"""The Nystrom sketch's block update as a kernel pair (``ops/sketch.py``,
``csrc/sketch_update.cu``) and its dispatch in ``estimators/ipca.py``.

On the CPU: the dispatch takes the plain version bit for bit and checks its
operands; the pair's geometry (the tiling, Omega's operand image, P's
image between the products) is emulated unit by unit in float64 and held against the
product.  The ``cuda`` tests need the card and skip elsewhere; the file
imports no jax, so run them there without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_port_sketch_kernel.py -m cuda -q
"""

import inspect

import pytest
import torch

from ganspace_tpu_torch.estimators import ipca
from ganspace_tpu_torch.estimators.ipca import (
    IPCAEstimator, NystromState, nystrom_update, nystrom_update_plain)
from ganspace_tpu_torch.ops import sketch
from ganspace_tpu_torch.ops.sketch import KC, KM, KN, omega_image, omega_image_plain, tiling
from ganspace_tpu_torch.ops.tf32x3 import sw128_image


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _state(d, l, gen, device="cpu"):
    return NystromState(3.0, torch.randn(d, generator=gen).to(device),
                        torch.tensor(5.0).to(device),
                        torch.randn(d, l, generator=gen).to(device))


# ---------------------------------------------------------------------------
# CPU: the dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,l", [(1, 40, 36), (37, 300, 40), (256, 1030, 100)])
def test_cpu_update_is_the_plain_version(n, d, l):
    gen = torch.Generator().manual_seed(n)
    state, x = _state(d, l, gen), torch.randn(n, d, generator=gen)
    omega = torch.randn(d, l, generator=gen)
    got, ref = nystrom_update(state, x, omega), nystrom_update_plain(state, x, omega)
    assert got.count == ref.count == state.count + n
    for a, b in zip(got[1:], ref[1:]):
        assert torch.equal(a, b)
    assert got.y is not state.y and got.s is not state.s


def test_update_keeps_its_interface():
    assert nystrom_update.__module__ == "ganspace_tpu_torch.estimators.ipca"
    assert list(inspect.signature(nystrom_update).parameters) == ["state", "x", "omega"]
    assert ipca.nystrom_update is nystrom_update


@pytest.mark.parametrize("fault", ["dtype", "device", "x_shape", "omega_shape", "y_shape",
                                   "s_shape", "sq_shape"])
def test_update_refuses_bad_operands(fault):
    gen = torch.Generator().manual_seed(1)
    d, l = 64, 36
    state, x, omega = _state(d, l, gen), torch.randn(8, d, generator=gen), torch.randn(d, l)
    if fault == "dtype":
        x = x.double()
    elif fault == "device":
        omega = omega.to("meta")
    elif fault == "x_shape":
        x = x[:, :-1]
    elif fault == "omega_shape":
        omega = omega[:, :-1]
    elif fault == "y_shape":
        state = state._replace(y=state.y[:-1])
    elif fault == "s_shape":
        state = state._replace(s=state.s[None])
    else:
        state = state._replace(sq=state.sq.reshape(1))
    with pytest.raises((TypeError, ValueError)):
        nystrom_update(state, x, omega)


@pytest.mark.parametrize("omega", [torch.zeros(64, 36), torch.zeros(64, 36, dtype=torch.float64),
                                   torch.zeros(64)])
def test_omega_image_is_card_only(omega):
    with pytest.raises(ValueError):
        omega_image(omega)


# ---------------------------------------------------------------------------
# CPU: the pair's geometry, emulated unit by unit
# ---------------------------------------------------------------------------

def _unswizzle(img):
    """[..., KN * 32] as wgmma reads it -> [..., KN, 32] (the swizzle is its
    own inverse)."""
    return sw128_image(img.reshape(*img.shape[:-1], KN, KC)).reshape(*img.shape[:-1], KN, KC)


@pytest.mark.parametrize("n,d,l,sms", [(10000, 32768, 320, 132), (128, 131072, 320, 132),
                                       (1, 8200, 80, 132), (7, 8200, 100, 132),
                                       (2000, 131072, 320, 132), (5, 33, 41, 3)])
def test_tiling_covers_k_once(n, d, l, sms):
    t = tiling(n, d, l, sms)
    chunks = -(-d // KC)
    assert t.n_nt * KN >= l > (t.n_nt - 1) * KN
    assert t.per_split == -(-chunks // t.splits)
    ranges = [(k * t.per_split, min((k + 1) * t.per_split, chunks)) for k in range(t.splits)]
    assert all(c0 < c1 for c0, c1 in ranges) and ranges[-1][1] == chunks
    units = t.n_nt * -(-n // KM) * t.splits
    if (n, d, l) == (128, 131072, 320):      # one row tile: K split to fill the card
        assert units == sms
    if (n, d, l) == (10000, 32768, 320):     # 158 tiles: split into ~6 waves
        assert units % sms > 0.9 * sms


def test_omega_image_is_the_split_transpose():
    gen = torch.Generator().manual_seed(3)
    for d, l in [(70, 100), (64, 80), (33, 161)]:
        omega = torch.randn(d, l, generator=gen) * 10.0 ** torch.randint(-3, 4, (d, l),
                                                                         generator=gen)
        img = omega_image_plain(omega)
        n_nt, chunks = -(-l // KN), -(-d // KC)
        assert img.shape == (n_nt, chunks, 2, KN * KC) and img.is_contiguous()
        tiles = _unswizzle(img)                            # [n_nt, chunks, 2, KN, 32]
        bits = tiles.view(torch.int32)
        assert torch.all(bits & 0x1FFF == 0)               # both halves are TF32
        full = (tiles[:, :, 0].double() + tiles[:, :, 1].double())
        full = full.transpose(1, 2).reshape(n_nt * KN, chunks * KC)
        assert torch.all(full[l:] == 0) and torch.all(full[:, d:] == 0)
        err = (full[:l, :d] - omega.T.double()).abs()
        assert torch.all(err <= 2.0 ** -21 * omega.T.double().abs())


def _emulate(state, x, omega, sms):
    """The pair's arithmetic unit by unit, in float64 on the TF32 halves:
    kernel 1's partial tiles over its K ranges, their sum in split order and
    P's image (the layout of ``omega_image_plain``, P^T over n), kernel
    2's D tiles over all of n."""
    n, d = x.shape
    l = omega.shape[1]
    t = tiling(n, d, l, sms)
    n_mt = -(-n // KM)
    chunks1, chunks2 = -(-d // KC), -(-n // KC)
    b1 = _unswizzle(omega_image_plain(omega)).double()
    xp = torch.zeros(n_mt * KM, chunks1 * KC, dtype=torch.float64)
    xp[:n, :d] = x.double()
    part = torch.zeros(t.splits, n_mt * KM, t.n_nt * KN, dtype=torch.float64)
    for u in range(t.n_nt * n_mt * t.splits):
        nt, mt, ks = u % t.n_nt, u // t.n_nt % n_mt, u // t.n_nt // n_mt
        rows, cols = slice(mt * KM, (mt + 1) * KM), slice(nt * KN, (nt + 1) * KN)
        for c in range(ks * t.per_split, min((ks + 1) * t.per_split, chunks1)):
            b = b1[nt, c, 0] + b1[nt, c, 1]
            part[ks, rows, cols] += xp[rows, c * KC:(c + 1) * KC] @ b.T
    p = torch.zeros_like(part[0])
    for ks in range(t.splits):
        p += part[ks]
    p = p[:n, :l].float()
    b2 = _unswizzle(omega_image_plain(p)).double()       # [n_nt, chunks2, 2, KN, 32]
    assert b2.shape[:2] == (t.n_nt, chunks2)
    xq = torch.zeros(chunks2 * KC, -(-d // KM) * KM, dtype=torch.float64)
    xq[:n, :d] = x.double()
    y = torch.zeros(xq.shape[1], t.n_nt * KN, dtype=torch.float64)
    for u in range(t.n_nt * (-(-d // KM))):
        nt, mt = u % t.n_nt, u // t.n_nt
        rows, cols = slice(mt * KM, (mt + 1) * KM), slice(nt * KN, (nt + 1) * KN)
        for c in range(chunks2):
            y[rows, cols] += xq[c * KC:(c + 1) * KC, rows].T @ (b2[nt, c, 0] + b2[nt, c, 1]).T
    return state.y.double() + y[:d, :l]


@pytest.mark.parametrize("n,d,l,sms", [(7, 300, 40, 5), (130, 200, 100, 4), (33, 1000, 161, 2)])
def test_emulated_pair_is_the_product(n, d, l, sms):
    gen = torch.Generator().manual_seed(n)
    state, x = _state(d, l, gen), torch.randn(n, d, generator=gen)
    omega = torch.randn(d, l, generator=gen)
    got = _emulate(state, x, omega, sms)
    ref = state.y.double() + x.double().T @ (x.double() @ omega.double())
    assert float((got - ref).norm() / ref.norm()) < 1e-6


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

#: normwise relative error of y' - y against the float64 product, and of s'
#: and sq': 3xTF32 products with float32 sums in two levels are float32's
#: accuracy (~1e-6 here); a single TF32 pass is ~1e-3
CARD_REL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    return torch.device("cuda")


def _rel(got, ref):
    return float((got.double() - ref).norm() / ref.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("l", [80, 100, 320])
@pytest.mark.parametrize("d", [8200, 32768, 131072])
@pytest.mark.parametrize("n", [1, 7, 128, 10000])
def test_pair_on_card(card, n, d, l):
    gen = torch.Generator(device=card).manual_seed(n * 7 + d + l)
    x = torch.randn(n, d, generator=gen, device=card) + 0.5
    omega = torch.randn(d, l, generator=gen, device=card)
    state = NystromState(2.0, torch.randn(d, generator=gen, device=card),
                         torch.tensor(3.0, device=card),
                         torch.randn(d, l, generator=gen, device=card))
    launches, builds = sketch.sketch_update.launches, ipca._omega_image.builds
    got = nystrom_update(state, x, omega)
    again = nystrom_update(state, x, omega)
    torch.cuda.synchronize()
    assert sketch.sketch_update.launches == launches + 2
    assert ipca._omega_image.builds == builds + 1          # one image per Omega
    assert got.count == state.count + n and got.y is not state.y
    for a, b in zip(got[1:], again[1:]):
        assert torch.equal(a, b)                           # bit-identical repeats
    xd = x.double()
    prod = xd.T @ (xd @ omega.double())
    assert _rel(got.y - state.y, prod) < CARD_REL
    assert _rel(got.s, state.s.double() + xd.sum(0)) < CARD_REL
    assert abs(float(got.sq) - (3.0 + float((xd * xd).sum()))) < CARD_REL * float(
        (xd * xd).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("d,l", [(32768, 320), (8200, 100), (33, 161), (131072, 320)])
def test_omega_image_on_card(card, d, l):
    gen = torch.Generator(device=card).manual_seed(d + l)
    omega = torch.randn(d, l, generator=gen, device=card) * 3.0
    assert torch.equal(omega_image(omega), omega_image_plain(omega))


@pytest.mark.cuda
def test_refine_builds_one_image_per_omega(card):
    gen = torch.Generator(device=card).manual_seed(5)
    d, c = 8200, 8
    blocks = [torch.randn(300, d, generator=gen, device=card) * torch.linspace(
        3, 0.1, d, device=card) for _ in range(4)]
    est = IPCAEstimator(c, mode="nystrom", refine="always")
    builds, launches = ipca._omega_image.builds, sketch.sketch_update.launches
    for b in blocks:
        assert est.fit_partial(b)
    first = est.get_components(device=True)[0].clone()
    assert est.should_refine() and est.begin_refine()
    for b in blocks[:2]:
        assert est.fit_partial(b)
    assert ipca._omega_image.builds == builds + 2
    assert sketch.sketch_update.launches == launches + 6
    est.abort_refine()
    assert torch.equal(est.get_components(device=True)[0], first)


@pytest.mark.cuda
def test_image_dies_with_its_omega(card):
    """The memo holds Omega weakly: once the fit's Omega is gone, so is its
    image, and a new Omega builds its own."""
    gen = torch.Generator(device=card).manual_seed(9)
    d, l = 8200, 100
    state = NystromState(0.0, torch.zeros(d, device=card), torch.zeros((), device=card),
                         torch.zeros(d, l, device=card))
    x = torch.randn(50, d, generator=gen, device=card)
    omega = torch.randn(d, l, generator=gen, device=card)
    builds = ipca._omega_image.builds
    nystrom_update(nystrom_update(state, x, omega), x, omega)
    assert ipca._omega_image.builds == builds + 1
    image = ipca._omega_images[0][1]
    del omega
    ipca._omega_image(torch.randn(d, l, generator=gen, device=card))
    assert ipca._omega_image.builds == builds + 2
    assert all(held is not image for _, held in ipca._omega_images)
