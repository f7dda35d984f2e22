"""Streaming (incremental) PCA: ``ganspace_tpu/estimators/ipca.py`` in PyTorch.

Three tiers behind one estimator, chosen by the feature dim D on the first
block (``mode="auto"``) or pinned by ``mode``:

* **exact moments** (D <= ``MOMENTS_MAX_D``, the W/Z latent spaces):
  Chan-merged count, mean and centered scatter M2, one centered Gram per
  block (the CUDA kernel of ``ops/moments.py``), one eigh at the end.
* **Nystrom sketch** (larger D, the conv taps): per block two plain GEMMs,
  ``x @ Omega`` and ``x^T (x Omega)`` with Omega a [D, l] Gaussian test
  matrix; at the end the [D, l] products run on the device and the l x l
  factorizations on the host in float64.  An optional second data pass
  (``should_refine`` / ``begin_refine``) is one power iteration against the
  first pass's orthonormal range.
* **sklearn mirror** (``mode="sklearn"``): sklearn ``IncrementalPCA``'s
  per-block update, an eigh of a (c + n + 1)-row Gram per block.

Every product runs under the caller's ``ops/precision.ieee_f32`` (TF32 off),
the counterpart of the JAX package's ``Precision.HIGHEST``.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ganspace_tpu_torch.estimators.utils import gram_svd, svd_flip_vt, topk_eigh_desc
from ganspace_tpu_torch.ops.moments import centered_gram

_NOT_FINITE = ("non-finite moment statistics: the activation stream contains "
               "NaN/Inf, so the factorization is refused")


def _f32_on(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host float64 factor as a float32 tensor on ``like``'s device (the
    descending eigh views have negative strides, which torch refuses)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(like.device)


# ---------------------------------------------------------------------------
# sklearn-mirror tier (ipca.py:42-108)
# ---------------------------------------------------------------------------

class IPCAState(NamedTuple):
    mean: torch.Tensor                      # [D]
    var: torch.Tensor                       # [D]
    components: torch.Tensor                # [c, D]
    singular_values: torch.Tensor           # [c]
    explained_variance: torch.Tensor        # [c]
    explained_variance_ratio: torch.Tensor  # [c]


def partial_fit_math(state: IPCAState, x: torch.Tensor, n_seen: float, *,
                     n_components: int, first: bool) -> IPCAState:
    """sklearn ``IncrementalPCA.partial_fit``: Chan update of mean and
    variance, then the top-c SVD of [s * V_old; x - mean_b; correction]."""
    n_batch = float(x.shape[0])
    batch_mean = torch.mean(x, dim=0)
    batch_var = torch.var(x, dim=0, correction=0)
    if first:
        n_total = n_batch
        new_mean, new_var = batch_mean, batch_var
        m = x - batch_mean
    else:
        n_total = n_seen + n_batch
        delta = batch_mean - state.mean
        new_mean = state.mean + delta * (n_batch / n_total)
        m2 = (state.var * n_seen + batch_var * n_batch
              + torch.square(delta) * (n_seen * n_batch / n_total))
        new_var = m2 / n_total
        mean_corr = math.sqrt((n_seen / n_total) * n_batch) * (state.mean - batch_mean)
        m = torch.cat([state.singular_values[:, None] * state.components,
                       x - batch_mean, mean_corr[None, :]], dim=0)
    s, vt = gram_svd(m, n_components)
    explained_variance = torch.square(s) / (n_total - 1.0)
    explained_variance_ratio = torch.square(s) / torch.sum(new_var * n_total)
    return IPCAState(new_mean, new_var, vt, s, explained_variance,
                     explained_variance_ratio)


def partial_fit_scan(state: IPCAState, blocks: torch.Tensor, n_seen0: float, *,
                     n_components: int) -> IPCAState:
    """k sequential updates over ``blocks`` [k, n, D]: the result of k
    ``fit_partial`` calls in order (one scanned dispatch in JAX, a loop
    here)."""
    n_seen = n_seen0
    for x in blocks:
        state = partial_fit_math(state, x, n_seen, n_components=n_components,
                                 first=False)
        n_seen += float(x.shape[0])
    return state


# ---------------------------------------------------------------------------
# Nystrom sketch tier (ipca.py:111-285)
# ---------------------------------------------------------------------------

class NystromState(NamedTuple):
    count: float           # samples absorbed
    s: torch.Tensor        # [D] running sum of x
    sq: torch.Tensor       # scalar: running sum of ||x||^2
    y: torch.Tensor        # [D, l] = (sum x x^T) @ omega


def sketch_test_matrix(d: int, l: int) -> torch.Tensor:
    """The sketch's Gaussian test matrix Omega [D, l], on the CPU.

    Drawn from a CPU generator seeded 0xA5, so a run on the card and a run
    on the CPU sketch against the same matrix.  (The JAX package draws its
    own from ``PRNGKey(0xA5)``: the same law, other values.)"""
    gen = torch.Generator().manual_seed(0xA5)
    return torch.randn(d, l, generator=gen, dtype=torch.float32)


def nystrom_update(state: NystromState, x: torch.Tensor,
                   omega: torch.Tensor) -> NystromState:
    """One block of the single-pass sketch: two GEMMs and two sums, no
    factorization.  Out of place: every update makes a new ``y``, which is
    what the factor memo of :class:`IPCAEstimator` keys on."""
    xo = x @ omega
    return NystromState(state.count + float(x.shape[0]),
                        state.s + torch.sum(x, dim=0),
                        state.sq + torch.sum(torch.square(x)),
                        torch.addmm(state.y, x.T, xo))


def sketch_grams(state: NystromState, omega: torch.Tensor):
    """Device half of every sketch factorization: the centered sketch
    Y = M2c @ Omega [D, l], its symmetrized Omega-Gram [l, l] and the exact
    centered energy (scalar).  The centering is the JAX package's, float32
    cancellation included."""
    n = state.count
    mu = state.s / n
    y = state.y - n * torch.outer(mu, (mu[None, :] @ omega)[0])
    m = omega.T @ y
    total = state.sq - n * torch.sum(torch.square(mu))
    return y, 0.5 * (m + m.T), total


def whitened_gram(y: torch.Tensor, w: torch.Tensor):
    """f = Y @ W [D, l] (the whitened centered sketch) and its Gram f^T f."""
    f = y @ w
    g = f.T @ f
    return f, 0.5 * (g + g.T)


def check_finite_gram(m: np.ndarray) -> None:
    """Refuse a non-finite sketch Gram: the [l, l] Gram is where a NaN/Inf in
    the activation stream first reaches the host."""
    if not np.all(np.isfinite(m)):
        raise FloatingPointError(
            "non-finite sketch statistics: the activation stream contains "
            "NaN/Inf, so the factorization is refused")


def pinv_sqrt_psd(m: np.ndarray, tol_rel: Optional[float] = None) -> np.ndarray:
    """Symmetric pseudo-inverse square root of a noisy-PSD matrix (host
    float64).  Eigendirections below ``tol_rel * max_eig`` (default
    l * eps_f32, the Gram's accumulation noise) are dropped, never
    amplified."""
    check_finite_gram(m)
    if tol_rel is None:
        tol_rel = m.shape[0] * float(np.finfo(np.float32).eps)
    e, v = np.linalg.eigh(m.astype(np.float64))
    emax = float(e[-1]) if e.size else 0.0
    if emax <= 0.0:
        return np.zeros_like(m, dtype=np.float64)
    keep = e > tol_rel * emax
    vk = v[:, keep]
    return (vk / np.sqrt(e[keep])) @ vk.T


def eigh_desc(g: np.ndarray):
    """Host float64 eigh of the [l, l] whitened Gram, descending."""
    check_finite_gram(g)
    e, v = np.linalg.eigh(np.asarray(g).astype(np.float64))
    return e[::-1], v[:, ::-1]


def noise_floor_scale(e: np.ndarray) -> np.ndarray:
    """e^{-1/2} with eigenvalues under 1e-12 of the largest zeroed (their
    columns carry no float32-resolvable signal)."""
    emax = float(e[0]) if e.size else 0.0
    return np.where(e > max(emax, 0.0) * 1e-12,
                    1.0 / np.sqrt(np.maximum(e, 1e-300)), 0.0)


def sketch_factor(state: NystromState, omega: torch.Tensor):
    """``(f [D, l] on the device, e desc f64, v desc f64, total float)``:
    f = Yc W is the whitened centered sketch, (e, v) the eigenpairs of
    f^T f.  Three [D, l] products on the device, two l x l eighs on the
    host."""
    y, m, total = sketch_grams(state, omega)
    w = pinv_sqrt_psd(m.cpu().numpy())
    f, g = whitened_gram(y, _f32_on(w, y))
    e, v = eigh_desc(g.cpu().numpy())
    return f, e, v, float(total)


def range_from_factor(f: torch.Tensor, e: np.ndarray, v: np.ndarray) -> torch.Tensor:
    """Orthonormal basis [D, l] of the centered sketch (zero columns where
    the spectrum is under the noise floor): the refine pass's test matrix."""
    return f @ _f32_on(v * noise_floor_scale(e)[None, :], f)


def flip_cols_to_components(u: torch.Tensor) -> torch.Tensor:
    """[D, c] columns -> [c, D] components with sklearn's signs."""
    return svd_flip_vt(u.T).contiguous()


def finish_from_factor(f, e, v, total, count, n_components):
    """Nystrom eigen-approximation C ~= Y (Omega^T Y)^+ Y^T of the centered
    covariance: (components [c, D] on the device, stdev [c], var_ratio [c])."""
    ec = e[:n_components]
    u = f @ _f32_on(v[:, :n_components] * noise_floor_scale(ec)[None, :], f)
    comp = flip_cols_to_components(u)
    denom = max(count - 1.0, 1.0)
    explained = np.maximum(ec, 0.0) / denom
    ratio = explained / max(total / denom, 1e-30)
    return comp, np.sqrt(explained), ratio


# ---------------------------------------------------------------------------
# Exact-moments tier (ipca.py:288-362)
# ---------------------------------------------------------------------------

class MomentsState(NamedTuple):
    count: float           # samples absorbed
    mean: torch.Tensor     # [D]
    m2: torch.Tensor       # [D, D] centered scatter sum (x-mu)(x-mu)^T


def moments_update(state: MomentsState, x: torch.Tensor) -> MomentsState:
    """One block of Chan-stable streaming moments: one centered Gram (the
    CUDA kernel on the card), no eigh."""
    n = float(x.shape[0])
    batch_mean = torch.mean(x, dim=0)
    gram = centered_gram(x, batch_mean)
    new_count = state.count + n
    delta = batch_mean - state.mean
    new_mean = state.mean + delta * (n / new_count)
    new_m2 = state.m2 + gram + torch.outer(delta, delta) * (state.count * n / new_count)
    return MomentsState(new_count, new_mean, new_m2)


def proj_variance(state: MomentsState, dirs: torch.Tensor) -> torch.Tensor:
    """Population variance of the stream's projections onto the rows of
    ``dirs`` [k, D], exact from the scatter: Var(d.x) = d M2 d / n."""
    return torch.sum((dirs @ state.m2) * dirs, dim=1) / state.count


def moments_finish(state: MomentsState, n_components: int):
    """(components [c, D], stdev [c], var_ratio [c]) from the moments."""
    cov = state.m2 / max(state.count - 1.0, 1.0)
    evals, evecs = topk_eigh_desc(cov)
    evals = torch.clamp(evals, min=0.0)
    comp = svd_flip_vt(evecs[:, :n_components].T)
    var_ratio = evals[:n_components] / torch.clamp(torch.sum(evals), min=1e-30)
    return comp, torch.sqrt(evals[:n_components]), var_ratio


def moments_finish_bundle(state: MomentsState, n_components: int, rand=None):
    """Components plus a [4, c] stats pack: stdev, var_ratio, lat_stdev (the
    exact full-stream projection stdev of the unit-row components, which in
    W space is the latent stdev) and the random-direction stdevs from the
    ``rand`` moments ``(mean, M2, n)`` (zeros without them)."""
    comp, stdev, ratio = moments_finish(state, n_components)
    pv = proj_variance(state, comp)
    rstd = (torch.zeros_like(stdev) if rand is None
            else torch.sqrt(torch.clamp(rand[1] / max(float(rand[2]), 1.0), min=0.0)))
    return comp, torch.stack([stdev, ratio, torch.sqrt(torch.clamp(pv, min=0.0)), rstd])


def rand_update(rand, x: torch.Tensor, dirs: torch.Tensor):
    """Chan merge of one block's projections ``x @ dirs^T`` into the
    random-projection moments ``(mean [c], M2 [c], n)``: centered per block,
    never the raw E[p^2] - E[p]^2."""
    pm, pm2, cnt = rand
    p = x @ dirs.T
    nb = p.shape[0]
    bm = torch.mean(p, dim=0)
    bm2 = torch.sum(torch.square(p - bm), dim=0)
    newc = cnt + nb
    delta = bm - pm
    return (pm + delta * (nb / newc),
            pm2 + bm2 + torch.square(delta) * (cnt * nb / newc), newc)


def reg_update_(reg, x: torch.Tensor, z: torch.Tensor):
    """One block of the regression cross-moments ``(sum x^T z, sum z, n)``,
    the sums updated in place (the [D, zdim] sum is 256 MB at a
    full-width conv tap, and a copy of it per block would cost more than
    its GEMM); returns the tuple with the new count."""
    xz, zs, n = reg
    xz.addmm_(x.T, z)
    zs.add_(torch.sum(z, dim=0))
    return xz, zs, n + x.shape[0]


class IPCAEstimator:
    """``ganspace_tpu.estimators.IPCAEstimator`` on one torch device.

    State lives on the device of the first block it is given; later blocks
    are moved there."""

    #: feature dims up to this use the exact-moments tier (D x D scatter:
    #: 8192^2 float32 = 256 MB); beyond it, the sketch
    MOMENTS_MAX_D = 8192

    #: Adaptive-refine thresholds, the JAX package's calibration (skip the
    #: second pass only when the first-pass sketch leaves at most 1.2% of
    #: the centered energy unresolved AND no relative eigengap among the
    #: top c + 1 estimates is under 2%)
    REFINE_TAIL_FRAC = 0.012
    REFINE_MIN_GAP = 0.02

    def __init__(self, n_components: int, mode: str = "auto",
                 refine: Optional[str] = None):
        if mode not in ("auto", "sklearn", "moments", "nystrom"):
            raise ValueError(f"IPCAEstimator: unknown mode {mode!r}")
        self.n_components = n_components
        # Fixed at construction: ``refine`` ("auto" / "always"/"1" /
        # "never"/"0") wins, else GANSPACE_IPCA_REFINE is read once here.
        self.refine_policy = (refine if refine is not None
                              else os.environ.get("GANSPACE_IPCA_REFINE",
                                                  "auto")).strip().lower()
        self.mode = mode
        self.batch_support = True
        self.n_samples_seen_ = 0
        self._device: Optional[torch.device] = None
        self._state: Optional[IPCAState] = None
        self._moments: Optional[MomentsState] = None
        self._nystrom: Optional[NystromState] = None
        self._omega: Optional[torch.Tensor] = None
        self._sf_cache = None      # (the y it was computed from, factor)
        self._refined = False
        self._pre_refine = None    # first-pass snapshot while a refine runs
        #: fit_stream accumulators: regression cross-moments (sum x^T z
        #: [D, zdim], sum z [zdim], n) and random-projection moments
        #: (mean [c], M2 [c], n), over the last pass's samples
        self._reg = None
        self._rand = None
        #: True when the policy (or an explicit never) skipped the second
        #: pass, False when one ran, None while undecided or off the sketch
        self.refine_skipped: Optional[bool] = None
        #: the convergence statistics the auto decision was made from
        self.refine_stats: Optional[dict] = None
        #: what the auto policy decided (True = skip-eligible), or None
        self.policy_would_skip: Optional[bool] = None
        # sketch oversampling: l = 4c (at least c + 32)
        self.oversample = max(4 * n_components, n_components + 32)
        # sklearn's default batch size, used by fit()
        self.batch_size = max(100, 2 * n_components)

    def get_param_str(self) -> str:
        return f"ipca_c{self.n_components}"   # the reference never whitens

    def _use_moments(self, d: int) -> bool:
        if self.mode == "moments":
            return True
        if self.mode != "auto":
            return False
        return d <= int(os.environ.get("GANSPACE_IPCA_MOMENTS_MAX_D",
                                       self.MOMENTS_MAX_D))

    def _use_nystrom(self, d: int) -> bool:
        if self.mode == "nystrom":
            return True
        return self.mode == "auto" and not self._use_moments(d)

    # -- sketch decisions -----------------------------------------------------
    def _sketch_factor_cached(self):
        """``sketch_factor`` of the current sketch, memoized on the identity
        of its ``y`` (a strong reference is held, so no id is recycled):
        should_refine -> begin_refine -> get_components factorize once."""
        c = self._sf_cache
        if c is not None and c[0] is self._nystrom.y:
            return c[1]
        out = sketch_factor(self._nystrom, self._omega)
        self._sf_cache = (self._nystrom.y, out)
        return out

    def sketch_convergence(self) -> Optional[dict]:
        """Convergence statistics of the first-pass sketch, from its own
        l x l spectrum: ``sketch_tail_frac`` (centered energy the sketch
        leaves unresolved, as a fraction of the exact total) and
        ``min_rel_gap_topc`` (smallest relative eigengap among the top c + 1
        estimates, the cut-boundary pair included).  None before data."""
        if self._nystrom is None or self._nystrom.count == 0.0:
            return None
        _, evals, _, total = self._sketch_factor_cached()
        ev = np.maximum(np.asarray(evals, np.float64), 1e-30)
        c = min(self.n_components, len(ev))
        hi = min(c + 1, len(ev))
        return {
            "sketch_tail_frac":
                float(max(total - float(ev.sum()), 0.0) / max(total, 1e-30)),
            "min_rel_gap_topc":
                float(np.min(1.0 - ev[1:hi] / ev[:hi - 1])) if hi > 1 else 1.0,
        }

    def should_refine(self) -> bool:
        """Whether the sketch's second data pass is worth a sweep, under the
        policy: ``auto`` skips it only when ``sketch_tail_frac <= 0.012`` and
        ``min_rel_gap_topc >= 0.02``.  Records ``refine_skipped``,
        ``refine_stats`` and ``policy_would_skip``."""
        mode = self.refine_policy
        if self._nystrom is None or self._refined:
            return False
        if mode in ("0", "never", "off", "false"):
            self.refine_skipped = True
            return False
        if mode in ("1", "always", "on", "true"):
            self.refine_skipped = False
            return True
        stats = self.sketch_convergence()
        if stats is None:
            return False
        skip = (stats["sketch_tail_frac"] <= self.REFINE_TAIL_FRAC
                and stats["min_rel_gap_topc"] >= self.REFINE_MIN_GAP)
        self.refine_skipped = bool(skip)
        self.policy_would_skip = bool(skip)
        self.refine_stats = stats
        return not skip

    def begin_refine(self, force: bool = False) -> bool:
        """Arm the sketch's second pass: the test matrix becomes the
        orthonormal range of the first-pass sketch and accumulation restarts,
        so re-streaming the same samples through ``fit_partial`` is one power
        iteration.  The first-pass sketch is kept for :meth:`abort_refine`.
        A ``never`` policy refuses unless ``force``."""
        if self._nystrom is None or self._refined:
            return False
        if not force and self.refine_policy in ("0", "never", "off", "false"):
            return False
        if self.refine_skipped is None:
            self.refine_skipped = False   # direct callers bypass the policy
        d, l = self._nystrom.y.shape
        self._pre_refine = (self._nystrom, self._omega, self.n_samples_seen_,
                            self._reg, self._rand)
        f, e, v, _ = self._sketch_factor_cached()
        self._omega = range_from_factor(f, e, v)
        # drop the whitened [D, l] factor before the second sweep runs
        self._sf_cache = None
        self._nystrom = self._empty_sketch(d, l)
        # The refine pass re-streams the same samples: its cross-moments and
        # random moments replace the first pass's instead of adding to them.
        if self._reg is not None:
            self._reg = (torch.zeros_like(self._reg[0]), torch.zeros_like(self._reg[1]), 0)
        if self._rand is not None:
            self._rand = (torch.zeros_like(self._rand[0]),
                          torch.zeros_like(self._rand[1]), 0)
        self.n_samples_seen_ = 0
        self._refined = True
        return True

    def abort_refine(self) -> None:
        """Undo a refine pass in progress (an interrupt mid-sweep): restore
        the completed first-pass sketch and its accumulators, which a partial
        second pass is strictly worse than.  No-op unless ``begin_refine``
        armed one."""
        if self._pre_refine is None:
            return
        (self._nystrom, self._omega, self.n_samples_seen_, self._reg,
         self._rand) = self._pre_refine
        self._pre_refine = None
        self._refined = False
        self.refine_skipped = None   # the armed pass never completed

    # -- streaming ----------------------------------------------------------
    def _empty_sketch(self, d: int, l: int) -> NystromState:
        dev = self._device
        return NystromState(0.0, torch.zeros((d,), dtype=torch.float32, device=dev),
                            torch.zeros((), dtype=torch.float32, device=dev),
                            torch.zeros((d, l), dtype=torch.float32, device=dev))

    def _maybe_init_tier(self, d: int, device: torch.device) -> None:
        """Allocate the moments or sketch state on the first block (no-op
        when a tier is live or the sklearn tier applies)."""
        if self._device is None:
            self._device = device
        if not (self._state is None and self._moments is None
                and self._nystrom is None):
            return
        if self._use_moments(d):
            self._moments = MomentsState(
                0.0, torch.zeros((d,), dtype=torch.float32, device=device),
                torch.zeros((d, d), dtype=torch.float32, device=device))
        elif self._use_nystrom(d):
            l = min(self.oversample, d)
            self._omega = torch.as_tensor(sketch_test_matrix(d, l),
                                          dtype=torch.float32).to(device)
            self._nystrom = self._empty_sketch(d, l)

    def fit_partial(self, x) -> bool:
        x = torch.as_tensor(x, dtype=torch.float32)
        n, d = x.shape
        if n < self.n_components:
            print(f"\nIPCA error: n_samples={n} < n_components={self.n_components}")
            return False
        if self._device is not None:
            x = x.to(self._device)
        self._maybe_init_tier(d, x.device)
        if self._moments is not None:
            self._moments = moments_update(self._moments, x)
        elif self._nystrom is not None:
            self._nystrom = nystrom_update(self._nystrom, x, self._omega)
        else:
            first = self._state is None
            if first:
                zeros_d = torch.zeros((d,), dtype=torch.float32, device=x.device)
                zeros_c = torch.zeros((self.n_components,), dtype=torch.float32,
                                      device=x.device)
                self._state = IPCAState(
                    zeros_d, zeros_d,
                    torch.zeros((self.n_components, d), dtype=torch.float32,
                                device=x.device),
                    zeros_c, zeros_c, zeros_c)
            self._state = partial_fit_math(
                self._state, x, float(self.n_samples_seen_),
                n_components=self.n_components, first=first)
        self.n_samples_seen_ += n
        return True

    def fit_partial_blocks(self, blocks) -> bool:
        """Update over ``blocks`` [k, n, D]: the sklearn tier runs the k
        updates in order; the moments and sketch tiers, whose updates are
        associative, take the concatenation in one update."""
        blocks = torch.as_tensor(blocks, dtype=torch.float32)
        k, n, d = blocks.shape
        if n < self.n_components:
            print(f"\nIPCA error: n_samples={n} < n_components={self.n_components}")
            return False
        if (self._moments is not None or self._nystrom is not None
                or (self._state is None
                    and (self._use_moments(d) or self._use_nystrom(d)))):
            return self.fit_partial(blocks.reshape(k * n, d))
        if self._state is None:
            if not self.fit_partial(blocks[0]):
                return False
            blocks = blocks[1:]
            k -= 1
        if k == 0:
            return True
        self._state = partial_fit_scan(
            self._state, blocks.to(self._device), float(self.n_samples_seen_),
            n_components=self.n_components)
        self.n_samples_seen_ += k * n
        return True

    def fit_stream(self, block_fn, n_blocks: int, *, with_reg: bool = False,
                   rand_dirs=None) -> bool:
        """Fit over a regenerable block stream (``ipca.py:780-897``).

        ``block_fn(i)`` returns block ``i``: ``x [nb, D]``, or ``(x, z
        [nb, zdim])`` with ``with_reg``.  It must depend on ``i`` alone, since
        the sketch tier's refine pass calls it again.  ``with_reg`` also
        accumulates the latent regression's raw cross-moments ``sum x^T z``
        and ``sum z`` (read back by :meth:`reg_moments`); ``rand_dirs``
        [c, D] the Chan moments of the projections ``x @ rand_dirs^T``
        (:meth:`rand_moments`).  Only the moments and sketch tiers stream
        (their updates are associative); the sklearn tier returns False.
        Each block is one eager update; on the sketch tier the adaptive
        refine pass follows the main pass."""
        if n_blocks <= 0:
            return True
        first = block_fn(0)        # the shape probe, kept as block 0 of pass 1
        x, z = first if with_reg else (first, None)
        nb, d = x.shape
        if nb < self.n_components:
            print(f"\nIPCA error: n_samples={nb} < n_components={self.n_components}")
            return False
        self._maybe_init_tier(d, torch.as_tensor(x).device)
        if self._moments is None and self._nystrom is None:
            return False
        dev = self._device
        if with_reg and self._reg is None:
            self._reg = (torch.zeros((d, z.shape[1]), dtype=torch.float32, device=dev),
                         torch.zeros((z.shape[1],), dtype=torch.float32, device=dev), 0)
        if rand_dirs is not None:
            rand_dirs = torch.as_tensor(rand_dirs, dtype=torch.float32).to(dev)
            if self._rand is None:
                zc = torch.zeros((rand_dirs.shape[0],), dtype=torch.float32, device=dev)
                self._rand = (zc, zc, 0)
        self._run_stream(block_fn, n_blocks, with_reg, rand_dirs, first)
        return True

    def _run_stream(self, block_fn, n_blocks, with_reg, rand_dirs, first) -> None:
        """The main pass, then on the sketch tier the adaptive refine pass
        over the regenerated stream (``ipca.py:899-964``)."""
        def on_device(a):
            return torch.as_tensor(a, dtype=torch.float32).to(self._device)

        def run_pass(first):
            for i in range(n_blocks):
                out = block_fn(i) if first is None else first
                first = None
                x, z = out if with_reg else (out, None)
                x = on_device(x)
                st = (moments_update(self._moments, x) if self._moments is not None
                      else nystrom_update(self._nystrom, x, self._omega))
                rand = (rand_update(self._rand, x, rand_dirs) if rand_dirs is not None
                        else self._rand)
                # a block lands whole: an interrupt between blocks leaves the
                # tier, the accumulators and the count consistent.  The
                # cross-moments update in place, last, right before the
                # commit; ``begin_refine`` gives the refine pass fresh sums,
                # so ``abort_refine``'s snapshot is never written.
                reg = reg_update_(self._reg, x, on_device(z)) if with_reg else self._reg
                if self._moments is not None:
                    self._moments, self._reg, self._rand = st, reg, rand
                else:
                    self._nystrom, self._reg, self._rand = st, reg, rand
                self.n_samples_seen_ += x.shape[0]

        run_pass(first)
        if self._nystrom is not None and self.should_refine() and self.begin_refine():
            run_pass(None)
            self._pre_refine = None   # completed: no abort may roll it back

    def reg_moments(self):
        """``(sum x^T z [D, zdim], sum z [zdim], n)`` over the last completed
        pass of ``fit_stream(with_reg=True)``, or None."""
        if self._reg is None or self._reg[2] == 0:
            return None
        return self._reg

    def rand_moments(self):
        """``(mean [c], M2 [c], n)`` of the projections onto ``rand_dirs``
        over the last completed pass (Var = M2 / n), or None."""
        if self._rand is None or self._rand[2] == 0:
            return None
        return self._rand

    def fit(self, x):
        x = np.asarray(x)
        for i in range(0, x.shape[0], self.batch_size):
            chunk = x[i:i + self.batch_size]
            if chunk.shape[0] >= self.n_components:
                self.fit_partial(chunk)

    # -- results ------------------------------------------------------------
    def _require_moments(self) -> MomentsState:
        if self._moments is None or self._moments.count == 0.0:
            raise RuntimeError("IPCAEstimator: no samples fitted yet")
        if not bool(torch.isfinite(self._moments.m2).all()):
            raise FloatingPointError(_NOT_FINITE)
        return self._moments

    @property
    def mean_(self) -> np.ndarray:
        if self._moments is not None:
            return self._moments.mean.cpu().numpy()
        if self._nystrom is not None:
            return (self._nystrom.s / self._nystrom.count).cpu().numpy()
        return self._state.mean.cpu().numpy()

    def get_components(self, device: bool = False):
        """(components [c, D], stdev [c], var_ratio [c]).  ``device=True``
        keeps the components a tensor on the estimator's device; stdev and
        var_ratio are numpy either way."""
        # Consuming the estimate finalizes a completed refine pass.
        self._pre_refine = None
        if self._moments is not None:
            comp, stdev, var_ratio = moments_finish(self._require_moments(),
                                                    self.n_components)
            stdev, var_ratio = stdev.cpu().numpy(), var_ratio.cpu().numpy()
        elif self._nystrom is not None:
            f, e, v, total = self._sketch_factor_cached()
            comp, stdev, var_ratio = finish_from_factor(
                f, e, v, total, self._nystrom.count, self.n_components)
        elif self._state is not None:
            comp = self._state.components
            stdev = torch.sqrt(self._state.explained_variance).cpu().numpy()
            var_ratio = self._state.explained_variance_ratio.cpu().numpy()
        else:
            raise RuntimeError("IPCAEstimator: no samples fitted yet")
        return (comp if device else comp.cpu().numpy()), stdev, var_ratio

    def finish_latent_bundle(self, rand_moments=None):
        """Samples-are-latents finish on the moments tier: ``(components
        [c, D] on the device, stats np [4, c])`` with rows (stdev, var_ratio,
        lat_stdev, random_stdevs, zeros unless ``rand_moments`` is given);
        None off the moments tier."""
        if self._moments is None or self._moments.count == 0.0:
            return None
        self._pre_refine = None
        comp, stats = moments_finish_bundle(self._require_moments(),
                                            self.n_components, rand_moments)
        return comp, stats.cpu().numpy()

    def component_spectrum(self) -> Optional[np.ndarray]:
        """Descending eigenvalue estimates of the fitted scatter: exact on
        the moments tier, the l Nystrom estimates on the sketch; None on the
        sklearn tier or before data."""
        if self._moments is not None and self._moments.count > 0.0:
            m = self._moments
            cov = m.m2.to(torch.float64) / max(m.count - 1.0, 1.0)
            ev = torch.flip(torch.linalg.eigvalsh(cov), (0,)).cpu().numpy()
            return np.maximum(ev, 0.0)
        if self._nystrom is not None and self._nystrom.count > 0.0:
            _, ev, _, _ = self._sketch_factor_cached()
            return np.maximum(np.asarray(ev, np.float64), 0.0)
        return None
