"""Streaming per-unit statistics (reference ``netdissect/runningstats.py``).

Counterpart of ``ganspace_tpu/stats/running.py``: the same accumulators,
with the same state-dict keys, on torch tensors that stay on the device of
the data they are fed:

* :class:`RunningTopK` — per-unit top-k, one ``torch.topk`` merge per batch;
* :class:`RunningQuantile` — per-unit quantile sketch by random level
  compaction (sort, keep every other sample, double its weight);
* :class:`RunningConditionalQuantile` — per-condition map of sketches;
* :class:`RunningCrossCovariance` — Chan-style stable cross-moments, the
  cross product an IEEE float32 matmul (no TF32);
* :class:`RunningVariance` — plain Chan mean/variance.

The quantile sketch's only randomness is one coin flip per (chunk, level),
which picks the parity a compaction keeps.  Flips never depend on the
values, and neither do the fill counts, which follow from the number of
columns and the flips alone.  So the flips of a flush are drawn on the host
(:func:`flip_source`, a CPU generator seeded as the sketch is), every fill
and every overflow is known before a launch, and only the merges that do
work are launched: no device-to-host copy per level, and the card and the
CPU compact identically.  The JAX package draws its flips from split
``PRNGKey(seed)`` keys; tests swap :func:`flip_source` for those draws.
"""

from __future__ import annotations

from itertools import chain
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ganspace_tpu_torch.ops.precision import ieee_f32


def _f32(x, device=None) -> torch.Tensor:
    """A float32 tensor of ``x`` (numpy or tensor), on ``device`` if given,
    else where it lies (a numpy array: the CPU)."""
    t = torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else torch.as_tensor(x)
    return t.to(device=device if device is not None else t.device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Top-K
# ---------------------------------------------------------------------------

class RunningTopK:
    """Highest ``k`` activation values seen per unit."""

    def __init__(self, k: int = 100):
        self.k = k
        self.count = 0
        self._vals: Optional[torch.Tensor] = None

    def add(self, batch) -> None:
        """batch: [N, U] (flatten spatial dims into N beforehand)."""
        batch = _f32(batch)
        n, u = batch.shape
        if self._vals is None:
            self._vals = torch.full((u, self.k), -torch.inf, device=batch.device)
        joined = torch.cat([self._vals, batch.T], dim=1)
        self._vals = torch.topk(joined, self.k, dim=1).values
        self.count += n

    def result(self) -> np.ndarray:
        """[U, k] top values, descending; -inf where fewer than k seen."""
        return self._vals.cpu().numpy()

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {"k": np.int64(self.k), "count": np.int64(self.count),
                "vals": self.result()}

    def set_state_dict(self, d, device="cpu") -> "RunningTopK":
        self.k = int(d["k"])
        self.count = int(d["count"])
        self._vals = _f32(d["vals"], device)
        return self


# ---------------------------------------------------------------------------
# Quantile sketch
# ---------------------------------------------------------------------------

def flip_source(seed: int):
    """The sketch's coin flips: ``draw(n_chunks, depth)`` -> bool
    [n_chunks, depth], one call per flush, from a CPU generator seeded
    ``seed``.  Flip (c, l) is the parity a compaction at level ``l`` keeps
    while chunk ``c`` of the flush cascades."""
    gen = torch.Generator().manual_seed(seed)

    def draw(n_chunks: int, depth: int) -> np.ndarray:
        return torch.randint(0, 2, (n_chunks, depth), generator=gen).numpy().astype(bool)
    return draw


class RunningQuantile:
    """Per-unit streaming quantiles by random level compaction.

    ``depth`` levels of ``samplesize`` slots each; level ``l`` samples carry
    weight ``2^l``.  Each level is kept sorted per unit and +inf past its
    fill.  Expected quantile error is O(1/samplesize), the guarantee class of
    the reference's sketch (``runningstats.py:119-457``).

    ``add`` appends the batch to a pending list.  Once ``flush_cols``
    columns are pending (``flush_blocks * samplesize``, where the JAX
    package flushes), the flush cuts them into chunks of ``samplesize``
    columns (the last +inf padded), sorts every chunk at once and cascades
    each chunk up the levels: a chunk meets an empty level and stays; meets
    a level whose union with it fits and merges; or overflows, and the
    sorted union is compacted (every other sample, from the flip's parity)
    and carried up.  The top level compacts in place.
    """

    def __init__(self, samplesize: int = 1024, depth: int = 12, seed: int = 0,
                 flush_blocks: int = 8):
        self.samplesize = samplesize
        self.depth = depth
        self.count = 0
        self.units = None
        self._flips = flip_source(seed)
        self._levels: Optional[list] = None        # depth x [U, S] tensors
        self._fills: Optional[np.ndarray] = None   # [D] host ints
        self._inf: Optional[torch.Tensor] = None   # [U, S] of +inf
        self._pending: list = []                   # list of [U, n] tensors
        self._pending_cols = 0
        self.flush_cols = flush_blocks * samplesize
        self.merges = 0                            # sorted merges launched

    def _init(self, u: int, device) -> None:
        self.units = u
        self._inf = torch.full((u, self.samplesize), torch.inf, device=device)
        self._levels = [self._inf] * self.depth
        self._fills = np.zeros((self.depth,), np.int64)

    def add(self, batch) -> None:
        """batch: [N, U]."""
        batch = _f32(batch)
        self.add_columns([batch.T], batch.shape[0])

    def add_columns(self, pieces: Iterable[torch.Tensor], n: int) -> None:
        """Add ``n`` columns given as consecutive [U, n_i] pieces (the
        transposed stream, in order): a large batch streams through here in
        slabs without ever being held whole."""
        pieces = iter(pieces)
        if self._levels is None:
            first = next(pieces)
            self._init(first.shape[0], first.device)
            pieces = chain([first], pieces)
        self.count += n
        if self._pending_cols + n < self.flush_cols:
            for p in pieces:
                assert p.shape[0] == self.units
                self._pending.append(_f32(p))
            self._pending_cols += n
            return
        # a flush of everything pending plus these n columns
        s = self.samplesize
        n_chunks = -(-(self._pending_cols + n) // s)
        flips = self._flips(n_chunks, self.depth)
        chunk = 0
        buf = None
        for p in chain(self._pending, pieces):
            assert p.shape[0] == self.units
            buf = _f32(p) if buf is None else torch.cat([buf, _f32(p)], dim=1)
            full = buf.shape[1] // s
            if full:
                sorted_chunks = torch.sort(
                    buf[:, :full * s].reshape(self.units, full, s), dim=2).values
                for j in range(full):
                    self._insert(sorted_chunks[:, j], s, flips[chunk])
                    chunk += 1
                buf = buf[:, full * s:]
        if buf is not None and buf.shape[1]:
            rest = buf.shape[1]
            pad = self._inf[:, :s - rest]
            self._insert(torch.sort(torch.cat([buf, pad], dim=1), dim=1).values,
                         rest, flips[chunk])
            chunk += 1
        assert chunk == n_chunks
        self._pending = []
        self._pending_cols = 0

    def _insert(self, carry: torch.Tensor, fc: int, flips) -> None:
        """Cascade one sorted, +inf padded chunk of ``fc`` real columns up the
        levels (``_pair_merge`` of the JAX package, with the fills on the
        host: only merges that change a level run)."""
        s, top = self.samplesize, self.depth - 1
        levels, fills = self._levels, self._fills
        for l in range(self.depth):
            if fc == 0:
                return
            fx = int(fills[l])
            tot = fx + fc
            if fx == 0:                       # an empty level takes the carry
                # (its own copy: a chunk is a view of the whole flush block)
                levels[l], fills[l] = carry.contiguous(), fc
                return
            cat = torch.sort(torch.cat([levels[l], carry], dim=1), dim=1).values
            self.merges += 1
            if tot <= s:                      # the union fits: stays here
                levels[l], fills[l] = cat[:, :s], tot
                return
            off = bool(flips[l])
            over = cat[:, 1::2] if off else cat[:, 0::2]
            fo = tot // 2 if off else (tot + 1) // 2
            if l == top:                      # graceful decay at the top
                levels[l], fills[l] = over, fo
                return
            levels[l], fills[l] = self._inf, 0
            carry, fc = over, fo

    def _weighted_sorted(self):
        """(v_sorted [U, M], cum-weights [U, M], totals [U, 1]) over every
        retained sample (sketch levels at weight 2^l plus raw pending)."""
        vals, weights = [], []
        if self._levels is not None:
            for l in range(self.depth):
                f = int(self._fills[l])
                if f == 0:
                    continue
                vals.append(self._levels[l][:, :f].cpu().numpy())
                weights.append(np.full((f,), 2.0 ** l))
        for blk in self._pending:                    # raw weight-1 samples
            b = blk.cpu().numpy()
            vals.append(b)
            weights.append(np.ones((b.shape[1],)))
        v = np.concatenate(vals, axis=1)            # [U, M]
        w = np.concatenate(weights)                 # [M]
        order = np.argsort(v, axis=1)
        v_sorted = np.take_along_axis(v, order, axis=1)
        cum = np.cumsum(w[order], axis=1)
        return v_sorted, cum, cum[:, -1:]

    def quantiles(self, qs) -> np.ndarray:
        """qs: scalar or [Q] in [0,1] -> [U, Q] estimated quantiles."""
        qs = np.atleast_1d(np.asarray(qs, np.float64))
        v_sorted, cum, total = self._weighted_sorted()
        # weighted quantile: first index with cum >= q * total
        out = np.empty((v_sorted.shape[0], qs.size), np.float32)
        for qi, q in enumerate(qs):
            idx = np.argmax(cum >= q * total, axis=1)
            out[:, qi] = np.take_along_axis(v_sorted, idx[:, None], axis=1)[:, 0]
        return out

    def normalize(self, levels) -> np.ndarray:
        """Inverse of :meth:`quantiles`: estimated CDF position of given
        values, per unit (reference ``runningstats.py`` ``normalize``).

        ``levels``: [U] or [U, K] -> [U, K] fractions in [0, 1]; fraction of
        the stream <= the level (so ``1 - normalize(x)`` is the exceedance
        probability used by the max-IoU search)."""
        levels = np.asarray(levels, np.float32)
        if levels.ndim == 1:
            levels = levels[:, None]
        v_sorted, cum, total = self._weighted_sorted()
        out = np.empty(levels.shape, np.float32)
        for u in range(levels.shape[0]):
            pos = np.searchsorted(v_sorted[u], levels[u], side="right")
            cdf = np.concatenate([[0.0], cum[u]])[pos]
            out[u] = cdf / max(float(total[u, 0]), 1e-30)
        return out

    def readout(self, n: int = 1001) -> np.ndarray:
        return self.quantiles(np.linspace(0.0, 1.0, n))

    def state_dict(self) -> Dict[str, np.ndarray]:
        pending = (np.concatenate([b.cpu().numpy() for b in self._pending], 1)
                   if self._pending else
                   np.zeros((self.units or 0, 0), np.float32))
        return {"samplesize": np.int64(self.samplesize),
                "depth": np.int64(self.depth), "count": np.int64(self.count),
                "fills": self._fills.astype(np.int32) if self._fills is not None
                else np.zeros((0,), np.int32),
                "levels": torch.stack(self._levels).cpu().numpy()
                if self._levels is not None else np.zeros((0,)),
                "pending": pending}

    def set_state_dict(self, d, device="cpu") -> "RunningQuantile":
        self.samplesize = int(d["samplesize"])
        self.depth = int(d["depth"])
        self.count = int(d["count"])
        levels = d["levels"]
        if levels.size:
            self._init(levels.shape[1], device)
            self._levels = list(_f32(levels, device).unbind(0))
            self._fills = np.asarray(d["fills"], np.int64).copy()
        else:
            self._levels = self._fills = self._inf = None
            self.units = None
        pending = d.get("pending")
        self._pending = []
        self._pending_cols = 0
        if pending is not None and pending.size:
            if self.units is None:
                self._init(pending.shape[0], device)
            self._pending = [_f32(pending, device)]
            self._pending_cols = pending.shape[1]
        return self


class RunningConditionalQuantile:
    """Per-condition quantile sketches (reference ``runningstats.py:458-574``)."""

    def __init__(self, samplesize: int = 1024, depth: int = 12):
        self.samplesize = samplesize
        self.depth = depth
        self._sketches: Dict = {}

    def add(self, condition, batch) -> None:
        if condition not in self._sketches:
            self._sketches[condition] = RunningQuantile(self.samplesize, self.depth)
        self._sketches[condition].add(batch)

    def keys(self):
        return self._sketches.keys()

    def conditional(self, condition) -> RunningQuantile:
        return self._sketches[condition]

    def has_conditional(self, condition) -> bool:
        return condition in self._sketches

    def state_dict(self):
        return {str(k): v.state_dict() for k, v in self._sketches.items()}

    def set_state_dict(self, d, device="cpu") -> "RunningConditionalQuantile":
        """Inverse of :meth:`state_dict`; integer-typed condition keys are
        restored as ints (the dissection passes key conditions by label
        number)."""
        self._sketches = {}
        for k, sub in d.items():
            cond = (int(k) if isinstance(k, str) and k.lstrip("-").isdigit()
                    else k)
            self._sketches[cond] = RunningQuantile(
                self.samplesize, self.depth).set_state_dict(sub, device)
        return self


# ---------------------------------------------------------------------------
# Cross-covariance / variance
# ---------------------------------------------------------------------------

_CROSS_KEYS = ("count", "mean_a", "mean_b", "cmom", "vm_a", "vm_b")


def _cross_update(state, a: torch.Tensor, b: torch.Tensor):
    """One Chan-style merge of the batch (a [N, Da], b [N, Db]) into the
    state; the count is a float32 device scalar, as in the JAX package."""
    count, mean_a, mean_b, cmom, vm_a, vm_b = state
    n = float(a.shape[0])
    new_count = count + n
    bm_a, bm_b = a.mean(dim=0), b.mean(dim=0)
    da, db = bm_a - mean_a, bm_b - mean_b
    f = n / new_count
    w = count * n / new_count
    ac, bc = a - bm_a, b - bm_b
    with ieee_f32():
        cross = ac.T @ bc
    return (new_count, mean_a + da * f, mean_b + db * f,
            cmom + cross + torch.outer(da, db) * w,
            vm_a + torch.sum(ac * ac, dim=0) + da * da * w,
            vm_b + torch.sum(bc * bc, dim=0) + db * db * w)


class RunningCrossCovariance:
    """Streaming cross-covariance between two unit sets."""

    def __init__(self):
        self._state = None

    def add(self, a, b) -> None:
        a = _f32(a)
        b = _f32(b, a.device)
        if self._state is None:
            da, db = a.shape[1], b.shape[1]
            z = lambda *s: torch.zeros(s, device=a.device)  # noqa: E731
            self._state = (z(), z(da), z(db), z(da, db), z(da), z(db))
        self._state = _cross_update(self._state, a, b)

    @property
    def count(self) -> float:
        return float(self._state[0])

    def mean(self):
        return self._state[1].cpu().numpy(), self._state[2].cpu().numpy()

    def covariance(self) -> np.ndarray:
        return (self._state[3] / (self._state[0] - 1.0)).cpu().numpy()

    def correlation(self) -> np.ndarray:
        _, _, _, cmom, vm_a, vm_b = self._state
        denom = torch.sqrt(torch.outer(vm_a, vm_b))
        return (cmom / torch.clamp(denom, min=1e-30)).cpu().numpy()

    def state_dict(self):
        return {k: v.cpu().numpy() for k, v in zip(_CROSS_KEYS, self._state)}

    def set_state_dict(self, d, device="cpu"):
        self._state = tuple(_f32(d[k], device) for k in _CROSS_KEYS)
        return self


class RunningVariance:
    """Chan mean/variance per unit."""

    def __init__(self):
        self.count = 0.0
        self._mean = None
        self._m2 = None

    def add(self, batch) -> None:
        batch = _f32(batch)
        n = batch.shape[0]
        bm = batch.mean(dim=0)
        bv = batch.var(dim=0, unbiased=False)
        if self._mean is None:
            self._mean, self._m2, self.count = bm, bv * n, float(n)
            return
        new_count = self.count + n
        delta = bm - self._mean
        self._mean = self._mean + delta * (n / new_count)
        self._m2 = self._m2 + bv * n + delta * delta * (self.count * n / new_count)
        self.count = new_count

    def mean(self) -> np.ndarray:
        return self._mean.cpu().numpy()

    def variance(self, ddof: int = 1) -> np.ndarray:
        return (self._m2 / (self.count - ddof)).cpu().numpy()

    def stdev(self, ddof: int = 1) -> np.ndarray:
        return np.sqrt(self.variance(ddof))
