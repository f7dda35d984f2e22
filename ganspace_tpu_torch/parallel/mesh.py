"""Process-group mesh, sharding helpers and collectives
(``ganspace_tpu/parallel/mesh.py`` on ``torch.distributed``).

The JAX package runs one program over a device mesh; here each device is
one process (a *rank*) and the mesh is the process group:

* **data parallelism** for synthesis: a latent batch splits into row
  shards over the ``data`` axis, each rank synthesizing its rows on its own
  device; parameters are replicated (each rank builds the same model).
  The fused streams deal whole blocks to the ranks by index instead.
* **feature parallelism** for estimator statistics: when the world size
  divides the feature dim D, each rank keeps its ``D / world`` slice of the
  sketch's and the regression's [D, .] state after the pass's merge
  (``feature_sharding``); the moments tier's scatter is merged whole, as
  rank 0's eigendecomposition reads all of it.  On a
  ``data x model`` mesh rows shard over ``data`` only and features over all
  ranks, as in the JAX package.

Statistics are per rank while a pass streams and are merged once per pass:
sums by all-reduce (reduce-scatter along D where the state is sharded),
``(count, mean, M2)`` by the pairwise Chan merge over the ranks in order.
A decision every rank must agree on (the sketch's refine) is made on
rank 0 and broadcast.

Backends: NCCL between GPUs; gloo on the CPU, and for ranks that share one
card, which only an explicit ``devices=`` list asks for.  Gloo stages a
collective of CUDA tensors through host memory (a branch on the backend
below, never a caught NCCL failure).

Processes: under ``torchrun`` a rank reads ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` from the environment; otherwise :func:`launch` starts one
process per rank with the ``spawn`` start method (CUDA does not survive a
fork) and a ``FileStore`` rendezvous in a temporary directory.  A mesh of
one rank runs in the calling process.  Rank 0 prints and writes files; the
other ranks' standard output goes to ``os.devnull``.

Without a process group, a one-device mesh collapses to ``None`` and the
caller keeps the single-device path.
"""

from __future__ import annotations

import math
import os
import pickle
import sys
import tempfile
from datetime import timedelta
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist

#: the mesh of the process group this process is a rank of (set by
#: :func:`launch` and by the ``torchrun`` path of :func:`init_from_env`)
_CURRENT: Optional["Mesh"] = None

#: collective timeout of the process groups made here
TIMEOUT = timedelta(minutes=30)


def parse_shape(shape: Optional[str]) -> Optional[tuple]:
    """``'8'`` -> (8,), ``'4x2'`` -> (4, 2); None stays None."""
    if not shape:
        return None
    dims = tuple(int(s) for s in str(shape).lower().split("x"))
    if not dims or len(dims) > 2 or min(dims) < 1:
        raise ValueError(f"Mesh shape {shape!r}: expected 'N' or 'AxB'")
    return dims


def _axis_names(dims: tuple) -> tuple:
    return ("data",) if len(dims) == 1 else ("data", "model")


def visible_devices() -> list:
    """The devices a default mesh takes: every visible GPU (a CPU mesh
    names its ranks' devices explicitly)."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return []


def resolve_devices(dims: Optional[tuple], devices=None):
    """``(dims, devices)`` of a mesh: ``devices`` is a list (an entry may
    repeat, which co-locates ranks on one card), ``"cpu"`` (any number of
    CPU ranks) or None (every visible GPU).  Raises ``ValueError`` when the
    shape needs more devices than there are, as the JAX package does."""
    if isinstance(devices, str) and devices == "cpu":
        dims = dims or (1,)
        return dims, [torch.device("cpu")] * math.prod(dims)
    have = ([torch.device(d) for d in devices] if devices is not None
            else visible_devices())
    dims = dims or (max(len(have), 1),)
    need = math.prod(dims)
    if need > len(have):
        raise ValueError(f"Mesh shape {dims} needs {need} devices, have {len(have)}")
    return dims, have[:need]


class Mesh:
    """A ``data`` (x ``model``) mesh of ranks, one device each.

    ``shape`` is the JAX package's ``dict(mesh.shape)``; ``rank`` is this
    process's place in it (0 without a process group)."""

    def __init__(self, dims: tuple, devices: Sequence[torch.device], rank: int = 0,
                 backend: Optional[str] = None):
        self.axis_names = _axis_names(dims)
        self.shape = dict(zip(self.axis_names, dims))
        self.devices = list(devices)
        self.size = math.prod(dims)
        self.rank = rank
        self.backend = backend
        self.device = self.devices[rank]

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank}, {self.backend})"

    # -- layout -----------------------------------------------------------
    @property
    def active(self) -> bool:
        """True when this mesh's process group is up (collectives work)."""
        return self.backend is not None and dist.is_initialized()

    @property
    def n_data(self) -> int:
        return self.shape["data"]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape.get("model", 1)

    @property
    def owns_rows(self) -> bool:
        """Whether this rank synthesizes rows: one rank per ``data`` index
        (the ``model`` axis shards features, not rows)."""
        return self.rank % self.shape.get("model", 1) == 0

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def row_range(self, n: int) -> tuple:
        """``(lo, hi)``: this rank's rows of an ``n``-row batch.  A batch that
        divides the ``data`` axis splits evenly; one that does not stays
        unsharded, on rank 0 (``shard_batch``'s rule)."""
        if not self.owns_rows:
            return 0, 0
        if n % self.n_data:
            return (0, n) if self.is_root else (0, 0)
        per = n // self.n_data
        return self.data_index * per, (self.data_index + 1) * per

    def my_blocks(self, n_blocks: int) -> range:
        """Block indices dealt to this rank: ``i % n_data == data_index``."""
        if not self.owns_rows:
            return range(0)
        return range(self.data_index, n_blocks, self.n_data)

    def feature_sharding(self, d: int) -> Optional[slice]:
        """This rank's slice of a feature dim ``d`` split over all ranks, or
        None (replicated state) when the world size does not divide it."""
        if d % self.size:
            return None
        per = d // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    # -- collectives --------------------------------------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        """Gloo runs a collective of CUDA tensors through host memory."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks (a new tensor on ``t``'s device)."""
        if self._staged(t):
            h = t.cpu().contiguous()
            dist.all_reduce(h)
            return h.to(t.device)
        t = t.contiguous().clone()
        dist.all_reduce(t)
        return t

    def sum_scalar(self, v: float) -> float:
        """A Python number summed over ranks, in float64."""
        t = torch.tensor([float(v)], dtype=torch.float64,
                         device=self.device if self.backend == "nccl" else "cpu")
        dist.all_reduce(t)
        return float(t.item())

    def reduce_scatter(self, t: torch.Tensor, part: Optional[slice]) -> torch.Tensor:
        """The sum over ranks of ``t`` [D, ...], of which this rank keeps
        rows ``part`` (all of them when ``part`` is None)."""
        if part is None:
            return self.all_reduce(t)
        t = t.contiguous()
        if self.backend == "nccl":
            out = torch.empty((part.stop - part.start, *t.shape[1:]), dtype=t.dtype,
                              device=t.device)
            dist.reduce_scatter_tensor(out, t)
            return out
        # gloo has no reduce-scatter: reduce all, keep the slice
        return self.all_reduce(t)[part].contiguous()

    def reduce_root(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """The sum over ranks on rank 0 (None elsewhere): rows that the
        ranks filled apart, gathered."""
        t = t.contiguous()
        h = t.cpu() if self._staged(t) else t
        dist.reduce(h, 0)
        return h.to(t.device) if self.is_root else None

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' equal-shaped ``t`` [k, ...] stacked in rank order
        along dim 0 (a feature-sharded operand made whole)."""
        t = t.contiguous()
        if self.backend == "gloo":
            h = t.cpu()
            parts = [torch.empty_like(h) for _ in range(self.size)]
            dist.all_gather(parts, h)
            return torch.cat(parts).to(t.device)
        out = torch.empty((self.size * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t)
        return out

    def all_gather_object(self, obj) -> list:
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank (shape and dtype known everywhere)."""
        t = t.contiguous()
        if self._staged(t):
            h = t.cpu()
            dist.broadcast(h, 0)
            return h.to(t.device)
        dist.broadcast(t, 0)
        return t

    def decide(self, value):
        """Rank 0's ``value`` (any picklable object) on every rank: the one
        place a decision is made, so that no two ranks diverge on a tie."""
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def chan_merge(self, count: float, mean: torch.Tensor, m2: torch.Tensor):
        """Merge the ranks' ``(count, mean [D], M2)`` (M2 [D] of variances or
        [D, D] of a scatter) by the pairwise Chan update in rank order into
        ``(count, mean, M2)`` on every rank.  Ranks with no samples drop
        out, so a single contributor passes through bit for bit."""
        stats = self.all_gather_object((float(count), mean.cpu()))
        n, mu, corr = 0.0, None, None
        matrix = m2.ndim == 2
        for c, m in stats:
            if c == 0:
                continue
            m = m.to(mean.device)
            if mu is None:
                n, mu = c, m
                continue
            total = n + c
            delta = m - mu
            term = (torch.outer(delta, delta) if matrix else torch.square(delta)) * (n * c / total)
            corr = term if corr is None else corr + term
            mu = mu + delta * (c / total)
            n = total
        if mu is None:
            mu = torch.zeros_like(mean)
        summed = self.all_reduce(m2)
        if corr is not None:
            summed = summed + corr
        return n, mu, summed

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


# ---------------------------------------------------------------------------
# JAX's names
# ---------------------------------------------------------------------------

def current_mesh() -> Optional[Mesh]:
    """The mesh of the process group this process runs in, or None."""
    return _CURRENT if _CURRENT is not None and _CURRENT.active else None


def get_mesh(shape: Optional[str] = None, devices=None) -> Mesh:
    """The mesh of a ``--mesh`` string, ``'8'`` or ``'4x2'`` (axes ``data``
    and ``data x model``); default: every visible device on ``data``.

    Inside a process group: the group's mesh, whose shape must match.
    Outside one: a layout with this process as rank 0 and no collectives
    (what :func:`launch` and the CLI start their ranks from).  Raises
    ``ValueError`` when the shape needs more devices than there are."""
    cur = current_mesh()
    dims = parse_shape(shape)
    if cur is not None:
        if dims is not None and dims != tuple(cur.shape.values()):
            raise ValueError(f"Mesh shape {dims} asked for inside a process group "
                             f"of {cur.shape}")
        return cur
    dims, devs = resolve_devices(dims, devices)
    return Mesh(dims, devs)


def pipeline_mesh(shape: Optional[str] = None, device_type: str = "cuda") -> Optional[Mesh]:
    """The mesh of the production pipeline, or None for a single-device run.

    Inside a process group, the group's mesh, even of one rank (a caller
    that set one up asked for it).  Outside one, the default and a shape of
    one device are None, as a one-device mesh collapses in the JAX package;
    a shape of more devices needs a process per rank: run through
    :func:`launch` (the visualize CLI does, and takes every visible GPU by
    default) or ``torchrun``."""
    cur = current_mesh()
    if cur is not None:
        return get_mesh(shape)
    if shape is None:
        return None
    mesh = get_mesh(shape, devices="cpu" if device_type == "cpu" else None)
    if mesh.size == 1:
        return None
    raise RuntimeError(f"--mesh {shape}: {mesh.size} ranks need a process each; run "
                       "through ganspace_tpu_torch.parallel.launch (the visualize CLI "
                       "does) or torchrun")


def mesh_desc(shape: Optional[str], n: int) -> Optional[dict]:
    """``_meta["mesh"]`` of a run of ``n`` samples under ``--mesh shape``,
    without starting a process: the group's shape inside one, else the
    shape asked for; None for the default or one device outside a group,
    and when ``n`` is below the device count (the tiny-run collapse)."""
    cur = current_mesh()
    if cur is not None:
        desc, size = dict(cur.shape), cur.size
    else:
        dims = parse_shape(shape)
        if dims is None or math.prod(dims) == 1:
            return None
        desc, size = dict(zip(_axis_names(dims), dims)), math.prod(dims)
    return None if n < size else desc


def shard_batch(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's rows of ``x`` (no-op without a mesh).  A batch that does
    not divide the ``data`` axis stays unsharded, on rank 0."""
    if mesh is None or mesh.size == 1:
        return x
    lo, hi = mesh.row_range(x.shape[0])
    return x[lo:hi]


def feature_sharding(mesh: Mesh, d: int) -> Optional[slice]:
    """This rank's slice of the feature dim ``d`` (None: replicated)."""
    return mesh.feature_sharding(d)


def batch_sharding(mesh: Mesh, n: int) -> tuple:
    """This rank's ``(lo, hi)`` rows of an ``n``-row batch."""
    return mesh.row_range(n)


def replicated(mesh: Mesh) -> list:
    """The devices a replicated value lives on: every rank's."""
    return list(mesh.devices)


def reshard_for_estimator(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """[n / data, D] batch-sharded -> [n, D / world] feature-sharded, by one
    ``all_to_all_single`` (the ranks' rows in rank order).  Every rank must
    hold the same number of rows and the world size must divide D."""
    if mesh is None or mesh.size == 1:
        return x
    rows, d = x.shape
    if d % mesh.size:
        raise ValueError(f"reshard_for_estimator: D = {d} does not split over "
                         f"{mesh.size} ranks")
    per = d // mesh.size
    # [world, rows, per]: the block bound for rank j is x[:, j * per:(j + 1) * per]
    send = x.reshape(rows, mesh.size, per).transpose(0, 1).contiguous()
    if mesh.backend == "gloo":
        send_h = send.cpu()
        recv = torch.empty_like(send_h)
        sends, recvs = list(send_h.unbind(0)), list(recv.unbind(0))
        for j in range(mesh.size):      # gloo has no all-to-all: one scatter per rank
            dist.scatter(recvs[j], sends if mesh.rank == j else None, src=j)
        return recv.reshape(mesh.size * rows, per).to(x.device)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    return recv.reshape(mesh.size * rows, per)


# ---------------------------------------------------------------------------
# Processes
# ---------------------------------------------------------------------------

def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL for ranks on distinct GPUs, gloo on the CPU and for ranks that
    share a card (NCCL refuses two ranks on one GPU)."""
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    if any(d.type == "cuda" for d in devices) and any(d.type != "cuda" for d in devices):
        raise ValueError(f"a mesh of CUDA and CPU ranks: {devices}")
    return "gloo"


def _enter(dims, devices, rank: int, backend: str, store) -> Mesh:
    global _CURRENT
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank, world_size=len(devices),
                            timeout=TIMEOUT)
    _CURRENT = Mesh(dims, devices, rank, backend)
    return _CURRENT


def _leave() -> None:
    global _CURRENT
    _CURRENT = None
    if dist.is_initialized():
        dist.destroy_process_group()


def _worker(rank, fn, args, dims, devices, backend, store_path, out_dir):
    """One spawned rank: its device, the group, ``fn(mesh, *args)``, its
    result pickled into ``out_dir``."""
    if rank:
        sys.stdout = open(os.devnull, "w")
    store = dist.FileStore(store_path, len(devices))
    mesh = _enter(dims, devices, rank, backend, store)
    try:
        result = fn(mesh, *args)
    finally:
        _leave()
    with open(Path(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def init_from_env() -> Optional[Mesh]:
    """The ``torchrun`` path: join the group ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK`` describe (one GPU per local rank), or None when they are
    unset."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    global _CURRENT
    if current_mesh() is not None:
        return _CURRENT
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", (rank - local + i) % count) for i in range(world)]
    else:
        devices = [torch.device("cpu")] * world
    device = devices[rank]
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    if rank:
        sys.stdout = open(os.devnull, "w")
    _CURRENT = Mesh((world,), devices, rank, backend)
    return _CURRENT


def launch(fn, args: tuple = (), shape: Optional[str] = None, devices=None) -> list:
    """Run ``fn(mesh, *args)`` on every rank of the mesh ``shape`` asks for
    and return the ranks' results in rank order.

    ``devices``: None (every visible GPU), ``"cpu"`` or an explicit list,
    which may name one card twice to co-locate ranks (over gloo).  A mesh
    of one rank runs in this process; more ranks are spawned processes,
    each running ``fn`` (a module-level function: it is pickled) with its
    device set before anything touches it.  A rank's exception ends every
    rank and is raised here."""
    dims, devs = resolve_devices(parse_shape(shape), devices)
    backend = backend_for(devs)
    with tempfile.TemporaryDirectory(prefix="ganspace_mesh_") as tmp:
        store_path = str(Path(tmp, "store"))
        if len(devs) == 1:
            _enter(dims, devs, 0, backend, dist.FileStore(store_path, 1))
            try:
                return [fn(_CURRENT, *args)]
            finally:
                _leave()
        import torch.multiprocessing as mp
        mp.start_processes(_worker, args=(fn, args, dims, devs, backend, store_path, tmp),
                           nprocs=len(devs), join=True, start_method="spawn")
        results = []
        for rank in range(len(devs)):
            with open(Path(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def params_checksum(module: torch.nn.Module) -> float:
    """A float64 checksum of a module's parameters and buffers (each
    weighted by its position, so a swap of two tensors shows)."""
    total = 0.0
    for i, t in enumerate(list(module.parameters()) + list(module.buffers())):
        total += (i + 1) * float(t.detach().to(torch.float64).sum())
    return total

