"""Decomposition pipeline (``ganspace_tpu/decomposition.py``).

Sample latents -> run the generator to the tap -> stream blocks through the
IPCA estimator, or collect them for a full-batch one -> regress the
components back to latent space -> write the ``.npz`` cache whose keys,
``_meta`` fields and filename scheme match the JAX package's (and the
reference's, ``decomposition.py:332-341, 384-394``).

The path is chosen as the JAX package's ``_compute`` chooses it
(``decomposition.py:755-830``):

* **fused W stream** (samples-are-latents runs, ``--use_w --layer style``,
  under ``GANSPACE_DEVICE_RNG=1``, the default): ``nb_w``-sample blocks of
  latents drawn and mapped on the card, one moments update each, the
  random-direction moments riding every block;
* **fused activation stream** (a tap, ``GANSPACE_FUSED_ACTS`` ``auto``
  and at least ``GANSPACE_FUSED_ACTS_MIN_N`` samples, or ``1``): one batch
  per block, drawn on the card and synthesized to the tap, with the
  regression's cross-moments and the random moments riding each block; the
  sketch tier's refine pass regenerates the same blocks;
* otherwise the **pre-sampled stream**: every latent drawn up front (on the
  card, or on the host under ``GANSPACE_DEVICE_RNG=0`` or above
  ``GANSPACE_LATENT_HBM_BUDGET``), NB-sample blocks of partial forwards
  through ``fit_partial``, the refine sweep, and a separate regression
  sweep.  For the full-batch estimators (``pca``, ``fbpca``, ``ica``,
  ``spca``) the same blocks are collected into one sample matrix on the
  model's device (the "Collecting" sweep) and fitted at once.

``GANSPACE_DEVICE_RNG=0`` is the JAX package's bit-exact host path.

On a mesh (``--mesh``, ``parallel/mesh.py``: one process per device) every
rank builds the model on its device and runs ``_compute``: the fused
streams deal their blocks to the ranks by index, the pre-sampled stream
and the regression sweep give each rank its rows of every batch, and the
estimator merges the ranks' statistics once per pass (feature-sharded when
the world size divides D).  The full-batch estimators fit on rank 0 the
rows the ranks collected, and broadcast the components.  The samples are
the single-device run's; only the order of float32 sums differs.  Rank 0
writes the cache, with ``_meta["mesh"]`` the mesh's shape.

Precision (``compute``, JAX ``decomposition.py:608-620``): ``--dtype
float32`` (the default) fits at the highest precision, ``--dtype bfloat16``
at the preview precision (the bf16 datapath of the synthesis ops, float32
activation storage) and writes a ``_bf16`` cache graded by its own
spectrum (:func:`bf16_component_bounds`).  The float32 fit of a conv tap on
the fused stream takes a bf16 first pass (bf16 storage) once a prior run of
the same workload recorded that the adaptive policy keeps the refine pass:
the mandatory float32 refine pass then determines the estimate.  That one
fact lives in a JSON registry (:func:`_fused_acts_registry`), which is off
unless ``GANSPACE_COMPILE_CACHE`` names its directory: on an H100 the first
pass has not made a fit faster, and with it off a fit does not depend on
what earlier runs recorded.  Not ported:
the rest of the JAX package's sentinel registry (``auto`` is the
sample-count rule alone), block grouping (a TPU dispatch lever), the XLA
memory-analysis batch autotune and ``_stream_npz``.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import time
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.estimators import get_estimator
from ganspace_tpu_torch.models import get_instrumented_model
from ganspace_tpu_torch.models.base import InstrumentedModel
from ganspace_tpu_torch.ops.precision import ieee_f32, precision, synth_dtype
from ganspace_tpu_torch.parallel.mesh import mesh_desc, pipeline_mesh
from ganspace_tpu_torch.sampling import (
    SEED_LINREG, SEED_SAMPLING, STREAM_LINREG, STREAM_MAIN, STREAM_W_TAIL,
    block_generator, random_directions, random_directions_device)

#: latent stream block size when ``-b`` is not given (the JAX package's W path)
W_BATCH = 4096

#: ``mesh=`` default of :func:`compute` and :func:`get_or_compute`: the mesh
#: of ``config.mesh_shape`` (``parallel.pipeline_mesh``)
FROM_CONFIG = "config"

#: --dtype -> the synthesis precision of ``ops/precision.py``: float32 fits
#: at the highest precision (component parity with the reference), bfloat16
#: on the bf16-operand datapath (previews, big sweeps)
_DTYPE_PRECISION = {"float32": "highest", "bfloat16": "default"}

def _fused_acts_registry() -> Optional[Path]:
    """The JSON registry of facts about fused-stream workloads, in the
    directory ``GANSPACE_COMPILE_CACHE`` names (``.ganspace_torch_cache``
    of a checkout is git-ignored for it); None when the variable is unset
    or empty, as the JAX package runs without a compile cache."""
    cache_dir = os.environ.get("GANSPACE_COMPILE_CACHE", "")
    return Path(cache_dir) / "ganspace_fused_acts.json" if cache_dir else None


def _fused_acts_info(key: str) -> dict:
    """What a prior run recorded about a fused-stream workload: {} when
    unseen, else ``{"policy_refines": bool}``, whether the adaptive policy
    kept the refine pass there (JAX ``decomposition.py:71-113``)."""
    path = _fused_acts_registry()
    if path is None or not path.is_file():
        return {}
    try:
        with open(path) as f:
            value = json.load(f).get(key)
    except (OSError, ValueError):
        return {}
    return value if isinstance(value, dict) else {}


def _record_fused_acts(key: str, info: dict) -> None:
    """Merge ``info`` into the workload's record: read, update, write a
    temporary file and replace the registry with it (atomic)."""
    path = _fused_acts_registry()
    if path is None:
        return
    try:
        entries = {}
        if path.is_file():
            with open(path) as f:
                entries = json.load(f)
        entries[key] = {**entries.get(key, {}), **info}
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(entries, f)
        os.replace(tmp, path)
    except (OSError, ValueError):
        pass


def _env_on(name: str) -> bool:
    """A ``1``-defaulted switch of the JAX package (``GANSPACE_DEVICE_RNG``,
    ``GANSPACE_FUSED_LINREG``, ``GANSPACE_FUSED_RAND``)."""
    return os.environ.get(name, "1") == "1"


def _fused_wanted(n: int) -> bool:
    """``GANSPACE_FUSED_ACTS``: ``1`` on, ``0`` off, ``auto`` (the default)
    on from ``GANSPACE_FUSED_ACTS_MIN_N`` samples (20000)."""
    env = os.environ.get("GANSPACE_FUSED_ACTS", "auto")
    return env == "1" or (env == "auto" and n >= int(
        os.environ.get("GANSPACE_FUSED_ACTS_MIN_N", 20_000)))


def get_max_batch_size(inst: InstrumentedModel, layer_name=None) -> int:
    """The JAX package's heuristic batch rule (``decomposition.py:290-315``):
    a partial forward keeps ~4 live feature maps of the tap's size, and the
    minibatch fills ``GANSPACE_ACT_BUDGET`` bytes (256 MiB), clamped to
    [4, 4096] and rounded down to a power of two."""
    model = inst.model
    if layer_name is not None and inst.feature_shape.get(layer_name) is not None:
        feat_elems = int(np.prod(inst.feature_shape[layer_name][1:]))
    else:
        res = getattr(model, "resolution", 256)
        feat_elems = 3 * res * res
    per_sample = max(feat_elems, 512) * 4 * 4
    budget = int(os.environ.get("GANSPACE_ACT_BUDGET", 256 * 1024 * 1024))
    b = max(4, min(4096, budget // per_sample))
    return 1 << (b.bit_length() - 1)


def acts_stream_block(model, layer: str, batch: int, seed: int, stream: int = STREAM_MAIN,
                      with_latents: bool = True):
    """``block(i)``: block ``i`` of the fused activation stream, ``batch``
    latents drawn on the model's device from block ``i`` of ``stream`` under
    ``seed`` and synthesized to the tap; ``(acts [batch, D], latents
    [batch, zdim])``, or the activations alone.  None when the model has no
    device sampler or no pure tap function."""
    lat_fn, acts_fn = model.device_latents_fn(), model.pure_acts_fn(layer)
    if lat_fn is None or acts_fn is None:
        return None

    def block(i):
        lat = lat_fn(block_generator(seed, stream, i, model.device), batch)
        acts = acts_fn(lat)
        return (acts, lat.reshape(batch, -1)) if with_latents else acts
    return block


# ---------------------------------------------------------------------------
# Latent regression (reference decomposition.py:77-148)
# ---------------------------------------------------------------------------

def linreg_lstsq(comp, mean, stdev, inst: InstrumentedModel, config, mesh=None):
    """Solve min_M ||M A - Z|| where A are the stdev-scaled PCA coordinates
    of fresh ``SEED_LINREG`` samples: the normal equations G = sum A^T A
    (c x c) and R = sum A^T Z accumulate on the device batch by batch, then
    one float32 solve with a 1e-10 tr(G)/c ridge.

    The samples come from the regression's device stream when the fused
    stream is wanted for ``n_samp`` samples and ``GANSPACE_DEVICE_RNG=1``
    (``decomposition.py:356-414``), else from the host stream.  On a mesh
    the device stream's blocks are dealt to the ranks, the host stream's
    batches split into the ranks' rows, and the sums are added up."""
    print("Performing least squares regression", flush=True)
    model = inst.model
    model.seed_host_rng(SEED_LINREG)
    device = model.device
    comp = torch.as_tensor(comp, dtype=torch.float32, device=device)
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device).reshape(1, -1)
    stdev = torch.as_tensor(stdev, dtype=torch.float32, device=device)

    # The fit sweep's minibatch when the user pinned one; never more than
    # the sample budget (G would stay singular).
    batch = config.batch_size or get_max_batch_size(inst, layer_name=config.layer)
    batch = min(batch, max(10_000, config.n))
    n_samp = max(10_000, config.n) // batch * batch
    n_comp = comp.shape[0]
    latent_dims = model.get_latent_dims()

    device_block = None
    if _fused_wanted(n_samp) and _env_on("GANSPACE_DEVICE_RNG"):
        device_block = acts_stream_block(model, config.layer, batch, SEED_LINREG,
                                         STREAM_LINREG)

    lo, hi = mesh.row_range(batch) if mesh is not None else (0, batch)

    def host_block(_):
        z = model.sample_latent(batch)[lo:hi]
        if hi == lo:
            return None
        model.partial_forward(z, config.layer)
        return inst.retained_features()[config.layer].reshape(hi - lo, -1), z

    comp_flat = comp.reshape(n_comp, -1)
    # zero-stdev components carry no direction: divide by 1 instead of 0
    safe = torch.where(stdev > 0, stdev, torch.ones_like(stdev))[None, :]
    g = torch.zeros((n_comp, n_comp), dtype=torch.float32, device=device)
    r = torch.zeros((n_comp, latent_dims), dtype=torch.float32, device=device)
    z_sum = torch.zeros((latent_dims,), dtype=torch.float32, device=device)
    n_blocks = n_samp // batch
    blocks = (mesh.my_blocks(n_blocks) if mesh is not None and device_block is not None
              else range(n_blocks))
    for i in blocks:
        out = (device_block or host_block)(i)
        if out is None:
            continue
        act, z = out
        coords = ((act - mean) @ comp_flat.T) / safe
        zf = z.reshape(z.shape[0], -1)
        g += coords.T @ coords
        r += coords.T @ zf
        z_sum += torch.sum(zf, dim=0)
    if mesh is not None:
        g, r, z_sum = mesh.all_reduce(g), mesh.all_reduce(r), mesh.all_reduce(z_sum)

    # M^T = (A^T A)^-1 A^T Z: rows of M^T are the latent-space directions.
    ridge = 1e-10 * torch.trace(g) / g.shape[0]
    m_t = torch.linalg.solve(
        g + ridge * torch.eye(n_comp, dtype=g.dtype, device=device), r)
    z_comp = m_t[:n_comp, :].cpu().numpy()
    z_mean = z_sum.cpu().numpy()[None, :] / n_samp
    return z_comp, z_mean


def regression_from_moments(comp, mean, stdev, reg, fsum=lambda t: t, fslice=None):
    """Closed-form latent regression from the cross-moments that rode the
    fit stream (``IPCAEstimator.fit_stream(with_reg=True)``): no extra
    synthesis (``decomposition.py:489-520``).

    The normal equations are ``G M = R`` with ``coords_i = diag(1/sigma)
    C (a_i - mu)``.  ``R`` follows exactly from the raw moments, ``R =
    diag(1/sigma) C (sum a z^T - mu sum z^T)``; ``G`` is the estimator's own
    model, ``(n - 1) I``: exact on the moments tier, consistent to the
    sketch's accuracy on the sketch tier.  It holds only if the moments come
    from the pass the components were fitted on, which ``begin_refine``
    ensures by restarting them.  The caller row-normalizes the result, so
    only off-diagonal mixing separates it from the explicit solve.  On a
    feature-sharded mesh ``sum x^T z`` holds this rank's rows ``fslice`` of
    D and ``fsum`` adds the ranks' partial products."""
    xz, z_sum, n_reg = reg
    print(f"Regression from fused cross-moments ({n_reg} samples, "
          f"no extra sweep)", flush=True)
    device = xz.device
    comp = torch.as_tensor(comp, dtype=torch.float32).to(device)
    comp = comp.reshape(comp.shape[0], -1)
    mean = torch.as_tensor(mean, dtype=torch.float32).to(device).reshape(-1)
    stdev = torch.as_tensor(stdev, dtype=torch.float32).to(device)
    r, gram = _reg_solve(comp, mean, stdev, xz, z_sum, fsum, fslice)
    z_comp = r.cpu().numpy() / max(float(n_reg) - 1.0, 1.0)
    z_mean = z_sum.cpu().numpy()[None, :] / max(float(n_reg), 1.0)
    _warn_if_not_orthonormal_gram(gram.cpu().numpy())
    return z_comp, z_mean


def _reg_solve(comp, mean, stdev, xz, z_sum, fsum=lambda t: t, fslice=None):
    """``(R [c, zdim], C C^T)``: the right-hand side from the raw moments,
    and the Gram for the orthonormality check."""
    # zero-stdev components carry no direction: divide by 1 instead of 0
    safe = torch.where(stdev > 0, stdev, torch.ones_like(stdev))
    cx = fsum((comp if fslice is None else comp[:, fslice]) @ xz)
    r = (cx - torch.outer(comp @ mean, z_sum)) / safe[:, None]
    return r, comp @ comp.T


def _warn_if_not_orthonormal(comp) -> None:
    """Reference ``decomposition.py:141-148``'s sanity check, contracted on
    the components' device."""
    c = torch.as_tensor(comp, dtype=torch.float32)
    c = c.reshape(c.shape[0], -1)
    _warn_if_not_orthonormal_gram((c @ c.T).cpu().numpy())


def _warn_if_not_orthonormal_gram(m: np.ndarray) -> None:
    if not np.allclose(m, np.identity(m.shape[0]), atol=1e-3):
        print(f"WARNING: Computed basis is not orthonormal "
              f"(determinant={np.linalg.det(m)})")


def regression(comp, mean, stdev, inst, config, mesh=None):
    _warn_if_not_orthonormal(comp)
    return linreg_lstsq(comp, mean, stdev, inst, config, mesh)


#: bf16-datapath sensitivity constant (JAX ``decomposition.py:454-466``):
#: activation rounding is relative noise (bf16 half-ulp 2^-9), so component
#: i rotates by about eps_rel / rel_gap_i under it.  The JAX package's
#: calibration: 2e-3 covers its CPU sweep (5 spectrum shapes x 3 seeds,
#: measured eps_rel 1e-5 .. 2.4e-4) and its two production datapoints.
BF16_EPS_REL = 2e-3


def bf16_component_bounds(evals, n_components: int) -> np.ndarray:
    """Per-component |cos| lower-bound estimates for bf16-datapath runs
    (JAX ``decomposition.py:467-489``).  ``evals``: descending eigenvalue
    estimates of the fitted scatter (ideally >= n_components + 1).
    Component i's bound is cos(min(BF16_EPS_REL / rel_gap_i, pi / 2)), with
    rel_gap_i the smaller adjacent relative eigengap; a component whose
    lower neighbour is unresolved gets 0 (no information)."""
    ev = np.maximum(np.asarray(evals, np.float64), 1e-300)
    n = len(ev)
    bounds = np.zeros(n_components)
    for i in range(min(n_components, n)):
        rel_lo = 1.0 - ev[i] / ev[i - 1] if i > 0 else np.inf
        rel_hi = 1.0 - ev[i + 1] / ev[i] if i + 1 < n else np.nan
        if np.isnan(rel_hi):          # the spectrum stops at c: no lower gap
            continue
        rel_gap = max(min(rel_lo, rel_hi), 1e-12)
        bounds[i] = np.cos(min(BF16_EPS_REL / rel_gap, np.pi / 2.0))
    return bounds


def _partial_dump_name(dump_name: Path, config_n: int, n_fitted: int) -> Path:
    """Interrupt-time filename: swap the ``_n{N}`` token for the fitted count
    (reference ``decomposition.py:268-274``).  The cache name encodes
    ``config.n``, not the batch-rounded total."""
    return dump_name.parent / dump_name.name.replace(
        f"_n{config_n}", f"_n{n_fitted}", 1)


def _device_type(config, inst: Optional[InstrumentedModel]) -> str:
    return inst.model.device.type if inst is not None else torch.device(config.device).type


def _resolve_mesh(config, inst: Optional[InstrumentedModel], mesh):
    """``config.mesh_shape``'s mesh for ``FROM_CONFIG``, else ``mesh``."""
    if isinstance(mesh, str) and mesh == FROM_CONFIG:
        return pipeline_mesh(getattr(config, "mesh_shape", None), _device_type(config, inst))
    return mesh


def compute(config, dump_name: Path,
            instrumented_model: Optional[InstrumentedModel], mesh=FROM_CONFIG) -> dict:
    """Run the decomposition under the config's precision policy (--dtype,
    unset meaning float32); returns the wall seconds of its phases.  The
    activation storage is pinned to float32: a viewer process sets the bf16
    preview policy for itself, and components fitted on preview-grade
    activations must never reach a cache.  ``mesh``: the mesh to run on
    (every rank calls this), ``config.mesh_shape``'s by default; a run that
    collapses to one device runs on rank 0 alone."""
    dtype = getattr(config, "dtype", None) or "float32"
    if dtype not in _DTYPE_PRECISION:
        raise ValueError(f"--dtype {dtype!r}: expected 'float32' or 'bfloat16'")
    mesh = _resolve_mesh(config, instrumented_model, mesh)
    # the JAX package's tiny-run collapse (decomposition.py:652-653): below
    # as many samples as ranks, rank 0 runs alone
    run_mesh = mesh if mesh is None or config.n >= mesh.size else None
    if mesh is not None and run_mesh is None and not mesh.is_root:
        return {}
    with ieee_f32(), precision(_DTYPE_PRECISION[dtype]), synth_dtype(None):
        return _compute(config, dump_name, instrumented_model, run_mesh)


def _compute(config, dump_name: Path,
             instrumented_model: Optional[InstrumentedModel], mesh=None) -> dict:
    timestamp = lambda: datetime.datetime.now().strftime("%d.%m %H:%M")  # noqa: E731
    print(f"[{timestamp()}] Computing", dump_name.name)
    canonical_name = dump_name.name   # the full-run cache filename
    layer_key = config.layer
    phases = {}
    clock = [time.perf_counter()]

    def stamp(name):
        """Wall seconds since the last stamp, the device drained first."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        phases[name] = now - clock[0]
        clock[0] = now

    if instrumented_model is None:
        inst = get_instrumented_model(config.model, config.output_class, layer_key,
                                      mesh.device if mesh is not None
                                      else require_device(config.device))
        model = inst.model
    else:
        print("Reusing InstrumentedModel instance")
        inst = instrumented_model
        model = inst.model
        inst.remove_edits()
        model.set_output_class(config.output_class)
    model.seed_host_rng(0)

    if config.use_w:
        print("Using W latent space")
        model.use_w()
    device = model.device
    placed = model._mesh
    if mesh is not None:
        model.place_on_mesh(mesh)
        print(f"Mesh: {mesh.shape} over {mesh.size} ranks ({mesh.backend})")
    try:
        return _compute_on(config, dump_name, instrumented_model, inst, model, mesh,
                           stamp, phases, timestamp)
    finally:
        model._mesh = placed


def _compute_on(config, dump_name, instrumented_model, inst, model, mesh, stamp,
                phases, timestamp):
    canonical_name = dump_name.name   # the full-run cache filename
    layer_key = config.layer
    device = model.device
    root = mesh is None or mesh.is_root

    inst.retain_layer(layer_key)
    z_probe = model.sample_latent(1)
    model.partial_forward(z_probe, layer_key)
    feat_probe = inst.retained_features()[layer_key]
    # In W mode the mapping does not run, so the style tap cannot fire: the
    # samples there ARE the W latents.
    sample_shape = tuple((z_probe if feat_probe is None else feat_probe).shape)
    sample_dims = int(np.prod(sample_shape))
    print("Feature shape:", sample_shape)

    input_shape = model.get_latent_shape()
    input_dims = model.get_latent_dims()

    # Local clamp: the cache filename keeps the requested count.
    n_components = min(config.components, sample_dims)
    if n_components < config.components:
        print(f"WARNING: clamping components {config.components} -> "
              f"{n_components} (feature dim {sample_dims}); the cache "
              f"filename keeps the requested count")
    # Feature-sharded estimator state when D splits evenly over the mesh
    # (uneven D keeps it replicated; the rows stay sharded either way).
    transformer = get_estimator(
        config.estimator, n_components, config.sparsity, device=device, mesh=mesh,
        feature_sharding=None if mesh is None else mesh.feature_sharding(sample_dims))
    # The full-batch estimators (pca, fbpca, ica, spca) fit the whole sample
    # matrix at once; ipca streams.
    full_batch = not transformer.batch_support

    # Decomposition on a non-Gaussian latent space (reference
    # decomposition.py:239): the samples are the W latents themselves.
    samples_are_latents = (layer_key in ("g_mapping", "style")
                           and model.latent_space_name() == "W")
    if config.batch_size:
        batch = config.batch_size
    elif samples_are_latents:
        batch = W_BATCH
    else:
        batch = get_max_batch_size(inst, layer_name=layer_key)

    # Round N down to full batches, but never below one batch.
    batch = min(batch, config.n)
    if mesh is not None:
        # keep minibatches evenly shardable over the data axis
        batch = max(mesh.n_data, batch // mesh.n_data * mesh.n_data)
    n_total = config.n // batch * batch

    if full_batch:
        budget = 20 * 1_000_000_000
        feat_bytes = sample_dims * np.dtype("float64").itemsize
        if n_total > budget // feat_bytes:
            print("WARNING: estimator does not support batching, given config "
                  "will use {:.1f} GB memory.".format(feat_bytes / 1e9 * n_total))
    if config.estimator == "ica":
        lapack_max_n = np.floor_divide(np.iinfo(np.int32).max // 4, sample_dims)
        if n_total > lapack_max_n:
            raise RuntimeError(f"Matrices too large for ICA, please use N <= {lapack_max_n}")

    print("B={}, N={}, dims={}, N/dims={:.1f}".format(
        batch, n_total, sample_dims, n_total / sample_dims), flush=True)

    # Must not depend on the chosen batch size (reproducibility)
    nb = max(batch, max(2_000, 3 * n_components))

    # The full-batch sample matrix, on the model's device: deliberately
    # n_total + nb rows with the tail left zero, and the fit runs over ALL
    # of them, as the JAX package and the reference do
    # (decomposition.py:224,267,278-285: N + NB rows allocated, ceil(N/NB)
    # blocks filled, the fit on "all samples"), so that the caches match.
    samples = (torch.zeros((n_total + nb, sample_dims), dtype=torch.float32, device=device)
               if full_batch else None)

    # -- the path (decomposition.py:751-830) --------------------------------
    seed0 = config.seed or SEED_SAMPLING
    model.seed_host_rng(seed0)
    n_lat = ((n_total + nb - 1) // batch + 1) * batch
    on_device = n_lat * int(np.prod(input_shape[1:])) * 4 < int(
        os.environ.get("GANSPACE_LATENT_HBM_BUDGET", 8 * 1024 ** 3))
    device_rng = _env_on("GANSPACE_DEVICE_RNG")
    lat_fn = model.device_latents_fn()
    # the streaming tiers are IPCA's alone (the JAX package's getattr guards)
    use_moments = getattr(transformer, "_use_moments", lambda d: False)(sample_dims)
    streamable = use_moments or getattr(transformer, "_use_nystrom",
                                        lambda d: False)(sample_dims)
    fused = samples_are_latents and device_rng and lat_fn is not None and use_moments
    want_reg = _env_on("GANSPACE_FUSED_LINREG")
    acts_block = (None if samples_are_latents
                  else acts_stream_block(model, layer_key, batch, seed0,
                                         with_latents=want_reg))
    fused_acts = (_fused_wanted(n_total) and acts_block is not None and device_rng
                  and streamable and batch >= n_components)
    rand_dirs = (random_directions_device(n_components, sample_dims, device)
                 if (fused or fused_acts) and _env_on("GANSPACE_FUSED_RAND") else None)
    # Which stream actually produced the samples (the _meta record): the
    # pre-sampled path draws on the host above the latent budget or for a
    # model without a device sampler.
    device_rng_used = fused or fused_acts
    latent_chunks = []
    if not device_rng_used:
        latent_chunks = (model.sample_latents_device(n_lat // batch, batch, seed0)
                         if on_device and device_rng else None)
        device_rng_used = latent_chunks is not None
        if latent_chunks is None:
            # above the budget the latents wait on the host, one batch at a
            # time on the device
            latent_chunks = model.sample_latents_prefetched(
                n_lat // batch, batch, keep_on=None if on_device else "cpu")

    def latent_slice(start, stop):
        i0, i1 = start // batch, -(-stop // batch)
        block = torch.cat(latent_chunks[i0:i1], dim=0)
        return block[start - i0 * batch:stop - i0 * batch].to(device)

    n_blocks = max(1, -(-n_total // nb))

    def make_block(gi):
        """One NB-sample block: ceil(NB / B) partial forwards over
        consecutive latents, cut to NB (the last block may run past
        n_total, as in the JAX package).  ``(rows, index)``: this rank's
        rows of every forward's batch (all of them off a mesh) and their
        indices in the block, ascending."""
        if samples_are_latents:
            lo, hi = mesh.row_range(nb) if mesh is not None else (0, nb)
            return (latent_slice(gi + lo, gi + hi).reshape(hi - lo, -1),
                    torch.arange(lo, hi, device=device))
        lo, hi = mesh.row_range(batch) if mesh is not None else (0, batch)
        starts = range(0, nb, batch)
        chunks = []
        for mb in starts:
            if hi > lo:
                z = latent_slice(gi + mb, gi + mb + batch)[lo:hi]
                model.partial_forward(z, layer_key)
                chunks.append(inst.retained_features()[layer_key].reshape(hi - lo, -1))
        index = torch.cat([torch.arange(mb + lo, mb + hi) for mb in starts])
        keep = int(torch.sum(index < nb))   # a prefix: the indices ascend
        rows = (torch.cat(chunks, dim=0) if chunks
                else torch.zeros((0, sample_dims), dtype=torch.float32, device=device))
        return rows[:keep], index[:keep].to(device)

    def whole(rows):
        """A block held whole by this rank, in ``make_block``'s form."""
        return rows, torch.arange(rows.shape[0], device=device)

    stamp("setup")

    def run_sweep(action, feed=lambda gi, xb: transformer.fit_partial(xb[0])):
        """Stream every NB block through ``feed(gi, (rows, index))``;
        returns the last assembled block (kept for the stdev baselines)."""
        xb = None
        for bi, gi in enumerate(range(0, n_total, nb)):
            xb = make_block(gi)
            if not feed(gi, xb):
                break
            print(f"\r{action} batches (NB={nb}): {bi + 1}/{n_blocks}",
                  end="", flush=True)
        print()
        return xb

    def interrupted():
        nonlocal dump_name
        n_fitted = transformer.n_samples_seen_
        dump_name = _partial_dump_name(dump_name, config.n, n_fitted)
        print(f'Saving current state to "{dump_name.name}" before exiting')
        return True

    canceled = False
    bf16_pass1 = bf16_pass1_aborted = False
    x_block = None   # the zeros fallback below covers an interrupted sweep
    if fused:
        # Large blocks (a W block is one mapping, ~ms of GEMMs); small runs
        # keep >= 8 blocks.  Whole nb_w blocks, then the remainder in NB
        # blocks on the tail stream: the overshoot stays under one NB block.
        nb_w = min(int(os.environ.get("GANSPACE_W_STREAM_NB", 65536)),
                   max(nb, n_total // 8))
        n_stream_blocks = n_total // nb_w
        rem = n_total - n_stream_blocks * nb_w
        n_tail_blocks = -(-rem // nb) if rem else 0
        print(f"Fitting fused latent stream: {n_stream_blocks} blocks of {nb_w}"
              + (f" + {n_tail_blocks} of {nb}" if n_tail_blocks else "")
              + (" (+rand moments)" if rand_dirs is not None else ""), flush=True)

        def w_stream(stream, n):
            return lambda i: lat_fn(block_generator(seed0, stream, i, device),
                                    n).reshape(n, -1)
        try:
            for stream, n, count in ((STREAM_MAIN, nb_w, n_stream_blocks),
                                     (STREAM_W_TAIL, nb, n_tail_blocks)):
                if not transformer.fit_stream(w_stream(stream, n), count,
                                              rand_dirs=rand_dirs):
                    raise RuntimeError("fused latent stream unavailable for this "
                                       "estimator")
            if transformer.rand_moments() is None and root:
                x_block = whole(w_stream(STREAM_MAIN, nb_w)(0))
        except KeyboardInterrupt:
            canceled = interrupted()
            x_block = None
    elif fused_acts:
        n_stream_blocks = -(-n_total // batch)
        print(f"Fitting fused activation stream: {n_stream_blocks} blocks of "
              f"{batch}" + (" (+regression moments)" if want_reg else ""), flush=True)
        # The workload's identity in the registry (JAX decomposition.py:794-800)
        fused_key = "|".join([
            config.model, str(config.output_class), layer_key, f"b{batch}",
            f"D{sample_dims}", transformer.get_param_str(),
            getattr(config, "dtype", None) or "float32",
            "reg2" if want_reg else "reg0",
            "rand2" if _env_on("GANSPACE_FUSED_RAND") else "rand0"])
        # The bf16 first pass (JAX decomposition.py:1008-1036): when a prior
        # run of this workload recorded that the adaptive policy keeps the
        # refine pass (a flat spectrum), pass 1 streams bf16-stored
        # activations to find the sketch's subspace and the mandatory
        # float32 refine pass determines the estimate.  The first run is
        # all float32; GANSPACE_BF16_PASS1=0 opts out; a never-refine
        # policy rules it out.  A model whose storage stays float32 under the
        # policy (DCGAN) streams float32 in both passes, as in JAX.
        bf16_pass1 = (
            _env_on("GANSPACE_BF16_PASS1")
            and (getattr(config, "dtype", None) or "float32") == "float32"
            and transformer._use_nystrom(sample_dims)
            and transformer.refine_policy not in ("0", "never", "off", "false")
            and _fused_acts_info(fused_key).get("policy_refines") is True)
        if mesh is not None:
            bf16_pass1 = mesh.decide(bf16_pass1)
        pass1_block, refine_stream = acts_block, None
        if bf16_pass1:
            with synth_dtype("bfloat16"):
                pass1_block = acts_stream_block(model, layer_key, batch, seed0,
                                                with_latents=want_reg)
            refine_stream = acts_block
            print("bf16 first pass (subspace discovery); float32 refine pass "
                  "determines the estimate", flush=True)
        try:
            if not transformer.fit_stream(pass1_block, n_stream_blocks,
                                          with_reg=want_reg, rand_dirs=rand_dirs,
                                          refine_stream=refine_stream):
                raise RuntimeError("fused activation stream unavailable for "
                                   "this estimator")
            if transformer.rand_moments() is None and root:
                x_block = acts_block(0)
                x_block = whole(x_block[0] if want_reg else x_block)
            # The policy's decision, for the next run's choice of pass 1
            pws = transformer.policy_would_skip
            if pws is not None and root:
                _record_fused_acts(fused_key, {"policy_refines": not pws})
        except KeyboardInterrupt:
            # fit_stream refines inside: an interrupt in its second pass falls
            # back to the completed first pass and its accumulators.
            transformer.abort_refine()
            canceled = interrupted()
            x_block = None
            if bf16_pass1 and not transformer._refined:
                # The save derives from the bf16 first pass: preview grade,
                # so it takes the _bf16 tag and never an f32 cache's name.
                bf16_pass1_aborted = True
                dump_name = dump_name.with_name(dump_name.name.replace(".npz", "_bf16.npz"))
                print("WARNING: interrupted before the float32 refine pass completed — "
                      "the partial save derives from the bf16 first pass (preview "
                      "grade; saved under the _bf16 tag, _meta records "
                      "bf16_pass1_aborted)", file=sys.stderr)
    elif full_batch:
        def collect(gi, xb):
            rows, index = xb
            samples[gi + index] = rows
            return True
        try:
            run_sweep("Collecting", collect)
        except KeyboardInterrupt:
            sys.exit(1)  # nothing fitted yet
    else:
        try:
            x_block = run_sweep("Fitting")
        except KeyboardInterrupt:
            canceled = interrupted()
    stamp("pass1")

    # Sketch-tier refine sweep of the pre-sampled stream (the fused streams
    # refine inside fit_stream): the latents are kept, so one more sweep buys
    # a power iteration on the scatter, unless the adaptive policy finds the
    # first-pass sketch resolved (the moments tier never refines).
    if (not canceled and not (fused or fused_acts or full_batch)
            and transformer.should_refine() and transformer.begin_refine()):
        try:
            run_sweep("Refine pass")
        except KeyboardInterrupt:
            # A partial second pass is strictly worse than the completed
            # first-pass sketch: fall back to it.
            transformer.abort_refine()
            print("\nRefine pass interrupted — saving the completed "
                  "single-pass estimate before exiting")
            canceled = True
    stamp("refine")

    x_centered = None   # rank 0's first centered rows, for the stdev baselines
    if full_batch:
        # The global mean over all n_total + nb rows, the zero tail included
        # (decomposition.py:1203-1212), then the whole-batch fit, on rank 0
        # of a mesh (the ranks filled their rows of the matrix apart).
        if mesh is not None:
            samples = mesh.reduce_root(samples)
        fitted = None
        if root:
            mean_t = torch.mean(samples, dim=0, keepdim=True)
            samples -= mean_t
            print(f"[{timestamp()}] Fitting whole batch")
            t_start_fit = datetime.datetime.now()
            transformer.fit(samples)
            n_iter = getattr(transformer, "n_iter_", None)
            print(f"[{timestamp()}] Done in {datetime.datetime.now() - t_start_fit}"
                  + ("" if n_iter is None else f", {n_iter} iterations"))
            if not np.all(np.abs(transformer.mean_) < 1e-3):
                raise AssertionError("Mean of normalized data should be zero")
            # the random baselines read the first 5000 centered rows; the
            # rest of the matrix goes before the regression sweep
            x_centered = samples[:5000].clone()
            # the full-batch estimators hand back host arrays
            fitted = (mean_t.cpu().numpy(), *transformer.get_components())
        del samples
        if mesh is not None:
            fitted = mesh.decide(fitted)
        x_global_mean, x_comp, x_stdev, x_var_ratio = fitted
        x_comp = torch.as_tensor(x_comp, device=device)
        stamp("fit")
    else:
        if canceled and transformer.n_samples_seen_ == 0:
            print("Nothing fitted before the interrupt — exiting without a "
                  "partial save")
            sys.exit(1)
        x_global_mean = transformer.mean_.reshape((1, sample_dims))
        if x_block is None:
            x_block = whole(torch.zeros((1, sample_dims), dtype=torch.float32,
                                        device=device))
        rows, index = x_block
        x_centered = rows[index < 5000] - torch.as_tensor(x_global_mean, device=device)

    # The components stay on the device for the regression; samples-are-
    # latents runs take the moments tier's bundle (lat_stdev and the random
    # baselines included).
    rand_mom = (getattr(transformer, "rand_moments", lambda: None)()
                if device_rng_used else None)
    bundle_stats = None
    if samples_are_latents and not full_batch:
        bundle = getattr(transformer, "finish_latent_bundle",
                         lambda **_k: None)(rand_moments=rand_mom)
        if bundle is not None:
            x_comp, bundle_stats = bundle
            x_stdev, x_var_ratio = bundle_stats[0], bundle_stats[1]
    if bundle_stats is None and not full_batch:
        x_comp, x_stdev, x_var_ratio = transformer.get_components(device=True)
    if (tuple(x_comp.shape) != (n_components, sample_dims)
            or x_stdev.shape[0] != n_components):
        raise RuntimeError(f"Invalid shape: components {tuple(x_comp.shape)}, "
                           f"stdev {x_stdev.shape}")
    stamp("finish")

    # 'Activations' are latents in the W space: the components are unit
    # rows there already.  Elsewhere, regress them back to latent space,
    # from the fit stream's cross-moments when they rode it.
    fused_linreg_used = False
    if samples_are_latents:
        z_comp = x_comp.cpu().numpy()
        z_global_mean = np.array(x_global_mean)
    else:
        reg = getattr(transformer, "reg_moments", lambda: None)()
        if reg is not None:
            fused_linreg_used = True
            z_comp, z_global_mean = regression_from_moments(
                x_comp, x_global_mean, x_stdev, reg, transformer._fsum,
                transformer.feature_slice)
        else:
            z_comp, z_global_mean = regression(x_comp, x_global_mean, x_stdev,
                                               inst, config, mesh)
    stamp("regression")
    # bf16 datapath: the fitted spectrum grades the cache (every rank takes
    # part: on a feature-sharded mesh the sketch's factor sums over ranks)
    dtype = getattr(config, "dtype", None) or "float32"
    spec_ev = (getattr(transformer, "component_spectrum", lambda: None)()
               if dtype == "bfloat16" else None)
    z_comp = z_comp / np.maximum(
        np.linalg.norm(z_comp, axis=-1, keepdims=True), 1e-30)

    # Random-direction stdev baselines (reference decomposition.py:310-316).
    # From the moments that rode the stream (all n samples; variance is
    # shift-invariant, so the global-mean centering falls out), else over
    # the first 5000 centered rows of the full-batch matrix or of the last
    # block, along directions from the stream the samples came from.
    # On a mesh the pre-sampled stream's rows lie on the ranks: their
    # projections' moments are Chan-merged.
    if bundle_stats is not None and rand_mom is not None:
        x_stdev_random = bundle_stats[3]
    elif rand_mom is not None:
        _, pm2, n_r = rand_mom
        x_stdev_random = torch.sqrt(torch.clamp(pm2 / n_r, min=0.0)).cpu().numpy()
    else:
        random_dirs = (random_directions_device(n_components, sample_dims, device)
                       if device_rng_used else
                       torch.as_tensor(random_directions(n_components, sample_dims),
                                       device=device))
        if mesh is not None and not full_batch and not (fused or fused_acts):
            p = random_dirs @ x_centered.T
            mu_p = (torch.mean(p, dim=1) if p.shape[1]
                    else torch.zeros((n_components,), dtype=torch.float32, device=device))
            n_p, _, pm2 = mesh.chan_merge(p.shape[1], mu_p, torch.sum(
                torch.square(p - mu_p[:, None]), dim=1))
            x_stdev_random = torch.sqrt(torch.clamp(pm2 / n_p, min=0.0)).cpu().numpy()
        elif root:
            x_stdev_random = torch.std(random_dirs @ x_centered.T, dim=1,
                                       correction=0).cpu().numpy()
    if not root:
        # rank 0 writes the cache
        if instrumented_model is None:
            inst.close()
        return phases

    x_comp = x_comp.cpu().numpy().reshape(-1, *sample_shape)
    x_global_mean = np.array(x_global_mean).reshape(sample_shape)
    z_comp = z_comp.reshape(-1, *input_shape)
    z_global_mean = z_global_mean.reshape(input_shape)

    # Latent stdev: ones in Z.  In W, the moments tier's exact full-stream
    # projection stdev when the samples are the W latents, else the
    # reference's estimate over 5000 fresh W samples
    # (decomposition.py:324-329) from the host stream.
    lat_stdev = np.ones_like(x_stdev)
    if config.use_w:
        if bundle_stats is not None:
            lat_stdev = bundle_stats[2]
        else:
            ws = model.sample_latent(5000).reshape(5000, input_dims)
            dirs = torch.as_tensor(z_comp.reshape(-1, input_dims),
                                   dtype=torch.float32, device=device)
            lat_stdev = torch.std(dirs @ ws.T, dim=1, correction=0).cpu().numpy()
    stamp("baselines")

    if canceled and dump_name.name == canonical_name:
        # An interrupted run never claims the canonical cache path.
        dump_name = dump_name.with_name(
            dump_name.name.replace(".npz", "_partial.npz"))
        print(f'Interrupted result claims the full-run name — saving as '
              f'"{dump_name.name}" instead', file=sys.stderr)
    os.makedirs(dump_name.parent, exist_ok=True)
    # bf16 datapath: grade the cache from its own fitted spectrum
    # (bf16_component_bounds), full precision in _meta, so that the grade
    # and the list always agree.
    bf16_meta = {}
    if dtype == "bfloat16":
        if spec_ev is not None:
            bounds = bf16_component_bounds(spec_ev, n_components)
            bf16_meta = {"bf16_cos_bounds": [float(b) for b in bounds],
                         "bf16_analysis_grade": bool((bounds >= 0.99).all())}
    # Provenance sidecar with the JAX package's fields: which RNG stream
    # produced the samples, whether the regression rode it, which estimator
    # options shaped the result, the precision.
    meta = json.dumps({
        "device_rng": device_rng_used,
        "dtype": dtype,
        "mesh": dict(mesh.shape) if mesh is not None else None,
        "fused_linreg": fused_linreg_used,
        "refine_skipped": getattr(transformer, "refine_skipped", None),
        "refine_stats": getattr(transformer, "refine_stats", None),
        # the float32 refine pass determined the estimate, unless it was cut
        # (bf16_pass1_aborted: then the save is filed under _bf16)
        "bf16_pass1": bf16_pass1,
        "bf16_pass1_aborted": bf16_pass1_aborted,
        **bf16_meta,
    })
    if dtype == "bfloat16":
        _print_bf16_verdict(bf16_meta, n_components)
    # Compression pays only for small caches (float components are
    # near-incompressible).
    cache_bytes = x_comp.nbytes + z_comp.nbytes + x_global_mean.nbytes
    savez = np.savez_compressed if cache_bytes <= 8 * 1024 * 1024 else np.savez
    # Atomic write (temp + rename): an interrupt mid-write never leaves a
    # truncated file at the cache path.
    tmp_name = dump_name.with_name(f"{dump_name.stem}.{os.getpid()}.tmp.npz")
    savez(tmp_name,
          act_comp=x_comp.astype(np.float32),
          act_mean=x_global_mean.astype(np.float32),
          act_stdev=np.asarray(x_stdev, np.float32),
          lat_comp=z_comp.astype(np.float32),
          lat_mean=z_global_mean.astype(np.float32),
          lat_stdev=np.asarray(lat_stdev, np.float32),
          var_ratio=np.asarray(x_var_ratio, np.float32),
          random_stdevs=np.asarray(x_stdev_random, np.float32),
          _meta=np.bytes_(meta.encode()))
    os.replace(tmp_name, dump_name)
    stamp("npz")
    print("Phases: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))
    if os.environ.get("GANSPACE_PHASE_TRACE") == "1":
        _print_phase_trace(phases)

    if canceled:
        sys.exit(1)
    if instrumented_model is None:
        inst.close()
    return phases


def _print_phase_trace(phases: dict) -> None:
    """The phase stamps on stderr in the format of the JAX package's
    ``GANSPACE_PHASE_TRACE=1`` trace (``decomposition.py:1474-1480``): each
    phase's seconds and the seconds since the start of ``_compute``.  The
    stamps are taken whether the trace is on or not."""
    t, lines = 0.0, []
    for label, dt in phases.items():
        t += dt
        lines.append(f"  {label:18s} +{dt:7.3f}s (t={t:7.3f})")
    print("post-fit phase trace:\n" + "\n".join(lines), file=sys.stderr)


def _print_bf16_verdict(bf16_meta: dict, n_components: int) -> None:
    """The stderr verdict on a bf16-datapath cache (JAX
    ``decomposition.py:1424-1446``): certified when every bound is at least
    0.99, else NOT analysis-grade."""
    if bf16_meta.get("bf16_analysis_grade") is True:
        print("Note: bfloat16-datapath components — the fitted spectrum's eigengaps "
              "bound every component's cosine vs float32 at >= 0.99 (per-component "
              "bounds in _meta bf16_cos_bounds)", file=sys.stderr)
    elif bf16_meta:
        bad = sum(b < 0.99 for b in bf16_meta["bf16_cos_bounds"])
        print(f"WARNING: bfloat16-datapath components are NOT analysis-grade here: "
              f"{bad}/{n_components} components sit on eigengaps too small to bound "
              f"their rotation under bf16 rounding (per-component bounds in _meta "
              f"bf16_cos_bounds).  Re-run without --dtype bfloat16 for "
              f"analysis-grade components", file=sys.stderr)
    else:
        print("Note: bfloat16-datapath components (preview precision) — "
              "per-component cosine vs float32 can dip below 0.99 on flat-spectrum "
              "models; re-run without --dtype bfloat16 for analysis-grade "
              "components", file=sys.stderr)


# ---------------------------------------------------------------------------
# Cache layer (reference decomposition.py:360-402)
# ---------------------------------------------------------------------------

def component_cache_name(config) -> str:
    """The reference filename scheme (``decomposition.py:384-392``); a
    ``--dtype bfloat16`` run appends ``_bf16``, so that preview-precision
    components never answer a float32 cache lookup."""
    # the parameter string alone: the estimator is never fitted here
    transformer = get_estimator(config.estimator, config.components, config.sparsity,
                                device="cpu")
    return "{}-{}_{}_{}_n{}{}{}{}.npz".format(
        config.model.lower(),
        (config.output_class or "None").replace(" ", "_"),
        config.layer.lower(),
        transformer.get_param_str(),
        config.n,
        "_w" if config.use_w else "",
        f"_seed{config.seed}" if config.seed else "",
        "_bf16" if getattr(config, "dtype", None) == "bfloat16" else "",
    )


def get_or_compute(config, model: Optional[InstrumentedModel] = None,
                   phases: Optional[dict] = None, mesh=FROM_CONFIG) -> Path:
    """Return the cached component file path, computing it if needed; a
    computed run's phase seconds go into ``phases`` when one is given.
    On a mesh (``config.mesh_shape``'s, or ``mesh``) every rank calls this:
    rank 0 decides whether the cache is there, all ranks compute, rank 0
    writes, and the others wait on a barrier for the file."""
    basedir = Path(os.environ.get("GANSPACE_OUTPUT_DIR", Path.cwd()))
    if config.n is None:
        raise RuntimeError("Must specify number of samples with -n=XXX")
    if model is not None and not isinstance(model, InstrumentedModel):
        raise RuntimeError('Passed model has to be wrapped in "InstrumentedModel"')
    if config.use_w and "StyleGAN" not in config.model:
        raise RuntimeError(f"Cannot change latent space of non-StyleGAN model {config.model}")

    dump_path = basedir / "cache" / "components" / component_cache_name(config)
    mesh = _resolve_mesh(config, model, mesh)
    root = mesh is None or mesh.is_root
    missing = root and (not dump_path.is_file() or not _cache_file_readable(dump_path))
    if mesh is not None:
        missing = mesh.decide(missing)
    if missing:
        print("Not cached")
        t_start = datetime.datetime.now()
        timings = compute(config, dump_path, model, mesh=mesh)
        if phases is not None:
            phases.update(timings)
        print("Total time:", datetime.datetime.now() - t_start)
        if mesh is not None:
            mesh.barrier()
    elif root:
        _warn_on_provenance_mismatch(dump_path, config)
    return dump_path


def _cache_file_readable(dump_path: Path) -> bool:
    """True if the cached npz opens and holds the component keys; a corrupt
    file recomputes instead of poisoning every later run."""
    try:
        with np.load(dump_path, allow_pickle=False) as d:
            return "act_comp" in d.files and "lat_comp" in d.files
    except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
        print(f"Warning: cached {dump_path.name} is unreadable ({e!r}); "
              f"recomputing")
        return False


def read_meta(data) -> Optional[dict]:
    """The ``_meta`` provenance sidecar of an open npz, or None."""
    if "_meta" not in data.files:
        return None
    try:
        return json.loads(bytes(data["_meta"].item()).decode())
    except (ValueError, AttributeError):
        return None


def _prospective_mesh_desc(config) -> Optional[dict]:
    """The mesh axis -> size map a ``compute()`` of this config would
    record (``decomposition.py:1551-1557``), the tiny-run collapse
    included."""
    return mesh_desc(getattr(config, "mesh_shape", None), config.n)


def _warn_on_provenance_mismatch(dump_path: Path, config=None) -> None:
    """Flag a cache hit drawn from the other RNG stream than this run's
    ``GANSPACE_DEVICE_RNG``, or made on another mesh than this run's
    (``decomposition.py:1560-1590``): statistically equivalent components,
    not bit-identical ones.  Caches without the record (reference exports)
    are accepted as they are."""
    with np.load(dump_path, allow_pickle=False) as d:
        meta = read_meta(d)
    cached = meta.get("device_rng") if meta else None
    current = _env_on("GANSPACE_DEVICE_RNG")
    if cached is not None and cached != current:
        print(f"WARNING: {dump_path.name} was computed with "
              f"{'device' if cached else 'host'}-side RNG but this run uses "
              f"{'device' if current else 'host'}-side RNG "
              f"(GANSPACE_DEVICE_RNG); components are statistically "
              f"equivalent, not bit-identical. Use a fresh output dir for a "
              f"like-for-like cache.")
    if config is not None and meta and "mesh" in meta:
        want = _prospective_mesh_desc(config)
        if meta["mesh"] != want:
            print(f"WARNING: {dump_path.name} was computed on mesh "
                  f"{meta['mesh'] or 'single-device'} but this run would use "
                  f"{want or 'single-device'}; sharded reductions reassociate "
                  f"floating point, so the cached components differ from a fresh "
                  f"run at the ~1e-4 level. Use a fresh output dir for a "
                  f"like-for-like cache.")
