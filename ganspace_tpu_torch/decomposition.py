"""Decomposition pipeline (``ganspace_tpu/decomposition.py``).

Sample latents on the host -> run the generator to the tap on the device ->
stream NB-sample blocks through the IPCA estimator -> regress the components
back to latent space -> write the ``.npz`` cache whose keys, ``_meta`` fields
and filename scheme match the JAX package's (and the reference's,
``decomposition.py:332-341, 384-394``).

This is the path the JAX package takes under ``GANSPACE_DEVICE_RNG=0``: host
numpy RNG (pre-sampled latents), one ``fit_partial`` per block, the sketch
tier's adaptive refine sweep, and a separate least-squares regression sweep
on fresh ``SEED_LINREG`` latents.  Samples-are-latents runs (``--use_w
--layer style``) fit the W latents themselves and need no regression.  Not
ported: the fused device-RNG streams, block grouping (a TPU dispatch lever)
and the XLA memory-analysis batch autotune.
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
from ganspace_tpu_torch.ops.precision import ieee_f32
from ganspace_tpu_torch.sampling import SEED_LINREG, SEED_SAMPLING, random_directions

#: latent stream block size when ``-b`` is not given (the JAX package's W path)
W_BATCH = 4096


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


# ---------------------------------------------------------------------------
# Latent regression (reference decomposition.py:77-148)
# ---------------------------------------------------------------------------

def linreg_lstsq(comp, mean, stdev, inst: InstrumentedModel, config):
    """Solve min_M ||M A - Z|| where A are the stdev-scaled PCA coordinates
    of fresh ``SEED_LINREG`` samples: the normal equations G = sum A^T A
    (c x c) and R = sum A^T Z accumulate on the device batch by batch, then
    one float32 solve with a 1e-10 tr(G)/c ridge."""
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

    comp_flat = comp.reshape(n_comp, -1)
    # zero-stdev components carry no direction: divide by 1 instead of 0
    safe = torch.where(stdev > 0, stdev, torch.ones_like(stdev))[None, :]
    g = torch.zeros((n_comp, n_comp), dtype=torch.float32, device=device)
    r = torch.zeros((n_comp, latent_dims), dtype=torch.float32, device=device)
    z_sum = torch.zeros((latent_dims,), dtype=torch.float32, device=device)
    for _ in range(n_samp // batch):
        z = model.sample_latent(batch)
        model.partial_forward(z, config.layer)
        act = inst.retained_features()[config.layer].reshape(batch, -1)
        coords = ((act - mean) @ comp_flat.T) / safe
        zf = z.reshape(batch, -1)
        g += coords.T @ coords
        r += coords.T @ zf
        z_sum += torch.sum(zf, dim=0)

    # M^T = (A^T A)^-1 A^T Z: rows of M^T are the latent-space directions.
    ridge = 1e-10 * torch.trace(g) / g.shape[0]
    m_t = torch.linalg.solve(
        g + ridge * torch.eye(n_comp, dtype=g.dtype, device=device), r)
    z_comp = m_t[:n_comp, :].cpu().numpy()
    z_mean = z_sum.cpu().numpy()[None, :] / n_samp
    return z_comp, z_mean


def _warn_if_not_orthonormal(comp) -> None:
    """Reference ``decomposition.py:141-148``'s sanity check, contracted on
    the components' device."""
    c = torch.as_tensor(comp, dtype=torch.float32)
    c = c.reshape(c.shape[0], -1)
    m = (c @ c.T).cpu().numpy()
    if not np.allclose(m, np.identity(m.shape[0]), atol=1e-3):
        print(f"WARNING: Computed basis is not orthonormal "
              f"(determinant={np.linalg.det(m)})")


def regression(comp, mean, stdev, inst, config):
    _warn_if_not_orthonormal(comp)
    return linreg_lstsq(comp, mean, stdev, inst, config)


def _partial_dump_name(dump_name: Path, config_n: int, n_fitted: int) -> Path:
    """Interrupt-time filename: swap the ``_n{N}`` token for the fitted count
    (reference ``decomposition.py:268-274``).  The cache name encodes
    ``config.n``, not the batch-rounded total."""
    return dump_name.parent / dump_name.name.replace(
        f"_n{config_n}", f"_n{n_fitted}", 1)


def compute(config, dump_name: Path,
            instrumented_model: Optional[InstrumentedModel]) -> dict:
    """Run the decomposition in IEEE float32 (the only precision ported);
    returns the wall seconds of its phases."""
    dtype = getattr(config, "dtype", None) or "float32"
    if dtype != "float32":
        raise NotImplementedError(
            f"--dtype {dtype!r}: only float32 is ported (bf16 preview is a "
            "ROADMAP item)")
    if getattr(config, "mesh_shape", None) not in (None, "1"):
        raise NotImplementedError("--mesh: the port runs on one device "
                                  "(multi-GPU is a ROADMAP item)")
    with ieee_f32():
        return _compute(config, dump_name, instrumented_model)


def _compute(config, dump_name: Path,
             instrumented_model: Optional[InstrumentedModel]) -> dict:
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
                                      require_device(config.device))
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
    transformer = get_estimator(config.estimator, n_components, config.sparsity)

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
    n_total = config.n // batch * batch
    print("B={}, N={}, dims={}, N/dims={:.1f}".format(
        batch, n_total, sample_dims, n_total / sample_dims), flush=True)

    # Must not depend on the chosen batch size (reproducibility)
    nb = max(batch, max(2_000, 3 * n_components))

    # Pre-sample every latent up front, so the fit stream is independent of
    # later RNG use (reference decomposition.py:229-236).  The batches stay
    # on the device.
    model.seed_host_rng(config.seed or SEED_SAMPLING)
    n_lat = ((n_total + nb - 1) // batch + 1) * batch
    latent_chunks = model.sample_latents_prefetched(n_lat // batch, batch)

    def latent_slice(start, stop):
        i0, i1 = start // batch, -(-stop // batch)
        block = torch.cat(latent_chunks[i0:i1], dim=0)
        return block[start - i0 * batch:stop - i0 * batch]

    n_blocks = max(1, -(-n_total // nb))

    def make_block(gi):
        """One NB-sample block: ceil(NB / B) partial forwards over
        consecutive latents, cut to NB (the last block may run past
        n_total, as in the JAX package)."""
        if samples_are_latents:
            return latent_slice(gi, gi + nb).reshape(nb, -1)
        chunks = []
        for mb in range(0, nb, batch):
            z = latent_slice(gi + mb, gi + mb + batch)
            model.partial_forward(z, layer_key)
            chunks.append(inst.retained_features()[layer_key].reshape(batch, -1))
        return torch.cat(chunks, dim=0)[:nb]

    stamp("setup")

    def run_sweep(action):
        """Stream every NB block through ``fit_partial``; returns the last
        assembled block (kept for the stdev baselines)."""
        xb = None
        for bi, gi in enumerate(range(0, n_total, nb)):
            xb = make_block(gi)
            if not transformer.fit_partial(xb):
                break
            print(f"\r{action} batches (NB={nb}): {bi + 1}/{n_blocks}",
                  end="", flush=True)
        print()
        return xb

    canceled = False
    x_block = None   # the zeros fallback below covers an interrupted sweep
    try:
        x_block = run_sweep("Fitting")
    except KeyboardInterrupt:
        n_fitted = transformer.n_samples_seen_
        dump_name = _partial_dump_name(dump_name, config.n, n_fitted)
        print(f'Saving current state to "{dump_name.name}" before exiting')
        canceled = True
    stamp("pass1")

    # Sketch-tier refine pass: the latents are kept, so one more sweep buys
    # a power iteration on the scatter, unless the adaptive policy finds the
    # first-pass sketch resolved (the moments tier never refines).
    if (not canceled and transformer.should_refine()
            and transformer.begin_refine()):
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

    if canceled and transformer.n_samples_seen_ == 0:
        print("Nothing fitted before the interrupt — exiting without a "
              "partial save")
        sys.exit(1)
    x_global_mean = transformer.mean_.reshape((1, sample_dims))
    if x_block is None:
        x_block = torch.zeros((1, sample_dims), dtype=torch.float32, device=device)

    # The components stay on the device for the regression; samples-are-
    # latents runs take the moments tier's bundle (lat_stdev included).
    bundle_stats = None
    if samples_are_latents:
        bundle = transformer.finish_latent_bundle()
        if bundle is not None:
            x_comp, bundle_stats = bundle
            x_stdev, x_var_ratio = bundle_stats[0], bundle_stats[1]
    if bundle_stats is None:
        x_comp, x_stdev, x_var_ratio = transformer.get_components(device=True)
    if (tuple(x_comp.shape) != (n_components, sample_dims)
            or x_stdev.shape[0] != n_components):
        raise RuntimeError(f"Invalid shape: components {tuple(x_comp.shape)}, "
                           f"stdev {x_stdev.shape}")
    stamp("finish")

    # 'Activations' are latents in the W space: the components are unit
    # rows there already.  Elsewhere, regress them back to latent space.
    if samples_are_latents:
        z_comp = x_comp.cpu().numpy()
        z_global_mean = np.array(x_global_mean)
    else:
        z_comp, z_global_mean = regression(x_comp, x_global_mean, x_stdev,
                                           inst, config)
    stamp("regression")
    z_comp = z_comp / np.maximum(
        np.linalg.norm(z_comp, axis=-1, keepdims=True), 1e-30)

    # Random-direction stdev baselines (reference decomposition.py:310-316)
    # over the first 5000 rows of the last block, centered by the global
    # mean; only the [c] stdevs leave the device.
    random_dirs = torch.as_tensor(random_directions(n_components, sample_dims),
                                  device=device)
    n_rand_samples = min(5000, x_block.shape[0])
    x_data = x_block[:n_rand_samples] - torch.as_tensor(x_global_mean, device=device)
    x_stdev_random = torch.std(random_dirs @ x_data.T, dim=1,
                               correction=0).cpu().numpy()

    x_comp = x_comp.cpu().numpy().reshape(-1, *sample_shape)
    x_global_mean = np.array(x_global_mean).reshape(sample_shape)
    z_comp = z_comp.reshape(-1, *input_shape)
    z_global_mean = z_global_mean.reshape(input_shape)

    # Latent stdev: ones in Z.  In W, the moments tier's exact full-stream
    # projection stdev when the samples are the W latents, else the
    # reference's estimate over 5000 fresh W samples
    # (decomposition.py:324-329), drawn after the regression sweep's.
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
    # Provenance sidecar with the JAX package's fields: which RNG stream
    # produced the samples and which estimator options shaped the result.
    meta = json.dumps({
        "device_rng": False,
        "dtype": "float32",
        "mesh": None,
        "fused_linreg": False,
        "refine_skipped": getattr(transformer, "refine_skipped", None),
        "refine_stats": getattr(transformer, "refine_stats", None),
        "bf16_pass1": False,
        "bf16_pass1_aborted": False,
    })
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
          random_stdevs=x_stdev_random.astype(np.float32),
          _meta=np.bytes_(meta.encode()))
    os.replace(tmp_name, dump_name)
    stamp("npz")
    print("Phases: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))

    if canceled:
        sys.exit(1)
    if instrumented_model is None:
        inst.close()
    return phases


# ---------------------------------------------------------------------------
# Cache layer (reference decomposition.py:360-402)
# ---------------------------------------------------------------------------

def component_cache_name(config) -> str:
    """The reference filename scheme (``decomposition.py:384-392``)."""
    transformer = get_estimator(config.estimator, config.components, config.sparsity)
    return "{}-{}_{}_{}_n{}{}{}.npz".format(
        config.model.lower(),
        (config.output_class or "None").replace(" ", "_"),
        config.layer.lower(),
        transformer.get_param_str(),
        config.n,
        "_w" if config.use_w else "",
        f"_seed{config.seed}" if config.seed else "",
    )


def get_or_compute(config, model: Optional[InstrumentedModel] = None,
                   phases: Optional[dict] = None) -> Path:
    """Return the cached component file path, computing it if needed; a
    computed run's phase seconds go into ``phases`` when one is given."""
    basedir = Path(os.environ.get("GANSPACE_OUTPUT_DIR", Path.cwd()))
    if config.n is None:
        raise RuntimeError("Must specify number of samples with -n=XXX")
    if model is not None and not isinstance(model, InstrumentedModel):
        raise RuntimeError('Passed model has to be wrapped in "InstrumentedModel"')
    if config.use_w and "StyleGAN" not in config.model:
        raise RuntimeError(f"Cannot change latent space of non-StyleGAN model {config.model}")

    dump_path = basedir / "cache" / "components" / component_cache_name(config)
    if not dump_path.is_file() or not _cache_file_readable(dump_path):
        print("Not cached")
        t_start = datetime.datetime.now()
        timings = compute(config, dump_path, model)
        if phases is not None:
            phases.update(timings)
        print("Total time:", datetime.datetime.now() - t_start)
    else:
        _warn_on_provenance_mismatch(dump_path)
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


def _warn_on_provenance_mismatch(dump_path: Path) -> None:
    """Flag a cache hit drawn from the device RNG (this port draws on the
    host): statistically equivalent components, not bit-identical ones."""
    with np.load(dump_path, allow_pickle=False) as d:
        meta = read_meta(d)
    if meta and meta.get("device_rng"):
        print(f"WARNING: {dump_path.name} was computed with device-side RNG; "
              f"this port draws on the host. Components are statistically "
              f"equivalent, not bit-identical. Use a fresh output dir for a "
              f"like-for-like cache.")
