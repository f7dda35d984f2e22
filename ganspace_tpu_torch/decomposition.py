"""Decomposition pipeline, W-space path (``ganspace_tpu/decomposition.py``).

Sample latents on the host -> map them to W on the device -> stream the
W blocks through the IPCA exact-moments tier -> write the ``.npz`` cache
whose keys, ``_meta`` fields and filename scheme match the JAX package's
(and the reference's, ``decomposition.py:332-341, 384-394``).

This is the path the JAX package takes under ``GANSPACE_DEVICE_RNG=0`` for
``--use_w --layer style`` (or ``g_mapping``): host numpy RNG, no fused
stream, one ``fit_partial`` per block.  Activation taps, which need the
latent regression and, past D = 8192, the Nystrom tier, are not ported
yet (ROADMAP.md, queue 1: the Nystrom / conv-tap tier).
"""

from __future__ import annotations

import datetime
import json
import os
import sys
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
from ganspace_tpu_torch.sampling import SEED_SAMPLING, random_directions

#: latent stream block size when ``-b`` is not given (the JAX package's W path)
W_BATCH = 4096


def _partial_dump_name(dump_name: Path, config_n: int, n_fitted: int) -> Path:
    """Interrupt-time filename: swap the ``_n{N}`` token for the fitted count
    (reference ``decomposition.py:268-274``).  The cache name encodes
    ``config.n``, not the batch-rounded total."""
    return dump_name.parent / dump_name.name.replace(
        f"_n{config_n}", f"_n{n_fitted}", 1)


def compute(config, dump_name: Path, instrumented_model: Optional[InstrumentedModel]):
    """Run the decomposition in IEEE float32 (the only precision ported)."""
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


def _compute(config, dump_name: Path, instrumented_model: Optional[InstrumentedModel]):
    timestamp = lambda: datetime.datetime.now().strftime("%d.%m %H:%M")  # noqa: E731
    print(f"[{timestamp()}] Computing", dump_name.name)
    canonical_name = dump_name.name   # the full-run cache filename
    layer_key = config.layer

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

    # Local clamp: the cache filename keeps the requested count.
    n_components = min(config.components, sample_dims)
    if n_components < config.components:
        print(f"WARNING: clamping components {config.components} -> "
              f"{n_components} (feature dim {sample_dims}); the cache "
              f"filename keeps the requested count")
    transformer = get_estimator(config.estimator, n_components, config.sparsity)

    samples_are_latents = (layer_key in ("g_mapping", "style")
                           and model.latent_space_name() == "W")
    if not samples_are_latents:
        raise NotImplementedError(
            f"layer {layer_key!r} in {model.latent_space_name()} space needs the "
            "latent regression, not yet ported (ROADMAP.md, queue 1: the "
            "Nystrom / conv-tap tier); "
            "use --use_w --layer style")

    # Round N down to full batches, but never below one batch.
    batch = min(config.batch_size or W_BATCH, config.n)
    n_total = config.n // batch * batch
    print("B={}, N={}, dims={}, N/dims={:.1f}".format(
        batch, n_total, sample_dims, n_total / sample_dims), flush=True)

    # Must not depend on the chosen batch size (reproducibility)
    nb = max(batch, max(2_000, 3 * n_components))

    # Pre-sample every latent up front, so the fit stream is independent of
    # later RNG use (reference decomposition.py:229-236).  The W batches
    # stay on the device.
    model.seed_host_rng(config.seed or SEED_SAMPLING)
    n_lat = ((n_total + nb - 1) // batch + 1) * batch
    latent_chunks = model.sample_latents_prefetched(n_lat // batch, batch)

    def latent_slice(start, stop):
        i0, i1 = start // batch, -(-stop // batch)
        block = torch.cat(latent_chunks[i0:i1], dim=0)
        return block[start - i0 * batch:stop - i0 * batch]

    n_blocks = max(1, -(-n_total // nb))
    canceled = False
    x_block = None
    try:
        for bi, gi in enumerate(range(0, n_total, nb)):
            x_block = latent_slice(gi, gi + nb).reshape(nb, -1)
            if not transformer.fit_partial(x_block):
                break
            print(f"\rFitting batches (NB={nb}): {bi + 1}/{n_blocks}",
                  end="", flush=True)
        print()
    except KeyboardInterrupt:
        n_fitted = transformer.n_samples_seen_
        dump_name = _partial_dump_name(dump_name, config.n, n_fitted)
        print(f'Saving current state to "{dump_name.name}" before exiting')
        canceled = True
    if canceled and transformer.n_samples_seen_ == 0:
        print("Nothing fitted before the interrupt — exiting without a "
              "partial save")
        sys.exit(1)

    x_global_mean = transformer.mean_.reshape((1, sample_dims))
    x_comp, stats = transformer.finish_latent_bundle()
    x_comp = x_comp.cpu().numpy()
    x_stdev, x_var_ratio, bundle_lat_stdev = stats

    # 'Activations' are latents in the W space: the components are unit
    # rows there already.
    z_comp = x_comp / np.maximum(
        np.linalg.norm(x_comp, axis=-1, keepdims=True), 1e-30)
    z_global_mean = np.array(x_global_mean)

    # Random-direction stdev baselines (reference decomposition.py:310-316)
    # over the last block, centered by the global mean.
    x_data = x_block - torch.as_tensor(x_global_mean, device=x_block.device)
    random_dirs = torch.as_tensor(random_directions(n_components, sample_dims),
                                  device=x_block.device)
    n_rand_samples = min(5000, x_data.shape[0])
    x_stdev_random = torch.std(random_dirs @ x_data[:n_rand_samples].T, dim=1,
                               correction=0).cpu().numpy()

    x_comp = x_comp.reshape(-1, *sample_shape)
    x_global_mean = np.array(x_global_mean).reshape(sample_shape)
    z_comp = z_comp.reshape(-1, *input_shape)
    z_global_mean = z_global_mean.reshape(input_shape)

    # Latent stdev: the moments tier holds the exact full-stream W
    # covariance, so it is the closed-form projection stdev.
    lat_stdev = bundle_lat_stdev if config.use_w else np.ones_like(x_stdev)

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
        "refine_skipped": None,
        "refine_stats": None,
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

    if canceled:
        sys.exit(1)
    if instrumented_model is None:
        inst.close()


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


def get_or_compute(config, model: Optional[InstrumentedModel] = None) -> Path:
    """Return the cached component file path, computing it if needed."""
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
        compute(config, dump_path, model)
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
