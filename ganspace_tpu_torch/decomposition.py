"""Decomposition pipeline (``ganspace_tpu/decomposition.py``).

Sample latents -> run the generator to the tap -> stream blocks through the
IPCA estimator -> regress the components back to latent space -> write the
``.npz`` cache whose keys, ``_meta`` fields and filename scheme match the
JAX package's (and the reference's, ``decomposition.py:332-341, 384-394``).

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
  sweep.

``GANSPACE_DEVICE_RNG=0`` is the JAX package's bit-exact host path.  Not
ported: the fused-acts sentinel registry (``auto`` is the sample-count rule
alone), the bf16 first pass, block grouping (a TPU dispatch lever), the
XLA memory-analysis batch autotune and ``_stream_npz``.
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
from ganspace_tpu_torch.sampling import (
    SEED_LINREG, SEED_SAMPLING, STREAM_LINREG, STREAM_MAIN, STREAM_W_TAIL,
    block_generator, random_directions, random_directions_device)

#: latent stream block size when ``-b`` is not given (the JAX package's W path)
W_BATCH = 4096


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

def linreg_lstsq(comp, mean, stdev, inst: InstrumentedModel, config):
    """Solve min_M ||M A - Z|| where A are the stdev-scaled PCA coordinates
    of fresh ``SEED_LINREG`` samples: the normal equations G = sum A^T A
    (c x c) and R = sum A^T Z accumulate on the device batch by batch, then
    one float32 solve with a 1e-10 tr(G)/c ridge.

    The samples come from the regression's device stream when the fused
    stream is wanted for ``n_samp`` samples and ``GANSPACE_DEVICE_RNG=1``
    (``decomposition.py:356-414``), else from the host stream."""
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

    def host_block(_):
        z = model.sample_latent(batch)
        model.partial_forward(z, config.layer)
        return inst.retained_features()[config.layer].reshape(batch, -1), z

    comp_flat = comp.reshape(n_comp, -1)
    # zero-stdev components carry no direction: divide by 1 instead of 0
    safe = torch.where(stdev > 0, stdev, torch.ones_like(stdev))[None, :]
    g = torch.zeros((n_comp, n_comp), dtype=torch.float32, device=device)
    r = torch.zeros((n_comp, latent_dims), dtype=torch.float32, device=device)
    z_sum = torch.zeros((latent_dims,), dtype=torch.float32, device=device)
    for i in range(n_samp // batch):
        act, z = (device_block or host_block)(i)
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


def regression_from_moments(comp, mean, stdev, reg):
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
    only off-diagonal mixing separates it from the explicit solve."""
    xz, z_sum, n_reg = reg
    print(f"Regression from fused cross-moments ({n_reg} samples, "
          f"no extra sweep)", flush=True)
    device = xz.device
    comp = torch.as_tensor(comp, dtype=torch.float32).to(device)
    comp = comp.reshape(comp.shape[0], -1)
    mean = torch.as_tensor(mean, dtype=torch.float32).to(device).reshape(-1)
    stdev = torch.as_tensor(stdev, dtype=torch.float32).to(device)
    r, gram = _reg_solve(comp, mean, stdev, xz, z_sum)
    z_comp = r.cpu().numpy() / max(float(n_reg) - 1.0, 1.0)
    z_mean = z_sum.cpu().numpy()[None, :] / max(float(n_reg), 1.0)
    _warn_if_not_orthonormal_gram(gram.cpu().numpy())
    return z_comp, z_mean


def _reg_solve(comp, mean, stdev, xz, z_sum):
    """``(R [c, zdim], C C^T)``: the right-hand side from the raw moments,
    and the Gram for the orthonormality check."""
    # zero-stdev components carry no direction: divide by 1 instead of 0
    safe = torch.where(stdev > 0, stdev, torch.ones_like(stdev))
    r = (comp @ xz - torch.outer(comp @ mean, z_sum)) / safe[:, None]
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

    # -- the path (decomposition.py:751-830) --------------------------------
    seed0 = config.seed or SEED_SAMPLING
    model.seed_host_rng(seed0)
    n_lat = ((n_total + nb - 1) // batch + 1) * batch
    on_device = n_lat * int(np.prod(input_shape[1:])) * 4 < int(
        os.environ.get("GANSPACE_LATENT_HBM_BUDGET", 8 * 1024 ** 3))
    device_rng = _env_on("GANSPACE_DEVICE_RNG")
    lat_fn = model.device_latents_fn()
    streamable = (transformer._use_moments(sample_dims)
                  or transformer._use_nystrom(sample_dims))
    fused = (samples_are_latents and device_rng and lat_fn is not None
             and transformer._use_moments(sample_dims))
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

    def interrupted():
        nonlocal dump_name
        n_fitted = transformer.n_samples_seen_
        dump_name = _partial_dump_name(dump_name, config.n, n_fitted)
        print(f'Saving current state to "{dump_name.name}" before exiting')
        return True

    canceled = False
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
            if transformer.rand_moments() is None:
                x_block = w_stream(STREAM_MAIN, nb_w)(0)
        except KeyboardInterrupt:
            canceled = interrupted()
            x_block = None
    elif fused_acts:
        n_stream_blocks = -(-n_total // batch)
        print(f"Fitting fused activation stream: {n_stream_blocks} blocks of "
              f"{batch}" + (" (+regression moments)" if want_reg else ""), flush=True)
        try:
            if not transformer.fit_stream(acts_block, n_stream_blocks,
                                          with_reg=want_reg, rand_dirs=rand_dirs):
                raise RuntimeError("fused activation stream unavailable for "
                                   "this estimator")
            if transformer.rand_moments() is None:
                x_block = acts_block(0)
                x_block = x_block[0] if want_reg else x_block
        except KeyboardInterrupt:
            # fit_stream refines inside: an interrupt in its second pass falls
            # back to the completed first pass and its accumulators.
            transformer.abort_refine()
            canceled = interrupted()
            x_block = None
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
    if (not canceled and not (fused or fused_acts)
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

    if canceled and transformer.n_samples_seen_ == 0:
        print("Nothing fitted before the interrupt — exiting without a "
              "partial save")
        sys.exit(1)
    x_global_mean = transformer.mean_.reshape((1, sample_dims))
    if x_block is None:
        x_block = torch.zeros((1, sample_dims), dtype=torch.float32, device=device)

    # The components stay on the device for the regression; samples-are-
    # latents runs take the moments tier's bundle (lat_stdev and the random
    # baselines included).
    rand_mom = transformer.rand_moments() if device_rng_used else None
    bundle_stats = None
    if samples_are_latents:
        bundle = transformer.finish_latent_bundle(rand_moments=rand_mom)
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
    # rows there already.  Elsewhere, regress them back to latent space,
    # from the fit stream's cross-moments when they rode it.
    fused_linreg_used = False
    if samples_are_latents:
        z_comp = x_comp.cpu().numpy()
        z_global_mean = np.array(x_global_mean)
    else:
        reg = transformer.reg_moments()
        if reg is not None:
            fused_linreg_used = True
            z_comp, z_global_mean = regression_from_moments(
                x_comp, x_global_mean, x_stdev, reg)
        else:
            z_comp, z_global_mean = regression(x_comp, x_global_mean, x_stdev,
                                               inst, config)
    stamp("regression")
    z_comp = z_comp / np.maximum(
        np.linalg.norm(z_comp, axis=-1, keepdims=True), 1e-30)

    # Random-direction stdev baselines (reference decomposition.py:310-316).
    # From the moments that rode the stream (all n samples; variance is
    # shift-invariant, so the global-mean centering falls out), else over
    # the first 5000 rows of the last block, centered by the global mean,
    # along directions from the stream the samples came from.
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
        n_rand_samples = min(5000, x_block.shape[0])
        x_data = (x_block[:n_rand_samples]
                  - torch.as_tensor(x_global_mean, device=device))
        x_stdev_random = torch.std(random_dirs @ x_data.T, dim=1,
                                   correction=0).cpu().numpy()

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
    # Provenance sidecar with the JAX package's fields: which RNG stream
    # produced the samples, whether the regression rode it, and which
    # estimator options shaped the result.
    meta = json.dumps({
        "device_rng": device_rng_used,
        "dtype": "float32",
        "mesh": None,
        "fused_linreg": fused_linreg_used,
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
          random_stdevs=np.asarray(x_stdev_random, np.float32),
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
    """Flag a cache hit drawn from the other RNG stream than this run's
    ``GANSPACE_DEVICE_RNG`` (``decomposition.py:1560-1585``): statistically
    equivalent components, not bit-identical ones.  Caches without the
    record (reference exports) are accepted as they are."""
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
