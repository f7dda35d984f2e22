"""Phase-level wall-clock profile of the 1M-sample W-space fit: the port of
``tools/profile_wpca.py``.

The headline leg (StyleGAN2-FFHQ, ``--use_w``, tap ``style``, ``ipca`` c=80,
the moments tier on the fused W stream, one kernel-A launch per block),
timed through ``get_or_compute`` with stamps at the fit's boundaries: the
fused stream entered, its blocks enqueued, the device drained, the finish
bundle done; ``GANSPACE_PHASE_TRACE=1`` prints the pipeline's own phases.
``REPS`` repetitions follow a warm-up (3 by default); with ``TRACE_DIR``
set, the last runs under ``utils.tracing.trace`` (``tools/profiling.py``).

    python -m ganspace_tpu_torch.tools.profile_wpca [n] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from ganspace_tpu_torch.tools.profiling import Stamps, environ, patched, run_reps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ganspace_tpu_torch.tools.profile_wpca")
    p.add_argument("n", type=int, nargs="?", default=1_000_000)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda | cpu); cuda refuses "
                        "to fall back to the CPU")
    args = p.parse_args(argv)

    from ganspace_tpu_torch.config import Config
    from ganspace_tpu_torch.estimators.ipca import IPCAEstimator
    from ganspace_tpu_torch.models import get_instrumented_model
    from ganspace_tpu_torch.utils.tracing import device_sync

    cfg = Config(model="StyleGAN2", output_class="ffhq", layer="style",
                 estimator="ipca", components=80, n=args.n, use_w=True,
                 device=args.device)
    inst = get_instrumented_model(cfg, use_w=True)
    inst.model.use_w()
    stamp = Stamps()

    # Split the fused W stream's host enqueue from its device drain, and
    # stamp the finish bundle (its eigh and readback).
    def wrap_stream(orig):
        def fit_stream(self, block_fn, n_blocks, **kw):
            stamp(f"fit_stream:enter[{n_blocks}blk]")
            ok = orig(self, block_fn, n_blocks, **kw)
            stamp("fit_stream:dispatched")
            device_sync((self._moments, self._nystrom))
            stamp("fit:device_drained")
            return ok
        return fit_stream

    def wrap_bundle(orig):
        def finish_latent_bundle(self, rand_moments=None):
            out = orig(self, rand_moments=rand_moments)
            stamp("finish_bundle:done")
            return out
        return finish_latent_bundle

    with environ(GANSPACE_PHASE_TRACE=1), \
            patched(IPCAEstimator, "fit_stream", wrap_stream), \
            patched(IPCAEstimator, "finish_latent_bundle", wrap_bundle):
        run_reps(cfg, inst, stamp, default_reps=3, width=36)
    return 0


if __name__ == "__main__":
    sys.exit(main())
