"""Phase-level wall-clock profile of the conv-tap fit: the port of
``tools/profile_convtap.py``.

The paper's leg (StyleGAN2-FFHQ-1024 tapped at ``convs.2``, D = 131072,
n = 50000: the fused activation stream into the Nystrom sketch tier with
its adaptive refine pass and the regression riding the stream), timed
through ``get_or_compute``.  Stamps mark the fit's boundaries: the stream
entered, pass 1 drained on the device, the refine pass armed, the policy's
decision (its spectrum readback included), the stream drained;
``GANSPACE_PHASE_TRACE=1`` prints the pipeline's own phases.  ``REPS``
repetitions follow a warm-up (2 by default); with ``TRACE_DIR`` set, the
last runs under ``utils.tracing.trace`` and the tool prints the device's
busy share and the top host ops of that repetition
(``tools/profiling.py``).

    python -m ganspace_tpu_torch.tools.profile_convtap [n] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from ganspace_tpu_torch.tools.profiling import Stamps, environ, patched, run_reps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ganspace_tpu_torch.tools.profile_convtap")
    p.add_argument("n", type=int, nargs="?", default=50_000)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda | cpu); cuda refuses "
                        "to fall back to the CPU")
    args = p.parse_args(argv)

    from ganspace_tpu_torch.config import Config
    from ganspace_tpu_torch.estimators.ipca import IPCAEstimator
    from ganspace_tpu_torch.models import get_instrumented_model
    from ganspace_tpu_torch.utils.tracing import device_sync

    cfg = Config(model="StyleGAN2", output_class="ffhq", layer="convs.2",
                 estimator="ipca", components=80, n=args.n, device=args.device)
    inst = get_instrumented_model(cfg, use_w=False)
    inst.model.use_z()
    stamp = Stamps()

    def wrap_stream(orig):
        def fit_stream(self, block_fn, n_blocks, **kw):
            stamp("fit_stream:enter")
            orig_begin = self.begin_refine

            def begin_refine(*a, **k):
                device_sync(self._nystrom)
                stamp("pass1:device_done")
                r = orig_begin(*a, **k)
                stamp("begin_refine:done")
                return r

            self.begin_refine = begin_refine
            ok = orig(self, block_fn, n_blocks, **kw)
            device_sync(self._nystrom)
            stamp("fit_stream:device_done")
            return ok
        return fit_stream

    def wrap_should(orig):
        def should_refine(self):
            stamp("should_refine:enter")
            r = orig(self)
            stamp("should_refine:done")   # includes the spectrum readback
            return r
        return should_refine

    with environ(GANSPACE_PHASE_TRACE=1), \
            patched(IPCAEstimator, "fit_stream", wrap_stream), \
            patched(IPCAEstimator, "should_refine", wrap_should):
        run_reps(cfg, inst, stamp, default_reps=2, width=24,
                 header=" (fit-sweep stamps below; post-fit phases printed "
                        "above by GANSPACE_PHASE_TRACE)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
