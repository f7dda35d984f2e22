"""One run of one benchmark cell of ganspace_tpu_torch on this machine's GPUs.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Progress goes to standard output; its last
line is the result (one JSON object), and the last lines on standard error
are the numbers that decided ``correct``, each beside its limit.  The run
exits with code 2, and prints no result, when CUDA or the cell's GPUs are
missing; 3 when the program (``ganspace_tpu_torch``) is not there; 4 when
JAX or the JAX package was loaded in this process.
"""

from __future__ import annotations

import argparse
import sys

from benchmark import harness


def main(argv=None) -> int:
    started = harness.process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.pin_threads()
    try:
        cell = harness.resolve(args.workload)
    except (KeyError, FileNotFoundError, StopIteration) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    harness.pin_env(cell.mix)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import ganspace_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not here ({e})", file=sys.stderr)
        return 3
    try:
        out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                               started=started)
    except harness.JaxLoaded as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 4
    harness.report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
