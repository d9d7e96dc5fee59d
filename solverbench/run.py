#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the card that this machine holds.

    python3 solverbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``), then ``checks``: each number the reference
compared, beside its limit; the same numbers end standard error.  Exits
non-zero, printing no result, without enough CUDA cards, or when a module
of jax, jaxlib, flax or porotpu (the JAX package) was loaded.
``--dtype float32`` runs the configuration in another precision: the
control that ``correct`` has to reject.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dtype", default=None, help="run the configuration in this dtype (the control)")
    args = ap.parse_args(argv)
    from solverbench.harness import run_cell

    return run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                    dtype=args.dtype)


if __name__ == "__main__":
    sys.exit(main())
