"""Run one cell of the benchmark of the PyTorch + CUDA port once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
Prints the run's result as the last line of standard output (one JSON
object) and the numbers that decided ``correct``, each beside its limit, as
the last lines of standard error. Exits non-zero, printing no result, when
there is no CUDA device, when the cell needs more cards than there are, or
when the process holds JAX or the JAX package once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, heads the import path
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda", T_START)
        held = harness.forbidden_modules()
        if held:
            raise harness.Refused("the process holds " + ", ".join(held))
    except harness.Refused as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    harness.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
