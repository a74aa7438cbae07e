"""Command line of the benchmark; run from the root of a checkout::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output, and each number
that decided ``correct`` beside its limit as the last lines of standard
error.  Exit 2 without a result when the run cannot be made (no card, too
few cards, an unknown cell, a window that launched nothing on the card);
exit 3 without a result when the process holds JAX or the JAX package
once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), T_START)
    except harness.RunError as e:
        harness.log(f"portbench: no result: {e}")
        return 2
    found = harness.forbidden_modules()
    if found:
        harness.log(f"portbench: no result: the process holds {found}")
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']} limit {c['limit']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
