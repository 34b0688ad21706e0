"""Run one cell of the port's benchmark once, on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result, one JSON object; the numbers that decide `correct` are the last
lines of standard error. Without a CUDA device, or with fewer than the
cell asks for, it exits 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    from harness import cell

    return cell.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
