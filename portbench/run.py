"""Run one cell of BENCHMARK.json once and print its result line:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device[, breakdown], checks);
the numbers compared, each beside its limit, are also the last lines of
standard error. Exits with a code other than 0, and prints no result,
where the machine lacks the cell's cards or a forbidden module (JAX, the
JAX package) is loaded.
"""

import time

_PROCESS_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # a library that could load JAX by itself is kept from doing so
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    from portbench import harness, nojax

    try:
        return harness.main(args.workload, args.seed, args.seconds, bool(args.trace), _PROCESS_START)
    except nojax.Forbidden as e:
        print(f"portbench: {e}; no result", file=sys.stderr)
        return 4


if __name__ == "__main__":
    sys.exit(main())
