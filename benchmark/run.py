"""Run one cell of the port's benchmark on this machine's card(s).

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Builds the program's kernels into
``benchmark/.build/kernels/`` on the first run there, draws the weights
and inputs from ``--seed`` on the card, warms up the cell's shapes,
measures for ``--seconds``, checks what the timed path produced against
the plain reference, and prints one JSON line: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.
Exits non-zero, printing no result, without the cards the cell asks for
or when JAX or the JAX package got loaded.
"""

import time

_T0 = time.perf_counter()  # the run's start, for setup_s

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # transformers, if anything loads it, must not pull in JAX or Flax
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    from .core import main as run

    return run(args, _T0)


if __name__ == "__main__":
    sys.exit(main())
