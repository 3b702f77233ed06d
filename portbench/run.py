"""Run one cell of the benchmark on this machine's card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the output check
compared, with its limit). The check's numbers are also the last lines
of standard error. Exits 2, printing no result, where the card or a
file the cell needs is missing.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("int4", "fp8"), default=None,
                    help="judge the reference in this precision in the program's place "
                         "(for setting the check's limits, not for measuring)")
    args = ap.parse_args(argv)
    from .harness import run

    return run(args.workload, args.seed, args.seconds, bool(args.trace), control=args.control)


if __name__ == "__main__":
    sys.exit(main())
