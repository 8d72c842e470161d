"""Run one cell of the port's benchmark once, in this process::

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards. It
loads and warms up the cell (``setup_s``), measures for ``--seconds``, checks
what the timed path produced against the plain reference, prints each
compared number beside its limit on standard error and, as the last line of
standard output, one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and ``checks``).
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from snetbench import core

    return core.main(sys.argv[1:] if argv is None else argv, T0)


if __name__ == "__main__":
    sys.exit(main())
