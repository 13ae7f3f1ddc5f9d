"""Run one benchmark cell of the port on the card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python -m portbench.run ...`) from the root of a checkout. See
portbench/README.md.
"""

import time

_STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import cell_threads  # noqa: E402

cell_threads(sys.argv[1:])

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=_STARTED))
