#!/usr/bin/env python3
"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (see harness.py).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process with few threads: the host's share of the card's machine is
# what the end-to-end metrics time
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "2"

# the checkout's root, not this folder, heads the path: the harness and the
# program are imported as packages of the checkout
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
