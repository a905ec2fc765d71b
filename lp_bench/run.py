#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 lp_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the card's name and power limit, then, as the last line, one JSON
result (see ``lp_bench/lib/harness.py``).  Exits nonzero, printing no
result, without enough CUDA devices for the cell.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lp_bench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
