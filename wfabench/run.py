#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``wfa_tpu_torch`` on the card.

    python3 wfabench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell asks
for; without them it exits with code 2 and prints no result.  See
``wfabench/harness.py``.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The checkout's root, in place of this script's folder, so that the
# harness's modules are found only as ``wfabench.*``.
sys.path[0] = str(Path(__file__).resolve().parents[1])

from wfabench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
