#!/usr/bin/env python3
"""The rate of K4's ring traffic on the card: per step 4 rows of a [3A, W]
int32 slab read and 3 written (each written row the row read + 1), one slab
per block, A = 5 (penalties 2,3,1), through ``csrc/ring_bw.cu``.  The port of
tools/dev_dma_bw.py: the rate comes from the difference of two step counts
(256 and 2048), CUDA-event times, best of 3 after a warm-up.

    python3 tools/torch_ring_bw.py

At two sizes: the ring of seq_10K_n100 at max_error 3000 (100 slabs at
W=6016, 36 MB: it fits the 50 MB L2) and 1056 slabs at W=16384 (8 per SM,
1 GB: past the L2).  Needs a CUDA device.  Prints the card's name and power
limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ROWS = 15   # 3A at A = 5
SIZES = ((100, 6016), (1056, 16384))   # (slabs, W)


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_ring_bw: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from wfa_tpu_torch.ops import ring_bw

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    runs = [ring_bw.measure(B, W, ROWS, device=dev) for B, W in SIZES]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
