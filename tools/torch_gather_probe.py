#!/usr/bin/env python3
"""The wide-gather probe on the card: the port of tools/dev_gather_probe.py
(Q1) through ``wfa_tpu_torch/ops/csrc/gather_probe.cu``.

    python3 tools/torch_gather_probe.py

out[r, j] = tab[r, idx[r, j]] from a [BT, 128] int32 table at [BT, W]
indices, on seeded random inputs: at the TPU probe's [8, 2048], where the
launch is the whole cost, and at [8192, 2048] (128 MB of indices and
results).  Prints whether the kernel equals ``torch.gather``, both times
(CUDA events, mean of 20 after a warm-up) and the kernel's rate over the
bytes it must move.  Needs a CUDA device.  Prints the card's name and power
limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SIZES = ((8, 2048), (8192, 2048))   # (BT, W)


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_gather_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from wfa_tpu_torch.ops import gather_probe

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.time()
    runs = [gather_probe.measure(bt, w, device=dev) for bt, w in SIZES]
    r = runs[0]
    print(f"Q1 wide-take-from-1vreg: ok={r['equal']} (build+run "
          f"{time.time() - t0:.1f}s)")
    for r in runs:
        print(f"[{r['BT']}, {r['W']}]: kernel {r['ms'] * 1e3:.3f} us, "
              f"torch.gather {r['library_ms'] * 1e3:.3f} us, "
              f"{r['achieved_GBps']:.1f} GB/s, equal={r['equal']}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "runs": runs}), flush=True)
    return 0 if all(r["equal"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
