#!/usr/bin/env python3
"""Speed-of-light calibration of the card: the port of
benchmarks/sol_calibrate.py through ``wfa_tpu_torch/ops/csrc/sol_calibrate.cu``.

    python3 tools/torch_sol_calibrate.py

Times each primitive at the TPU script's two iteration counts (CUDA events,
best of 3 after a warm-up) and takes its cost from the difference, for one
[8, 128] tile (latency) and for the card full of tiles (throughput):

- the dependent int32 chain (8 source ops a rep): ns per dependent op, and
  the int32 source-op rate; then the SASS instructions nvcc made of a rep;
- the dependent gather of a 128-lane row from itself (shared memory and one
  block barrier a step): ns per gather;
- the tile-wide max feeding a branch (two block barriers): ns per sync, with
  1024 threads (the TPU tile) and 512 (the wavefront kernels' block).

Needs a CUDA device.  Prints the card's name and power limit, the TPU
script's lines, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_sol_calibrate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from wfa_tpu_torch.ops import sol_calibrate as sol

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}")
    runs = []
    for tiles in (1, sol.resident_tiles("vpu_ops", dev)):
        r = sol.bench_vpu_ops(dev, tiles)
        print(f"VPU int32 vreg-ops (dependent chain), {tiles} tile(s): "
              f"{r['per_s'] / 1e9:.2f} G/s ({r['ns']:.2f} ns/op), "
              f"{r['int32_ops_per_s'] / 1e12:.3f} T int32 source ops/s  "
              f"[t1={r['ms'][0]:.1f}ms t2={r['ms'][1]:.1f}ms]", flush=True)
        runs.append(r)
    sass = sol.sass_per_rep()
    print(f"SASS: {sass['loop_instructions']} instructions in the loop of "
          f"{sol.INNER} reps ({sass['per_rep']:.2f} a rep, "
          f"{sol.OPS_PER_REP} source ops): {sass['opcodes']}", flush=True)
    for tiles in (1, sol.resident_tiles("gather_chain", dev)):
        r = sol.bench_gather(dev, tiles)
        print(f"dynamic_gather (8,128), {tiles} tile(s): {r['per_s'] / 1e6:.1f} "
              f"M/s ({r['ns']:.1f} ns/gather)  "
              f"[t1={r['ms'][0]:.1f}ms t2={r['ms'][1]:.1f}ms]", flush=True)
        runs.append(r)
    for threads in sol.THREADS:
        for tiles in (1, sol.resident_tiles("scalar_sync", dev, threads)):
            r = sol.bench_scalar_sync(dev, tiles, threads=threads)
            print(f"vector->scalar sync + cond, {threads} threads, {tiles} "
                  f"tile(s): {r['ns']:.0f} ns/sync  "
                  f"[t1={r['ms'][0]:.1f}ms t2={r['ms'][1]:.1f}ms]", flush=True)
            runs.append(r)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "sass": sass, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
