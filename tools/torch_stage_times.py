#!/usr/bin/env python3
"""Where the time of ``align_pairs(backend='cuda')`` goes, per stage, in
distance and in CIGAR mode, on one of two workloads:

* ``hifi`` (the default): tests/data/test_hifi.seq x8 = 400 pairs of
  ~14 kbp, banded, W=512, band 25, penalties 2,3,1, max_steps 3000 (K1;
  K2 + K3);
* ``wide10k``: tests/data/seq_10K_n100.seq, 100 pairs of ~10 kbp, exact,
  penalties 2,3,1, max_error 3000, W=6016 (K4; K4 + K3);
* ``large1k``: the 24 random 850-950 bp pairs of ``chip_smoke.py`` phase
  large-working-set (seed 601), exact, penalties 600,6,2 (A = 601), max_error
  3000, W=2176 (K4 at a large working set; K4 + K3).

    python3 tools/torch_stage_times.py [--workload hifi|wide10k|large1k]
                                       [--reps 3] [--root DIR]

``--root`` imports ``wfa_tpu_torch`` from another checkout (an earlier
commit unpacked with ``git archive``), to compare two versions in turns on
the same card.

Needs a CUDA device.  Each timed call's stages are the program's own
spans and counters (``utils.timers.TRACE``: presort, plan, slots, pack,
launch, wait, decode, results, fallback, the time no stage covers, and
the call's thread CPU time), taken as the call runs, with no
``synchronize()`` inside it; one further call runs under
``torch.profiler`` for the device time by kernel and copy.
A ``--root`` without those spans gives each call's total alone.  Prints the
card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3, help="timed repeats per mode")
    ap.add_argument("--workload", choices=("hifi", "wide10k", "large1k"),
                    default="hifi")
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_stage_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    import numpy as np

    from wfa_tpu_torch import AlignmentOptions, Penalties, align_pairs
    from wfa_tpu_torch.utils.io import read_seq_file
    from wfa_tpu_torch.utils.synth import random_pairs
    try:
        from wfa_tpu_torch.utils.timers import TRACE
    except ImportError:      # a --root from before the program's spans
        TRACE = None

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)

    data = ROOT / "tests" / "data"
    pen = Penalties(2, 3, 1)
    if args.workload == "hifi":
        batch = read_seq_file(data / "test_hifi.seq")
        pats, txts = batch.patterns * 8, batch.texts * 8
        banded = dict(band=25, band_width=512)
    elif args.workload == "wide10k":
        batch = read_seq_file(data / "seq_10K_n100.seq")
        pats, txts = batch.patterns, batch.texts
        banded = {}
    else:
        rng = np.random.default_rng(601)
        random_pairs(rng, 32, 90, 110, 0.1, 0, 0)        # the phase's 100 bp set
        pairs = random_pairs(rng, 24, 850, 950, 0.05, 0, 0)
        pats, txts = [p for p, _ in pairs], [t for _, t in pairs]
        pen, banded = Penalties(600, 6, 2), {}
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "workload": args.workload, "pairs": len(pats),
              "root": str(args.root.resolve())}
    for mode, cigar in (("distance", False), ("cigar", True)):
        opts = AlignmentOptions(penalties=pen, max_error=3000,
                                compute_cigar=cigar, backend="cuda", **banded)
        align_pairs(pats[:8], txts[:8], opts)          # warm-up
        runs = []
        for _ in range(args.reps):
            if TRACE is not None:
                TRACE.enable()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = align_pairs(pats, txts, opts)
            t1 = time.perf_counter()
            if TRACE is not None:
                TRACE.disable()
            assert all(r.finished_on_accelerator for r in res)
            row = {"total_ms": (t1 - t0) * 1e3}
            if TRACE is not None:
                (call,) = TRACE.calls(t0, t1)
                row["stages"] = {
                    name: {"n": st["n"], "wall_ms": st["wall"] * 1e3,
                           "self_ms": st["self"] * 1e3}
                    for name, st in call["stages"].items()}
                row["other_ms"] = call["other"] * 1e3
                row["cpu_ms"] = call["cpu"] * 1e3
                row["counters"] = call["counters"]
            runs.append(row)
        with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ]) as prof:
            t0 = time.perf_counter()
            align_pairs(pats, txts, opts)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # Kernels and copies only: the CPU ops that launched them report
        # the same device time again.
        device = {
            e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
        }
        busy = sum(device.values())
        report[mode] = {
            "runs": runs,
            "profiled_wall_ms": wall,
            "device_ms_by_name": device,
            "device_busy_ms": busy,
            "idle_share": 1 - busy / wall,
        }
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
