#!/usr/bin/env python3
"""The control of a cell: the reference put in the program's place, with
the guarantee its configuration states broken as the configuration's
``control`` entry says, judged as a run judges the program.  It has to come
out not correct.

    python3 wfabench/control.py --workload <cell> --seeds 1,2,3 [--cpu]

Prints one JSON line a seed: the control's counts over one pass of the
pool (a run counts each wrong pair once a call), the reference's seconds
and the distances' range.  On the card unless ``--cpu``.  Not part of a
benchmark run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from wfabench import harness  # noqa: E402


@dataclasses.dataclass
class _Result:
    error: int
    finished: bool = True
    finished_on_accelerator: bool = True
    cigar: str = ""


def control_counts(cell: harness.Cell, seed: int, device) -> dict:
    gen = harness.load_module(harness.BENCH / "gen" / f"{cell.traffic['generator']}.py")
    pool = gen.make_pool(cell.traffic, cell.config["batch_size"], seed,
                         harness.BENCH / "data")
    t0 = time.perf_counter()
    ref = harness.reference(cell, pool, device)
    ref_s = time.perf_counter() - t0
    ctl = harness.reference(cell, pool, device, control=True)
    answers = harness.Answers(pool, cigar=False)
    for b, (d, f) in enumerate(ctl):
        answers.add(b, [_Result(int(v), bool(ok)) for v, ok in zip(d, f)])
    counts = harness.judge(answers, ref, tuple(cell.config["penalties"]))
    dist = [int(v) for d, _ in ref for v in d]
    return {"workload": cell.name, "seed": seed, **counts,
            "reference_s": ref_s, "ref_min": min(dist), "ref_max": max(dist)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")
    cell = harness.find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_counts(cell, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
