#!/usr/bin/env python3
"""Times K1, K2 and K4 (wfa_tpu_torch/ops/csrc/wfa_distance.cu) and K3
(wfa_traceback.cu) with CUDA events.

    python3 tools/torch_k1k2_times.py [--root DIR] [--rounds N]
                                      [--warps 1,2,4] [--only NAME]

Needs one NVIDIA GPU and nvcc; imports no jax.  ``--root`` imports
``wfa_tpu_torch`` from another checkout of the repository (an earlier commit
unpacked with ``git archive``), whose kernels then build into that
checkout's ``build/cuda/``: to compare two versions, run the script once
per checkout, in turns, on the same card.  Each time is the mean of
5 launches after a warm-up, taken ``--rounds`` times in turn.  Prints one
JSON object: the card (``nvidia-smi`` name and power limit), the tree, and
lists of ms:

- ``hifi_k1``, ``hifi_k2``: the HiFi workload, 400 pairs (the 50 of
  ``tests/data/test_hifi.seq`` x 8), W=512, band 25, penalties (2,3,1),
  max_steps 3000, as ``chip_smoke.py`` phases hifi and hifi-cigar time it;
  ``hifi_k1_256``, ``hifi_k2_256`` at 256 threads a block (two diagonals a
  thread);
- ``pair30_k1``, ``pair30_k2``: the 8 copies of pair 30 (distance 426, the
  slowest) alone: about as long as the 400 when each block's chain of
  dependent steps sets the time, much shorter when the SMs' issue does;
- ``exact1k_k1_T``, ``exact1k_k2_T``: ``seq_1000_n1000`` at max_error 300
  (exact, W=640, as ``align_pairs`` plans it) at T = 512 and 1024 threads a
  block (null where the kernel refuses T);
- ``w3840_k1_T``, ``w3840_k4``: ``seq_10K_n100`` at the widest window a
  shared ring holds (3840 at A=5), the loop stopped at its certificate, on
  K1 at T threads and on K4;
- ``wide10k_k4``, ``wide10k_k4_cigar``, ``ringwide_k4``: K4, which shares
  the extension, on ``seq_10K_n100`` at max_error 3000 (W=6016) in both
  modes and on the ring-wide set (16 x 5 kbp, W=9216), as ``align_pairs``
  plans them;
- ``burst_k4b``, ``burst_k4bc``: banded K4 (W=4096, band 25, max_steps
  5000, as ``chip_smoke.py`` phase nanopore-burst-wide runs it) on the 128 x
  20 kbp burst reads of ``tools/torch_nanopore_recall.py`` in distance and
  CIGAR-table mode, at the default threads and, as ``..._T``, at T = 512
  and 1024 (null where the kernel refuses T), and exact K4 on
  ``seq_10K_n100`` with its centre pinned to 0 and 32 (``wide10k_k4_c0``,
  ``wide10k_k4_c32``);
- ``big640_k4``, ``big640c_k4``, ``big2176_k4``, ``big2176x4_k4``,
  ``big2176c_k4``, ``big6016c_k4``, ``big256b_k4``, ``big580_k4``,
  ``big3e200_k4``: K4 at large working sets, (600,6,2) (A = 601), (580,6,2)
  and (3,200,1), on random pairs of 150-220 bp (W=640), 900-950 bp
  (W=2176; banded W=256) and 9.8-10 kbp (W=6016), in distance and
  CIGAR-table mode: the compact ring where the tree has it, else the whole
  ring.  Each at as many pairs as the whole ring puts in one launch at the
  default memory budget (x4: at four times it), the same pairs in every
  tree; ``big..own_k4`` at as many as this tree puts in one launch
  (``pairs_a_launch``: W, centre and both counts); ``big2176setup_k4``,
  ``big6016csetup_k4`` stopped at score 0 (the block's set-up and, for the
  whole ring, its reset); ``big640``, ``big640c``, ``big2176`` also at
  T = 512 and 1024 threads (``..._T``; W=640 takes at most 640);
  ``probe151_k4``: the probe's banded K4 at A = 151 on the 50 HiFi pairs;
- with ``_rows`` on the wrappers, the HiFi times with the rows pinned in
  global memory (``hifi_k1_rows_global``, ``hifi_k2_rows_global``);
- with ``engine_cuda.blocks_per_sm``, ``blocks_per_sm``: the blocks one SM
  holds at once and their threads, for the default launches above;
- ``hifi_k3``, ``pair30_k3``, ``exact1k_k3``, ``wide10k_k3``: K3 alone on
  K2's (K4's) tables of the HiFi, pair-30, exact-1k and wide10k workloads
  above, at the wrapper's defaults; and, where ``traceback_cuda`` takes
  ``_warps``, the same at each of ``--warps`` walks a block
  (``hifi_k3_w1`` ...).  ``--only`` times only the runs whose name
  contains it.
  Every K3 run's fused rows must equal the first run's of its workload.
  K3 is timed one launch at a time behind a spin kernel (its walks take
  about as long as a launch from Python), warm (its rows in L2 from the
  run before) and, as ``..._cold``, after 128 MB were overwritten.
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--warps", default="1,2,4",
                    help="K3's walks a block to time, comma-separated")
    ap.add_argument("--only", default="",
                    help="time only the runs whose name contains this")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_k1k2_times: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import numpy as np

    from wfa_tpu_torch import AlignmentOptions, Penalties, aligner
    from wfa_tpu_torch.ops import engine_cuda, engine_torch, traceback_torch
    from wfa_tpu_torch.ops.packing import pack_batch
    from wfa_tpu_torch.schedule import build_schedule
    from wfa_tpu_torch.utils.io import read_seq_file
    from wfa_tpu_torch.utils.synth import random_pairs, ring_wide_pairs

    dev = torch.device("cuda", 0)
    data = root / "tests" / "data"
    pen = Penalties(2, 3, 1)
    smem = engine_cuda.smem_optin(dev)

    def tensors(pairs, nw=None):
        if nw is None:
            nw = max(max(len(p), len(t)) for p, t in pairs) // 16 + 2
        pat, plen, vp = pack_batch([p for p, _ in pairs], nw)
        txt, tlen, vt = pack_batch([t for _, t in pairs], nw)
        return engine_torch.batch_to_tensors(pat, plen, txt, tlen, vp & vt, dev)

    def cuda_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    flush = torch.empty(2**25, dtype=torch.int32, device=dev)   # 128 MB > L2

    def launch_ms(fn, reps=5, cold=False):
        """One launch at a time, each queued behind a spin kernel so that
        the host's enqueue is not timed (K3 runs for tens of us, about as
        long as a launch from Python): the mean ms; ``cold`` overwrites
        128 MB first, so that the launch finds none of its table in L2."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        total = 0.0
        for _ in range(reps):
            if cold:
                flush.zero_()
            torch.cuda._sleep(1_000_000)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / reps

    def route(pairs, opts):
        lens = np.array([max(len(p), len(t)) for p, t in pairs])
        (plan,) = aligner._plan_tiers(lens, opts, opts.max_error)
        cfg, _, _, cap = aligner._tier_geometry_cuda(plan, opts, opts.max_error,
                                                     -1, smem)
        return cfg, cap, plan.nwords

    def cigar_cfg(cfg, max_steps):
        cap = build_schedule(cfg.penalties, max_steps, None).unfinished_score + 1
        return dataclasses.replace(cfg, score_limit=cap - 1, compute_cigar=True), cap

    hifi = read_seq_file(data / "test_hifi.seq")
    hifi_pairs = list(zip(hifi.patterns, hifi.texts))
    ref = json.loads((data / "hifi_banded_w512_b25.json").read_text())["distance"]
    slow = ref.index(max(ref))
    hifi_args = tensors(hifi_pairs * 8)
    pair_args = tensors([hifi_pairs[slow]] * 8, nw=hifi_args[0].shape[1])
    band_cfg = engine_torch.EngineConfig(pen, 3000, 512, 25)
    band_ccfg, band_cap = cigar_cfg(band_cfg, 3000)

    k1k = read_seq_file(data / "seq_1000_n1000.seq")
    k1k_pairs = list(zip(k1k.patterns, k1k.texts))
    k1k_cfg, _, k1k_nw = route(k1k_pairs, AlignmentOptions(
        penalties=pen, max_error=300, backend="cuda"))
    k1k_ccfg, k1k_cap, _ = route(k1k_pairs, AlignmentOptions(
        penalties=pen, max_error=300, backend="cuda", compute_cigar=True))
    k1k_args = tensors(k1k_pairs, nw=k1k_nw)

    w10 = read_seq_file(data / "seq_10K_n100.seq")
    w10_pairs = list(zip(w10.patterns, w10.texts))
    w10_cfg, _, w10_nw = route(w10_pairs, AlignmentOptions(
        penalties=pen, max_error=3000, backend="cuda"))
    cut = engine_cuda.max_width(pen.active_working_set, smem)
    cut_cfg = dataclasses.replace(w10_cfg, wf_width=cut, ring_global=False,
                                  score_limit=pen.o + pen.e * (cut // 2 + 1))
    w10_args = tensors(w10_pairs, nw=w10_nw)
    w10_ccfg, w10_cap, _ = route(w10_pairs, AlignmentOptions(
        penalties=pen, max_error=3000, backend="cuda", compute_cigar=True))
    rw_pairs = ring_wide_pairs()
    rw_cfg, _, rw_nw = route(rw_pairs, AlignmentOptions(
        penalties=pen, max_error=4600, backend="cuda", cpu_fallback=False))
    rw_args = tensors(rw_pairs, nw=rw_nw)
    sys.path.insert(0, str(root / "tools"))
    import torch_nanopore_recall as recall

    bpats, btxts, _ = recall.long_reads(True)
    bargs = recall.tensors(bpats, btxts, recall.card_words(bpats, btxts), dev)
    burst_cfg = dataclasses.replace(recall.banded_config(4096), ring_global=True)
    burst_ccfg, burst_cap = cigar_cfg(burst_cfg, recall.MAX_STEPS)

    K1, K2 = engine_cuda.align_batch_cuda, engine_cuda.cigar_tables_cuda
    runs = {
        "hifi_k1": lambda: K1(band_cfg, *hifi_args),
        "hifi_k2": lambda: K2(band_ccfg, band_cap, *hifi_args),
        "pair30_k1": lambda: K1(band_cfg, *pair_args),
        "pair30_k2": lambda: K2(band_ccfg, band_cap, *pair_args),
        "hifi_k1_256": lambda: K1(band_cfg, *hifi_args, _threads=256),
        "hifi_k2_256": lambda: K2(band_ccfg, band_cap, *hifi_args, _threads=256),
        "w3840_k4": lambda: K1(dataclasses.replace(cut_cfg, ring_global=True),
                               *w10_args),
        "wide10k_k4": lambda: K1(w10_cfg, *w10_args),
        "wide10k_k4_cigar": lambda: K2(w10_ccfg, w10_cap, *w10_args),
        "ringwide_k4": lambda: K1(rw_cfg, *rw_args),
    }
    # Runs a tree may refuse: 1024 threads, a centre of 0.
    optional = set()
    for t in ("", 512, 1024):
        kw = {"_threads": t} if t else {}
        suffix = f"_{t}" if t else ""
        runs["burst_k4b" + suffix] = lambda kw=kw: K1(burst_cfg, *bargs, **kw)
        runs["burst_k4bc" + suffix] = lambda kw=kw: K2(burst_ccfg, burst_cap,
                                                       *bargs, **kw)
    for c in (0, 32):
        runs[f"wide10k_k4_c{c}"] = lambda c=c: K1(w10_cfg, *w10_args, _centre=c)
        optional.add(f"wide10k_k4_c{c}")
    # Large working sets (A > 64): K4's compact ring in a tree that has it,
    # the whole ring (at A = 601 a centre of 0) in one that does not; a tree
    # without either plans none of them.  ``{name}_k4`` runs as many pairs
    # as the whole ring puts in one launch, the same in every tree;
    # ``{name}own_k4`` as many as this tree puts in one (``pairs_a_launch``);
    # ``{name}setup_k4`` stops at score 0 (max_steps 2): the block's set-up
    # and, for the whole ring, its reset.
    def tree_arith(fn, p, *rest):
        """fn(penalties, ...) in this tree's arithmetic, fn(A, ...) in a
        tree whose K4 arithmetic takes the working set."""
        try:
            return fn(p, *rest)
        except TypeError:
            return fn(p.active_working_set, *rest)

    big_rng = np.random.default_rng(601)
    big_cfgs = []
    pairs_a_launch = {}
    for name, pen_xoe, lo, hi, cigar, budget, band in (
        ("big640", (600, 6, 2), 150, 220, False, 1, -1),
        ("big640c", (600, 6, 2), 150, 220, True, 1, -1),
        ("big2176", (600, 6, 2), 900, 950, False, 1, -1),
        ("big2176x4", (600, 6, 2), 900, 950, False, 4, -1),
        ("big2176c", (600, 6, 2), 900, 950, True, 1, -1),
        ("big6016c", (600, 6, 2), 9800, 10000, True, 1, -1),
        ("big256b", (600, 6, 2), 900, 950, False, 1, 25),
        ("big580", (580, 6, 2), 900, 950, False, 1, -1),
        ("big3e200", (3, 200, 1), 900, 950, False, 1, -1),
    ):
        big_pen = Penalties(*pen_xoe)
        big_opts = AlignmentOptions(
            penalties=big_pen, max_error=3000, compute_cigar=cigar, backend="cuda",
            band=band, band_width=256 if band > 0 else None,
            memory_budget_bytes=budget * AlignmentOptions().memory_budget_bytes)
        pool = random_pairs(big_rng, 1024 if hi < 5000 else 64, lo, hi, 0.1, 0, 0)
        lens = np.array([max(len(p), len(t)) for p, t in pool])
        (plan,) = aligner._plan_tiers(lens, big_opts, big_opts.max_error)
        try:
            cfg, _, _, cap = aligner._tier_geometry_cuda(plan, big_opts, 3000, band, smem)
        except ValueError:
            continue
        nw, W = plan.nwords, cfg.wf_width
        centre = tree_arith(engine_cuda.centre_width, big_pen, W, nw, cigar, smem)
        whole = 12 * big_pen.active_working_set * W

        def batch(ring, cigar=cigar, cap=cap, W=W, opts=big_opts):
            return (aligner._cigar_call_batch(opts, cap, W, ring) if cigar
                    else aligner._distance_call_batch(opts, ring))

        n, own = batch(whole), batch(tree_arith(engine_cuda.ring_bytes, big_pen, W, centre))
        pairs_a_launch[name] = {"W": W, "centre": centre, "whole_ring": n, "tree": own}
        big_cfgs.append((f"{name}_k4", cfg, nw, cigar))
        stop = dataclasses.replace(cfg, max_steps=2)
        for tag, c, m in (("", cfg, n), ("own", cfg, own), ("setup", stop, n)):
            if (tag == "own" and own == n) or (tag == "setup" and name not in (
                    "big2176", "big6016c")):
                continue
            a = tensors((pool * (m // len(pool) + 1))[:m], nw=nw)
            for t in ("", 512, 1024) if tag == "" and name in (
                    "big640", "big640c", "big2176") else ("",):
                kw = {"_threads": t} if t else {}
                runs[f"{name}{tag}_k4" + (f"_{t}" if t else "")] = (
                    (lambda c=c, cap=cap, a=a, kw=kw: K2(c, cap, *a, **kw))
                    if cigar else (lambda c=c, a=a, kw=kw: K1(c, *a, **kw)))
    # The probe at A = 151 (banded K4 at W=128 on the 50 HiFi pairs).
    probe_cfg = aligner._probe_config(Penalties(150, 6, 2), 3000, 0, smem)
    probe_args = tensors(hifi_pairs)
    runs["probe151_k4"] = lambda: K1(probe_cfg, *probe_args)
    for t in (512, 1024):
        runs[f"exact1k_k1_{t}"] = lambda t=t: K1(k1k_cfg, *k1k_args, _threads=t)
        runs[f"exact1k_k2_{t}"] = lambda t=t: K2(k1k_ccfg, k1k_cap, *k1k_args,
                                                 _threads=t)
        runs[f"w3840_k1_{t}"] = lambda t=t: K1(cut_cfg, *w10_args, _threads=t)
    if "_rows" in inspect.signature(K1).parameters:
        runs["hifi_k1_rows_global"] = lambda: K1(band_cfg, *hifi_args, _rows="global")
        runs["hifi_k2_rows_global"] = lambda: K2(band_ccfg, band_cap, *hifi_args,
                                                 _rows="global")

    # K3 alone, on tables K2 (K4) built once per workload.
    K3 = engine_cuda.traceback_cuda
    pinned = "_warps" in inspect.signature(K3).parameters
    for name, ccfg, cap, targs in (
        ("hifi", band_ccfg, band_cap, hifi_args),
        ("pair30", band_ccfg, band_cap, pair_args),
        ("exact1k", k1k_ccfg, k1k_cap, k1k_args),
        ("wide10k", w10_ccfg, w10_cap, w10_args),
    ):
        tab = K2(ccfg, cap, *targs)
        tb = traceback_torch.TracebackConfig(
            pen, ccfg.wf_width, cap, banded=ccfg.banded,
            lo_pad=engine_torch.lo_pad(cap) if ccfg.banded else 0)
        k3_args = (tb, tab["choice_words"], tab.get("lo_trace"), tab["distance"],
                   tab["finished"], targs[3] - targs[2])
        k3_runs = {f"{name}_k3": lambda a=k3_args: K3(*a)}
        if pinned:
            for w in map(int, args.warps.split(",")):
                k3_runs[f"{name}_k3_w{w}"] = lambda a=k3_args, w=w: K3(*a, _warps=w)
        for key, fn in k3_runs.items():
            runs[key] = fn
            runs[key + "_cold"] = fn

    runs = {k: v for k, v in runs.items() if args.only in k}
    # Every run's distances must equal the first run's of its workload.
    want = {}
    times = {name: [] for name in runs}
    for _ in range(args.rounds):
        for name, fn in runs.items():
            try:
                if "_k3" in name:
                    times[name].append(launch_ms(fn, cold=name.endswith("_cold")))
                else:
                    times[name].append(cuda_ms(fn))
            except (RuntimeError, ValueError):
                if not (name.endswith("_1024") or name in optional):
                    raise
                # An earlier kernel takes at most 512 threads, or no centre
                # of 0.
                times[name] = None
                continue
            out = fn()
            key = name.split("_")[0]
            if isinstance(out, torch.Tensor):       # K3's fused rows
                key += "_k3"
                got = (out.cpu(),)
            else:
                got = (out["distance"].cpu(), out["finished"].cpu())
            ref_out = want.setdefault(key, got)
            if not all(torch.equal(a, b) for a, b in zip(got, ref_out)):
                raise SystemExit(f"torch_k1k2_times: {name} differs from its workload's first run")
        runs = {k: v for k, v in runs.items() if times[k] is not None}
    if "hifi" in want and want["hifi"][0].tolist() != ref * 8:
        raise SystemExit("torch_k1k2_times: HiFi distances differ from the reference")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    occupancy = {}
    if hasattr(engine_cuda, "blocks_per_sm"):
        for name, cfg, nw, cigar, *threads in (
            ("hifi_k1", band_cfg, hifi_args[0].shape[1], False),
            ("hifi_k2", band_ccfg, hifi_args[0].shape[1], True),
            ("hifi_k1_256", band_cfg, hifi_args[0].shape[1], False, 256),
            ("hifi_k2_256", band_ccfg, hifi_args[0].shape[1], True, 256),
            ("exact1k_k1", k1k_cfg, k1k_nw, False),
            ("exact1k_k2", k1k_ccfg, k1k_nw, True),
            ("w3840_k1", cut_cfg, w10_nw, False),
            ("wide10k_k4", w10_cfg, w10_nw, False),
            ("wide10k_k4_cigar", w10_ccfg, w10_nw, True),
            ("burst_k4b", burst_cfg, bargs[0].shape[1], False),
            ("burst_k4bc", burst_ccfg, bargs[0].shape[1], True),
            *big_cfgs, *((n + "_512", c, w, g, 512) for n, c, w, g in big_cfgs),
        ):
            occupancy[name] = engine_cuda.blocks_per_sm(cfg, nw, dev, cigar=cigar,
                                                        _threads=threads[0] if threads else 0)
    print(json.dumps({"card": card, "root": str(root), "ms": times,
                      "blocks_per_sm": occupancy,
                      "pairs_a_launch": pairs_a_launch}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
