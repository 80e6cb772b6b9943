#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, wfa_tpu_torch.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a), nvcc and a C++ compiler; imports no
jax and nothing of wfa_tpu.  It builds the CUDA kernels from the sources
(K1, K2 and K4: wfa_tpu_torch/ops/csrc/wfa_distance.cu; K3:
wfa_traceback.cu; the ring-row probe: ring_bw.cu), holds each against its
plain PyTorch version on random pairs, drives align_pairs(backend='cuda') on
the golden score sets in distance and CIGAR mode, and runs through the
kernels alone, their plain versions and align_pairs, with times: the HiFi
banded workload (400 pairs of ~14 kbp, W=512, band 25, penalties 2,3,1,
max_steps 3000) in distance and CIGAR mode on K1 and K2 + K3; the 100 x
10 kbp golden set at max_error 3000 (exact, W=6016) in distance and CIGAR
mode on K4, at 1024 and 512 threads a block, with its cells and edge
traffic; the 16 x 5 kbp ring-wide set (exact, W=9216) on K4; the
ring-row probe at two sizes; the speed-of-light calibration kernels and the
wide-gather probe (sol_calibrate.cu, gather_probe.cu), held against their
plain versions and timed at the TPU script's counts for one tile and for
the card full; and the CLI's --profile trace, which must name K1.  Every
phase prints one line with its seconds;
any failure ends the run with a nonzero exit code.  The line before the last lists every kernel with its
launches on the main paths, error against its plain version, times and
bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
HIFI_REPS = 8
# Iterations at which the calibration kernels and their plain versions are
# timed for the kernels line (the plain versions pay a launch per op).
CAL_ITERS = 256

# H100 SXM peaks (NVIDIA data sheet, as tabled in the repository's
# measurement notes): 3.35 TB/s of HBM; 67 TFLOP/s float32 outside the
# tensor cores is 128 FP32 lanes x 2 (an FMA counts 2) per SM and clock, so
# an SM issues at most 128 lane-instructions a clock (4 schedulers x one
# 32-lane warp instruction): 67/2 T/s.  That is the int32 peak too: the 64
# INT32 lanes alone give 67/4 T/s, but IMAD issues to the FMA pipe beside
# them, and the calibration chain (8 source ops in 6 instructions, 2 of them
# IMAD) ran at 32.8 T source ops/s, twice 67/4 (phase calibrate).  The
# operation counts below are source ops, each counted as one instruction.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
# Integer ops one cell (score x window diagonal) needs at least: I 8 (two
# +1, two packs of 2, max, >> 2), D 6, M 10 (+1, three packs, two max, >> 2),
# and one 16-base comparison 8 (two de-phased loads 4, xor, clz, >> 1, add).
# K2 adds the choice nibble: 6 (op test 2, two extend bits 2, shift, or).
# K3 does about 12 per walk step (nibble extract 2, branch tests 3, score,
# diagonal, state updates 4, op append 3).
OPS_PER_CELL = 32
OPS_PER_CELL_CIGAR = OPS_PER_CELL + 6
OPS_PER_WALK_STEP = 12
# K4 before the cone, the shared-memory centre and the shared sequences
# (the whole [3A, W] ring in global memory, every diagonal every score, 512
# threads), on an H100 80GB HBM3 at 700 W (PERF.md section 6): ms.
WHOLE_RING_MS = {"wide10k": 19.135, "wide10k-cigar": 21.684, "ring-wide": 37.7}


def phase(name: str, t0: float, detail: str) -> None:
    print(f"[{name}] {time.perf_counter() - t0:.2f}s {detail}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for the work: bytes over HBM rate vs int ops over peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from wfa_tpu_torch import AlignmentOptions, Penalties, aligner, align_pairs, native
    from wfa_tpu_torch.ops import (
        _build, engine_cuda, engine_torch, gather_probe, ring_bw, sol_calibrate,
        traceback_torch,
    )
    from wfa_tpu_torch.ops.packing import pack_batch
    from wfa_tpu_torch.schedule import build_schedule, cone_radii
    from wfa_tpu_torch.utils.device_query import describe
    from wfa_tpu_torch.utils.io import read_seq_file
    from wfa_tpu_torch.utils.synth import EDGE_PAIRS, random_pairs, ring_wide_pairs
    from wfa_tpu_torch.utils.verification import affine_score, check_cigar

    dev = torch.device("cuda", 0)

    def tensors(pairs, invalid_every=0, nw=None):
        if nw is None:
            nw = max(max(len(p), len(t)) for p, t in pairs) // 16 + 2
        pat, plen, vp = pack_batch([p for p, _ in pairs], nw)
        txt, tlen, vt = pack_batch([t for _, t in pairs], nw)
        valid = vp & vt
        if invalid_every:
            valid[::invalid_every] = False
        return engine_torch.batch_to_tensors(pat, plen, txt, tlen, valid, dev)

    def cuda_ms(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, out

    def cigar_configs(pen, max_steps, width, band, ring_global=False):
        """The CUDA route's CIGAR geometry (aligner._tier_geometry_cuda)."""
        score_cap = build_schedule(pen, max_steps, None).unfinished_score + 1
        cfg = engine_torch.EngineConfig(
            pen, max_steps, width, band, score_limit=score_cap - 1,
            compute_cigar=True, ring_global=ring_global,
        )
        tb = traceback_torch.TracebackConfig(
            pen, width, score_cap, banded=band > 0,
            lo_pad=engine_torch.lo_pad(score_cap) if band > 0 else 0,
        )
        return cfg, tb

    # ---- 1. Card ----
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    phase("card", t0, f"{describe()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # ---- 2. Build: one nvcc per source, all at once ----
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.load_library(name)
    ptxas = "; ".join(
        f"{name}: " + ", ".join(
            ln.split(":", 1)[-1].strip()
            for ln in so.with_suffix(".log").read_text().splitlines()
            if "registers" in ln or "spill" in ln
        )
        for name, so in libs.items()
    )
    t_nvcc = time.perf_counter() - t0
    # Registers of each wfa_kernel<banded, cigar, ring_global>; no spills.
    regs, kernel = {}, None
    log = libs["wfa_distance"].with_suffix(".log").read_text().splitlines()
    for ln in log:
        if m := re.search(r"wfa_kernelILb(\d)ELb(\d)ELb(\d)E", ln):
            kernel = "<" + ", ".join(("false", "true")[int(c)] for c in m.groups()) + ">"
        elif kernel and (m := re.search(r"Used (\d+) registers", ln)):
            regs[kernel] = int(m.group(1))
    spills = [ln for ln in log if "spill" in ln and not re.search(
        r"\b0 bytes spill stores, 0 bytes spill loads", ln)]
    require(not spills, "wfa_distance.cu spills registers: " + "; ".join(spills))
    # The host library: packing, readers, the CPU fallback, CIGAR decoding.
    require(_build.ensure_native(), "the native host library did not build")
    threads = native.get_lib().wfa_cpu_num_threads()
    phase("build", t0, f"nvcc sm_90a {t_nvcc:.2f}s: {ptxas}; wfa_kernel "
          f"registers {regs}, no spills; native host "
          f"library {time.perf_counter() - t0 - t_nvcc:.2f}s, {threads} CPU "
          "fallback thread(s)")

    def reset_launches():
        for counts in (engine_cuda.LAUNCHES, ring_bw.LAUNCHES,
                       sol_calibrate.LAUNCHES, gather_probe.LAUNCHES):
            for k in counts:
                counts[k] = 0

    def fused_plain(tb, plain, args):
        """K3's plain version on the plain K2/K4 tables: the fused rows."""
        walk = traceback_torch.traceback_batch_device(
            tb, plain["choice_words"], plain.get("lo_trace"),
            plain["distance"], plain["finished"], args[3] - args[2],
        )
        return traceback_torch.fuse(plain["distance"], plain["finished"],
                                    walk["n_ops"], walk["ops"])

    def exact_bound(cfg, dist, fin, args, cigar):
        """K4's bound_ms on this run's data: cells = for each scheduled
        score up to each pair's distance (the last scheduled score if
        unfinished), the diagonals that score can reach, |k| <= (s - o) / e
        (only k = 0 below o + e), at most W; in CIGAR mode one stored choice
        word per reachable diagonal per 8 scores (the widest score of the
        8)."""
        pen, W = cfg.penalties, cfg.wf_width
        sched = build_schedule(pen, cfg.max_steps, cfg.score_limit)
        scores = sched.score.astype(np.int64)
        lanes = np.where(scores >= pen.o + pen.e,
                         np.minimum(W, 2 * ((scores - pen.o) // pen.e) + 1), 1)
        reach = [d if f else int(scores[-1]) if scores.size else 0
                 for d, f in zip(dist.tolist(), fin.tolist())]
        cells = row_words = 0
        for d in reach:
            upto = scores <= d
            cells += int(lanes[upto].sum())
            group = scores[upto] >> 3
            last = np.append(group[1:] != group[:-1], True)
            row_words += int(lanes[upto][last].sum())
        nbytes = sum(t.numel() * t.element_size() for t in args) + 5 * len(reach)
        if cigar:
            return cells, bound_ms(nbytes + row_words * 4,
                                   cells * OPS_PER_CELL_CIGAR)
        return cells, bound_ms(nbytes, cells * OPS_PER_CELL)

    def k4_work(cfg, centre, dist, fin):
        """What K4 did on this run's data, for each pair up to its distance
        (all scheduled scores if unfinished): the cells it computed (each
        step's cone, capped at W), the cells of the whole window (every
        diagonal every score, as K4 did before the cone), and the bytes its
        global edges moved: each block's slab reset, 3 stores a computed
        edge cell and each parent read that lands on an edge (the reset of a
        shrinking cone is not counted: (2,3,1) has none)."""
        pen, W = cfg.penalties, cfg.wf_width
        sched = build_schedule(pen, cfg.max_steps, cfg.score_limit)
        radius, _ = cone_radii(pen, cfg.max_steps, cfg.score_limit)
        W2 = W // 2
        r = np.minimum(radius, W2).astype(np.int64)
        lo, hi = W2 - r, np.minimum(W - 1, W2 + r)
        c_lo = (W - centre) // 2
        c_hi = c_lo + centre - 1

        def on_edges(a, b):   # lanes a..b outside the centre c_lo..c_hi
            n = np.maximum(b - a + 1, 0)
            return n - np.maximum(np.minimum(b, c_hi) - np.maximum(a, c_lo) + 1, 0)

        edge = on_edges(lo, hi)
        gap_parents = (sched.moe_slot >= 0).astype(np.int64) + (sched.ide_slot >= 0)
        reads = ((sched.mx_slot >= 0) * edge
                 + gap_parents * (on_edges(np.maximum(lo, 1) - 1, hi - 1)
                                  + on_edges(lo + 1, np.minimum(hi, W - 2) + 1)))
        cum = {k: np.concatenate([[0], np.cumsum(v)]) for k, v in (
            ("cells", hi - lo + 1), ("edge", edge), ("bytes", 4 * (3 * edge + reads)))}
        steps = [int(np.searchsorted(sched.score, d, side="right")) if f
                 else sched.num_steps for d, f in zip(dist.tolist(), fin.tolist())]
        slab = 4 * 3 * pen.active_working_set * (W - centre)
        return {
            "cells": sum(int(cum["cells"][n]) for n in steps),
            "edge_cells": sum(int(cum["edge"][n]) for n in steps),
            "window_cells": sum(steps) * W,
            "edge_bytes": sum(int(cum["bytes"][n]) for n in steps) + slab * len(steps),
            "allocated": slab * len(steps),
        }

    def work_line(work, cone_cells, centre):
        return (f"C={centre}: {work['cells']} cells computed, {cone_cells} in "
                f"the cone, {work['window_cells']} in the whole window "
                f"({work['window_cells'] / work['cells']:.2f}x); "
                f"{work['edge_cells']} on the global edges "
                f"({100 * work['edge_cells'] / work['cells']:.1f}%); edges "
                f"{work['allocated'] / 1e6:.3f} MB allocated, "
                f"{work['edge_bytes'] / 1e9:.3f} GB moved")

    def threads_ms(fn, reps=3):
        """K4 at 1024 and 512 threads a block, in turns (1024, 512, 512,
        1024): the mean ms of each."""
        fn(1024)
        fn(512)
        torch.cuda.synchronize()
        t = {1024: 0.0, 512: 0.0}
        for n in (1024, 512, 512, 1024):
            t[n] += cuda_ms(lambda: fn(n), reps)[0] / 2
        return t

    smem = engine_cuda.smem_optin(dev)

    def route_config(pats, txts, opts):
        """The config align_pairs(backend='cuda') launches on one tier, and
        the tier's packed words per sequence."""
        lens = np.array([max(len(p), len(t)) for p, t in zip(pats, txts)])
        plans = aligner._plan_tiers(lens, opts, opts.max_error)
        require(len(plans) == 1, "expected one length tier")
        return (*aligner._tier_geometry_cuda(plans[0], opts, opts.max_error,
                                             -1, smem), plans[0].nwords)

    # ---- 3. K1 against the plain version on the card ----
    t0 = time.perf_counter()
    rng = np.random.default_rng(20261016)
    max_err = {"wfa_distance": 0, "wfa_cigar": 0, "wfa_traceback": 0,
               "wfa_distance_ring": 0, "wfa_cigar_ring": 0, "ring_bw": 0,
               "vpu_ops": 0, "gather_chain": 0, "scalar_sync": 0, "k_wide": 0}
    n_cases = n_lanes = 0
    prep_s = k1_s = plain_s = 0.0
    pens = (Penalties(2, 3, 1), Penalties(1, 0, 1), Penalties(4, 1, 2))
    cases = [
        (band, pen, w) for band in (-1, 10, 25) for pen in pens
        for w in (128, 512, 1024)
    ] + [(band, Penalties(70, 6, 2), 128) for band in (-1, 10, 25)]
    for band, pen, w in cases:
        t1 = time.perf_counter()
        pairs = EDGE_PAIRS + random_pairs(rng, 96, 10, 1000)
        args = tensors(pairs, invalid_every=13)
        cfg = engine_torch.EngineConfig(pen, 200, w, band)
        prep_s += time.perf_counter() - t1
        t1 = time.perf_counter()
        got = engine_cuda.align_batch_cuda(cfg, *args)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        want = engine_torch.align_batch_device(cfg, *args)
        torch.cuda.synchronize()
        k1_s += t2 - t1
        plain_s += time.perf_counter() - t2
        require(torch.equal(got["finished"], want["finished"]),
                f"finished differs: band={band} pen={pen} W={w}")
        err = (got["distance"] - want["distance"]).abs().max().item()
        require(err == 0, f"distance differs by {err}: band={band} pen={pen} W={w}")
        max_err["wfa_distance"] = max(max_err["wfa_distance"], err)
        n_cases += 1
        n_lanes += len(pairs)
    for band in (-1, 25):
        try:
            engine_cuda.align_batch_cuda(
                engine_torch.EngineConfig(Penalties(70, 6, 2), 200, 512, band),
                *tensors(EDGE_PAIRS),
            )
        except ValueError:
            continue
        require(False, "(70,6,2) at W=512 did not raise ValueError")
    phase("k1-vs-plain", t0, f"{n_cases} cases, {n_lanes} lanes, arrays equal "
          f"(inputs {prep_s:.2f}s, K1 {k1_s:.2f}s, plain {plain_s:.2f}s); "
          "(70,6,2) at W=512 refused")

    # ---- 4. Exact goldens through align_pairs(backend='cuda') ----
    t0 = time.perf_counter()
    launches0 = engine_cuda.LAUNCHES["wfa_distance"]
    utest = read_seq_file(DATA / "wfa.utest.seq")
    golden_runs = []
    for tag, pen in (("p0", Penalties(1, 2, 1)), ("p1", Penalties(3, 1, 4)),
                     ("p2", Penalties(5, 3, 2))):
        path = DATA / "results" / f"test.score.affine.{tag}.alg"
        gold = [-int(ln.split()[0]) for ln in path.read_text().splitlines() if ln.strip()]
        golden_runs.append((f"utest-{tag}", utest, pen, 10000, gold))
    for name, key, pen, me in (
        ("seq_1000_n1000", "results_1000_n1000_x2o3e1", Penalties(2, 3, 1), 300),
        ("seq_10K_n100", "results_10K_n100_x2o3e1", Penalties(2, 3, 1), 3000),
    ):
        gold = json.loads((DATA / f"{name}.golden.json").read_text())[key]
        golden_runs.append((name, read_seq_file(DATA / f"{name}.seq"), pen, me,
                            [-g for g in gold]))
    ring0 = engine_cuda.LAUNCHES["wfa_distance_ring"]
    shares = []
    for name, batch, pen, me, gold in golden_runs:
        t1 = time.perf_counter()
        res = align_pairs(batch.patterns, batch.texts, AlignmentOptions(
            penalties=pen, max_error=me, backend="cuda"))
        bad = sum(r.error != g for r, g in zip(res, gold))
        require(len(res) == len(gold) and bad == 0,
                f"{name}: {bad} scores differ from the goldens")
        on_card = sum(r.finished_on_accelerator for r in res)
        require(on_card == len(res), f"{name}: {on_card}/{len(res)} on the card")
        shares.append(f"{name} {on_card}/{len(res)} on card "
                      f"({time.perf_counter() - t1:.2f}s)")
    require(engine_cuda.LAUNCHES["wfa_distance"] > launches0
            and engine_cuda.LAUNCHES["wfa_distance_ring"] > ring0,
            "golden runs launched no K1 or no K4")
    phase("goldens", t0, "all scores equal; " + ", ".join(shares))

    # ---- 5. HiFi banded distance: 400 x ~14 kbp, W=512, band 25 ----
    t0 = time.perf_counter()
    ref = json.loads((DATA / "hifi_banded_w512_b25.json").read_text())
    hifi = read_seq_file(DATA / "test_hifi.seq")
    pats = hifi.patterns * HIFI_REPS
    txts = hifi.texts * HIFI_REPS
    n = len(pats)
    hifi_args = tensors(list(zip(pats, txts)))
    cfg = engine_torch.EngineConfig(Penalties(2, 3, 1), 3000, 512, 25)
    out = engine_cuda.align_batch_cuda(cfg, *hifi_args)   # warm-up
    torch.cuda.synchronize()
    k1_ms, out = cuda_ms(lambda: engine_cuda.align_batch_cuda(cfg, *hifi_args), 5)
    dist = out["distance"].cpu().numpy()
    require(bool(out["finished"].all()), "HiFi: unfinished pairs on K1")
    require(dist.tolist() == ref["distance"] * HIFI_REPS,
            "HiFi: K1 distances differ from the stored reference")
    k1_plain_ms, plain = cuda_ms(
        lambda: engine_torch.align_batch_device(cfg, *hifi_args), 1)
    err = (plain["distance"] - out["distance"]).abs().max().item()
    require(err == 0 and torch.equal(plain["finished"], out["finished"]),
            "HiFi: plain version differs from K1")
    max_err["wfa_distance"] = max(max_err["wfa_distance"], err)

    opts = AlignmentOptions(penalties=Penalties(2, 3, 1), max_error=3000,
                            band=25, band_width=512, backend="cuda")
    align_pairs(pats[:8], txts[:8], opts)            # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    res = align_pairs(pats, txts, opts)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t1
    k1_launches = engine_cuda.LAUNCHES["wfa_distance"]
    require(k1_launches > 0, "align_pairs(backend='cuda') launched no K1")
    require([r.error for r in res] == ref["distance"] * HIFI_REPS,
            "HiFi: align_pairs distances differ from the stored reference")
    require(all(r.finished_on_accelerator for r in res),
            "HiFi: align_pairs left pairs to the CPU")
    phase("hifi", t0,
          f"{n} pairs: K1 {k1_ms:.3f} ms ({n / k1_ms * 1e3:.1f} aln/s), "
          f"plain {k1_plain_ms:.3f} ms ({n / k1_plain_ms * 1e3:.1f} aln/s), "
          f"align_pairs {e2e_s * 1e3:.3f} ms ({n / e2e_s:.1f} aln/s), "
          f"launches {dict(engine_cuda.LAUNCHES)}; [{smi}]")

    # ---- 6. K2 + K3 against the plain versions on the card ----
    t0 = time.perf_counter()
    n_cases = n_lanes = n_walks = 0
    cases = [
        (band, pen, w) for band in (-1, 10, 25) for pen in pens
        for w in (128, 512)
    ] + [(band, Penalties(70, 6, 2), 128) for band in (-1, 10, 25)]
    for band, pen, w in cases:
        pairs = EDGE_PAIRS + random_pairs(rng, 96, 10, 1000)
        args = tensors(pairs, invalid_every=13)
        ccfg, tb = cigar_configs(pen, 200, w, band)
        fused = engine_cuda.align_cigar_cuda(ccfg, tb, *args)
        tables = engine_cuda.cigar_tables_cuda(ccfg, tb.score_cap, *args)
        torch.cuda.synchronize()
        plain = engine_torch.cigar_tables(ccfg, tb.score_cap, *args)
        tb_plain = traceback_torch.traceback_batch_device(
            tb, plain["choice_words"], plain.get("lo_trace"),
            plain["distance"], plain["finished"], args[3] - args[2],
        )
        want = traceback_torch.fuse(plain["distance"], plain["finished"],
                                    tb_plain["n_ops"], tb_plain["ops"])
        what = f"band={band} pen={pen} W={w}"
        require(torch.equal(tables["finished"], plain["finished"])
                and torch.equal(tables["distance"], plain["distance"]),
                f"K2 distances differ: {what}")
        require(engine_torch.tables_equal(ccfg, tb.score_cap, plain, tables,
                                          cone=True),
                f"K2 choice table differs on the readable region: {what}")
        require(torch.equal(fused, want), f"K2 + K3 rows differ: {what}")
        max_err["wfa_cigar"] = max(max_err["wfa_cigar"], (
            tables["distance"] - plain["distance"]).abs().max().item())
        max_err["wfa_traceback"] = max(
            max_err["wfa_traceback"], (fused - want).abs().max().item())
        n_cases += 1
        n_lanes += len(pairs)
        n_walks += int((want[:, 2] > 0).sum())
    phase("k2k3-vs-plain", t0, f"{n_cases} cases, {n_lanes} lanes, {n_walks} "
          "walks: distances, flags, n_ops and op streams equal; tables equal "
          "on the readable region")

    # ---- 7. CIGAR goldens through align_pairs(compute_cigar=True) ----
    t0 = time.perf_counter()
    kernel_route = engine_cuda.align_cigar_cuda
    launches0 = dict(engine_cuda.LAUNCHES)
    shares = []
    for name, batch, pen, me, gold in golden_runs[:4]:
        t1 = time.perf_counter()
        copts = AlignmentOptions(penalties=pen, max_error=me,
                                 compute_cigar=True, backend="cuda")
        res = align_pairs(batch.patterns, batch.texts, copts)
        t_card = time.perf_counter() - t1
        bad = sum(r.error != g for r, g in zip(res, gold))
        require(len(res) == len(gold) and bad == 0,
                f"{name} CIGAR: {bad} scores differ from the goldens")
        invalid = sum(
            not (check_cigar(r.cigar, p, t) and affine_score(r.cigar, pen) == r.error)
            for r, p, t in zip(res, batch.patterns, batch.texts)
        )
        require(invalid == 0, f"{name}: {invalid} CIGARs invalid")
        on_card = sum(r.finished_on_accelerator for r in res)
        require(on_card == len(res),
                f"{name} CIGAR: {on_card}/{len(res)} on the card")
        # The same geometry with the plain K2/K4 + K3 in place of the
        # kernels, on the pairs below tier 16384 (the plain engine syncs
        # with the host once a score, and tier-16384 windows run ~10^4).
        short = [i for i, (p, t) in enumerate(zip(batch.patterns, batch.texts))
                 if aligner._tier_of(max(len(p), len(t))) < 16384]
        engine_cuda.align_cigar_cuda = traceback_torch.align_cigar_fused
        try:
            plain_res = align_pairs([batch.patterns[i] for i in short],
                                    [batch.texts[i] for i in short], copts)
        finally:
            engine_cuda.align_cigar_cuda = kernel_route
        require([res[i].cigar for i in short] == [r.cigar for r in plain_res],
                f"{name}: CIGARs differ from the plain route's")
        shares.append(f"{name} {on_card}/{len(res)} on card ({t_card:.2f}s; "
                      f"{len(short)} held against the plain route)")
    require(all(engine_cuda.LAUNCHES[k] > launches0[k]
                for k in ("wfa_cigar", "wfa_traceback", "wfa_cigar_ring")),
            "CIGAR golden runs launched no K2, K3 or K4")
    phase("cigar-goldens", t0, "all scores equal, every CIGAR valid with "
          "affine_score == error and equal to the plain route's; "
          + ", ".join(shares))

    # ---- 8. HiFi banded CIGAR: 400 x ~14 kbp, W=512, band 25 ----
    t0 = time.perf_counter()
    cref = json.loads((DATA / "hifi_banded_cigar_w512_b25.json").read_text())
    require(cref["config"] == ref["config"], "HiFi CIGAR reference config")
    pen = Penalties(2, 3, 1)
    ccfg, tb = cigar_configs(pen, 3000, 512, 25)
    tk = hifi_args[3] - hifi_args[2]
    fused = engine_cuda.align_cigar_cuda(ccfg, tb, *hifi_args)   # warm-up
    torch.cuda.synchronize()
    k2k3_ms, fused = cuda_ms(
        lambda: engine_cuda.align_cigar_cuda(ccfg, tb, *hifi_args), 5)
    k2_ms, tables = cuda_ms(
        lambda: engine_cuda.cigar_tables_cuda(ccfg, tb.score_cap, *hifi_args), 5)
    k3_ms, _ = cuda_ms(lambda: engine_cuda.traceback_cuda(
        tb, tables["choice_words"], tables["lo_trace"], tables["distance"],
        tables["finished"], tk), 5)
    arr = fused.cpu().numpy()
    require(bool((arr[:, 1] != 0).all()), "HiFi CIGAR: unfinished pairs on K2")
    require(bool((arr[:, 2] > 0).all()), "HiFi CIGAR: corrupt or missing walks")
    cigars, _ = native.cigar_from_ops_batch(
        np.ascontiguousarray(arr[:, 4:]), arr[:, 2], arr[:, 1] != 0, pats, txts
    )
    require(cigars == cref["cigar"] * HIFI_REPS,
            "HiFi CIGAR: K2 + K3 CIGARs differ from the stored reference")
    k2_plain_ms, plain = cuda_ms(
        lambda: engine_torch.cigar_tables(ccfg, tb.score_cap, *hifi_args), 1)
    k3_plain_ms, tb_plain = cuda_ms(lambda: traceback_torch.traceback_batch_device(
        tb, plain["choice_words"], plain["lo_trace"], plain["distance"],
        plain["finished"], tk), 1)
    want = traceback_torch.fuse(plain["distance"], plain["finished"],
                                tb_plain["n_ops"], tb_plain["ops"])
    require(torch.equal(fused, want), "HiFi CIGAR: K2 + K3 differ from plain")
    max_err["wfa_cigar"] = max(max_err["wfa_cigar"], (
        tables["distance"] - plain["distance"]).abs().max().item())
    max_err["wfa_traceback"] = max(
        max_err["wfa_traceback"], (fused - want).abs().max().item())
    require(engine_torch.tables_equal(ccfg, tb.score_cap, plain, tables),
            "HiFi CIGAR: K2 table differs on the readable region")

    copts = AlignmentOptions(penalties=pen, max_error=3000, band=25,
                             band_width=512, compute_cigar=True, backend="cuda")
    align_pairs(pats[:8], txts[:8], copts)           # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    res = align_pairs(pats, txts, copts)
    torch.cuda.synchronize()
    ce2e_s = time.perf_counter() - t1
    cigar_launches = dict(engine_cuda.LAUNCHES)
    require(cigar_launches["wfa_cigar"] > 0 and cigar_launches["wfa_traceback"] > 0,
            "align_pairs(compute_cigar=True) launched no K2/K3")
    require([r.cigar for r in res] == cref["cigar"] * HIFI_REPS
            and [r.error for r in res] == cref["distance"] * HIFI_REPS,
            "HiFi CIGAR: align_pairs differs from the stored reference")
    require(all(r.finished_on_accelerator for r in res),
            "HiFi CIGAR: align_pairs left pairs to the CPU")

    # The work this run's data needs (bound_ms): cells = scheduled scores up
    # to each pair's distance x that score's window; K2's bytes are the
    # choice rows and lo_trace entries it stores; K3 reads one choice word
    # and one lo_trace entry per step and writes its rows.
    sched = build_schedule(pen, 3000, ccfg.score_limit)
    scores = torch.from_numpy(sched.score).to(dev, torch.int64)
    on_walk = scores[None, :] <= plain["distance"].long()[:, None]   # [B, S]
    windows = plain["window_ext"][:, scores].long() + 1
    cells = int((windows * on_walk).sum())
    rows = int(sum(len(set((sched.score[sched.score <= d] >> 3).tolist()))
                   for d in plain["distance"].tolist()))
    scored = int(on_walk.sum())
    walk_steps = int(want[:, 2].long().sum())
    seq_bytes = sum(t.numel() * t.element_size() for t in hifi_args)
    k1_bound = bound_ms(seq_bytes + 5 * n, cells * OPS_PER_CELL)
    k2_bound = bound_ms(seq_bytes + 5 * n + rows * 512 * 4 + scored * 4,
                        cells * OPS_PER_CELL_CIGAR)
    k3_bound = bound_ms(walk_steps * 8 + 9 * n + fused.numel() * 4,
                        walk_steps * OPS_PER_WALK_STEP)
    phase("hifi-cigar", t0,
          f"{n} pairs: K2+K3 {k2k3_ms:.3f} ms ({n / k2k3_ms * 1e3:.1f} aln/s; "
          f"K2 {k2_ms:.3f}, K3 {k3_ms:.3f}), plain K2+K3 "
          f"{k2_plain_ms + k3_plain_ms:.3f} ms (K2 {k2_plain_ms:.3f}, K3 "
          f"{k3_plain_ms:.3f}), align_pairs {ce2e_s * 1e3:.3f} ms "
          f"({n / ce2e_s:.1f} aln/s), launches {cigar_launches}; all on card, "
          f"no corrupt walk, CIGARs equal the reference x{HIFI_REPS}; "
          f"{cells} cells, {rows} choice rows, {walk_steps} walk steps; [{smi}]")

    # ---- 9. K4 (the ring's edges in global memory) against the plain versions ----
    t0 = time.perf_counter()
    n_cases = n_lanes = n_same = n_cross = 0
    # (pen, W, pinned centre or None, threads or 0): the pinned centres are
    # narrower than the cone, so cells cross from shared to global memory.
    cases = [(pen, w, None, 0) for pen in pens for w in (128, 512, 1024)]
    cases += [(Penalties(70, 6, 2), 512, None, 0),   # a ring of 436 KB per block
              (Penalties(2, 3, 1), 512, 64, 0), (Penalties(4, 1, 2), 1024, 128, 512),
              (Penalties(70, 6, 2), 512, 64, 0), (Penalties(3, 1, 3), 512, 32, 0)]
    for pen, w, centre, threads in cases:
        pairs = EDGE_PAIRS + random_pairs(rng, 96, 10, 1000)
        args = tensors(pairs, invalid_every=13)
        pin = dict(_centre=centre, _threads=threads)
        cfg = engine_torch.EngineConfig(pen, 200, w, -1, ring_global=True)
        ccfg, tb = cigar_configs(pen, 200, w, -1, ring_global=True)
        got = engine_cuda.align_batch_cuda(cfg, *args, **pin)
        tables = engine_cuda.cigar_tables_cuda(ccfg, tb.score_cap, *args, **pin)
        fused = engine_cuda.align_cigar_cuda(ccfg, tb, *args, **pin)
        torch.cuda.synchronize()
        want = engine_torch.align_batch_device(cfg, *args)
        plain = engine_torch.cigar_tables(ccfg, tb.score_cap, *args)
        want_fused = fused_plain(tb, plain, args)
        what = f"pen={pen} W={w} centre={centre} threads={threads}"
        err = (got["distance"] - want["distance"]).abs().max().item()
        require(err == 0 and torch.equal(got["finished"], want["finished"]),
                f"K4 distances differ: {what}")
        max_err["wfa_distance_ring"] = max(max_err["wfa_distance_ring"], err)
        cerr = (tables["distance"] - plain["distance"]).abs().max().item()
        require(cerr == 0 and torch.equal(tables["finished"], plain["finished"]),
                f"K4 CIGAR-mode distances differ: {what}")
        max_err["wfa_cigar_ring"] = max(max_err["wfa_cigar_ring"], cerr)
        require(engine_torch.tables_equal(ccfg, tb.score_cap, plain, tables,
                                          cone=True),
                f"K4 choice table differs on the readable region: {what}")
        require(torch.equal(fused, want_fused), f"K4 + K3 rows differ: {what}")
        if centre is not None:
            work = k4_work(cfg, centre, want["distance"].cpu(),
                           want["finished"].cpu())
            require(work["edge_cells"] > 0, f"no cell on the edges: {what}")
            n_cross += 1
        if engine_cuda.smem_bytes(pen.active_working_set, w, True) <= smem:
            k1 = engine_cuda.align_batch_cuda(
                dataclasses.replace(cfg, ring_global=False), *args)
            k2 = engine_cuda.align_cigar_cuda(
                dataclasses.replace(ccfg, ring_global=False), tb, *args)
            require(torch.equal(k1["distance"], got["distance"])
                    and torch.equal(k1["finished"], got["finished"])
                    and torch.equal(k2, fused), f"K4 differs from K1/K2: {what}")
            n_same += 1
        n_cases += 1
        n_lanes += len(pairs)
    phase("k4-vs-plain", t0, f"{n_cases} cases, {n_lanes} lanes: distances, "
          "flags and fused rows equal, tables equal on the cone's readable "
          f"region; {n_cross} cases with a pinned centre crossing to the "
          f"global edges; equal to K1/K2 on the {n_same} cases a shared ring "
          "holds")

    # ---- 10. wide10k: seq_10K_n100 at max_error 3000, exact, on K4 ----
    t0 = time.perf_counter()
    pen = Penalties(2, 3, 1)
    w10 = read_seq_file(DATA / "seq_10K_n100.seq")
    gold10 = [-g for g in json.loads(
        (DATA / "seq_10K_n100.golden.json").read_text())["results_10K_n100_x2o3e1"]]
    n10 = len(w10.patterns)
    dopts = AlignmentOptions(penalties=pen, max_error=3000, backend="cuda")
    cfg10, full10, _, _, nw10 = route_config(w10.patterns, w10.texts, dopts)
    require(cfg10.ring_global and cfg10.wf_width == 6016 and full10,
            f"seq_10K_n100: expected K4 at W=6016, got {cfg10}")
    args10 = tensors(list(zip(w10.patterns, w10.texts)), nw=nw10)
    centre10 = engine_cuda.centre_width(5, 6016, nw10, False, smem)
    engine_cuda.align_batch_cuda(cfg10, *args10)       # warm-up
    torch.cuda.synchronize()
    k4_ms, out10 = cuda_ms(lambda: engine_cuda.align_batch_cuda(cfg10, *args10), 3)
    k4_threads = threads_ms(
        lambda n: engine_cuda.align_batch_cuda(cfg10, *args10, _threads=n))
    require(bool(out10["finished"].all())
            and out10["distance"].tolist() == gold10,
            "seq_10K_n100: K4 distances differ from the goldens")
    k4_plain_ms, plain10 = cuda_ms(
        lambda: engine_torch.align_batch_device(cfg10, *args10), 1)
    err = (plain10["distance"] - out10["distance"]).abs().max().item()
    require(err == 0 and torch.equal(plain10["finished"], out10["finished"]),
            "seq_10K_n100: the plain version differs from K4")
    k4_cells, k4_bound = exact_bound(cfg10, out10["distance"].cpu(),
                                     out10["finished"].cpu(), args10, False)
    work10 = k4_work(cfg10, centre10, out10["distance"].cpu(),
                     out10["finished"].cpu())
    # What the global ring costs: K1 and K4 on the same pairs at the widest
    # window a shared ring holds, the loop stopped at its certificate.
    cut = engine_cuda.max_width(pen.active_working_set, smem)
    cfg_cut = dataclasses.replace(cfg10, wf_width=cut, ring_global=False,
                                  score_limit=pen.o + pen.e * (cut // 2 + 1))
    cfg_cut4 = dataclasses.replace(cfg_cut, ring_global=True)
    k1_cut_ms, k1_cut = cuda_ms(lambda: engine_cuda.align_batch_cuda(cfg_cut, *args10), 3)
    k4_cut_ms, k4_cut = cuda_ms(lambda: engine_cuda.align_batch_cuda(cfg_cut4, *args10), 3)
    require(torch.equal(k1_cut["distance"], k4_cut["distance"])
            and torch.equal(k1_cut["finished"], k4_cut["finished"]),
            f"seq_10K_n100 at W={cut}: K4 differs from K1")

    align_pairs(w10.patterns[:4], w10.texts[:4], dopts)   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    res = align_pairs(w10.patterns, w10.texts, dopts)
    torch.cuda.synchronize()
    w10_s = time.perf_counter() - t1
    k4_launches = engine_cuda.LAUNCHES["wfa_distance_ring"]
    require(k4_launches > 0, "seq_10K_n100: align_pairs launched no K4")
    require([r.error for r in res] == gold10,
            "seq_10K_n100: align_pairs distances differ from the goldens")
    require(all(r.finished_on_accelerator for r in res),
            "seq_10K_n100: align_pairs left pairs to the CPU")

    copts = dataclasses.replace(dopts, compute_cigar=True)
    ccfg10, cfull10, _, cap10, _ = route_config(w10.patterns, w10.texts, copts)
    require(ccfg10.ring_global and ccfg10.wf_width == 6016 and cfull10,
            f"seq_10K_n100 CIGAR: expected K4 at W=6016, got {ccfg10}")
    ccentre10 = engine_cuda.centre_width(5, 6016, nw10, True, smem)
    engine_cuda.cigar_tables_cuda(ccfg10, cap10, *args10)   # warm-up
    torch.cuda.synchronize()
    k4c_ms, tables10 = cuda_ms(
        lambda: engine_cuda.cigar_tables_cuda(ccfg10, cap10, *args10), 3)
    k4c_threads = threads_ms(
        lambda n: engine_cuda.cigar_tables_cuda(ccfg10, cap10, *args10, _threads=n))
    k4c_plain_ms, cplain10 = cuda_ms(
        lambda: engine_torch.cigar_tables(ccfg10, cap10, *args10), 1)
    cerr = (cplain10["distance"] - tables10["distance"]).abs().max().item()
    require(cerr == 0 and torch.equal(cplain10["finished"], tables10["finished"])
            and engine_torch.tables_equal(ccfg10, cap10, cplain10, tables10,
                                          cone=True),
            "seq_10K_n100: the plain CIGAR tables differ from K4's")
    max_err["wfa_distance_ring"] = max(max_err["wfa_distance_ring"], err)
    max_err["wfa_cigar_ring"] = max(max_err["wfa_cigar_ring"], cerr)
    k4c_cells, k4c_bound = exact_bound(ccfg10, tables10["distance"].cpu(),
                                       tables10["finished"].cpu(), args10, True)
    cwork10 = k4_work(ccfg10, ccentre10, tables10["distance"].cpu(),
                      tables10["finished"].cpu())
    del cplain10, plain10

    align_pairs(w10.patterns[:4], w10.texts[:4], copts)   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    cres = align_pairs(w10.patterns, w10.texts, copts)
    torch.cuda.synchronize()
    c10_s = time.perf_counter() - t1
    k4c_launches = dict(engine_cuda.LAUNCHES)
    require(k4c_launches["wfa_cigar_ring"] > 0 and k4c_launches["wfa_traceback"] > 0,
            "seq_10K_n100 CIGAR: align_pairs launched no K4 or no K3")
    require([r.error for r in cres] == gold10,
            "seq_10K_n100 CIGAR: distances differ from the goldens")
    require(all(r.finished_on_accelerator for r in cres),
            "seq_10K_n100 CIGAR: align_pairs left pairs to the CPU")
    require(all(check_cigar(r.cigar, p, t) and affine_score(r.cigar, pen) == g
                for r, p, t, g in zip(cres, w10.patterns, w10.texts, gold10)),
            "seq_10K_n100 CIGAR: invalid CIGARs")
    engine_cuda.align_cigar_cuda = traceback_torch.align_cigar_fused
    try:
        t1 = time.perf_counter()
        plain_res = align_pairs(w10.patterns[:16], w10.texts[:16], copts)
        route_plain_s = time.perf_counter() - t1
    finally:
        engine_cuda.align_cigar_cuda = kernel_route
    require([r.cigar for r in plain_res] == [r.cigar for r in cres[:16]],
            "seq_10K_n100: CIGARs differ from the plain route's")
    phase("wide10k", t0,
          f"{n10} pairs, W=6016: K4 {k4_ms:.3f} ms (1024 threads "
          f"{k4_threads[1024]:.3f}, 512 threads {k4_threads[512]:.3f}; the "
          f"whole ring {WHOLE_RING_MS['wide10k']} ms), plain "
          f"{k4_plain_ms:.3f} ms; {work_line(work10, k4_cells, centre10)}; "
          f"at W={cut}, cut at its certificate: "
          f"K1 {k1_cut_ms:.3f} ms, K4 {k4_cut_ms:.3f} ms, equal; "
          f"align_pairs {w10_s * 1e3:.3f} ms "
          f"({n10 / w10_s:.1f} aln/s), all on card, distances equal the "
          f"goldens; CIGAR: K4 tables {k4c_ms:.3f} ms (1024 threads "
          f"{k4c_threads[1024]:.3f}, 512 threads {k4c_threads[512]:.3f}; the "
          f"whole ring {WHOLE_RING_MS['wide10k-cigar']} ms), plain "
          f"{k4c_plain_ms:.3f} ms; {work_line(cwork10, k4c_cells, ccentre10)}; "
          f"align_pairs {c10_s * 1e3:.3f} ms ({n10 / c10_s:.1f} aln/s), all "
          "on card, every CIGAR valid and rescoring to its golden, equal to "
          f"the plain route's on 16 pairs ({route_plain_s:.2f}s); "
          f"launches {k4c_launches}; [{smi}]")

    # ---- 11. ring-wide: 16 x 5 kbp at 50% substitution, exact, on K4 ----
    t0 = time.perf_counter()
    rw = ring_wide_pairs()
    rw_p = [p for p, _ in rw]
    rw_t = [t for _, t in rw]
    ropts = AlignmentOptions(penalties=pen, max_error=4600, cpu_fallback=False,
                             backend="cuda")
    cfg_rw, full_rw, _, _, nw_rw = route_config(rw_p, rw_t, ropts)
    require(cfg_rw.ring_global and cfg_rw.wf_width == 9216 and full_rw,
            f"ring-wide: expected K4 at W=9216, got {cfg_rw}")
    args_rw = tensors(rw, nw=nw_rw)
    centre_rw = engine_cuda.centre_width(5, 9216, nw_rw, False, smem)
    engine_cuda.align_batch_cuda(cfg_rw, *args_rw)     # warm-up
    torch.cuda.synchronize()
    rw_ms, out_rw = cuda_ms(lambda: engine_cuda.align_batch_cuda(cfg_rw, *args_rw), 3)
    rw_threads = threads_ms(
        lambda n: engine_cuda.align_batch_cuda(cfg_rw, *args_rw, _threads=n))
    rw_cells, _ = exact_bound(cfg_rw, out_rw["distance"].cpu(),
                              out_rw["finished"].cpu(), args_rw, False)
    work_rw = k4_work(cfg_rw, centre_rw, out_rw["distance"].cpu(),
                      out_rw["finished"].cpu())
    rw_plain_ms, plain_rw = cuda_ms(
        lambda: engine_torch.align_batch_device(cfg_rw, *args_rw), 1)
    err = (plain_rw["distance"] - out_rw["distance"]).abs().max().item()
    require(err == 0 and torch.equal(plain_rw["finished"], out_rw["finished"]),
            "ring-wide: the plain version differs from K4")
    max_err["wfa_distance_ring"] = max(max_err["wfa_distance_ring"], err)
    reset_launches()
    t1 = time.perf_counter()
    res = align_pairs(rw_p, rw_t, ropts)
    torch.cuda.synchronize()
    rw_s = time.perf_counter() - t1
    require(engine_cuda.LAUNCHES["wfa_distance_ring"] > 0,
            "ring-wide: align_pairs launched no K4")
    require(all(r.finished_on_accelerator for r in res),
            "ring-wide: pairs left unfinished on the card")
    least = min(r.error for r in res)
    require(least > 3077, f"ring-wide: least distance {least} is not past 3077")
    require([r.error for r in res] == out_rw["distance"].tolist(),
            "ring-wide: align_pairs differs from K4 alone")
    oracle, _, _ = native.cpu_align_batch(
        [rw_p[0], rw_p[8]], [rw_t[0], rw_t[8]], pen, np.ones(2, dtype=np.int8),
        False)
    require([int(v) for v in oracle] == [res[0].error, res[8].error],
            "ring-wide: the CPU oracle disagrees on pairs 0 and 8")
    phase("ring-wide", t0,
          f"16 pairs, W=9216: K4 {rw_ms:.3f} ms (1024 threads "
          f"{rw_threads[1024]:.3f}, 512 threads {rw_threads[512]:.3f}; the "
          f"whole ring {WHOLE_RING_MS['ring-wide']} ms), plain "
          f"{rw_plain_ms:.3f} ms, equal; {work_line(work_rw, rw_cells, centre_rw)}; "
          f"align_pairs {rw_s * 1e3:.3f} ms, 16/16 on card, distances "
          f"{least}..{max(r.error for r in res)}, CPU oracle equal on pairs "
          f"0 and 8; [{smi}]")

    # ---- 12. ring-bw: K4's ring-row traffic (4 rows in, 3 out per step) ----
    t0 = time.perf_counter()
    for shape, steps in (((4, 15, 1024), 64), ((100, 15, 6016), 16)):
        start = torch.randint(-1000, 1000, shape, dtype=torch.int32, device=dev)
        ring, plain_ring = start.clone(), start.clone()
        acc = ring_bw.ring_bw(ring, steps)
        want_acc = ring_bw.ring_bw_plain(plain_ring, steps)
        err = (acc.long() - want_acc.long()).abs().max().item()
        require(torch.equal(ring, plain_ring) and err == 0,
                f"ring-bw differs from the plain version at {shape}")
        max_err["ring_bw"] = max(max_err["ring_bw"], err)
    reset_launches()
    probes = [ring_bw.measure(100, 6016, 15, device=dev),
              ring_bw.measure(1056, 16384, 15, device=dev)]
    bw_launches = ring_bw.LAUNCHES["ring_bw"]
    require(bw_launches > 0, "ring-bw launched no kernel")
    # The kernel and the plain version from one seeded random ring at the
    # measured size and step count.
    gen = torch.Generator(device=dev).manual_seed(20261016)
    big = torch.randint(-1000, 1000, (1056, 15, 16384), dtype=torch.int32,
                        device=dev, generator=gen)
    plain_big = big.clone()
    acc = ring_bw.ring_bw(big, 2048)
    bw_plain_ms, want_acc = cuda_ms(lambda: ring_bw.ring_bw_plain(plain_big, 2048), 1)
    err = (acc.long() - want_acc.long()).abs().max().item()
    require(torch.equal(big, plain_big) and err == 0,
            "ring-bw differs from the plain version at (1056, 15, 16384), "
            "2048 steps")
    max_err["ring_bw"] = max(max_err["ring_bw"], err)
    bw_ms = probes[1]["ms"]["2048"]
    ring_b = big.numel() * 4
    # The function's least work: the ring read once and written once, and 7
    # int adds per column and step (4 into the sum, 3 for the +1).
    bw_bound = bound_ms(2 * ring_b + 4 * 1056, 7 * 1056 * 16384 * 2048)
    del big, plain_big
    phase("ring-bw", t0, "equal to the plain version, at (1056, 15, 16384) "
          "over 2048 steps too; " + "; ".join(
        f"B={p['B']} W={p['W']} ({p['ring_bytes'] / 1e6:.1f} MB of ring): "
        f"{p['per_step_us']:.3f} us a step, {p['achieved_GBps']:.1f} GB/s"
        for p in probes) + f"; plain (B=1056, 2048 steps) {bw_plain_ms:.3f} ms; "
        f"[{smi}]")

    # ---- 13. calibrate: the speed-of-light kernels and the wide gather ----
    t0 = time.perf_counter()
    sol = sol_calibrate
    rng = np.random.default_rng(20261016)

    def tiles(G, lo=-(2**31), hi=2**31):
        return torch.from_numpy(rng.integers(lo, hi, (G, 8, 128), dtype=np.int32)).to(dev)

    def err_of(got, want):
        return (got.long() - want.long()).abs().max().item()

    n_checks = 0
    for G in (1, 3):
        for iters in (0, 1, 5, 64):
            x, idx = tiles(G), tiles(G, 0, 128)
            x[0] = -tiles(1, 0, 1000)[0]            # a tile whose max is <= 0
            for name, got, want in (
                ("vpu_ops", sol.vpu_ops(x, iters), sol.vpu_ops_plain(x, iters)),
                ("gather_chain", sol.gather_chain(x, idx, iters),
                 sol.gather_chain_plain(x, idx, iters)),
                ("scalar_sync", sol.scalar_sync(x, iters),
                 sol.scalar_sync_plain(x, iters)),
                ("scalar_sync", sol.scalar_sync(x, iters, threads=512),
                 sol.scalar_sync_plain(x, iters)),
            ):
                err = err_of(got, want)
                require(err == 0, f"{name} differs from its plain version at "
                        f"G={G}, iters={iters}")
                max_err[name] = max(max_err[name], err)
                n_checks += 1
    for R, W in ((8, 2048), (8192, 2048)):
        tab, idx = gather_probe.random_inputs(R, W, dev, seed=R)
        err = err_of(gather_probe.k_wide(tab, idx), gather_probe.k_wide_plain(tab, idx))
        require(err == 0, f"k_wide differs from torch.gather at [{R}, {W}]")
        max_err["k_wide"] = max(max_err["k_wide"], err)
        n_checks += 1

    # The rates, from the difference of the TPU script's two counts.
    reset_launches()
    full = {k: sol.resident_tiles(k, dev) for k in ("vpu_ops", "gather_chain")}
    full512 = sol.resident_tiles("scalar_sync", dev, 512)
    full1024 = sol.resident_tiles("scalar_sync", dev, 1024)
    rates = {
        "vpu": [sol.bench_vpu_ops(dev, g) for g in (1, full["vpu_ops"])],
        "gather": [sol.bench_gather(dev, g) for g in (1, full["gather_chain"])],
        "sync1024": [sol.bench_scalar_sync(dev, g) for g in (1, full1024)],
        "sync512": [sol.bench_scalar_sync(dev, g, threads=512) for g in (1, full512)],
    }
    probes = [gather_probe.measure(8, 2048, device=dev),
              gather_probe.measure(8192, 2048, device=dev)]
    require(all(p["equal"] for p in probes), "k_wide differs in its measuring run")
    cal_launches = {**sol.LAUNCHES, **gather_probe.LAUNCHES}
    require(all(v > 0 for v in cal_launches.values()),
            f"the calibration run launched no kernel: {cal_launches}")
    sass = sol.sass_per_rep()

    # The kernels line's times: kernel and plain version on the same inputs,
    # the card full, at CAL_ITERS iterations (the plain versions pay one
    # launch per op, so not at the TPU counts).
    cal = {}
    for name, G in (("vpu_ops", full["vpu_ops"]), ("gather_chain", full["gather_chain"]),
                    ("scalar_sync", full1024)):
        x, idx = tiles(G), tiles(G, 0, 128)
        kern = {"vpu_ops": lambda: sol.vpu_ops(x, CAL_ITERS),
                "gather_chain": lambda: sol.gather_chain(x, idx, CAL_ITERS),
                "scalar_sync": lambda: sol.scalar_sync(x, CAL_ITERS)}[name]
        plain = {"vpu_ops": lambda: sol.vpu_ops_plain(x, CAL_ITERS),
                 "gather_chain": lambda: sol.gather_chain_plain(x, idx, CAL_ITERS),
                 "scalar_sync": lambda: sol.scalar_sync_plain(x, CAL_ITERS)}[name]
        kern()                                             # warm-up
        ms, got = cuda_ms(kern, 5)
        plain_ms, want = cuda_ms(plain, 1)
        err = err_of(got, want)
        require(err == 0, f"{name} differs from its plain version at G={G}, "
                f"iters={CAL_ITERS}")
        max_err[name] = max(max_err[name], err)
        # Source ops per value and iteration: 8 x 16; the gather's and, xor
        # and shared load x 16; the sync's max and add.
        ops = {"vpu_ops": 8 * 16, "gather_chain": 3 * 16, "scalar_sync": 2}[name]
        nbytes = (3 if name == "gather_chain" else 2) * x.numel() * 4
        cal[name] = (G, ms, plain_ms, bound_ms(nbytes, ops * x.numel() * CAL_ITERS))
    tab, idx = gather_probe.random_inputs(8192, 2048, dev)
    gather_probe.k_wide(tab, idx)                          # warm-up
    kw_ms, got = cuda_ms(lambda: gather_probe.k_wide(tab, idx), 20)
    kw_plain_ms, want = cuda_ms(lambda: gather_probe.k_wide_plain(tab, idx), 20)
    idx64 = idx.long()
    kw_lib_ms, _ = cuda_ms(lambda: torch.gather(tab, 1, idx64), 20)
    require(err_of(got, want) == 0, "k_wide differs from torch.gather at [8192, 2048]")
    kw_bound = bound_ms(tab.numel() * 4 + 2 * idx.numel() * 4, idx.numel())
    del tab, idx, idx64, got, want

    def rate_line(tag, runs, unit):
        return f"{tag}: " + ", ".join(
            f"G={r['tiles']} {r['ns']:.3f} ns/{unit} ({r['ms'][0]:.3f}/"
            f"{r['ms'][1]:.3f} ms at {r['counts'][0]}/{r['counts'][1]})"
            for r in runs)

    # K1's floor on HiFi from its barriers alone: one block barrier a
    # scheduled score (half a 512-thread max-and-branch, which pays two),
    # and every HiFi block resident at once, so the longest pair's count.
    hifi_scores = build_schedule(Penalties(2, 3, 1), 3000, None).score
    longest = int(max((hifi_scores <= d).sum() for d in ref["distance"]))
    floor_us = [longest * r["ns"] / 2e3 for r in rates["sync512"]]
    vfull = rates["vpu"][1]
    phase("calibrate", t0,
          f"{n_checks} checks equal; "
          + rate_line("dependent int32 op", rates["vpu"], "op")
          + f", the card full {vfull['int32_ops_per_s'] / 1e12:.3f} T source "
          f"ops/s ({vfull['int32_ops_per_s'] / INT32_OPS_PER_S:.2f}x "
          f"INT32_OPS_PER_S); SASS {sass['loop_instructions']} instructions "
          f"a loop of 16 reps {sass['opcodes']}; "
          + rate_line("gather step", rates["gather"], "gather") + "; "
          + rate_line("block max + branch, 1024 threads", rates["sync1024"], "sync")
          + "; " + rate_line("512 threads", rates["sync512"], "sync")
          + "; k_wide " + ", ".join(
              f"[{p['BT']}, {p['W']}] {p['ms'] * 1e3:.3f} us (torch.gather "
              f"{p['library_ms'] * 1e3:.3f} us, {p['achieved_GBps']:.1f} GB/s)"
              for p in probes)
          + f"; K1's barrier floor on HiFi: {longest} scheduled scores x "
          f"{floor_us[0] * 1e3 / longest:.3f}-{floor_us[1] * 1e3 / longest:.3f} ns "
          f"= {floor_us[0]:.3f}-{floor_us[1]:.3f} us, {100e-3 * floor_us[0] / k1_ms:.1f}"
          f"-{100e-3 * floor_us[1] / k1_ms:.1f}% of K1's {k1_ms:.3f} ms"
          f"; launches {cal_launches}; [{smi}]")

    # ---- 14. profile: the CLI's --profile trace names K1 ----
    t0 = time.perf_counter()
    trace_dir = ROOT / "build" / "profile"
    proc = subprocess.run(
        [sys.executable, "-m", "wfa_tpu_torch.cli", "-i",
         str(DATA / "wfa.utest.seq"), "-n", "50", "-g", "1,2,1", "-e", "100",
         "--backend", "cuda", "--profile", str(trace_dir)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    require(proc.returncode == 0, f"--profile run failed:\n{proc.stderr[-2000:]}")
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels
          if re.search(r"wfa_kernel<(true|false), false, false>", e["name"])]
    require(len(k1) > 0, f"the --profile trace names no K1 kernel "
            f"({len(kernels)} kernel events)")
    phase("profile", t0, f"trace.json: {len(events)} events, {len(kernels)} "
          f"kernel events, {len(k1)} of K1 ({sum(e['dur'] for e in k1):.3f} us)")

    print(json.dumps({"kernels": [
        {
            "name": "wfa_distance", "route": "cuda",
            "source": "wfa_tpu_torch/ops/csrc/wfa_distance.cu",
            "replaces": "wfa_tpu/ops/engine_pallas.py:804",
            "launches": k1_launches, "max_abs_err": max_err["wfa_distance"],
            "ms": k1_ms, "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None,
        },
        {
            "name": "wfa_cigar", "route": "cuda",
            "source": "wfa_tpu_torch/ops/csrc/wfa_distance.cu",
            "replaces": "wfa_tpu/ops/engine_pallas.py:804",
            "launches": cigar_launches["wfa_cigar"],
            "max_abs_err": max_err["wfa_cigar"],
            "ms": k2_ms, "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None,
        },
        {
            "name": "wfa_traceback", "route": "cuda",
            "source": "wfa_tpu_torch/ops/csrc/wfa_traceback.cu",
            "replaces": "wfa_tpu/ops/traceback_pallas.py:95",
            "launches": cigar_launches["wfa_traceback"],
            "max_abs_err": max_err["wfa_traceback"],
            "ms": k3_ms, "plain_ms": k3_plain_ms,
            "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "library_ms": None,
        },
        {
            "name": "wfa_distance_ring", "route": "cuda",
            "source": "wfa_tpu_torch/ops/csrc/wfa_distance.cu",
            "replaces": "wfa_tpu/ops/engine_pallas.py:804",
            "launches": k4_launches,
            "max_abs_err": max_err["wfa_distance_ring"],
            "ms": k4_ms, "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound[0], "bound_by": k4_bound[1], "library_ms": None,
        },
        {
            "name": "wfa_cigar_ring", "route": "cuda",
            "source": "wfa_tpu_torch/ops/csrc/wfa_distance.cu",
            "replaces": "wfa_tpu/ops/engine_pallas.py:804",
            "launches": k4c_launches["wfa_cigar_ring"],
            "max_abs_err": max_err["wfa_cigar_ring"],
            "ms": k4c_ms, "plain_ms": k4c_plain_ms,
            "bound_ms": k4c_bound[0], "bound_by": k4c_bound[1], "library_ms": None,
        },
        {
            "name": "ring_bw", "route": "cuda",
            "source": "wfa_tpu_torch/ops/csrc/ring_bw.cu",
            "replaces": "tools/dev_dma_bw.py:35",
            "launches": bw_launches, "max_abs_err": max_err["ring_bw"],
            "ms": bw_ms, "plain_ms": bw_plain_ms,
            "bound_ms": bw_bound[0], "bound_by": bw_bound[1], "library_ms": None,
        },
        *({
            "name": name, "route": "cuda",
            "source": "wfa_tpu_torch/ops/csrc/sol_calibrate.cu",
            "replaces": f"benchmarks/sol_calibrate.py:{line}",
            "launches": cal_launches[name], "max_abs_err": max_err[name],
            "ms": cal[name][1], "plain_ms": cal[name][2],
            "bound_ms": cal[name][3][0], "bound_by": cal[name][3][1],
            "library_ms": None,
        } for name, line in (("vpu_ops", 56), ("gather_chain", 84),
                             ("scalar_sync", 115))),
        {
            "name": "k_wide", "route": "cuda",
            "source": "wfa_tpu_torch/ops/csrc/gather_probe.cu",
            "replaces": "tools/dev_gather_probe.py:22",
            "launches": cal_launches["k_wide"], "max_abs_err": max_err["k_wide"],
            "ms": kw_ms, "plain_ms": kw_plain_ms,
            "bound_ms": kw_bound[0], "bound_by": kw_bound[1], "library_ms": kw_lib_ms,
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
