#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, wfa_tpu_torch.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a), nvcc and a C++ compiler; imports no
jax and nothing of wfa_tpu.  It builds the CUDA kernels from the sources
(K1, K2 and K4: wfa_tpu_torch/ops/csrc/wfa_distance.cu; K3:
wfa_traceback.cu; the ring-row probe: ring_bw.cu), fails on a register
spill, holds each kernel against its plain PyTorch version on random pairs
(K1 and K2 also on near-identical 2-5 kbp pairs whose long runs the
warp-cooperative extension serves, with the packed rows in shared and in
global memory and, exact, at 512 and 1024 threads a block; K3 also alone,
at 1, 2 and 4 walks a block, on tables whose
banded re-centres move lo past its window, rows skipped, walks at the
row's ends, B = 1, forged tables, distances past score_cap and lo_pad, a
stream past opw; a K3 stack frame fails the build like a spill), drives
align_pairs(backend='cuda') on the golden score sets in distance and CIGAR
mode, and runs through the kernels alone, their plain versions and
align_pairs, with times: the HiFi banded workload (400 pairs of ~14 kbp,
W=512, band 25, penalties 2,3,1, max_steps 3000) in distance and CIGAR mode
on K1 and K2 + K3, with the slowest pair's 8 copies alone and the rows in
global memory beside it; seq_1000_n1000 (exact, W=640) on K1 and K2 at 512
and 1024 threads; the 100 x 10 kbp golden set at max_error 3000 (exact,
W=6016) in distance and CIGAR mode on K4, at 1024 and 512 threads a block
(K3 alone timed on the HiFi, pair-30, exact-1k and wide10k tables, warm
and with L2 flushed, with its per-walk row loads, misses and cold entries),
with its cells and edge traffic, and K1 against K4 at W=3840; the 16 x 5
kbp ring-wide set (exact, W=9216) on K4; the ring-row probe at two sizes;
the speed-of-light calibration kernels and the wide-gather probe
(sol_calibrate.cu, gather_probe.cu), held against their plain versions and
timed at the TPU script's counts for one tile and for the card full; the
CLI's --profile trace, which must name K1; the data-parallel layer
(wfa_tpu_torch/parallel/mesh.py): K1, K2 + K3 and K4 on HiFi x8 and wide10k
as two blocks on two streams of the card and over data_mesh(), equal to one
launch bit for bit with one launch a block, their traced kernel spans, and
align_pairs with data_parallel over two blocks against data_parallel=False
and the stored references; two processes in a gloo group on localhost, each
running the CLI on its strided half of wfa.utest.seq, whose gathered and
merged scores equal the golden file; probe_order: _probe_distances
launches K1 once at W=128, and align_pairs gives the same results with and
without it; band recall on 128 x 20 kbp reads (tools/torch_nanopore_recall.py),
uniform and burst: K4's certified exact references at W=6144, held against
the CPU oracle, and K1 banded at W = 128, 256, 512 and 1024 (uniform: every
pair finished and optimal at every width; burst: K1 equal to the plain
engine on the card on pairs the band clips); HiFi x8 exact at W=1024 with
the loop stopped at its certificate, every pair certified; and
pack_batch_torch on the card equal to pack_batch.  Every phase prints one line
with its seconds; any failure ends the run with a nonzero exit code.  The
line before the last lists every kernel with its launches on the main
paths, error against its plain version, times and bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import dataclasses
import json
import re
import socket
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
    from wfa_tpu_torch.ops.packing import (
        pack_batch, pack_batch_torch, unpack_words, words_for_length,
    )
    from wfa_tpu_torch.parallel import distributed
    from wfa_tpu_torch.parallel import mesh as parallel_mesh
    from wfa_tpu_torch.schedule import build_schedule, cone_radii
    from wfa_tpu_torch.utils.device_query import describe
    from wfa_tpu_torch.utils.io import read_seq_file
    from wfa_tpu_torch.utils.synth import (
        EDGE_PAIRS, edge_pairs, forged_walks, long_run_pairs, overflow_walks,
        random_pairs, ring_wide_pairs,
    )
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
    # Registers of each wfa_kernel<banded, cigar, ring_global, rows shared>;
    # no spills.
    regs, kernel = {}, None
    log = libs["wfa_distance"].with_suffix(".log").read_text().splitlines()
    for ln in log:
        if m := re.search(r"wfa_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)E", ln):
            kernel = "<" + ", ".join(("false", "true")[int(c)] for c in m.groups()) + ">"
        elif kernel and (m := re.search(r"Used (\d+) registers", ln)):
            regs[kernel] = int(m.group(1))
    spills = [ln for ln in log if "spill" in ln and not re.search(
        r"\b0 bytes spill stores, 0 bytes spill loads", ln)]
    require(not spills, "wfa_distance.cu spills registers: " + "; ".join(spills))
    require(len(regs) == 10, f"expected 10 wfa_kernel instantiations, got {regs}")
    # K3's two instantiations <banded>: no spill, no stack
    # (a walker member that left registers would show as a stack frame).
    k3_regs, kernel = {}, None
    k3_log = libs["wfa_traceback"].with_suffix(".log").read_text().splitlines()
    for ln in k3_log:
        if m := re.search(r"wfa_traceback_kernelILb(\d)E", ln):
            kernel = f"<{('false', 'true')[int(m.group(1))]}>"
        elif kernel and (m := re.search(r"Used (\d+) registers", ln)):
            k3_regs[kernel] = int(m.group(1))
    k3_bad = [ln for ln in k3_log if ("spill" in ln or "stack frame" in ln)
              and not re.search(r"\b0 bytes stack frame, 0 bytes spill stores, "
                                r"0 bytes spill loads", ln)]
    require(not k3_bad, "wfa_traceback.cu spills or uses a stack: " + "; ".join(k3_bad))
    require(len(k3_regs) == 2, f"expected 2 wfa_traceback_kernel instantiations, got {k3_regs}")
    # The host library: packing, readers, the CPU fallback, CIGAR decoding.
    require(_build.ensure_native(), "the native host library did not build")
    threads = native.get_lib().wfa_cpu_num_threads()
    phase("build", t0, f"nvcc sm_90a {t_nvcc:.2f}s: {ptxas}; wfa_kernel "
          f"registers {regs}, no spills; wfa_traceback_kernel<banded> "
          f"registers {k3_regs}, no spill or stack; native host "
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

    def fused_walk(tb, words, lo, dist, fin, tk):
        """K3's plain version on the card: the fused rows."""
        walk = traceback_torch.traceback_batch_device(tb, words, lo, dist, fin, tk)
        return traceback_torch.fuse(dist, fin, walk["n_ops"], walk["ops"])

    def k3_stress_cases(rng):
        """(name, tb, words, lo_trace, dist, fin, target_k) on the card."""
        def tables(pen, width, band, pairs):
            ccfg, tb = cigar_configs(pen, 200, width, band)
            args = tensors(pairs)
            t = engine_cuda.cigar_tables_cuda(ccfg, tb.score_cap, *args)
            return (tb, t["choice_words"], t.get("lo_trace"), t["distance"],
                    t["finished"], args[3] - args[2])

        p231 = Penalties(2, 3, 1)
        narrow = tables(p231, 96, 5, EDGE_PAIRS + random_pairs(
            rng, 200, 60, 400, 0.3, n_rate=0.0))
        yield ("banded-narrow", *narrow)
        i = int(torch.nonzero(narrow[4] & (narrow[3] > 0))[0])   # a lane that walks
        yield ("banded-b1", narrow[0], narrow[1][:, i:i + 1].contiguous(),
               *(t[i:i + 1].contiguous() for t in narrow[2:]))
        yield ("banded-x4o1e2", *tables(Penalties(4, 1, 2), 96, 10, random_pairs(
            rng, 64, 100, 400, 0.3, n_rate=0.0)))
        yield ("banded-x70", *tables(Penalties(70, 6, 2), 64, 25, random_pairs(
            rng, 64, 30, 200, 0.3, n_rate=0.0)))
        yield ("exact-edges", *tables(p231, 128, -1, edge_pairs(rng, 128, 37)))
        yield ("exact", *tables(Penalties(1, 0, 1), 256, -1, EDGE_PAIRS + random_pairs(
            rng, 96, 10, 600, 0.3)))
        exact_tb = traceback_torch.TracebackConfig(p231, 64, 120, banded=False)
        band_tb = traceback_torch.TracebackConfig(p231, 64, 120, banded=True,
                                                  lo_pad=engine_torch.lo_pad(120))
        short_tb = traceback_torch.TracebackConfig(p231, 64, 120, banded=True,
                                                   lo_pad=64)
        yield ("forged-exact", exact_tb, *forged_walks(rng, exact_tb, 37, device=dev))
        yield ("forged-banded", band_tb, *forged_walks(rng, band_tb, 37, device=dev))
        yield ("forged-lo-pad", short_tb, *forged_walks(rng, short_tb, 37, device=dev))
        # Rows past the table for every lane: the last lane's distance would
        # read lo_trace past the allocation if it were read before the row
        # check.
        past = np.linspace(8 * band_tb.num_chunks, band_tb.lo_pad + 10**6, 37)
        yield ("past-score-cap", band_tb, *forged_walks(
            rng, band_tb, 37, dist=past.astype(np.int64), device=dev))
        # A stream past opw: 2000 ops to the origin, 2060 of 2048, off the origin.
        yield ("overflow", *overflow_walks(dev))

    flush = torch.empty(2**25, dtype=torch.int32, device=dev)   # 128 MB > L2

    def launch_ms(fn, reps, cold=False):
        """One launch at a time, each queued behind a spin kernel so that
        the host's enqueue is not timed (K3 runs for tens of us, about as
        long as a launch from Python): the mean ms; ``cold`` overwrites
        128 MB first, so that the launch finds none of its inputs in L2."""
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

    def k3_time(tb, t, tk, reps=5):
        """K3 alone on K2's tables ``t``: (ms warm, its rows in L2 from the
        launch before; ms cold; fused rows; the per-walk counters [B, 4]:
        rows entered, window loads, misses, cold entries)."""
        def run(**kw):
            return engine_cuda.traceback_cuda(
                tb, t["choice_words"], t.get("lo_trace"), t["distance"],
                t["finished"], tk, **kw)
        out = run()
        torch.cuda.synchronize()
        warm = launch_ms(run, reps)
        cold = launch_ms(run, reps, cold=True)
        st = torch.zeros((tk.shape[0], 4), dtype=torch.int32, device=dev)
        run(_stats=st)
        return warm, cold, out, st

    def k3_bound_of(fused, banded):
        """K3's bound_ms on this run's walks: each step reads one choice word
        (and, banded, one lo_trace entry) and does OPS_PER_WALK_STEP ops; the
        inputs of each alignment (9 bytes) and the fused rows."""
        steps = int(fused[:, 2].clamp(min=0).long().sum())
        return bound_ms(steps * (8 if banded else 4) + 9 * fused.shape[0]
                        + fused.numel() * 4, steps * OPS_PER_WALK_STEP)

    def k3_line(ms, cold, bound, st, fused):
        walked = fused[:, 2] > 0
        per = st[walked].double().mean(0).tolist()
        return (f"K3 {ms:.4f} ms one launch at a time, {cold:.4f} cold (bound "
                f"{bound[0]:.5f} ms, "
                f"{bound[1]}; longest "
                f"walk {int(fused[:, 2].max())} steps; per walk {per[0]:.1f} rows, "
                f"{per[1]:.1f} window loads, {per[2]:.2f} misses, {per[3]:.2f} "
                "cold entries)")

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
        """A kernel at 1024 and 512 threads a block, in turns (1024, 512,
        512, 1024): the mean ms of each."""
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
    # Long runs (near-identical 2-5 kbp pairs: runs past 512 bases, to
    # either end, homopolymers) with the rows in shared and in global memory
    # and, exact, at 512 and 1024 threads a block.
    long_pairs = EDGE_PAIRS + long_run_pairs(rng, 42)
    long_args = tensors(long_pairs, invalid_every=17)
    # (band, penalties, W); the exact windows are wide enough for 1024 threads.
    long_cases = [(-1, Penalties(2, 3, 1), 1024), (25, Penalties(2, 3, 1), 512),
                  (-1, Penalties(4, 1, 2), 2048), (10, Penalties(1, 0, 1), 256)]
    n_long = 0
    for band, pen, w in long_cases:
        cfg = engine_torch.EngineConfig(pen, 200, w, band)
        want = engine_torch.align_batch_device(cfg, *long_args)
        for rows in ("shared", "global"):
            for nt in (512, 1024) if band < 0 else (0,):
                got = engine_cuda.align_batch_cuda(cfg, *long_args, _rows=rows,
                                                   _threads=nt)
                err = (got["distance"] - want["distance"]).abs().max().item()
                require(err == 0 and torch.equal(got["finished"], want["finished"]),
                        f"long runs: K1 differs: band={band} pen={pen} W={w} "
                        f"rows={rows} threads={nt}")
                max_err["wfa_distance"] = max(max_err["wfa_distance"], err)
                n_long += 1
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
          f"long runs: {len(long_pairs)} pairs, {n_long} launches over "
          f"{len(long_cases)} configs x both row placements (x 512 and "
          "1024 threads exact), arrays equal; (70,6,2) at W=512 refused")

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
    # Where K1's time goes: the 8 copies of the slowest pair alone (about
    # the 400's time if each block's chain of dependent steps sets it, far
    # less if the SMs' issue does), and the rows pinned in global memory.
    slow = ref["distance"].index(max(ref["distance"]))
    pair_args = tensors([(hifi.patterns[slow], hifi.texts[slow])] * HIFI_REPS,
                        nw=hifi_args[0].shape[1])
    engine_cuda.align_batch_cuda(cfg, *pair_args)      # warm-up
    k1_pair_ms, pair_out = cuda_ms(
        lambda: engine_cuda.align_batch_cuda(cfg, *pair_args), 5)
    require(pair_out["distance"].tolist() == [ref["distance"][slow]] * HIFI_REPS,
            f"HiFi pair {slow}: K1 distances differ from the stored reference")
    k1_global_ms, gout = cuda_ms(
        lambda: engine_cuda.align_batch_cuda(cfg, *hifi_args, _rows="global"), 5)
    require(torch.equal(gout["distance"], out["distance"])
            and torch.equal(gout["finished"], out["finished"]),
            "HiFi: K1 with the rows in global memory differs")
    k1_occ = engine_cuda.blocks_per_sm(cfg, hifi_args[0].shape[1], dev)

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
          f"{n} pairs: K1 {k1_ms:.3f} ms ({n / k1_ms * 1e3:.1f} aln/s; pair "
          f"{slow} x{HIFI_REPS} alone {k1_pair_ms:.3f} ms; the rows in global "
          f"memory {k1_global_ms:.3f} ms; {k1_occ[0]} blocks of {k1_occ[1]} "
          "threads an SM), "
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
    n_long = 0
    for band, pen, w in long_cases:
        ccfg, tb = cigar_configs(pen, 200, w, band)
        plain = engine_torch.cigar_tables(ccfg, tb.score_cap, *long_args)
        want = fused_plain(tb, plain, long_args)
        for rows in ("shared", "global"):
            for nt in (512, 1024) if band < 0 else (0,):
                pin = dict(_rows=rows, _threads=nt)
                tables = engine_cuda.cigar_tables_cuda(ccfg, tb.score_cap, *long_args,
                                                       **pin)
                fused = engine_cuda.align_cigar_cuda(ccfg, tb, *long_args, **pin)
                what = f"band={band} pen={pen} W={w} rows={rows} threads={nt}"
                require(torch.equal(tables["finished"], plain["finished"])
                        and torch.equal(tables["distance"], plain["distance"]),
                        f"long runs: K2 distances differ: {what}")
                require(engine_torch.tables_equal(ccfg, tb.score_cap, plain, tables,
                                                  cone=True),
                        f"long runs: K2 choice table differs: {what}")
                require(torch.equal(fused, want), f"long runs: K2 + K3 rows differ: {what}")
                n_long += 1
        n_walks += int((want[:, 2] > 0).sum())
    # K3 alone against the plain walk on the same tables, at 1, 2 and 4
    # walks a block: banded tables whose
    # re-centres move lo past the window, rows skipped by (70,6,2), walks
    # that start at the row's ends, B = 1, forged tables (random words and
    # lo, lo_pad below the rows, distances past score_cap and past lo_pad for
    # every lane, the last one too) and a stream that overflows opw.
    k3_stats = {}
    n_k3 = 0
    for what, tb, words, lo, dist, fin, tk in k3_stress_cases(rng):
        want = fused_walk(tb, words, lo, dist, fin, tk)
        for warps in (1, 2, 4):
            st = torch.zeros((dist.shape[0], 4), dtype=torch.int32, device=dev)
            got = engine_cuda.traceback_cuda(tb, words, lo, dist, fin, tk,
                                             _warps=warps, _stats=st)
            require(torch.equal(got, want),
                    f"K3 differs from the plain walk: {what}, {warps} warps")
            max_err["wfa_traceback"] = max(max_err["wfa_traceback"],
                                           (got - want).abs().max().item())
            require(bool((st[:, 1] >= st[:, 0] + st[:, 2]).all())
                    and bool((st[:, 3] <= st[:, 0]).all()),
                    f"K3 counters inconsistent: {what}")
            k3_stats[what] = tuple(st.long().sum(0).tolist())
            n_k3 += 1
        if what == "past-score-cap":
            require(bool((want[:, 2] == torch.where(fin, -1, 0)).all()),
                    "distances past the table's rows not corrupt")
        if what == "overflow":
            require(want[:, 2].tolist() == [2000, -1, -1], "overflow case")
    require(k3_stats["banded-narrow"][2] > 0,
            "the narrow banded tables gave K3 no window miss")
    phase("k2k3-vs-plain", t0, f"{n_cases} cases, {n_lanes} lanes, {n_walks} "
          "walks: distances, flags, n_ops and op streams equal; tables equal "
          f"on the readable region; long runs: {n_long} launches of K2 + K3 "
          "over both row placements (x 512 and 1024 threads exact), equal; "
          f"K3 stress: {n_k3} launches equal to the plain walk (rows, loads, "
          "misses, cold entries: " + "; ".join(
              f"{w} {v}" for w, v in k3_stats.items()) + ")")

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
    k3_launch_ms, k3_cold_ms, k3_out, k3_st = k3_time(tb, tables, tk)
    k2_pair_ms, pair_tab = cuda_ms(
        lambda: engine_cuda.cigar_tables_cuda(ccfg, tb.score_cap, *pair_args), 5)
    require(pair_tab["distance"].tolist() == [ref["distance"][slow]] * HIFI_REPS,
            f"HiFi pair {slow}: K2 distances differ from the stored reference")
    k3_pair_ms, k3_pair_cold, pair_out, _ = k3_time(tb, pair_tab,
                                                    pair_args[3] - pair_args[2])
    require(torch.equal(pair_out, k3_out[slow::len(ref["distance"])]),
            f"HiFi pair {slow}: K3 alone differs from K3 on the 400")
    k2_global_ms, gtab = cuda_ms(lambda: engine_cuda.cigar_tables_cuda(
        ccfg, tb.score_cap, *hifi_args, _rows="global"), 5)
    require(torch.equal(gtab["distance"], tables["distance"]),
            "HiFi: K2 with the rows in global memory differs")
    k2_occ = engine_cuda.blocks_per_sm(ccfg, hifi_args[0].shape[1], dev, cigar=True)
    del pair_tab
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
    require(engine_torch.tables_equal(ccfg, tb.score_cap, plain, tables)
            and engine_torch.tables_equal(ccfg, tb.score_cap, plain, gtab),
            "HiFi CIGAR: K2 table differs on the readable region")
    del gtab

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
    k3_bound = k3_bound_of(want, True)
    require(torch.equal(k3_out, want), "HiFi CIGAR: K3 alone differs from plain")
    phase("hifi-cigar", t0,
          f"{n} pairs: K2+K3 {k2k3_ms:.3f} ms ({n / k2k3_ms * 1e3:.1f} aln/s; "
          f"K2 {k2_ms:.3f} (pair {slow} x{HIFI_REPS} alone {k2_pair_ms:.3f}; the "
          f"rows in global memory {k2_global_ms:.3f}; {k2_occ[0]} blocks of "
          f"{k2_occ[1]} threads an SM), "
          f"K3 {k3_ms:.4f} ms 5 back to back (the kernels line's), "
          f"{k3_line(k3_launch_ms, k3_cold_ms, k3_bound, k3_st, want)}, pair {slow} "
          f"x{HIFI_REPS} alone K3 {k3_pair_ms:.4f} ms, {k3_pair_cold:.4f} cold), "
          "plain K2+K3 "
          f"{k2_plain_ms + k3_plain_ms:.3f} ms (K2 {k2_plain_ms:.3f}, K3 "
          f"{k3_plain_ms:.3f}), align_pairs {ce2e_s * 1e3:.3f} ms "
          f"({n / ce2e_s:.1f} aln/s), launches {cigar_launches}; all on card, "
          f"no corrupt walk, CIGARs equal the reference x{HIFI_REPS}; "
          f"{cells} cells, {rows} choice rows, {walk_steps} walk steps; [{smi}]")

    # ---- 9. exact-1k: seq_1000_n1000 (exact, W=640) on K1 and K2 ----
    t0 = time.perf_counter()
    name, k1k, pen, me, gold1k = golden_runs[3]
    require(name == "seq_1000_n1000", f"expected seq_1000_n1000, got {name}")
    dopts = AlignmentOptions(penalties=pen, max_error=me, backend="cuda")
    cfg1k, full1k, _, _, nw1k = route_config(k1k.patterns, k1k.texts, dopts)
    ccfg1k, _, _, cap1k, _ = route_config(
        k1k.patterns, k1k.texts, dataclasses.replace(dopts, compute_cigar=True))
    require(not cfg1k.ring_global and cfg1k.wf_width == 640 and full1k,
            f"seq_1000_n1000: expected K1 at W=640, got {cfg1k}")
    args1k = tensors(list(zip(k1k.patterns, k1k.texts)), nw=nw1k)
    rows1k = engine_cuda.rows_fit(pen.active_working_set, 640, nw1k, True, smem)
    occ1k = {nt: engine_cuda.blocks_per_sm(cfg1k, nw1k, dev, _threads=nt)[0]
             for nt in (512, 1024)}
    k1_1k = threads_ms(
        lambda n: engine_cuda.align_batch_cuda(cfg1k, *args1k, _threads=n))
    k2_1k = threads_ms(
        lambda n: engine_cuda.cigar_tables_cuda(ccfg1k, cap1k, *args1k, _threads=n))
    for nt in (512, 1024):
        got = engine_cuda.align_batch_cuda(cfg1k, *args1k, _threads=nt)
        tab = engine_cuda.cigar_tables_cuda(ccfg1k, cap1k, *args1k, _threads=nt)
        require(bool(got["finished"].all()) and got["distance"].tolist() == gold1k
                and torch.equal(tab["distance"], got["distance"])
                and bool(tab["finished"].all()),
                f"seq_1000_n1000 at {nt} threads: K1/K2 distances differ from "
                "the goldens")
    tab = engine_cuda.cigar_tables_cuda(ccfg1k, cap1k, *args1k)
    tb1k = traceback_torch.TracebackConfig(pen, 640, cap1k, banded=False)
    tk1k = args1k[3] - args1k[2]
    k3_1k_ms, k3_1k_cold, k3_1k, k3_1k_st = k3_time(tb1k, tab, tk1k)
    want1k = fused_walk(tb1k, tab["choice_words"], None, tab["distance"],
                        tab["finished"], tk1k)
    require(torch.equal(k3_1k, want1k) and bool((k3_1k[:, 2] > 0).all()),
            "seq_1000_n1000: K3 differs from the plain walk or left a walk corrupt")
    max_err["wfa_traceback"] = max(max_err["wfa_traceback"],
                                   (k3_1k - want1k).abs().max().item())
    k3_1k_line = k3_line(k3_1k_ms, k3_1k_cold, k3_bound_of(want1k, False),
                         k3_1k_st, want1k)
    del tab
    phase("exact-1k", t0,
          f"{len(gold1k)} pairs, W=640, rows {'shared' if rows1k else 'global'}: "
          f"K1 {k1_1k[512]:.3f} ms at 512 threads ({occ1k[512]} blocks an SM), "
          f"{k1_1k[1024]:.3f} ms at 1024 (640 at W=640; {occ1k[1024]} blocks an "
          f"SM), default {engine_cuda.blocks_per_sm(cfg1k, nw1k, dev)[1]} threads; "
          f"K2 {k2_1k[512]:.3f} ms at 512, {k2_1k[1024]:.3f} ms at 1024; "
          f"distances equal the goldens; {k3_1k_line}, equal to the plain walk; "
          f"[{smi}]")

    # ---- 10. K4 (the ring's edges in global memory) against the plain versions ----
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

    # ---- 11. wide10k: seq_10K_n100 at max_error 3000, exact, on K4 ----
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
    # Warm-up: the first launch of an instantiation also loads it.
    engine_cuda.align_batch_cuda(cfg_cut, *args10)
    engine_cuda.align_batch_cuda(cfg_cut4, *args10)
    k1_cut_ms, k1_cut = cuda_ms(lambda: engine_cuda.align_batch_cuda(cfg_cut, *args10), 3)
    k1_cut_threads = threads_ms(
        lambda n: engine_cuda.align_batch_cuda(cfg_cut, *args10, _threads=n))
    rows_cut = engine_cuda.rows_fit(pen.active_working_set, cut, nw10, False, smem)
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
    tb10 = traceback_torch.TracebackConfig(pen, 6016, cap10, banded=False)
    tk10 = args10[3] - args10[2]
    k3_10_ms, k3_10_cold, k3_10, k3_10_st = k3_time(tb10, tables10, tk10, 3)
    want10 = fused_walk(tb10, tables10["choice_words"], None, tables10["distance"],
                        tables10["finished"], tk10)
    require(torch.equal(k3_10, want10) and bool((k3_10[:, 2] > 0).all()),
            "seq_10K_n100: K3 differs from the plain walk or left a walk corrupt")
    max_err["wfa_traceback"] = max(max_err["wfa_traceback"],
                                   (k3_10 - want10).abs().max().item())
    k3_10_line = k3_line(k3_10_ms, k3_10_cold, k3_bound_of(want10, False),
                         k3_10_st, want10)
    del tables10

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
          f"K1 {k1_cut_ms:.3f} ms (512 threads {k1_cut_threads[512]:.3f}, 1024 "
          f"threads {k1_cut_threads[1024]:.3f}; rows "
          f"{'shared' if rows_cut else 'global'}), K4 {k4_cut_ms:.3f} ms, equal; "
          f"align_pairs {w10_s * 1e3:.3f} ms "
          f"({n10 / w10_s:.1f} aln/s), all on card, distances equal the "
          f"goldens; CIGAR: K4 tables {k4c_ms:.3f} ms (1024 threads "
          f"{k4c_threads[1024]:.3f}, 512 threads {k4c_threads[512]:.3f}; the "
          f"whole ring {WHOLE_RING_MS['wide10k-cigar']} ms), plain "
          f"{k4c_plain_ms:.3f} ms; {work_line(cwork10, k4c_cells, ccentre10)}; "
          f"{k3_10_line}, equal to the plain walk; "
          f"align_pairs {c10_s * 1e3:.3f} ms ({n10 / c10_s:.1f} aln/s), all "
          "on card, every CIGAR valid and rescoring to its golden, equal to "
          f"the plain route's on 16 pairs ({route_plain_s:.2f}s); "
          f"launches {k4c_launches}; [{smi}]")

    # ---- 12. ring-wide: 16 x 5 kbp at 50% substitution, exact, on K4 ----
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

    # ---- 13. ring-bw: K4's ring-row traffic (4 rows in, 3 out per step) ----
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

    # ---- 14. calibrate: the speed-of-light kernels and the wide gather ----
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

    # ---- 15. profile: the CLI's --profile trace names K1 ----
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
          if re.search(r"wfa_kernel<(true|false), false, false, (true|false)>",
                       e["name"])]
    require(len(k1) > 0, f"the --profile trace names no K1 kernel "
            f"({len(kernels)} kernel events)")
    phase("profile", t0, f"trace.json: {len(events)} events, {len(kernels)} "
          f"kernel events, {len(k1)} of K1 ({sum(e['dur'] for e in k1):.3f} us)")

    # ---- 16. data-parallel: parallel/mesh.py, blocks on the card's streams ----
    t0 = time.perf_counter()

    def kernel_trace(fn):
        """fn's K1-K4 launches in a torch.profiler trace: (us from the first
        one's start to the last one's end, us summed, launches)."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = ROOT / "build" / "profile" / "data_parallel.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        ks = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "kernel"
              and re.search(r"wfa_(kernel|traceback)", e["name"])]
        require(ks, "data-parallel: the trace names no K1-K4 kernel")
        span = max(e["ts"] + e["dur"] for e in ks) - min(e["ts"] for e in ks)
        return span, sum(e["dur"] for e in ks), len(ks)

    pen = Penalties(2, 3, 1)
    two = [dev, dev]
    meshes = [("[cuda:0, cuda:0]", two), ("data_mesh()", parallel_mesh.data_mesh())]
    hcfg = engine_torch.EngineConfig(pen, 3000, 512, 25)
    hccfg, htb = cigar_configs(pen, 3000, 512, 25)
    dp_lines = []
    for name, dcfg, dccfg, dtb, dargs in (
        ("HiFi x8", hcfg, hccfg, htb, hifi_args),
        ("wide10k", cfg10, ccfg10, tb10, args10),
    ):
        k1 = "wfa_distance_ring" if dcfg.ring_global else "wfa_distance"
        k2 = "wfa_cigar_ring" if dccfg.ring_global else "wfa_cigar"
        one_d = engine_cuda.align_batch_cuda(dcfg, *dargs)
        one_c = engine_cuda.align_cigar_cuda(dccfg, dtb, *dargs).cpu()
        torch.cuda.synchronize()
        for mname, m in meshes:
            blocks = min(len(m), dargs[0].shape[0])
            reset_launches()
            split_d = parallel_mesh.align_batch_pallas_sharded(dcfg, m, *dargs)
            require(engine_cuda.LAUNCHES[k1] == blocks,
                    f"data-parallel {name} {mname}: {engine_cuda.LAUNCHES[k1]} "
                    f"launches of {k1}, expected {blocks}")
            require(torch.equal(split_d["distance"], one_d["distance"].cpu())
                    and torch.equal(split_d["finished"], one_d["finished"].cpu()),
                    f"data-parallel {name} {mname}: distances differ from one launch")
            reset_launches()
            split_c = parallel_mesh.align_cigar_fused_sharded(dccfg, dtb, m, *dargs)
            require(engine_cuda.LAUNCHES[k2] == blocks
                    and engine_cuda.LAUNCHES["wfa_traceback"] == blocks,
                    f"data-parallel {name} {mname}: launches "
                    f"{dict(engine_cuda.LAUNCHES)}, expected {blocks} of {k2} and K3")
            require(torch.equal(split_c, one_c),
                    f"data-parallel {name} {mname}: CIGAR rows differ from one launch")
        # Kernel time of the split against the one launch (a finding, not a
        # target), from the card's own trace: the split's first call, and a
        # call once every stream of PyTorch's pool (32 a device) has run a
        # block, so that no block allocates device memory between launches
        # (an allocation there keeps two streams' kernels from overlapping).
        spans = []
        for mode, one_fn, two_fn in (
            ("distance", lambda: engine_cuda.align_batch_cuda(dcfg, *dargs),
             lambda: parallel_mesh.align_batch_pallas_sharded(dcfg, two, *dargs)),
            ("CIGAR K2+K3", lambda: engine_cuda.align_cigar_cuda(dccfg, dtb, *dargs),
             lambda: parallel_mesh.align_cigar_fused_sharded(dccfg, dtb, two, *dargs)),
        ):
            one_t = kernel_trace(one_fn)
            first = kernel_trace(two_fn)
            for _ in range(34):
                two_fn()
            warm = kernel_trace(two_fn)
            spans.append(
                f"{mode} one launch {one_t[0] / 1e3:.3f} ms, two blocks "
                f"{first[0] / 1e3:.3f} ms first call ({first[1] / 1e3:.3f} summed), "
                f"{warm[0] / 1e3:.3f} ms warm ({warm[1] / 1e3:.3f} summed, "
                f"{warm[2]} launches)")
        host = {}
        for blocks_n in (1, 2, 2, 1):
            t1 = time.perf_counter()
            parallel_mesh.align_batch_pallas_sharded(dcfg, [dev] * blocks_n, *dargs)
            host.setdefault(blocks_n, []).append((time.perf_counter() - t1) * 1e3)
        dp_lines.append(
            f"{name}: " + "; ".join(spans) + "; the sharded distance call on "
            f"the host, 1 block {host[1][0]:.3f}, {host[1][1]:.3f} ms, 2 blocks "
            f"{host[2][0]:.3f}, {host[2][1]:.3f} ms")

    # align_pairs with data_mesh() giving the card twice, against
    # data_parallel=False, in turns.
    real_data_mesh = parallel_mesh.data_mesh
    dp_res = {}
    for mode, want_cigar in (("distance", False), ("cigar", True)):
        dopts_dp = AlignmentOptions(penalties=pen, max_error=3000, band=25,
                                    band_width=512, compute_cigar=want_cigar,
                                    backend="cuda")
        key = "wfa_cigar" if want_cigar else "wfa_distance"
        walls = {False: [], True: []}
        res_dp = {}
        for split_on in (False, True, True, False):
            parallel_mesh.data_mesh = lambda devices=None: two
            try:
                reset_launches()
                t1 = time.perf_counter()
                res_dp[split_on] = align_pairs(pats, txts, dataclasses.replace(
                    dopts_dp, data_parallel=split_on))
                torch.cuda.synchronize()
                walls[split_on].append((time.perf_counter() - t1) * 1e3)
                launches_dp = dict(engine_cuda.LAUNCHES)
            finally:
                parallel_mesh.data_mesh = real_data_mesh
            blocks = 2 if split_on else 1
            require(launches_dp[key] == blocks and launches_dp["wfa_traceback"]
                    == (blocks if want_cigar else 0),
                    f"data-parallel align_pairs ({mode}, data_parallel="
                    f"{split_on}): launches {launches_dp}, expected {blocks}")
        require(res_dp[True] == res_dp[False], f"data-parallel align_pairs "
                f"({mode}) differs from data_parallel=False")
        want_ref = cref if want_cigar else ref
        require([r.error for r in res_dp[True]] == want_ref["distance"] * HIFI_REPS
                and (not want_cigar
                     or [r.cigar for r in res_dp[True]] == cref["cigar"] * HIFI_REPS),
                f"data-parallel align_pairs ({mode}) differs from the stored reference")
        dp_res[mode] = walls
    phase("data-parallel", t0,
          f"sharded K1, K2+K3 and K4 over {', '.join(m for m, _ in meshes)} "
          f"({len(meshes[1][1])} card(s) visible) equal one launch bit for bit, "
          "one launch a block; " + "; ".join(dp_lines) + "; align_pairs over "
          "two blocks equal to data_parallel=False and the stored references, "
          "ms in turns (False, True, True, False): " + ", ".join(
              f"{k} data_parallel=False {w[False][0]:.3f}, {w[False][1]:.3f}, "
              f"True {w[True][0]:.3f}, {w[True][1]:.3f}"
              for k, w in dp_res.items()) + f"; [{smi}]")

    # ---- 17. multihost: two processes, a gloo group, the CLI on the card ----
    t0 = time.perf_counter()
    mh_dir = ROOT / "build" / "multihost"
    mh_dir.mkdir(parents=True, exist_ok=True)
    mh_out = mh_dir / "scores.out"
    for stale in mh_dir.glob("scores.out*"):
        stale.unlink()
    worker = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import numpy as np\n"
        "import torch\n"
        "from wfa_tpu_torch import cli\n"
        "from wfa_tpu_torch.ops import engine_cuda\n"
        "from wfa_tpu_torch.parallel import distributed\n"
        "pid, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]\n"
        "distributed.initialize(f'localhost:{port}', 2, pid)\n"
        "t = time.perf_counter()\n"
        "assert cli.main(['-i', 'tests/data/wfa.utest.seq', '-g', '1,2,1', '-e',\n"
        "                 '10000', '--backend', 'cuda', '-o', out]) == 0\n"
        "assert engine_cuda.LAUNCHES['wfa_distance'] > 0, engine_cuda.LAUNCHES\n"
        "with open(f'{out}.{pid}') as f:\n"
        "    local = np.array([int(ln.split()[0]) for ln in f if ln.strip()],\n"
        "                     dtype=np.int32)\n"
        "g = distributed.allgather_scores(local, total=305)\n"
        "if pid == 0:\n"
        "    merged = distributed.merge_sharded_scores(list(g), 305)\n"
        "    np.savetxt(f'{out}.gathered', merged, fmt='%d')\n"
        "torch.distributed.destroy_process_group()\n"
        "print(f'OK {pid}: {len(local)} pairs in {time.perf_counter() - t:.2f}s, '\n"
        "      f'launches {dict(engine_cuda.LAUNCHES)}')\n"
    )
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [
        subprocess.Popen([sys.executable, "-c", worker, str(pid), str(port),
                          str(mh_out)], cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)
    ]
    try:
        mh_logs = [proc.communicate(timeout=300)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    require(all(proc.returncode == 0 for proc in procs),
            "multihost: a process failed:\n" + "\n".join(
                log[-3000:] for log in mh_logs))
    gold_p0 = [int(ln.split()[0]) for ln in
               (DATA / "results" / "test.score.affine.p0.alg").read_text().splitlines()
               if ln.strip()]
    merged = np.loadtxt(f"{mh_out}.gathered", dtype=np.int64).tolist()
    require(merged == gold_p0, "multihost: the gathered scores differ from "
            "test.score.affine.p0.alg")
    files = [np.array([int(ln.split()[0]) for ln in
                       Path(f"{mh_out}.{pid}").read_text().splitlines() if ln.strip()])
             for pid in (0, 1)]
    require(distributed.merge_sharded_scores(files, len(gold_p0)).tolist() == gold_p0,
            "multihost: the two output files merged differ from test.score.affine.p0.alg")
    oks = [ln for log in mh_logs for ln in log.splitlines() if ln.startswith("OK ")]
    phase("multihost", t0,
          f"2 processes on cuda:0, gloo on localhost:{port}; {'; '.join(oks)}; "
          f"the allgather ({len(merged)} scores) and the two files "
          f"({len(files[0])} + {len(files[1])} lines) merged equal "
          f"test.score.affine.p0.alg; [{smi}]")

    # ---- 18. probe-order: K1 at W=128 measures the tiling hints ----
    t0 = time.perf_counter()
    popts = AlignmentOptions(penalties=pen, max_error=3000, band=25,
                             band_width=512, backend="cuda")
    align_pairs(pats[:8], txts[:8], dataclasses.replace(popts, probe_order=True))
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    hints = aligner._probe_distances(pats, txts, list(range(n)), pen, 3000, 25, dev)
    probe_s = time.perf_counter() - t1
    require(engine_cuda.LAUNCHES["wfa_distance"] == 1,
            f"probe-order: _probe_distances launched {dict(engine_cuda.LAUNCHES)}")
    pcfg = engine_torch.EngineConfig(pen, 3000, 128, 25)
    probe_ms, pout = cuda_ms(lambda: engine_cuda.align_batch_cuda(pcfg, *hifi_args), 5)
    want_hints = np.where(pout["finished"].cpu().numpy(),
                          pout["distance"].cpu().numpy(), 1 << 30)
    require(hints.tolist() == want_hints.astype(np.float64).tolist(),
            "probe-order: the hints differ from K1 at W=128")
    walls = {False: [], True: []}
    probe_res = {}
    for order in (False, True, True, False):
        reset_launches()
        t1 = time.perf_counter()
        probe_res[order] = align_pairs(pats, txts, dataclasses.replace(
            popts, probe_order=order))
        torch.cuda.synchronize()
        walls[order].append((time.perf_counter() - t1) * 1e3)
        require(engine_cuda.LAUNCHES["wfa_distance"] == (2 if order else 1),
                f"probe-order={order}: launches {dict(engine_cuda.LAUNCHES)}")
    require(probe_res[True] == probe_res[False],
            "probe-order: probe_order=True changes the results")
    require([r.error for r in probe_res[True]] == ref["distance"] * HIFI_REPS,
            "probe-order: distances differ from the stored reference")
    phase("probe-order", t0,
          f"{n} pairs: the probe (K1, W=128, band 25) {probe_ms:.3f} ms on the "
          f"card, {probe_s * 1e3:.3f} ms for _probe_distances, "
          f"{int((want_hints < (1 << 30)).sum())}/{n} finished in the band; "
          f"align_pairs probe_order=False {', '.join(f'{v:.3f}' for v in walls[False])} ms, "
          f"True {', '.join(f'{v:.3f}' for v in walls[True])} ms, results equal; [{smi}]")

    # ---- 19. nanopore: 128 x 20 kbp at 6% error, K4 references, K1 banded ----
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_nanopore_recall as recall

    def best_ms(fn, reps=3):
        """The least of ``reps`` launches' CUDA-event times, after a warm-up."""
        fn()
        return min(cuda_ms(fn, 1)[0] for _ in range(reps))

    def recall_lines(res):
        return "; ".join(recall.row_line(row, len(res["exact"])) for row in res["rows"])

    reset_launches()
    nano = recall.card_recall(False, dev, n_check=16)
    torch.cuda.synchronize()
    nano_launches = dict(engine_cuda.LAUNCHES)
    require(nano_launches["wfa_distance_ring"] == 1
            and nano_launches["wfa_distance"] == len(recall.CARD_WIDTHS),
            f"nanopore: launches {nano_launches}, expected one K4 and "
            f"{len(recall.CARD_WIDTHS)} K1")
    exact = nano["exact"]
    require((int(exact.min()), int(exact.max())) == (2697, 2940),
            f"nanopore: K4's distances span {exact.min()}..{exact.max()}, not "
            "2697..2940")
    require(all(row[1:3] == (len(exact), len(exact)) for row in nano["rows"]),
            "nanopore: K1 left pairs unfinished or above the optimum: "
            + recall_lines(nano))
    nargs, nwp = nano["args"], nano["args"][0].shape[1]
    k4_nano_ms = best_ms(lambda: engine_cuda.align_batch_cuda(recall.exact_config(),
                                                              *nargs))
    k1_nano = {}
    for w in recall.CARD_WIDTHS:
        bcfg = recall.banded_config(w)
        k1_nano[w] = (best_ms(lambda: engine_cuda.align_batch_cuda(bcfg, *nargs)),
                      engine_cuda.blocks_per_sm(bcfg, nwp, dev),
                      engine_cuda.rows_fit(5, w, nwp, False, smem))
    host_s = []
    for _ in range(3):
        t1 = time.perf_counter()
        engine_cuda.align_batch_cuda(recall.banded_config(512), *nargs)["distance"].cpu()
        host_s.append(time.perf_counter() - t1)
    phase("nanopore", t0,
          f"{len(exact)} pairs of 20 kbp, {nwp} words a row: K4 W=6144 "
          f"(C={engine_cuda.centre_width(5, 6144, nwp, False, smem)}) "
          f"{k4_nano_ms:.3f} ms, distances {exact.min()}..{exact.max()}, all "
          f"certified below {recall.CERT_BOUND}, {len(nano['checked'])} equal to the "
          f"CPU oracle; " + recall_lines(nano) + "; K1 " + ", ".join(
              f"W={w} {ms:.3f} ms ({occ[0]} blocks of {occ[1]} threads an SM, rows "
              f"{'shared' if fit else 'global'})" for w, (ms, occ, fit) in k1_nano.items())
          + f"; W=512 call on the host {min(host_s) * 1e3:.3f} ms, "
          f"{len(exact) / min(host_s):.1f} aln/s; launches {nano_launches}; [{smi}]")

    # ---- 20. nanopore-burst: 1% error plus three 200-500 bp events ----
    t0 = time.perf_counter()
    reset_launches()
    burst = recall.card_recall(True, dev)
    torch.cuda.synchronize()
    burst_launches = dict(engine_cuda.LAUNCHES)
    require(burst_launches["wfa_distance_ring"] == 1
            and burst_launches["wfa_distance"] == len(recall.CARD_WIDTHS),
            f"nanopore-burst: launches {burst_launches}")
    bexact = burst["exact"]
    # K1 against the plain engine on the card at W=256, on pairs the band
    # clips (score above the optimum or unfinished), filled up with others.
    b256 = burst["outs"][256]
    clipped = ~b256["finished"].cpu().numpy() | (b256["distance"].cpu().numpy() != bexact)
    pick = np.concatenate([np.flatnonzero(clipped), np.flatnonzero(~clipped)])[:8]
    sel = torch.from_numpy(pick).to(dev)
    sub = tuple(t[sel].contiguous() for t in burst["args"])
    bcfg = recall.banded_config(256)
    got = engine_cuda.align_batch_cuda(bcfg, *sub)
    t1 = time.perf_counter()
    want = engine_torch.align_batch_device(bcfg, *sub)
    torch.cuda.synchronize()
    burst_plain_s = time.perf_counter() - t1
    require(torch.equal(got["distance"], want["distance"])
            and torch.equal(got["finished"], want["finished"])
            and torch.equal(got["distance"], b256["distance"][sel]),
            f"nanopore-burst: K1 differs from the plain engine at W=256 on pairs "
            f"{pick.tolist()}")
    max_err["wfa_distance"] = max(max_err["wfa_distance"], (
        got["distance"] - want["distance"]).abs().max().item())
    bargs = burst["args"]
    k4_burst_ms = best_ms(lambda: engine_cuda.align_batch_cuda(recall.exact_config(),
                                                               *bargs))
    k1_burst = {w: best_ms(lambda: engine_cuda.align_batch_cuda(
        recall.banded_config(w), *bargs)) for w in recall.CARD_WIDTHS}
    phase("nanopore-burst", t0,
          f"{len(bexact)} pairs, {bargs[0].shape[1]} words a row: K4 W=6144 "
          f"{k4_burst_ms:.3f} ms, distances {bexact.min()}..{bexact.max()}, all "
          f"certified, {len(burst['checked'])} equal to the CPU oracle; "
          + recall_lines(burst) + "; K1 " + ", ".join(
              f"W={w} {ms:.3f} ms" for w, ms in k1_burst.items())
          + f"; W=256 on pairs {pick.tolist()} ({int(clipped[pick].sum())} clipped): "
          f"K1 equal to the plain engine on the card ({burst_plain_s:.2f}s), "
          f"distances {want['distance'].tolist()}, finished "
          f"{want['finished'].int().tolist()}; launches {burst_launches}; [{smi}]")

    # ---- 21. hifi-exact-certified: HiFi x8, exact, W=1024, stopped at the certificate ----
    t0 = time.perf_counter()
    pen = Penalties(2, 3, 1)
    lmax = max(max(len(p), len(t)) for p, t in zip(pats, txts))
    hnw = ((lmax // 16 + 8 + 127) // 128) * 128
    hx_args = tensors(list(zip(pats, txts)), nw=hnw)
    hx_cert = pen.o + pen.e * (1024 // 2 + 1)
    # The Pallas score_cap = hx_cert + 1 stops the loop at d < score_cap.
    hx_cfg = engine_torch.EngineConfig(pen, 3000, 1024, -1, score_limit=hx_cert)
    reset_launches()
    hx_out = engine_cuda.align_batch_cuda(hx_cfg, *hx_args)
    torch.cuda.synchronize()
    hx_launches = dict(engine_cuda.LAUNCHES)
    require(hx_launches["wfa_distance"] == 1 and hx_launches["wfa_distance_ring"] == 0,
            f"hifi-exact-certified: launches {hx_launches}, expected one K1")
    hx_dist = hx_out["distance"].cpu().numpy()
    require(bool(hx_out["finished"].all()) and bool((hx_dist < hx_cert).all()),
            f"hifi-exact-certified: {int((~hx_out['finished']).sum())} unfinished, "
            f"largest distance {hx_dist.max()} (certificate {hx_cert})")
    n50 = len(ref["distance"])
    require(bool((hx_dist[:n50] <= np.array(ref["distance"])).all())
            and hx_dist.tolist() == hx_dist[:n50].tolist() * HIFI_REPS,
            "hifi-exact-certified: an exact distance above the banded one, or "
            "copies of a pair differ")
    hard = np.argsort(hx_dist[:n50], kind="stable")[-8:]
    oracle, _, _ = native.cpu_align_batch(
        [pats[i] for i in hard], [txts[i] for i in hard], pen,
        np.ones(len(hard), dtype=np.int8), False)
    require(oracle.tolist() == hx_dist[hard].tolist(),
            f"hifi-exact-certified: the CPU oracle differs on pairs {hard.tolist()}")
    hx_ms = best_ms(lambda: engine_cuda.align_batch_cuda(hx_cfg, *hx_args))
    hx_occ = engine_cuda.blocks_per_sm(hx_cfg, hnw, dev)
    phase("hifi-exact-certified", t0,
          f"{len(pats)} pairs, exact W=1024, score_limit {hx_cert}: K1 ({hx_occ[1]} threads a "
          f"block, {hx_occ[0]} blocks an SM, rows "
          f"{'shared' if engine_cuda.rows_fit(5, 1024, hnw, False, smem) else 'global'}) "
          f"{hx_ms:.3f} ms ({len(pats) / hx_ms * 1e3:.1f} aln/s), all finished and certified "
          f"below {hx_cert}, distances {hx_dist.min()}..{hx_dist.max()}, none above "
          f"the banded reference; CPU oracle equal on pairs {sorted(hard.tolist())}; "
          f"launches {hx_launches}; [{smi}]")

    # ---- 22. pack-device: pack_batch_torch on the card against pack_batch ----
    t0 = time.perf_counter()
    pack_lines = []
    for name, seqs in (("HiFi x8", pats + txts),
                       ("20 kbp", nano["patterns"] + nano["texts"])):
        lens = [len(s) for s in seqs]
        ascii_np = np.zeros((len(seqs), max(lens)), dtype=np.uint8)
        for i, s in enumerate(seqs):
            ascii_np[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
        nw_pack = words_for_length(ascii_np.shape[1])
        t1 = time.perf_counter()
        words, _, _ = pack_batch(seqs, nw_pack)
        host_pack_ms = (time.perf_counter() - t1) * 1e3
        ascii_t = torch.from_numpy(ascii_np).to(dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        pack_ms = best_ms(lambda: pack_batch_torch(ascii_t, lens_t))
        got = pack_batch_torch(ascii_t, lens_t).cpu().numpy().view(np.uint32)
        require(got.shape == words.shape and all(
            np.array_equal(unpack_words(got[i], ln), unpack_words(words[i], ln))
            for i, ln in enumerate(lens)),
            f"pack-device: {name}: pack_batch_torch differs from pack_batch")
        pack_lines.append(f"{name} ({len(seqs)} reads, [{len(seqs)}, {nw_pack}] "
                          f"words): pack_batch_torch {pack_ms:.3f} ms on the card, "
                          f"pack_batch {host_pack_ms:.3f} ms on the host")
    phase("pack-device", t0, "2-bit fields equal inside every read; "
          + "; ".join(pack_lines) + f"; [{smi}]")

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
