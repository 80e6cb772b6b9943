#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, wfa_tpu_torch.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a), nvcc and a C++ compiler; imports no
jax.  It builds the CUDA kernel K1 (wfa_tpu_torch/ops/csrc/wfa_distance.cu)
from the sources, holds it against its plain PyTorch version on random
pairs, drives align_pairs(backend='cuda') on the golden score sets, and runs
the HiFi banded distance workload (400 pairs of ~14 kbp, W=512, band 25,
penalties 2,3,1) through the kernel alone, the plain version and align_pairs,
with its times.  Every phase prints one line with its seconds; any failure
ends the run with a nonzero exit code.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
HIFI_REPS = 8


def phase(name: str, t0: float, detail: str) -> None:
    print(f"[{name}] {time.perf_counter() - t0:.2f}s {detail}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from wfa_tpu import native
    from wfa_tpu.ops.packing import pack_batch
    from wfa_tpu.types import Penalties
    from wfa_tpu.utils.io import read_seq_file
    from wfa_tpu_torch import AlignmentOptions, align_pairs
    from wfa_tpu_torch.ops import _build, engine_cuda, engine_torch
    from wfa_tpu_torch.utils.device_query import describe
    from wfa_tpu_torch.utils.synth import EDGE_PAIRS, random_pairs

    dev = torch.device("cuda", 0)

    def tensors(pairs, invalid_every=0):
        lmax = max(max(len(p), len(t)) for p, t in pairs)
        nw = lmax // 16 + 2
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

    # ---- 1. Card ----
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    phase("card", t0, f"{describe()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # ---- 2. Build ----
    t0 = time.perf_counter()
    _build.load_library()
    log = _build.library_path().with_suffix(".log").read_text()
    ptxas = "; ".join(
        ln.split(":", 1)[-1].strip() for ln in log.splitlines()
        if "registers" in ln or "spill" in ln
    )
    t_nvcc = time.perf_counter() - t0
    # The host library: packing, readers and the CPU fallback of align_pairs.
    require(_build.ensure_native(), "wfa_tpu's native host library did not build")
    threads = native.get_lib().wfa_cpu_num_threads()
    phase("build", t0, f"nvcc sm_90a {t_nvcc:.2f}s: {ptxas}; native host "
          f"library {time.perf_counter() - t0 - t_nvcc:.2f}s, {threads} CPU "
          "fallback thread(s)")

    # ---- 3. K1 against the plain version on the card ----
    t0 = time.perf_counter()
    rng = np.random.default_rng(20261016)
    max_err = 0
    n_cases = n_lanes = 0
    prep_s = k1_s = plain_s = 0.0
    cases = [
        (band, pen, w)
        for band in (-1, 10, 25)
        for pen in (Penalties(2, 3, 1), Penalties(1, 0, 1), Penalties(4, 1, 2))
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
        max_err = max(max_err, err)
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
    launches0 = engine_cuda.LAUNCHES
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
    shares = []
    for name, batch, pen, me, gold in golden_runs:
        t1 = time.perf_counter()
        res = align_pairs(batch.patterns, batch.texts, AlignmentOptions(
            penalties=pen, max_error=me, backend="cuda"))
        bad = sum(r.error != g for r, g in zip(res, gold))
        require(len(res) == len(gold) and bad == 0,
                f"{name}: {bad} scores differ from the goldens")
        on_card = sum(r.finished_on_accelerator for r in res)
        shares.append(f"{name} {on_card}/{len(res)} on card "
                      f"({time.perf_counter() - t1:.2f}s)")
    require(engine_cuda.LAUNCHES > launches0, "golden runs launched no kernel")
    phase("goldens", t0, "all scores equal; " + ", ".join(shares))

    # ---- 5. HiFi banded distance: 400 x ~14 kbp, W=512, band 25 ----
    t0 = time.perf_counter()
    ref = json.loads((DATA / "hifi_banded_w512_b25.json").read_text())
    hifi = read_seq_file(DATA / "test_hifi.seq")
    pats = hifi.patterns * HIFI_REPS
    txts = hifi.texts * HIFI_REPS
    n = len(pats)
    args = tensors(list(zip(pats, txts)))
    cfg = engine_torch.EngineConfig(Penalties(2, 3, 1), 3000, 512, 25)
    out = engine_cuda.align_batch_cuda(cfg, *args)   # warm-up
    torch.cuda.synchronize()
    k_ms, out = cuda_ms(lambda: engine_cuda.align_batch_cuda(cfg, *args), 5)
    dist = out["distance"].cpu().numpy()
    require(bool(out["finished"].all()), "HiFi: unfinished pairs on K1")
    require(dist.tolist() == ref["distance"] * HIFI_REPS,
            "HiFi: K1 distances differ from the stored reference")
    p_ms, plain = cuda_ms(lambda: engine_torch.align_batch_device(cfg, *args), 1)
    err = (plain["distance"] - out["distance"]).abs().max().item()
    require(err == 0 and torch.equal(plain["finished"], out["finished"]),
            "HiFi: plain version differs from K1")
    max_err = max(max_err, err)

    opts = AlignmentOptions(penalties=Penalties(2, 3, 1), max_error=3000,
                            band=25, band_width=512, backend="cuda")
    align_pairs(pats[:8], txts[:8], opts)            # warm-up
    torch.cuda.synchronize()
    engine_cuda.LAUNCHES = 0
    t1 = time.perf_counter()
    res = align_pairs(pats, txts, opts)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t1
    launches = engine_cuda.LAUNCHES
    require(launches > 0, "align_pairs(backend='cuda') launched no kernel")
    require([r.error for r in res] == ref["distance"] * HIFI_REPS,
            "HiFi: align_pairs distances differ from the stored reference")
    require(all(r.finished_on_accelerator for r in res),
            "HiFi: align_pairs left pairs to the CPU")
    phase("hifi", t0,
          f"{n} pairs: K1 {k_ms:.3f} ms ({n / k_ms * 1e3:.1f} aln/s), "
          f"plain {p_ms:.3f} ms ({n / p_ms * 1e3:.1f} aln/s), "
          f"align_pairs {e2e_s * 1e3:.3f} ms ({n / e2e_s:.1f} aln/s), "
          f"{launches} launches; [{smi}]")

    print(json.dumps({"kernels": [{
        "name": "wfa_distance",
        "route": "cuda",
        "source": "wfa_tpu_torch/ops/csrc/wfa_distance.cu",
        "replaces": "wfa_tpu/ops/engine_pallas.py:804",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
