"""The CUDA kernels against their plain PyTorch versions on the card.

K1 (wfa_tpu_torch/ops/csrc/wfa_distance.cu): ``distance`` and ``finished``
equal in every lane.  K2 (the same source, CIGAR mode): distances and flags
equal, and the choice table and ``lo_trace`` equal wherever a backward walk
can read them (``engine_torch.tables_equal``; exact tables on the cone).
K3 (wfa_tpu_torch/ops/csrc/wfa_traceback.cu): the fused rows (distance,
finished, n_ops, 0, op stream) equal.  K4 (wfa_distance.cu with the ring's
edges in global memory, ``ring_global``): the same outputs as the plain
versions and as K1/K2 where both run, also with a centre pinned narrower
than the cone, so that cells cross from shared to global memory.  The ring-row probe (csrc/ring_bw.cu): the ring and
the sums equal.  The calibration kernels (csrc/sol_calibrate.cu) and the
wide-gather probe (csrc/gather_probe.cu): outputs equal.  Tolerance 0
throughout.

Needs an NVIDIA GPU and nvcc; without them every test skips.  The file
imports no jax, so on a machine without it run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from wfa_tpu_torch.ops import (
    engine_cuda, engine_torch, gather_probe, ring_bw, sol_calibrate, traceback_torch,
)
from wfa_tpu_torch.ops.packing import pack_batch
from wfa_tpu_torch.schedule import build_schedule
from wfa_tpu_torch.types import Penalties
from wfa_tpu_torch.utils.synth import EDGE_PAIRS, random_pairs

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tensors(pairs, device, invalid_every=0):
    lmax = max(max(len(p), len(t)) for p, t in pairs)
    nw = lmax // 16 + 2
    pat, plen, vp = pack_batch([p for p, _ in pairs], nw)
    txt, tlen, vt = pack_batch([t for _, t in pairs], nw)
    valid = vp & vt
    if invalid_every:
        valid[::invalid_every] = False
    return engine_torch.batch_to_tensors(pat, plen, txt, tlen, valid, device)


@pytest.mark.parametrize(
    "band,pen,width",
    [(-1, Penalties(2, 3, 1), 128), (10, Penalties(2, 3, 1), 128),
     (25, Penalties(4, 1, 2), 512), (-1, Penalties(1, 0, 1), 1024),
     (10, Penalties(70, 6, 2), 128), (-1, Penalties(2, 3, 1), 32)],
)
def test_kernel_equals_plain_version(device, band, pen, width):
    rng = np.random.default_rng(width + pen.x + band)
    pairs = EDGE_PAIRS + random_pairs(rng, 64, 10, 600)
    args = _tensors(pairs, device, invalid_every=9)
    cfg = engine_torch.EngineConfig(pen, 120, width, band)
    before = engine_cuda.LAUNCHES["wfa_distance"]
    got = engine_cuda.align_batch_cuda(cfg, *args)
    torch.cuda.synchronize()
    assert engine_cuda.LAUNCHES["wfa_distance"] == before + 1
    want = engine_torch.align_batch_device(cfg, *args)
    assert torch.equal(got["finished"], want["finished"])
    assert torch.equal(got["distance"], want["distance"])


def test_kernel_refuses_what_it_cannot_run(device):
    args = _tensors(EDGE_PAIRS, device)
    pen = Penalties(2, 3, 1)
    with pytest.raises(ValueError):   # W not a multiple of 32
        engine_cuda.align_batch_cuda(
            engine_torch.EngineConfig(pen, 50, 100, -1), *args)
    with pytest.raises(ValueError):   # ring larger than shared memory
        engine_cuda.align_batch_cuda(
            engine_torch.EngineConfig(Penalties(70, 6, 2), 50, 512, 25), *args)
    with pytest.raises(ValueError):   # wrong dtype
        engine_cuda.align_batch_cuda(
            engine_torch.EngineConfig(pen, 50, 128, -1),
            args[0].long(), *args[1:])


def _cigar_configs(pen, max_steps, width, band, ring_global=False):
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


@pytest.mark.parametrize(
    "band,pen,width",
    [(-1, Penalties(2, 3, 1), 128), (10, Penalties(2, 3, 1), 128),
     (25, Penalties(4, 1, 2), 512), (-1, Penalties(1, 0, 1), 512),
     (10, Penalties(70, 6, 2), 128)],
)
def test_k2_k3_equal_plain_version(device, band, pen, width):
    rng = np.random.default_rng(7 * width + pen.x + band)
    pairs = EDGE_PAIRS + random_pairs(rng, 48, 10, 500)
    args = _tensors(pairs, device, invalid_every=11)
    cfg, tb = _cigar_configs(pen, 120, width, band)
    before = dict(engine_cuda.LAUNCHES)
    got = engine_cuda.cigar_tables_cuda(cfg, tb.score_cap, *args)
    fused = engine_cuda.traceback_cuda(
        tb, got["choice_words"], got.get("lo_trace"), got["distance"],
        got["finished"], args[3] - args[2],
    )
    torch.cuda.synchronize()
    assert engine_cuda.LAUNCHES["wfa_cigar"] == before["wfa_cigar"] + 1
    assert engine_cuda.LAUNCHES["wfa_traceback"] == before["wfa_traceback"] + 1
    plain = engine_torch.cigar_tables(cfg, tb.score_cap, *args)
    assert torch.equal(got["finished"], plain["finished"])
    assert torch.equal(got["distance"], plain["distance"])
    assert engine_torch.tables_equal(cfg, tb.score_cap, plain, got, cone=True)
    want = traceback_torch.align_cigar_fused(cfg, tb, *args)
    assert torch.equal(fused, want)
    assert torch.equal(engine_cuda.align_cigar_cuda(cfg, tb, *args), want)
    walked = plain["finished"] & (plain["distance"] > 0)
    assert bool((want[:, 2][walked] > 0).all())


def test_k3_walk_errors_equal_plain_version(device):
    """A table of zeros: lanes whose diagonal leaves the window are corrupt
    (-1), unfinished and distance-0 lanes have no walk (0)."""
    pen = Penalties(2, 3, 1)
    tb = traceback_torch.TracebackConfig(pen, 64, 40, banded=False)
    words = torch.zeros((tb.num_chunks, 4, 64), dtype=torch.int32, device=device)
    dist = torch.tensor([6, 6, 0, 6], dtype=torch.int32, device=device)
    fin = torch.tensor([True, True, True, False], device=device)
    tk = torch.tensor([0, 40, 0, 0], dtype=torch.int32, device=device)
    got = engine_cuda.traceback_cuda(tb, words, None, dist, fin, tk)
    want = engine_cuda.traceback_cuda(
        tb, words.cpu(), None, dist.cpu(), fin.cpu(), tk.cpu()
    )
    assert torch.equal(got.cpu(), want)
    assert got[:, 2].tolist() == [3, -1, 0, 0]


@pytest.mark.parametrize(
    "pen,width,centre,threads",
    [(Penalties(2, 3, 1), 128, None, 0), (Penalties(4, 1, 2), 512, None, 0),
     (Penalties(1, 0, 1), 1024, None, 0), (Penalties(70, 6, 2), 512, None, 0),
     (Penalties(2, 3, 1), 512, 64, 0), (Penalties(1, 0, 1), 1024, 128, 512),
     (Penalties(70, 6, 2), 512, 64, 0), (Penalties(3, 1, 3), 512, 32, 0)],
)
def test_k4_equals_plain_version(device, pen, width, centre, threads):
    """K4 in distance and CIGAR mode; (70,6,2) at W=512 needs 436 KB of ring,
    more than a block's shared memory.  A pinned centre of 32-128 diagonals
    puts most of each cone in the global edges; (3,1,3) has a step whose cone
    is narrower than its slot's previous one."""
    rng = np.random.default_rng(3 * width + pen.x + (centre or 0))
    pairs = EDGE_PAIRS + random_pairs(rng, 48, 10, 600)
    args = _tensors(pairs, device, invalid_every=9)
    pin = dict(_centre=centre, _threads=threads)
    cfg = engine_torch.EngineConfig(pen, 120, width, -1, ring_global=True)
    before = dict(engine_cuda.LAUNCHES)
    got = engine_cuda.align_batch_cuda(cfg, *args, **pin)
    ccfg, tb = _cigar_configs(pen, 120, width, -1, ring_global=True)
    tables = engine_cuda.cigar_tables_cuda(ccfg, tb.score_cap, *args, **pin)
    fused = engine_cuda.align_cigar_cuda(ccfg, tb, *args, **pin)
    torch.cuda.synchronize()
    assert engine_cuda.LAUNCHES["wfa_distance_ring"] == before["wfa_distance_ring"] + 1
    assert engine_cuda.LAUNCHES["wfa_cigar_ring"] == before["wfa_cigar_ring"] + 2
    assert engine_cuda.LAUNCHES["wfa_distance"] == before["wfa_distance"]
    assert engine_cuda.LAUNCHES["wfa_cigar"] == before["wfa_cigar"]
    want = engine_torch.align_batch_device(cfg, *args)
    assert torch.equal(got["finished"], want["finished"])
    assert torch.equal(got["distance"], want["distance"])
    plain = engine_torch.cigar_tables(ccfg, tb.score_cap, *args)
    assert torch.equal(tables["finished"], plain["finished"])
    assert torch.equal(tables["distance"], plain["distance"])
    assert engine_torch.tables_equal(ccfg, tb.score_cap, plain, tables, cone=True)
    assert torch.equal(fused, traceback_torch.align_cigar_fused(ccfg, tb, *args))


def test_k4_refuses_a_centre_it_cannot_take(device):
    args = _tensors(EDGE_PAIRS, device)
    cfg = engine_torch.EngineConfig(Penalties(2, 3, 1), 50, 256, -1,
                                    ring_global=True)
    for centre in (0, 48, 288):   # none, off the granule, wider than W
        with pytest.raises(ValueError, match="centre"):
            engine_cuda.align_batch_cuda(cfg, *args, _centre=centre)
    with pytest.raises(RuntimeError):   # more threads than K4's block takes
        engine_cuda.align_batch_cuda(cfg, *args, _threads=2048)


def test_k4_equals_k1_k2(device):
    rng = np.random.default_rng(11)
    pairs = EDGE_PAIRS + random_pairs(rng, 64, 10, 800)
    args = _tensors(pairs, device, invalid_every=7)
    pen = Penalties(2, 3, 1)
    ring = engine_torch.EngineConfig(pen, 150, 512, -1, ring_global=True)
    shared = dataclasses.replace(ring, ring_global=False)
    a = engine_cuda.align_batch_cuda(ring, *args)
    b = engine_cuda.align_batch_cuda(shared, *args)
    assert torch.equal(a["distance"], b["distance"])
    assert torch.equal(a["finished"], b["finished"])
    ccfg, tb = _cigar_configs(pen, 150, 512, -1, ring_global=True)
    assert torch.equal(
        engine_cuda.align_cigar_cuda(ccfg, tb, *args),
        engine_cuda.align_cigar_cuda(
            dataclasses.replace(ccfg, ring_global=False), tb, *args),
    )


def test_k4_refuses_a_band(device):
    pen = Penalties(2, 3, 1)
    with pytest.raises(ValueError, match="exact only"):
        engine_torch.EngineConfig(pen, 50, 128, 25, ring_global=True)
    # The C entry point refuses a ring with a band too.
    args = _tensors(EDGE_PAIRS, device)
    B, nw = args[0].shape
    sched, num_steps, unfinished, _ = engine_cuda._schedule_tensor(
        pen, 50, None, device)
    dist = torch.empty(B, dtype=torch.int32, device=device)
    fin = torch.empty(B, dtype=torch.bool, device=device)
    edges = torch.empty((B, 15, 64), dtype=torch.int32, device=device)
    lib = engine_cuda.load_library("wfa_distance")
    rc = lib.wfa_distance_launch(
        *(t.data_ptr() for t in args[:2]), nw,
        *(t.data_ptr() for t in args[2:]), sched.data_ptr(), num_steps,
        unfinished, 5, 128, 25, dist.data_ptr(), fin.data_ptr(),
        edges.data_ptr(), 64, 0, B, device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    assert rc != 0


@pytest.mark.parametrize("shape,steps", [((3, 15, 64), 37), ((5, 15, 1024), 300)])
def test_ring_bw_equals_plain_version(device, shape, steps):
    rng = np.random.default_rng(steps)
    start = torch.from_numpy(
        rng.integers(-1000, 1000, size=shape).astype(np.int32))
    ring = start.to(device)
    before = ring_bw.LAUNCHES["ring_bw"]
    acc = ring_bw.ring_bw(ring, steps)
    torch.cuda.synchronize()
    assert ring_bw.LAUNCHES["ring_bw"] == before + 1
    plain = start.clone()
    want = ring_bw.ring_bw_plain(plain, steps)
    assert torch.equal(ring.cpu(), plain)
    assert torch.equal(acc.cpu(), want)


def _tiles(rng, G, lo=-(2**31), hi=2**31):
    return torch.from_numpy(rng.integers(lo, hi, (G, 8, 128), dtype=np.int32))


@pytest.mark.parametrize("G,iters", [(1, 0), (1, 5), (3, 64)])
def test_calibration_kernels_equal_plain_versions(device, G, iters):
    rng = np.random.default_rng(G * 100 + iters)
    x = _tiles(rng, G)
    x[0, :4] = -7 - torch.arange(128)        # a tile with rows <= 0 ...
    nonpos = _tiles(rng, G, -1000, 1)         # ... and whole tiles <= 0
    idx = _tiles(rng, G, 0, 128)
    before = dict(sol_calibrate.LAUNCHES)
    got = {
        "vpu_ops": sol_calibrate.vpu_ops(x.to(device), iters),
        "gather_chain": sol_calibrate.gather_chain(x.to(device), idx.to(device), iters),
        "scalar_sync": sol_calibrate.scalar_sync(x.to(device), iters),
    }
    sync512 = sol_calibrate.scalar_sync(nonpos.to(device), iters, threads=512)
    sync1024 = sol_calibrate.scalar_sync(nonpos.to(device), iters, threads=1024)
    torch.cuda.synchronize()
    assert sol_calibrate.LAUNCHES == {
        k: v + (3 if k == "scalar_sync" else 1) for k, v in before.items()}
    assert torch.equal(got["vpu_ops"].cpu(), sol_calibrate.vpu_ops_plain(x, iters))
    assert torch.equal(got["gather_chain"].cpu(),
                       sol_calibrate.gather_chain_plain(x, idx, iters))
    assert torch.equal(got["scalar_sync"].cpu(), sol_calibrate.scalar_sync_plain(x, iters))
    want = sol_calibrate.scalar_sync_plain(nonpos, iters)
    assert torch.equal(sync512.cpu(), want) and torch.equal(sync1024.cpu(), want)


@pytest.mark.parametrize("R,W", [(8, 2048), (5, 36), (300, 4100)])
def test_k_wide_equals_plain_version(device, R, W):
    tab, idx = gather_probe.random_inputs(R, W, device, seed=R)
    before = gather_probe.LAUNCHES["k_wide"]
    out = gather_probe.k_wide(tab, idx)
    torch.cuda.synchronize()
    assert gather_probe.LAUNCHES["k_wide"] == before + 1
    assert torch.equal(out, gather_probe.k_wide_plain(tab, idx))


def test_probes_refuse_what_they_cannot_run(device):
    x = torch.zeros((2, 8, 128), dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        sol_calibrate.vpu_ops(x.to(torch.int64), 1)
    with pytest.raises(ValueError):
        sol_calibrate.gather_chain(x, x.cpu(), 1)
    with pytest.raises(ValueError):
        sol_calibrate.scalar_sync(x, 1, threads=256)
    with pytest.raises(ValueError):
        sol_calibrate.vpu_ops(x[:, :, ::2], 1)
    tab, idx = gather_probe.random_inputs(4, 64, device)
    with pytest.raises(ValueError):     # W not a multiple of 4
        gather_probe.k_wide(tab, idx[:, :62].contiguous())
    with pytest.raises(ValueError):     # a start off 16 bytes
        gather_probe.k_wide(tab[:3], idx.view(-1)[1:193].view(3, 64))
    lib = sol_calibrate.load_library("sol_calibrate")
    rc = lib.scalar_sync_launch(x.data_ptr(), x.data_ptr(), 2, 1, 256, device.index,
                                torch.cuda.current_stream(device).cuda_stream)
    assert rc != 0


def test_calibration_rates(device):
    """The measuring functions at the TPU script's counts, one tile each: a
    positive cost per step; the full card's G from the occupancy query."""
    full = sol_calibrate.resident_tiles("vpu_ops", device)
    assert full >= torch.cuda.get_device_properties(device).multi_processor_count
    for r in (sol_calibrate.bench_vpu_ops(device),
              sol_calibrate.bench_gather(device),
              sol_calibrate.bench_scalar_sync(device, threads=512)):
        assert r["ns_per_step"] > 0 and r["per_s"] > 0, r
