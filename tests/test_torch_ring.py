"""The wide exact path of the port (K4: the wavefront ring's edges in global
memory) against wfa_tpu's HBM-ring kernel (``PallasConfig.ring_hbm``), on the
CPU.

K4 cannot run here; its plain versions can.  They are the port's plain
engine and CIGAR tables at the same config (``EngineConfig.ring_global``,
which the plain engine ignores), held here against the Pallas ring kernel in
interpret mode.  The ring and truncation decisions of the CUDA route's
planner are held against ``wfa_tpu.aligner._tier_geometry`` with the TPU's
VMEM cap replaced by the port's shared-memory cap.  Inputs are made from
seeds; every comparison is exact."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import wfa_tpu
import wfa_tpu.aligner as tpu_aligner
from wfa_tpu.ops.engine_pallas import PallasConfig, align_batch_pallas
from wfa_tpu.ops.engine_xla import EngineConfig as XlaConfig
from wfa_tpu.ops.packing import pack_batch
from wfa_tpu.ops.traceback_pallas import TracebackConfig as PallasTbConfig
from wfa_tpu.ops.traceback_pallas import align_cigar_fused as pallas_fused
from wfa_tpu.schedule import build_schedule
from wfa_tpu.types import Penalties
from wfa_tpu_torch import AlignmentOptions
from wfa_tpu_torch import Penalties as TorchPenalties
from wfa_tpu_torch.aligner import _TierPlan, _tier_geometry_cuda
from wfa_tpu_torch.ops import engine_cuda, engine_torch, ring_bw, traceback_torch
from wfa_tpu_torch.utils.synth import ring_wide_pairs

from test_engine import make_pairs

H100_SMEM = 232448  # bytes a block may opt in to on an H100


def _packed(pairs, nwords):
    pat, plen, vp = pack_batch([p for p, _ in pairs], nwords)
    txt, tlen, vt = pack_batch([t for _, t in pairs], nwords)
    return pat, plen, txt, tlen, vp & vt


def _jax_args(packed):
    pat, plen, txt, tlen, valid = packed
    return (jnp.asarray(pat), jnp.asarray(txt), jnp.asarray(plen),
            jnp.asarray(tlen), jnp.asarray(valid))


def _torch_args(packed):
    pat, plen, txt, tlen, valid = packed
    return engine_torch.batch_to_tensors(pat, plen, txt, tlen, valid, "cpu")


def test_plain_engine_equals_pallas_ring_distance():
    """The shapes of tests/test_pallas.py::test_ring_hbm_and_partial_extend_
    match_vmem: W=768, 16 pairs of 40/150/300 bp, (2,3,1), max_steps 400."""
    pairs = make_pairs(31, sizes=(40, 150, 300), errs=(0.0, 0.08, 0.25))
    pairs = (pairs + pairs)[:16]
    packed = _packed(pairs, 128)
    pcfg = PallasConfig(penalties=Penalties(2, 3, 1), max_steps=400,
                        wf_width=768, tile_batch=8, band=-1,
                        two_score_body=0, ring_hbm=True)
    with pltpu.force_tpu_interpret_mode():
        out_p = align_batch_pallas(pcfg, *_jax_args(packed))
        dist_p = np.asarray(out_p["distance"])
        fin_p = np.asarray(out_p["finished"])
    cfg = engine_torch.config_from_tpu(pcfg)
    assert cfg.ring_global and not cfg.banded
    out_t = engine_cuda.align_batch_cuda(cfg, *_torch_args(packed))
    np.testing.assert_array_equal(out_t["finished"].numpy(), fin_p)
    np.testing.assert_array_equal(out_t["distance"].numpy(), dist_p)
    assert fin_p.all() and dist_p.max() > 100


def test_plain_k2_k3_equal_pallas_ring_fused():
    """The shapes of tests/test_pallas.py::test_ring_hbm_cigar_matches_vmem:
    W=128, 16 pairs of 12/60/110 bp, (2,3,1), max_steps 100; columns 0-2
    equal and the op words up to n_ops equal."""
    pen = Penalties(2, 3, 1)
    pairs = make_pairs(23, sizes=(12, 60, 110), errs=(0.0, 0.08))
    pairs = (pairs + pairs)[:16]
    packed = _packed(pairs, 128)
    sched = build_schedule(pen, 100, None)
    pcfg = PallasConfig(penalties=pen, max_steps=100, wf_width=128,
                        tile_batch=8, band=-1, compute_cigar=True,
                        score_cap=sched.unfinished_score + 1, ring_hbm=True)
    ptb = PallasTbConfig(penalties=pen, wf_width=128, score_cap=pcfg.score_cap,
                         banded=False, lo_pad=0)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_fused(pcfg, ptb, *_jax_args(packed)))
    cfg = engine_torch.config_from_tpu(pcfg)
    tb = traceback_torch.TracebackConfig(
        penalties=TorchPenalties(2, 3, 1), wf_width=128,
        score_cap=pcfg.score_cap, banded=False,
    )
    got = engine_cuda.align_cigar_cuda(cfg, tb, *_torch_args(packed)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    for b in range(len(pairs)):
        n_ops = want[b, 2]
        nw = (2 * n_ops + 31) // 32 if n_ops > 0 else 0
        np.testing.assert_array_equal(got[b, 4 : 4 + nw], want[b, 4 : 4 + nw],
                                      err_msg=f"b={b}")
    assert (want[:, 2] > 0).sum() >= 6


def test_config_maps_ring_and_refuses_a_band():
    pen = Penalties(2, 3, 1)
    ring = PallasConfig(penalties=pen, max_steps=50, wf_width=256,
                        ring_hbm=True)
    plain = PallasConfig(penalties=pen, max_steps=50, wf_width=256)
    xla = XlaConfig(penalties=pen, max_steps=50, wf_width=256,
                    compute_cigar=False)
    assert engine_torch.config_from_tpu(ring).ring_global
    assert not engine_torch.config_from_tpu(plain).ring_global
    assert not engine_torch.config_from_tpu(xla).ring_global
    tpen = TorchPenalties(2, 3, 1)
    with pytest.raises(ValueError, match="exact only"):
        engine_torch.EngineConfig(tpen, 50, 256, band=25, ring_global=True)
    cfg = engine_torch.EngineConfig(tpen, 50, 256, ring_global=True)
    with pytest.raises(ValueError, match="exact only"):
        dataclasses.replace(cfg, band=10)


_PENS = [(2, 3, 1), (1, 2, 1), (3, 1, 4), (5, 3, 2), (4, 1, 2), (1, 0, 1),
         (20, 6, 2)]


@pytest.mark.parametrize("cigar", [False, True], ids=["distance", "cigar"])
def test_tier_geometry_equals_wfa_tpu(monkeypatch, cigar):
    """The ring flag, W, full_window, cert_bound and score cap of every
    (penalties, tier, max_error, band) case equal wfa_tpu's planner with the
    port's shared-memory cap in place of the VMEM cap."""
    monkeypatch.setattr(
        tpu_aligner, "_wide_exact_cap",
        lambda aws, tile: engine_cuda.max_width(aws, H100_SMEM, cigar))
    assert tpu_aligner.PALLAS_MAX_WIDTH_RING == 16384
    n = n_ring = n_cut = 0
    for x, o, e in _PENS:
        for tier in (64, 1024, 4096, 8192, 16384):
            for max_error in (30, 500, 3000, 4600, 10000):
                for band in (-1, 25):
                    banded = band > 0
                    width = 2 * min(max_error, tier + 2) + 1
                    if banded:
                        width = min(512, 2 * (tier + 2) + 1)
                    limit = None if banded else 2 * o + e * 2 * (tier + 2) + x
                    plan = _TierPlan(tier, [0], width, 8, tier // 16 + 1, limit)
                    topts = AlignmentOptions(
                        penalties=TorchPenalties(x, o, e), band=band,
                        max_error=max_error, compute_cigar=cigar)
                    ropts = wfa_tpu.AlignmentOptions(
                        penalties=Penalties(x, o, e), band=band,
                        max_error=max_error, compute_cigar=cigar,
                        data_parallel=False)
                    cfg, full, cert, cap = _tier_geometry_cuda(
                        plan, topts, max_error, band, H100_SMEM)
                    rcfg, _, _, rfull, rcert = tpu_aligner._tier_geometry(
                        plan, ropts, max_error, band, 1, 1)
                    case = (x, o, e, tier, max_error, band)
                    assert cfg.ring_global == rcfg.ring_hbm, case
                    assert cfg.wf_width == rcfg.wf_width, case
                    assert (full, cert) == (rfull, rcert), case
                    if cigar:
                        assert cap == rcfg.score_cap, case
                        assert cfg.score_limit == cap - 1, case
                    else:
                        # wfa_tpu stops a truncated window's loop at
                        # score_cap = cert + 1; the port's schedule at
                        # score_limit = cert.
                        want = limit
                        if rcfg.score_cap:
                            want = min(limit, rcfg.score_cap - 1)
                        assert cfg.score_limit == want, case
                    n += 1
                    n_ring += cfg.ring_global
                    n_cut += not full
    assert n == 350 and n_ring > 50 and n_cut > 10


def test_ring_wide_pairs_equal_bench_generator():
    # bench.py::_bench_ring_wide_exact, lines 430-443.
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    n, L = 16, 5000
    pats, txts = [], []
    for _ in range(n):
        p = rng.choice(bases, size=L)
        t = p.copy()
        k = int(L * 0.5)
        t[rng.choice(L, size=k, replace=False)] = rng.choice(bases, size=k)
        pats.append(bytes(p))
        txts.append(bytes(t))
    assert ring_wide_pairs() == list(zip(pats, txts))
    assert ring_wide_pairs(seed=8, n=2, length=64) != ring_wide_pairs(n=2, length=64)


def _tpu_ring_kernel(ring, steps):
    """tools/dev_dma_bw.py::kernel in numpy, its output aliased onto its input
    ([ROWS, BT, W] there, [B, R, W] here): per step row = i % (ROWS - 5),
    vals = rows row .. row+3, rows row .. row+2 = vals[:3] + 1.  Also the
    sum of every value read, per slab."""
    ring = ring.copy()
    span = ring.shape[1] - 4 - 1
    acc = np.zeros(ring.shape[0], dtype=np.int64)
    for i in range(steps):
        row = i % span
        vals = ring[:, row : row + 4].copy()
        acc += vals.astype(np.int64).sum(axis=(1, 2))
        ring[:, row : row + 3] = vals[:, :3] + 1
    return ring, (acc & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("rows,steps", [(15, 37), (6, 5), (24, 0)])
def test_plain_ring_bw_equals_tpu_kernel(rows, steps):
    rng = np.random.default_rng(rows * 100 + steps)
    start = rng.integers(-2**31, 2**31, size=(3, rows, 64), dtype=np.int64)
    start = start.astype(np.int32)
    want_ring, want_acc = _tpu_ring_kernel(start, steps)
    ring = torch.from_numpy(start.copy())
    before = ring_bw.LAUNCHES["ring_bw"]
    acc = ring_bw.ring_bw(ring, steps)
    assert ring_bw.LAUNCHES["ring_bw"] == before   # the plain version ran
    np.testing.assert_array_equal(ring.numpy(), want_ring)
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    assert ring_bw.step_bytes(3, 64) == 7 * 3 * 64 * 4


def test_cuda_wrappers_run_plain_versions_on_cpu_tensors():
    """With ring_global set, each wrapper on CPU tensors returns its plain
    version's output and counts no launch."""
    rng = np.random.default_rng(5)
    from wfa_tpu_torch.utils.synth import EDGE_PAIRS, random_pairs

    pairs = EDGE_PAIRS + random_pairs(rng, 20, 10, 200)
    args = _torch_args(_packed(pairs, 200 // 16 + 2))
    pen = TorchPenalties(4, 1, 2)
    sched = build_schedule(Penalties(4, 1, 2), 80, None)
    cap = sched.unfinished_score + 1
    ring = engine_torch.EngineConfig(pen, 80, 256, score_limit=cap - 1,
                                     ring_global=True)
    shared = dataclasses.replace(ring, ring_global=False)
    tb = traceback_torch.TracebackConfig(pen, 256, cap, banded=False)
    before = dict(engine_cuda.LAUNCHES)
    got = engine_cuda.align_batch_cuda(ring, *args)
    want = engine_torch.align_batch_device(shared, *args)
    assert torch.equal(got["distance"], want["distance"])
    assert torch.equal(got["finished"], want["finished"])
    tables = engine_cuda.cigar_tables_cuda(ring, cap, *args)
    plain = engine_torch.cigar_tables(shared, cap, *args)
    assert torch.equal(tables["choice_words"], plain["choice_words"])
    fused = engine_cuda.align_cigar_cuda(ring, tb, *args)
    assert torch.equal(fused, traceback_torch.align_cigar_fused(shared, tb, *args))
    assert engine_cuda.LAUNCHES == before
    # K4's block: the ring's centre, the slot bases, the scratch, the row
    # words and the two packed rows, each with a zero word after it.
    assert engine_cuda.smem_bytes(5, 16384, cigar=True, ring_global=True,
                                  centre=512, nwords=1025) == (
        4 * (15 * 512 + 10 + 66 + 16384 + 2 * 1026))
    assert engine_cuda.ring_bytes(5, 6016, 3712) == 4 * 15 * (6016 - 3712)
