"""Large working sets on the CUDA route, and banded K4's shared pass.

A = max(o+e, x) + 1 is the ring's slots.  At (600,6,2), A = 601, so a shared
ring holds no window (``engine_cuda.max_width`` is 0): K4 runs it, in its
compact ring (M's far ring in global memory, the rest in shared memory,
``tests/test_torch_compact.py``), where ``wfa_tpu`` returns results from its
XLA engine.  Here, on the CPU: the
planner's arithmetic on the shapes that used to raise, the CUDA route's tier
loop at that working set with the wrappers on CPU tensors (their plain
versions) against ``wfa_tpu.align_pairs(backend='xla')``, ``probe_order``'s
config (banded K4 at W=128 from A = 151 on) and its distances against
``wfa_tpu``'s XLA engine, and a numpy statement of banded K4's warp-uniform
shared pass against a brute-force check of every lane a warp touches.
Every comparison is of integers or strings, exact.  K4 itself runs on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase
large-working-set).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wfa_tpu
import wfa_tpu_torch
from wfa_tpu.aligner import _probe_distances as jax_probe_distances
from wfa_tpu.ops.engine_xla import EngineConfig as XlaConfig
from wfa_tpu.ops.engine_xla import align_batch_device as xla_align
from wfa_tpu.ops.packing import pack_batch
from wfa_tpu_torch import AlignmentOptions, Penalties, aligner
from wfa_tpu_torch.aligner import (
    _PROBE_WIDTH, _TierPlan, _cigar_call_batch, _distance_call_batch,
    _probe_config, _probe_distances, _tier_geometry_cuda,
)
from wfa_tpu_torch.ops import engine_cuda, engine_torch
from wfa_tpu_torch.utils.synth import random_pairs
from wfa_tpu_torch.utils.verification import check_cigar

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

H100_SMEM = 232448   # bytes a block may opt in to on an H100
BIG = Penalties(600, 6, 2)
CPU = torch.device("cpu")

# The shapes that raised at (600,6,2) (largest x that ran at o,e = 6,2):
# (name, tier, window, banded, cigar, max_error).
SHAPES = [
    ("100bp-exact-distance", 128, 2 * 130 + 1, False, False, 6000),      # 591
    ("1kbp-exact-distance", 1024, 2 * 1026 + 1, False, False, 60000),    # 589
    ("1kbp-exact-cigar", 1024, 2 * 1026 + 1, False, True, 60000),        # 583
    ("10kbp-exact-cigar-e3000", 16384, 6001, False, True, 3000),         # 508
    ("20kbp-banded-distance", 32768, 1024, True, False, 5000),           # 549
    ("20kbp-banded-cigar", 32768, 1024, True, True, 5000),               # 539
]


def _geometry(tier, wf, banded, cigar, max_error, pen=BIG, smem=H100_SMEM):
    limit = None if banded else 2 * pen.o + pen.e * 2 * (tier + 2) + pen.x
    plan = _TierPlan(tier, [0], wf, 8, tier // 16 + 1, limit)
    opts = AlignmentOptions(penalties=pen, max_error=max_error,
                            band=25 if banded else -1, band_width=wf,
                            compute_cigar=cigar)
    return plan, opts, _tier_geometry_cuda(plan, opts, max_error,
                                           25 if banded else -1, smem)


@pytest.mark.parametrize("name,tier,wf,banded,cigar,max_error", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_planner_routes_large_a_to_k4_without_centre(name, tier, wf, banded,
                                                    cigar, max_error):
    """Each shape runs on K4, which the whole ring once held in global
    memory (no granule of centre fit): now in its compact ring, 17 rows of
    68 bytes a centre diagonal, with a centre of the whole window or, for
    10 kbp exact CIGARs, as many granules as fit."""
    A = BIG.active_working_set
    plan, opts, (cfg, full, cert, cap) = _geometry(tier, wf, banded, cigar,
                                                   max_error)
    assert engine_cuda.max_width(A, H100_SMEM, cigar) <= 0
    assert cfg.ring_global and cfg.banded == banded and full
    assert engine_cuda.compact_slots(cfg.penalties) == (9, 3, 1)
    W = cfg.wf_width
    assert W == -(-wf // 128) * 128
    centre = engine_cuda.centre_width(BIG, W, plan.nwords, cigar, H100_SMEM)
    assert 0 < centre <= W
    fixed = engine_cuda.smem_bytes(BIG, W, cigar, True, 0, plan.nwords)
    assert fixed + 68 * centre <= H100_SMEM
    assert centre == W or H100_SMEM < fixed + 68 * (centre + engine_cuda.CENTRE_GRANULE)
    # M's far ring [A, W] and the I/D edges an alignment; each launch
    # within the budget.
    ring = engine_cuda.ring_bytes(BIG, W, centre)
    assert ring == 4 * A * W + 24 * (W - centre)
    if cigar:
        call_b = _cigar_call_batch(opts, cap, cfg.wf_width, ring)
        per_lane = engine_torch.num_chunks(cap) * cfg.wf_width * 4 + ring
    else:
        call_b, per_lane = _distance_call_batch(opts, ring), ring
    assert 1 <= call_b and call_b * per_lane <= opts.memory_budget_bytes


def test_centre_zero_call_batches_and_the_last_refusal():
    """At A = 601 and W = 16384 the compact ring at a centre of 0 is 39.8 MB
    an alignment (the whole ring was 118 MB): the call batches stay at
    least 1 and within the budget.  Only a block that cannot hold the
    per-slot window words, the scratch and the packed rows is refused:
    4 (2A + 66 + 2 (nw + 1)) bytes, past 232,448 from A = 28,958 at 65 words
    a row."""
    ring = engine_cuda.ring_bytes(BIG, 16384, 0)
    assert ring == 4 * 601 * 16384 + 24 * 16384 == 39_780_352
    opts = AlignmentOptions(penalties=BIG)
    assert _distance_call_batch(opts, ring) == (1 << 30) // ring == 26
    per_lane = engine_torch.num_chunks(4000) * 16384 * 4 + ring
    assert _cigar_call_batch(opts, 4000, 16384, ring) == (1 << 30) // per_lane == 14
    tiny = dataclasses.replace(opts, memory_budget_bytes=ring // 2)
    assert _distance_call_batch(tiny, ring) == _cigar_call_batch(
        tiny, 4000, 16384, ring) == 1
    last = Penalties(28_956, 6, 2)   # A = 28,957
    assert engine_cuda.smem_bytes(last, 1024, False, True, 0, 65) == 232_448
    assert engine_cuda.centre_width(last, 1024, 65, False, H100_SMEM) == 0
    with pytest.raises(ValueError, match="K4"):
        engine_cuda.centre_width(Penalties(28_957, 6, 2), 1024, 65, False, H100_SMEM)
    with pytest.raises(ValueError, match="K4"):
        _geometry(1024, 2053, False, False, 3000, Penalties(28_957, 6, 2))
    _geometry(1024, 2053, False, False, 3000, Penalties(28_956, 6, 2))


def _pairs(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return random_pairs(rng, n, lo, hi, 0.1, n_rate=0.0, empty_rate=0.0)


@pytest.mark.parametrize("banded", [False, True], ids=["exact", "banded"])
@pytest.mark.parametrize("cigar", [False, True], ids=["distance", "cigar"])
def test_run_tier_large_a_matches_xla(monkeypatch, banded, cigar):
    """align_pairs at (600,6,2) through the CUDA route's tier loop (K4 in
    its compact ring, the wrappers' plain versions on the CPU) equals wfa_tpu's
    XLA engine: distances, flags and CIGARs."""
    pairs = _pairs(6, 60, 120, 601 + 2 * banded + cigar)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    kw = dict(max_error=2000, compute_cigar=cigar, device_retries=0)
    if banded:
        kw.update(band=10, band_width=128)
    ref = wfa_tpu.align_pairs(pats, txts, wfa_tpu.AlignmentOptions(
        penalties=wfa_tpu.Penalties(600, 6, 2), backend="xla",
        data_parallel=False, **kw))
    geoms = []
    run = aligner._run_tier_cuda

    def on_cpu(*args):
        geoms.append(_tier_geometry_cuda(args[3], args[4], args[5], args[6],
                                         H100_SMEM)[0])
        return run(*args, device=CPU, smem=H100_SMEM)

    monkeypatch.setattr(aligner, "_resolve_backend", lambda name: "cuda")
    monkeypatch.setattr(aligner, "_run_tier_cuda", on_cpu)
    got = wfa_tpu_torch.align_pairs(pats, txts, AlignmentOptions(
        penalties=BIG, backend="cuda", **kw))
    assert geoms and all(g.ring_global and g.banded == banded for g in geoms)
    assert [r.error for r in got] == [r.error for r in ref]
    assert [r.finished_on_accelerator for r in got] == [
        r.finished_on_accelerator for r in ref]
    assert sum(r.finished_on_accelerator for r in got) >= 4
    if cigar:
        assert [r.cigar for r in got] == [r.cigar for r in ref]
        assert all(check_cigar(r.cigar, p, t) for r, p, t in zip(got, pats, txts))


def test_probe_config_takes_k4_past_the_shared_ring():
    """W=128 fits a shared ring up to A = 150 (231,864 bytes); from 151 on
    the probe launches banded K4, whose compact ring holds the whole window
    in shared memory; with no shared memory given (the plain engine) the
    flag stays off."""
    for x, ring in ((149, False), (150, True), (600, True)):
        pen = Penalties(x, 6, 2)
        cfg = _probe_config(pen, 3000, 0, H100_SMEM)
        assert cfg.ring_global == ring
        assert (cfg.wf_width, cfg.band, cfg.max_steps) == (_PROBE_WIDTH, 25, 3000)
        assert _probe_config(pen, 3000, 10, H100_SMEM).band == 10
        assert not _probe_config(pen, 3000, 0, None).ring_global
    assert engine_cuda.smem_bytes(150, 128) == 231_864 <= H100_SMEM
    assert engine_cuda.smem_bytes(151, 128) == 233_408 > H100_SMEM
    # 4 kbp reads: 258 words a row.
    assert engine_cuda.centre_width(Penalties(150, 6, 2), 128, 258, False,
                                    H100_SMEM) == 128
    assert engine_cuda.centre_width(Penalties(592, 6, 2), 128, 258, False,
                                    H100_SMEM) == 128


def test_probe_large_a_matches_xla():
    """The probe's plain version at A = 151 (4 pairs of 480 bp, max_error
    240, band 0 -> 25) against wfa_tpu's XLA engine at the probe's config.
    wfa_tpu's Pallas probe takes no working set above 64 (its config
    asserts), so there it returns None and wfa_tpu uses the host estimate."""
    pen = Penalties(150, 6, 2)
    pairs = _pairs(4, 470, 490, 151)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    got = _probe_distances(pats, txts, [0, 1, 2, 3], pen, 240, 0, CPU)
    nw = 490 // 16 + 2
    pat, plen, vp = pack_batch(pats, nw)
    txt, tlen, vt = pack_batch(txts, nw)
    want = xla_align(
        XlaConfig(penalties=wfa_tpu.Penalties(150, 6, 2), max_steps=240,
                  wf_width=128, compute_cigar=False, band=25),
        jnp.asarray(pat), jnp.asarray(txt), jnp.asarray(plen),
        jnp.asarray(tlen), jnp.asarray(vp & vt))
    dist = np.asarray(want["distance"]).astype(np.float64)
    dist[~np.asarray(want["finished"])] = float(1 << 30)
    np.testing.assert_array_equal(got, dist)
    assert (got < float(1 << 30)).any()
    assert jax_probe_distances(pats, txts, [0, 1, 2, 3],
                               wfa_tpu.Penalties(150, 6, 2), 240, 0) is None


def test_probe_order_large_a_only_reorders(monkeypatch):
    """align_pairs(probe_order=True) at A = 151 on 4 kbp reads, through the
    CUDA route's loop on the CPU with the probe's K4 config: the same
    results as without the probe."""
    pen = Penalties(150, 6, 2)
    rng = np.random.default_rng(4151)
    pairs = random_pairs(rng, 3, 4100, 4200, 0.002, n_rate=0.0, empty_rate=0.0)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    probes = []
    probe, run = aligner._probe_distances, aligner._run_tier_cuda

    def probe_cpu(*args):
        probes.append(_probe_config(pen, args[4], args[5], H100_SMEM))
        return probe(*args[:6], CPU)

    monkeypatch.setattr(aligner, "_resolve_backend", lambda name: "cuda")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(aligner, "_run_tier_cuda",
                        lambda *a: run(*a, device=CPU, smem=H100_SMEM))
    monkeypatch.setattr(aligner, "_probe_distances", probe_cpu)
    opts = AlignmentOptions(penalties=pen, max_error=600, band=25,
                            band_width=128, backend="cuda", device_retries=0)
    plain = wfa_tpu_torch.align_pairs(pats, txts, opts)
    assert not probes
    ordered = wfa_tpu_torch.align_pairs(
        pats, txts, dataclasses.replace(opts, probe_order=True))
    assert len(probes) == 1 and probes[0].ring_global
    assert ordered == plain
    assert all(r.finished_on_accelerator for r in plain)


# ---- banded K4's shared pass (csrc/wfa_distance.cu), as numpy ----

def shared_limit(C, parents):
    """The highest child lane whose cell reads and writes only ring lanes
    below C: ``parents`` is [(shift, extent, reach)] for each present
    parent, a cell at lane j reading lanes shift + j - 1 .. shift + j +
    reach that lie in [0, extent].  -1: no lane."""
    jlim = C - 1
    for shift, ext, reach in parents:
        if ext >= C:
            jlim = min(jlim, C - 1 - reach - shift)
    return jlim


def shared_warps(W, nthreads, jlim):
    """For each pass and warp of the lane loop (lanes jb + 32 w .. + 31,
    clamped to W - 1): whether it takes the shared pass."""
    out = []
    for jb in range(0, W, nthreads):
        for w in range(nthreads // 32):
            if jb + 32 * w > W - 1:
                break
            out.append((jb + 32 * w, min(jb + 32 * w + 31, W - 1) <= jlim))
    return out


def lanes_touched(first, W, parents):
    """Every ring lane the warp from lane ``first`` reads or writes: the
    children's lanes and each parent lane read inside its window."""
    lanes = set()
    for j in range(first, min(first + 32, W)):
        lanes.add(j)
        for shift, ext, reach in parents:
            # M[d-x] at its lane; I and D at the lanes either side.
            for r in ((shift + j,) if reach == 0 else (shift + j - 1, shift + j + 1)):
                if 0 <= r <= ext:
                    lanes.add(r)
    return lanes


@pytest.mark.parametrize("centre", ["0", "32", "W/2", "W"])
def test_shared_pass_model_sound_and_tight(centre):
    """Fuzzed over shifts (growing windows, re-centres), extents, missing
    parents and block sizes: a warp that takes the shared pass touches only
    lanes below C, and where every parent lane its cells ask for lies inside
    that parent's window, a warp that touches only lanes below C takes it."""
    rng = np.random.default_rng({"0": 0, "32": 32, "W/2": 2, "W": 1}[centre])
    taken = declined = 0
    for _ in range(400):
        W = int(rng.choice([128, 512, 1024, 4096]))
        C = {"0": 0, "32": 32, "W/2": W // 2, "W": W}[centre]
        nthreads = int(rng.choice([512, 1024]))
        parents = []
        for reach in (0, 1, 1):          # M[d-x]; M, I, D of d-o-e; I, D of d-e
            if rng.random() < 0.15:
                continue                  # a missing parent
            ext = int(rng.choice([W - 1, rng.integers(0, W)]))
            if rng.random() < 0.6:
                shift = int(rng.integers(-2, 3))      # a window that grows
            else:
                shift = int(rng.integers(-W, W))      # a re-centre
            parents.append((shift, ext, reach))
        jlim = shared_limit(C, parents)
        for first, shared in shared_warps(W, nthreads, jlim):
            touched = lanes_touched(first, W, parents)
            below = max(touched) < C
            if shared:
                assert below
                taken += 1
            else:
                declined += 1
                inside = all(
                    0 <= shift + j - (1 if reach else 0) and shift + j + reach <= ext
                    for shift, ext, reach in parents
                    for j in range(first, min(first + 32, W)))
                if inside:
                    assert not below
    if centre == "0":
        assert taken == 0
    elif centre == "W":                   # no edge: every warp takes it
        assert taken > 20 and declined == 0
    else:
        assert taken > 20 and declined > 20
