"""The exact-mode cone of the CUDA kernels, and K4's split ring, on the CPU.

At score s the exact kernels (K1, K2 and K4) compute only the diagonals
|k| <= radius(s) of ``schedule.cone_radii``, and K4 keeps the ring's centre
in shared memory and only its edges in global memory.  The kernels cannot
run here; what decides their work can: the radii against an independent
statement of which diagonals a score can reach, the choice tables' cone
against the plain backward walk, and the shared-memory and edge-ring
arithmetic against values worked by hand.  Inputs are made from seeds;
every comparison is exact."""
import numpy as np
import pytest
import torch

from wfa_tpu_torch import AlignmentOptions, Penalties
from wfa_tpu_torch.aligner import _TierPlan, _tier_geometry_cuda
from wfa_tpu_torch.ops import engine_cuda, engine_torch, traceback_torch
from wfa_tpu_torch.ops.packing import pack_batch
from wfa_tpu_torch.schedule import build_schedule, cone_radii
from wfa_tpu_torch.utils.synth import EDGE_PAIRS, random_pairs

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

H100_SMEM = 232448  # bytes a block may opt in to on an H100


def _reachable_radius(x, o, e, top):
    """Per score up to ``top``, the largest |k| of a diagonal that can hold
    an offset, from the recurrence on sets of diagonals: M(0) = {0};
    I(s) = (M(s-o-e) | I(s-e)) + 1, D(s) = (M(s-o-e) | D(s-e)) - 1,
    M(s) = M(s-x) | I(s) | D(s)."""
    M, I, D = {0: {0}}, {}, {}
    for s in range(1, top + 1):
        I[s] = {k + 1 for k in M.get(s - o - e, set()) | I.get(s - e, set())}
        D[s] = {k - 1 for k in M.get(s - o - e, set()) | D.get(s - e, set())}
        M[s] = M.get(s - x, set()) | I[s] | D[s]
    return {s: max(abs(k) for k in ks) for s, ks in M.items() if ks}


@pytest.mark.parametrize("pen", [(2, 3, 1), (1, 2, 1), (5, 3, 2), (70, 6, 2)])
def test_cone_radii_follow_the_rule(pen):
    x, o, e = pen
    sched = build_schedule(Penalties(*pen), 300, None)
    radius, previous = cone_radii(Penalties(*pen), 300, None)
    scores = sched.score.astype(np.int64)
    reach = _reachable_radius(x, o, e, int(scores[-1]))
    assert radius.tolist() == [reach[s] for s in scores.tolist()]
    closed = np.where(scores >= o + e, (scores - o) // e, 0)
    W2 = 512 // 2
    if pen == (5, 3, 2):
        # Tighter than the closed form: at score 10 a gap of 3 costs 9 and
        # no step of 1 is left, so k = 3 is out of reach.
        assert (radius <= closed).all() and radius[scores == 10].tolist() == [2]
    else:
        assert (np.minimum(radius, W2) == np.minimum(closed, W2)).all()
    # No score's cone is narrower than that of the score whose slot it
    # reuses, so the block's reset keeps every cell outside the cone NULL.
    assert (previous <= radius).all()


def test_cone_shrinks_for_some_penalties():
    """(3,1,3): score 9 reaches |k| <= 0 only (M from score 6 by a
    mismatch), but its slot last held score 4, of radius 1; the kernels
    reset that difference before computing the step."""
    sched = build_schedule(Penalties(3, 1, 3), 60, None)
    radius, previous = cone_radii(Penalties(3, 1, 3), 60, None)
    at = sched.score == 9
    assert sched.score[previous > radius].tolist() == [9]
    assert (int(radius[at][0]), int(previous[at][0])) == (0, 1)


def test_schedule_table_carries_the_cone():
    pen = Penalties(3, 1, 3)
    rows, num_steps, unfinished, last = engine_cuda._schedule_tensor(
        pen, 80, None, torch.device("cpu"))
    sched = build_schedule(pen, 80, None)
    radius, previous = cone_radii(pen, 80, None)
    assert rows.shape == (num_steps, 7) and rows.dtype == torch.int32
    assert rows[:, 0].tolist() == sched.score.tolist()
    assert rows[:, 5].tolist() == radius.tolist()
    assert rows[:, 6].tolist() == previous.tolist()
    assert (unfinished, last) == (sched.unfinished_score, int(sched.score[-1]))


def _cone_bits(cfg, score_cap):
    """int64 [C, 1, W]: the nibbles of each scheduled score's cone."""
    sched = build_schedule(cfg.penalties, cfg.max_steps, cfg.score_limit)
    radius, _ = cone_radii(cfg.penalties, cfg.max_steps, cfg.score_limit)
    W = cfg.wf_width
    bits = torch.zeros((engine_torch.num_chunks(score_cap), 1, W), dtype=torch.int64)
    lane = (torch.arange(W) - W // 2).abs()
    for d, r in zip(sched.score.tolist(), radius.tolist()):
        bits[d >> 3, 0] |= (lane <= r).to(torch.int64) * 0xF << (4 * (d & 7))
    return bits


@pytest.mark.parametrize("pen,width", [((2, 3, 1), 256), ((5, 3, 2), 128),
                                       ((3, 1, 3), 128)])
def test_walks_read_only_the_cone(pen, width):
    """The plain K2's table with every nibble outside the cone scrambled
    (other scores' nibbles and the skipped scores' too) gives the plain
    K3's walks unchanged: a walk reads only inside the cone."""
    rng = np.random.default_rng(width + pen[0])
    pairs = EDGE_PAIRS + random_pairs(rng, 24, 10, 300)
    nw = 300 // 16 + 2
    pat, plen, vp = pack_batch([p for p, _ in pairs], nw)
    txt, tlen, vt = pack_batch([t for _, t in pairs], nw)
    args = engine_torch.batch_to_tensors(pat, plen, txt, tlen, vp & vt, "cpu")
    penalties = Penalties(*pen)
    cap = build_schedule(penalties, 120, None).unfinished_score + 1
    cfg = engine_torch.EngineConfig(penalties, 120, width, score_limit=cap - 1,
                                    compute_cigar=True, ring_global=True)
    tb = traceback_torch.TracebackConfig(penalties, width, cap, banded=False)
    plain = engine_torch.cigar_tables(cfg, cap, *args)
    words = plain["choice_words"].to(torch.int64) & 0xFFFFFFFF
    noise = torch.from_numpy(rng.integers(0, 2**32, words.shape, dtype=np.int64))
    inside = _cone_bits(cfg, cap)
    mixed = (words & inside) | (noise & ~inside & 0xFFFFFFFF)
    scrambled = dict(plain, choice_words=mixed.to(torch.int32))
    assert not torch.equal(scrambled["choice_words"], plain["choice_words"])
    assert engine_torch.tables_equal(cfg, cap, plain, scrambled, cone=True)
    assert not engine_torch.tables_equal(cfg, cap, plain, scrambled)

    tk = args[3] - args[2]
    want = traceback_torch.traceback_batch_device(
        tb, plain["choice_words"], None, plain["distance"], plain["finished"], tk)
    got = traceback_torch.traceback_batch_device(
        tb, scrambled["choice_words"], None, plain["distance"], plain["finished"], tk)
    assert torch.equal(got["n_ops"], want["n_ops"])
    assert torch.equal(got["ops"], want["ops"])
    assert int((want["n_ops"] > 0).sum()) >= 12


def _cone_engine(cfg, score_cap, pat, txt, plen, tlen, valid):
    """The exact kernels' score loop in PyTorch: the ring reset to NULL
    (I to NULL + 1), each step computing only its cone after resetting what
    the slot's previous score held outside it, a lane stopping at its
    distance.  Returns (distance, finished, choice words on the cones)."""
    from wfa_tpu_torch.ops.engine_torch import _choice, _extend, _pack, _shift_hi, _shift_lo
    from wfa_tpu_torch.types import OFFSET_NULL as N

    sched = build_schedule(cfg.penalties, cfg.max_steps, cfg.score_limit)
    radius, previous = cone_radii(cfg.penalties, cfg.max_steps, cfg.score_limit)
    A, W, B = cfg.penalties.active_working_set, cfg.wf_width, pat.shape[0]
    W2 = W // 2
    pad = torch.zeros((B, 1), dtype=torch.int64)
    patp = torch.cat([pat.long() & 0xFFFFFFFF, pad], 1)
    txtp = torch.cat([txt.long() & 0xFFFFFFFF, pad], 1)
    p2, t2 = plen[:, None], tlen[:, None]
    M = torch.full((A, B, W), N, dtype=torch.int32)
    I = torch.full((A, B, W), N + 1, dtype=torch.int32)
    D = torch.full((A, B, W), N, dtype=torch.int32)
    zero = torch.zeros((B, 1), dtype=torch.int32)
    M[0, :, W2] = _extend(zero, zero, patp, txtp, p2, t2)[:, 0]
    target_k = tlen - plen
    done = ((target_k == 0) & (M[0, :, W2] == tlen)) | ~valid
    finished = done & valid
    dist = torch.zeros(B, dtype=torch.int32)
    words = torch.zeros((engine_torch.num_chunks(score_cap), B, W), dtype=torch.int64)
    lane = (torch.arange(W) - W2).abs()
    null = torch.full((B, W), N, dtype=torch.int32)
    for s in range(sched.num_steps):
        if bool(done.all()):
            break
        d, o = int(sched.score[s]), int(sched.out_slot[s])
        sx, soe, se = (int(a[s]) for a in (sched.mx_slot, sched.moe_slot, sched.ide_slot))
        cone = lane <= min(int(radius[s]), W2)
        stale = (lane <= min(int(previous[s]), W2)) & ~cone
        live = ~done[:, None]
        M[o] = torch.where(live & stale, N, M[o])
        I[o] = torch.where(live & stale, N + 1, I[o])
        D[o] = torch.where(live & stale, N, D[o])
        Moe = M[soe] if soe >= 0 else null
        i_pb = torch.maximum(_pack(_shift_hi(Moe) + 1, 1),
                             _pack(_shift_hi(I[se] if se >= 0 else null) + 1, 2))
        d_pb = torch.maximum(_pack(_shift_lo(Moe), 1),
                             _pack(_shift_lo(D[se] if se >= 0 else null), 2))
        x_off = (M[sx] if sx >= 0 else null) + 1
        m_pb = torch.maximum(torch.maximum(_pack(x_off, 2), _pack(d_pb >> 2, 3)),
                             _pack(i_pb >> 2, 1))
        m_new = _extend(m_pb >> 2, (torch.arange(W) - W2)[None, :], patp, txtp, p2, t2)
        put = live & cone
        M[o] = torch.where(put, m_new, M[o])
        I[o] = torch.where(put, i_pb >> 2, I[o])
        D[o] = torch.where(put, d_pb >> 2, D[o])
        words[d >> 3] |= torch.where(put, _choice(m_pb, i_pb, d_pb).long(), 0) << 4 * (d & 7)
        rel = (target_k + W2).clamp(0, W - 1).long()
        m_at_t = torch.where((target_k + W2 >= 0) & (target_k + W2 < W),
                             M[o].gather(1, rel[:, None])[:, 0], N)
        newly = ~done & (target_k.abs() <= d) & (m_at_t == tlen)
        finished, dist, done = finished | newly, torch.where(newly, d, dist), done | newly
    dist = torch.where(valid & ~done, sched.unfinished_score, dist)
    return torch.where(valid, dist, 0), finished, words


@pytest.mark.parametrize("pen,width", [((2, 3, 1), 256), ((5, 3, 2), 128),
                                       ((3, 1, 3), 128), ((70, 6, 2), 128)])
def test_cone_recurrence_equals_plain_engine(pen, width):
    """The kernels' exact loop restricted to the cone, with I reset to
    NULL + 1 (``_cone_engine``), gives the plain engine's distances and
    flags, and its choice nibbles on every cone up to each distance: what
    the plain engine holds outside the cone cannot reach them."""
    rng = np.random.default_rng(3 * width + pen[0])
    pairs = EDGE_PAIRS + random_pairs(rng, 24, 10, 300)
    nw = 300 // 16 + 2
    pat, plen, vp = pack_batch([p for p, _ in pairs], nw)
    txt, tlen, vt = pack_batch([t for _, t in pairs], nw)
    valid = vp & vt
    valid[::9] = False
    args = engine_torch.batch_to_tensors(pat, plen, txt, tlen, valid, "cpu")
    penalties = Penalties(*pen)
    cap = build_schedule(penalties, 120, None).unfinished_score + 1
    cfg = engine_torch.EngineConfig(penalties, 120, width, score_limit=cap - 1,
                                    compute_cigar=True, ring_global=True)
    plain = engine_torch.cigar_tables(cfg, cap, *args)
    dist, fin, words = _cone_engine(cfg, cap, *args)
    assert torch.equal(dist, plain["distance"])
    assert torch.equal(fin, plain["finished"])
    got = {"choice_words": words.to(torch.int32)}
    assert engine_torch.tables_equal(cfg, cap, plain, got, cone=True)
    assert int((fin & (dist > 0)).sum()) >= 12


@pytest.mark.parametrize("workload", ["wide10k", "ring-wide", "70-6-2"])
def test_centre_and_shared_memory_arithmetic(workload):
    """K4's centre C (a multiple of 32), its block's shared memory and its
    edge ring per alignment, worked by hand: 4 bytes x (3A C + 2A window
    words + 66 scratch + W row words with CIGARs + 2 (nw + 1) sequence
    words); above A = 64 the compact ring's rows in place of 3A."""
    ring, W, nw, want = {
        # seq_10K_n100 at -e 3000: tier 16384, nw 1025.  Distance:
        # (232448 - 4 (10 + 66 + 2052)) / 60 = 3732.2 -> 3712; CIGAR adds
        # 6016 row words: (232448 - 32576) / 60 = 3331.2 -> 3328.
        "wide10k": (5, 6016, 1025, {False: (3712, 231_232, 138_240),
                                    True: (3328, 232_256, 161_280)}),
        # ring-wide, 5 kbp: tier 8192, nw 513; (232448 - 4416) / 60 = 3800.5.
        "ring-wide": (5, 9216, 513, {False: (3776, 230_976, 326_400)}),
        # (70,6,2): A = 71, the compact ring: 9 near, 3 + 3 gap and 2
        # staging rows, 68 bytes a centre diagonal, so the whole window fits
        # (4 (2A + 66 + 130) = 1,352 bytes besides); the far ring 71 x 512.
        "70-6-2": (Penalties(70, 6, 2), 512, 64,
                   {False: (512, 36_168, 145_408), True: (512, 38_216, 145_408)}),
    }[workload]
    for cigar, (centre, smem, ring_b) in want.items():
        assert engine_cuda.centre_width(ring, W, nw, cigar, H100_SMEM) == centre
        assert engine_cuda.smem_bytes(ring, W, cigar, True, centre, nw) == smem
        assert smem <= H100_SMEM
        assert centre == W or H100_SMEM < engine_cuda.smem_bytes(
            ring, W, cigar, True, centre + 32, nw)
        assert engine_cuda.ring_bytes(ring, W, centre) == ring_b
    # A centre of all W holds no edges; below one granule, none is in
    # shared memory; the block's part outside the ring must fit.
    assert engine_cuda.centre_width(ring, 128, nw, False, H100_SMEM) == 128
    fixed = engine_cuda.smem_bytes(ring, W, False, True, 0, nw)
    assert engine_cuda.centre_width(
        ring, W, nw, False, engine_cuda.smem_bytes(ring, W, False, True, 31, nw)) == 0
    assert engine_cuda.centre_width(ring, W, nw, False, fixed) == 0
    with pytest.raises(ValueError, match="shared memory"):
        engine_cuda.centre_width(ring, W, nw, False, fixed - 1)


def test_planner_refuses_a_centre_that_does_not_fit():
    """The wide tier's decisions are those of the whole-ring K4; a block
    too small for one centre granule keeps the whole ring in global memory
    (centre 0), and one too small for the packed rows and the per-slot
    window words raises."""
    pen = Penalties(2, 3, 1)
    limit = 2 * 3 + 2 * (16384 + 2) + 2
    plan = _TierPlan(16384, [0], 6001, 8, 1025, limit)
    opts = AlignmentOptions(penalties=pen, max_error=3000)
    cfg, full, _, _ = _tier_geometry_cuda(plan, opts, 3000, -1, H100_SMEM)
    assert (cfg.wf_width, cfg.ring_global, full) == (6016, True, True)
    fixed = engine_cuda.smem_bytes(5, 6016, False, True, 0, 1025)
    small = fixed + 12 * 5 * 31
    assert _tier_geometry_cuda(plan, opts, 3000, -1, small)[0] == cfg
    assert engine_cuda.centre_width(5, 6016, 1025, False, small) == 0
    with pytest.raises(ValueError, match="shared memory"):
        _tier_geometry_cuda(plan, opts, 3000, -1, fixed - 4)
