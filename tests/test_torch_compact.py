"""K4's compact ring (working sets above 64) on the CPU.

At A = max(x, o+e) + 1 > 64 every K4 launch keeps the compact ring
(csrc/wfa_distance.cu, ``kCompact``): M's near ring of min(x, o+e) + 1
slots, the I and D rings of e + 1 slots and two staging rows of M's far
parent in shared memory, M's far ring of A slots in global memory, each read
masked by its parent's cone (exact) or window (banded), nothing reset.  The
kernel cannot run here; its rules can.  ``compact_engine`` states them in
PyTorch, slot for slot and with the staging rows filled when the kernel
fills them (one step ahead, or after the score's barrier when the next far
parent is this score), on rings that start as random garbage.  Its step
loop equals the plain engine and ``wfa_tpu``'s XLA engine at (600,6,2),
(580,6,2), (70,6,2), (3,200,1) (the far parent is o+e, not x),
(100,90,10) (x = o+e: both M parents far) and (100,0,100) (every far parent
copied after the barrier), exact and banded, in distance and
CIGAR-table mode, at several centres.  A fuzz over penalties checks on the
schedule alone that no slot is overwritten between its write and its last
read, and the planner's arithmetic is worked on the shapes of
``tests/test_torch_large_a.py``.  Every comparison is of integers, exact.
K4 itself runs on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase large-working-set).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wfa_tpu
from wfa_tpu.ops.engine_xla import EngineConfig as XlaConfig
from wfa_tpu.ops.engine_xla import align_batch_device as xla_align
from wfa_tpu_torch import AlignmentOptions, Penalties
from wfa_tpu_torch.aligner import (
    _TierPlan, _cigar_call_batch, _distance_call_batch, _tier_geometry_cuda,
)
from wfa_tpu_torch.ops import engine_cuda, engine_torch
from wfa_tpu_torch.ops.engine_torch import _choice, _extend, _pack
from wfa_tpu_torch.ops.packing import pack_batch
from wfa_tpu_torch.schedule import build_schedule
from wfa_tpu_torch.types import OFFSET_NULL as NULL
from wfa_tpu_torch.utils.synth import EDGE_PAIRS, random_pairs

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

H100_SMEM = 232448  # bytes a block may opt in to on an H100
CPU = torch.device("cpu")


def compact_engine(cfg, score_cap, pat, txt, plen, tlen, valid, centre, seed=0):
    """The compact ring's score loop (``wfa_kernel<..., kCompact>``) in
    PyTorch over a batch: the kernel's schedule table, its rings (shared
    rows hold lanes cl .. cl + C - 1; M's edges come from the far ring, I's
    and D's from their own rows), every ring filled with random values
    first, a lane stopping at its distance.  Returns (distance, finished,
    choice words [num_chunks, B, W] of every computed cell, lo_trace
    [B, lo_pad])."""
    pen = cfg.penalties
    A, W, B = pen.active_working_set, cfg.wf_width, pat.shape[0]
    W2 = W // 2
    near, gap, far_mask = engine_cuda.compact_slots(pen)
    rows, num_steps, unfinished, _ = engine_cuda._schedule_rows(
        pen, cfg.max_steps, cfg.score_limit, CPU, True)
    tab = rows.tolist()
    banded = cfg.banded
    cl = 0 if banded else (W - centre) // 2
    jr = torch.arange(W)
    in_c = (jr >= cl) & (jr < cl + centre)
    i_reset = NULL if banded else NULL + 1
    gen = torch.Generator().manual_seed(seed)

    def garbage(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, dtype=torch.int32)

    near_r, far_r, stage = garbage(near, B, W), garbage(A, B, W), garbage(2, B, W)
    gap_i, gap_d = garbage(gap, B, W), garbage(gap, B, W)
    win_lo = torch.zeros((A, B), dtype=torch.int32)
    win_ext = torch.zeros((A, B), dtype=torch.int32)

    pad = torch.zeros((B, 1), dtype=torch.int64)
    patp = torch.cat([pat.long() & 0xFFFFFFFF, pad], 1)
    txtp = torch.cat([txt.long() & 0xFFFFFFFF, pad], 1)
    p2, t2 = plen[:, None], tlen[:, None]
    target_k = tlen - plen

    def m_read(shared_row, aslot):
        """M of a parent at every lane: the centre from its shared row, the
        edges from the far ring."""
        return torch.where(in_c, shared_row, far_r[aslot])

    def prefetch(s, buf):
        """The kernel's copy of step s's far parent into staging row buf:
        the centre lanes of its cone (exact) or window (banded), rounded
        out to 4-lane granules."""
        if s >= num_steps or centre == 0:
            return
        row = tab[s]
        aslot = row[2] if far_mask & 1 else row[3]
        if aslot < 0:
            return
        if banded:
            hi = torch.clamp(win_ext[aslot], max=centre - 1)[:, None]
            lo = torch.zeros_like(hi)
        else:
            r = row[11] if far_mask & 1 else row[12]
            lo = torch.full((B, 1), max(W2 - r - cl, 0))
            hi = torch.full((B, 1), min(W2 + r - cl, centre - 1))
        jc = (jr - cl)[None, :]
        take = in_c[None, :] & (jc >= (lo >> 2) * 4) & (jc <= (hi >> 2) * 4 + 3)
        stage[buf] = torch.where(take, far_r[aslot], stage[buf])

    zero = torch.zeros((B, 1), dtype=torch.int32)
    init = _extend(zero, zero, patp, txtp, p2, t2)[:, 0]
    lane0 = 0 if banded else W2
    near_r[0, :, lane0] = init   # score 0: near slot 0, far slot 0
    far_r[0, :, lane0] = init
    done = ((target_k == 0) & (init == tlen)) | ~valid
    finished = done & valid
    dist = torch.zeros(B, dtype=torch.int32)
    words = torch.zeros((engine_torch.num_chunks(score_cap), B, W), dtype=torch.int64)
    lo_trace = torch.zeros((B, engine_torch.lo_pad(score_cap)), dtype=torch.int32)
    prefetch(0, 0)
    for s in range(num_steps):
        if bool(done.all()):
            break
        d, oslot, sx, soe, se, r_d = tab[s][:6]
        near_out, gap_out, near_in, gap_in, rad_x, rad_oe, rad_e = tab[s][7:]
        stage_row = stage[s & 1].clone()
        late = s + 1 < num_steps and tab[s + 1][0] - (A - 1) == d
        if not late:
            prefetch(s + 1, (s + 1) & 1)
        Mx = m_read(stage_row if far_mask & 1 else near_r[near_in], max(sx, 0))
        Moe = m_read(stage_row if far_mask & 2 else near_r[near_in], max(soe, 0))
        Ie, De = gap_i[gap_in], gap_d[gap_in]
        live = ~done
        if banded:
            def bounds(slot):
                if slot < 0:
                    return torch.full((B,), -(2**20)), torch.full((B,), 2**20)
                return win_lo[slot] + win_ext[slot], win_lo[slot]

            (hx, lx), (ho, lo_), (he, le) = bounds(sx), bounds(soe), bounds(se)
            hi_n = torch.maximum(hx, torch.maximum(ho, he) + 1)
            lo_n = torch.minimum(lx, torch.minimum(lo_, le) - 1)
            t = torch.clamp(hi_n - lo_n - (W - 1), min=0)
            hi_n, lo_n = hi_n - (t + 1) // 2, lo_n + t // 2
            if d % cfg.band == 0 and sx >= 0 and (soe >= 0 or se >= 0):
                lox, extx = win_lo[sx], win_ext[sx]
                kx = lox[:, None] + jr
                d2t = torch.where(Mx >= 0, torch.maximum(p2 - (Mx - kx), t2 - Mx),
                                  2**31 - 1)
                d2t = torch.where(jr < extx[:, None], d2t, 2**31 - 1)
                best = torch.cat([2 * (t2 + p2), d2t], 1).argmin(1).to(torch.int32)
                lo_rc = lox + torch.clamp(best - 1, min=0) - W2
                lo_n = torch.where(extx >= W - 1, lo_rc, lo_n)
                hi_n = torch.where(extx >= W - 1, lo_rc + W - 1, hi_n)
            ext_n = hi_n - lo_n

            def read(vals, slot, dk):
                if slot < 0:
                    return torch.full((B, W), NULL, dtype=torch.int32)
                rel = (lo_n - win_lo[slot])[:, None] + jr + dk
                return engine_torch._window_gather(vals, rel, win_ext[slot][:, None])

            i_open, d_open = read(Moe, soe, -1), read(Moe, soe, 1)
            i_ext, d_ext = read(Ie, se, -1), read(De, se, 1)
            x_off = read(Mx, sx, 0)
            k = lo_n[:, None] + jr
            cells = live[:, None] & (jr[None, :] <= ext_n[:, None])
        else:
            k = (jr - W2)[None, :].expand(B, W)
            lo_n = torch.full((B,), -W2)

            def shifted(vals, dk, rad, out):
                """vals at lane j + dk, masked by the parent's cone; NULL
                past the window's ends."""
                got = torch.roll(vals, -dk, dims=1)
                got = torch.where((k + dk).abs() <= rad, got, out)
                edge = jr + dk
                return torch.where(((edge < 0) | (edge >= W))[None, :], NULL, got)

            i_open, d_open = shifted(Moe, -1, rad_oe, NULL), shifted(Moe, 1, rad_oe, NULL)
            i_ext = shifted(Ie, -1, rad_e, NULL if se < 0 else i_reset)
            d_ext = shifted(De, 1, rad_e, NULL)
            x_off = shifted(Mx, 0, rad_x, NULL)
            cells = live[:, None] & (k.abs() <= min(r_d, W2))
        i_pb = torch.maximum(_pack(i_open + 1, 1), _pack(i_ext + 1, 2))
        d_pb = torch.maximum(_pack(d_open, 1), _pack(d_ext, 2))
        m_pb = torch.maximum(torch.maximum(_pack(x_off + 1, 2), _pack(d_pb >> 2, 3)),
                             _pack(i_pb >> 2, 1))
        m_new = _extend(m_pb >> 2, k, patp, txtp, p2, t2)
        near_r[near_out] = torch.where(cells & in_c, m_new, near_r[near_out])
        far_r[oslot] = torch.where(cells, m_new, far_r[oslot])
        gap_i[gap_out] = torch.where(cells, i_pb >> 2, gap_i[gap_out])
        gap_d[gap_out] = torch.where(cells, d_pb >> 2, gap_d[gap_out])
        words[d >> 3] |= torch.where(cells, _choice(m_pb, i_pb, d_pb).long(), 0) << 4 * (d & 7)
        if banded:
            win_lo[oslot] = torch.where(live, lo_n, win_lo[oslot])
            win_ext[oslot] = torch.where(live, ext_n, win_ext[oslot])
            lo_trace[:, d] = torch.where(live, lo_n, lo_trace[:, d])
            rel = target_k - lo_n
            inside = (rel >= 0) & (rel <= ext_n)
        else:
            rel = target_k + W2
            inside = (rel >= 0) & (rel < W) & (target_k.abs() <= r_d)
        m_now = m_read(near_r[near_out], oslot)
        m_at_t = torch.where(
            inside, m_now.gather(1, rel.clamp(0, W - 1).long()[:, None])[:, 0], NULL)
        reach = target_k.abs() <= d
        hit = reach & (m_at_t == tlen)
        stop = live & (hit | (reach & (m_at_t > tlen) if banded else hit))
        finished = finished | (stop & hit)
        dist = torch.where(stop, d, dist)
        done = done | stop
        if late:
            prefetch(s + 1, (s + 1) & 1)
    dist = torch.where(valid & ~done, unfinished, dist)
    return torch.where(valid, dist, 0), finished, words, lo_trace


def _batch(pen, seed, n=12, lo=30, hi=120):
    rng = np.random.default_rng(seed)
    pairs = EDGE_PAIRS[:6] + random_pairs(rng, n, lo, hi, 0.1, n_rate=0.0,
                                          empty_rate=0.0)
    nw = hi // 16 + 2
    pat, plen, vp = pack_batch([p for p, _ in pairs], nw)
    txt, tlen, vt = pack_batch([t for _, t in pairs], nw)
    packed = (pat, plen, txt, tlen, vp & vt)
    return packed, engine_torch.batch_to_tensors(*packed, "cpu")


# (penalties, max_steps): the working sets of the large-working-set phase,
# (70,6,2) just past 64, (3,200,1) whose far parent is o + e, (100,90,10)
# with x = o + e, and (100,0,100), whose every step's far parent is the
# score before (the copy after the barrier).
PENS = [((600, 6, 2), 150), ((580, 6, 2), 150), ((70, 6, 2), 120),
        ((3, 200, 1), 40), ((100, 90, 10), 60), ((100, 0, 100), 30)]


@pytest.mark.parametrize("banded", [False, True], ids=["exact", "banded"])
@pytest.mark.parametrize("cigar", [False, True], ids=["distance", "cigar"])
@pytest.mark.parametrize("pen,max_steps", PENS, ids=["-".join(map(str, p)) for p, _ in PENS])
def test_compact_ring_equals_plain_and_xla(pen, max_steps, banded, cigar):
    """The compact ring's loop at centres 0, 32, W/2 and W equals the plain
    engine and wfa_tpu's XLA engine: distances and flags and, with CIGAR
    tables, every choice nibble a walk reads (exact: on the cone) and
    lo_trace."""
    penalties = Penalties(*pen)
    assert penalties.active_working_set >= engine_cuda.COMPACT_MIN_A
    W = 128 if banded else 256
    band = 10 if banded else -1
    packed, args = _batch(penalties, sum(pen) + 2 * banded + cigar)
    sched = build_schedule(penalties, max_steps, None)
    cap = sched.unfinished_score + 1
    cfg = engine_torch.EngineConfig(
        penalties, max_steps, W, band, score_limit=cap - 1 if cigar else None,
        compute_cigar=cigar, ring_global=True)
    xcfg = XlaConfig(penalties=wfa_tpu.Penalties(*pen), max_steps=max_steps,
                     wf_width=W, compute_cigar=cigar, band=band,
                     score_limit=cfg.score_limit)
    pat, plen, txt, tlen, valid = packed
    out_x = xla_align(xcfg, jnp.asarray(pat), jnp.asarray(txt), jnp.asarray(plen),
                      jnp.asarray(tlen), jnp.asarray(valid))
    dist_x = torch.from_numpy(np.asarray(out_x["distance"]))
    fin_x = torch.from_numpy(np.asarray(out_x["finished"]))
    if cigar:
        plain = engine_torch.cigar_tables(cfg, cap, *args)
        xla_words, xla_lo = engine_torch.choices_to_words(
            {"choices": torch.from_numpy(np.asarray(out_x["choices"])),
             "lo_trace": torch.from_numpy(np.asarray(out_x["lo_trace"]))},
            build_schedule(penalties, max_steps, cfg.score_limit), cap, W)
        xla_tables = {"choice_words": xla_words, "lo_trace": xla_lo}
        assert engine_torch.tables_equal(cfg, cap, plain, xla_tables)
    else:
        plain = engine_torch.align_batch_device(cfg, *args)
    assert torch.equal(plain["distance"], dist_x)
    assert torch.equal(plain["finished"], fin_x)
    for centre in (0, 32, W // 2, W):
        dist, fin, words, lo = compact_engine(cfg, cap, *args, centre=centre,
                                              seed=centre)
        assert torch.equal(dist, plain["distance"]), centre
        assert torch.equal(fin, plain["finished"]), centre
        if cigar:
            got = {"choice_words": words.to(torch.int32), "lo_trace": lo}
            assert engine_torch.tables_equal(cfg, cap, plain, got, cone=not banded)
            assert engine_torch.tables_equal(cfg, cap, xla_tables | {
                "window_ext": plain["window_ext"], "distance": plain["distance"],
                "finished": plain["finished"]}, got, cone=not banded)
    assert int(fin_x.sum()) >= 6


def _slot_trace(pen, max_steps):
    """Replays the compact table on scores alone: each ring slot holds the
    score last written to it, each staging row the score copied into it,
    read when the kernel reads it.  Returns the list of (what, expected,
    found) of every read that found another score."""
    A = pen.active_working_set
    near, gap, far_mask = engine_cuda.compact_slots(pen)
    rows, num_steps, _, _ = engine_cuda._schedule_rows(pen, max_steps, None, CPU, True)
    tab = rows.tolist()
    x, oe, e = pen.x, pen.o + pen.e, pen.e
    near_s, gap_s, far_s, stage = [None] * near, [None] * gap, [None] * A, [None, None]
    near_s[0] = far_s[0] = 0
    bad = []

    def prefetch(s, buf):
        if s < num_steps:
            aslot = tab[s][2] if far_mask & 1 else tab[s][3]
            if aslot >= 0:
                stage[buf] = far_s[aslot]

    prefetch(0, 0)
    for s in range(num_steps):
        d, oslot, sx, soe, se = tab[s][:5]
        near_out, gap_out, near_in, gap_in = tab[s][7:11]
        late = s + 1 < num_steps and tab[s + 1][0] - (A - 1) == d
        if not late:
            prefetch(s + 1, (s + 1) & 1)
        for slot, delta, bit in ((sx, x, 1), (soe, oe, 2)):
            if slot < 0:
                continue
            found = stage[s & 1] if far_mask & bit else near_s[near_in]
            if found != d - delta:
                bad.append((f"M[d-{delta}] at {d}", d - delta, found))
            if far_s[slot] != d - delta:   # its edges, from the far ring
                bad.append((f"far M[d-{delta}] at {d}", d - delta, far_s[slot]))
        if se >= 0 and gap_s[gap_in] != d - e:
            bad.append((f"I/D[d-{e}] at {d}", d - e, gap_s[gap_in]))
        near_parent = soe if far_mask == 1 else sx if far_mask == 2 else -1
        if (near_parent >= 0 and near_out == near_in) or (se >= 0 and gap_out == gap_in):
            bad.append((f"score {d} writes a slot it reads", None, None))
        near_s[near_out], gap_s[gap_out], far_s[oslot] = d, d, d
        if late:
            prefetch(s + 1, (s + 1) & 1)
    return bad


def test_no_slot_is_overwritten_before_its_last_read():
    """Fuzzed over (x, o, e) with A in 65..1000, and the x = o + e and
    largest-e corners: every parent read finds the score it asks for, in
    its near, gap, far or staging slot, and no step writes a slot that it
    reads."""
    rng = np.random.default_rng(65)
    pens = [Penalties(100, 90, 10), Penalties(100, 0, 100), Penalties(69, 0, 70),
            Penalties(64, 1, 1), Penalties(3, 200, 1), Penalties(600, 6, 2)]
    while len(pens) < 160:
        x, o, e = (int(v) for v in rng.integers(1, 1000, 3))
        pen = Penalties(x, int(o) % 300, e % 120 + 1)
        if 65 <= pen.active_working_set <= 1000:
            pens.append(pen)
    late = 0
    for pen in pens:
        assert _slot_trace(pen, 60) == [], pen
        tab = engine_cuda._schedule_rows(pen, 60, None, CPU, True)[0][:, 0].tolist()
        late += any(b - a == pen.active_working_set - 1 for a, b in zip(tab, tab[1:]))
    assert late >= 1   # (100,0,100): scores 0, 100, 200, ...


def test_compact_slots_and_columns():
    """The slots and the table: (600,6,2) reads M at d-8 near (9 slots) and
    d-600 far; (3,200,1) M at d-3 near (4 slots) and d-201 far; (100,90,10)
    both M parents far (1 near slot); e + 1 gap slots; at A <= 64 none."""
    assert engine_cuda.compact_slots(Penalties(600, 6, 2)) == (9, 3, 1)
    assert engine_cuda.compact_slots(Penalties(3, 200, 1)) == (4, 2, 2)
    assert engine_cuda.compact_slots(Penalties(100, 90, 10)) == (1, 11, 3)
    assert engine_cuda.compact_slots(Penalties(63, 6, 2)) is None
    assert engine_cuda.compact_slots(Penalties(64, 6, 2)) == (9, 3, 1)
    pen = Penalties(600, 6, 2)
    rows, n, _, _ = engine_cuda._schedule_rows(pen, 80, None, CPU, True)
    plain, _, _, _ = engine_cuda._schedule_rows(pen, 80, None, CPU)
    assert rows.shape == (n, 14) and torch.equal(rows[:, :7], plain)
    d = rows[:, 0]
    assert torch.equal(rows[:, 7], d % 9) and torch.equal(rows[:, 8], d % 3)
    has_oe = rows[:, 3] >= 0
    assert torch.equal(rows[:, 9], torch.where(has_oe, (d - 8) % 9, 0))
    assert torch.equal(rows[:, 10], torch.where(rows[:, 4] >= 0, (d - 2) % 3, 0))
    assert (rows[:, 11] == -1).all()          # no M[d-600] below score 600
    assert torch.equal(rows[:, 12] >= 0, has_oe)


# The shapes of tests/test_torch_large_a.py at (600,6,2): (name, window,
# packed words a row, cigar, compact centre on an H100).
SHAPES = [
    ("100bp-exact-distance", 384, 9, False, 384),
    ("1kbp-exact-distance", 2176, 65, False, 2176),
    ("1kbp-exact-cigar", 2176, 65, True, 2176),
    ("10kbp-exact-cigar-e3000", 6016, 1025, True, 2848),
    ("20kbp-banded-distance", 1024, 2049, False, 1024),
    ("20kbp-banded-cigar", 1024, 2049, True, 1024),
]


@pytest.mark.parametrize("name,W,nw,cigar,centre", SHAPES, ids=[s[0] for s in SHAPES])
def test_compact_centre_ring_bytes_and_call_batches(name, W, nw, cigar, centre):
    """At A = 601 the compact ring has 17 rows a centre diagonal (9 near,
    3 + 3 gap, 2 staging), 68 bytes: the whole window fits up to W = 2176
    (10 kbp exact CIGARs: 2,848 of 6,016 diagonals).  Its global memory is
    the far ring, 4 A W bytes a pair, plus 4 x 6 (W - C) of I and D edges,
    so a launch holds a third more pairs than the whole ring's 12 A W."""
    pen = Penalties(600, 6, 2)
    assert engine_cuda.centre_width(pen, W, nw, cigar, H100_SMEM) == centre
    fixed = 4 * (2 * 601 + 66 + (W if cigar else 0) + 2 * (nw + 1))
    assert engine_cuda.smem_bytes(pen, W, cigar, True, centre, nw) == fixed + 68 * centre
    assert fixed + 68 * centre <= H100_SMEM
    assert centre == W or H100_SMEM < fixed + 68 * (centre + 32)
    ring = engine_cuda.ring_bytes(pen, W, centre)
    assert ring == 4 * 601 * W + 24 * (W - centre)
    opts = AlignmentOptions(penalties=pen, compute_cigar=cigar)
    if cigar:
        got = _cigar_call_batch(opts, 4000, W, ring)
        per_lane = engine_torch.num_chunks(4000) * W * 4 + ring
        assert got == min(4096, (1 << 30) // per_lane)
    else:
        assert _distance_call_batch(opts, ring) == (1 << 30) // ring


def test_planner_routes_every_large_a_k4_launch_to_the_compact_ring():
    """From A = 65 on, a window past the shared ring takes K4 (the compact
    ring); at 64 the whole ring stays; the 1 kbp tier at (600,6,2) then
    holds 205 pairs a launch against the whole ring's 68."""
    for x, compact in ((63, False), (64, True), (600, True)):
        pen = Penalties(x, 6, 2)
        limit = 2 * pen.o + pen.e * 2 * 1026 + pen.x
        plan = _TierPlan(1024, [0], 2 * 1026 + 1, 8, 65, limit)
        opts = AlignmentOptions(penalties=pen, max_error=3000)
        cfg = _tier_geometry_cuda(plan, opts, 3000, -1, H100_SMEM)[0]
        assert cfg.ring_global
        assert (engine_cuda._compact_args(cfg)[0] > 0) == compact
    pen = Penalties(600, 6, 2)
    ring = engine_cuda.ring_bytes(pen, 2176, 2176)
    assert ring == 4 * 601 * 2176 == 5_231_104
    assert _distance_call_batch(AlignmentOptions(penalties=pen), ring) == 205
    assert (1 << 30) // (12 * 601 * 2176) == 68
