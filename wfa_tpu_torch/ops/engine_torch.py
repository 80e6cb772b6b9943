"""Batched gap-affine WFA engine in plain PyTorch.

A line-for-line port of ``wfa_tpu/ops/engine_xla.py``: the same
host-precomputed schedule (``wfa_tpu_torch.schedule.build_schedule``), the
same ``(offset << 2) | op`` tie-breaking, the same exact and adaptive-band
windows, and in CIGAR mode the same per-step ``choices`` and ``lo_trace``.
On the same packed inputs its outputs equal ``engine_xla.align_batch_device``
in every lane.

It is the CPU engine of the port and the plain version of the hand-written
CUDA kernels of ``ops/csrc/wfa_distance.cu``: K1 must equal
``align_batch_device`` in every lane, and K2 must equal ``cigar_tables`` (this
engine plus ``choices_to_words``, the relayout into the Pallas kernel's
by-score table) wherever a backward walk can read (in exact mode, on each
score's cone: ``readable_masks``).  K4, the same kernels with the wavefront
ring's edges in global memory (``EngineConfig.ring_global``, exact or
banded), must equal the same two functions at the same config: this engine
has no shared memory, so it ignores the flag.  Unlike the TPU kernel it has no limit on
the working set.

Torch specifics:

* ``torch.uint32`` lacks shifts, ``gather`` and comparisons on the CPU, so
  packed words are held as ``int64`` in ``0 .. 2**32 - 1`` and masked to 32
  bits after every left shift.
* Torch has no ``clz``: ``torch.frexp`` of the word as a double gives its bit
  length exactly for values below ``2**32``, and ``clz = 32 - bitlen``.
* ``_pack`` is ``off * 4 + op`` (equal to ``(off << 2) | op`` in two's
  complement) and NULL-derived offsets such as ``OFFSET_NULL + 1`` are
  carried through exactly as XLA does, never clamped back to NULL.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..schedule import WavefrontSchedule, build_schedule, cone_radii
from ..types import OFFSET_NULL, AffineOp, Penalties

INT32_MAX = 2**31 - 1
_MASK32 = 0xFFFFFFFF
# Window bounds standing in for a missing parent (engine_xla.py:291-296).
_BIG = 2**20
# 16-base chunks the plain extension compares per loop iteration.
_CHUNKS = 8
_LANE = 128

# Choice encoding of the CIGAR mode (engine_xla.py:50-55).
M_FROM_X = 0
M_FROM_I = 1
M_FROM_D = 2
I_FROM_EXTEND_BIT = 2
D_FROM_EXTEND_BIT = 3


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine configuration for one batch shape."""

    penalties: Penalties
    max_steps: int          # reference `max_error` / max_steps
    wf_width: int           # W: number of diagonals held per wavefront
    band: int = -1          # <0: exact; >0: re-center every `band` scores
    # Optional cap on the highest score the schedule enumerates (see
    # wfa_tpu.ops.engine_xla.EngineConfig.score_limit).
    score_limit: int | None = None
    # Also return the per-step backtrace choices and window bases.
    compute_cigar: bool = False
    # On the CUDA kernels, keep only part of the M/I/D ring in shared memory
    # and its edges in global memory (K4), for windows wider than a block's
    # shared memory holds: exact (PallasConfig.ring_hbm) or banded (where
    # wfa_tpu runs its XLA engine).  The plain engine ignores it.
    ring_global: bool = False

    @property
    def banded(self) -> bool:
        return self.band > 0


def config_from_tpu(cfg) -> EngineConfig:
    """This package's config from a ``wfa_tpu`` ``EngineConfig`` or
    ``PallasConfig`` (duck-typed, so jax is never imported).

    A Pallas ``score_cap`` stops the loop at ``d < score_cap``, which is the
    schedule's ``score_limit = score_cap - 1``; 0 means no cap.  Its
    ``ring_hbm`` becomes ``ring_global``."""
    if hasattr(cfg, "score_limit"):
        limit = cfg.score_limit
    else:
        cap = getattr(cfg, "score_cap", 0)
        limit = cap - 1 if cap > 0 else None
    return EngineConfig(
        penalties=cfg.penalties,
        max_steps=cfg.max_steps,
        wf_width=cfg.wf_width,
        band=cfg.band,
        score_limit=limit,
        compute_cigar=cfg.compute_cigar,
        ring_global=getattr(cfg, "ring_hbm", False),
    )


def batch_to_tensors(pat_w, plen, txt_w, tlen, valid, device):
    """``pack_batch`` output (numpy) -> ``(pat, txt, plen, tlen, valid)``
    tensors on ``device``, in the argument order of ``align_batch_device``.

    Packed words keep their u32 bit patterns in ``int32`` tensors, the type
    the CUDA kernel reads."""
    def words(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))

    def ints(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32))

    return (
        words(pat_w).to(device),
        words(txt_w).to(device),
        ints(plen).to(device),
        ints(tlen).to(device),
        torch.from_numpy(np.ascontiguousarray(valid, np.bool_)).to(device),
    )


def _pack(offset: torch.Tensor, op: int) -> torch.Tensor:
    """(offset, op) -> int whose order is lexicographic: ``(offset << 2) | op``
    written without shifting a negative value."""
    return offset * 4 + op


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit words held in int64 (``clz(0) == 32``)."""
    _, bitlen = torch.frexp(x.to(torch.float64))
    return 32 - bitlen.to(torch.int64)


def _load16(words: torch.Tensor, row: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The 16 bases starting at base index ``pos`` (>= 0) of row ``row`` as
    one u32 in int64 (engine_xla.py:102-110).  ``words`` [B, NW+1] carries
    one zero pad word; indices past it read the pad word."""
    last = words.shape[1] - 1
    flat = words.view(-1)
    base = row * words.shape[1]
    idx = pos >> 4
    sh = 2 * (pos & 15)
    w1 = flat[base + torch.clamp(idx, max=last)]
    w2 = flat[base + torch.clamp(idx + 1, max=last)]
    hi = (w1 << sh) & _MASK32
    lo = torch.where(sh == 0, torch.zeros_like(w2), w2 >> (32 - sh))
    return hi | lo


def _tail_mask(nxt: torch.Tensor, limit: torch.Tensor) -> torch.Tensor:
    """Bits past the sequence end count as mismatches (engine_xla.py:112-118)."""
    sh = torch.clamp(2 * (nxt - limit), 0, 32)
    return torch.where(
        sh == 32, torch.zeros_like(sh),
        (torch.full_like(sh, _MASK32) << sh) & _MASK32,
    )


def _extend(offs, k, pat, txt, plen, tlen) -> torch.Tensor:
    """LCP extension over every diagonal of every alignment
    (engine_xla.py:84-145); offsets int32 [B, W], words int64 [B, NW+1],
    lengths int32 [B, 1].

    XLA iterates over the whole [B, W] block with an ``active`` mask, 16
    bases per iteration.  Here each iteration works on the still-active lanes
    only, compacted to a flat list, and compares ``_CHUNKS`` 16-base chunks
    at once: chunk c counts only if chunks 0..c-1 all matched in full, so
    the sums equal the sequential loop's, chunk for chunk."""
    v = (offs - k).to(torch.int64)
    shape = v.shape
    h = offs.to(torch.int64).expand_as(v)
    pl = plen.to(torch.int64).expand_as(v)
    tl = tlen.to(torch.int64).expand_as(v)
    invalid = (h < 0) | (v > pl) | (h > tl)
    active = ~invalid & (v < pl) & (h < tl)
    acc = torch.zeros(v.numel(), dtype=torch.int64, device=v.device)
    step = 16 * torch.arange(_CHUNKS, dtype=torch.int64, device=v.device)

    lane = active.flatten().nonzero().squeeze(1)
    row = lane // shape[1]
    v, h = v.flatten()[lane], h.flatten()[lane]
    pl, tl = pl.flatten()[lane], tl.flatten()[lane]
    while lane.numel():
        p2, t2 = pl[:, None], tl[:, None]
        vc = torch.minimum(torch.clamp(v[:, None] + step, min=0), p2)
        hc = torch.minimum(torch.clamp(h[:, None] + step, min=0), t2)
        diff = _load16(pat, row[:, None], vc) ^ _load16(txt, row[:, None], hc)
        diff = diff | (~_tail_mask(vc + 16, p2) & _MASK32)
        diff = diff | (~_tail_mask(hc + 16, t2) & _MASK32)
        eq = _clz32(diff) >> 1                          # [n, _CHUNKS]
        nfull = torch.cumprod((eq == 16).to(torch.int64), dim=1).sum(dim=1)
        part = torch.gather(eq, 1, torch.clamp(nfull, max=_CHUNKS - 1)[:, None])
        ext = 16 * nfull + torch.where(nfull < _CHUNKS, part[:, 0], 0)
        acc[lane] += ext
        v, h = v + ext, h + ext
        keep = ((nfull == _CHUNKS) & (v < pl) & (h < tl)).nonzero().squeeze(1)
        lane, row, v, h, pl, tl = (
            t[keep] for t in (lane, row, v, h, pl, tl)
        )
    out = offs + acc.view(shape).to(torch.int32)
    return torch.where(invalid, torch.full_like(offs, OFFSET_NULL), out)


def _shift_hi(row: torch.Tensor) -> torch.Tensor:
    """row[k-1] aligned under k (NULL on the left)."""
    return torch.nn.functional.pad(row[:, :-1], (1, 0), value=OFFSET_NULL)


def _shift_lo(row: torch.Tensor) -> torch.Tensor:
    """row[k+1] aligned under k (NULL on the right)."""
    return torch.nn.functional.pad(row[:, 1:], (0, 1), value=OFFSET_NULL)


def _window_gather(parent, rel, parent_extent) -> torch.Tensor:
    """Read a parent window at per-alignment shifted positions; outside
    ``[0, extent]`` reads NULL (engine_xla.py:166-177)."""
    oob = (rel < 0) | (rel > parent_extent)
    safe = torch.clamp(rel, 0, parent.shape[1] - 1).to(torch.int64)
    vals = torch.gather(parent, 1, safe)
    return torch.where(oob, torch.full_like(vals, OFFSET_NULL), vals)


def align_batch_device(
    cfg: EngineConfig,
    pat: torch.Tensor,    # [B, NW] int32 (u32 bit patterns) packed patterns
    txt: torch.Tensor,    # [B, NW] int32 packed texts
    plen: torch.Tensor,   # [B] int32
    tlen: torch.Tensor,   # [B] int32
    valid: torch.Tensor,  # [B] bool — False routes to the CPU fallback
) -> dict[str, torch.Tensor]:
    """Align one batch of B pairs on ``pat.device``; the plain version of K1
    and of K4 in distance mode (``cfg.ring_global`` changes nothing here).
    Returns ``distance``
    (int32 [B]) and ``finished`` (bool [B]), and in CIGAR mode ``choices``
    (uint8 [S, B, W], the 4-bit choice of step s at each window lane),
    ``lo_trace`` (int32 [S, B], the window base of step s) and
    ``ext_trace`` (int32 [S, B], its extent: lanes 0..ext are live), S the
    schedule's number of steps; steps after the loop ends stay 0.  XLA has
    no ``ext_trace``: it bounds the region a backward walk can read."""
    sched = build_schedule(cfg.penalties, cfg.max_steps, cfg.score_limit)
    device = pat.device
    A = cfg.penalties.active_working_set
    W = cfg.wf_width
    W2 = W // 2
    B = pat.shape[0]
    NULL = OFFSET_NULL
    i32 = dict(dtype=torch.int32, device=device)

    # One zero pad word so the two-word de-phased load stays in range.
    pad = torch.zeros((B, 1), dtype=torch.int64, device=device)
    patp = torch.cat([pat.to(torch.int64) & _MASK32, pad], dim=1)
    txtp = torch.cat([txt.to(torch.int64) & _MASK32, pad], dim=1)

    plen = plen.to(torch.int32)
    tlen = tlen.to(torch.int32)
    plen2 = plen[:, None]
    tlen2 = tlen[:, None]
    target_k = tlen - plen
    target_off = tlen
    tk_abs = target_k.abs()

    null_row = torch.full((B, W), NULL, **i32)
    M = torch.full((A, B, W), NULL, **i32)
    I = torch.full((A, B, W), NULL, **i32)
    D = torch.full((A, B, W), NULL, **i32)

    # Score 0: initial extension on diagonal 0, which lives at window index
    # 0 (banded) or W2 (exact) (engine_xla.py:235-248).
    zero = torch.zeros((B, 1), **i32)
    init_off = _extend(zero, zero, patp, txtp, plen2, tlen2)[:, 0]
    M[0, :, 0 if cfg.banded else W2] = init_off

    done = ((target_k == 0) & (init_off == target_off)) | ~valid
    finished = done & valid
    dist = torch.zeros(B, **i32)

    if cfg.banded:
        lo = torch.zeros((A, B), **i32)
        ext = torch.zeros((A, B), **i32)
    jrange = torch.arange(W, **i32)[None, :]
    exact_k = jrange - W2
    exact_lo = torch.full((B,), -W2, **i32)
    exact_ext = torch.full((B,), W - 1, **i32)
    if cfg.compute_cigar:
        S = sched.num_steps
        choices = torch.zeros((S, B, W), dtype=torch.uint8, device=device)
        lo_trace = torch.zeros((S, B), **i32)
        ext_trace = torch.zeros((S, B), **i32)

    for s in range(sched.num_steps):
        if bool(done.all()):
            break
        d = int(sched.score[s])
        oslot = int(sched.out_slot[s])
        sx = int(sched.mx_slot[s])
        soe = int(sched.moe_slot[s])
        se = int(sched.ide_slot[s])

        Mx = M[sx] if sx >= 0 else null_row
        Moe = M[soe] if soe >= 0 else null_row
        Ie = I[se] if se >= 0 else null_row
        De = D[se] if se >= 0 else null_row

        if cfg.banded:
            # New window bounds (engine_xla.py:289-309): grow, clamp to the
            # width shrinking hi first.
            def bounds(slot):
                if slot < 0:
                    big = torch.full((B,), _BIG, **i32)
                    return -big, big
                return lo[slot] + ext[slot], lo[slot]

            hi_x_b, lo_x_b = bounds(sx)
            hi_oe_b, lo_oe_b = bounds(soe)
            hi_e_b, lo_e_b = bounds(se)
            hi_n = torch.maximum(hi_x_b, torch.maximum(hi_oe_b, hi_e_b) + 1)
            lo_n = torch.minimum(lo_x_b, torch.minimum(lo_oe_b, lo_e_b) - 1)
            t = torch.clamp((hi_n - lo_n) - (W - 1), min=0)
            hi_n = hi_n - (t + 1) // 2
            lo_n = lo_n + t // 2

            # Re-center every `band` scores on MDI steps once the M[d-x]
            # window is at full width (engine_xla.py:311-334); the host-side
            # part of the condition skips the scan on other steps.
            if d % cfg.band == 0 and sx >= 0 and (soe >= 0 or se >= 0):
                lo_x, ext_x = lo[sx], ext[sx]
                kx = lo_x[:, None] + jrange
                d2t = torch.where(
                    Mx >= 0,
                    torch.maximum(plen2 - (Mx - kx), tlen2 - Mx),
                    INT32_MAX,
                )
                d2t = torch.where(jrange < ext_x[:, None], d2t, INT32_MAX)
                # argmin resolves ties to the first index, so the sentinel at
                # index 0 wins a tie and keeps the window at lo_x.
                cand = torch.cat([2 * (tlen2 + plen2), d2t], dim=1)
                amin = torch.argmin(cand, dim=1).to(torch.int32)
                lo_rc = lo_x + torch.clamp(amin - 1, min=0) - W2
                recenter = ext_x >= W - 1
                lo_n = torch.where(recenter, lo_rc, lo_n)
                hi_n = torch.where(recenter, lo_rc + W - 1, hi_n)
            ext_n = hi_n - lo_n

            # Parent reads at per-alignment shifted positions: child lane j
            # is diagonal lo_n + j (engine_xla.py:336-349).
            def read(parent, slot, dk):
                if slot < 0:
                    return null_row
                rel = (lo_n - lo[slot])[:, None] + jrange + dk
                return _window_gather(parent, rel, ext[slot][:, None])

            I_open = read(Moe, soe, -1) + 1
            I_ext = read(Ie, se, -1) + 1
            D_open = read(Moe, soe, +1)
            D_ext = read(De, se, +1)
            X_off = read(Mx, sx, 0) + 1
            k_lane = lo_n[:, None] + jrange
        else:
            lo_n, ext_n = exact_lo, exact_ext
            I_open = _shift_hi(Moe) + 1
            I_ext = _shift_hi(Ie) + 1
            D_open = _shift_lo(Moe)
            D_ext = _shift_lo(De)
            X_off = Mx + 1
            k_lane = exact_k

        # I/D/M recurrence with the reference's tie-breaking
        # (engine_xla.py:361-372).
        I_pb = torch.maximum(_pack(I_open, 1), _pack(I_ext, 2))
        D_pb = torch.maximum(_pack(D_open, 1), _pack(D_ext, 2))
        I_new = I_pb >> 2
        D_new = D_pb >> 2
        M_pb = torch.maximum(
            torch.maximum(
                _pack(X_off, int(AffineOp.SUB)), _pack(D_new, int(AffineOp.DEL))
            ),
            _pack(I_new, int(AffineOp.INS)),
        )
        M_new = _extend(M_pb >> 2, k_lane, patp, txtp, plen2, tlen2)

        if cfg.banded:
            lane_live = jrange <= ext_n[:, None]
            I_new = torch.where(lane_live, I_new, NULL)
            D_new = torch.where(lane_live, D_new, NULL)
            M_new = torch.where(lane_live, M_new, NULL)

        # Termination, plus the banded overshoot rule (engine_xla.py:379-396).
        m_at_t = _window_gather(
            M_new, (target_k - lo_n)[:, None], ext_n[:, None]
        )[:, 0]
        reachable = tk_abs <= d
        hit = reachable & (m_at_t == target_off)
        stop = (reachable & (m_at_t >= target_off)) if cfg.banded else hit
        newly = stop & ~done
        finished = torch.where(newly, hit, finished)
        dist = torch.where(newly, d, dist)
        done = done | newly

        # Commit to the ring, except for lanes that were already done: their
        # final wavefronts stay frozen (engine_xla.py:398-422), which keeps
        # the choices recorded for them equal to XLA's.
        live = ~done[:, None] | newly[:, None]
        M[oslot] = torch.where(live, M_new, M[oslot])
        I[oslot] = torch.where(live, I_new, I[oslot])
        D[oslot] = torch.where(live, D_new, D[oslot])
        if cfg.banded:
            lo[oslot] = torch.where(live[:, 0], lo_n, lo[oslot])
            ext[oslot] = torch.where(live[:, 0], ext_n, ext[oslot])
        if cfg.compute_cigar:
            choices[s] = _choice(M_pb, I_pb, D_pb)
            lo_trace[s] = lo_n
            ext_trace[s] = ext_n

    # Lanes that ran out of steps: unfinished, score = last score + 1
    # (engine_xla.py:456-462).
    timed_out = valid & ~done
    dist = torch.where(timed_out, sched.unfinished_score, dist)
    finished = finished & ~timed_out & valid
    dist = torch.where(valid, dist, 0)
    out = {"distance": dist, "finished": finished}
    if cfg.compute_cigar:
        out["choices"] = choices
        out["lo_trace"] = lo_trace
        out["ext_trace"] = ext_trace
    return out


def _choice(M_pb, I_pb, D_pb) -> torch.Tensor:
    """4-bit backtrace choice of each lane (engine_xla.py:424-433): M's
    winning op SUB/INS/DEL -> from X/I/D, plus the I and D gap-extend bits."""
    m_op = M_pb & 3
    m_choice = torch.where(
        m_op == int(AffineOp.SUB), M_FROM_X,
        torch.where(m_op == int(AffineOp.INS), M_FROM_I, M_FROM_D),
    )
    ch = (
        m_choice
        | (((I_pb & 3) == 2).to(torch.int32) << I_FROM_EXTEND_BIT)
        | (((D_pb & 3) == 2).to(torch.int32) << D_FROM_EXTEND_BIT)
    )
    return ch.to(torch.uint8)


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def num_chunks(score_cap: int) -> int:
    """Rows of the by-score choice table: 8 scores per int32 word, plus one
    slack row (engine_pallas.py:196-198)."""
    return score_cap // 8 + 2


def lo_pad(score_cap: int) -> int:
    """Length of the banded by-score ``lo_trace`` (engine_pallas.py:200-203)."""
    return _round_up(score_cap + 2 * _LANE, _LANE)


def choices_to_words(
    out: dict[str, torch.Tensor], sched: WavefrontSchedule, score_cap: int,
    W: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Relayout the per-step ``choices``/``lo_trace`` of ``align_batch_device``
    into the Pallas kernel's by-score layout (the relayout of
    tests/test_pallas.py:17-31, at the kernel's table size).

    Returns ``words`` int32 [score_cap//8 + 2, B, W], the 4-bit choice of
    score d at nibble ``d & 7`` of row ``d >> 3`` and 0 for scores the
    schedule skips, and ``lo`` int32 [B, lo_pad(score_cap)], the window base
    of score d at column d."""
    choices, lo_tr = out["choices"], out["lo_trace"]
    S, B, _ = choices.shape
    device = choices.device
    scores = torch.from_numpy(sched.score[:S]).to(device=device, dtype=torch.int64)
    if S and int(sched.score[S - 1]) >= score_cap:
        raise ValueError(
            f"schedule reaches score {int(sched.score[S - 1])}, past the table's "
            f"score_cap {score_cap}"
        )
    words = torch.zeros((num_chunks(score_cap), B, W), dtype=torch.int32,
                        device=device)
    # A row holds at most one score per nibble, so each nibble's rows are
    # distinct and one indexed update per nibble places them.
    for nib in range(8):
        sel = (scores & 7) == nib
        rows = scores[sel] >> 3
        words[rows] |= choices[sel].to(torch.int32) << (4 * nib)
    lo = torch.zeros((B, lo_pad(score_cap)), dtype=torch.int32, device=device)
    lo[:, scores] = lo_tr.T
    return words, lo


def cigar_tables(
    cfg: EngineConfig, score_cap: int, pat, txt, plen, tlen, valid,
) -> dict[str, torch.Tensor]:
    """The plain version of K2, and of K4 in CIGAR mode (``cfg.ring_global``
    changes nothing here): ``distance``, ``finished``, ``choice_words``
    [score_cap//8 + 2, B, W] and, banded, ``lo_trace`` [B, lo_pad] — the
    outputs of ``engine_pallas.align_batch_pallas`` with ``compute_cigar``
    and of ``engine_cuda.cigar_tables_cuda``.  ``cfg`` runs the schedule up
    to ``score_cap - 1``.  It also gives ``window_ext`` [B, lo_pad], the
    window extent of each score, for ``readable_masks``."""
    cfg = dataclasses.replace(cfg, compute_cigar=True)
    out = align_batch_device(cfg, pat, txt, plen, tlen, valid)
    sched = build_schedule(cfg.penalties, cfg.max_steps, cfg.score_limit)
    words, lo = choices_to_words(out, sched, score_cap, cfg.wf_width)
    ext = torch.zeros_like(lo)
    S = out["ext_trace"].shape[0]
    ext[:, torch.from_numpy(sched.score[:S]).to(lo.device, torch.int64)] = (
        out["ext_trace"].T
    )
    res = {"distance": out["distance"], "finished": out["finished"],
           "choice_words": words, "window_ext": ext}
    if cfg.banded:
        res["lo_trace"] = lo
    return res


def readable_masks(
    cfg: EngineConfig, score_cap: int, plain: dict[str, torch.Tensor],
    cone: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Where a backward walk can read K2's tables, from the plain version's
    ``cigar_tables`` output: for each finished lane of nonzero distance, the
    scheduled scores 1..distance and, at each, the diagonals of that score's
    window (lanes 0..window_ext).  Elsewhere the tables may differ: K2 stops
    at its own alignment's distance and computes no choice outside the
    window, while the plain engine and the Pallas kernel run on.  With
    ``cone`` (exact mode), only the diagonals of each score's cone, the
    lanes W/2 +- radius of ``schedule.cone_radii``: the exact kernels
    compute no others, and no walk reads outside them.

    Returns (int64 [C, B, W] bit mask of the readable nibbles of each table
    word, bool [B, lo_pad] mask of the readable ``lo_trace`` columns)."""
    sched = build_schedule(cfg.penalties, cfg.max_steps, cfg.score_limit)
    words, ext = plain["choice_words"], plain["window_ext"]
    C, B, W = words.shape
    device = words.device
    scores = torch.from_numpy(sched.score).to(device=device, dtype=torch.int64)
    walked = plain["finished"] & (plain["distance"] > 0)
    # live[s, b]: score s is on lane b's walkable range.
    live = walked[None, :] & (scores[:, None] <= plain["distance"][None, :].long())
    jr = torch.arange(W, device=device)
    if cone and not cfg.banded:
        radius, _ = cone_radii(cfg.penalties, cfg.max_steps, cfg.score_limit)
        radius = torch.tensor(radius, device=device, dtype=torch.int64)
        # [S, W]: lane j lies in the cone of step s.
        in_cone = (jr[None, :] - W // 2).abs() <= radius[:, None]
    mask = torch.zeros((C, B, W), dtype=torch.int64, device=device)
    for nib in range(8):
        sel = (scores & 7) == nib
        if cone and not cfg.banded:
            in_win = in_cone[sel][:, None, :]
        else:
            in_win = jr[None, None, :] <= ext[:, scores[sel]].T[:, :, None]
        cells = live[sel][:, :, None] & in_win
        mask[scores[sel] >> 3] |= cells.to(torch.int64) << (4 * nib)
    lo_mask = torch.zeros(ext.shape, dtype=torch.bool, device=device)
    lo_mask[:, scores] = live.T
    return mask, lo_mask


def tables_equal(
    cfg: EngineConfig, score_cap: int, plain: dict[str, torch.Tensor],
    other: dict[str, torch.Tensor], cone: bool = False,
) -> bool:
    """Whether ``other`` (K2's, K4's or the Pallas kernel's tables) equals
    the plain version's ``cigar_tables`` on the readable region; ``cone``
    narrows an exact one to the cone (``readable_masks``), for the exact
    CUDA kernels."""
    mask, lo_mask = readable_masks(cfg, score_cap, plain, cone)
    a = plain["choice_words"].to(torch.int64)
    b = other["choice_words"].to(device=a.device, dtype=torch.int64)
    if bool(((a ^ b) & mask).any()):
        return False
    if cfg.banded:
        lo_a = plain["lo_trace"]
        lo_b = other["lo_trace"].to(lo_a.device)[:, : lo_a.shape[1]]
        return bool((lo_a[lo_mask] == lo_b[lo_mask]).all())
    return True
