"""Wrappers of the CUDA kernels: K1, K2 and K4 (``csrc/wfa_distance.cu``)
and K3 (``csrc/wfa_traceback.cu``).

``align_batch_cuda`` (K1) takes the tensors of
``engine_torch.align_batch_device`` and returns the same outputs.
``cigar_tables_cuda`` (K2) returns those of ``engine_torch.cigar_tables``,
``traceback_cuda`` (K3) those of ``traceback_torch.traceback_batch_device``,
and ``align_cigar_cuda`` launches K2 then K3 and returns the fused rows of
``traceback_torch.align_cigar_fused``.  With ``cfg.ring_global`` the first
two and ``align_cigar_cuda`` launch K4 in place of K1 and K2, exact or
banded: the same outputs, with ``centre_width`` lanes of the ring in shared
memory (exact: the diagonals around W/2; banded: the window's first lanes;
none where a large working set leaves no room for 32) and its edges in a
global scratch buffer.  At working sets above 64 (``COMPACT_MIN_A``) K4
keeps the compact ring (``compact_slots``): M's near slots, the I and D rings
of e + 1 slots and two staging rows in shared memory, and only M's far ring
of A slots, written every score and read at one slot, in global memory.
K1 and K2 stage the two packed rows in shared memory where they fit beside
the ring (``rows_fit``, host arithmetic before the launch) and read them from
global memory where they do not.  K3 walks each alignment with one warp, two walks
a block (``TRACEBACK_WARPS``), with the current choice row's window in
registers and the next three rows' copied ahead into shared memory.  On CPU tensors each runs its plain version; on
CUDA tensors it launches its kernel on the current stream or raises — it
never falls back.  ``LAUNCHES`` counts each kernel's launches (banded K4
apart from exact K4: ``*_ring_banded``; the compact ring's among them again
as ``*_compact``), and K1's and K2's by row placement
(``rows_shared``, ``rows_global``), so a run can show that its main path
went through the kernels; the counts are exact when several threads launch
at once.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from ..schedule import build_schedule, cone_radii
from ..types import Penalties
from ..utils.timers import TRACE
from . import engine_torch, traceback_torch
from ._build import check, check_inputs, load_library
from .engine_torch import EngineConfig
from .traceback_torch import TracebackConfig

LAUNCHES = {
    "wfa_distance": 0, "wfa_cigar": 0, "wfa_traceback": 0,
    "wfa_distance_ring": 0, "wfa_cigar_ring": 0,
    "wfa_distance_ring_banded": 0, "wfa_cigar_ring_banded": 0,
    "wfa_distance_compact": 0, "wfa_cigar_compact": 0,
    "rows_shared": 0, "rows_global": 0,
}
_LAUNCHES_LOCK = threading.Lock()

_SCRATCH_INTS = 66  # kScratchInts in csrc/wfa_distance.cu
TRACEBACK_WARPS = 2  # K3's walks (warps) a block
CENTRE_GRANULE = 32  # kCentreGranule: K4's centre is a multiple of it
# K4 keeps the compact ring from this working set on: wfa_tpu's Pallas
# kernel takes at most 64 (its bitmasks), where the whole ring stays.
COMPACT_MIN_A = 65


def compact_slots(penalties: Penalties) -> tuple[int, int, int] | None:
    """K4's compact ring for ``penalties``, None at A <= 64: (M's near
    slots, each gap ring's slots, far mask).  M is read at d - x and
    d - o - e; the nearer of the two, n = min(x, o+e), needs n + 1 slots, the
    far one (A - 1 scores back) comes from global memory; where x = o + e
    both are far and the near ring keeps only the score being computed
    (1 slot).  I and D are read at d - e: e + 1 slots.  Far mask bit 0: M[d-x]
    is far, bit 1: M[d-o-e]."""
    A = penalties.active_working_set
    if A < COMPACT_MIN_A:
        return None
    x, oe = penalties.x, penalties.o + penalties.e
    far = (1 if x == A - 1 else 0) | (2 if oe == A - 1 else 0)
    return (1 if x == oe else min(x, oe) + 1), penalties.e + 1, far


def _layout(ring) -> tuple[int, int, int, int]:
    """K4's ring for ``ring``, the penalties (or, at A <= 64, the working
    set A): (A, rows a diagonal in shared memory, edge rows a diagonal
    outside the centre, far-ring rows of all W).  The whole ring: 3A, 3A, 0;
    the compact ring: near + 2 gap + 2 staging rows, 2 gap rows, A."""
    if isinstance(ring, Penalties):
        A = ring.active_working_set
        slots = compact_slots(ring)
        if slots is not None:
            near, gap, _ = slots
            return A, near + 2 * gap + 2, 2 * gap, A
        return A, 3 * A, 3 * A, 0
    if ring >= COMPACT_MIN_A:
        raise ValueError(f"K4 at A={ring} takes the compact ring: pass the penalties")
    return ring, 3 * ring, 3 * ring, 0


def smem_bytes(ring, width: int, cigar: bool = False,
               ring_global: bool = False, centre: int = 0,
               nwords: int | None = None) -> int:
    """Shared memory of one block: the [3A, W] int32 ring (K4: only its
    [rows, centre] centre, ``_layout``), the per-slot window base and
    extent, the argmin scratch, in CIGAR mode one choice row word per
    diagonal and, where the block stages them (``nwords`` given: K4 always,
    K1/K2 when ``rows_fit``), the two packed rows of ``nwords`` words, each
    with a zero word after it (csrc smem_bytes).  ``ring`` is the working
    set A, or for K4 the penalties (required above A = 64)."""
    if ring_global:
        A, rows, _, _ = _layout(ring)
    else:
        A = ring.active_working_set if isinstance(ring, Penalties) else ring
        rows = 3 * A
    ring_ints = rows * (centre if ring_global else width)
    seq = 0 if nwords is None else 2 * (nwords + 1)
    return 4 * (ring_ints + 2 * A + _SCRATCH_INTS + (width if cigar else 0) + seq)


def rows_fit(active_working_set: int, width: int, nwords: int, cigar: bool,
             smem: int) -> bool:
    """K1/K2's row placement: whether the two packed rows of ``nwords``
    words fit in ``smem`` bytes beside the shared ring.  Where they do not
    (exact windows near ``max_width``), the kernel reads them from global
    memory."""
    return smem_bytes(active_working_set, width, cigar, nwords=nwords) <= smem


def centre_width(ring, width: int, nwords: int, cigar: bool, smem: int) -> int:
    """K4's centre: the most lanes, a multiple of ``CENTRE_GRANULE`` and at
    most W, whose ring rows (``_layout``: [3A, C], or the compact ring's)
    fit ``smem`` beside the rest of the block's shared memory
    (``smem_bytes``); exact K4 holds the diagonals around W/2 there, banded
    K4 the window's lanes 0 .. C - 1.  0 where not even one granule fits:
    the whole ring is then in global memory.  Raises ValueError only where
    the rest of the block (the per-slot window words, the scratch, K2's row
    words and the packed rows) does not fit.  ``ring``: as for
    ``smem_bytes``."""
    A, rows, _, _ = _layout(ring)
    fixed = smem_bytes(ring, width, cigar, True, 0, nwords)
    if fixed > smem:
        raise ValueError(
            f"K4 at W={width}, A={A}, cigar={cigar}: the window words, "
            f"scratch and packed rows of {nwords} words need {fixed} bytes "
            f"of shared memory; a block has {smem}"
        )
    return min(width, (smem - fixed) // (4 * rows)
               // CENTRE_GRANULE * CENTRE_GRANULE)


def ring_bytes(ring, width: int, centre: int) -> int:
    """K4's global buffer per alignment: the edges of its rows outside the
    centre, [3A, W - centre] int32, and for the compact ring M's far ring
    [A, W] before the I and D edges [2 (e + 1), W - centre]."""
    _, _, edge_rows, far_rows = _layout(ring)
    return 4 * (far_rows * width + edge_rows * (width - centre))


def max_width(active_working_set: int, smem: int, cigar: bool = False) -> int:
    """Widest multiple-of-128 window whose shared-memory ring block fits
    ``smem`` bytes; past it the window needs K4's global ring."""
    A = active_working_set
    per_diagonal = 4 * (3 * A + (1 if cigar else 0))
    return (smem - 4 * (2 * A + _SCRATCH_INTS)) // per_diagonal // 128 * 128


@functools.lru_cache(maxsize=None)
def smem_optin(device: torch.device) -> int:
    """Shared memory one block of this device may opt in to."""
    lib = load_library()
    out = ctypes.c_int(0)
    check(lib, lib.wfa_smem_optin(device.index, ctypes.byref(out)))
    return out.value


def _schedule_tensor(penalties, max_steps, score_limit, device, compact=False):
    """The kernels' [S, 7] int32 schedule on ``device`` (``_schedule_rows``;
    [S, 14] with ``compact``) for a launch on the current stream: the tensor
    is marked as used by that stream, so that the cache dropping it cannot
    free it under a launch still reading it."""
    res = _schedule_rows(penalties, max_steps, score_limit, device, compact)
    if device.type == "cuda":
        res[0].record_stream(torch.cuda.current_stream(device))
    return res


def compact_columns(penalties: Penalties, max_steps: int,
                    score_limit: int | None) -> np.ndarray:
    """The compact ring's 7 schedule columns, int32 [S, 7]: the near M slot
    and the gap slot this score writes (d mod each ring's slots), the near
    M parent's slot (0 where it is missing or both M parents are far), the
    gap parent's slot (0 where missing), and the cone radius of each parent
    (M[d-x], M[d-o-e], I/D[d-e]; -1 where missing), which masks its reads.
    Slots of missing parents are 0 so that every address stays in the
    ring."""
    near, gap, far = compact_slots(penalties)
    sched = build_schedule(penalties, max_steps, score_limit)
    radius, _ = cone_radii(penalties, max_steps, score_limit)
    d = sched.score.astype(np.int64)
    x, oe, e = penalties.x, penalties.o + penalties.e, penalties.e
    # Radius by score (score 0: radius 0); every parent that exists was
    # computed, so its score is on the schedule or is 0.
    by_score = np.zeros(int(d[-1]) + 1 if len(d) else 1, dtype=np.int64)
    by_score[d] = radius

    def parent_radius(slot, delta):
        return np.where(slot >= 0, by_score[np.clip(d - delta, 0, None)], -1)

    if far == 3:
        near_in = np.zeros_like(d)
    else:
        n, slot = (x, sched.mx_slot) if far == 2 else (oe, sched.moe_slot)
        near_in = np.where(slot >= 0, (d - n) % near, 0)
    return np.stack([
        d % near, d % gap, near_in,
        np.where(sched.ide_slot >= 0, (d - e) % gap, 0),
        parent_radius(sched.mx_slot, x), parent_radius(sched.moe_slot, oe),
        parent_radius(sched.ide_slot, e),
    ], axis=1).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _schedule_rows(penalties, max_steps, score_limit, device, compact=False):
    """The kernels' [S, 7] int32 schedule: score, out slot, the three parent
    slots, the cone radius and the out slot's previous cone radius; with
    ``compact``, the compact ring's 7 columns after them
    (``compact_columns``).  On a CUDA device it is copied on the default
    stream and waited for, so that a launch on any stream reads the whole
    table."""
    TRACE.count("schedule_builds")
    sched = build_schedule(penalties, max_steps, score_limit)
    radius, previous = cone_radii(penalties, max_steps, score_limit)
    rows = torch.stack([
        torch.tensor(a) for a in (
            sched.score, sched.out_slot, sched.mx_slot,
            sched.moe_slot, sched.ide_slot, radius, previous,
        )
    ], dim=1).to(torch.int32)
    if compact:
        rows = torch.cat([rows, torch.from_numpy(
            compact_columns(penalties, max_steps, score_limit))], dim=1)
    rows = rows.contiguous()
    last = int(sched.score[-1]) if sched.num_steps else 0
    if device.type == "cuda":
        default = torch.cuda.default_stream(device)
        with torch.cuda.stream(default):
            rows = rows.to(device)
        default.synchronize()
    return rows.to(device), sched.num_steps, sched.unfinished_score, last


def _placement(cfg: EngineConfig, nw: int, cigar: bool, centre: int | None,
               rows: str | None, device) -> tuple[int, bool]:
    """Where K1/K2/K4 keep their ring and rows on ``device``, host
    arithmetic before the launch: (centre, rows_shared), centre -1 for the
    shared-memory ring.  K4's centre is ``centre_width`` unless the caller
    pins it; K4 always stages the rows, K1/K2 where ``rows_fit`` unless the
    caller pins ``rows`` ('shared' or 'global').  Raises ValueError for
    what does not fit."""
    W = cfg.wf_width
    if W <= 0 or W % 32:
        raise ValueError(f"wf_width {W} must be a positive multiple of 32")
    A = cfg.penalties.active_working_set
    have = smem_optin(device)
    if rows not in (None, "shared", "global") or (cfg.ring_global and rows == "global"):
        raise ValueError(f"rows {rows!r}: None, 'shared' or (not K4) 'global'")
    if cfg.ring_global:
        if centre is None:
            return centre_width(cfg.penalties, W, nw, cigar, have), True
        need = smem_bytes(cfg.penalties, W, cigar, True, centre, nw)
        if centre % CENTRE_GRANULE or not 0 <= centre <= W or need > have:
            raise ValueError(
                f"K4 centre {centre} at W={W}: 0 or a multiple of "
                f"{CENTRE_GRANULE} up to W whose block ({need} bytes) fits "
                f"the {have} bytes a block may use"
            )
        return centre, True
    shared = rows_fit(A, W, nw, cigar, have) if rows is None else rows == "shared"
    need = smem_bytes(A, W, cigar, nwords=nw if shared else None)
    if need > have:
        raise ValueError(
            f"block of {need} bytes of shared memory (A={A}, W={W}, "
            f"cigar={cigar}, rows {'shared' if shared else 'global'}) exceeds "
            f"the {have} bytes a block may use"
        )
    return -1, shared


def _check_batch(cfg: EngineConfig, pat, txt, plen, tlen, valid, cigar: bool,
                 centre: int | None, rows: str | None):
    """Validate the inputs of K1/K2/K4 (exact or banded) on a CUDA device;
    returns (B, nw, centre, rows_shared) (``_placement``)."""
    device = pat.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    B, nw = pat.shape
    check_inputs(
        device,
        pat=(pat, torch.int32, (B, nw)), txt=(txt, torch.int32, (B, nw)),
        plen=(plen, torch.int32, (B,)), tlen=(tlen, torch.int32, (B,)),
        valid=(valid, torch.bool, (B,)),
    )
    return (B, nw, *_placement(cfg, nw, cigar, centre, rows, device))


def blocks_per_sm(cfg: EngineConfig, nwords: int, device: torch.device, *,
                  cigar: bool = False, _centre: int | None = None,
                  _threads: int = 0, _rows: str | None = None) -> tuple[int, int]:
    """How many blocks of the kernel that ``align_batch_cuda`` (``cigar``:
    ``cigar_tables_cuda``) launches for ``cfg`` on rows of ``nwords`` words
    one SM of ``device`` holds at once, by threads, registers and shared
    memory (the CUDA occupancy query), and the threads of each block."""
    centre, shared = _placement(cfg, nwords, cigar, _centre, _rows, device)
    near, gap, _ = _compact_args(cfg)
    lib = load_library("wfa_distance")
    out = (ctypes.c_int * 2)()
    check(lib, lib.wfa_blocks_per_sm(
        int(cigar), cfg.band if cfg.banded else -1, centre, near, gap,
        int(shared), cfg.penalties.active_working_set, cfg.wf_width, nwords,
        _threads, device.index, out,
    ))
    return out[0], out[1]


def _compact_args(cfg: EngineConfig) -> tuple[int, int, int]:
    """The launch's compact-ring arguments (near slots, gap slots, far
    mask): ``compact_slots`` for K4, (0, 0, 0) for the whole ring and K1/K2."""
    slots = compact_slots(cfg.penalties) if cfg.ring_global else None
    return slots or (0, 0, 0)


def _edges(cfg: EngineConfig, B: int, centre: int, device) -> torch.Tensor | None:
    """K4's global buffer, ``ring_bytes`` an alignment: the whole ring's
    [B, 3A, W - centre] edges (each block resets its own slab; a centre of
    0: the whole ring), or the compact ring's far rings and I/D edges, which
    nothing resets; None for the shared-memory ring and for a whole ring
    with a centre of all W."""
    compact = _compact_args(cfg)[0] > 0
    if centre < 0 or (centre == cfg.wf_width and not compact):
        return None
    ring = cfg.penalties if compact else cfg.penalties.active_working_set
    return torch.empty(B * ring_bytes(ring, cfg.wf_width, centre) // 4,
                       dtype=torch.int32, device=device)


def align_batch_cuda(
    cfg: EngineConfig,
    pat: torch.Tensor,    # [B, NW] int32 (u32 bit patterns)
    txt: torch.Tensor,    # [B, NW] int32
    plen: torch.Tensor,   # [B] int32
    tlen: torch.Tensor,   # [B] int32
    valid: torch.Tensor,  # [B] bool
    *, _centre: int | None = None, _threads: int = 0, _rows: str | None = None,
) -> dict[str, torch.Tensor]:
    """K1 (K4 with ``cfg.ring_global``): distances and finished flags of
    one batch.  ``_centre`` pins K4's centre (0: the whole ring in global
    memory), ``_threads`` the threads a block (0: for K1 512, and 1024 in
    exact mode where a block's shared memory leaves room for no second block
    on an SM; for K4 up to 1024, or 512 where two blocks of 512 keep more
    threads on an SM) and ``_rows`` K1's row placement ('shared' or
    'global'); tests and timings use them."""
    if pat.device.type == "cpu":
        return engine_torch.align_batch_device(cfg, pat, txt, plen, tlen, valid)
    B, nw, centre, shared = _check_batch(cfg, pat, txt, plen, tlen, valid, False,
                                         _centre, _rows)
    device = pat.device
    compact = _compact_args(cfg)
    sched, num_steps, unfinished, _ = _schedule_tensor(
        cfg.penalties, cfg.max_steps, cfg.score_limit, device, compact[0] > 0
    )
    dist = torch.empty(B, dtype=torch.int32, device=device)
    fin = torch.empty(B, dtype=torch.bool, device=device)
    edges = _edges(cfg, B, centre, device)
    lib = load_library("wfa_distance")
    stream = torch.cuda.current_stream(device).cuda_stream
    check(lib, lib.wfa_distance_launch(
        pat.data_ptr(), txt.data_ptr(), nw,
        plen.data_ptr(), tlen.data_ptr(), valid.data_ptr(),
        sched.data_ptr(), num_steps, unfinished,
        cfg.penalties.active_working_set, cfg.wf_width,
        cfg.band if cfg.banded else -1,
        dist.data_ptr(), fin.data_ptr(),
        None if edges is None else edges.data_ptr(), centre, *compact,
        int(shared), _threads, B, device.index, stream,
    ))
    _count("wfa_distance", cfg, shared)
    return {"distance": dist, "finished": fin}


def _count(kernel: str, cfg: EngineConfig, rows_shared: bool) -> None:
    """One launch of K1/K2 (by row placement) or K4 (exact or banded; the
    compact ring also as ``*_compact``)."""
    if cfg.ring_global:
        keys = [kernel + ("_ring_banded" if cfg.banded else "_ring")]
        if _compact_args(cfg)[0]:
            keys.append(kernel + "_compact")
        _bump(*keys)
    else:
        _bump(kernel, "rows_shared" if rows_shared else "rows_global")


def _bump(*keys: str) -> None:
    """Add one to each count, under the lock: threads launch at once."""
    with _LAUNCHES_LOCK:
        for key in keys:
            LAUNCHES[key] += 1


def cigar_tables_cuda(
    cfg: EngineConfig, score_cap: int, pat, txt, plen, tlen, valid,
    *, _centre: int | None = None, _threads: int = 0, _rows: str | None = None,
) -> dict[str, torch.Tensor]:
    """K2 (K4 with ``cfg.ring_global``): ``distance``, ``finished``,
    ``choice_words`` [score_cap//8 + 2, B, W] int32 and, banded,
    ``lo_trace`` [B, lo_pad(score_cap)] int32.

    The table and ``lo_trace`` come from ``torch.empty``, not
    ``torch.zeros``: K2 stores every row that holds a scheduled score up to
    each alignment's distance, in exact mode only on the row's cone, and K3
    reads no other word, so clearing the table (310 MB at HiFi x8, a memset
    about as long as a tenth of K2) buys nothing.  Rows past an alignment's
    distance and exact words outside the cone hold whatever the memory held;
    compare tables only where a walk can read (``engine_torch.tables_equal``
    with ``cone=True`` in exact mode).  The private knobs are
    ``align_batch_cuda``'s."""
    if pat.device.type == "cpu":
        return engine_torch.cigar_tables(
            cfg, score_cap, pat, txt, plen, tlen, valid
        )
    B, nw, centre, shared = _check_batch(cfg, pat, txt, plen, tlen, valid, True,
                                         _centre, _rows)
    device = pat.device
    compact = _compact_args(cfg)
    sched, num_steps, unfinished, last = _schedule_tensor(
        cfg.penalties, cfg.max_steps, cfg.score_limit, device, compact[0] > 0
    )
    if last >= score_cap:
        raise ValueError(
            f"schedule reaches score {last}, past the table's score_cap "
            f"{score_cap}"
        )
    C = engine_torch.num_chunks(score_cap)
    W = cfg.wf_width
    dist = torch.empty(B, dtype=torch.int32, device=device)
    fin = torch.empty(B, dtype=torch.bool, device=device)
    words = torch.empty((C, B, W), dtype=torch.int32, device=device)
    res = {"distance": dist, "finished": fin, "choice_words": words}
    lo_ptr, lo_stride = None, 0
    if cfg.banded:
        lo_stride = engine_torch.lo_pad(score_cap)
        res["lo_trace"] = torch.empty((B, lo_stride), dtype=torch.int32,
                                      device=device)
        lo_ptr = res["lo_trace"].data_ptr()
    edges = _edges(cfg, B, centre, device)
    lib = load_library("wfa_distance")
    stream = torch.cuda.current_stream(device).cuda_stream
    check(lib, lib.wfa_cigar_launch(
        pat.data_ptr(), txt.data_ptr(), nw,
        plen.data_ptr(), tlen.data_ptr(), valid.data_ptr(),
        sched.data_ptr(), num_steps, unfinished,
        cfg.penalties.active_working_set, W, cfg.band if cfg.banded else -1,
        dist.data_ptr(), fin.data_ptr(), words.data_ptr(), C,
        lo_ptr, lo_stride, None if edges is None else edges.data_ptr(),
        centre, *compact, int(shared), _threads, B, device.index, stream,
    ))
    _count("wfa_cigar", cfg, shared)
    return res


def traceback_cuda(
    tb_cfg: TracebackConfig,
    choice_words: torch.Tensor,      # [C, B, W] int32
    lo_trace: torch.Tensor | None,   # [B, lo_pad] int32 (banded) or None
    dist: torch.Tensor,              # [B] int32
    fin: torch.Tensor,               # [B] bool
    target_k: torch.Tensor,          # [B] int32
    *, _warps: int = 0, _stats: torch.Tensor | None = None,
) -> torch.Tensor:
    """K3: the fused rows [B, 4 + opw] int32 (distance, finished, n_ops, 0,
    ops...).  One warp walks each alignment; ``_warps`` pins the walks a
    block (1-8; 0: ``TRACEBACK_WARPS``), and ``_stats``, an int32 [B, 4]
    tensor on the device, receives each walk's counters (rows entered,
    window loads, misses, entries with no load in flight); tests and
    timings use them."""
    device = choice_words.device
    if device.type == "cpu":
        tb = traceback_torch.traceback_batch_device(
            tb_cfg, choice_words, lo_trace, dist, fin, target_k
        )
        return traceback_torch.fuse(dist, fin, tb["n_ops"], tb["ops"])
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    C, B, W = choice_words.shape
    if C != tb_cfg.num_chunks or W != tb_cfg.wf_width:
        raise ValueError(
            f"choice table {tuple(choice_words.shape)} does not match "
            f"score_cap {tb_cfg.score_cap} and W {tb_cfg.wf_width}"
        )
    warps = _warps or TRACEBACK_WARPS
    if not 1 <= warps <= 8:
        raise ValueError(f"K3 takes 1-8 warps a block, not {warps}")
    tensors = dict(
        choice_words=(choice_words, torch.int32, (C, B, W)),
        dist=(dist, torch.int32, (B,)), fin=(fin, torch.bool, (B,)),
        target_k=(target_k, torch.int32, (B,)),
    )
    if tb_cfg.banded:
        tensors["lo_trace"] = (lo_trace, torch.int32, (B, tb_cfg.lo_pad))
    if _stats is not None:
        tensors["_stats"] = (_stats, torch.int32, (B, 4))
    check_inputs(device, **tensors)
    opw = tb_cfg.opw
    out = torch.empty((B, 4 + opw), dtype=torch.int32, device=device)
    pen = tb_cfg.penalties
    lib = load_library("wfa_traceback")
    stream = torch.cuda.current_stream(device).cuda_stream
    check(lib, lib.wfa_traceback_launch(
        choice_words.data_ptr(), C,
        lo_trace.data_ptr() if tb_cfg.banded else None,
        tb_cfg.lo_pad if tb_cfg.banded else 0,
        dist.data_ptr(), fin.data_ptr(), target_k.data_ptr(),
        B, W, pen.x, pen.o, pen.e, opw, out.data_ptr(),
        None if _stats is None else _stats.data_ptr(), warps, device.index,
        stream,
    ))
    _bump("wfa_traceback")
    return out


def align_cigar_cuda(
    cfg: EngineConfig, tb_cfg: TracebackConfig, pat, txt, plen, tlen, valid,
    *, _centre: int | None = None, _threads: int = 0, _rows: str | None = None,
) -> torch.Tensor:
    """K2 (K4 with ``cfg.ring_global``) then K3 on the current stream:
    [B, 4 + opw] int32 rows (distance, finished, n_ops, 0, ops...), the
    output of ``traceback_torch.align_cigar_fused``.  ``_centre``,
    ``_threads`` and ``_rows`` go to ``cigar_tables_cuda``."""
    if pat.device.type == "cpu":
        return traceback_torch.align_cigar_fused(
            cfg, tb_cfg, pat, txt, plen, tlen, valid
        )
    if (cfg.wf_width, cfg.banded) != (tb_cfg.wf_width, tb_cfg.banded):
        raise ValueError("the engine and traceback configs disagree")
    if cfg.banded and tb_cfg.lo_pad != engine_torch.lo_pad(tb_cfg.score_cap):
        raise ValueError(f"lo_pad must be {engine_torch.lo_pad(tb_cfg.score_cap)}")
    tables = cigar_tables_cuda(
        cfg, tb_cfg.score_cap, pat, txt, plen, tlen, valid,
        _centre=_centre, _threads=_threads, _rows=_rows,
    )
    return traceback_cuda(
        tb_cfg, tables["choice_words"], tables.get("lo_trace"),
        tables["distance"], tables["finished"], tlen - plen,
    )
