"""Public aligner API of the PyTorch/CUDA port.

The counterpart of ``wfa_tpu/aligner.py``: pairs are binned into length
tiers (``_plan_tiers``), each tier runs on the device engine, pairs the
device leaves unfinished get the on-device retry ladder, and what is still
unfinished, ``N``-containing or oversized goes to the native CPU fallback.
With ``compute_cigar`` each pair also gets its CIGAR.

Backends: ``cuda`` runs the hand-written kernels (``ops/engine_cuda.py``: K1
for distances; K2 + K3 for CIGARs, with only the walked op streams copied
back and decoded by ``native.cigar_from_ops_batch``; K4 in place of K1 or K2
for windows, exact or banded, wider than a block's shared memory allows),
enqueues every chunk of a tier before it decodes the first, and never
carries on on the CPU; ``torch`` runs the plain PyTorch engine on CPU
tensors at the XLA route's window widths, decoding its per-step choice
table with ``native.traceback_batch``, so its results equal
``wfa_tpu.align_pairs(backend='xla')``; ``auto``, the default, is ``cuda``:
without a CUDA device both raise, and only ``torch`` runs on the CPU.

With ``data_parallel`` (the default) and more than one device in
``parallel.mesh.data_mesh()``, the ``cuda`` route splits each launch's batch
over those devices (``parallel/mesh.py``).  With ``probe_order`` it orders
the pairs within long-read tiers by distances measured at a narrow band
(``_probe_distances``: K1, or banded K4 at large working sets) in place of
the host's divergence estimate.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import native
from .ops import engine_cuda, engine_torch
from .ops.engine_torch import EngineConfig, batch_to_tensors
from .ops.packing import _ACGT, pack_batch, pack_slot
from .ops.traceback_torch import TracebackConfig
from .parallel import mesh as parallel_mesh
from .params import (
    AUTO_BAND_INTERVAL, AlignmentOptions, default_band_width, default_max_error,
)
from .schedule import build_schedule
from .traceback import recover_cigar, recover_cigar_from_stream
from .types import MAX_SEQ_LEN, AlignmentResult
from .utils.cpu_wfa import align_one_py
from .utils.logger import LOG
from .utils.presort import MIN_PRESORT_TIER
from .utils.presort_scan import divergence_scores
from .utils.timers import TRACE

BACKENDS = ("auto", "torch", "cuda")
_LANE = 128
_MIN_TIER = 64
# Pairs per kernel launch in distance mode: one block per pair, so this only
# bounds the packed host arrays (and, for K4, the memory budget binds).
_CUDA_CALL_BATCH = 1 << 16
# Most pairs per K2 launch; the memory budget usually binds first.
_CUDA_CIGAR_CALL_BATCH = 4096
# Widest exact window on K4's global ring (wfa_tpu's PALLAS_MAX_WIDTH_RING);
# past it the window is truncated and certified.
_RING_MAX_W = 16384
# Most chunks of a tier in flight at once (_pending_depth); None: no cap
# beyond the memory budget.  Timings set it to 1 to compare with a loop that
# waits for each chunk before it packs the next.
_MAX_PENDING: int | None = None


def _tier_of(length: int) -> int:
    t = _MIN_TIER
    while length + 2 > t:
        t *= 2
    return t


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


@dataclasses.dataclass
class _TierPlan:
    tier: int
    indices: list[int]
    wf_width: int
    tile_batch: int
    nwords: int
    score_limit: int | None


def _plan_tiers(
    lens: np.ndarray, opts: AlignmentOptions, max_error: int,
    cost_hint: np.ndarray | None = None,
) -> list[_TierPlan]:
    """Bin pairs into power-of-two length tiers (``wfa_tpu/aligner.py``
    ``_plan_tiers``): per tier the window width, the exact mode's score
    bound, the plain engine's tile and the packed words per sequence.
    Within a tier pairs are ordered by ``cost_hint`` (estimated divergence),
    then by length, so pairs of similar cost run together."""
    pen = opts.penalties
    tiers: dict[int, list[int]] = {}
    for i, L in enumerate(lens):
        tiers.setdefault(_tier_of(int(L)), []).append(i)

    plans = []
    for tier, idxs in sorted(tiers.items()):
        if cost_hint is not None:
            idxs.sort(key=lambda i: (-cost_hint[i], -int(lens[i])))
        else:
            idxs.sort(key=lambda i: -int(lens[i]))
        if opts.banded:
            width = opts.band_width or default_band_width(max_error)
            w = min(width, 2 * (tier + 2) + 1)
            score_limit = None
        else:
            w = 2 * min(max_error, tier + 2) + 1
            # The all-indels alignment bounds the optimum, so the schedule
            # never needs scores beyond its cost for this tier.
            score_limit = 2 * pen.o + pen.e * 2 * (tier + 2) + pen.x
        sched = build_schedule(pen, max_error, score_limit)
        if opts.compute_cigar:
            # The plain engine's per-step choice table, times 3 for its
            # temporaries.
            per_lane = sched.num_steps * w * 3
        else:
            per_lane = 3 * pen.active_working_set * w * 4 * 2
        tile = opts.tile_batch or max(
            8, min(2048, opts.memory_budget_bytes // max(per_lane, 1))
        )
        if opts.compute_cigar and w >= 2048:
            tile = min(tile, 16)
        tile = min(_round_up(len(idxs), 8), _round_up(tile, 8))
        plans.append(_TierPlan(tier, idxs, w, tile, tier // 16 + 1, score_limit))
    return plans


def _resolve_backend(name: str) -> str:
    """``auto`` is the card, as ``cuda``; either raises without a CUDA
    device.  Only ``torch`` runs the plain engine on the CPU."""
    if name not in BACKENDS:
        raise ValueError(f"backend {name!r} not in {BACKENDS}")
    if name == "torch":
        return name
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"backend={name!r} needs a CUDA device; none is available "
            "(backend='torch' runs the plain engine on the CPU)"
        )
    return "cuda"


def _tier_geometry_cuda(plan, opts: AlignmentOptions, max_error: int,
                        band: int, smem_bytes: int):
    """Launch geometry of one tier on the CUDA kernels; host arithmetic only.

    The window is ``plan.wf_width`` rounded up to 128 diagonals, as on the
    Pallas route, so banded scores equal ``wfa_tpu``'s at the same W.  A
    window wider than a shared-memory ring allows runs on K4, with part of
    its ring in shared memory and the edges in global memory
    (``ring_global``).  Exact, it does so up to ``_RING_MAX_W`` diagonals
    (``wfa_tpu/aligner.py:183-201``); past that it is truncated and
    certified: leaving a centred +-W/2 window costs at least
    ``o + e*(W/2+1)``, so a distance below that bound is optimal; the loop
    stops at the bound.  Banded, it takes K4 at its own W, never truncated
    or certified, where ``wfa_tpu`` runs its XLA engine
    (``wfa_tpu/aligner.py:637-646``).  At working sets above 64 every K4
    launch keeps the compact ring (``engine_cuda.compact_slots``): only M's
    far ring in global memory, the rest of the rows in shared memory as far
    as the centre reaches.  Where no centre of 32 diagonals fits, K4 keeps
    its rows' lanes in global memory (``centre_width`` 0); the one window
    refused is one whose block cannot hold even the per-slot window words,
    the scratch and the packed rows (``centre_width`` raises, near
    A = 29,000 on an H100).

    In CIGAR mode (``wfa_tpu/aligner.py:204-224``) the choice table holds
    scores below ``score_cap = unfinished_score + 1``, capped at
    ``cert_bound + 1`` when the window is truncated, and the schedule runs to
    ``score_cap - 1`` as the Pallas loop runs to ``d < score_cap``.

    Returns (EngineConfig, full_window, cert_bound, score_cap); score_cap is
    0 in distance mode."""
    pen = opts.penalties
    A = pen.active_working_set
    cigar = opts.compute_cigar
    w = _round_up(plan.wf_width, _LANE)
    score_limit = None
    full_window = True
    # w is a multiple of 128, so it fits a shared ring iff w <= max_width.
    ring_global = w > engine_cuda.max_width(A, smem_bytes, cigar)
    if not opts.banded:
        if ring_global:
            w = min(w, _RING_MAX_W)
        full_window = w >= plan.wf_width
        score_limit = plan.score_limit
    if ring_global:
        # Raises where the block's part outside the ring does not fit.
        engine_cuda.centre_width(pen, w, plan.nwords, cigar, smem_bytes)
    cert_bound = pen.o + pen.e * (w // 2 + 1)
    score_cap = 0
    if cigar:
        sched = build_schedule(pen, max_error, score_limit)
        score_cap = sched.unfinished_score + 1
        if not full_window:
            score_cap = min(score_cap, cert_bound + 1)
        score_limit = score_cap - 1
    elif not full_window:
        score_limit = (
            cert_bound if score_limit is None else min(score_limit, cert_bound)
        )
    cfg = EngineConfig(
        penalties=pen, max_steps=max_error, wf_width=w, band=band,
        score_limit=score_limit, compute_cigar=cigar, ring_global=ring_global,
    )
    return cfg, full_window, cert_bound, score_cap


def _cigar_call_batch(opts: AlignmentOptions, score_cap: int, w: int,
                      ring: int = 0) -> int:
    """Pairs per K2/K4 launch: the memory budget over the bytes of one lane's
    choice table and K4 global ring (``ring``, ``engine_cuda.ring_bytes``),
    at most _CUDA_CIGAR_CALL_BATCH."""
    per_lane = engine_torch.num_chunks(score_cap) * w * 4 + ring
    return max(1, min(_CUDA_CIGAR_CALL_BATCH,
                      opts.memory_budget_bytes // per_lane))


def _distance_call_batch(opts: AlignmentOptions, ring: int) -> int:
    """Pairs per K1/K4 launch: _CUDA_CALL_BATCH, and with a K4 global ring
    of ``ring`` bytes a lane at most the memory budget over it."""
    if not ring:
        return _CUDA_CALL_BATCH
    return max(1, min(_CUDA_CALL_BATCH, opts.memory_budget_bytes // ring))


def _pending_depth(n_chunks: int, chunk_bytes: int, budget: int) -> int:
    """How many chunks of a tier may be in flight (packed, launched and
    copied back, not yet decoded) at once: every chunk, as
    ``wfa_tpu/aligner.py:398`` allows on its fused paths, unless the
    page-locked host buffers they hold (``chunk_bytes`` a chunk) would pass
    the memory budget, or ``_MAX_PENDING`` caps it.  The device memory of a
    pending chunk does not bound it: K2's choice table and K4's edge ring
    are temporaries of the wrapper, freed into the caching allocator in
    stream order, so the next chunk's launch reuses them, and a chunk's
    inputs and fused output are dropped once its copy back is enqueued."""
    depth = min(n_chunks, max(1, budget // max(chunk_bytes, 1)))
    if _MAX_PENDING:
        depth = min(depth, _MAX_PENDING)
    return depth


class _HostSlot:
    """One pending chunk's host buffers, allocated once per tier and reused
    by every ``depth``-th chunk: the packed inputs and the copy back's
    [rows, cols] int32 (distance and finished, or the fused CIGAR rows).
    Page-locked (``pin``) so that both copies are asynchronous."""

    def __init__(self, rows: int, nwords: int, cols: int, pin: bool):
        def empty(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)

        self.pat = empty(rows, nwords)
        self.txt = empty(rows, nwords)
        self.plen = empty(rows)
        self.tlen = empty(rows)
        self.valid = empty(rows, dtype=torch.bool)
        self.out = empty(rows, cols)

    def fill(self, pats, txts, nwords: int) -> tuple[torch.Tensor, ...]:
        """Pack one chunk into the slot: (pat, txt, plen, tlen, valid), the
        host tensors of ``batch_to_tensors`` with the same values.  One
        native call packs both sides straight into the slot
        (``packing.pack_slot``, ``csrc/pack_slot.cpp``); where the native
        library does not load or a sequence is not ``bytes``,
        ``pack_batch`` packs each side and the arrays are copied in.
        Counts ``pack_native``, the pairs the native packer packed (0 on
        the fallback), and the level ``pack_threads``, the threads it ran
        on."""
        n = len(pats)
        views = (self.pat[:n], self.txt[:n], self.plen[:n], self.tlen[:n],
                 self.valid[:n])
        if native.available():
            try:
                threads = pack_slot(native.get_lib(), pats, txts, self.pat,
                                    self.txt, self.plen, self.tlen, self.valid)
            except TypeError:               # a sequence that is not bytes
                pass
            else:
                TRACE.count("pack_native", n)
                TRACE.level("pack_threads", threads)
                return views
        TRACE.count("pack_native", 0)
        pat_w, p_len, p_ok = pack_batch(pats, nwords)
        txt_w, t_len, t_ok = pack_batch(txts, nwords)
        self.pat[:n].numpy()[:] = pat_w.view(np.int32)
        self.txt[:n].numpy()[:] = txt_w.view(np.int32)
        self.plen[:n].numpy()[:] = p_len
        self.tlen[:n].numpy()[:] = t_len
        self.valid[:n].numpy()[:] = p_ok & t_ok
        return views


def _run_tier_cuda(patterns, texts, idxs, plan, opts, max_error, band,
                   results, need_cpu, device=None, smem=None) -> dict:
    """One tier on K1 (distance) or K2 + K3 (CIGAR), with K4 in place of K1
    or K2 when the window takes the global ring.  With ``data_parallel`` and
    several devices in ``data_mesh()``, each chunk of up to ``ndev x call_b``
    pairs is packed once and split over the devices, each launch within the
    one-device caps.  ``device`` runs the loop on one explicit device
    instead, and ``smem`` sets the bytes of shared memory a block may use;
    on the CPU the wrappers run their plain versions (tests).

    ``wfa_tpu/aligner.py:387-524``'s two phases: each chunk is packed into
    page-locked host buffers, copied to the card, launched, and its results
    copied back into host buffers, one copy each way, with no wait; then the
    chunks are waited for in order and decoded, so the host's packing and
    decoding overlap the card's work on other chunks.  At most
    ``_pending_depth`` chunks are in flight: before a chunk past it is
    packed, the oldest is decoded.  Returns the tier's chunks, that depth
    and the most chunks that were in flight at once."""
    with TRACE.span("plan"):
        mesh = []
        if device is None:
            mesh = parallel_mesh.data_mesh() if opts.data_parallel else []
            if len(mesh) < 2:
                mesh = []
                device = torch.device("cuda", torch.cuda.current_device())
        if smem is None:
            smem = min(engine_cuda.smem_optin(d) for d in mesh or [device])
        ndev = max(len(mesh), 1)
        cfg, full_window, cert_bound, score_cap = _tier_geometry_cuda(
            plan, opts, max_error, band, smem
        )
        cigar = opts.compute_cigar
        # K4's global ring: what the part of the ring in shared memory leaves
        # over (the compact ring: M's far ring besides).  K4 stages the packed
        # rows; K1/K2 where they fit beside the ring.
        pen = opts.penalties
        A = pen.active_working_set
        ring = 0
        rows = "shared"
        if cfg.ring_global:
            centre = engine_cuda.centre_width(pen, cfg.wf_width, plan.nwords, cigar,
                                              smem)
            ring = engine_cuda.ring_bytes(pen, cfg.wf_width, centre)
        elif not engine_cuda.rows_fit(A, cfg.wf_width, plan.nwords, cigar, smem):
            rows = "global"
        cols = 2
        if cigar:
            tb_cfg = TracebackConfig(
                penalties=opts.penalties, wf_width=cfg.wf_width,
                score_cap=score_cap, banded=cfg.banded,
                lo_pad=engine_torch.lo_pad(score_cap) if cfg.banded else 0,
            )
            call_b = _cigar_call_batch(opts, score_cap, cfg.wf_width, ring)
            cols = 4 + tb_cfg.opw
        else:
            call_b = _distance_call_batch(opts, ring)
        step = ndev * call_b
        n_chunks = -(-len(idxs) // step)
        slot_rows = min(step, len(idxs))
        slot_bytes = slot_rows * (4 * (2 * plan.nwords + 2 + cols) + 1)
        depth = _pending_depth(n_chunks, slot_bytes, opts.memory_budget_bytes)
        LOG.debug(
            "cuda tier=%d pairs=%d W=%d band=%d cigar=%s ring_global=%s rows=%s "
            "score_cap=%d call_b=%d chunks=%d depth=%d full_window=%s "
            "cert_bound=%d devices=%d",
            plan.tier, len(idxs), cfg.wf_width, band, cigar, cfg.ring_global, rows,
            score_cap, call_b, n_chunks, depth, full_window, cert_bound, ndev,
        )
        on_card = any(d.type == "cuda" for d in mesh or [device])
    # Page-locked allocations only here, before the first launch: one
    # between two launches would serialise them.
    with TRACE.span("slots"):
        slots = [_HostSlot(slot_rows, plan.nwords, cols, on_card)
                 for _ in range(depth)]
    if on_card:
        TRACE.count("pinned_bytes", depth * slot_bytes)

    def dispatch(slot, pats, txts):
        """Phase 1 for one chunk; returns a function that waits for the
        chunk's copy back and gives its [n, cols] int32 rows."""
        with TRACE.span("pack"):
            host = slot.fill(pats, txts, plan.nwords)
        n = len(pats)
        with TRACE.span("launch"):
            if mesh:
                if cigar:
                    return parallel_mesh.align_cigar_fused_sharded(
                        cfg, tb_cfg, mesh, *host, wait=False)
                finish = parallel_mesh.align_batch_pallas_sharded(
                    cfg, mesh, *host, wait=False)
                return lambda: _distance_rows(finish())
            args = tuple(t.to(device, non_blocking=True) for t in host)
            if cigar:
                out = engine_cuda.align_cigar_cuda(cfg, tb_cfg, *args)
            else:
                out = _distance_rows(engine_cuda.align_batch_cuda(cfg, *args))
            slot.out[:n].copy_(out, non_blocking=True)
            if device.type != "cuda":
                return lambda: slot.out[:n]
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))

        def wait():
            done.synchronize()
            return slot.out[:n]
        return wait

    def consume(chunk, pats, txts, wait) -> None:
        """Phase 2 for one chunk: decode and place its results."""
        with TRACE.span("wait"):
            arr = wait().numpy()
        dist = arr[:, 0]
        fin = arr[:, 1] != 0
        cigars: list[str | None] = [None] * len(chunk)
        if cigar:
            n_ops = arr[:, 2]
            ops_w = arr[:, 4:]
            with TRACE.span("decode"):
                if native.available():
                    cigars, _ = native.cigar_from_ops_batch(
                        ops_w, n_ops, fin, pats, txts
                    )
                else:
                    TRACE.count("decode_native", 0)
                    cigars = [
                        recover_cigar_from_stream(ops_w[b], int(n_ops[b]),
                                                  pats[b], txts[b])
                        if fin[b] and n_ops[b] >= 0 else None
                        for b in range(len(chunk))
                    ]
        with TRACE.span("results"):
            for b, i in enumerate(chunk):
                ok = fin[b] and (full_window or int(dist[b]) < cert_bound)
                if cigar and ok and cigars[b] is None:
                    ok = False  # corrupt walk -> CPU fallback
                if ok:
                    results[i] = AlignmentResult(
                        error=int(dist[b]), cigar=cigars[b] or "",
                        finished_on_accelerator=True,
                    )
                else:
                    need_cpu[i] = True

    pending = []
    peak = 0
    for k, start in enumerate(range(0, len(idxs), step)):
        # Decode before packing, so that at most `depth` chunks hold a slot.
        while len(pending) >= depth:
            consume(*pending.pop(0))
        chunk = idxs[start : start + step]
        pats = [patterns[i] for i in chunk]
        txts = [texts[i] for i in chunk]
        pending.append((chunk, pats, txts,
                        dispatch(slots[k % depth], pats, txts)))
        peak = max(peak, len(pending))
    for item in pending:
        consume(*item)
    TRACE.count("chunks", n_chunks)
    TRACE.count("depth", depth)
    TRACE.count("peak", peak)
    return {"chunks": n_chunks, "depth": depth, "peak": peak}


def _distance_rows(out: dict) -> torch.Tensor:
    """K1/K4's outputs as one [B, 2] int32 tensor (distance, finished), so
    that a chunk copies back once (``wfa_tpu/aligner.py:513-518``)."""
    return torch.stack([out["distance"], out["finished"].to(torch.int32)], 1)


# The probe_order pass's window, and the hint of a pair it left unfinished.
_PROBE_WIDTH = 128
_PROBE_UNFINISHED = float(1 << 30)


def _probe_config(pen, max_error: int, band: int,
                  smem: int | None) -> EngineConfig:
    """The probe's config: banded at W=128 (band ``band``, or 25 in exact
    mode), on K1 where a block of ``smem`` bytes holds the shared ring, else
    on banded K4 (``ring_global``: from A = 151 on an H100, in its compact
    ring).  ``smem`` None: the plain engine, which
    ignores the flag."""
    ring = smem is not None and _PROBE_WIDTH > engine_cuda.max_width(
        pen.active_working_set, smem)
    return EngineConfig(
        penalties=pen, max_steps=max_error, wf_width=_PROBE_WIDTH,
        band=band if band > 0 else AUTO_BAND_INTERVAL, ring_global=ring,
    )


def _probe_distances(patterns, texts, run_idx, pen, max_error: int, band: int,
                     device: torch.device) -> np.ndarray:
    """``probe_order``'s first pass (``wfa_tpu/aligner.py:284-323``): the
    distances one banded launch at W=128 measures (``_probe_config``: K1,
    or banded K4 at large working sets), as float64 ordering hints; pairs
    it leaves unfinished (band overflow, non-ACGT) get ``1 << 30`` and so
    tile together last.  On a CPU ``device`` the plain engine measures
    them."""
    pats = [patterns[i] for i in run_idx]
    txts = [texts[i] for i in run_idx]
    lmax = max(max(len(p), len(t)) for p, t in zip(pats, txts))
    pat_w, p_len, p_ok = pack_batch(pats, lmax // 16 + 2)
    txt_w, t_len, t_ok = pack_batch(txts, lmax // 16 + 2)
    smem = engine_cuda.smem_optin(device) if device.type == "cuda" else None
    out = engine_cuda.align_batch_cuda(
        _probe_config(pen, max_error, band, smem),
        *batch_to_tensors(pat_w, p_len, txt_w, t_len, p_ok & t_ok, device)
    )
    dist = out["distance"].cpu().numpy().astype(np.float64)
    dist[~out["finished"].cpu().numpy()] = _PROBE_UNFINISHED
    return dist


def _run_tier_torch(patterns, texts, idxs, plan, opts, max_error, band,
                    results, need_cpu) -> None:
    """One tier on the plain engine at the XLA route's widths; CIGARs from
    its per-step choice table (``wfa_tpu/aligner.py:647-732``)."""
    pen = opts.penalties
    cfg = EngineConfig(
        penalties=pen, max_steps=max_error, wf_width=plan.wf_width,
        band=band, score_limit=None if opts.banded else plan.score_limit,
        compute_cigar=opts.compute_cigar,
    )
    if opts.compute_cigar:
        sched = build_schedule(pen, max_error, cfg.score_limit)
        max_sc = int(sched.score[-1]) if sched.num_steps else 0
        step_of_score = np.full(max_sc + 1, -1, dtype=np.int32)
        step_of_score[sched.score] = np.arange(sched.num_steps, dtype=np.int32)
    device = torch.device("cpu")
    for start in range(0, len(idxs), plan.tile_batch):
        chunk = idxs[start : start + plan.tile_batch]
        pats = [patterns[i] for i in chunk]
        txts = [texts[i] for i in chunk]
        pat_w, p_len, p_ok = pack_batch(pats, plan.nwords)
        txt_w, t_len, t_ok = pack_batch(txts, plan.nwords)
        out = engine_cuda.align_batch_cuda(
            cfg, *batch_to_tensors(pat_w, p_len, txt_w, t_len, p_ok & t_ok, device)
        )
        dist = out["distance"].numpy()
        fin = out["finished"].numpy()
        cigars: list[str | None] = [None] * len(chunk)
        if opts.compute_cigar:
            # Only the steps a walk can reach.
            dmax = int(dist[fin].max(initial=0))
            smax = int(step_of_score[min(dmax, len(step_of_score) - 1)])
            rows = min(out["choices"].shape[0], smax + 2)
            choices = out["choices"][:rows].numpy()
            lo_trace = out["lo_trace"][:rows].numpy()
            if native.available():
                cigars, _ = native.traceback_batch(
                    choices, lo_trace, step_of_score, dist, fin, pats, txts, pen,
                )
            else:
                cigars = [
                    recover_cigar(choices[:, b], lo_trace[:, b], sched,
                                  int(dist[b]), pats[b], txts[b])
                    if fin[b] else None
                    for b in range(len(chunk))
                ]
        for b, i in enumerate(chunk):
            if fin[b]:
                results[i] = AlignmentResult(
                    error=int(dist[b]), cigar=cigars[b] or "",
                    finished_on_accelerator=True,
                )
            else:
                need_cpu[i] = True


def align_pairs(
    patterns: list[bytes],
    texts: list[bytes],
    options: AlignmentOptions | None = None,
) -> list[AlignmentResult]:
    """Align a batch of (pattern, text) pairs; the functional core API."""
    with TRACE.span("call"):
        return _align_pairs(patterns, texts, options)


def _align_pairs(patterns, texts, options) -> list[AlignmentResult]:
    opts = options or AlignmentOptions()
    backend = _resolve_backend(opts.backend)
    run_tier = _run_tier_cuda if backend == "cuda" else _run_tier_torch
    pen = opts.penalties
    n = len(patterns)
    if n == 0:
        return []
    if len(texts) != n:
        raise ValueError("patterns and texts must have equal length")
    TRACE.count("pairs", n)

    max_error = opts.max_error or default_max_error(
        len(patterns[0]), len(texts[0]), pen
    )
    lens = np.array(
        [max(len(p), len(t)) for p, t in zip(patterns, texts)], dtype=np.int64
    )
    have_native = native.available()
    results: list[AlignmentResult | None] = [None] * n
    need_cpu = np.zeros(n, dtype=bool)

    # Pairs the device engine cannot take at all.
    oversized = np.array([
        len(p) >= MAX_SEQ_LEN or len(t) >= MAX_SEQ_LEN
        for p, t in zip(patterns, texts)
    ])
    need_cpu |= oversized
    device_idx = [i for i in range(n) if not oversized[i]]
    band = opts.resolved_band() if opts.banded else -1

    def _device_pass(run_idx: list[int], err: int) -> None:
        # Cost-ordered tiling for long reads: distances measured on the
        # card at a narrow band (probe_order), else the host's divergence
        # estimate (utils/presort.py), scanned natively where the library
        # loads (utils/presort_scan.py).
        hints = None
        dev_lens = lens[run_idx]
        if dev_lens.size and int(dev_lens.max()) >= MIN_PRESORT_TIER:
            with TRACE.span("presort"):
                if opts.probe_order and backend == "cuda":
                    hints = _probe_distances(
                        patterns, texts, run_idx, pen, err, band,
                        torch.device("cuda", torch.cuda.current_device()),
                    )
                else:
                    hints = divergence_scores(
                        [patterns[i] for i in run_idx],
                        [texts[i] for i in run_idx],
                        dev_lens,
                    )
        with TRACE.span("plan"):
            plans = _plan_tiers(dev_lens, opts, err, hints)
        for plan in plans:
            idxs = [run_idx[j] for j in plan.indices]
            with TRACE.span("tier"):
                run_tier(patterns, texts, idxs, plan, opts, err, band,
                         results, need_cpu)

    # On-device retry ladder (wfa_tpu/aligner.py:734-767): unfinished
    # ACGT-clean pairs get further device passes at a doubled error budget,
    # never past the all-indel cost bound, before the CPU takes over.
    err_cap = 2 * pen.o + pen.e * 2 * int(lens.max(initial=0)) + pen.x
    todo = device_idx
    attempt_err = max_error
    for attempt in range(max(0, opts.device_retries) + 1):
        if not todo:
            break
        if attempt:
            LOG.debug(
                "device retry %d: %d unfinished pairs at max_error %d",
                attempt, len(todo), attempt_err,
            )
            for i in todo:
                need_cpu[i] = False
            TRACE.count("retry_passes")
            TRACE.count("retry_pairs", len(todo))
        _device_pass(todo, attempt_err)
        failed = [i for i in todo if need_cpu[i]]
        nxt = min(attempt_err * 2, err_cap)
        if nxt <= attempt_err:
            break
        attempt_err = nxt
        todo = [
            i for i in failed
            if _ACGT[np.frombuffer(patterns[i], np.uint8)].all()
            and _ACGT[np.frombuffer(texts[i], np.uint8)].all()
        ]

    # CPU fallback pass (wfa_tpu/aligner.py:769-808).
    cpu_idx = np.flatnonzero(need_cpu)
    TRACE.count("pairs_on_card", n - int(cpu_idx.size))
    cigar = opts.compute_cigar
    if cpu_idx.size and opts.cpu_fallback:
        LOG.debug("CPU fallback for %d/%d pairs", cpu_idx.size, n)
        TRACE.count("fallback_pairs", int(cpu_idx.size))
        cpats = [patterns[i] for i in cpu_idx]
        ctxts = [texts[i] for i in cpu_idx]
        with TRACE.span("fallback"):
            if have_native:
                # WFA-adaptive on the CPU iff the device ran banded.
                dist, cigs, _ = native.cpu_align_batch(
                    cpats, ctxts, pen, np.ones(len(cpats), dtype=np.int8), cigar,
                    adaptive=opts.banded,
                )
            else:
                found = [align_one_py(p, t, pen, cigar) for p, t in zip(cpats, ctxts)]
                dist = [d for d, _ in found]
                cigs = [c for _, c in found]
        for j, i in enumerate(cpu_idx):
            results[i] = AlignmentResult(
                error=int(dist[j]), cigar=(cigs[j] or "") if cigar else "",
                finished_on_accelerator=False,
            )
    elif cpu_idx.size:
        LOG.warning(
            "%d pairs unfinished on device and cpu_fallback is disabled; "
            "their results carry finished=False placeholders",
            cpu_idx.size,
        )
        for i in cpu_idx:
            results[i] = AlignmentResult(
                error=0, finished_on_accelerator=False, finished=False
            )

    return results  # type: ignore[return-value]


class WfaAligner:
    """Stateful wrapper (wfagpu_initialize_aligner / wfagpu_add_sequences /
    wfagpu_align, lib/aligner.h:49-63) over the pipelined ``align_pairs``."""

    def __init__(self, options: AlignmentOptions | None = None):
        self.options = options or AlignmentOptions()
        self._patterns: list[bytes] = []
        self._texts: list[bytes] = []
        self.results: list[AlignmentResult] = []

    def add_sequences(self, pattern: bytes | str, text: bytes | str) -> None:
        if isinstance(pattern, str):
            pattern = pattern.encode()
        if isinstance(text, str):
            text = text.encode()
        self._patterns.append(pattern)
        self._texts.append(text)

    def __len__(self) -> int:
        return len(self._patterns)

    def align(self) -> list[AlignmentResult]:
        # Honors options.batch_size through the streaming pipeline.
        from .pipeline import align_pairs_pipelined

        self.results = align_pairs_pipelined(
            self._patterns, self._texts, self.options
        )
        return self.results
