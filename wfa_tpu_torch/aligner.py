"""Public aligner API of the PyTorch/CUDA port.

The counterpart of ``wfa_tpu/aligner.py``: pairs are binned into length
tiers (``_plan_tiers``), each tier runs on the device engine, pairs the
device leaves unfinished get the on-device retry ladder, and what is still
unfinished, ``N``-containing or oversized goes to the native CPU fallback.
With ``compute_cigar`` each pair also gets its CIGAR.

Backends: ``cuda`` runs the hand-written kernels (``ops/engine_cuda.py``: K1
for distances; K2 + K3 for CIGARs, with only the walked op streams copied
back and decoded by ``native.cigar_from_ops_batch``; K4 in place of K1 or K2
for exact windows wider than a block's shared memory allows) and never
carries on on the CPU; ``torch`` runs the plain PyTorch engine on CPU
tensors at the XLA route's window widths, decoding its per-step choice
table with ``native.traceback_batch``, so its results equal
``wfa_tpu.align_pairs(backend='xla')``; ``auto``, the default, is ``cuda``:
without a CUDA device both raise, and only ``torch`` runs on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import native
from .ops import _build, engine_cuda, engine_torch
from .ops.engine_torch import EngineConfig, batch_to_tensors
from .ops.packing import _ACGT, pack_batch
from .ops.traceback_torch import TracebackConfig
from .params import AlignmentOptions, default_band_width, default_max_error
from .schedule import build_schedule
from .traceback import recover_cigar, recover_cigar_from_stream
from .types import MAX_SEQ_LEN, AlignmentResult
from .utils.cpu_wfa import align_one_py
from .utils.logger import LOG
from .utils.presort import MIN_PRESORT_TIER, divergence_scores

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
    Pallas route, so banded scores equal ``wfa_tpu``'s at the same W.  An
    exact window wider than a shared-memory ring allows runs on K4, its
    ring's centre in shared memory and its edges in global memory
    (``ring_global``), up to ``_RING_MAX_W`` diagonals
    (``wfa_tpu/aligner.py:183-201``); past that it is truncated and
    certified: leaving a centred +-W/2 window costs at least
    ``o + e*(W/2+1)``, so a distance below that bound is optimal; the loop
    stops at the bound.  A banded window never takes the global ring and is
    never truncated.

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
    ring_global = False
    if not opts.banded:
        ring_global = w > engine_cuda.max_width(A, smem_bytes, cigar)
        if ring_global:
            w = min(w, _RING_MAX_W)
        full_window = w >= plan.wf_width
        score_limit = plan.score_limit
    if ring_global:
        # Raises when K4's packed rows and smallest centre do not fit.
        engine_cuda.centre_width(A, w, plan.nwords, cigar, smem_bytes)
    elif (need := engine_cuda.smem_bytes(A, w, cigar)) > smem_bytes:
        raise ValueError(
            f"window W={w} with working set {A} (band={band}, cigar={cigar}) "
            f"needs {need} bytes of shared memory; a block has {smem_bytes}"
        )
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
    choice table and K4 edge ring (``ring``, ``engine_cuda.ring_bytes``), at
    most _CUDA_CIGAR_CALL_BATCH."""
    per_lane = engine_torch.num_chunks(score_cap) * w * 4 + ring
    return max(1, min(_CUDA_CIGAR_CALL_BATCH,
                      opts.memory_budget_bytes // per_lane))


def _distance_call_batch(opts: AlignmentOptions, ring: int) -> int:
    """Pairs per K1/K4 launch: _CUDA_CALL_BATCH, and with a K4 edge ring of
    ``ring`` bytes a lane at most the memory budget over it."""
    if not ring:
        return _CUDA_CALL_BATCH
    return max(1, min(_CUDA_CALL_BATCH, opts.memory_budget_bytes // ring))


def _run_tier_cuda(patterns, texts, idxs, plan, opts, max_error, band,
                   results, need_cpu) -> None:
    """One tier on K1 (distance) or K2 + K3 (CIGAR), with K4 in place of K1
    or K2 when the window takes the global ring."""
    device = torch.device("cuda", torch.cuda.current_device())
    smem = engine_cuda.smem_optin(device)
    cfg, full_window, cert_bound, score_cap = _tier_geometry_cuda(
        plan, opts, max_error, band, smem
    )
    cigar = opts.compute_cigar
    # K4's edges: what the ring's centre in shared memory leaves over.
    ring = 0
    if cfg.ring_global:
        A = opts.penalties.active_working_set
        centre = engine_cuda.centre_width(A, cfg.wf_width, plan.nwords, cigar,
                                          smem)
        ring = engine_cuda.ring_bytes(A, cfg.wf_width, centre)
    if cigar:
        tb_cfg = TracebackConfig(
            penalties=opts.penalties, wf_width=cfg.wf_width,
            score_cap=score_cap, banded=cfg.banded,
            lo_pad=engine_torch.lo_pad(score_cap) if cfg.banded else 0,
        )
        call_b = _cigar_call_batch(opts, score_cap, cfg.wf_width, ring)
    else:
        call_b = _distance_call_batch(opts, ring)
    LOG.debug(
        "cuda tier=%d pairs=%d W=%d band=%d cigar=%s ring_global=%s "
        "score_cap=%d call_b=%d full_window=%s cert_bound=%d", plan.tier,
        len(idxs), cfg.wf_width, band, cigar, cfg.ring_global, score_cap,
        call_b, full_window, cert_bound,
    )
    for start in range(0, len(idxs), call_b):
        chunk = idxs[start : start + call_b]
        pats = [patterns[i] for i in chunk]
        txts = [texts[i] for i in chunk]
        pat_w, p_len, p_ok = pack_batch(pats, plan.nwords)
        txt_w, t_len, t_ok = pack_batch(txts, plan.nwords)
        args = batch_to_tensors(pat_w, p_len, txt_w, t_len, p_ok & t_ok, device)
        cigars: list[str | None] = [None] * len(chunk)
        if cigar:
            # One copy back per chunk: distances, flags, op counts, streams.
            arr = engine_cuda.align_cigar_cuda(cfg, tb_cfg, *args).cpu().numpy()
            dist = arr[:, 0]
            fin = arr[:, 1] != 0
            n_ops = arr[:, 2]
            ops_w = np.ascontiguousarray(arr[:, 4:])
            if native.available():
                cigars, _ = native.cigar_from_ops_batch(
                    ops_w, n_ops, fin, pats, txts
                )
            else:
                cigars = [
                    recover_cigar_from_stream(ops_w[b], int(n_ops[b]),
                                              pats[b], txts[b])
                    if fin[b] and n_ops[b] >= 0 else None
                    for b in range(len(chunk))
                ]
        else:
            out = engine_cuda.align_batch_cuda(cfg, *args)
            dist = out["distance"].cpu().numpy()
            fin = out["finished"].cpu().numpy()
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
    opts = options or AlignmentOptions()
    backend = _resolve_backend(opts.backend)
    run_tier = _run_tier_cuda if backend == "cuda" else _run_tier_torch
    pen = opts.penalties
    n = len(patterns)
    if n == 0:
        return []
    if len(texts) != n:
        raise ValueError("patterns and texts must have equal length")

    max_error = opts.max_error or default_max_error(
        len(patterns[0]), len(texts[0]), pen
    )
    lens = np.array(
        [max(len(p), len(t)) for p, t in zip(patterns, texts)], dtype=np.int64
    )
    have_native = _build.ensure_native()
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
        # Divergence-ordered tiling for long reads (utils/presort.py).
        hints = None
        dev_lens = lens[run_idx]
        if dev_lens.size and int(dev_lens.max()) >= MIN_PRESORT_TIER:
            hints = divergence_scores(
                [patterns[i] for i in run_idx],
                [texts[i] for i in run_idx],
                dev_lens,
            )
        for plan in _plan_tiers(dev_lens, opts, err, hints):
            idxs = [run_idx[j] for j in plan.indices]
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
    cigar = opts.compute_cigar
    if cpu_idx.size and opts.cpu_fallback:
        LOG.debug("CPU fallback for %d/%d pairs", cpu_idx.size, n)
        cpats = [patterns[i] for i in cpu_idx]
        ctxts = [texts[i] for i in cpu_idx]
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
