"""Public aligner API of the PyTorch/CUDA port (distance path).

The counterpart of ``wfa_tpu/aligner.py``: pairs are binned into length tiers
(``wfa_tpu.aligner._plan_tiers``), each tier runs on the device engine, pairs
the device leaves unfinished get the on-device retry ladder, and what is still
unfinished, ``N``-containing or oversized goes to the native CPU fallback.

Backends: ``cuda`` runs the hand-written kernel (``ops/engine_cuda.py``) and
never carries on on the CPU; ``torch`` runs the plain PyTorch engine on CPU
tensors at the XLA route's window widths, so its results equal
``wfa_tpu.align_pairs(backend='xla')``; ``auto`` picks ``cuda`` when a CUDA
device is present.
"""
from __future__ import annotations

import numpy as np
import torch

from wfa_tpu import native
from wfa_tpu.aligner import WfaAligner as _WfaAlignerBase
from wfa_tpu.aligner import _plan_tiers, _round_up
from wfa_tpu.ops.packing import _ACGT, pack_batch
from wfa_tpu.params import AlignmentOptions, default_max_error
from wfa_tpu.types import MAX_SEQ_LEN, AlignmentResult
from wfa_tpu.utils.logger import LOG
from wfa_tpu.utils.presort import MIN_PRESORT_TIER, divergence_scores

from .ops import _build, engine_cuda
from .ops.engine_cuda import align_batch_cuda
from .ops.engine_torch import EngineConfig, batch_to_tensors

BACKENDS = ("auto", "torch", "cuda")
_LANE = 128
# Pairs per kernel launch: one block per pair, so this only bounds the
# packed host arrays.
_CUDA_CALL_BATCH = 1 << 16


def _resolve_backend(name: str) -> str:
    if name not in BACKENDS:
        raise ValueError(f"backend {name!r} not in {BACKENDS}")
    if name == "auto":
        return "cuda" if torch.cuda.is_available() else "torch"
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("backend='cuda' needs a CUDA device; none is available")
    return name


def _tier_geometry_cuda(plan, opts: AlignmentOptions, max_error: int,
                        band: int, smem_bytes: int):
    """Launch geometry of one tier on the CUDA kernel; host arithmetic only.

    The window is ``plan.wf_width`` rounded up to 128 diagonals, as on the
    Pallas route, so banded scores equal ``wfa_tpu``'s at the same W.  An
    exact window wider than the shared-memory ring allows is truncated to the
    cap and certified: leaving a centred +-W/2 window costs at least
    ``o + e*(W/2+1)``, so a distance below that bound is optimal; the loop
    stops at the bound.  A banded window is never truncated.

    Returns (EngineConfig, full_window, cert_bound)."""
    pen = opts.penalties
    A = pen.active_working_set
    w = _round_up(plan.wf_width, _LANE)
    score_limit = None
    full_window = True
    if opts.banded:
        if engine_cuda.smem_bytes(A, w) > smem_bytes:
            raise ValueError(
                f"banded window W={w} with working set {A} needs "
                f"{engine_cuda.smem_bytes(A, w)} bytes of shared memory; "
                f"a block has {smem_bytes}"
            )
    else:
        cap = engine_cuda.max_width(A, smem_bytes)
        if cap < _LANE:
            raise ValueError(
                f"working set {A} leaves no {_LANE}-diagonal window in "
                f"{smem_bytes} bytes of shared memory"
            )
        w = min(w, cap)
        full_window = w >= plan.wf_width
        score_limit = plan.score_limit
    cert_bound = pen.o + pen.e * (w // 2 + 1)
    if not full_window:
        score_limit = (
            cert_bound if score_limit is None else min(score_limit, cert_bound)
        )
    cfg = EngineConfig(
        penalties=pen, max_steps=max_error, wf_width=w, band=band,
        score_limit=score_limit,
    )
    return cfg, full_window, cert_bound


def _run_tier(patterns, texts, idxs, plan, opts, max_error, band, backend,
              results, need_cpu) -> None:
    """Run one length tier on the device engine; unfinished or uncertified
    pairs are flagged in ``need_cpu``."""
    pen = opts.penalties
    if backend == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        cfg, full_window, cert_bound = _tier_geometry_cuda(
            plan, opts, max_error, band, engine_cuda.smem_optin(device)
        )
        call_b = _CUDA_CALL_BATCH
    else:
        device = torch.device("cpu")
        cfg = EngineConfig(
            penalties=pen, max_steps=max_error, wf_width=plan.wf_width,
            band=band, score_limit=None if opts.banded else plan.score_limit,
        )
        full_window, cert_bound = True, 0
        call_b = plan.tile_batch
    LOG.debug(
        "%s tier=%d pairs=%d W=%d band=%d full_window=%s cert_bound=%d",
        backend, plan.tier, len(idxs), cfg.wf_width, band, full_window,
        cert_bound,
    )
    for start in range(0, len(idxs), call_b):
        chunk = idxs[start : start + call_b]
        pat_w, p_len, p_ok = pack_batch([patterns[i] for i in chunk], plan.nwords)
        txt_w, t_len, t_ok = pack_batch([texts[i] for i in chunk], plan.nwords)
        out = align_batch_cuda(
            cfg, *batch_to_tensors(pat_w, p_len, txt_w, t_len, p_ok & t_ok, device)
        )
        dist = out["distance"].cpu().numpy()
        fin = out["finished"].cpu().numpy()
        for b, i in enumerate(chunk):
            if fin[b] and (full_window or int(dist[b]) < cert_bound):
                results[i] = AlignmentResult(
                    error=int(dist[b]), finished_on_accelerator=True
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
    if opts.compute_cigar:
        raise NotImplementedError(
            "CIGAR path is not ported yet (ROADMAP.md queue 1, item 7)"
        )
    backend = _resolve_backend(opts.backend)
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
        # Divergence-ordered tiling for long reads (wfa_tpu/utils/presort.py).
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
            _run_tier(
                patterns, texts, idxs, plan, opts, err, band, backend,
                results, need_cpu,
            )

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
    if cpu_idx.size and opts.cpu_fallback:
        LOG.debug("CPU fallback for %d/%d pairs", cpu_idx.size, n)
        cpats = [patterns[i] for i in cpu_idx]
        ctxts = [texts[i] for i in cpu_idx]
        if have_native:
            # WFA-adaptive on the CPU iff the device ran banded.
            dist, _, _ = native.cpu_align_batch(
                cpats, ctxts, pen, np.ones(len(cpats), dtype=np.int8), False,
                adaptive=opts.banded,
            )
        else:
            from wfa_tpu.utils.cpu_wfa import align_one_py

            dist = [align_one_py(p, t, pen, False)[0] for p, t in zip(cpats, ctxts)]
        for j, i in enumerate(cpu_idx):
            results[i] = AlignmentResult(
                error=int(dist[j]), finished_on_accelerator=False
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


class WfaAligner(_WfaAlignerBase):
    """Stateful wrapper (add_sequences / align) over this package's
    pipelined ``align_pairs``."""

    def align(self) -> list[AlignmentResult]:
        from .pipeline import align_pairs_pipelined

        self.results = align_pairs_pipelined(
            self._patterns, self._texts, self.options
        )
        return self.results
