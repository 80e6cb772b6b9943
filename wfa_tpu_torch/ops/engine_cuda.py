"""Wrappers of the CUDA kernels: K1, K2 and K4 (``csrc/wfa_distance.cu``)
and K3 (``csrc/wfa_traceback.cu``).

``align_batch_cuda`` (K1) takes the tensors of
``engine_torch.align_batch_device`` and returns the same outputs.
``cigar_tables_cuda`` (K2) returns those of ``engine_torch.cigar_tables``,
``traceback_cuda`` (K3) those of ``traceback_torch.traceback_batch_device``,
and ``align_cigar_cuda`` launches K2 then K3 and returns the fused rows of
``traceback_torch.align_cigar_fused``.  With ``cfg.ring_global`` the first
two and ``align_cigar_cuda`` launch K4 in place of K1 and K2: the same
outputs, with each alignment's [3A, W] ring in a global scratch buffer
rather than in shared memory.  On CPU tensors each runs its plain version;
on CUDA tensors it launches its kernel on the current stream or raises — it
never falls back.  ``LAUNCHES`` counts each kernel's launches, so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..schedule import build_schedule
from . import engine_torch, traceback_torch
from ._build import check, check_inputs, load_library
from .engine_torch import EngineConfig
from .traceback_torch import TracebackConfig

LAUNCHES = {
    "wfa_distance": 0, "wfa_cigar": 0, "wfa_traceback": 0,
    "wfa_distance_ring": 0, "wfa_cigar_ring": 0,
}

_SCRATCH_INTS = 66  # kScratchInts in csrc/wfa_distance.cu


def smem_bytes(active_working_set: int, width: int, cigar: bool = False,
               ring_global: bool = False) -> int:
    """Shared memory of one block: the [3A, W] int32 ring (none for K4), the
    per-slot window base and extent, the argmin scratch and, in CIGAR mode,
    one choice row word per diagonal (csrc smem_bytes)."""
    A = active_working_set
    ring = 0 if ring_global else 3 * A * width
    return 4 * (ring + 2 * A + _SCRATCH_INTS + (width if cigar else 0))


def ring_bytes(active_working_set: int, width: int) -> int:
    """K4's global ring per alignment: [3A, W] int32."""
    return 4 * 3 * active_working_set * width


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


@functools.lru_cache(maxsize=64)
def _schedule_tensor(penalties, max_steps, score_limit, device):
    sched = build_schedule(penalties, max_steps, score_limit)
    rows = torch.stack([
        torch.from_numpy(a) for a in (
            sched.score, sched.out_slot, sched.mx_slot,
            sched.moe_slot, sched.ide_slot,
        )
    ], dim=1).to(torch.int32).contiguous()
    last = int(sched.score[-1]) if sched.num_steps else 0
    return rows.to(device), sched.num_steps, sched.unfinished_score, last


def _check_batch(cfg: EngineConfig, pat, txt, plen, tlen, valid, cigar: bool):
    """Validate the inputs of K1/K2/K4 on a CUDA device (a band with
    ``ring_global`` cannot reach here: ``EngineConfig`` refuses it); returns
    (B, nw)."""
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
    W = cfg.wf_width
    if W <= 0 or W % 32:
        raise ValueError(f"wf_width {W} must be a positive multiple of 32")
    A = cfg.penalties.active_working_set
    need = smem_bytes(A, W, cigar, cfg.ring_global)
    have = smem_optin(device)
    if need > have:
        raise ValueError(
            f"block of {need} bytes of shared memory (A={A}, W={W}, "
            f"cigar={cigar}, ring_global={cfg.ring_global}) exceeds the "
            f"{have} bytes a block may use"
        )
    return B, nw


def _ring(cfg: EngineConfig, B: int, device) -> torch.Tensor | None:
    """K4's [B, 3A, W] scratch ring (each block resets its own slab), or
    None for the shared-memory ring."""
    if not cfg.ring_global:
        return None
    A = cfg.penalties.active_working_set
    return torch.empty((B, 3 * A, cfg.wf_width), dtype=torch.int32,
                       device=device)


def align_batch_cuda(
    cfg: EngineConfig,
    pat: torch.Tensor,    # [B, NW] int32 (u32 bit patterns)
    txt: torch.Tensor,    # [B, NW] int32
    plen: torch.Tensor,   # [B] int32
    tlen: torch.Tensor,   # [B] int32
    valid: torch.Tensor,  # [B] bool
) -> dict[str, torch.Tensor]:
    """K1 (K4 with ``cfg.ring_global``): distances and finished flags of
    one batch."""
    if pat.device.type == "cpu":
        return engine_torch.align_batch_device(cfg, pat, txt, plen, tlen, valid)
    B, nw = _check_batch(cfg, pat, txt, plen, tlen, valid, cigar=False)
    device = pat.device
    sched, num_steps, unfinished, _ = _schedule_tensor(
        cfg.penalties, cfg.max_steps, cfg.score_limit, device
    )
    dist = torch.empty(B, dtype=torch.int32, device=device)
    fin = torch.empty(B, dtype=torch.bool, device=device)
    ring = _ring(cfg, B, device)
    lib = load_library("wfa_distance")
    stream = torch.cuda.current_stream(device).cuda_stream
    check(lib, lib.wfa_distance_launch(
        pat.data_ptr(), txt.data_ptr(), nw,
        plen.data_ptr(), tlen.data_ptr(), valid.data_ptr(),
        sched.data_ptr(), num_steps, unfinished,
        cfg.penalties.active_working_set, cfg.wf_width,
        cfg.band if cfg.banded else -1,
        dist.data_ptr(), fin.data_ptr(),
        None if ring is None else ring.data_ptr(), B, device.index, stream,
    ))
    LAUNCHES["wfa_distance_ring" if cfg.ring_global else "wfa_distance"] += 1
    return {"distance": dist, "finished": fin}


def cigar_tables_cuda(
    cfg: EngineConfig, score_cap: int, pat, txt, plen, tlen, valid,
) -> dict[str, torch.Tensor]:
    """K2 (K4 with ``cfg.ring_global``): ``distance``, ``finished``,
    ``choice_words`` [score_cap//8 + 2, B, W] int32 and, banded,
    ``lo_trace`` [B, lo_pad(score_cap)] int32.

    The table and ``lo_trace`` come from ``torch.empty``, not
    ``torch.zeros``: K2 stores every row that holds a scheduled score up to
    each alignment's distance, and K3 reads no other, so clearing the table
    (310 MB at HiFi x8, a memset about as long as a tenth of K2) buys
    nothing.  Rows past an alignment's distance hold whatever the memory
    held; compare tables only where a walk can read."""
    if pat.device.type == "cpu":
        return engine_torch.cigar_tables(
            cfg, score_cap, pat, txt, plen, tlen, valid
        )
    B, nw = _check_batch(cfg, pat, txt, plen, tlen, valid, cigar=True)
    device = pat.device
    sched, num_steps, unfinished, last = _schedule_tensor(
        cfg.penalties, cfg.max_steps, cfg.score_limit, device
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
    ring = _ring(cfg, B, device)
    lib = load_library("wfa_distance")
    stream = torch.cuda.current_stream(device).cuda_stream
    check(lib, lib.wfa_cigar_launch(
        pat.data_ptr(), txt.data_ptr(), nw,
        plen.data_ptr(), tlen.data_ptr(), valid.data_ptr(),
        sched.data_ptr(), num_steps, unfinished,
        cfg.penalties.active_working_set, W, cfg.band if cfg.banded else -1,
        dist.data_ptr(), fin.data_ptr(), words.data_ptr(), C,
        lo_ptr, lo_stride, None if ring is None else ring.data_ptr(),
        B, device.index, stream,
    ))
    LAUNCHES["wfa_cigar_ring" if cfg.ring_global else "wfa_cigar"] += 1
    return res


def traceback_cuda(
    tb_cfg: TracebackConfig,
    choice_words: torch.Tensor,      # [C, B, W] int32
    lo_trace: torch.Tensor | None,   # [B, lo_pad] int32 (banded) or None
    dist: torch.Tensor,              # [B] int32
    fin: torch.Tensor,               # [B] bool
    target_k: torch.Tensor,          # [B] int32
) -> torch.Tensor:
    """K3: the fused rows [B, 4 + opw] int32 (distance, finished, n_ops, 0,
    ops...)."""
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
    tensors = dict(
        choice_words=(choice_words, torch.int32, (C, B, W)),
        dist=(dist, torch.int32, (B,)), fin=(fin, torch.bool, (B,)),
        target_k=(target_k, torch.int32, (B,)),
    )
    if tb_cfg.banded:
        tensors["lo_trace"] = (lo_trace, torch.int32, (B, tb_cfg.lo_pad))
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
        B, W, pen.x, pen.o, pen.e, opw, out.data_ptr(), device.index, stream,
    ))
    LAUNCHES["wfa_traceback"] += 1
    return out


def align_cigar_cuda(
    cfg: EngineConfig, tb_cfg: TracebackConfig, pat, txt, plen, tlen, valid,
) -> torch.Tensor:
    """K2 (K4 with ``cfg.ring_global``) then K3 on the current stream:
    [B, 4 + opw] int32 rows (distance, finished, n_ops, 0, ops...), the
    output of ``traceback_torch.align_cigar_fused``."""
    if pat.device.type == "cpu":
        return traceback_torch.align_cigar_fused(
            cfg, tb_cfg, pat, txt, plen, tlen, valid
        )
    if (cfg.wf_width, cfg.banded) != (tb_cfg.wf_width, tb_cfg.banded):
        raise ValueError("the engine and traceback configs disagree")
    if cfg.banded and tb_cfg.lo_pad != engine_torch.lo_pad(tb_cfg.score_cap):
        raise ValueError(f"lo_pad must be {engine_torch.lo_pad(tb_cfg.score_cap)}")
    tables = cigar_tables_cuda(
        cfg, tb_cfg.score_cap, pat, txt, plen, tlen, valid
    )
    return traceback_cuda(
        tb_cfg, tables["choice_words"], tables.get("lo_trace"),
        tables["distance"], tables["finished"], tlen - plen,
    )
