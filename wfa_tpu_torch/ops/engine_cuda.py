"""K1 wrapper: batched WFA distance on the CUDA kernel ``csrc/wfa_distance.cu``.

``align_batch_cuda`` takes the tensors of ``engine_torch.align_batch_device``
and returns the same outputs.  On CPU tensors it runs that plain version; on
CUDA tensors it launches the kernel on the current stream or raises — it never
falls back.  ``LAUNCHES`` counts kernel launches, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from wfa_tpu.schedule import build_schedule

from . import engine_torch
from ._build import load_library
from .engine_torch import EngineConfig

LAUNCHES = 0

_SCRATCH_INTS = 66  # kScratchInts in csrc/wfa_distance.cu


def smem_bytes(active_working_set: int, width: int) -> int:
    """Shared memory of one block: the [3A, W] int32 ring, the per-slot
    window base and extent, and the argmin scratch (csrc smem_bytes)."""
    A = active_working_set
    return 4 * (3 * A * width + 2 * A + _SCRATCH_INTS)


def max_width(active_working_set: int, smem: int) -> int:
    """Widest multiple-of-128 window whose ring fits ``smem`` bytes."""
    A = active_working_set
    return (smem - 4 * (2 * A + _SCRATCH_INTS)) // (12 * A) // 128 * 128


@functools.lru_cache(maxsize=None)
def smem_optin(device: torch.device) -> int:
    """Shared memory one block of this device may opt in to."""
    lib = load_library()
    out = ctypes.c_int(0)
    _check(lib, lib.wfa_smem_optin(device.index, ctypes.byref(out)))
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
    return rows.to(device), sched.num_steps, sched.unfinished_score


def _check(lib, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"CUDA error {rc}: {lib.wfa_cuda_error_string(rc).decode()}"
        )


def align_batch_cuda(
    cfg: EngineConfig,
    pat: torch.Tensor,    # [B, NW] int32 (u32 bit patterns)
    txt: torch.Tensor,    # [B, NW] int32
    plen: torch.Tensor,   # [B] int32
    tlen: torch.Tensor,   # [B] int32
    valid: torch.Tensor,  # [B] bool
) -> dict[str, torch.Tensor]:
    """Distances and finished flags of one batch; see module docstring."""
    if pat.device.type == "cpu":
        return engine_torch.align_batch_device(cfg, pat, txt, plen, tlen, valid)
    global LAUNCHES
    device = pat.device
    if device.type != "cuda":
        raise ValueError(f"align_batch_cuda: unsupported device {device}")
    B, nw = pat.shape
    for name, t, dtype, shape in (
        ("pat", pat, torch.int32, (B, nw)),
        ("txt", txt, torch.int32, (B, nw)),
        ("plen", plen, torch.int32, (B,)),
        ("tlen", tlen, torch.int32, (B,)),
        ("valid", valid, torch.bool, (B,)),
    ):
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    W = cfg.wf_width
    if W <= 0 or W % 32:
        raise ValueError(f"wf_width {W} must be a positive multiple of 32")
    A = cfg.penalties.active_working_set
    need = smem_bytes(A, W)
    have = smem_optin(device)
    if need > have:
        raise ValueError(
            f"wavefront ring of {need} bytes (A={A}, W={W}) exceeds the "
            f"{have} bytes of shared memory a block may use"
        )
    sched, num_steps, unfinished = _schedule_tensor(
        cfg.penalties, cfg.max_steps, cfg.score_limit, device
    )
    dist = torch.empty(B, dtype=torch.int32, device=device)
    fin = torch.empty(B, dtype=torch.bool, device=device)
    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    _check(lib, lib.wfa_distance_launch(
        pat.data_ptr(), txt.data_ptr(), nw,
        plen.data_ptr(), tlen.data_ptr(), valid.data_ptr(),
        sched.data_ptr(), num_steps, unfinished,
        A, W, cfg.band if cfg.banded else -1,
        dist.data_ptr(), fin.data_ptr(), B, device.index, stream,
    ))
    LAUNCHES += 1
    return {"distance": dist, "finished": fin}
