"""The wide-gather probe (``csrc/gather_probe.cu``) and its plain version.

The port of tools/dev_gather_probe.py::k_wide: out[r, j] = tab[r, idx[r, j]]
for tab [R, 128] int32 and idx [R, W] int32 in 0..127, one 128-entry table
per row (the TPU probe's shape is [8, 2048]).  ``k_wide`` runs the plain
version on a CPU tensor and launches the kernel on a CUDA tensor (or
raises); ``measure`` times the kernel and ``torch.gather``, the one PyTorch
call that computes the same function, on seeded random inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from ._build import check, check_inputs, load_library

LAUNCHES = {"k_wide": 0}

TAB = 128
REPS = 20   # launches timed by ``measure``, after a warm-up


def k_wide_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, j] = tab[r, idx[r, j]]."""
    return torch.gather(tab, 1, idx.to(torch.int64))


def k_wide(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The wide gather of ``tab`` [R, 128] at ``idx`` [R, W], both int32.
    On the card W must be a multiple of 4 and R at most 65535; an index
    outside 0..127 there reads the entry of its low 7 bits (the plain
    version raises)."""
    R, W = idx.shape if idx.dim() == 2 else (-1, -1)
    device = idx.device
    check_inputs(device, tab=(tab, torch.int32, (R, TAB)),
                 idx=(idx, torch.int32, (R, W)))
    if device.type == "cpu":
        return k_wide_plain(tab, idx)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if W % 4 or R > 65535 or idx.data_ptr() % 16:
        raise ValueError(f"idx [{R}, {W}]: need W a multiple of 4, R <= 65535 "
                         "and a 16-byte aligned start")
    out = torch.empty_like(idx)
    lib = load_library("gather_probe")
    check(lib, lib.k_wide_launch(
        tab.data_ptr(), idx.data_ptr(), out.data_ptr(), R, W, device.index,
        torch.cuda.current_stream(device).cuda_stream,
    ))
    LAUNCHES["k_wide"] += 1
    return out


def random_inputs(R: int, W: int, device, seed: int = 0):
    """Seeded tab [R, 128] in 0..999 and idx [R, W] in 0..127, as the TPU
    probe draws them."""
    rng = np.random.default_rng(seed)
    tab = torch.from_numpy(rng.integers(0, 1000, (R, TAB), dtype=np.int32))
    idx = torch.from_numpy(rng.integers(0, TAB, (R, W), dtype=np.int32))
    return tab.to(device), idx.to(device)


def _mean_ms(fn) -> float:
    fn()                                   # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def measure(BT: int, W: int, device=None) -> dict:
    """CUDA-event times (mean of ``REPS`` after a warm-up) of the kernel and
    of ``torch.gather`` (its int64 index made beforehand) on seeded inputs
    [BT, 128] and [BT, W], the kernel's rate over the bytes it must move,
    and whether the two agree."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    tab, idx = random_inputs(BT, W, device)
    idx64 = idx.to(torch.int64)
    ms = _mean_ms(lambda: k_wide(tab, idx))
    library_ms = _mean_ms(lambda: torch.gather(tab, 1, idx64))
    nbytes = tab.numel() * 4 + 2 * idx.numel() * 4
    return {
        "BT": BT, "W": W, "ms": ms, "library_ms": library_ms,
        "bytes": nbytes, "achieved_GBps": nbytes / ms / 1e6,
        "equal": bool(torch.equal(k_wide(tab, idx), torch.gather(tab, 1, idx64))),
    }
