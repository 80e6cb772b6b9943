"""K4's ring-row traffic probe (``csrc/ring_bw.cu``) and its plain version.

The probe replaces ``tools/dev_dma_bw.py::kernel``: per step it reads 4 rows
of a wavefront ring and writes 3, each written row the row read + 1, here on
K4's layout (one [R, W] int32 slab per alignment, R = 3A) with the TPU
kernel's output aliased onto its input.  ``ring_bw`` runs the plain version
on a CPU tensor and launches the kernel on a CUDA tensor (or raises);
``measure`` gives the rate of the kernel's ring traffic from the difference
of two step counts, as the TPU tool does.
"""
from __future__ import annotations

import torch

from ._build import check, check_inputs, load_library

LAUNCHES = {"ring_bw": 0}

READS, WRITES = 4, 3


def ring_bw_plain(ring: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` steps on ``ring`` [B, R, W] int32, in place: at step i, with
    row = i % (R - 5) as in dev_dma_bw.py, read rows row .. row + 3 and write
    rows row .. row + 2 as the values read + 1.  Returns [B] int32, the sum
    (mod 2**32) of every value each slab read."""
    acc = torch.zeros(ring.shape[0], dtype=torch.int64, device=ring.device)
    span = ring.shape[1] - READS - 1
    for i in range(steps):
        row = i % span
        vals = ring[:, row : row + READS].clone()
        acc += vals.to(torch.int64).sum(dim=(1, 2))
        ring[:, row : row + WRITES] = vals[:, :WRITES] + 1
    acc &= 0xFFFFFFFF
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)


def ring_bw(ring: torch.Tensor, steps: int) -> torch.Tensor:
    """The probe on ``ring`` [B, R, W] int32 (updated in place); returns the
    per-slab sums of ``ring_bw_plain``."""
    device = ring.device
    if device.type == "cpu":
        return ring_bw_plain(ring, steps)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    B, R, W = ring.shape
    check_inputs(device, ring=(ring, torch.int32, (B, R, W)))
    if R <= READS + 1 or W % 32 or steps < 0:
        raise ValueError(f"ring [{B}, {R}, {W}] and {steps} steps: need "
                         f"R > {READS + 1}, W a multiple of 32, steps >= 0")
    acc = torch.empty(B, dtype=torch.int32, device=device)
    lib = load_library("ring_bw")
    check(lib, lib.ring_bw_launch(
        ring.data_ptr(), B, R, W, steps, acc.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream,
    ))
    LAUNCHES["ring_bw"] += 1
    return acc


def step_bytes(B: int, W: int) -> int:
    """Bytes one step moves: 4 rows read and 3 written per slab."""
    return (READS + WRITES) * B * W * 4


def measure(B: int, W: int, rows: int, steps=(256, 2048), reps: int = 3,
            device=None) -> dict:
    """The kernel's ring traffic on [B, rows, W] int32 zeros: CUDA-event
    times of ``steps[0]`` and ``steps[1]`` steps (best of ``reps`` after a
    warm-up), and the rate from their difference."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    ring = torch.zeros((B, rows, W), dtype=torch.int32, device=device)
    ms = {}
    for n in steps:
        ring_bw(ring, n)                      # warm-up
        best = float("inf")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ring_bw(ring, n)
            end.record()
            torch.cuda.synchronize(device)
            best = min(best, start.elapsed_time(end))
        ms[n] = best
    lo, hi = steps
    dt_s = (ms[hi] - ms[lo]) / 1e3
    return {
        "B": B, "W": W, "rows": rows, "ring_bytes": B * rows * W * 4,
        "bytes_per_step": step_bytes(B, W),
        "ms": {str(n): ms[n] for n in steps},
        "per_step_us": dt_s / (hi - lo) * 1e6,
        "achieved_GBps": step_bytes(B, W) * (hi - lo) / dt_s / 1e9,
    }
