"""Speed-of-light calibration on the card (``csrc/sol_calibrate.cu``) and
the kernels' plain versions.

The port of benchmarks/sol_calibrate.py: the primitive costs the wavefront
kernels are built from, each on [G, 8, 128] int32 tiles (G = 1 is the TPU
function; G > 1 runs independent tiles, one block each):

- ``vpu_ops``: a dependent int32 hash chain, 8 source ops a rep, 16 reps an
  iteration;
- ``gather_chain``: each 128-lane row gathers from itself at
  ``idx0 ^ (v & 127)``, 16 dependent gathers an iteration;
- ``scalar_sync``: a tile-wide max feeding a branch (+1 or -1), one an
  iteration.

Each wrapper runs the plain version on a CPU tensor and launches the kernel
on a CUDA tensor (or raises).  ``bench_*`` time a kernel at two iteration
counts with CUDA events and take the rate from the difference, as the TPU
script does (``timed_pair``); ``resident_tiles`` gives the G that fills the
card, and ``sass_per_rep`` counts the instructions nvcc made of the chain.
"""
from __future__ import annotations

import collections
import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from ._build import _nvcc, check, check_inputs, library_path, load_library

LAUNCHES = {"vpu_ops": 0, "gather_chain": 0, "scalar_sync": 0}

TILE = (8, 128)
INNER = 16               # reps an iteration (sol_calibrate.py's INNER)
OPS_PER_REP = 8          # source ops of one rep of the vpu_ops chain
MUL, ADD = 1103515245, 12345
THREADS = (1024, 512)    # scalar_sync's blocks: one value a thread, or two
# Iteration counts (n1, n2) the TPU script times each primitive at.
COUNTS = {"vpu_ops": (200_000, 800_000), "gather_chain": (50_000, 200_000),
          "scalar_sync": (20_000, 80_000)}
_KERNEL_ID = {"vpu_ops": 0, "gather_chain": 1, "scalar_sync": 2}


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2**32 into int32's signed range."""
    return ((v + 2**31) & 0xFFFFFFFF) - 2**31


def vpu_ops_plain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` x 16 reps of v = v*1103515245 + 12345; v ^= v >>> 5;
    v += v << 3; v = max(v, v ^ 255) on int32 (wrapping, ``>>>`` logical,
    ``max`` signed), in int64 with an explicit wrap."""
    v = x.to(torch.int64)
    for _ in range(iters * INNER):
        v = _wrap32(v * MUL + ADD)
        v = v ^ ((v & 0xFFFFFFFF) >> 5)   # only bits 0..26 change: in range
        v = _wrap32(v + (v << 3))
        v = torch.maximum(v, v ^ 255)
    return v.to(torch.int32)


def gather_chain_plain(x: torch.Tensor, idx0: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` x 16 reps of v = take_along_axis(v, idx0 ^ (v & 127),
    axis=-1); idx0 counts by its low 7 bits, as in the kernel."""
    v = x.to(torch.int64)
    base = idx0.to(torch.int64) & 127
    for _ in range(iters * INNER):
        v = torch.gather(v, -1, base ^ (v & 127))
    return v.to(torch.int32)


def scalar_sync_plain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` times: m = max of each [8, 128] tile, then the tile + 1 if
    m > 0, else - 1 (wrapping)."""
    v = x.to(torch.int64)
    for _ in range(iters):
        m = v.amax(dim=(-2, -1), keepdim=True)
        v = _wrap32(v + torch.where(m > 0, 1, -1))
    return v.to(torch.int32)


def _tiles(x: torch.Tensor, iters: int, **more) -> int:
    """G of x [G, 8, 128] int32 (and of ``more``, the same shape), checked."""
    G = x.shape[0] if x.dim() == 3 else -1
    check_inputs(x.device, x=(x, torch.int32, (G, *TILE)),
                 **{k: (t, torch.int32, (G, *TILE)) for k, t in more.items()})
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    return G


def _launch_args(device: torch.device) -> tuple[int, int]:
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return device.index, torch.cuda.current_stream(device).cuda_stream


def vpu_ops(x: torch.Tensor, iters: int) -> torch.Tensor:
    """The vpu_ops chain on x [G, 8, 128] int32."""
    G = _tiles(x, iters)
    if x.device.type == "cpu":
        return vpu_ops_plain(x, iters)
    dev, stream = _launch_args(x.device)
    out = torch.empty_like(x)
    lib = load_library("sol_calibrate")
    check(lib, lib.vpu_ops_launch(x.data_ptr(), out.data_ptr(), G, iters, dev, stream))
    LAUNCHES["vpu_ops"] += 1
    return out


def gather_chain(x: torch.Tensor, idx: torch.Tensor, iters: int) -> torch.Tensor:
    """The gather chain on x, idx [G, 8, 128] int32 (idx in 0..127)."""
    G = _tiles(x, iters, idx=idx)
    if x.device.type == "cpu":
        return gather_chain_plain(x, idx, iters)
    dev, stream = _launch_args(x.device)
    out = torch.empty_like(x)
    lib = load_library("sol_calibrate")
    check(lib, lib.gather_chain_launch(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), G, iters, dev, stream))
    LAUNCHES["gather_chain"] += 1
    return out


def scalar_sync(x: torch.Tensor, iters: int, threads: int = 1024) -> torch.Tensor:
    """The max-and-branch loop on x [G, 8, 128] int32; on the card with
    blocks of ``threads`` (1024 or 512) threads."""
    G = _tiles(x, iters)
    if threads not in THREADS:
        raise ValueError(f"threads must be one of {THREADS}, got {threads}")
    if x.device.type == "cpu":
        return scalar_sync_plain(x, iters)
    dev, stream = _launch_args(x.device)
    out = torch.empty_like(x)
    lib = load_library("sol_calibrate")
    check(lib, lib.scalar_sync_launch(
        x.data_ptr(), out.data_ptr(), G, iters, threads, dev, stream))
    LAUNCHES["scalar_sync"] += 1
    return out


def resident_tiles(kernel: str, device: torch.device, threads: int = 1024) -> int:
    """G that fills the card: SMs x the blocks of ``kernel`` one SM holds."""
    device = _require_cuda(device)
    lib = load_library("sol_calibrate")
    blocks = ctypes.c_int(0)
    index = torch.cuda.current_device() if device.index is None else device.index
    check(lib, lib.sol_blocks_per_sm(_KERNEL_ID[kernel], threads, index,
                                     ctypes.byref(blocks)))
    return torch.cuda.get_device_properties(device).multi_processor_count * blocks.value


def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def timed_pair(fn, n1: int, n2: int) -> tuple[float, float]:
    """CUDA-event times (ms) of ``fn(n1)`` and ``fn(n2)``: one warm-up
    each, then the best of 3 (sol_calibrate.py::_timed_pair)."""
    fn(n1)
    fn(n2)
    t1 = t2 = float("inf")
    for _ in range(3):
        t1 = min(t1, _event_ms(lambda: fn(n1)))
        t2 = min(t2, _event_ms(lambda: fn(n2)))
    return t1, t2


def _require_cuda(device: torch.device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the calibration measures a CUDA device, not {device}")
    return device


def _rates(kind: str, tiles: int, counts, t1: float, t2: float, per_step: int,
           **extra) -> dict:
    n1, n2 = counts
    ns_step = (t2 - t1) * 1e6 / (n2 - n1)
    ns = ns_step / per_step
    return {"kernel": kind, "tiles": tiles, "counts": [n1, n2],
            "ms": [t1, t2], "ns_per_step": ns_step, "ns": ns,
            "per_s": 1e9 / ns, **extra}


def bench_vpu_ops(device, tiles: int = 1) -> dict:
    """The chain on ``tiles`` zero tiles: ``ns`` per dependent op (one op
    over every tile), ``per_s`` the TPU function's rate (ops a second), and
    ``int32_ops_per_s`` the source ops a second over all values."""
    device = _require_cuda(device)
    x = torch.zeros((tiles, *TILE), dtype=torch.int32, device=device)
    counts = COUNTS["vpu_ops"]
    t1, t2 = timed_pair(lambda n: vpu_ops(x, n), *counts)
    r = _rates("vpu_ops", tiles, counts, t1, t2, INNER * OPS_PER_REP)
    r["int32_ops_per_s"] = r["per_s"] * x.numel()
    return r


def bench_gather(device, tiles: int = 1) -> dict:
    """The gather chain on seeded random tiles (values and idx0 in 0..127):
    ``ns`` per dependent gather, ``per_s`` gathers a second."""
    device = _require_cuda(device)
    rng = np.random.default_rng(0)
    x, idx = (torch.from_numpy(rng.integers(0, 128, (tiles, *TILE), dtype=np.int32))
              .to(device) for _ in range(2))
    counts = COUNTS["gather_chain"]
    t1, t2 = timed_pair(lambda n: gather_chain(x, idx, n), *counts)
    return _rates("gather_chain", tiles, counts, t1, t2, INNER)


def bench_scalar_sync(device, tiles: int = 1, threads: int = 1024) -> dict:
    """The max-and-branch loop on tiles of ones: ``ns`` per sync, ``per_s``
    syncs a second."""
    device = _require_cuda(device)
    x = torch.ones((tiles, *TILE), dtype=torch.int32, device=device)
    counts = COUNTS["scalar_sync"]
    t1, t2 = timed_pair(lambda n: scalar_sync(x, n, threads), *counts)
    return _rates("scalar_sync", tiles, counts, t1, t2, 1, threads=threads)


def sass_per_rep() -> dict:
    """What nvcc made of the vpu_ops chain: the instructions of the built
    kernel's loop (16 reps, plus the loop's counter, compare and branch) by
    opcode, from ``cuobjdump -sass`` of the library."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library_path("sol_calibrate"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    body = _loop_body(sass, "vpu_ops_kernel")
    ops = collections.Counter(
        ins.split()[1 if ins.startswith("@") else 0].split(".")[0] for ins in body)
    return {"loop_instructions": len(body), "per_rep": len(body) / INNER,
            "opcodes": dict(ops.most_common())}


def _loop_body(sass: str, kernel: str) -> list[str]:
    """Instructions of ``kernel`` from the target of its first backward
    branch (``BRA <address>`` to a lower address) to that branch."""
    funcs = re.split(r"\n\s*Function : ", sass)
    text = next((f for f in funcs[1:] if kernel in f.split("\n", 1)[0]), None)
    if text is None:
        raise RuntimeError(f"{kernel} not in the SASS")
    instrs = []   # (address, instruction)
    for line in text.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        instrs.append((addr, m.group(2)))
        b = re.search(r"\bBRA\s+(0x[0-9a-f]+)", m.group(2))
        if b and int(b.group(1), 16) < addr:
            return [ins for a, ins in instrs if a >= int(b.group(1), 16)]
    raise RuntimeError(f"no loop found in {kernel}'s SASS")
