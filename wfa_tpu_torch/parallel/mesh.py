"""Data-parallel execution over this process's devices (``wfa_tpu/parallel/mesh.py``).

Alignments are independent, so the batch dimension is split over a list of
devices, pure data parallelism: each device runs the whole engine on its
contiguous block of the batch, with no communication between devices, and
the outputs are concatenated in order on the host.  ``wfa_tpu`` does this
with ``shard_map`` over a 1-D ``("data",)`` mesh; here a "mesh" is a list of
``torch.device``.

Which engine a block runs on is set by its device: the wrappers of
``ops/engine_cuda.py`` launch the kernels on a CUDA device and run their
plain versions on the CPU.  Each CUDA block gets its own stream, made per
call, and its copy in, its launches and its copy out are enqueued on it; all
blocks are enqueued before any is waited on, so that several cards run at
once from one host thread.  A device may appear more than once (two blocks
on one card, or several on the CPU).  Blocks need not be equal: the kernels
have no tile, so a batch of any size splits (``torch.tensor_split``), and no
padding pair is made.

Multi-host: ``distributed.py`` gives each process its strided shard of the
global batch first, so a mesh spans one process's local devices only.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence

import torch

from ..ops import engine_cuda, engine_torch
from ..ops.engine_torch import EngineConfig
from ..ops.traceback_torch import TracebackConfig

# The batch dimension of each output of the plain engine.
_OUT_DIM = {"distance": 0, "finished": 0, "choices": 1, "lo_trace": 1,
            "ext_trace": 1}


def data_mesh(devices=None) -> list[torch.device]:
    """The devices a batch is split over, in block order.

    Defaults to this process's CUDA devices, ``cuda:0`` to
    ``cuda:{device_count() - 1}``: the CLI host-shards the batch first, so
    each process splits its own shard over its own cards.  An explicit list
    may repeat a device."""
    if devices is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [_device(d) for d in devices]


def _device(d) -> torch.device:
    """``d`` as a torch.device; a CUDA device without an index is the
    current one."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_count(mesh: Sequence[torch.device] | None) -> int:
    return len(mesh) if mesh is not None else 1


def _on(t: torch.Tensor | None, device: torch.device) -> torch.Tensor | None:
    if t is None:
        return None
    return t.to(device, non_blocking=True).contiguous()


def _to_host(out):
    if isinstance(out, dict):
        return {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
    return out.to("cpu", non_blocking=True)


def _run_blocks(mesh: Sequence[torch.device], fn: Callable,
                args: Sequence[tuple[torch.Tensor | None, int]],
                wait: bool = True):
    """``fn`` on the i-th contiguous block of every argument on ``mesh[i]``.

    ``args`` are (tensor or None, batch dimension) pairs.  Returns each
    block's output on the host, in block order, once all are done; with
    ``wait=False``, once everything is enqueued, a function that waits for
    the blocks and returns the same list (the aligner's chunk loop enqueues
    the next chunk meanwhile).  A batch smaller than the mesh uses its first
    devices, one pair each."""
    if not mesh:
        raise ValueError("no device to run on")
    n = next(t.shape[dim] for t, dim in args if t is not None)
    if n == 0:
        raise ValueError("empty batch")
    mesh = [_device(d) for d in mesh][:n]
    blocks = [
        torch.tensor_split(t, len(mesh), dim) if t is not None
        else (None,) * len(mesh)
        for t, dim in args
    ]
    # Build and load the kernels before any block is enqueued.
    for d in mesh:
        if d.type == "cuda":
            engine_cuda.smem_optin(d)
    launched = []
    for i, d in enumerate(mesh):
        part = [b[i] for b in blocks]
        if d.type != "cuda":
            launched.append((fn(*(_on(t, d) for t in part)), None))
            continue
        stream = torch.cuda.Stream(d)
        with torch.cuda.device(d):
            # The inputs may come from work still queued on the caller's stream.
            stream.wait_stream(torch.cuda.current_stream(d))
            with torch.cuda.stream(stream):
                launched.append((fn(*(_on(t, d) for t in part)), stream))
    # The copies back only after every launch: a pinned host allocation
    # between two launches would keep them from running at once.
    pending = []
    for out, stream in launched:
        if stream is None:
            pending.append((out, None))
            continue
        with torch.cuda.stream(stream):
            done = torch.cuda.Event()
            pending.append((_to_host(out), done))
            done.record(stream)

    def finish() -> list:
        outs = []
        for out, done in pending:
            if done is not None:
                done.synchronize()
            outs.append(out)
        return outs

    return finish() if wait else finish


def _cat(outs: list) -> dict[str, torch.Tensor]:
    return {k: torch.cat([o[k] for o in outs], dim=_OUT_DIM[k]) for k in outs[0]}


def _batch_args(pat, txt, plen, tlen, valid):
    return [(pat, 0), (txt, 0), (plen, 0), (tlen, 0), (valid, 0)]


def align_batch_sharded(
    cfg: EngineConfig,
    mesh: Sequence[torch.device],
    pat: torch.Tensor,
    txt: torch.Tensor,
    plen: torch.Tensor,
    tlen: torch.Tensor,
    valid: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """The plain engine (``engine_torch.align_batch_device``, the XLA
    engine's counterpart) on each block; the outputs of one call over the
    whole batch, on the host.  In CIGAR mode the per-step tables keep each
    block's own steps: a block's loop ends when its own pairs are done."""
    return _cat(_run_blocks(
        mesh, lambda *a: engine_torch.align_batch_device(cfg, *a),
        _batch_args(pat, txt, plen, tlen, valid),
    ))


def align_batch_pallas_sharded(
    cfg: EngineConfig,
    mesh: Sequence[torch.device],
    pat: torch.Tensor,
    txt: torch.Tensor,
    plen: torch.Tensor,
    tlen: torch.Tensor,
    valid: torch.Tensor,
    *, wait: bool = True,
):
    """K1 (K4 with ``cfg.ring_global``) on each block
    (``engine_cuda.align_batch_cuda``): ``distance`` and ``finished`` on the
    host; with ``wait=False`` a function that waits and returns them."""
    finish = _run_blocks(
        mesh, lambda *a: engine_cuda.align_batch_cuda(cfg, *a),
        _batch_args(pat, txt, plen, tlen, valid), wait=False,
    )
    return _cat(finish()) if wait else lambda: _cat(finish())


def align_cigar_fused_sharded(
    cfg: EngineConfig,
    tb_cfg: TracebackConfig,
    mesh: Sequence[torch.device],
    pat: torch.Tensor,
    txt: torch.Tensor,
    plen: torch.Tensor,
    tlen: torch.Tensor,
    valid: torch.Tensor,
    *, wait: bool = True,
):
    """K2 (K4 with ``cfg.ring_global``) then K3 on each block
    (``engine_cuda.align_cigar_cuda``): the [B, 4 + opw] int32 rows on the
    host, or with ``wait=False`` a function that waits and returns them;
    ``opw`` comes from ``tb_cfg`` alone, so every block's rows are as
    wide."""
    finish = _run_blocks(
        mesh, lambda *a: engine_cuda.align_cigar_cuda(cfg, tb_cfg, *a),
        _batch_args(pat, txt, plen, tlen, valid), wait=False,
    )
    return torch.cat(finish()) if wait else lambda: torch.cat(finish())


def traceback_batch_sharded(
    tb_cfg: TracebackConfig,
    mesh: Sequence[torch.device],
    choice_words: torch.Tensor,      # [C, B, W] int32
    lo_trace: torch.Tensor | None,   # [B, lo_pad] int32 (banded) or None
    dist: torch.Tensor,              # [B] int32
    fin: torch.Tensor,               # [B] bool
    target_k: torch.Tensor,          # [B] int32
) -> torch.Tensor:
    """K3 on each block (``engine_cuda.traceback_cuda``): the choice words
    split on their batch dimension 1, the rest on 0; the [B, 4 + opw] int32
    rows on the host."""
    return torch.cat(_run_blocks(
        mesh, lambda *a: engine_cuda.traceback_cuda(tb_cfg, *a),
        [(choice_words, 1), (lo_trace, 0), (dist, 0), (fin, 0), (target_k, 0)],
    ))
