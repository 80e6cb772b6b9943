"""Multi-host bring-up and batch partitioning (``wfa_tpu/parallel/distributed.py``).

Alignments are independent, so a run over several hosts (one process a
host) is pure striding: each process aligns its own strided shard of the
global batch on its local cards and writes or gathers only its own scores.
``torch.distributed`` carries what crosses processes, on the ``gloo``
backend: the scores it gathers are host arrays already, and NCCL would need
them on a card, one card per rank.

Typical use, in each process:

    from wfa_tpu_torch.parallel.distributed import initialize, host_shard
    initialize()                       # torchrun's environment, or explicit
    mine = host_shard(len(patterns))   # this process's slice of the batch
    results = align_pairs_pipelined(
        [patterns[i] for i in mine], [texts[i] for i in mine], opts)

Scores are then written per process (merged offline with
``merge_sharded_scores``) or gathered with ``allgather_scores``.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank once a process group is up, else 0."""
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """The number of processes once a process group is up, else 1."""
    return dist.get_world_size() if _initialized() else 1


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the process group (idempotent).

    ``coordinator_address`` is ``host:port`` of process 0.  Arguments left
    out are read from torchrun's environment (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  With no coordinator
    configured at all this is a no-op: one process.  Once a coordinator is
    configured, a failure to join raises."""
    if _initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator_address is None:
        return
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"]) if "WORLD_SIZE" in env else None
    if process_id is None:
        process_id = int(env["RANK"]) if "RANK" in env else None
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address} given without the number of "
            "processes and this process's id (arguments, or WORLD_SIZE and "
            "RANK)"
        )
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )


def host_shard(n: int, process_id: int | None = None,
               num_processes: int | None = None) -> np.ndarray:
    """Indices of the global batch this host is responsible for.

    Strided (not blocked) so every host sees the same length mix — keeps the
    per-tier tile shapes, and therefore compile caches, identical across
    hosts.
    """
    pid = process_index() if process_id is None else process_id
    nproc = process_count() if num_processes is None else num_processes
    return np.arange(pid, n, nproc)


def shard_batch(
    patterns: list,
    texts: list,
    output_file: str | None = None,
    process_id: int | None = None,
    num_processes: int | None = None,
):
    """Restrict a global batch to this host's strided shard.

    Returns (patterns, texts, output_file) where output_file gets a
    ``.{process_id}`` suffix so every host writes its own results (merge
    offline or with ``allgather_scores``).  The CLI multi-host branch is a
    thin call to this, so the logic is unit-testable with injected
    process_id/num_processes.
    """
    pid = process_index() if process_id is None else process_id
    nproc = process_count() if num_processes is None else num_processes
    mine = host_shard(len(patterns), pid, nproc)
    out = f"{output_file}.{pid}" if output_file else output_file
    return (
        [patterns[i] for i in mine],
        [texts[i] for i in mine],
        out,
    )


def merge_sharded_scores(
    per_host: list[np.ndarray], total: int
) -> np.ndarray:
    """Undo the strided host sharding: per_host[p][j] is global index
    p + j*nproc.  Inverse of host_shard for score arrays (e.g. after
    allgather_scores); rows longer than the host's shard (allgather
    padding) are trimmed."""
    nproc = len(per_host)
    out = np.empty(total, dtype=np.asarray(per_host[0]).dtype)
    for p, arr in enumerate(per_host):
        k = len(range(p, total, nproc))
        out[p:total:nproc] = np.asarray(arr)[:k]
    return out


def allgather_scores(
    local_scores: np.ndarray,
    total: int | None = None,
    fill: int = -1,
) -> np.ndarray:
    """Gather every process's score array to every process:
    [num_processes, width].

    ``all_gather`` needs equal-length arrays in every process, but
    ``host_shard`` shards are unequal whenever ``total % nproc != 0`` — pass
    ``total`` (the global batch size) and each process pads its shard to
    ``ceil(total/nproc)`` with ``fill`` before the collective; the padding
    is trimmed again by `merge_sharded_scores`.  Without ``total`` the
    local arrays must already be equal-length across processes.  With one
    process this is ``local[None]``.
    """
    local = np.asarray(local_scores)
    nproc = process_count()
    if total is not None:
        width = -(-total // nproc)
        padded = np.full(width, fill, dtype=local.dtype)
        padded[: len(local)] = local
        local = padded
    if nproc == 1:
        return local[None]
    mine = torch.from_numpy(np.ascontiguousarray(local))
    parts = [torch.empty_like(mine) for _ in range(nproc)]
    dist.all_gather(parts, mine)
    return torch.stack(parts).numpy()
