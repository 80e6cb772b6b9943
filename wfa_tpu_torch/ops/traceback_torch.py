"""The backward walk over the by-score choice table, in plain PyTorch.

The plain version of K3 (``ops/csrc/wfa_traceback.cu``), which replaces
``wfa_tpu/ops/traceback_pallas.py::_traceback_kernel``.  Every finished
alignment of nonzero distance walks from (M, distance, tlen - plen) back to
the origin through the table K2 wrote, and emits a backward stream of 2-bit
ops, 16 per int32 word: SUB for each M cell, INS for each I cell, DEL for
each D cell.  The host replays the stream into a CIGAR
(``native.cigar_from_ops_batch``), so no choice table crosses to the host.

The walk runs the whole batch in lockstep, one masked tensor update per
step, until no lane is walking.  ``n_ops`` is -1 for a corrupt walk (a
diagonal outside [0, W), an op stream past ``opw * 16`` ops, or a walk that
does not end at d == 0, k == 0 in M) and 0 where there is no walk
(unfinished, or distance 0): the rules of the Pallas kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from ..types import AffineOp, Penalties
from . import engine_torch
from .engine_torch import M_FROM_I, M_FROM_X, EngineConfig

OPS_PER_WORD = 16  # 2-bit ops per int32 stream word


def ops_stream_words(score_cap: int) -> int:
    """Stream words per alignment (traceback_pallas.py:56-59).  Every op
    either lowers the score by >= 1 or is a mat-switch SUB followed by a
    lowering op, so ops <= 2 * distance + 1."""
    return engine_torch._round_up(
        (2 * score_cap + 1 + OPS_PER_WORD) // OPS_PER_WORD, engine_torch._LANE
    )


@dataclasses.dataclass(frozen=True)
class TracebackConfig:
    """Configuration of the walk (traceback_pallas.py:62-82), without the
    TPU's lockstep tile height."""

    penalties: Penalties
    wf_width: int        # W of the choice table
    score_cap: int       # table rows C = score_cap // 8 + 2
    banded: bool         # True: per-score lo_trace input; False: lo = -W/2
    lo_pad: int = 0      # lo_trace length (banded only)

    def __post_init__(self):
        if self.banded and self.lo_pad <= 0:
            raise ValueError("a banded walk needs lo_pad > 0")

    @property
    def num_chunks(self) -> int:
        return engine_torch.num_chunks(self.score_cap)

    @property
    def opw(self) -> int:
        return ops_stream_words(self.score_cap)


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """u32 bit patterns held in int64 -> the int32 of the same bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def traceback_batch_device(
    cfg: TracebackConfig,
    choice_words: torch.Tensor,        # [C, B, W] int32
    lo_trace: torch.Tensor | None,     # [B, lo_pad] int32 (banded) or None
    dist: torch.Tensor,                # [B] int32
    fin: torch.Tensor,                 # [B] bool
    target_k: torch.Tensor,            # [B] int32 (= tlen - plen)
) -> dict[str, torch.Tensor]:
    """The plain K3: ``ops`` int32 [B, opw], the backward op streams, and
    ``n_ops`` int32 [B] (-1 corrupt walk, 0 no walk); the outputs of
    ``traceback_pallas.traceback_batch_device``."""
    C, B, W = choice_words.shape
    device = choice_words.device
    x, e = cfg.penalties.x, cfg.penalties.e
    oe = cfg.penalties.o + e
    opw = cfg.opw
    flat = choice_words.reshape(-1)
    lane = torch.arange(B, device=device)
    i64 = dict(dtype=torch.int64, device=device)

    walk = fin.to(torch.bool) & (dist > 0)
    d = torch.where(walk, dist.to(torch.int64), 0)
    k = target_k.to(torch.int64).clone()
    mat = torch.zeros(B, **i64)
    p = torch.zeros(B, **i64)
    acc = torch.zeros(B, **i64)
    err = torch.zeros(B, dtype=torch.bool, device=device)
    ops = torch.zeros(B * opw, dtype=torch.int32, device=device)

    while True:
        live = (d > 0) & ~err
        if not bool(live.any()):
            break
        if cfg.banded:
            lo = lo_trace[lane, d.clamp(0, lo_trace.shape[1] - 1)].to(torch.int64)
        else:
            lo = -(W // 2)
        j = k - lo
        row = d >> 3
        bad = live & ((j < 0) | (j >= W) | (row >= C))
        err = err | bad
        on = live & ~bad
        idx = (row.clamp(0, C - 1) * B + lane) * W + j.clamp(0, W - 1)
        word = flat[idx].to(torch.int64) & 0xFFFFFFFF
        ch = (word >> (4 * (d & 7))) & 0xF

        is_m = mat == 0
        is_i = mat == 1
        c2 = ch & 3
        ext = torch.where(is_i, (ch >> 2) & 1, (ch >> 3) & 1)
        op = torch.where(
            is_m, int(AffineOp.SUB),
            torch.where(is_i, int(AffineOp.INS), int(AffineOp.DEL)),
        )
        d_dec = torch.where(
            is_m, torch.where(c2 == M_FROM_X, x, 0), torch.where(ext != 0, e, oe)
        )
        new_mat = torch.where(
            is_m,
            torch.where(c2 == M_FROM_X, 0, torch.where(c2 == M_FROM_I, 1, 2)),
            torch.where(ext != 0, mat, 0),
        )
        dk = torch.where(is_m, 0, torch.where(is_i, -1, 1))

        d = torch.where(on, d - d_dec, d)
        k = torch.where(on, k + dk, k)
        mat = torch.where(on, new_mat, mat)
        acc = torch.where(on, acc | (op << (2 * (p & 15))), acc)
        # Each walking lane's current stream word holds its ops so far.
        ops[(lane * opw + (p >> 4))[on]] = _to_int32(acc[on])
        acc = torch.where(on & ((p & 15) == 15), 0, acc)
        p = torch.where(on, p + 1, p)
        err = err | (on & (p >= opw * OPS_PER_WORD))

    ok = ~err & (d == 0) & (k == 0) & (mat == 0)
    n_ops = torch.where(walk, torch.where(ok, p, -1), 0).to(torch.int32)
    return {"ops": ops.view(B, opw), "n_ops": n_ops}


def fuse(dist, fin, n_ops, ops) -> torch.Tensor:
    """[B, 4 + opw] int32 rows (distance, finished, n_ops, 0, ops...), the
    one array the host copies back (traceback_pallas.py:346-375)."""
    stats = torch.stack(
        [dist.to(torch.int32), fin.to(torch.int32), n_ops,
         torch.zeros_like(n_ops)], dim=1,
    )
    return torch.cat([stats, ops], dim=1)


def align_cigar_fused(
    cfg: EngineConfig, tb_cfg: TracebackConfig, pat, txt, plen, tlen, valid,
) -> torch.Tensor:
    """The plain K2 + K3: [B, 4 + opw] int32 rows (distance, finished,
    n_ops, 0, ops...), the output of ``traceback_pallas.align_cigar_fused``."""
    tables = engine_torch.cigar_tables(
        cfg, tb_cfg.score_cap, pat, txt, plen, tlen, valid
    )
    tb = traceback_batch_device(
        tb_cfg, tables["choice_words"], tables.get("lo_trace"),
        tables["distance"], tables["finished"],
        (tlen.to(torch.int32) - plen.to(torch.int32)),
    )
    return fuse(tables["distance"], tables["finished"], tb["n_ops"], tb["ops"])
