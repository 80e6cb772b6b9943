"""CIGAR recovery in Python, used when the native library is missing.

The port's own copy of ``wfa_tpu/traceback.py`` (the role of the
reference's utils/cigar.c:96-272 ``recover_cigar_affine``):

1.  Walk the DP backwards from (M, final score, target diagonal) using the
    per-step choice table the engine recorded (2 bits for M's winning source,
    1 bit each for I/D gap-open vs gap-extend).  Each visited M cell
    contributes an OP_SUB, each I an OP_INS, each D an OP_DEL.
2.  Replay the op stream forward through the run-length emitter, re-deriving
    match runs by LCP extension on the raw sequences and treating a SUB that
    closes an I/D run as a pure delimiter (utils/cigar.c:119-268).

``wfa_tpu_torch.native`` binds the C++ decoders with the same semantics.
"""
from __future__ import annotations

import numpy as np

from .schedule import WavefrontSchedule
from .types import AffineOp, Penalties

# Choice encoding (ops/engine_torch.py, ops/csrc/wfa_distance.cu).
M_FROM_X = 0
M_FROM_I = 1
M_FROM_D = 2


def walk_ops(
    choices: np.ndarray,   # [S, W] uint8 for one alignment
    lo_trace: np.ndarray,  # [S] int32 window base per step
    sched: WavefrontSchedule,
    distance: int,
    target_k: int,
) -> list[int]:
    """Backward DP walk -> forward-ordered op list (AffineOp values)."""
    x = sched.penalties.x
    oe = sched.penalties.o + sched.penalties.e
    e = sched.penalties.e
    step_of = {int(d): s for s, d in enumerate(sched.score)}

    ops_rev: list[int] = []
    mat = 0  # 0=M, 1=I, 2=D
    d = int(distance)
    k = int(target_k)
    while d > 0:
        s = step_of[d]
        j = k - int(lo_trace[s])
        if j < 0 or j >= choices.shape[1] or s >= choices.shape[0]:
            raise ValueError(
                f"traceback out of bounds (d={d} s={s} j={j} "
                f"table={choices.shape})"
            )
        ch = int(choices[s, j])
        if mat == 0:
            ops_rev.append(AffineOp.SUB)
            c = ch & 3
            if c == M_FROM_X:
                d -= x
            elif c == M_FROM_I:
                mat = 1
            else:
                mat = 2
        elif mat == 1:
            ops_rev.append(AffineOp.INS)
            if ch & 4:  # gap-extend
                d -= e
            else:       # gap-open
                mat = 0
                d -= oe
            k -= 1
        else:
            ops_rev.append(AffineOp.DEL)
            if ch & 8:
                d -= e
            else:
                mat = 0
                d -= oe
            k += 1
    if mat != 0 or d != 0 or k != 0:
        raise ValueError(
            f"traceback did not close at origin (mat={mat} d={d} k={k})"
        )
    ops_rev.reverse()
    return ops_rev


def _lcp(pattern: bytes, text: bytes, v: int, h: int) -> int:
    """Longest common prefix of pattern[v:] vs text[h:] (cigar.c:63-94)."""
    n = min(len(pattern) - v, len(text) - h)
    acc = 0
    while acc < n and pattern[v + acc] == text[h + acc]:
        acc += 1
    return acc


def ops_to_cigar(ops: list[int], pattern: bytes, text: bytes) -> str:
    """Forward decode with the reference's run-length semantics
    (cigar.c:96-272)."""
    out: list[str] = []
    rep = 0
    prev_op = -1
    extending = False
    k = 0
    offset = 0

    def emit(op_idx: int, count: int) -> None:
        if count:
            out.append(f"{count}{'?IXD'[op_idx]}")

    for op in ops:
        if op != prev_op and rep != 0:
            emit(prev_op, rep)
            rep = 0
        if not extending:
            acc = _lcp(pattern, text, offset - k, offset)
            if acc > 0:
                if rep != 0:
                    emit(prev_op, rep)
                    rep = 0
                out.append(f"{acc}M")
                offset += acc
        if op == AffineOp.DEL:
            extending = True
            k -= 1
        elif op == AffineOp.SUB:
            if extending:
                extending = False
                op = AffineOp.NOOP
                rep -= 1
            else:
                offset += 1
        elif op == AffineOp.INS:
            extending = True
            k += 1
            offset += 1
        prev_op = op
        rep += 1

    if rep != 0:
        emit(prev_op, rep)
    if not extending:
        acc = _lcp(pattern, text, offset - k, offset)
        if acc > 0:
            out.append(f"{acc}M")
    return "".join(out)


def recover_cigar(
    choices: np.ndarray,
    lo_trace: np.ndarray,
    sched: WavefrontSchedule,
    distance: int,
    pattern: bytes,
    text: bytes,
) -> str:
    """CIGAR of one finished alignment from the per-step choice table."""
    if distance == 0:
        return f"{len(text)}M"
    target_k = len(text) - len(pattern)
    ops = walk_ops(choices, lo_trace, sched, distance, target_k)
    return ops_to_cigar(ops, pattern, text)


def walk_ops_packed(
    words: np.ndarray,        # [C, W] int32 nibble-packed choices for one pair
    lo_of_score,              # callable score -> window base
    pen: Penalties,
    distance: int,
    target_k: int,
) -> list[int]:
    """Backward walk over the by-score nibble-packed table (the 4-bit choice
    of score d at words[d >> 3, j] >> 4*(d & 7))."""
    x, oe, e = pen.x, pen.o + pen.e, pen.e

    ops_rev: list[int] = []
    mat = 0
    d = int(distance)
    k = int(target_k)
    while d > 0:
        j = k - lo_of_score(d)
        if j < 0 or j >= words.shape[1] or (d >> 3) >= words.shape[0]:
            raise ValueError(
                f"packed traceback out of bounds (d={d} j={j} "
                f"table={words.shape})"
            )
        ch = (int(words[d >> 3, j]) >> (4 * (d & 7))) & 0xF
        if mat == 0:
            ops_rev.append(AffineOp.SUB)
            c = ch & 3
            if c == M_FROM_X:
                d -= x
            elif c == M_FROM_I:
                mat = 1
            else:
                mat = 2
        elif mat == 1:
            ops_rev.append(AffineOp.INS)
            if ch & 4:
                d -= e
            else:
                mat = 0
                d -= oe
            k -= 1
        else:
            ops_rev.append(AffineOp.DEL)
            if ch & 8:
                d -= e
            else:
                mat = 0
                d -= oe
            k += 1
    if mat != 0 or d != 0 or k != 0:
        raise ValueError(
            f"packed traceback did not close at origin (mat={mat} d={d} k={k})"
        )
    ops_rev.reverse()
    return ops_rev


def recover_cigar_packed(
    words: np.ndarray,          # [C, W] int32 for one alignment
    lo_trace: np.ndarray | None,  # [>=max_score] int32 by score, or None
    lo_const: int,
    pen: Penalties,
    distance: int,
    pattern: bytes,
    text: bytes,
) -> str:
    """CIGAR of one finished alignment from the packed choice table."""
    if distance == 0:
        return f"{len(text)}M"
    if lo_trace is None:
        lo_of = lambda d: lo_const
    else:
        lo_of = lambda d: int(lo_trace[d])
    target_k = len(text) - len(pattern)
    ops = walk_ops_packed(words, lo_of, pen, distance, target_k)
    return ops_to_cigar(ops, pattern, text)


def ops_from_stream(words_row: np.ndarray, n_ops: int) -> list[int]:
    """Unpack a backward op stream (16 2-bit ops per int32 word) into
    forward-ordered AffineOp values."""
    ops = [
        (int(words_row[i >> 4]) >> (2 * (i & 15))) & 3 for i in range(n_ops)
    ]
    ops.reverse()
    return ops


def recover_cigar_from_stream(
    words_row: np.ndarray,  # [OPW] int32 for one alignment
    n_ops: int,
    pattern: bytes,
    text: bytes,
) -> str:
    """CIGAR from the backward walk's op stream (the Python twin of
    ``native.cigar_from_ops_batch``)."""
    return ops_to_cigar(ops_from_stream(words_row, n_ops), pattern, text)
