"""The least time the kernels' work could take on one H100, from the inputs
and each pair's distance alone: never from anything a kernel reports.

A frozen copy of ``chip_smoke.py``'s arithmetic (``bound_ms`` and
``exact_bound``, with its peaks and operation counts), so that a later
change to the program cannot move the yardstick.

Cells: for each pair, every scheduled score s up to its distance, times the
diagonals s can reach: the cone, 2 * ((s - o) // e) + 1 from o + e on (one
below it), at most W.  A band narrows no cone, so banded windows count the
same way; the cone is less than or equal to what any window computes, so the
share cannot pass 100%.  Each cell costs OPS_PER_CELL int32 operations
(OPS_PER_CELL_CIGAR with the choice nibble).  With CIGARs the walk back
costs OPS_PER_WALK_STEP a step, and a walk has at least distance / max(x,
o + e) steps.  Bytes: the packed inputs (2 bits a base, 16 a word) and
lengths read once, distance and flag written once; with CIGARs, one choice
word a reachable diagonal per 8 scores (the widest score of the 8) and the
2-bit op stream of at least max(len) ops.
"""
from __future__ import annotations

import numpy as np

# H100 SXM: 3.35 TB/s of HBM; 128 int32 lane-instructions an SM and clock
# (the INT32 pipe plus IMAD on the FMA pipe), 132 SMs at the boost clock:
# 67e12 / 2 int32 ops/s (the port's calibration kernel measured 32.6e12).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
# I 8, D 6, M 10, one 16-base comparison 8; the choice nibble 6 more.
OPS_PER_CELL = 32
OPS_PER_CELL_CIGAR = OPS_PER_CELL + 6
OPS_PER_WALK_STEP = 12


def least_seconds(nbytes: float, ops: float) -> float:
    """The larger of bytes over the HBM rate and ops over the int32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def work(scores: np.ndarray, pen: tuple[int, int, int], width: int,
         dist: np.ndarray, plen: np.ndarray, tlen: np.ndarray,
         cigar: bool) -> tuple[float, float]:
    """(int32 ops, bytes) of a batch: ``scores`` the scheduled scores after
    0 in order, ``pen`` (x, o, e), ``width`` W, ``dist`` each pair's
    distance, ``plen``/``tlen`` its lengths."""
    x, o, e = pen
    s = np.asarray(scores, dtype=np.int64)
    lanes = np.where(s >= o + e, np.minimum(width, 2 * ((s - o) // e) + 1), 1)
    upto = np.searchsorted(s, np.asarray(dist, np.int64), side="right")
    cells = float(np.concatenate([[0], np.cumsum(lanes)])[upto].sum())
    words = (np.ceil(np.asarray(plen) / 16) + np.ceil(np.asarray(tlen) / 16)) * 4
    nbytes = float(words.sum()) + 14.0 * len(dist)
    if not cigar:
        return cells * OPS_PER_CELL, nbytes
    # A group of 8 scores stores one word a lane of its last (widest) score.
    group = s >> 3
    last = np.append(group[1:] != group[:-1], True)
    row = np.concatenate([[0], np.cumsum(np.where(last, lanes, 0))])
    # The group a pair's distance falls in is stored up to that distance.
    partial = np.where(upto > 0, lanes[np.maximum(upto - 1, 0)], 0)
    partial = np.where((upto > 0) & ~last[np.maximum(upto - 1, 0)], partial, 0)
    row_words = float((row[upto] + partial).sum())
    steps = float(np.ceil(np.asarray(dist) / max(x, o + e)).sum())
    ops_stream = float((np.maximum(plen, tlen) / 4).sum())
    return (cells * OPS_PER_CELL_CIGAR + steps * OPS_PER_WALK_STEP,
            nbytes + row_words * 4 + ops_stream)
