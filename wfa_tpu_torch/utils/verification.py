"""Alignment verification: replay a run-length CIGAR against the sequences
and recompute its gap-affine score.

The port's own copy of ``wfa_tpu/utils/verification.py`` (Python
equivalents of the reference's utils/verification.c: ``check_cigar_edit``
:27-89 and ``check_affine_distance`` :91-146), used by the CLI's ``-c`` and
by the tests; ``gotoh_distance`` is the O(n*m) dynamic-programming oracle
that the tests hold exact scores to.
"""
from __future__ import annotations

import re

import numpy as np

from ..types import Penalties

_CIGAR_RE = re.compile(r"(\d+)([MXIDS])")


def parse_cigar(cigar: str) -> list[tuple[int, str]]:
    runs = [(int(n), op) for n, op in _CIGAR_RE.findall(cigar)]
    if "".join(f"{n}{op}" for n, op in runs) != cigar:
        raise ValueError(f"malformed CIGAR: {cigar!r}")
    return runs


def check_cigar(cigar: str, pattern: bytes, text: bytes) -> bool:
    """Replay the CIGAR; M must match, X must mismatch, ends must meet."""
    p = 0
    t = 0
    for n, op in parse_cigar(cigar):
        if op == "M":
            if pattern[p : p + n] != text[t : t + n]:
                return False
            p += n
            t += n
        elif op == "X":
            for _ in range(n):
                if p >= len(pattern) or t >= len(text) or pattern[p] == text[t]:
                    return False
                p += 1
                t += 1
        elif op == "I":
            t += n
        elif op == "D":
            p += n
        else:
            return False
    return p == len(pattern) and t == len(text)


def affine_score(cigar: str, penalties: Penalties) -> int:
    """Gap-affine cost of a CIGAR (match=0), cf. verification.c:91-146."""
    x, o, e = penalties.x, penalties.o, penalties.e
    score = 0
    prev = ""
    for n, op in parse_cigar(cigar):
        if op == "X":
            score += n * x
        elif op in ("I", "D"):
            score += o + n * e if prev != op else n * e
        prev = op
    return score


def gotoh_distance(pattern: bytes, text: bytes, penalties: Penalties) -> int:
    """O(n*m) gap-affine DP oracle (min cost, match=0)."""
    x, o, e = penalties.x, penalties.o, penalties.e
    n, m = len(pattern), len(text)
    big = 1 << 29
    p = np.frombuffer(pattern, dtype=np.uint8)
    t = np.frombuffer(text, dtype=np.uint8)

    M = np.full(m + 1, big, dtype=np.int64)
    I = np.full(m + 1, big, dtype=np.int64)
    D = np.full(m + 1, big, dtype=np.int64)
    M[0] = 0
    if m > 0:
        I[1:] = o + e * np.arange(1, m + 1)
        M[1:] = I[1:]
    for i in range(1, n + 1):
        prevM = M.copy()
        prevD = D.copy()
        D = np.minimum(prevM + o + e, prevD + e)
        M_new = np.full(m + 1, big, dtype=np.int64)
        I_new = np.full(m + 1, big, dtype=np.int64)
        M_new[0] = D[0]
        sub = prevM[:-1] + np.where(p[i - 1] == t, 0, x)
        run_i = big
        for j in range(1, m + 1):
            run_i = min(M_new[j - 1] + o + e, run_i + e)
            I_new[j] = run_i
            M_new[j] = min(sub[j - 1], I_new[j], D[j])
        M, I = M_new, I_new
    return int(M[m])
