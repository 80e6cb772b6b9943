"""Alignment verification: replay a run-length CIGAR against the sequences
and recompute its gap-affine score.

The port's own copy of ``wfa_tpu/utils/verification.py`` (Python
equivalents of the reference's utils/verification.c: ``check_cigar_edit``
:27-89 and ``check_affine_distance`` :91-146), used by the CLI's ``-c`` and
by the tests.
"""
from __future__ import annotations

import re

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
