"""The benchmark's check of a CIGAR: it must replay the pattern into the
text (M over equal bases, X over different ones, I taking text bases, D
pattern bases, both ends met) and cost, under gap-affine penalties with
match 0, exactly the distance the reference computed.  A CIGAR that passes
is an alignment of the reference's score; one that does not is wrong."""
from __future__ import annotations

import re

_RUN = re.compile(r"(\d+)([MXID])")


def cost(cigar: str, pattern: bytes, text: bytes, x: int, o: int,
         e: int) -> int | None:
    """The CIGAR's gap-affine cost, or None if it does not replay."""
    runs = _RUN.findall(cigar)
    if "".join(n + op for n, op in runs) != cigar:
        return None
    p = t = total = 0
    prev = ""
    for n_s, op in runs:
        n = int(n_s)
        if n == 0:
            return None
        if op == "M":
            if pattern[p : p + n] != text[t : t + n] or p + n > len(pattern) \
                    or t + n > len(text):
                return None
            p, t = p + n, t + n
        elif op == "X":
            if p + n > len(pattern) or t + n > len(text) or any(
                    a == b for a, b in zip(pattern[p : p + n], text[t : t + n])):
                return None
            p, t = p + n, t + n
            total += n * x
        else:
            total += n * e + (o if op != prev else 0)
            if op == "I":
                t += n
            else:
                p += n
        prev = op
    if p != len(pattern) or t != len(text):
        return None
    return total
