"""Seeded sequence pairs for the port's tests and its on-card smoke run.

``random_pairs`` draws DNA pairs with lengths in a range and a per-pair error
rate, some containing ``N`` and some empty; ``EDGE_PAIRS`` are fixed pairs
that reach the extension's boundary cases (sequence ends inside and exactly
at a 16-base word, the tail mask, empty and invalid sequences).
"""
from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

EDGE_PAIRS: list[tuple[bytes, bytes]] = [
    (b"", b""),
    (b"", b"ACGT"),
    (b"ACG", b""),
    (b"A" * 16, b"A" * 16),
    (b"A" * 16, b"A" * 32),
    (b"A" * 32, b"A" * 17),
    (b"ACGT", b"ACGT" + b"A" * 40),
    (b"ACGT" + b"A" * 40, b"ACGT"),
    (b"ACGT" * 8, b"ACGT" * 8),
    (b"C" * 31, b"C" * 33),
    (b"ACGTN", b"ACGT"),
    (b"GATTACA", b"GATTACA"),
    (b"A", b"TTTT"),
    (b"AAAA", b"TTTT"),
]


def _mutate(rng: np.random.Generator, seq: list[int], err: float) -> list[int]:
    out = list(seq)
    for _ in range(int(len(seq) * err)):
        op = rng.integers(3)
        pos = int(rng.integers(max(1, len(out))))
        base = int(_BASES[rng.integers(4)])
        if op == 0 and out:
            out[pos] = base
        elif op == 1:
            out.insert(pos, base)
        elif len(out) > 1:
            del out[pos]
    return out


def random_pairs(
    rng: np.random.Generator,
    n: int,
    min_len: int = 10,
    max_len: int = 1000,
    max_err: float = 0.25,
    n_rate: float = 0.05,
    empty_rate: float = 0.03,
) -> list[tuple[bytes, bytes]]:
    """``n`` pairs: a random pattern, and a text that is the pattern with
    ``len * U(0, max_err)`` random substitutions, insertions and deletions.
    A share ``n_rate`` of the pairs gets an ``N`` in one sequence and a share
    ``empty_rate`` an empty pattern or text."""
    pairs = []
    for _ in range(n):
        length = int(rng.integers(min_len, max_len + 1))
        pat = [int(c) for c in _BASES[rng.integers(0, 4, length)]]
        txt = _mutate(rng, pat, float(rng.uniform(0.0, max_err)))
        if rng.random() < n_rate:
            side = pat if rng.random() < 0.5 else txt
            if side:
                side[int(rng.integers(len(side)))] = ord("N")
        if rng.random() < empty_rate:
            if rng.random() < 0.5:
                pat = []
            else:
                txt = []
        pairs.append((bytes(pat), bytes(txt)))
    return pairs
