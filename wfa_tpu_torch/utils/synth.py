"""Seeded sequence pairs for the port's tests and its on-card smoke run.

``random_pairs`` draws DNA pairs with lengths in a range and a per-pair error
rate, some containing ``N`` and some empty; ``EDGE_PAIRS`` are fixed pairs
that reach the extension's boundary cases (sequence ends inside and exactly
at a 16-base word, the tail mask, empty and invalid sequences);
``long_run_pairs`` are near-identical pairs of a few kbp whose matching
runs cross 512 bases and reach either end; ``ring_wide_pairs`` is the wide
exact workload of ``bench.py::_bench_ring_wide_exact``.
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


def long_run_pairs(rng: np.random.Generator, n: int, min_len: int = 2000,
                   max_len: int = 5000) -> list[tuple[bytes, bytes]]:
    """``n`` near-identical pairs of ``min_len..max_len`` bases, in turn:
    identical (a run to both ends); the text a prefix of the pattern and the
    pattern a prefix of the text (runs that end at ``tlen`` or at ``plen``);
    substitutions 511, 512 or 513 bases apart (runs of about one 32-word
    round of the extension, and just past it); a few random edits (runs of
    hundreds to thousands of bases); and homopolymers of unequal length,
    where every diagonal of a warp has a long run at once."""
    pairs = []
    for i in range(n):
        length = int(rng.integers(min_len, max_len + 1))
        pat = [int(c) for c in _BASES[rng.integers(0, 4, length)]]
        kind = i % 6
        if kind == 0:
            txt = list(pat)
        elif kind == 1:
            txt = pat[: length - int(rng.integers(1, 40))]
        elif kind == 2:
            txt = pat
            pat = txt[: length - int(rng.integers(1, 40))]
        elif kind == 3:
            txt = list(pat)
            pos = -1
            while (pos := pos + 511 + int(rng.integers(3))) < length:
                txt[pos] = int(_BASES[(list(_BASES).index(txt[pos]) + 1) % 4])
        elif kind == 4:
            txt = _mutate(rng, pat, float(rng.uniform(0.0005, 0.003)))
        else:
            pat = [int(_BASES[i % 4])] * length
            txt = pat[: length - int(rng.integers(0, 9))] + [int(_BASES[(i + 1) % 4])]
        pairs.append((bytes(pat), bytes(txt)))
    return pairs


def ring_wide_pairs(seed: int = 7, n: int = 16,
                    length: int = 5000) -> list[tuple[bytes, bytes]]:
    """``n`` pairs of ``length`` bases, the text the pattern with half its
    positions resampled (about 37.5% mismatches): exact distances near
    0.75 * length at penalties (2,3,1), past the certificate of any window
    narrower than 2 * 0.75 * length diagonals.  The generator of
    ``bench.py::_bench_ring_wide_exact``, draw for draw."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        p = rng.choice(_BASES, size=length)
        t = p.copy()
        k = int(length * 0.5)
        t[rng.choice(length, size=k, replace=False)] = rng.choice(_BASES, size=k)
        pairs.append((bytes(p), bytes(t)))
    return pairs
