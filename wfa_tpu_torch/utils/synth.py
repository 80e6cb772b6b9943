"""Seeded sequence pairs and traceback inputs for the port's tests and its
on-card smoke run.

``random_pairs`` draws DNA pairs with lengths in a range and a per-pair error
rate, some containing ``N`` and some empty; ``EDGE_PAIRS`` are fixed pairs
that reach the extension's boundary cases (sequence ends inside and exactly
at a 16-base word, the tail mask, empty and invalid sequences);
``long_run_pairs`` are near-identical pairs of a few kbp whose matching
runs cross 512 bases and reach either end; ``ring_wide_pairs`` is the wide
exact workload of ``bench.py::_bench_ring_wide_exact``; ``edge_pairs``
start their walk back at either end of a row of W diagonals.
``forged_walks`` and ``overflow_walks`` are K3 inputs no aligner gives:
random (corrupt) choice tables and a stream longer than ``opw`` words.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import engine_torch, traceback_torch
from ..types import Penalties

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


def edge_pairs(rng: np.random.Generator, width: int,
               n: int) -> list[tuple[bytes, bytes]]:
    """``n`` pairs whose walk back starts 4 to 6 diagonals from either end
    of a row of ``width`` diagonals (k = +-(width/2 - 4 .. 6)): a random
    150-base pattern and, in turn, a text that is it plus a tail of that
    length, or the other way round."""
    pairs = []
    for i in range(n):
        gap = width // 2 - 4 - int(rng.integers(0, 3))
        pat = bytes(b"ACGT"[c] for c in rng.integers(0, 4, 150))
        tail = bytes(b"ACGT"[c] for c in rng.integers(0, 4, gap))
        pairs.append((pat, pat + tail) if i % 2 else (pat + tail, pat))
    return pairs


def forged_walks(rng: np.random.Generator, tb: traceback_torch.TracebackConfig,
                 n: int, dist=None, device="cpu"):
    """K3 inputs ``(words, lo_trace or None, distance, finished, target_k)``
    for ``n`` walks over a random table and lo_trace, as a corrupt table
    gives: walks that leave the window or the row, run past the rows or read
    garbage lo.  Distances are random below 8 * num_chunks + 40 unless
    ``dist`` gives them."""
    C, W = tb.num_chunks, tb.wf_width
    words = rng.integers(-2**31, 2**31, (C, n, W), dtype=np.int64).astype(np.int32)
    lo = (rng.integers(-W, W, (n, tb.lo_pad)).astype(np.int32)
          if tb.banded else None)
    if dist is None:
        dist = rng.integers(0, 8 * C + 40, n)
    fin = rng.random(n) < 0.9
    tk = rng.integers(-W // 2, W // 2, n).astype(np.int32)
    return tuple(None if a is None else torch.from_numpy(a).to(device)
                 for a in (words, lo, np.asarray(dist, np.int32), fin, tk))


def overflow_walks(device="cpu"):
    """``(tb, words, lo_trace, distance, finished, target_k)``: every choice
    0x1 (M from I, I opened) under (1,0,1), two ops a score and k down one a
    score, lo_trace following k with the walk at lane 5.  Distance 1000
    walks 2000 ops to the origin; 1030 needs 2060 of the 2048 a stream
    holds; the third walk ends off the origin."""
    cap = 1016
    tb = traceback_torch.TracebackConfig(Penalties(1, 0, 1), 32, cap, banded=True,
                                         lo_pad=engine_torch.lo_pad(cap))
    dist = torch.tensor([1000, 1030, 1000], dtype=torch.int32)
    tk = torch.tensor([1000, 1030, 990], dtype=torch.int32)
    words = torch.full((tb.num_chunks, 3, 32), 0x11111111, dtype=torch.int32)
    s = torch.arange(tb.lo_pad)
    # Column s: k at score s is tk - (dist - s); lo puts it at lane 5.
    lo = torch.stack([t - (d - s) - 5 for t, d in zip(tk.tolist(), dist.tolist())])
    return (tb, *(t.to(device) for t in (words, lo.to(torch.int32), dist,
                                         torch.ones(3, dtype=torch.bool), tk)))
