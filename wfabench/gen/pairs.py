"""The general pair generator: one traffic file of parameters -> the pool of
batches a cell's calls cycle through.

The pairs in one ``align_pairs`` call are the configuration's
``batch_size``, which the harness passes in.  Keys of a traffic file that
this generator reads:

* ``pool_calls``: distinct batches in the pool;
* ``source``: ``"random"``, or the name of a ``.seq`` or ``.seq.gz`` file
  under ``wfabench/data/`` (``>pattern`` / ``<text`` lines);
* ``length`` (random only): ``[lo, hi]``; a batch's lengths are spread
  evenly over the range and shuffled, so that every seed draws the same
  set of sizes;
* ``edit_rate``: edits a base made by ``mutate_batch`` to each pattern
  (random: to a copy of the pattern, which is the text).

A file source gives each batch every pair of the file ``batch_size /
len(file)`` times, in a seeded order, each copy's pattern with edits of its
own, so that no two pairs of the pool are equal and every seed has the same
lengths.  Only A, C, G and T are drawn, so that every pair can run on the
card.
"""
from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def mutate_batch(rng: np.random.Generator, seqs: list[bytes],
                 err: float) -> list[bytes]:
    """Substitutions and single-base indels at about ``err`` a base: of
    ``int(len * err)`` random positions 60% substituted, 20% deleted and
    20% inserted after (``bench.py::_mutate_batch``, draw for draw)."""
    out = []
    for s in seqs:
        arr = np.frombuffer(s, dtype=np.uint8).copy()
        n = len(arr)
        nmut = int(n * err)
        pos = rng.integers(0, n, size=nmut)
        kinds = rng.random(nmut)
        sub_pos = pos[kinds < 0.6]
        arr[sub_pos] = _BASES[rng.integers(0, 4, size=len(sub_pos))]
        del_pos = np.unique(pos[(kinds >= 0.6) & (kinds < 0.8)])
        keep = np.ones(n, dtype=bool)
        keep[del_pos] = False
        arr = arr[keep]
        ins_pos = np.sort(pos[kinds >= 0.8]) % max(len(arr), 1)
        arr = np.insert(arr, ins_pos, _BASES[rng.integers(0, 4, size=len(ins_pos))])
        out.append(arr.tobytes())
    return out


def read_pairs(path: Path) -> list[tuple[bytes, bytes]]:
    """(pattern, text) pairs of a ``.seq`` file (``>`` then ``<`` lines)."""
    raw = path.read_bytes()
    if path.suffix == ".gz":
        raw = gzip.decompress(raw)
    pats, txts = [], []
    for line in raw.splitlines():
        if line.startswith(b">"):
            pats.append(line[1:].strip())
        elif line.startswith(b"<"):
            txts.append(line[1:].strip())
    if len(pats) != len(txts) or not pats:
        raise ValueError(f"{path}: {len(pats)} patterns, {len(txts)} texts")
    return list(zip(pats, txts))


def _clean(seq: bytes) -> bool:
    return bool(np.isin(np.frombuffer(seq, np.uint8), _BASES).all())


def make_pool(traffic: dict, batch_size: int, seed: int,
              data_dir: Path) -> list[tuple[list[bytes], list[bytes]]]:
    """``traffic["pool_calls"]`` batches of ``batch_size`` pairs, each
    ``(patterns, texts)``."""
    rng = np.random.default_rng(seed & (2**64 - 1))
    n = int(batch_size)
    rate = float(traffic["edit_rate"])
    pool = []
    if traffic["source"] == "random":
        lo, hi = traffic["length"]
        lengths = np.rint(np.linspace(lo, hi, n)).astype(int)
        for _ in range(int(traffic["pool_calls"])):
            pats = [_BASES[rng.integers(0, 4, int(L))].tobytes()
                    for L in rng.permutation(lengths)]
            pool.append((pats, mutate_batch(rng, pats, rate)))
        return pool
    pairs = read_pairs(data_dir / traffic["source"])
    if n % len(pairs):
        raise ValueError(f"batch_size {n} is not a multiple of the "
                         f"{len(pairs)} pairs of {traffic['source']}")
    if not all(_clean(p) and _clean(t) for p, t in pairs):
        raise ValueError(f"{traffic['source']} holds bases other than ACGT")
    for _ in range(int(traffic["pool_calls"])):
        order = rng.permutation(np.tile(np.arange(len(pairs)), n // len(pairs)))
        texts = [pairs[i][1] for i in order]
        pool.append((mutate_batch(rng, [pairs[i][0] for i in order], rate),
                     texts))
    return pool
