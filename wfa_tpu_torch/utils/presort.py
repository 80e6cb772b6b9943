"""Divergence-ordered tiling hints.

The port's own copy of ``wfa_tpu/utils/presort.py``.  Within a length tier,
pairs are ordered by a cheap estimate of their divergence, so that pairs of
similar distance run next to each other: sample ~32 k-mers of the pattern
and test whether each occurs in the text within an indel-drift window around
its own position; the miss fraction tracks the pair's divergence.
``bytes.find`` runs at C speed, so the cost is tens of µs per long read.
"""
from __future__ import annotations

import numpy as np

# Only long tiers are scored: short ones finish together anyway, and could
# not amortize the scan.
MIN_PRESORT_TIER = 4096


def divergence_score(
    pattern: bytes,
    text: bytes,
    anchors: int = 32,
    k: int = 12,
) -> float:
    """Estimated divergence in [0, 1]; monotone-ish in alignment distance.

    The drift window is capped: anchors past the cumulative-indel horizon of
    a high-divergence pair read as misses, which only pushes its score
    further up, so the ranking is preserved while the scan stays cheap.
    """
    L = min(len(pattern), len(text))
    if L < 4 * k:
        return 0.0
    step = max(1, (L - k) // anchors)
    hits = 0
    total = 0
    for pos in range(0, L - k, step):
        slack = min(32 + (pos >> 3), 192)
        w0 = max(0, pos - slack)
        w1 = min(len(text), pos + k + slack)
        hits += text.find(pattern[pos : pos + k], w0, w1) >= 0
        total += 1
    return 1.0 - hits / max(total, 1)


def divergence_scores(patterns, texts, lens=None) -> np.ndarray:
    """Scores for every pair; pairs below MIN_PRESORT_TIER get 0 (their
    relative order then falls back to length)."""
    out = np.zeros(len(patterns))
    for i, (p, t) in enumerate(zip(patterns, texts)):
        if lens is not None and lens[i] < MIN_PRESORT_TIER:
            continue
        out[i] = divergence_score(p, t)
    return out
