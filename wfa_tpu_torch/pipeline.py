"""Streaming batch pipeline over this package's ``align_pairs``.

The same two-deep thread pipeline as ``wfa_tpu/pipeline.py``: the batch is
split into ``options.batch_size`` chunks and two worker threads run
``align_pairs`` on them, so the host stages of one chunk (packing, CPU
fallback in native code that releases the GIL) overlap the device work of the
other.  Results equal one ``align_pairs`` call over the whole batch.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

from .aligner import align_pairs
from .params import AlignmentOptions, default_max_error
from .types import AlignmentResult


def align_pairs_pipelined(
    patterns: list[bytes],
    texts: list[bytes],
    options: AlignmentOptions | None = None,
) -> list[AlignmentResult]:
    """Batched, pipelined front-end over ``align_pairs``."""
    opts = options or AlignmentOptions()
    n = len(patterns)
    if n == 0:
        return []
    bs = opts.batch_size or n
    if bs >= n:
        return align_pairs(patterns, texts, opts)

    # Resolve the auto max_error once, from the first pair, so every batch
    # runs the same engine configuration.
    if opts.max_error is None:
        opts = dataclasses.replace(
            opts,
            max_error=default_max_error(
                len(patterns[0]), len(texts[0]), opts.penalties
            ),
        )

    results: list[AlignmentResult | None] = [None] * n
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = [
            (start, ex.submit(
                align_pairs, patterns[start : start + bs],
                texts[start : start + bs], opts,
            ))
            for start in range(0, n, bs)
        ]
        for start, fut in futs:
            r = fut.result()
            results[start : start + len(r)] = r
    return results  # type: ignore[return-value]
