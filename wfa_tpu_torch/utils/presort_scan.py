"""The presort's divergence scan in native code, one pass over the batch.

``divergence_scores`` here gives the same float64 array as
``utils/presort.py::divergence_scores``, bit for bit, from one call into
``ops/csrc/presort_scan.cpp``, an entry of the native host library
(``native.py``), parallel over pairs where the host compiler has OpenMP.
The scan reads each ``bytes`` object's own buffer: nothing is joined or
copied.  Where the library cannot be built or loaded, or a sequence is not
``bytes``, ``utils/presort.py`` scores the batch; it stays the oracle the
tests hold this scan to.

Counters of the open ``align_pairs`` call (``utils/timers.TRACE``):
``presort_native``, the pairs the native scan scored (those ``lens`` puts
at ``MIN_PRESORT_TIER`` or above; 0 on the Python fallback), and the level
``presort_threads``, the threads it ran on.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .. import native
from . import presort
from .presort import MIN_PRESORT_TIER
from .timers import TRACE


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def scan(lib: ctypes.CDLL, patterns, texts, lens=None) -> tuple[np.ndarray, int]:
    """The scores of every pair by the library ``lib`` and the threads it
    ran on; pairs whose ``lens`` is below ``MIN_PRESORT_TIER`` get 0.
    Raises ``TypeError`` where a sequence is not ``bytes``."""
    n = len(patterns)
    if len(texts) != n or (lens is not None and len(lens) != n):
        raise ValueError("patterns, texts and lens must have equal length")
    out = np.zeros(n)
    if n == 0:
        return out, 0
    # Arrays of pointers into the bytes objects themselves (ctypes keeps a
    # reference to each in the array while it lives).
    pats = (ctypes.c_char_p * n)()
    pats[:] = patterns
    txts = (ctypes.c_char_p * n)()
    txts[:] = texts
    plen = np.fromiter(map(len, patterns), dtype=np.int64, count=n)
    tlen = np.fromiter(map(len, texts), dtype=np.int64, count=n)
    lens_arr = None if lens is None else np.ascontiguousarray(lens, dtype=np.int64)
    threads = lib.presort_scan(
        pats, _ptr(plen), txts, _ptr(tlen),
        None if lens_arr is None else _ptr(lens_arr),
        MIN_PRESORT_TIER, n, _ptr(out),
    )
    return out, threads


def divergence_scores(patterns, texts, lens=None) -> np.ndarray:
    """``utils/presort.py::divergence_scores``, computed natively where the
    library loads."""
    if native.available():
        try:
            out, threads = scan(native.get_lib(), patterns, texts, lens)
        except TypeError:                   # a sequence that is not bytes
            pass
        else:
            scored = len(out) if lens is None else int(
                np.count_nonzero(np.asarray(lens) >= MIN_PRESORT_TIER))
            TRACE.count("presort_native", scored)
            TRACE.level("presort_threads", threads)
            return out
    TRACE.count("presort_native", 0)
    return presort.divergence_scores(patterns, texts, lens)
