"""ctypes bindings of the port's native C++ host library.

The port's own copy of ``wfa_tpu/native.py``.  The library provides the host
hot paths, mirroring the reference's native layers:

* ``wfa_cpu_align_*`` — the CPU WFA fallback engine and exact oracle (role of
  utils/wfa_cpu.c over the vendored WFA2-lib).
* ``wfa_traceback_batch*`` — CIGARs from the plain engine's choice tables
  (role of utils/cigar.c ``recover_cigar_affine``).
* ``wfa_pack_batch`` and ``wfa_read_*`` — packing and the .seq / FASTA
  readers (role of utils/sequence_reader.c).
* ``presort_scan``, ``pack_slot`` and ``cigar_from_ops`` — the presort's
  divergence scan (``utils/presort_scan.py``), the chunk loop's slot packer
  (``ops/packing.pack_slot``) and its CIGAR decode
  (``cigar_from_ops_batch``: K3's walked op streams replayed into CIGARs,
  ``ops/csrc/cigar_ops.cpp``).

``ops._build.build_native`` builds it from the repository's ``native/``
sources and the port's ``ops/csrc/`` host sources with one ``g++``;
``get_lib`` loads it once per process, the OpenMP form, else the serial
one, and logs which (``-v``).  Every entry point has a Python fallback
elsewhere in the package: ``available()`` says whether the library loads.
"""
from __future__ import annotations

import ctypes as ct
import threading

import numpy as np

from .ops import _build
from .types import Penalties
from .utils.logger import LOG
from .utils.timers import TRACE


class NativeUnavailable(RuntimeError):
    pass


_p, _i32, _i64 = ct.c_void_p, ct.c_int, ct.c_int64
# Every entry of the library: name -> (restype, argtypes).
_ENTRIES = {
    "wfa_cpu_num_threads": (_i32, []),
    "wfa_cpu_align_single": (_i32, [ct.c_char_p, _i32, ct.c_char_p, _i32,
                                    _i32, _i32, _i32]),
    "wfa_cpu_align_batch": (None, [_p, _p, _p, _p, _p, _p, _i64, _i32, _i32,
                                   _i32, _p, _p, _i64, _p, _i32]),
    "wfa_traceback_batch": (None, [_p, _p, _i64, _i64, _i64, _p, _i64, _p, _p,
                                   _p, _p, _p, _p, _p, _i32, _i32, _i32, _p,
                                   _i64, _p]),
    "wfa_traceback_batch_packed": (None, [_p, _i64, _i64, _i64, _p, _i64,
                                          ct.c_int32, _p, _p, _p, _p, _p, _p,
                                          _p, _i32, _i32, _i32, _p, _i64, _p]),
    "wfa_pack_batch": (None, [_p, _p, _p, ct.c_int32, ct.c_int32, ct.c_int32,
                              _p, _p]),
    "wfa_read_seq_scan": (_i64, [ct.c_char_p, ct.POINTER(ct.c_int64)]),
    "wfa_read_seq_load": (_i64, [ct.c_char_p, _p, _p, _p, _p, _p, _i64]),
    "wfa_read_fasta_scan": (_i64, [ct.c_char_p, ct.c_char_p,
                                   ct.POINTER(ct.c_int64)]),
    "wfa_read_fasta_load": (_i64, [ct.c_char_p, ct.c_char_p, _p, _p, _p, _p,
                                   _p, _i64]),
    "presort_scan": (_i32, [_p, _p, _p, _p, _p, _i64, _i64, _p]),
    "pack_slot": (_i32, [_p, _p, _p, _p, _i64, _i64, _i64, _p, _p, _p, _p, _p]),
    "cigar_from_ops": (_i32, [_p, _i64, _i64, _p, _p, _p, _p, _p, _p, _i64,
                              _p, _p, _p, _p]),
}

# The loaded library, or False once it failed to build or load.
_lib: ct.CDLL | bool | None = None
_lock = threading.Lock()


def get_lib() -> ct.CDLL:
    """The loaded library, built and loaded on first use, once per process:
    the OpenMP form, else the serial one; raises NativeUnavailable where
    neither builds and loads."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = False
            for openmp in (True, False):
                so = _build.build_native(openmp)
                if so is None:
                    continue
                try:
                    _lib = _load_and_bind(str(so))
                except OSError:             # built, but its runtime is missing
                    continue
                LOG.debug("native host library %s: %s, wfa_cpu_num_threads %d",
                          so, "omp" if openmp else "serial",
                          _lib.wfa_cpu_num_threads())
                break
        if not _lib:
            raise NativeUnavailable(
                "the native host library could not be built or loaded "
                f"(the compiler's output: {_build._NATIVE_DIR}/*.log)"
            )
        return _lib


def _load_and_bind(path: str) -> ct.CDLL:
    """Load a build of the library with every entry's C signature; raises
    ``OSError`` where it does not load."""
    lib = ct.CDLL(path)
    for name, (restype, argtypes) in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def available() -> bool:
    try:
        get_lib()
        return True
    except NativeUnavailable:
        return False


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ct.c_void_p)


def cpu_align_single(pattern: bytes, text: bytes, pen: Penalties) -> int:
    """Exact single-pair oracle (compute_alignment_cpu analog)."""
    return get_lib().wfa_cpu_align_single(
        pattern, len(pattern), text, len(text), pen.x, pen.o, pen.e
    )


def pack_batch_native(
    seqs: list[bytes], out_words: int, max_seq_len: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-pass C++ packing and ACGT validity; the semantics of
    ``ops.packing.pack_batch``.  Returns (packed[B, out_words] u32,
    lengths[B] i32, valid[B] bool)."""
    lib = get_lib()
    b = len(seqs)
    lengths = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=b)
    starts = np.zeros(b, dtype=np.int64)
    if b > 1:
        np.cumsum(lengths[:-1], out=starts[1:])
    flat = np.frombuffer(b"".join(seqs) if b else b"\0", dtype=np.uint8)
    lengths32 = lengths.astype(np.int32)
    out = np.empty((b, out_words), dtype=np.uint32)
    valid = np.empty(b, dtype=np.uint8)
    lib.wfa_pack_batch(
        _ptr(flat), _ptr(starts), _ptr(lengths32),
        ct.c_int32(b), ct.c_int32(out_words), ct.c_int32(max_seq_len),
        _ptr(out), _ptr(valid),
    )
    return out, lengths32, valid != 0


def _flat_seqs(patterns, texts):
    p_off = np.zeros(len(patterns), dtype=np.int64)
    t_off = np.zeros(len(patterns), dtype=np.int64)
    p_len = np.array([len(p) for p in patterns], dtype=np.int32)
    t_len = np.array([len(t) for t in texts], dtype=np.int32)
    total = int(p_len.sum() + t_len.sum())
    buf = np.empty(max(total, 1), dtype=np.uint8)
    pos = 0
    for i, (p, t) in enumerate(zip(patterns, texts)):
        p_off[i] = pos
        buf[pos : pos + len(p)] = np.frombuffer(p, dtype=np.uint8)
        pos += len(p)
        t_off[i] = pos
        buf[pos : pos + len(t)] = np.frombuffer(t, dtype=np.uint8)
        pos += len(t)
    return buf, p_off, t_off, p_len, t_len


def _cigars_from_buffer(cig_buf, cigar_stride, status, n) -> list[str | None]:
    raw = cig_buf.tobytes()
    return [
        raw[i * cigar_stride : (i + 1) * cigar_stride].split(b"\0", 1)[0].decode()
        if status[i] == 1 else None
        for i in range(n)
    ]


def cpu_align_batch(
    patterns: list[bytes],
    texts: list[bytes],
    pen: Penalties,
    mask: np.ndarray,
    compute_cigar: bool,
    cigar_stride: int = 0,
    adaptive: bool = False,
) -> tuple[np.ndarray, list[str | None], np.ndarray]:
    """Batch CPU alignment (compute_alignments_cpu_threaded analog).

    ``adaptive`` turns on the WFA-adaptive heuristic, as the reference does
    for the CPU pass when the device ran banded (utils/wfa_cpu.c:40-48).
    Returns (distances, cigars, status); cigars are None for skipped pairs.
    Rows whose CIGAR overflows the stride are retried with a wider one.
    """
    lib = get_lib()
    n = len(patterns)
    buf, p_off, t_off, p_len, t_len = _flat_seqs(patterns, texts)
    mask8 = np.ascontiguousarray(mask, dtype=np.int8)
    dist = np.zeros(n, dtype=np.int32)
    status = np.zeros(n, dtype=np.int8)
    adp = 1 if adaptive else 0

    if not compute_cigar:
        lib.wfa_cpu_align_batch(
            _ptr(buf), _ptr(p_off), _ptr(t_off), _ptr(p_len), _ptr(t_len),
            _ptr(mask8), n, pen.x, pen.o, pen.e,
            _ptr(dist), None, 0, _ptr(status), adp,
        )
        return dist, [None] * n, status

    if cigar_stride <= 0:
        cigar_stride = 4096
    cig_buf = np.zeros(n * cigar_stride, dtype=np.uint8)
    lib.wfa_cpu_align_batch(
        _ptr(buf), _ptr(p_off), _ptr(t_off), _ptr(p_len), _ptr(t_len),
        _ptr(mask8), n, pen.x, pen.o, pen.e,
        _ptr(dist), _ptr(cig_buf), cigar_stride, _ptr(status), adp,
    )
    cigars = _cigars_from_buffer(cig_buf, cigar_stride, status, n)
    over = np.flatnonzero(status == 2)
    if over.size:
        sub_d, sub_c, sub_s = cpu_align_batch(
            [patterns[i] for i in over], [texts[i] for i in over],
            pen, mask8[over], True, cigar_stride * 4, adaptive,
        )
        dist[over], status[over] = sub_d, sub_s
        for j, i in enumerate(over):
            cigars[i] = sub_c[j]
    return dist, cigars, status


def traceback_batch(
    choices: np.ndarray,      # [S, B, W] uint8
    lo_trace: np.ndarray,     # [S, B] int32
    step_of_score: np.ndarray,  # [max_score+1] int32, -1 where absent
    distances: np.ndarray,    # [B] int32
    finished: np.ndarray,     # [B] bool
    patterns: list[bytes],
    texts: list[bytes],
    pen: Penalties,
    cigar_stride: int = 0,
) -> tuple[list[str | None], np.ndarray]:
    """CIGARs from the per-step choice table of the plain engine."""
    lib = get_lib()
    S, B, W = choices.shape
    choices = np.ascontiguousarray(choices, dtype=np.uint8)
    lo_trace = np.ascontiguousarray(lo_trace, dtype=np.int32)
    step_of_score = np.ascontiguousarray(step_of_score, dtype=np.int32)
    distances = np.ascontiguousarray(distances, dtype=np.int32)
    fin8 = np.ascontiguousarray(finished, dtype=np.int8)
    buf, p_off, t_off, p_len, t_len = _flat_seqs(patterns, texts)
    status = np.zeros(B, dtype=np.int8)
    if cigar_stride <= 0:
        cigar_stride = max(64, 8 * int(distances.max(initial=0)) + 64)
    cig_buf = np.zeros(B * cigar_stride, dtype=np.uint8)
    lib.wfa_traceback_batch(
        _ptr(choices), _ptr(lo_trace), S, B, W,
        _ptr(step_of_score), len(step_of_score) - 1,
        _ptr(distances), _ptr(fin8),
        _ptr(buf), _ptr(p_off), _ptr(t_off), _ptr(p_len), _ptr(t_len),
        pen.x, pen.o, pen.e,
        _ptr(cig_buf), cigar_stride, _ptr(status),
    )
    bad = status > 2
    if bad.any():
        raise RuntimeError(
            f"traceback failed for {bad.sum()} alignments (codes "
            f"{np.unique(status[bad])})"
        )
    cigars = _cigars_from_buffer(cig_buf, cigar_stride, status, B)
    over = np.flatnonzero(status == 2)
    if over.size:  # retry the overflowing subset only
        sub_c, sub_s = traceback_batch(
            choices[:, over], lo_trace[:, over], step_of_score,
            distances[over], finished[over],
            [patterns[i] for i in over], [texts[i] for i in over],
            pen, cigar_stride * 4,
        )
        status[over] = sub_s
        for j, i in enumerate(over):
            cigars[i] = sub_c[j]
    return cigars, status


def cigar_from_ops_batch(
    ops_words: np.ndarray,    # [B, OPW] int32 backward 2-bit op streams
    n_ops: np.ndarray,        # [B] int32 (-1 = corrupt walk)
    finished: np.ndarray,     # [B] bool
    patterns: list[bytes],
    texts: list[bytes],
    cigar_stride: int = 0,
) -> tuple[list[str | None], np.ndarray]:
    """Replay walked op streams into CIGARs (no choice table on the host);
    an unfinished pair or a corrupt walk gives None, status 0 (else 1).

    One call of the library's ``cigar_from_ops`` (``ops/csrc/cigar_ops.cpp``)
    decodes the batch, OpenMP over pairs, reading each sequence and each op
    row in place: ``ops_words`` may be a view whose rows are apart by any
    whole number of words, as the chunk loop's ``arr[:, 4:]``.  A sequence
    that is not ``bytes`` is passed as ``bytes(seq)``.  Each pair gets room
    for the most runs its stream can make, so no CIGAR overflows and
    ``cigar_stride`` is not read; the entry moves the CIGARs together, a
    newline after each, and one decode and one split make the list.  Counts
    ``decode_native``, the pairs decoded, and the level ``decode_threads``,
    the threads it ran on."""
    lib = get_lib()
    b, opw = ops_words.shape
    if b == 0:
        return [], np.zeros(0, dtype=np.int8)
    if ops_words.dtype != np.int32 or ops_words.strides[1] != 4 or (
            ops_words.strides[0] % 4):
        ops_words = np.ascontiguousarray(ops_words, dtype=np.int32)
    n_ops = np.ascontiguousarray(n_ops, dtype=np.int32)
    fin8 = np.ascontiguousarray(finished, dtype=np.int8)
    pats = [s if type(s) is bytes else bytes(s) for s in patterns]
    txts = [s if type(s) is bytes else bytes(s) for s in texts]
    p_len = np.fromiter(map(len, pats), dtype=np.int64, count=b)
    t_len = np.fromiter(map(len, txts), dtype=np.int64, count=b)
    # Room a pair: 2 n_ops + 1 runs, each of at most `width` bytes, and the
    # separator.
    longest = max(int(p_len.max()), int(t_len.max()), int(n_ops.max()))
    width = len(str(longest)) + 1
    room = (2 * np.maximum(n_ops, 0).astype(np.int64) + 1) * width + 1
    ends = np.cumsum(room)
    out = np.empty(int(ends[-1]), dtype=np.uint8)
    lens = np.empty(b, dtype=np.int64)
    status = np.empty(b, dtype=np.int8)
    p_arr = (ct.c_char_p * b)()
    p_arr[:] = pats
    t_arr = (ct.c_char_p * b)()
    t_arr[:] = txts
    threads = lib.cigar_from_ops(
        ops_words.ctypes.data, ops_words.strides[0] // 4, opw, _ptr(n_ops),
        _ptr(fin8), p_arr, _ptr(p_len), t_arr, _ptr(t_len), b,
        _ptr(ends - room), _ptr(out), _ptr(lens), _ptr(status),
    )
    TRACE.count("decode_native", b)
    TRACE.level("decode_threads", threads)
    used = int(lens.sum()) + b - 1         # less the last separator
    cigars: list[str | None] = str(out[:used], "ascii").split("\n")
    for i in np.flatnonzero(status == 0):
        cigars[i] = None
    return cigars, status


def traceback_batch_packed(
    words: np.ndarray,          # [C, B, W] int32 nibble-packed choices
    lo_trace: np.ndarray | None,  # [B, lo_stride] int32 by score, or None
    lo_const: int,
    distances: np.ndarray,      # [B] int32
    finished: np.ndarray,       # [B] bool
    patterns: list[bytes],
    texts: list[bytes],
    pen: Penalties,
    cigar_stride: int = 0,
) -> tuple[list[str | None], np.ndarray]:
    """CIGARs from the by-score nibble-packed choice table."""
    lib = get_lib()
    C, B, W = words.shape
    words = np.ascontiguousarray(words, dtype=np.int32)
    distances = np.ascontiguousarray(distances, dtype=np.int32)
    fin8 = np.ascontiguousarray(finished, dtype=np.int8)
    if lo_trace is not None:
        lo_trace = np.ascontiguousarray(lo_trace, dtype=np.int32)
        lo_ptr, lo_stride = _ptr(lo_trace), lo_trace.shape[1]
    else:
        lo_ptr, lo_stride = None, 0
    buf, p_off, t_off, p_len, t_len = _flat_seqs(patterns, texts)
    status = np.zeros(B, dtype=np.int8)
    if cigar_stride <= 0:
        cigar_stride = max(64, 8 * int(distances.max(initial=0)) + 64)
    cig_buf = np.zeros(B * cigar_stride, dtype=np.uint8)
    lib.wfa_traceback_batch_packed(
        _ptr(words), C, B, W,
        lo_ptr, lo_stride, lo_const,
        _ptr(distances), _ptr(fin8),
        _ptr(buf), _ptr(p_off), _ptr(t_off), _ptr(p_len), _ptr(t_len),
        pen.x, pen.o, pen.e,
        _ptr(cig_buf), cigar_stride, _ptr(status),
    )
    bad = status > 2
    if bad.any():
        raise RuntimeError(
            f"packed traceback failed for {bad.sum()} alignments (codes "
            f"{np.unique(status[bad])})"
        )
    cigars = _cigars_from_buffer(cig_buf, cigar_stride, status, B)
    over = np.flatnonzero(status == 2)
    if over.size:  # retry the overflowing subset only
        sub_c, sub_s = traceback_batch_packed(
            words[:, over],
            lo_trace[over] if lo_trace is not None else None,
            lo_const, distances[over], finished[over],
            [patterns[i] for i in over], [texts[i] for i in over],
            pen, cigar_stride * 4,
        )
        status[over] = sub_s
        for j, i in enumerate(over):
            cigars[i] = sub_c[j]
    return cigars, status


def _read_loaded(buf, p_off, t_off, p_len, t_len, got):
    raw = buf.tobytes()
    pats = [raw[p_off[i] : p_off[i] + p_len[i]] for i in range(got)]
    txts = [raw[t_off[i] : t_off[i] + t_len[i]] for i in range(got)]
    return pats, txts


def read_seq_native(path: str):
    """Fast .seq reader; returns (patterns, texts) as lists of bytes."""
    lib = get_lib()
    total = ct.c_int64(0)
    n = lib.wfa_read_seq_scan(str(path).encode(), ct.byref(total))
    if n < 0:
        raise IOError(f"cannot read .seq file {path}")
    buf = np.empty(max(int(total.value), 1), dtype=np.uint8)
    p_off = np.zeros(n, dtype=np.int64)
    t_off = np.zeros(n, dtype=np.int64)
    p_len = np.zeros(n, dtype=np.int32)
    t_len = np.zeros(n, dtype=np.int32)
    got = lib.wfa_read_seq_load(
        str(path).encode(), _ptr(buf), _ptr(p_off), _ptr(t_off),
        _ptr(p_len), _ptr(t_len), n,
    )
    return _read_loaded(buf, p_off, t_off, p_len, t_len, got)


def read_fasta_native(query_path: str, target_path: str):
    """Fast FASTA pair reader; returns (patterns, texts)."""
    lib = get_lib()
    total = ct.c_int64(0)
    n = lib.wfa_read_fasta_scan(
        str(query_path).encode(), str(target_path).encode(), ct.byref(total)
    )
    if n < 0:
        raise IOError(f"cannot read FASTA files {query_path}, {target_path}")
    buf = np.empty(max(int(total.value), 1), dtype=np.uint8)
    p_off = np.zeros(n, dtype=np.int64)
    t_off = np.zeros(n, dtype=np.int64)
    p_len = np.zeros(n, dtype=np.int32)
    t_len = np.zeros(n, dtype=np.int32)
    got = lib.wfa_read_fasta_load(
        str(query_path).encode(), str(target_path).encode(), _ptr(buf),
        _ptr(p_off), _ptr(t_off), _ptr(p_len), _ptr(t_len), n,
    )
    return _read_loaded(buf, p_off, t_off, p_len, t_len, got)
