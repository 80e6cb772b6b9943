"""2-bit sequence packing on the host.

The port's own copy of ``wfa_tpu/ops/packing.py::pack_batch`` (the role of
the reference's lib/kernels/sequence_packing_kernel.cu:28-116): each base is
encoded in 2 bits via ``(ascii & 6) >> 1`` (A->0, C->1, T->2, G->3) and 16
bases are packed per u32 word, base ``i`` of a word in bits
``[30-2*(i%16), 31-2*(i%16)]`` (first base in the highest bits), so the LCP
extension is ``xor`` + ``clz / 2`` with no swizzle.

Any non-ACGT base routes the pair to the CPU fallback, as does a sequence
of length >= MAX_SEQ_LEN (sequence_packing_kernel.cu:54-76).
"""
from __future__ import annotations

import numpy as np

from .. import native
from ..types import MAX_SEQ_LEN
from ..utils.logger import LOG

BASES_PER_WORD = 16

_ACGT = np.zeros(256, dtype=bool)
_ACGT[[ord(c) for c in "ACGTacgt"]] = True


def pack_batch(
    seqs: list[bytes | np.ndarray], out_words: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack a batch of sequences into a dense [B, out_words] u32 array.

    Returns (packed[B, out_words] u32, lengths[B] i32, valid[B] bool).
    ``valid`` is False for non-ACGT content, length >= MAX_SEQ_LEN, or a
    sequence longer than the packed buffer.  The native C++ packer runs when
    the library is available; this NumPy path has the same semantics.
    """
    b = len(seqs)
    seqs_b = [
        s if isinstance(s, (bytes, bytearray)) else bytes(s) for s in seqs
    ]
    if native.available():
        try:
            return native.pack_batch_native(
                [bytes(s) for s in seqs_b], out_words, MAX_SEQ_LEN
            )
        except OSError:  # pragma: no cover - the library failed to load
            LOG.warning("native packing failed; using the NumPy path",
                        exc_info=True)
    flat = np.frombuffer(b"".join(seqs_b), dtype=np.uint8)
    lengths = np.fromiter((len(s) for s in seqs_b), dtype=np.int64, count=b)
    # Only do real work up to the longest sequence; the tail of the output is
    # zero padding.
    full_cap = out_words * BASES_PER_WORD
    content_words = min(
        out_words,
        (int(lengths.max(initial=0)) + BASES_PER_WORD - 1) // BASES_PER_WORD,
    )
    cap = content_words * BASES_PER_WORD
    starts = np.zeros(b, dtype=np.int64)
    if b > 1:
        np.cumsum(lengths[:-1], out=starts[1:])
    # Ragged -> padded matrix with one gather: read past each row's end
    # (clamped to the buffer) and zero the overhang.
    itype = np.int32 if flat.size < 2**31 - cap - 1 else np.int64
    col = np.arange(max(cap, 1), dtype=itype)
    idx = np.minimum(
        starts.astype(itype)[:, None] + col, itype(max(flat.size - 1, 0))
    )
    mat = flat[idx] if flat.size else np.zeros((b, max(cap, 1)), np.uint8)
    mat *= col < lengths[:, None]
    lengths = lengths.astype(np.int32)

    in_buf = np.minimum(lengths, cap)
    acgt_count = _ACGT[mat].sum(axis=1, dtype=np.int64)
    valid = (
        (acgt_count == in_buf)
        & (lengths < MAX_SEQ_LEN)
        & (lengths <= full_cap)
    )

    # Byte j of a word holds bases 4j..4j+3 in bit pairs (7-6, 5-4, 3-2,
    # 1-0); a big-endian u32 view of the bytes gives the packed words.
    cod = (mat[:, :cap] & 6) >> 1
    by = (
        (cod[:, 0::4] << 6)
        | (cod[:, 1::4] << 4)
        | (cod[:, 2::4] << 2)
        | cod[:, 3::4]
    )
    out = np.zeros((b, out_words), np.uint32)
    if cap:
        out[:, :content_words] = (
            np.ascontiguousarray(by).view(">u4").astype(np.uint32)
        ).reshape(b, content_words)
    return out, lengths, valid
