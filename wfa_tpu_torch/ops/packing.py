"""2-bit sequence packing on the host.

The port's own copy of ``wfa_tpu/ops/packing.py::pack_batch`` (the role of
the reference's lib/kernels/sequence_packing_kernel.cu:28-116): each base is
encoded in 2 bits via ``(ascii & 6) >> 1`` (A->0, C->1, T->2, G->3) and 16
bases are packed per u32 word, base ``i`` of a word in bits
``[30-2*(i%16), 31-2*(i%16)]`` (first base in the highest bits), so the LCP
extension is ``xor`` + ``clz / 2`` with no swizzle.

Any non-ACGT base routes the pair to the CPU fallback, as does a sequence
of length >= MAX_SEQ_LEN (sequence_packing_kernel.cu:54-76).

``pack_ascii`` and ``unpack_words`` pack one sequence and unpack it again
(round-trip tests); ``pack_batch_torch`` packs a zero-padded batch that is
already a tensor, on its own device, in plain torch ops.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..types import MAX_SEQ_LEN
from ..utils.logger import LOG

BASES_PER_WORD = 16

# Reverse of the 2-bit encoding, for round-trip tests (cf. the UNPACK table
# of the reference's tests/test_packing_kernel.cu:31).
UNPACK = np.frombuffer(b"ACTG", dtype=np.uint8)

_ACGT = np.zeros(256, dtype=bool)
_ACGT[[ord(c) for c in "ACGTacgt"]] = True


def words_for_length(length: int) -> int:
    return (length + BASES_PER_WORD - 1) // BASES_PER_WORD


def pack_ascii(seq: np.ndarray, out_words: int | None = None) -> tuple[np.ndarray, bool]:
    """Pack an ASCII uint8 sequence into big-endian-ordered 2-bit u32 words.

    Returns (packed_words[uint32], valid).  ``valid`` is False when the
    sequence contains non-ACGT characters or is too long, in which case the
    caller must route the pair to the CPU engine.
    """
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n = seq.shape[0]
    valid = bool(_ACGT[seq].all()) and n < MAX_SEQ_LEN
    nwords = words_for_length(n)
    if out_words is None:
        out_words = nwords
    codes2 = ((seq & 6) >> 1).astype(np.uint32)
    pad = nwords * BASES_PER_WORD - n
    if pad:
        codes2 = np.concatenate([codes2, np.zeros(pad, dtype=np.uint32)])
    codes2 = codes2.reshape(nwords, BASES_PER_WORD)
    shifts = np.arange(30, -2, -2, dtype=np.uint32)
    words = (codes2 << shifts).sum(axis=1, dtype=np.uint32)
    if out_words != nwords:
        out = np.zeros(out_words, dtype=np.uint32)
        out[: min(nwords, out_words)] = words[:out_words]
        words = out
    return words, valid


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


def unpack_words(words: np.ndarray, length: int) -> np.ndarray:
    """Round-trip helper: packed u32 words -> ASCII uint8 sequence."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = np.arange(30, -2, -2, dtype=np.uint32)
    codes = (words[:, None] >> shifts) & 3
    return UNPACK[codes.reshape(-1)[:length]]


def pack_batch_torch(ascii_batch: torch.Tensor, lengths) -> torch.Tensor:
    """[B, Lmax] uint8 ASCII (zero padded) -> [B, ceil(Lmax/16)] int32 on
    the same device, each word the u32 bit pattern ``pack_batch`` gives.

    As the reference's on-device packing, the zero padding packs as 'A'
    (code 0) and ``lengths`` is not read; no validity is computed.  torch's
    uint32 has no shifts or reductions on CUDA, so the codes are combined
    in int64: their 2-bit fields are disjoint, so the sum is their OR and
    stays below 2**32.  The word is then narrowed to its int32 bit
    pattern."""
    b, lmax = ascii_batch.shape
    nwords = words_for_length(lmax)
    codes = ((ascii_batch & 6) >> 1).to(torch.int64)
    pad = nwords * BASES_PER_WORD - lmax
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    shifts = torch.arange(30, -2, -2, dtype=torch.int64, device=codes.device)
    words = (codes.view(b, nwords, BASES_PER_WORD) << shifts).sum(dim=2)
    return (words - ((words >> 31) << 32)).to(torch.int32)
