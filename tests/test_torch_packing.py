"""The port's packing helpers equal wfa_tpu's: ``UNPACK``,
``words_for_length``, ``pack_ascii`` and ``unpack_words`` word for word, and
``pack_batch_torch`` bit for bit equal to ``pack_batch_jax`` (jax on the
CPU) on ragged zero-padded batches; on the card, equal to its CPU run.

The card case imports no jax, so on a machine without it run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_packing.py
"""
import numpy as np
import pytest
import torch

from wfa_tpu_torch.ops import packing
from wfa_tpu_torch.types import MAX_SEQ_LEN

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _read(length, seed=3):
    return np.random.default_rng(seed + length).choice(_BASES, size=length)


def _ascii_batch(seed, b, lmax):
    """A [b, lmax] zero-padded batch of random lengths up to lmax (one of
    them lmax), with the odd N and lower-case base."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, lmax + 1, size=b)
    lengths[0] = lmax
    batch = np.zeros((b, lmax), dtype=np.uint8)
    letters = np.frombuffer(b"ACGTACGTACGTNacgt", dtype=np.uint8)
    for i, n in enumerate(lengths):
        batch[i, :n] = rng.choice(letters, size=n)
    return batch, lengths.astype(np.int32)


@pytest.mark.parametrize("length", [0, 1, 4, 15, 16, 17, 100, 1000])
def test_helpers_match(length):
    from wfa_tpu.ops import packing as tpu_packing

    np.testing.assert_array_equal(packing.UNPACK, tpu_packing.UNPACK)
    assert packing.words_for_length(length) == tpu_packing.words_for_length(length)
    seq = _read(length)
    for out_words in (None, 1, packing.words_for_length(length) + 3):
        got, got_valid = packing.pack_ascii(seq, out_words)
        want, want_valid = tpu_packing.pack_ascii(seq, out_words)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
        assert got_valid == want_valid
    words, _ = packing.pack_ascii(seq)
    back = packing.unpack_words(words, length)
    np.testing.assert_array_equal(back, tpu_packing.unpack_words(words, length))
    np.testing.assert_array_equal(back, seq)


@pytest.mark.parametrize("seq", [
    np.frombuffer(b"ACGTNACGTACGTACGTTT", dtype=np.uint8),
    np.full(MAX_SEQ_LEN, ord("A"), dtype=np.uint8),
], ids=["non-acgt", "max-seq-len"])
def test_helpers_match_on_invalid_reads(seq):
    from wfa_tpu.ops import packing as tpu_packing

    got, got_valid = packing.pack_ascii(seq)
    want, want_valid = tpu_packing.pack_ascii(seq)
    np.testing.assert_array_equal(got, want)
    assert got_valid is want_valid is False
    np.testing.assert_array_equal(packing.unpack_words(got, len(seq)),
                                  tpu_packing.unpack_words(want, len(seq)))


@pytest.mark.parametrize("seed,b,lmax", [(1, 7, 64), (2, 5, 37), (3, 9, 1000),
                                         (4, 3, 1), (5, 2, 0)])
def test_pack_batch_torch_matches_pack_batch_jax(seed, b, lmax):
    from wfa_tpu.ops.packing import pack_batch_jax

    batch, lengths = _ascii_batch(seed, b, lmax)
    want = np.asarray(pack_batch_jax(batch, lengths))
    got = packing.pack_batch_torch(torch.from_numpy(batch), torch.from_numpy(lengths))
    assert got.dtype == torch.int32
    assert got.shape == (b, packing.words_for_length(lmax)) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # Inside each read, the 2-bit fields are those of the host packer.
    host, _, _ = packing.pack_batch([bytes(r[:n]) for r, n in zip(batch, lengths)],
                                    got.shape[1])
    for i, n in enumerate(lengths):
        np.testing.assert_array_equal(
            packing.unpack_words(got[i].numpy().view(np.uint32), n),
            packing.unpack_words(host[i], n))


@pytest.mark.cuda
def test_pack_batch_torch_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    batch, lengths = _ascii_batch(6, 33, 20011)
    want = packing.pack_batch_torch(torch.from_numpy(batch), lengths)
    got = packing.pack_batch_torch(torch.from_numpy(batch).cuda(), lengths)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
