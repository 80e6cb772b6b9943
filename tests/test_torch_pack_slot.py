"""The chunk loop's slot packer (``ops/packing.pack_slot`` over
``ops/csrc/pack_slot.cpp``) against the NumPy path of ``pack_batch``, which
``aligner._HostSlot.fill`` used before it: the same words, lengths and
validity bit for bit, from the OpenMP build and the serial one, on every
kind of input, in a slot that an earlier, longer chunk left dirty; and
``fill``'s counters and its fallback to ``pack_batch``."""
import numpy as np
import pytest
import torch

from wfa_tpu_torch import aligner, native
from wfa_tpu_torch.ops import _build, packing
from wfa_tpu_torch.types import MAX_SEQ_LEN
from wfa_tpu_torch.utils.io import read_seq_file
from wfa_tpu_torch.utils.timers import TRACE

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

HIFI = "tests/data/test_hifi.seq"
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random(rng, n, alphabet=_BASES) -> bytes:
    return alphabet[rng.integers(0, len(alphabet), n)].tobytes()


def _lengths(rng):
    lens = [1, 15, 16, 17, 31, 32, 33, 16 * 7, 16 * 12 - 1, 16 * 12]
    return ([_random(rng, n) for n in lens],
            [_random(rng, n) for n in reversed(lens)], 12)


def _empty(rng):
    return [b"", b"", _random(rng, 40)], [b"", _random(rng, 17), b""], 4


def _non_acgt(rng):
    """Every byte value once, at positions in whole words and in the last
    partial word, beside the bytes one bit away from ACGT; in the pattern
    for even values, in the text for odd ones."""
    pats, txts = [], []
    for v in range(256):
        seq = bytearray(_random(rng, 16 * 3 + 5))
        seq[int(rng.integers(0, len(seq)))] = v
        pair = [bytes(seq), _random(rng, int(rng.integers(1, 60)))]
        pats.append(pair[v % 2])
        txts.append(pair[1 - v % 2])
    pats += [b"ACGTN" * 9, b"N", b"ACGT" * 4 + b"N"]
    txts += [b"ACGT" * 11, b"A", b"ACGT" * 5]
    return pats, txts, 4


def _lower_case(rng):
    mixed = np.frombuffer(b"ACGTacgt", dtype=np.uint8)
    pats = [_random(rng, n, mixed) for n in (5, 16, 37, 64)]
    txts = [p.lower() for p in pats]
    return pats, txts, 4


def _max_seq_len(rng):
    lens = [MAX_SEQ_LEN - 17, MAX_SEQ_LEN - 1, MAX_SEQ_LEN, MAX_SEQ_LEN + 1]
    pats = [_random(rng, n) for n in lens]
    return pats, [_random(rng, 100) for _ in lens], MAX_SEQ_LEN // 16 + 2


def _over_long(rng):
    """Longer than the slot's 4 words: bases past 64 are dropped unchecked
    (an N there too); one just fits."""
    pats = [_random(rng, 64), _random(rng, 65), _random(rng, 200),
            _random(rng, 64) + b"N" * 10, b"N" + _random(rng, 80)]
    return pats, [_random(rng, 30) for _ in pats], 4


def _hifi(rng):
    batch = read_seq_file(HIFI)
    pats, txts = list(batch.patterns), list(batch.texts)
    nwords = max(map(len, pats + txts)) // 16 + 2
    return pats, txts, nwords


CASES = {
    "lengths": _lengths,
    "empty": _empty,
    "non_acgt": _non_acgt,
    "lower_case": _lower_case,
    "max_seq_len": _max_seq_len,
    "over_long": _over_long,
    "hifi": _hifi,
}


def _case(name):
    return CASES[name](np.random.default_rng(sorted(CASES).index(name) + 19))


@pytest.fixture(scope="module")
def builds():
    libs = {}
    for openmp in (True, False):
        so = _build.build_native(openmp)
        if so is not None:
            libs["omp" if openmp else "serial"] = native._load_and_bind(str(so))
    if "serial" not in libs:
        pytest.skip("the slot packer could not be built here (no g++)")
    return libs


def _numpy_pack(monkeypatch, pats, txts, nwords):
    """``pack_batch``'s NumPy path on each side: the expected slot rows."""
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        pat_w, p_len, p_ok = packing.pack_batch(pats, nwords)
        txt_w, t_len, t_ok = packing.pack_batch(txts, nwords)
    return pat_w.view(np.int32), txt_w.view(np.int32), p_len, t_len, p_ok & t_ok


def _dirty_slot(lib, rows, nwords):
    """A slot whose rows hold an earlier chunk of full-length sequences
    (every word nonzero where it can be) and whose lengths and validity
    are garbage."""
    slot = aligner._HostSlot(rows, nwords, 2, pin=False)
    for t in (slot.pat, slot.txt, slot.plen, slot.tlen):
        t.fill_(-1)
    slot.valid.fill_(True)
    full = [b"T" * (16 * nwords)] * rows
    packing.pack_slot(lib, full, full, slot.pat, slot.txt, slot.plen,
                      slot.tlen, slot.valid)
    return slot


@pytest.mark.parametrize("build", ["omp", "serial"])
@pytest.mark.parametrize("name", list(CASES))
def test_slot_equals_pack_batch(builds, monkeypatch, name, build):
    if build not in builds:
        pytest.skip(f"the {build} build fails here")
    lib = builds[build]
    pats, txts, nwords = _case(name)
    n = len(pats)
    slot = _dirty_slot(lib, n + 3, nwords)      # n below the slot's rows
    got = (slot.pat, slot.txt, slot.plen, slot.tlen, slot.valid)
    before = [t[n:].clone() for t in got]
    threads = packing.pack_slot(lib, pats, txts, slot.pat, slot.txt,
                                slot.plen, slot.tlen, slot.valid)
    assert threads == 1 if build == "serial" else threads >= 1
    want = _numpy_pack(monkeypatch, pats, txts, nwords)
    for g, w, b in zip(got, want, before):
        np.testing.assert_array_equal(g[:n].numpy(), w)
        assert torch.equal(g[n:], b)            # rows past n are not touched


def test_slot_packer_checks_its_inputs(builds):
    lib = builds["serial"]
    slot = aligner._HostSlot(2, 4, 2, pin=False)
    host = (slot.pat, slot.txt, slot.plen, slot.tlen, slot.valid)
    with pytest.raises(ValueError):
        packing.pack_slot(lib, [b"A"] * 3, [b"A"] * 3, *host)
    with pytest.raises(ValueError):
        packing.pack_slot(lib, [b"A"], [b"A", b"C"], *host)
    with pytest.raises(ValueError):
        packing.pack_slot(lib, [b"A"], [b"A"], slot.pat[:, :2], *host[1:])
    with pytest.raises(ValueError):
        packing.pack_slot(lib, [b"A"], [b"A"], *host[:4], slot.plen)
    for bad in ([bytearray(b"ACGT")], [np.frombuffer(b"ACGT", np.uint8)],
                ["ACGT"], [7], [None]):
        with pytest.raises(TypeError):
            packing.pack_slot(lib, bad, [b"ACGT"], *host)


@pytest.mark.parametrize("kind", ["bytes", "bytearray", "ndarray", "no_library"])
def test_fill_counters_and_fallback(builds, monkeypatch, kind):
    """``fill`` packs natively where its library loads and every sequence
    is ``bytes`` (``pack_native`` = n, ``pack_threads`` its threads); else
    ``pack_batch`` fills the slot with the same values and ``pack_native``
    reads 0."""
    pats, txts, nwords = _case("non_acgt")
    pats, txts = pats[:40], txts[:40]
    want = _numpy_pack(monkeypatch, pats, txts, nwords)
    if kind == "bytearray":
        pats = [bytearray(p) for p in pats]
    elif kind == "ndarray":
        txts = [np.frombuffer(t, dtype=np.uint8) for t in txts]
    elif kind == "no_library":
        monkeypatch.setattr(native, "available", lambda: False)
    slot = _dirty_slot(builds["serial"], len(pats) + 1, nwords)
    was = TRACE.on
    TRACE.enable()
    TRACE.clear()
    try:
        with TRACE.span("call"):
            got = slot.fill(pats, txts, nwords)
        (call,) = TRACE.calls()
    finally:
        TRACE.on = was
        TRACE.clear()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    c = call["counters"]
    native_pack = kind == "bytes" and native.available()
    assert c["pack_native"] == (len(pats) if native_pack else 0)
    if native_pack:
        assert c["pack_threads"] >= 1 and "pack_threads" in TRACE.levels
    else:
        assert "pack_threads" not in c
