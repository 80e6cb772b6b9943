"""The presort's native scan (``utils/presort_scan.py``, built from
``ops/csrc/presort_scan.cpp``) against the Python presort it replaces on the
hot path, ``utils/presort.py::divergence_scores``: the same float64 scores
bit for bit on every kind of input, from the OpenMP build and the serial
one, hence the same tier order in ``_plan_tiers`` and the same results from
``align_pairs``; where the library is missing, the Python scan serves."""
import numpy as np
import pytest
import torch

import wfa_tpu_torch
from wfa_tpu_torch import AlignmentOptions, Penalties, aligner, native
from wfa_tpu_torch.ops import _build
from wfa_tpu_torch.utils import presort, presort_scan
from wfa_tpu_torch.utils.io import read_seq_file
from wfa_tpu_torch.utils.presort import MIN_PRESORT_TIER
from wfa_tpu_torch.utils.synth import mutate_batch, random_pairs

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

HIFI = "tests/data/test_hifi.seq"
K = 12
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random(rng, n) -> bytes:
    return _BASES[rng.integers(0, 4, n)].tobytes()


def _lens(pats, txts):
    return np.array([max(len(p), len(t)) for p, t in zip(pats, txts)], dtype=np.int64)


def _short(rng):
    """L < 4k, and just at and above it."""
    pats, txts = [], []
    for L in list(range(0, 4 * K + 3)) + [4 * K - 1, 4 * K, 4 * K + 1]:
        p = _random(rng, L)
        pats += [p, p + _random(rng, 30), p]
        txts += [p + _random(rng, 30), p, _random(rng, L)]
    return pats, txts, None


def _step_remainder(rng):
    """(L - k) not a multiple of the 32 anchors, so the step leaves a
    remainder and the last anchor lands short of the end."""
    pats, txts = [], []
    for L in (4 * K, 77, 100, 333, 1000, 4095, 4100, 4107, 5000, 9999):
        assert (L - K) % 32 or L == 4 * K
        p = _random(rng, L)
        pats.append(p)
        txts.append(mutate_batch(rng, [p], 0.03)[0])
    return pats, txts, None


def _text_shorter_and_longer(rng):
    pats, txts = [], []
    for L in (60, 500, 4200):
        for d in (1, 13, 200, 2000):
            p = _random(rng, L + d)
            q = mutate_batch(rng, [p], 0.08)[0]
            pats += [p, p[:L], q, q[:L]]
            txts += [q[:L], q, p[:L], p]
    return pats, txts, None


def _clipped_windows(rng):
    """The text is the pattern shifted by d bases: each anchor then hits iff
    the shift stays within its slack, min(32 + pos / 8, 192), so shifts at
    and beside the slack test both ends of the window, which the text's
    ends also clip."""
    pats, txts = [], []
    for L in (60, 300, 2000, 6000):
        p = _random(rng, L)
        for d in (1, 31, 32, 33, 40, 100, 191, 192, 193, 250):
            pats += [p, p]
            txts += [_random(rng, d) + p, p[d:] + _random(rng, d)]
    return pats, txts, None


def _tight_windows(rng):
    """The shortest windows: the text no longer than L, so that the last
    anchors' windows end at the text's end.  (A window never holds fewer
    than k + 1 bytes: pos + k < L <= |t|.)"""
    pats, txts = [], []
    for L in (4 * K, 4 * K + 1, 45 + K, 64, 97):
        t = _random(rng, L)
        pats += [t + _random(rng, 5), t[::-1], t]
        txts += [t, t, t[:-1] + b"A"]
    return pats, txts, None


def _n_and_lower_case(rng):
    """Bytes other than ACGT match only themselves, as ``bytes.find``
    decides."""
    pats, txts = [], []
    for L in (80, 1000, 5000):
        arr = _BASES[rng.integers(0, 4, L)]
        arr[rng.integers(0, L, L // 20)] = ord("N")
        p = arr.tobytes()
        pats += [p, p, p.lower(), p, b"N" * L]
        txts += [p, p.replace(b"N", b"A"), p, p.lower(), b"N" * (L + 7)]
    return pats, txts, None


def _empty(rng):
    p = _random(rng, 5000)
    return [b"", b"", p, b"", b"ACGT"], [b"", p, b"", b"ACGT", b""], None


def _lens_below_tier(rng):
    """Long pairs whose ``lens`` put some below MIN_PRESORT_TIER (0.0) and
    some at or above it (scored)."""
    pats = [_random(rng, 3000 + 200 * i) for i in range(8)]
    txts = mutate_batch(rng, pats, 0.05)
    lens = np.array([MIN_PRESORT_TIER - 1, MIN_PRESORT_TIER, 0, 10**6,
                     MIN_PRESORT_TIER + 1, 5, MIN_PRESORT_TIER - 100, 9000])
    return pats, txts, lens


def _hifi(rng):
    """test_hifi's 50 pairs ×8, each pattern with 0.1% more edits, as the
    HiFi cells of the benchmark run them."""
    batch = read_seq_file(HIFI)
    pats = mutate_batch(rng, list(batch.patterns) * 8, 0.001)
    txts = list(batch.texts) * 8
    return pats, txts, _lens(pats, txts)


def _random10k(rng):
    """Random 10 kbp patterns, texts at 11.9% edits."""
    pats = [_random(rng, 10_000) for _ in range(100)]
    txts = mutate_batch(rng, pats, 0.119)
    return pats, txts, _lens(pats, txts)


def _mixed(rng):
    """``random_pairs`` over every length up to 6 kbp: N, empty sequences."""
    pairs = random_pairs(rng, 120, 0, 6000, 0.3, 0.2, 0.1)
    pats, txts = [p for p, _ in pairs], [t for _, t in pairs]
    return pats, txts, _lens(pats, txts)


CASES = {f.__name__.lstrip("_"): f for f in (
    _short, _step_remainder, _text_shorter_and_longer, _clipped_windows,
    _tight_windows, _n_and_lower_case, _empty, _lens_below_tier, _hifi,
    _random10k, _mixed)}


def _case(name):
    return CASES[name](np.random.default_rng(sorted(CASES).index(name) + 16))


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("the native host library could not be built here (no g++)")
    return native.get_lib()


@pytest.mark.parametrize("name", list(CASES))
def test_native_scan_equals_python(lib, name):
    pats, txts, lens = _case(name)
    want = presort.divergence_scores(pats, txts, lens)
    got, threads = presort_scan.scan(lib, pats, txts, lens)
    assert got.dtype == np.float64 and threads >= 1
    np.testing.assert_array_equal(got, want)
    # Every pair scored where there is no lens.
    got, _ = presort_scan.scan(lib, pats, txts)
    np.testing.assert_array_equal(got, presort.divergence_scores(pats, txts))


def test_serial_build_equals_openmp(lib):
    builds = {}
    for openmp in (True, False):
        so = _build.build_native(openmp)
        if so is None:
            pytest.skip(f"the {'OpenMP' if openmp else 'serial'} build fails here")
        builds[openmp] = native._load_and_bind(str(so))
    for name in ("hifi", "random10k", "mixed"):
        pats, txts, lens = _case(name)
        omp, _ = presort_scan.scan(builds[True], pats, txts, lens)
        serial, threads = presort_scan.scan(builds[False], pats, txts, lens)
        assert threads == 1
        np.testing.assert_array_equal(serial, omp)
        np.testing.assert_array_equal(serial, presort.divergence_scores(pats, txts, lens))


def test_scan_checks_its_inputs(lib):
    assert presort_scan.scan(lib, [], [], np.zeros(0))[0].shape == (0,)
    with pytest.raises(ValueError):
        presort_scan.scan(lib, [b"A"], [b"A", b"C"])
    with pytest.raises(ValueError):
        presort_scan.scan(lib, [b"A"], [b"A"], [1, 2])
    with pytest.raises(TypeError):
        presort_scan.scan(lib, [bytearray(b"ACGT" * 20)], [b"ACGT" * 20])


def test_falls_back_to_python(lib, monkeypatch):
    """Without the library, or on sequences that are not bytes, the Python
    scan gives the scores."""
    pats, txts, lens = _case("mixed")
    want = presort.divergence_scores(pats, txts, lens)
    np.testing.assert_array_equal(presort_scan.divergence_scores(pats, txts, lens), want)
    as_arrays = [bytearray(p) for p in pats]
    np.testing.assert_array_equal(
        presort_scan.divergence_scores(as_arrays, txts, lens), want)
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(presort_scan.divergence_scores(pats, txts, lens), want)


@pytest.mark.parametrize("opts", [
    AlignmentOptions(penalties=Penalties(2, 3, 1), max_error=3000, band=25),
    AlignmentOptions(penalties=Penalties(2, 3, 1), max_error=3000),
], ids=["banded", "exact"])
def test_plan_tiers_order_is_unchanged(lib, opts):
    for name in ("hifi", "random10k", "mixed"):
        pats, txts, lens = _case(name)
        scores, _ = presort_scan.scan(lib, pats, txts, lens)
        python = presort.divergence_scores(pats, txts, lens)
        got = aligner._plan_tiers(lens, opts, 3000, scores)
        want = aligner._plan_tiers(lens, opts, 3000, python)
        assert [p.indices for p in got] == [p.indices for p in want]


def test_align_pairs_equal_with_and_without_the_library(lib, monkeypatch):
    """The plain CPU backend, long pairs of several divergences beside short
    ones: the same results with the native scan and the fallback."""
    rng = np.random.default_rng(5)
    pats = [_random(rng, MIN_PRESORT_TIER + 40 * i) for i in range(4)]
    txts = [mutate_batch(rng, [p], err)[0] for p, err in zip(pats, (0.0, 0.01, 0.002, 0.02))]
    pats += [_random(rng, 200), _random(rng, 90)]
    txts += [pats[4][::-1], pats[5]]
    opts = AlignmentOptions(penalties=Penalties(2, 3, 1), max_error=400, band=25,
                            band_width=64, backend="torch", compute_cigar=True)
    with_library = wfa_tpu_torch.align_pairs(pats, txts, opts)
    monkeypatch.setattr(native, "available", lambda: False)
    fallback = wfa_tpu_torch.align_pairs(pats, txts, opts)
    assert with_library == fallback
