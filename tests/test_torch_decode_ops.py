"""The chunk loop's CIGAR decode (``native.cigar_from_ops_batch`` over
``ops/csrc/cigar_ops.cpp``) against wfa_tpu's native decoder on the walks
of the plain K2 + K3: byte-equal CIGARs and the same status on every kind
of row, from the OpenMP build and the serial one; and the decode's counters
in the chunk loop, with and without the library."""
import dataclasses
import re

import numpy as np
import pytest
import torch

import wfa_tpu.native as tpu_native
import wfa_tpu_torch
from wfa_tpu_torch import AlignmentOptions, Penalties, aligner, native
from wfa_tpu_torch.ops import _build, engine_torch, packing, traceback_torch
from wfa_tpu_torch.schedule import build_schedule
from wfa_tpu_torch.utils.synth import EDGE_PAIRS, long_run_pairs, random_pairs
from wfa_tpu_torch.utils.timers import TRACE

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

PEN = Penalties(2, 3, 1)


def _walks(pairs, max_steps=80, band=-1):
    """The plain K2 + K3's fused rows [B, 4 + opw] (distance, finished,
    n_ops, 0, ops...) for ``pairs``, as the chunk loop copies them back."""
    pats, txts = [p for p, _ in pairs], [t for _, t in pairs]
    nwords = max(map(len, pats + txts)) // 16 + 2
    p_w, p_len, p_ok = packing.pack_batch(pats, nwords)
    t_w, t_len, t_ok = packing.pack_batch(txts, nwords)
    args = engine_torch.batch_to_tensors(p_w, p_len, t_w, t_len, p_ok & t_ok, "cpu")
    score_cap = build_schedule(PEN, max_steps, None).unfinished_score + 1
    cfg = engine_torch.EngineConfig(PEN, max_steps, 64, band, score_cap - 1)
    tb = traceback_torch.TracebackConfig(
        PEN, 64, score_cap, band > 0,
        engine_torch.lo_pad(score_cap) if band > 0 else 0,
    )
    return pats, txts, traceback_torch.align_cigar_fused(cfg, tb, *args).numpy()


def _mixed(rng):
    return _walks(EDGE_PAIRS + random_pairs(rng, 24, 20, 200))


def _banded(rng):
    return _walks(random_pairs(rng, 16, 100, 300, 0.08), band=10)


def _distance_0(rng):
    same = [bytes(p) for p, _ in random_pairs(rng, 6, 1, 90)]
    return _walks([(p, p) for p in same] + [(b"", b""), (b"ACGT" * 8,) * 2])


def _not_decoded(rng):
    """Unfinished pairs (distances past max_steps' scores), rows marked
    unfinished, corrupt walks (n_ops < 0) and a stream longer than its
    row, each beside pairs that decode."""
    pats, txts, rows = _walks(random_pairs(rng, 24, 100, 200, 0.1), max_steps=12)
    assert (rows[:, 1] == 0).sum() >= 3 and (rows[:, 1] != 0).sum() >= 6
    rows[0, 1] = 0
    rows[1, 2] = -1
    rows[2, 2] = -7
    rows[3, 2] = 16 * (rows.shape[1] - 4) + 1
    return pats, txts, rows


def _long_match(rng):
    """Runs of 10,000 bases and more: five digits a run length."""
    return _walks(long_run_pairs(rng, 6, 10_000, 10_300), max_steps=120)


def _one_pair(rng):
    pats, txts, rows = _walks(random_pairs(rng, 1, 150, 160, 0.05))
    assert rows[0, 2] > 0
    return pats, txts, rows


CASES = {
    "mixed": _mixed,
    "banded": _banded,
    "distance_0": _distance_0,
    "not_decoded": _not_decoded,
    "long_match": _long_match,
    "one_pair": _one_pair,
}


@pytest.fixture(scope="module")
def builds():
    libs = {}
    for openmp in (True, False):
        so = _build.build_native(openmp)
        if so is not None:
            libs["omp" if openmp else "serial"] = native._load_and_bind(str(so))
    if "serial" not in libs:
        pytest.skip("the native host library could not be built here (no g++)")
    return libs


@pytest.fixture(scope="module")
def cases():
    return {name: make(np.random.default_rng(sorted(CASES).index(name) + 21))
            for name, make in CASES.items()}


def _decode(lib, monkeypatch, *args):
    """``cigar_from_ops_batch`` on ``lib``, and its counters in one call."""
    was = TRACE.on
    TRACE.enable()
    TRACE.clear()
    try:
        with monkeypatch.context() as m:
            m.setattr(native, "get_lib", lambda: lib)
            with TRACE.span("call"):
                got = native.cigar_from_ops_batch(*args)
        (call,) = TRACE.calls()
    finally:
        TRACE.on = was
        TRACE.clear()
    return got, call["counters"]


@pytest.mark.parametrize("build", ["omp", "serial"])
@pytest.mark.parametrize("inputs", ["contiguous", "view", "bytes_like"])
@pytest.mark.parametrize("name", list(CASES))
def test_decode_equals_wfa_tpu(builds, cases, monkeypatch, name, inputs, build):
    """Byte-equal CIGARs and the same status as wfa_tpu's native decoder,
    from op rows read contiguous or through the fused rows' ``[:, 4:]``
    view, and from sequences as ``bytes`` or as bytearray and memoryview."""
    if build not in builds:
        pytest.skip(f"the {build} build fails here")
    pats, txts, rows = cases[name]
    fin = rows[:, 1] != 0
    want, want_st = tpu_native.cigar_from_ops_batch(
        np.ascontiguousarray(rows[:, 4:]), rows[:, 2], fin, pats, txts)
    if name == "not_decoded":
        # wfa_tpu's decoder reads row 3's stream on past its row; the
        # port's refuses it.
        want[3], want_st[3] = None, 0
    ops = rows[:, 4:] if inputs == "view" else rows[:, 4:].copy()
    assert ops.strides[0] == 4 * (rows.shape[1] if inputs == "view" else ops.shape[1])
    if inputs == "bytes_like":
        pats = [bytearray(p) for p in pats]
        txts = [memoryview(t) for t in txts]
    (got, status), counters = _decode(builds[build], monkeypatch, ops,
                                      rows[:, 2], fin, pats, txts)
    assert got == want
    np.testing.assert_array_equal(status, want_st)
    assert set(status.tolist()) <= {0, 1}
    assert [c is None for c in got] == (status == 0).tolist()
    assert counters["decode_native"] == len(pats)
    assert counters["decode_threads"] == 1 if build == "serial" else (
        counters["decode_threads"] >= 1)
    if name == "long_match":
        assert max(int(r) for c in got if c for r in re.findall(r"\d+", c)) >= 10_000
    if name == "not_decoded":
        assert status[:4].tolist() == [0, 0, 0, 0] and status.sum() >= 6
    if name == "distance_0":
        assert (rows[:, 2] == 0).all() and fin.all() and status.all()


def test_empty_batch():
    got, status = native.cigar_from_ops_batch(
        np.zeros((0, 3), np.int32), np.zeros(0, np.int32), np.zeros(0, bool),
        [], [])
    assert got == [] and status.shape == (0,)


@pytest.mark.parametrize("library", [True, False], ids=["native", "fallback"])
def test_chunk_loop_decode_counters(monkeypatch, library):
    """In the CUDA route's chunk loop (run on the CPU), ``decode_native``
    counts every pair the native decode took, and reads 0 where the library
    does not load and ``recover_cigar_from_stream`` decodes; both give the
    same results."""
    pairs = random_pairs(np.random.default_rng(5), 20, 150, 260, 0.05, 0.0, 0.0)
    pats, txts = [p for p, _ in pairs], [t for _, t in pairs]
    opts = AlignmentOptions(penalties=PEN, max_error=150, compute_cigar=True,
                            device_retries=0)
    run = aligner._run_tier_cuda

    def on_cpu(*args):
        return run(*args, device=torch.device("cpu"), smem=48 * 1024)

    def align(with_library):
        was = TRACE.on
        TRACE.enable()
        TRACE.clear()
        try:
            with monkeypatch.context() as m:
                m.setattr(aligner, "_resolve_backend", lambda name: "cuda")
                m.setattr(aligner, "_run_tier_cuda", on_cpu)
                m.setattr(aligner, "_CUDA_CIGAR_CALL_BATCH", 8)
                if not with_library:
                    m.setattr(native, "available", lambda: False)
                res = wfa_tpu_torch.align_pairs(pats, txts, opts)
            (call,) = TRACE.calls()
        finally:
            TRACE.on = was
            TRACE.clear()
        return [dataclasses.astuple(r) for r in res], call

    res, call = align(library)
    counters = call["counters"]
    assert call["stages"]["decode"]["n"] >= 3            # 8 pairs a chunk
    assert counters["pairs_on_card"] == len(pairs)
    on = library and native.available()
    assert counters["decode_native"] == (len(pairs) if on else 0)
    assert ("decode_threads" in counters) == on
    assert all(r[1] for r in res)                        # every CIGAR
    if not library:
        assert res == align(True)[0]
