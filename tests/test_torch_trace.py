"""The host stages' spans and counters (``utils.timers.TRACE``) of
``align_pairs`` on the CPU: off, nothing is recorded; on, each call is one
``call`` record with a fresh id whose spans nest in time and whose leaf
spans and unnamed time add up to the call; the counters match the results
and the chunk loop's own account; the pipeline's threads keep their calls
apart; under ``device_trace`` the ``wfa.*`` ranges nest in the call's."""
import dataclasses
import json
import logging
import re
import threading

import numpy as np
import pytest
import torch

import wfa_tpu_torch
from wfa_tpu_torch import AlignmentOptions, Penalties, aligner
from wfa_tpu_torch.cli import main
from wfa_tpu_torch.pipeline import align_pairs_pipelined
from wfa_tpu_torch.utils.presort import MIN_PRESORT_TIER
from wfa_tpu_torch.utils.synth import random_pairs
from wfa_tpu_torch.utils.timers import TRACE, Trace, device_trace

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

PEN = Penalties(2, 3, 1)
BANDED = AlignmentOptions(penalties=PEN, max_error=400, band=25, band_width=64,
                          backend="torch")
# The CUDA route's chunk loop on the CPU: a shared memory that holds the
# exact window (K1), and 8 pairs a launch, so 28 pairs take 4 chunks.
SMEM = 48 * 1024
CHUNK = 8
CHUNK_PAIRS = 28
LEAVES = ("presort", "plan", "slots", "pack", "launch", "wait", "decode",
          "results", "fallback")


@pytest.fixture(autouse=True)
def trace_off():
    """Each test starts with tracing off and no records, and leaves it so."""
    was = TRACE.on
    TRACE.disable()
    TRACE.clear()
    yield
    TRACE.on = was
    TRACE.clear()


def _pairs(n, lo, hi, err, seed, n_rate=0.0):
    pairs = random_pairs(np.random.default_rng(seed), n, lo, hi, err, n_rate, 0)
    return [p for p, _ in pairs], [t for _, t in pairs]


def _long_pairs(n=3, seed=15):
    """Pairs long enough for the presort, with few edits."""
    return _pairs(n, MIN_PRESORT_TIER + 50, MIN_PRESORT_TIER + 200, 0.01, seed)


def _check_call(call):
    """Spans nest in time under parents of the same call; the leaf spans
    and ``other`` add up to the call."""
    spans = call["spans"]
    assert spans[0][0] == "call" and spans[0][1] == -1
    assert (spans[0][2], spans[0][3]) == (call["start"], call["end"])
    parents = set()
    for name, parent, start, end in spans[1:]:
        assert 0 <= parent < len(spans)
        parents.add(parent)
        _, _, p_start, p_end = spans[parent]
        assert p_start <= start <= end <= p_end, name
    assert call["cpu"] >= 0
    leaves = sum(end - start for i, (_, _, start, end) in enumerate(spans)
                 if i not in parents)
    assert leaves + call["other"] == pytest.approx(call["end"] - call["start"],
                                                   rel=1e-9, abs=1e-9)
    return parents


def test_off_records_nothing():
    pats, txts = _long_pairs(2)
    assert TRACE.span("call") is TRACE.span("pack")   # the shared no-op
    TRACE.count("pairs", 5)
    with TRACE.span("call"):
        TRACE.count("pairs")
    res = wfa_tpu_torch.align_pairs(pats, txts, BANDED)
    assert all(r.finished_on_accelerator for r in res)
    assert TRACE.calls() == []


def test_on_one_record_a_call():
    pats, txts = _long_pairs()
    TRACE.enable()
    res = wfa_tpu_torch.align_pairs(pats, txts, BANDED)
    wfa_tpu_torch.align_pairs(pats[:2], txts[:2], BANDED)
    calls = TRACE.calls()
    assert len(calls) == 2 and calls[0]["id"] != calls[1]["id"]
    for call in calls:
        parents = _check_call(call)
        # The plain engine's tier is a leaf: only the call has children.
        assert parents == {0}
        assert call["other"] == pytest.approx(call["stages"]["call"]["self"])
        assert call["stages"]["call"]["n"] == 1
        assert {"presort", "plan", "tier"} <= set(call["stages"])
    counters = dict(calls[0]["counters"])
    assert counters.pop("presort_threads") >= 1
    assert counters == {
        "pairs": 3, "pairs_on_card": sum(r.finished_on_accelerator for r in res),
        "presort_native": 3}
    # The window: only calls wholly inside it.
    first, second = calls
    assert [c["id"] for c in TRACE.calls(first["start"], second["end"])] == [
        first["id"], second["id"]]
    assert [c["id"] for c in TRACE.calls(first["start"] + 1e-9, second["end"])] == [
        second["id"]]
    assert TRACE.calls(first["start"], second["end"] - 1e-9) == [
        c for c in TRACE.calls() if c["id"] == first["id"]]


def test_retries_and_fallback_are_counted():
    pats, txts = _pairs(12, 90, 110, 0.2, 3)
    pats[0] = b"N" + pats[0][1:]                 # not ACGT: no retry, the CPU
    opts = AlignmentOptions(penalties=PEN, max_error=12, backend="torch",
                            device_retries=1)
    TRACE.enable()
    res = wfa_tpu_torch.align_pairs(pats, txts, opts)
    (call,) = TRACE.calls()
    _check_call(call)
    c = call["counters"]
    on_card = sum(r.finished_on_accelerator for r in res)
    assert c["pairs"] == 12 and c["pairs_on_card"] == on_card
    assert c["fallback_pairs"] == 12 - on_card >= 1
    assert c["retry_passes"] == 1 and 1 <= c["retry_pairs"] < 12
    assert call["stages"]["fallback"]["n"] == 1
    assert call["stages"]["tier"]["n"] >= 2      # the first pass and the retry


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
def test_presort_counters(monkeypatch, native):
    """``presort_native`` counts the long pairs of a call, those the
    presort scores natively, and reads 0 where the Python scan serves;
    ``presort_threads`` is the native scan's thread count, a level that
    the call's passes do not add up."""
    long_pats, long_txts = _long_pairs(3)
    pats, txts = _pairs(4, 90, 110, 0.05, 7)
    pats, txts = long_pats + pats, long_txts + txts
    if not native:
        monkeypatch.setattr(wfa_tpu_torch.native, "available", lambda: False)
    elif not wfa_tpu_torch.native.available():
        pytest.skip("the presort's scan could not be built here (no g++)")
    TRACE.enable()
    wfa_tpu_torch.align_pairs(pats, txts, BANDED)
    (call,) = TRACE.calls()
    c = call["counters"]
    assert c["presort_native"] == (3 if native else 0)
    assert call["stages"]["presort"]["n"] == 1
    if native:
        assert c["presort_threads"] >= 1 and "presort_threads" in TRACE.levels
    else:
        assert "presort_threads" not in c
    with TRACE.span("call"):
        TRACE.level("presort_threads", 3)
        TRACE.level("presort_threads", 2)
    assert TRACE.calls()[-1]["counters"] == {"presort_threads": 3}


def _chunk_loop(monkeypatch, cigar, length=(600, 900), max_error=150):
    """align_pairs through the CUDA route's chunk loop on the CPU; the
    results and each tier's returned account."""
    pats, txts = _pairs(CHUNK_PAIRS, *length, 0.05, 10)
    stats = []
    run = aligner._run_tier_cuda

    def on_cpu(*args):
        stats.append(run(*args, device=torch.device("cpu"), smem=SMEM))
        return stats[-1]

    opts = AlignmentOptions(penalties=PEN, max_error=max_error,
                            compute_cigar=cigar, device_retries=0)
    with monkeypatch.context() as m:
        m.setattr(aligner, "_resolve_backend", lambda name: "cuda")
        m.setattr(aligner, "_run_tier_cuda", on_cpu)
        m.setattr(aligner, "_CUDA_CALL_BATCH", CHUNK)
        m.setattr(aligner, "_CUDA_CIGAR_CALL_BATCH", CHUNK)
        res = wfa_tpu_torch.align_pairs(pats, txts, opts)
    return res, stats


@pytest.mark.parametrize("cigar", [False, True], ids=["distance", "cigar"])
def test_chunk_loop_spans_and_counters(monkeypatch, cigar):
    TRACE.enable()
    res, stats = _chunk_loop(monkeypatch, cigar)
    assert [(s["chunks"], s["depth"], s["peak"]) for s in stats] == [(4, 4, 4)]
    (call,) = TRACE.calls()
    parents = _check_call(call)
    st = call["stages"]
    for name in ("pack", "launch", "wait", "results") + (("decode",) if cigar else ()):
        assert st[name]["n"] == 4, name
    assert st["slots"]["n"] == st["tier"]["n"] == 1
    assert st["plan"]["n"] == 2                  # the tiers, then the tier's geometry
    assert "decode" in st if cigar else "decode" not in st
    # The call and the tier hold the other spans; every other span is a leaf.
    names = [s[0] for s in call["spans"]]
    assert {names[i] for i in parents} == {"call", "tier"}
    assert set(names) - {"call", "tier"} <= set(LEAVES)
    assert call["other"] == pytest.approx(st["call"]["self"] + st["tier"]["self"])
    counters = call["counters"]
    assert {k: counters[k] for k in ("chunks", "depth", "peak")} == stats[0]
    assert counters["pairs_on_card"] == sum(r.finished_on_accelerator for r in res)
    packer = wfa_tpu_torch.native.available()
    assert counters["pack_native"] == (CHUNK_PAIRS if packer else 0)
    assert "pinned_bytes" not in counters        # the CPU's slots are not page-locked


def test_pipeline_threads_keep_their_calls():
    pats, txts = _pairs(16, 90, 110, 0.05, 4)
    opts = dataclasses.replace(BANDED, batch_size=8)
    TRACE.enable()
    res = align_pairs_pipelined(pats, txts, opts)
    calls = TRACE.calls()
    assert len(res) == 16 and len({c["id"] for c in calls}) == len(calls) == 2
    for call in calls:
        assert call["thread"] != threading.get_ident()   # the workers'

        _check_call(call)
        assert call["counters"]["pairs"] == 8


def test_the_buffer_keeps_the_last_calls():
    trace = Trace(max_calls=3)
    trace.enable()
    for _ in range(5):
        with trace.span("call"):
            with trace.span("plan"):
                trace.count("pairs", 2)
    with trace.span("plan"):                     # outside a call: not recorded
        trace.count("pairs")
    calls = trace.calls()
    assert [c["id"] for c in calls] == [3, 4, 5]
    assert all(c["counters"] == {"pairs": 2} for c in calls)


def test_profiler_ranges_nest_in_the_call(monkeypatch, tmp_path):
    with device_trace(str(tmp_path)):
        _chunk_loop(monkeypatch, False, (90, 110), 20)
    assert not TRACE.on                          # as it was before
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("name", "").startswith("wfa.")]
    (call,) = [e for e in ranges if e["name"] == "wfa.call"]
    assert {e["name"] for e in ranges} == {
        "wfa.call", "wfa.plan", "wfa.tier", "wfa.slots", "wfa.pack", "wfa.launch",
        "wfa.wait", "wfa.results"}
    for e in ranges:
        assert call["ts"] <= e["ts"] and e["ts"] + e["dur"] <= call["ts"] + call["dur"]


def test_cli_verbose_logs_each_stage(tmp_path, caplog):
    caplog.set_level(logging.INFO, logger="wfa_tpu_torch")
    pats, txts = _long_pairs(2)
    seq = tmp_path / "pairs.seq"
    seq.write_bytes(b"".join(b">" + p + b"\n<" + t + b"\n" for p, t in zip(pats, txts)))
    assert main(["-i", str(seq), "-g", "2,3,1", "-e", "400", "-B", "25", "-t", "64",
                 "--backend", "torch", "-v"]) == 0
    assert not TRACE.on
    lines = [r.getMessage() for r in caplog.records]
    for stage in ("call", "presort", "plan", "tier"):
        assert any(ln.startswith(f"stage {stage}: 1 of 1 calls") for ln in lines), lines
    assert any(ln.startswith("stage other: wall") and "cpu" in ln for ln in lines)
    (counters,) = [ln for ln in lines if ln.startswith("counters: ")]
    assert re.fullmatch(
        r"counters: pairs=2 pairs_on_card=2 presort_native=2 presort_threads=[1-9]\d*",
        counters), counters
