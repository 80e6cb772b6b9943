"""The readers of the program's own spans and counters (``host_*_ms``,
``inflight_share``) on the CPU: on calls recorded by hand, each reads its
stage's mean over the window's calls, the leaf stages and ``host_other_ms``
add up to the mean call, and a reader refuses a window whose calls the
program and the harness count differently; where a span never opened it
reads nothing; on a traced run of the plain engine, those of the stages it
opens."""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

from wfabench import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAMES = ["host_presort_ms", "host_plan_ms", "host_slots_ms", "host_pack_ms",
         "host_launch_ms", "host_wait_ms", "host_decode_ms", "host_results_ms",
         "host_other_ms", "inflight_share"]
STAGES = {"host_presort_ms": "presort", "host_plan_ms": "plan",
          "host_slots_ms": "slots", "host_pack_ms": "pack",
          "host_launch_ms": "launch", "host_wait_ms": "wait",
          "host_decode_ms": "decode", "host_results_ms": "results"}
TINY = {"name": "tiny_exact_145", "penalties": [1, 4, 5], "band": -1,
        "max_error": 60, "batch_size": 8}
TRAFFIC = {"generator": "pairs", "source": "random", "length": [90, 110],
           "edit_rate": 0.08, "pool_calls": 2, "trace_calls": 2}


@pytest.fixture
def trace():
    """The program's recorder, emptied, as loading the readers leaves it
    (on); off again afterwards."""
    from wfa_tpu_torch.utils.timers import TRACE

    was = TRACE.on
    TRACE.clear()
    yield TRACE
    TRACE.on = was
    TRACE.clear()


@pytest.fixture
def readers(trace):
    out = {n: harness.load_module(ROOT / "wfabench" / "metrics" / f"{n}.py")
           for n in NAMES}
    assert trace.on
    return out


def _run(calls) -> harness.Run:
    """A run whose window holds ``calls`` (start, end) of the harness."""
    cell = harness.Cell("fabricated", 1, {}, {}, [], [])
    return harness.Run(cell, [(a, b, 0) for a, b in calls], 0, 0, {}, {})


def _call(trace, chunks: int, cigar: bool):
    """One call recorded by hand as the chunk loop records it."""
    def stage(name):
        with trace.span(name):
            time.sleep(0.0005)

    t0 = time.perf_counter()
    with trace.span("call"):
        stage("presort")
        stage("plan")
        with trace.span("tier"):
            stage("plan")
            stage("slots")
            for _ in range(chunks):
                stage("pack")
                stage("launch")
            for _ in range(chunks):
                stage("wait")
                if cigar:
                    stage("decode")
                stage("results")
            time.sleep(0.0005)
        trace.count("chunks", chunks)
        trace.count("peak", chunks - 1)
        time.sleep(0.001)
    return t0, time.perf_counter()


def test_the_spec_lists_each_reader_once():
    per_layer = {m["name"]: m for m in SPEC["per_layer"]}
    assert [m["name"] for m in SPEC["per_layer"][-len(NAMES):]] == NAMES
    for name in NAMES:
        m = per_layer[name]
        assert m["moves"] == "aln_per_s"
        assert m["better"] == ("higher" if name == "inflight_share" else "lower")
        assert (ROOT / "wfabench" / "metrics" / f"{name}.py").exists()


def test_readers_on_calls_recorded_by_hand(readers, trace):
    windows = [_call(trace, 2, True), _call(trace, 2, True), _call(trace, 1, False)]
    _call(trace, 1, False)                           # after the window
    run = _run(windows)
    got = {n: readers[n].read(run) for n in NAMES}
    calls = trace.calls(windows[0][0], windows[-1][1])
    assert len(calls) == 3
    for name, stage in STAGES.items():
        want = sum(c["stages"].get(stage, {"wall": 0.0})["wall"] for c in calls) / 3
        assert got[name] == pytest.approx(want * 1e3)
    mean_call = sum(c["end"] - c["start"] for c in calls) / 3 * 1e3
    assert sum(got[n] for n in NAMES[:-1]) == pytest.approx(mean_call, rel=1e-9)
    assert got["host_other_ms"] >= 1.0               # the call's and the tier's sleeps
    assert got["inflight_share"] == pytest.approx(100.0 * (1 + 1 + 0) / (2 + 2 + 1))


def test_a_window_counted_otherwise_is_refused(readers, trace):
    a = _call(trace, 1, False)
    b = _call(trace, 1, False)
    more = _run([a, b, (b[1], b[1] + 1.0)])   # a call the program never made
    fewer = _run([(a[0], b[1])])             # two calls the harness saw as one
    for name in NAMES:
        for run in (more, fewer):
            with pytest.raises(RuntimeError, match="traced"):
                readers[name].read(run)


def test_a_span_never_opened_reads_nothing(readers, trace):
    t0 = time.perf_counter()
    with trace.span("call"):
        with trace.span("plan"):
            pass
    run = _run([(t0, time.perf_counter())])
    got = {n: readers[n].read(run) for n in NAMES}
    assert got["host_plan_ms"] > 0 and got["host_other_ms"] >= 0
    assert all(got[n] is None for n in NAMES if n not in ("host_plan_ms", "host_other_ms"))


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """A reader loaded against a program that lacks ``TRACE`` reads None
    and does not raise."""
    import sys
    import types

    fake = types.ModuleType("wfa_tpu_torch.utils.timers")
    monkeypatch.setitem(sys.modules, "wfa_tpu_torch.utils.timers", fake)
    run = _run([(0.0, 1.0)])
    for name in NAMES:
        mod = harness.load_module(ROOT / "wfabench" / "metrics" / f"{name}.py")
        assert mod.TRACE is None and mod.read(run) is None


def test_a_traced_run_of_the_plain_engine(trace):
    import torch

    torch.set_num_threads(2)
    per_layer = [m for m in SPEC["per_layer"] if m["name"] in NAMES]
    cell = harness.Cell("tiny.dist", 1, dict(TINY, control={}), TRAFFIC, [], per_layer)
    result, _ = harness.execute(cell, 2**31 + 7, 1.0, True, time.perf_counter(),
                                backend="torch")
    assert result["correct"] is True
    metrics = result["metrics"]
    # Short reads bypass the presort; the plain engine has no chunk loop.
    assert set(metrics) == {"host_plan_ms", "host_other_ms"}
    assert metrics["host_plan_ms"]["value"] > 0 and metrics["host_plan_ms"]["unit"] == "ms"
