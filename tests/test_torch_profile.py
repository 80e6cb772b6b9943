"""``--profile DIR`` of the port's CLI and ``utils.timers.device_trace``: a
``torch.profiler`` trace of the alignment run in ``DIR/trace.json`` (the
counterpart of wfa_tpu's JAX profiler hook).  On the CPU the trace holds the
host's events; on the card also the kernels (``chip_smoke.py``'s profile
phase looks for K1 there)."""
import json
from pathlib import Path

import torch

from wfa_tpu_torch.cli import main
from wfa_tpu_torch.utils.timers import device_trace

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data"


def _events(path):
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def test_cli_profile_writes_a_trace(tmp_path):
    trace_dir = tmp_path / "prof"
    out = tmp_path / "res.out"
    rc = main([
        "-i", str(DATA / "wfa.utest.seq"), "-n", "20", "-g", "1,2,1",
        "-e", "100", "--backend", "torch", "--profile", str(trace_dir),
        "-o", str(out),
    ])
    assert rc == 0
    gold = (DATA / "results" / "test.score.affine.p0.alg").read_text().split("\n")
    assert [ln.split("\t")[0] for ln in out.read_text().splitlines()] == [
        ln.split()[0] for ln in gold[:20]]
    events = _events(trace_dir / "trace.json")
    assert events
    names = {e["name"] for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]


def test_device_trace_records_the_region(tmp_path):
    with device_trace(str(tmp_path)):
        torch.arange(1000).cumsum(0)
    names = {e["name"] for e in _events(tmp_path / "trace.json")}
    assert "aten::cumsum" in names


def test_device_trace_none_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ran = False
    with device_trace(None):
        ran = True
    assert ran and not list(tmp_path.iterdir())


def test_cli_profile_holds_the_stage_ranges(tmp_path):
    """Each ``align_pairs`` call's host stages are ``wfa.*`` ranges in the
    trace, inside their call's range; tracing is off again after it."""
    from wfa_tpu_torch.utils.timers import TRACE

    was = TRACE.on
    TRACE.disable()
    try:
        rc = main([
            "-i", str(DATA / "wfa.utest.seq"), "-n", "4", "-g", "1,2,1",
            "-e", "100", "--backend", "torch", "--profile", str(tmp_path),
        ])
        assert rc == 0 and not TRACE.on
    finally:
        TRACE.on = was
    ranges = [e for e in _events(tmp_path / "trace.json")
              if e["name"].startswith("wfa.")]
    assert {e["name"] for e in ranges} == {"wfa.call", "wfa.plan", "wfa.tier"}
    calls = [e for e in ranges if e["name"] == "wfa.call"]
    for e in ranges:
        assert any(c["tid"] == e["tid"] and c["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= c["ts"] + c["dur"] for c in calls)
