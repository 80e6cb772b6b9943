"""The harness on the CPU, on the plain engine: a cell, a configuration, a
traffic mix and a metric that exist only in a copy of the benchmark are
found by name and run; the result line; runs whose timed path is broken
underneath come out not correct; the controls come out not correct; no
card, no result."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from wfabench import control, harness

ROOT = Path(__file__).resolve().parents[2]

TINY = {"generator": "pairs", "source": "random", "length": [90, 110],
        "edit_rate": 0.08, "pool_calls": 2, "trace_calls": 3}
TINY_CIGAR = dict(TINY, compute_cigar=True)
NEW_CONFIG = {"name": "tiny_exact_145", "source": "a test", "penalties": [1, 4, 5],
              "band": -1, "max_error": 60, "batch_size": 8,
              "control": {"setting": {"wf_width": 3}}, "reduced": []}
NEW_METRIC = '''"""calls_in_window: the window's calls."""


def read(run):
    return float(len(run.calls))
'''

# Run one cell of the copy at ``sys.argv[1]``; ``sys.argv[3]`` names a fault.
RUNNER = r'''
import json, sys, time
T = time.perf_counter()
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(2)
from wfabench import harness
from wfa_tpu_torch import native
from wfa_tpu_torch.ops import engine_cuda

def stale(align):
    last = []
    def run(pats, txts, opts):
        res = align(pats, txts, opts)
        out = last[0] if last else res
        last[:] = [res]
        return out
    return run

fault = None
name = sys.argv[3]
if name == "stale":
    fault = stale
elif name in ("half", "altered"):
    plain = engine_cuda.align_batch_cuda
    def broken(cfg, *args, **kw):
        out = plain(cfg, *args, **kw)
        d = out["distance"]
        if name == "half":
            n = (len(d) + 1) // 2
            d[n:] = d[: len(d) - n]
        else:
            d[0] += 2
        return out
    engine_cuda.align_batch_cuda = broken
elif name == "cigar":
    decode = native.traceback_batch
    def broken(*args, **kw):
        cigars, rest = decode(*args, **kw)
        cigars[0] = cigars[0].replace("M", "X", 1)
        return cigars, rest
    native.traceback_batch = broken
cell = harness.find_cell(sys.argv[4], root=__import__("pathlib").Path(sys.argv[1]))
result, lines = harness.execute(cell, 2**31 + 99, 1.0, sys.argv[5] == "1", T,
                                backend="torch", fault=fault)
print(json.dumps(result))
'''


@pytest.fixture(scope="module")
def copy(tmp_path_factory) -> Path:
    """A copy of the benchmark with a new cell on a new configuration,
    traffic and metric, and a new CIGAR cell on a configuration that is
    ``hifi_banded`` at a batch of 8."""
    tmp = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "wfabench", tmp / "wfabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in ("tiny_exact_145", "tiny_banded"):
        spec["configs"].append({"name": name, "source": "a test",
                                "file": f"wfabench/configs/{name}.json",
                                "reduced": ["batch_size"], "why": "a test"})
    spec["workloads"] += [
        {"name": "tiny.dist", "config": "tiny_exact_145", "traffic": "tiny",
         "chips": 1, "why": "a test"},
        {"name": "tiny.cigar", "config": "tiny_banded", "traffic": "tiny_cigar",
         "chips": 1, "why": "a test"}]
    for m in spec["per_layer"]:
        m["workloads"] += ["tiny.dist", "tiny.cigar"]
    spec["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "harness", "moves": "aln_per_s",
                              "workloads": ["tiny.dist"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp / "wfabench/configs/tiny_exact_145.json").write_text(json.dumps(NEW_CONFIG))
    banded = json.loads((ROOT / "wfabench/configs/hifi_banded.json").read_text())
    banded.update(name="tiny_banded", batch_size=8)
    (tmp / "wfabench/configs/tiny_banded.json").write_text(json.dumps(banded))
    (tmp / "wfabench/traffic/tiny.json").write_text(json.dumps(TINY))
    (tmp / "wfabench/traffic/tiny_cigar.json").write_text(json.dumps(TINY_CIGAR))
    (tmp / "wfabench/metrics/calls_in_window.py").write_text(NEW_METRIC)
    (tmp / "runner.py").write_text(RUNNER)
    return tmp


def _run(copy: Path, cell: str, trace: bool, fault: str = "none") -> dict:
    proc = subprocess.run(
        [sys.executable, str(copy / "runner.py"), str(copy), str(ROOT), fault, cell,
         "1" if trace else "0"],
        capture_output=True, text=True, timeout=600, cwd=copy)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_a_new_cell_and_metric_are_found_and_run(copy, trace):
    result = _run(copy, "tiny.dist", trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 2 * NEW_CONFIG["batch_size"]
    metrics = result["metrics"]
    if trace:
        assert metrics["calls_in_window"]["value"] >= 1
        assert metrics["card_share"]["value"] == 100.0
        assert "presort_ms" not in metrics      # short reads bypass the presort
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert set(metrics) == {"aln_per_s", "call_p95_ms", "setup_s"}
        assert all(m["value"] > 0 for m in metrics.values())
    assert result["checks"] == {"wrong_distance": {"value": 0, "limit": 0},
                                "unjudged": {"value": 0, "limit": 0}}


def test_a_new_cigar_cell_on_a_derived_config(copy):
    result = _run(copy, "tiny.cigar", False)
    assert result["correct"] is True
    assert result["checks"]["wrong_cigar"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("fault,cell", [
    ("stale", "tiny.dist"),      # a call returns the state of the call before
    ("half", "tiny.dist"),       # half the batch left out, the rest's answers reused
    ("altered", "tiny.dist"),    # a distance altered where the engine makes it
    ("cigar", "tiny.cigar"),     # a CIGAR altered where it is decoded
])
def test_a_broken_timed_path_is_not_correct(copy, fault, cell):
    result = _run(copy, cell, False, fault)
    assert result["correct"] is False and result["failed"] > 0
    bad = result["checks"]["wrong_cigar" if fault == "cigar" else "wrong_distance"]
    assert bad["value"] > bad["limit"]


@pytest.mark.parametrize("config,batch,traffic", [
    ("exact_231", {"batch_size": 200, "max_error": 300},
     {"generator": "pairs", "source": "random", "length": [1000, 1000],
      "edit_rate": 0.062, "pool_calls": 1}),
    ("hifi_banded", {"batch_size": 50},
     {"generator": "pairs", "source": "test_hifi.seq.gz", "edit_rate": 0.001,
      "pool_calls": 1}),
])
def test_the_control_is_not_correct(config, batch, traffic):
    import torch

    torch.set_num_threads(2)
    cfg = json.loads((ROOT / "wfabench" / "configs" / f"{config}.json").read_text())
    cell = harness.Cell("control", 1, dict(cfg, **batch), traffic, [], [])
    counts = control.control_counts(cell, 4242, torch.device("cpu"))
    assert counts["wrong_distance"] > harness.LIMITS["wrong_distance"]
    assert counts["unjudged"] == 0


def _bare_run(cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "wfabench/run.py", "--workload", "hifi.dist", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_no_card_no_result():
    proc = _bare_run(ROOT)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copytree(ROOT / "wfabench", tmp_path / "wfabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = _bare_run(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
