"""BENCHMARK.json against the benchmark's rules: names, units and the files
each entry names."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "wfabench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["wfabench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])


@pytest.mark.parametrize("section", list(KEYS))
def test_entries_have_the_allowed_keys_and_names(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert set(e) <= KEYS[section]
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads", "per_layer"):
                assert _line(e[key]), (e["name"], key)


def test_names_of_configs_traffic_and_reduced_keys():
    for w in SPEC["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert all(NAME.fullmatch(k) for k in c["reduced"]) and len(c["reduced"]) <= 16


def test_files_named_by_the_spec_exist():
    configs = {c["name"] for c in SPEC["configs"]}
    used = {w["config"] for w in SPEC["workloads"]}
    assert configs == used
    for c in SPEC["configs"]:
        assert PATH.fullmatch(c["file"]) and c["file"].startswith("wfabench/")
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        assert config["batch_size"] > 0 and config["max_error"] > 0
        assert set(c["reduced"]) <= set(config) and set(c["reduced"]) <= set(config["source_scale"])
    for w in SPEC["workloads"]:
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "gen" / f"{traffic['generator']}.py").exists()
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()


def test_metrics_follow_the_rules():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for cell in cells:
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


def test_every_file_under_paths_has_an_allowed_name():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.fullmatch(rel), rel
