"""The import guard: nothing a run imports is JAX or the JAX package
(compared by whole top-level names: ``wfa_tpu_torch`` is the program, not
``wfa_tpu``), nor the JAX-era benchmark or its records; the reference
imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "wfabench"
REFUSED = {"jax", "jaxlib", "flax", "wfa_tpu", "bench", "benchmarks"}
# Names of the JAX-era records, spelled so that this file does not hold them.
RECORDS = ("BENCH" + "_", "BASE" + "LINE", "MULTI" + "CHIP_")
MODULES = sorted(p for p in BENCH.rglob("*.py")
                 if "tests" not in p.relative_to(BENCH).parts)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", "")) in ("import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    names.add(arg.value.split(".")[0])
    return names


def _strings(path: Path) -> list[str]:
    return [n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def test_the_guard_compares_whole_top_level_names():
    assert "wfa_tpu_torch".split(".")[0] not in REFUSED
    assert "wfa_tpu.aligner".split(".")[0] in REFUSED


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_refused_import_and_no_jax_era_record(path):
    assert not _imports(path) & REFUSED
    for text in _strings(path):
        assert not any(r in text for r in RECORDS), text
    if "reference" in path.relative_to(BENCH).parts:
        assert "wfa_tpu_torch" not in _imports(path)


def test_span_targets_name_only_the_program():
    from wfabench.harness import load_module

    for path in (BENCH / "metrics").glob("*.py"):
        for target in getattr(load_module(path), "SPANS", {}).values():
            assert target.split(".")[0] == "wfa_tpu_torch"


def test_loaded_modules():
    code = ("import sys; sys.path[0] = %r; import wfabench.reference.wfa, "
            "wfabench.reference.cigar; assert 'wfa_tpu_torch' not in sys.modules; "
            "import wfabench.harness, wfabench.control, wfabench.devslice, "
            "wfabench.roofline, wfa_tpu_torch; "
            "from wfabench.harness import forbidden_modules; "
            "assert forbidden_modules() == [], forbidden_modules()" % str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_the_run_time_guard_names_what_it_finds(monkeypatch):
    import types

    from wfabench.harness import forbidden_modules

    monkeypatch.setitem(sys.modules, "wfa_tpu_torchx", types.ModuleType("x"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "wfa_tpu.aligner", types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("z"))
    assert forbidden_modules() == ["jaxlib", "wfa_tpu"]
