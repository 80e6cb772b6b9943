"""The PyTorch/CUDA port stands alone: it imports neither jax nor anything of
wfa_tpu, builds its one native host library even without OpenMP and each
CUDA library only when it is asked for, and refuses
what it does not do: the card's backends (``cuda``, and ``auto``, the
default) without a CUDA device, and backends it does not have."""
import ast
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import wfa_tpu_torch
from wfa_tpu_torch import AlignmentOptions, native
from wfa_tpu_torch.ops import _build
from wfa_tpu_torch.utils.io import read_seq_file

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
# The port, and the scripts that run it on the card (the tools that write
# reference files from wfa_tpu import it on purpose).
PORT_FILES = sorted((ROOT / "wfa_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "torch_stage_times.py",
    ROOT / "tools" / "torch_ring_bw.py", ROOT / "tools" / "torch_sol_calibrate.py",
    ROOT / "tools" / "torch_gather_probe.py", ROOT / "tools" / "torch_k1k2_times.py",
    ROOT / "tools" / "torch_nanopore_recall.py", ROOT / "tools" / "torch_check_cigars.py",
    ROOT / "examples" / "torch_auto_example.py",
    ROOT / "examples" / "torch_manual_example.py",
]


def _module_names():
    pkg = ROOT / "wfa_tpu_torch"
    for path in sorted(pkg.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _imports_of(path: Path) -> list[str]:
    """Absolute module names imported anywhere in the file."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_source_imports_neither_wfa_tpu_nor_jax(path):
    """Nor ``bench``, whose workloads the port's tools copy."""
    bad = [
        n for n in _imports_of(path)
        if n.split(".")[0] in ("wfa_tpu", "jax", "jaxlib", "bench")
    ]
    assert not bad, f"{path.name} imports {bad}"


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {list(_module_names())!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_port_imports_nothing_of_wfa_tpu():
    """After importing every module of the port, no module named wfa_tpu or
    wfa_tpu.* is loaded."""
    code = (
        "import importlib, sys\n"
        f"names = {list(_module_names())!r}\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'wfa_tpu' or m.startswith('wfa_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'wfa_tpu_torch.ops.engine_cuda' in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_cuda_backend_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        wfa_tpu_torch.align_pairs(
            [b"ACGT"], [b"ACGA"], AlignmentOptions(backend="cuda")
        )
    # auto, the default, is the card too: it never runs on the CPU.
    for opts in (AlignmentOptions(backend="auto"), AlignmentOptions()):
        with pytest.raises(RuntimeError, match="CUDA"):
            wfa_tpu_torch.align_pairs([b"ACGT"], [b"ACGA"], opts)
    # Only backend='torch' runs the plain engine on the CPU.
    res = wfa_tpu_torch.align_pairs(
        [b"ACGT"], [b"ACGA"], AlignmentOptions(backend="torch")
    )
    assert res[0].error == 2 and res[0].finished_on_accelerator


def test_native_host_library_builds_serially():
    """The serial form of the native host library, the one ``get_lib``
    falls back to where the host compiler has no OpenMP runtime: one
    thread, the same exact scores."""
    so = _build.build_native(False)
    assert so == _build.native_path(False)
    assert so.parent.name == "torch_native" and "_serial_" in so.name
    lib = native._load_and_bind(str(so))
    assert lib.wfa_cpu_num_threads() == 1
    batch = read_seq_file(ROOT / "tests" / "data" / "wfa.utest.seq", 5)
    gold = (ROOT / "tests" / "data" / "results" / "test.score.affine.p0.alg")
    want = [-int(ln.split()[0]) for ln in gold.read_text().splitlines()[:5]]
    got = [
        lib.wfa_cpu_align_single(p, len(p), t, len(t), 1, 2, 1)
        for p, t in batch.pairs()
    ]
    assert got == want
    assert native.available()


def test_native_sources_are_the_makefiles_and_the_ports():
    """One library holds native/Makefile's SRCS and every host source of
    the port's own under ops/csrc/."""
    make = (ROOT / "native" / "Makefile").read_text()
    srcs = next(ln for ln in make.splitlines() if ln.startswith("SRCS")).split()[2:]
    csrc = ROOT / "wfa_tpu_torch" / "ops" / "csrc"
    ports = (csrc / "presort_scan.cpp", csrc / "pack_slot.cpp",
             csrc / "cigar_ops.cpp")
    assert sorted(csrc.glob("*.cpp")) == sorted(ports)
    assert _build.NATIVE_SOURCES == (
        tuple(ROOT / "native" / s for s in srcs) + ports)


def test_native_library_name_follows_sources_and_flags(tmp_path, monkeypatch):
    """The library's name is a hash of the flags and of every source's
    bytes: the same bytes give the same name wherever they lie, and one
    more byte in any source, another form or one more flag another."""
    copies = []
    for src in _build.NATIVE_SOURCES:
        copies.append(tmp_path / src.name)
        copies[-1].write_bytes(src.read_bytes())
    names = {_build.native_path(False, copies), _build.native_path(True, copies)}
    assert names == {_build.native_path(False), _build.native_path(True)}
    assert len(names) == 2
    for copy in copies:
        before = copy.read_bytes()
        copy.write_bytes(before + b"\n")
        names.add(_build.native_path(False, copies))
        copy.write_bytes(before)
    assert len(names) == 2 + len(copies)
    monkeypatch.setattr(_build, "HOST_CXXFLAGS", _build.HOST_CXXFLAGS + ("-DNDEBUG",))
    names |= {_build.native_path(False, copies), _build.native_path(True, copies)}
    assert len(names) == 4 + len(copies)


@pytest.mark.parametrize("openmp", [True, False], ids=["omp", "serial"])
def test_native_library_exports_every_bound_entry(openmp):
    so = _build.build_native(openmp)
    if so is None:
        pytest.skip(f"the {'OpenMP' if openmp else 'serial'} form fails here")
    raw = ctypes.CDLL(str(so))
    assert [name for name in native._ENTRIES if not hasattr(raw, name)] == []
    native._load_and_bind(str(so))


def test_cli_verbose_logs_the_native_library_once(tmp_path):
    """``-v`` names the native host library that loaded, its form and its
    threads, once in a process."""
    proc = subprocess.run(
        [sys.executable, "-m", "wfa_tpu_torch.cli", "-i",
         str(ROOT / "tests" / "data" / "wfa.utest.seq"), "-n", "2", "-g", "1,2,1",
         "-e", "100", "--backend", "torch", "-v", "-o", str(tmp_path / "out")],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    lines = re.findall(r"native host library (\S+): (omp|serial), "
                       r"wfa_cpu_num_threads (\d+)", proc.stderr)
    assert len(lines) == 1, proc.stderr
    path, form, threads = lines[0]
    assert Path(path).name.startswith(f"libwfa_native_{form}_")
    assert int(threads) >= 1 and (form == "omp" or threads == "1")


def test_cuda_library_is_built_alone_when_asked_for(tmp_path, monkeypatch):
    """Asking for a CUDA library runs one nvcc, on its own source: the
    others are built only when they are asked for."""
    record = tmp_path / "calls.txt"
    stub = tmp_path / "nvcc"
    # Records its arguments and leaves an empty shared library at -o.
    stub.write_text(
        f"#!/bin/sh\necho \"$*\" >> {record}\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
        "g++ -shared -fPIC -x c++ /dev/null -o \"$out\"\n")
    stub.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "cuda")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_bind", lambda name, lib: None)
    _build.load_library("wfa_distance")
    _build.load_library("wfa_distance")
    calls = record.read_text().splitlines()
    assert len(calls) == 1 and calls[0].endswith("/csrc/wfa_distance.cu")
    assert not any(src in calls[0] for name, src in _build.SOURCES.items()
                   if name != "wfa_distance")
    assert list(_build._libs) == ["wfa_distance"]
    assert [p.name for p in (tmp_path / "cuda").glob("*.so")] == [
        _build.library_path("wfa_distance").name]
    _build.load_library("wfa_traceback")
    calls = record.read_text().splitlines()
    assert len(calls) == 2 and calls[1].endswith("/csrc/wfa_traceback.cu")


def test_unsupported_requests_raise():
    with pytest.raises(ValueError):
        wfa_tpu_torch.align_pairs(
            [b"ACGT"], [b"ACGT"], AlignmentOptions(backend="xla")
        )
