"""The PyTorch/CUDA port stands alone: it imports neither jax nor anything of
wfa_tpu, builds its native host library even without OpenMP, and refuses
what it does not do: the card's backends (``cuda``, and ``auto``, the
default) without a CUDA device, and backends it does not have."""
import ast
import ctypes
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import wfa_tpu_torch
from wfa_tpu_torch import AlignmentOptions
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
    bad = [
        n for n in _imports_of(path)
        if n.split(".")[0] in ("wfa_tpu", "jax", "jaxlib")
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


def test_native_host_library_builds_serially(tmp_path):
    """The build ensure_native falls back to where the host compiler has no
    OpenMP runtime: one thread, the same exact scores."""
    proc = _build.build_native_serial(tmp_path)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(tmp_path / "libwfatpu_native.so"))
    assert lib.wfa_cpu_num_threads() == 1
    batch = read_seq_file(ROOT / "tests" / "data" / "wfa.utest.seq", 5)
    gold = (ROOT / "tests" / "data" / "results" / "test.score.affine.p0.alg")
    want = [-int(ln.split()[0]) for ln in gold.read_text().splitlines()[:5]]
    got = [
        lib.wfa_cpu_align_single(p, len(p), t, len(t), 1, 2, 1)
        for p, t in batch.pairs()
    ]
    assert got == want
    assert _build.ensure_native()
    assert _build.native_library_path().parent.name == "torch_native"


def test_unsupported_requests_raise():
    with pytest.raises(ValueError):
        wfa_tpu_torch.align_pairs(
            [b"ACGT"], [b"ACGT"], AlignmentOptions(backend="xla")
        )
