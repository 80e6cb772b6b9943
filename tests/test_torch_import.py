"""The PyTorch/CUDA port imports no jax, builds wfa_tpu's native host
library even without OpenMP, and refuses what it does not do: the CUDA
backend without a CUDA device, and the CIGAR path."""
import ctypes
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import wfa_tpu_torch
from wfa_tpu.utils.io import read_seq_file
from wfa_tpu_torch import AlignmentOptions
from wfa_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import wfa_tpu_torch, wfa_tpu_torch.cli, wfa_tpu_torch.aligner\n"
        "import wfa_tpu_torch.ops.engine_cuda, wfa_tpu_torch.utils.device_query\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_cuda_backend_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        wfa_tpu_torch.align_pairs(
            [b"ACGT"], [b"ACGA"], AlignmentOptions(backend="cuda")
        )
    # auto falls back to the torch engine only in the absence of a device.
    res = wfa_tpu_torch.align_pairs(
        [b"ACGT"], [b"ACGA"], AlignmentOptions(backend="auto")
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


def test_unsupported_requests_raise():
    with pytest.raises(NotImplementedError, match="CIGAR"):
        wfa_tpu_torch.align_pairs(
            [b"ACGT"], [b"ACGT"],
            AlignmentOptions(compute_cigar=True, backend="torch"),
        )
    with pytest.raises(ValueError):
        wfa_tpu_torch.align_pairs(
            [b"ACGT"], [b"ACGT"], AlignmentOptions(backend="xla")
        )
