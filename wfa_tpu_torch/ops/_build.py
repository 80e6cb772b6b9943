"""Build and load the port's CUDA kernels.

The sources under ``ops/csrc/`` are compiled at first use with ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
library lands in ``build/cuda/`` at the repository root, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one is
reused.  The compiler's output (``-Xptxas -v``: registers, shared memory,
spills) is kept beside it as a ``.log`` file.

``ensure_native`` makes sure ``wfa_tpu``'s native host library (packing,
readers, the CPU fallback) is built too: ``make -C native`` with its own
flags, and where the host compiler has no OpenMP runtime, the same sources
built serially.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_REPO = Path(__file__).resolve().parents[2]
_BUILD_DIR = _REPO / "build" / "cuda"
_SOURCES = ("wfa_distance.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_native_ok: bool | None = None


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    return _BUILD_DIR / f"libwfa_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them already exists."""
    so = library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(_CSRC / name) for name in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)
    return so


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first call, with its C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.wfa_distance_launch.restype = i
            lib.wfa_distance_launch.argtypes = [
                p, p, i, p, p, p, p, i, i, i, i, i, p, p, i, i, p,
            ]
            lib.wfa_smem_optin.restype = i
            lib.wfa_smem_optin.argtypes = [i, ctypes.POINTER(i)]
            lib.wfa_cuda_error_string.restype = ctypes.c_char_p
            lib.wfa_cuda_error_string.argtypes = [i]
            _lib = lib
        return _lib


def build_native_serial(build_dir: Path) -> subprocess.CompletedProcess:
    """``make -C native`` into ``build_dir`` with native/Makefile's flags
    minus ``-fopenmp``; ``csrc/serial_omp/omp.h`` stands in for the OpenMP
    header, so the library's parallel loops run serially."""
    return subprocess.run(
        ["make", "-C", str(_REPO / "native"), f"BUILD={build_dir}",
         "CXXFLAGS=-O3 -march=native -fPIC -std=c++17 -Wall -Wextra "
         f"-I{_CSRC / 'serial_omp'}",
         "LDFLAGS=-shared"],
        capture_output=True, text=True, timeout=300,
    )


def ensure_native() -> bool:
    """Whether ``wfa_tpu``'s native host library is available, building it
    once per process if not.  ``wfa_tpu.native`` runs ``make -C native``
    itself; if that fails (``-fopenmp`` needs an OpenMP runtime the host
    compiler may lack), the library is built serially in its place."""
    global _native_ok
    from wfa_tpu import native

    with _lock:
        if _native_ok is None:
            _native_ok = native.available()
            if not _native_ok:
                build_native_serial(_REPO / "build")
                _native_ok = native.available()
        return _native_ok
