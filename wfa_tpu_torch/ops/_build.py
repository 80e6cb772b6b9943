"""Build and load the port's CUDA kernels and its native host library.

Each source under ``ops/csrc/`` is compiled at first use with ``nvcc`` into a
shared library of its own with a plain C interface, loaded with ``ctypes``.
``build_all`` starts one ``nvcc`` per source, all at once, and waits for
them.  The libraries land in ``build/cuda/`` at the repository root, each
named by a hash of its source and the flags, so an edited source rebuilds
and an unchanged one is reused.  The compiler's output (``-Xptxas -v``:
registers, shared memory, spills) is kept beside each as a ``.log`` file.

``ensure_native`` builds the native host library (packing, readers, the CPU
fallback, CIGAR decoding) from the repository's ``native/*.cpp`` into
``build/torch_native/``, once per process: ``make -C native`` with its own
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
_NATIVE_DIR = _REPO / "build" / "torch_native"
# Library name -> its source under csrc/.
SOURCES = {
    "wfa_distance": "wfa_distance.cu",     # K1, K2 and K4
    "wfa_traceback": "wfa_traceback.cu",   # K3
    "ring_bw": "ring_bw.cu",               # K4's ring-row traffic probe
    "sol_calibrate": "sol_calibrate.cu",   # speed-of-light calibration
    "gather_probe": "gather_probe.cu",     # the wide-gather probe
}
_HEADERS = ("wfa_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_native_ok: bool | None = None


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    """Where the library ``name`` for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (SOURCES[name], *_HEADERS):
        h.update((_CSRC / src).read_bytes())
    return _BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library does not exist yet, one ``nvcc``
    per source, all started together; raises if any fails."""
    paths = {name: library_path(name) for name in SOURCES}
    todo = {name: so for name, so in paths.items() if not so.exists()}
    if not todo:
        return paths
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, so in todo.items():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        so = todo[name]
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return paths


def _bind(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wfa_cuda_error_string.restype = ctypes.c_char_p
    lib.wfa_cuda_error_string.argtypes = [i]
    if name == "wfa_distance":
        lib.wfa_distance_launch.restype = i
        lib.wfa_distance_launch.argtypes = [
            p, p, i, p, p, p, p, i, i, i, i, i, p, p, p, i, i, i, i, p,
        ]
        lib.wfa_cigar_launch.restype = i
        lib.wfa_cigar_launch.argtypes = [
            p, p, i, p, p, p, p, i, i, i, i, i, p, p,
            p, i, p, i, p, i, i, i, i, p,
        ]
        lib.wfa_smem_optin.restype = i
        lib.wfa_smem_optin.argtypes = [i, ctypes.POINTER(i)]
    elif name == "ring_bw":
        lib.ring_bw_launch.restype = i
        lib.ring_bw_launch.argtypes = [p, i, i, i, i, p, i, p]
    elif name == "sol_calibrate":
        lib.vpu_ops_launch.restype = i
        lib.vpu_ops_launch.argtypes = [p, p, i, i, i, p]
        lib.gather_chain_launch.restype = i
        lib.gather_chain_launch.argtypes = [p, p, p, i, i, i, p]
        lib.scalar_sync_launch.restype = i
        lib.scalar_sync_launch.argtypes = [p, p, i, i, i, i, p]
        lib.sol_blocks_per_sm.restype = i
        lib.sol_blocks_per_sm.argtypes = [i, i, i, ctypes.POINTER(i)]
    elif name == "gather_probe":
        lib.k_wide_launch.restype = i
        lib.k_wide_launch.argtypes = [p, p, p, i, i, i, p]
    else:
        lib.wfa_traceback_launch.restype = i
        lib.wfa_traceback_launch.argtypes = [
            p, i, p, i, p, p, p, i, i, i, i, i, i, p, i, p,
        ]


def load_library(name: str = "wfa_distance") -> ctypes.CDLL:
    """The library ``name`` (every library built on the first call), with
    its C signatures."""
    with _lock:
        if name not in _libs:
            for lib_name, so in build_all().items():
                if lib_name not in _libs:
                    lib = ctypes.CDLL(str(so))
                    _bind(lib_name, lib)
                    _libs[lib_name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, rc: int) -> None:
    """Raise on a nonzero return code of one of the libraries' C calls."""
    if rc != 0:
        raise RuntimeError(
            f"CUDA error {rc}: {lib.wfa_cuda_error_string(rc).decode()}"
        )


def check_inputs(device, **tensors) -> None:
    """Each (tensor, dtype, shape) must lie on ``device``, contiguous."""
    for name, (t, dtype, shape) in tensors.items():
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def native_library_path() -> Path:
    return _NATIVE_DIR / "libwfatpu_native.so"


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
    """Whether the native host library is built, building it once per
    process: ``make -C native`` into ``build/torch_native/`` (a no-op when
    it is up to date), and if that fails (``-fopenmp`` needs an OpenMP
    runtime the host compiler may lack), the serial build in its place.
    A failed build is not retried in the same process."""
    global _native_ok
    with _lock:
        if _native_ok is None:
            proc = subprocess.run(
                ["make", "-C", str(_REPO / "native"), f"BUILD={_NATIVE_DIR}"],
                capture_output=True, text=True, timeout=300,
            )
            if proc.returncode != 0:
                build_native_serial(_NATIVE_DIR)
            _native_ok = native_library_path().exists()
        return _native_ok
