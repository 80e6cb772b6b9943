"""Build and load the port's CUDA kernels and its native host library.

Each CUDA source under ``ops/csrc/`` (``SOURCES``) is compiled at its
first use, by ``load_library``, with one ``nvcc`` into a shared library of
its own with a plain C interface, loaded with ``ctypes``: a library that is
never asked for is never built, and a source that does not compile breaks
only its own.  The libraries land in ``build/cuda/`` at the repository
root, each named by a hash of its source and the flags, so an edited source
rebuilds and an unchanged one is reused.  The compiler's output (``-Xptxas
-v``: registers, shared memory, spills) is kept beside each as a ``.log``
file.

``build_native`` builds the port's one native host library with one ``g++``
command over ``NATIVE_SOURCES``: the repository's ``native/*.cpp``
(packing, readers, the CPU fallback, CIGAR decoding) and the port's own
host sources, ``csrc/presort_scan.cpp`` (the presort's scan),
``csrc/pack_slot.cpp`` (the chunk loop's slot packer) and
``csrc/cigar_ops.cpp`` (the chunk loop's CIGAR decode).  It lands in
``build/torch_native/``, named by its form and a hash of the flags and of
every source, with the compiler's output beside it.  ``native.get_lib``
loads it once per process: the OpenMP form, else the serial one.
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

# The native host library's sources: native/Makefile's SRCS, then the
# port's own.  Each keeps its helpers in an anonymous namespace and exports
# only ``extern "C"`` entries, so they link as one library.
NATIVE_SOURCES = tuple(
    _REPO / "native" / s
    for s in ("wfa_cpu.cpp", "traceback.cpp", "reader.cpp", "packing.cpp")
) + tuple(_CSRC / s
          for s in ("presort_scan.cpp", "pack_slot.cpp", "cigar_ops.cpp"))
# The host compiler's flags (native/Makefile's, bar -fopenmp).
HOST_CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared",
                 "-Wall", "-Wextra")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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


def build_library(name: str) -> Path:
    """Compile the library ``name`` unless built already; raises with the
    compiler's output where ``nvcc`` fails."""
    so = library_path(name)
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
         str(_CSRC / SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    so.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed: {SOURCES[name]} ({proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, so)
    return so


def _bind(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wfa_cuda_error_string.restype = ctypes.c_char_p
    lib.wfa_cuda_error_string.argtypes = [i]
    if name == "wfa_distance":
        lib.wfa_distance_launch.restype = i
        lib.wfa_distance_launch.argtypes = [
            p, p, i, p, p, p, p, i, i, i, i, i, p, p, p, i, i, i, i, i, i, i,
            i, p,
        ]
        lib.wfa_cigar_launch.restype = i
        lib.wfa_cigar_launch.argtypes = [
            p, p, i, p, p, p, p, i, i, i, i, i, p, p,
            p, i, p, i, p, i, i, i, i, i, i, i, i, p,
        ]
        lib.wfa_smem_optin.restype = i
        lib.wfa_smem_optin.argtypes = [i, ctypes.POINTER(i)]
        lib.wfa_blocks_per_sm.restype = i
        lib.wfa_blocks_per_sm.argtypes = [i, i, i, i, i, i, i, i, i, i, i,
                                          ctypes.POINTER(i)]
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
            p, i, p, i, p, p, p, i, i, i, i, i, i, p, p, i, i, p,
        ]


def load_library(name: str = "wfa_distance") -> ctypes.CDLL:
    """The library ``name``, built on its first use, with its C
    signatures."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build_library(name)))
            _bind(name, lib)
            _libs[name] = lib
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


def _host_flags(openmp: bool) -> tuple[str, ...]:
    return HOST_CXXFLAGS + (("-fopenmp",) if openmp else
                            ("-Wno-unknown-pragmas", "-I", str(_CSRC / "serial_omp")))


def native_path(openmp: bool, sources=NATIVE_SOURCES) -> Path:
    """Where the native host library of ``sources`` in the form ``openmp``
    lives: named by a hash of the flags and of every source's bytes."""
    h = hashlib.sha256(" ".join(_host_flags(openmp)).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    kind = "omp" if openmp else "serial"
    return _NATIVE_DIR / f"libwfa_native_{kind}_{h.hexdigest()[:16]}.so"


def build_native(openmp: bool) -> Path | None:
    """Compile ``NATIVE_SOURCES`` into one library with one ``g++`` unless
    built already: with ``-fopenmp``, or serially against
    ``csrc/serial_omp/omp.h``, where each ``#pragma omp`` loop runs on one
    thread.  None where the compiler fails (its output is kept beside the
    library as ``.log``)."""
    so = native_path(openmp)
    if so.exists():
        return so
    _NATIVE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *_host_flags(openmp), "-o", str(tmp),
             *map(str, NATIVE_SOURCES)],
            capture_output=True, text=True, timeout=300,
        )
    except OSError as exc:                  # no g++ at all
        so.with_suffix(".log").write_text(str(exc))
        return None
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so
