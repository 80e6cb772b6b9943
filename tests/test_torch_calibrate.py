"""The calibration and wide-gather kernels' plain versions against the TPU
kernels they replace, run in Pallas interpret mode on the CPU.

``benchmarks/sol_calibrate.py``'s three ``bench_*`` functions each build
their kernel inside ``make(iters)`` and hand it to ``_timed_pair``; a stub in
its place captures ``make``, and ``make(n)`` then runs on seeded inputs
under ``pltpu.force_tpu_interpret_mode()``.  ``tools/dev_gather_probe.py``'s
``k_wide`` goes through ``pl.pallas_call(..., interpret=True)``.  The port's
wrappers (``wfa_tpu_torch.ops.sol_calibrate``, ``.gather_probe``) run their
plain versions on CPU tensors.  Tolerance 0 throughout.
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from wfa_tpu_torch.ops import gather_probe, sol_calibrate

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
# The two settings benchmarks/sol_calibrate.py changes when imported.
_CONFIG = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
INT32 = (-(2**31), 2**31)


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    saved = {k: getattr(jax.config, k) for k in _CONFIG}
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def tpu_sol():
    return _load("benchmarks/sol_calibrate.py", "_tpu_sol_calibrate")


def _tpu_make(mod, bench: str, monkeypatch):
    """The ``make`` that ``mod.<bench>()`` hands to ``_timed_pair``."""
    got = {}

    def stub(make_fn, n1, n2, *args):
        got["make"] = make_fn
        return 1.0, 2.0

    monkeypatch.setattr(mod, "_timed_pair", stub)
    with pltpu.force_tpu_interpret_mode():
        getattr(mod, bench)()
    return got["make"]


def _tpu_run(make, n: int, *inputs: np.ndarray) -> np.ndarray:
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(make(n)(*(jnp.asarray(a) for a in inputs)))


def _tile(rng, lo, hi):
    return rng.integers(lo, hi, (8, 128), dtype=np.int32)


@pytest.mark.parametrize("n", [0, 1, 3])
def test_vpu_ops_equals_tpu_kernel(tpu_sol, monkeypatch, n):
    make = _tpu_make(tpu_sol, "bench_vpu_ops", monkeypatch)
    x = _tile(np.random.default_rng(n), *INT32)
    want = _tpu_run(make, n, x)
    got = sol_calibrate.vpu_ops(torch.from_numpy(x)[None], n)
    assert got.dtype == torch.int32 and got.shape == (1, 8, 128)
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 3])
def test_gather_chain_equals_tpu_kernel(tpu_sol, monkeypatch, n):
    make = _tpu_make(tpu_sol, "bench_gather", monkeypatch)
    rng = np.random.default_rng(10 + n)
    x, idx = _tile(rng, *INT32), _tile(rng, 0, 128)
    want = _tpu_run(make, n, x, idx)
    got = sol_calibrate.gather_chain(torch.from_numpy(x)[None],
                                     torch.from_numpy(idx)[None], n)
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("threads", sol_calibrate.THREADS)
@pytest.mark.parametrize("tile", ["mixed", "non-positive", "int-min"])
@pytest.mark.parametrize("n", [0, 1, 3])
def test_scalar_sync_equals_tpu_kernel(tpu_sol, monkeypatch, n, tile, threads):
    """Tiles whose max is positive, exactly 0 (the branch's edge: -1), and
    one holding INT32_MIN, whose -1 wraps to INT32_MAX and turns the
    branch."""
    make = _tpu_make(tpu_sol, "bench_scalar_sync", monkeypatch)
    rng = np.random.default_rng(20 + n)
    x = {"mixed": lambda: _tile(rng, *INT32),
         "non-positive": lambda: _tile(rng, -1000, 1),
         "int-min": lambda: np.full((8, 128), INT32[0], np.int32)}[tile]()
    if tile == "non-positive":
        x[3, 77] = 0
    want = _tpu_run(make, n, x)
    got = sol_calibrate.scalar_sync(torch.from_numpy(x)[None], n, threads)
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("shape", [(8, 2048), (16, 512)])
def test_k_wide_equals_tpu_kernel(shape):
    probe = _load("tools/dev_gather_probe.py", "_tpu_gather_probe")
    rng = np.random.default_rng(shape[1])
    tab = rng.integers(0, 1000, (shape[0], 128), dtype=np.int32)
    idx = rng.integers(0, 128, shape, dtype=np.int32)
    want = np.asarray(pl.pallas_call(
        probe.k_wide, out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
        interpret=True,
    )(jnp.asarray(tab), jnp.asarray(idx)))
    got = gather_probe.k_wide(torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.take_along_axis(tab, idx, axis=1))


def test_tiles_are_independent():
    """G > 1: each tile's result is the G = 1 result of that tile."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(np.stack([_tile(rng, *INT32), _tile(rng, -50, 1),
                                   _tile(rng, 0, 128)]))
    idx = torch.from_numpy(np.stack([_tile(rng, 0, 128) for _ in range(3)]))
    for fn in (lambda t, i: sol_calibrate.vpu_ops(t, 2),
               lambda t, i: sol_calibrate.gather_chain(t, i, 2),
               lambda t, i: sol_calibrate.scalar_sync(t, 5)):
        whole = fn(x, idx)
        for g in range(3):
            assert torch.equal(whole[g:g + 1], fn(x[g:g + 1], idx[g:g + 1]))


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros((2, 8, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        sol_calibrate.vpu_ops(x.to(torch.int64), 1)
    with pytest.raises(ValueError):
        sol_calibrate.vpu_ops(torch.zeros((8, 128), dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        sol_calibrate.vpu_ops(x, -1)
    with pytest.raises(ValueError):
        sol_calibrate.gather_chain(x, x[:1], 1)
    with pytest.raises(ValueError):
        sol_calibrate.scalar_sync(x, 1, threads=256)
    with pytest.raises(ValueError):
        gather_probe.k_wide(torch.zeros((4, 64), dtype=torch.int32),
                            torch.zeros((4, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        sol_calibrate.bench_vpu_ops(torch.device("cpu"))


# A loop as cuobjdump -sass prints one: a backward branch to an address.
_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_114vpu_ops_kernelEPKiPii
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe20000000800 */
        /*0010*/              @!P0 BRA 0x70 ;                      /* 0x0000000000c08947 */
        /*0020*/                   IMAD R7, R7, R4, 0x3039 ;       /* 0x0000303907077424 */
        /*0030*/                   LOP3.LUT R5, R6, 0xff, RZ, 0x3c, !PT ;
        /*0040*/                   UIADD3 UR4, UR4, 0x1, URZ ;
        /*0050*/                   ISETP.LE.AND P0, PT, R3, UR4, PT ;
        /*0060*/              @!P0 BRA 0x20 ;                      /* 0xfffffff800708947 */
        /*0070*/                   EXIT ;
        /*0080*/                   BRA 0x80;
\t\tFunction : _ZN12_GLOBAL__N_119gather_chain_kernelEPKiS1_Pii
        /*0000*/                   EXIT ;
        /*0010*/                   BRA 0x10;
"""


def test_sass_loop_body():
    body = sol_calibrate._loop_body(_SASS, "vpu_ops_kernel")
    assert [ins.split()[1 if ins.startswith("@") else 0] for ins in body] == [
        "IMAD", "LOP3.LUT", "UIADD3", "ISETP.LE.AND", "BRA"]
    with pytest.raises(RuntimeError, match="no loop"):
        sol_calibrate._loop_body(_SASS, "gather_chain_kernel")
    with pytest.raises(RuntimeError, match="not in"):
        sol_calibrate._loop_body(_SASS, "scalar_sync_kernel")
