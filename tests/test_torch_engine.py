"""The port's plain PyTorch engine (wfa_tpu_torch/ops/engine_torch.py) against
wfa_tpu's XLA engine and Pallas kernel on the same packed inputs.

Every comparison is of integers and exact (tolerance 0): against the XLA
engine, ``distance`` and ``finished`` are equal in every lane, unfinished and
invalid lanes included; against the Pallas kernel (interpret mode) on
``finished`` and ``distance[finished]``, as tests/test_pallas.py compares it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wfa_tpu.ops.engine_pallas import PallasConfig, align_batch_pallas
from wfa_tpu.ops.engine_xla import EngineConfig as XlaConfig
from wfa_tpu.ops.engine_xla import align_batch_device as xla_align
from wfa_tpu.ops.packing import pack_batch
from wfa_tpu.types import Penalties
from wfa_tpu_torch.ops import engine_cuda, engine_torch
from wfa_tpu_torch.utils.synth import EDGE_PAIRS, random_pairs

from test_engine import make_pairs


def _pack(pairs, nwords):
    pat, plen, vp = pack_batch([p for p, _ in pairs], nwords)
    txt, tlen, vt = pack_batch([t for _, t in pairs], nwords)
    return pat, plen, txt, tlen, vp & vt


def _run_both(pairs, xcfg, nwords=32):
    pat, plen, txt, tlen, valid = _pack(pairs, nwords)
    out_x = xla_align(
        xcfg, jnp.asarray(pat), jnp.asarray(txt),
        jnp.asarray(plen), jnp.asarray(tlen), jnp.asarray(valid),
    )
    out_t = engine_torch.align_batch_device(
        engine_torch.config_from_tpu(xcfg),
        *engine_torch.batch_to_tensors(pat, plen, txt, tlen, valid, "cpu"),
    )
    return (
        (np.asarray(out_x["distance"]), np.asarray(out_x["finished"])),
        (out_t["distance"].numpy(), out_t["finished"].numpy()),
    )


# The cases of tests/test_pallas.py:176-181, plus a working set over the
# Pallas kernel's 64-score limit and narrow windows that clamp and re-centre.
CASES = [
    (-1, Penalties(2, 3, 1), 128),
    (10, Penalties(2, 3, 1), 128),
    (-1, Penalties(1, 0, 1), 128),
    (10, Penalties(4, 1, 2), 128),
    (-1, Penalties(70, 6, 2), 128),
    (25, Penalties(70, 6, 2), 64),
    (10, Penalties(2, 3, 1), 48),
    (-1, Penalties(2, 3, 1), 33),
]


@pytest.mark.parametrize(
    "band,pen,width", CASES,
    ids=["exact", "banded", "exact-o0", "banded-x4o1e2", "exact-x70",
         "banded-x70-w64", "banded-w48", "exact-w33"],
)
def test_twin_matches_xla(band, pen, width):
    rng = np.random.default_rng(width + pen.x)
    pairs = (
        make_pairs(17, sizes=(10, 60, 120), errs=(0.0, 0.1))
        + EDGE_PAIRS
        + random_pairs(rng, 12, 10, 300)
    )
    cfg = XlaConfig(
        penalties=pen, max_steps=100, wf_width=width,
        compute_cigar=False, band=band,
    )
    (dx, fx), (dt, ft) = _run_both(pairs, cfg)
    np.testing.assert_array_equal(ft, fx)
    np.testing.assert_array_equal(dt, dx)
    assert fx.any() and not fx.all()  # finished, unfinished and invalid lanes


def test_twin_matches_xla_truncated_score_limit():
    """An exact window too narrow for the pairs plus a schedule cut at
    ``score_limit``: most lanes time out and report the unfinished score."""
    rng = np.random.default_rng(7)
    pairs = random_pairs(rng, 24, 40, 200, n_rate=0.0, empty_rate=0.0)
    cfg = XlaConfig(
        penalties=Penalties(2, 3, 1), max_steps=200, wf_width=64,
        compute_cigar=False, score_limit=33,
    )
    (dx, fx), (dt, ft) = _run_both(pairs, cfg)
    np.testing.assert_array_equal(ft, fx)
    np.testing.assert_array_equal(dt, dx)
    assert (~fx).sum() >= 4


@pytest.mark.parametrize("band", [-1, 10], ids=["exact", "banded"])
def test_twin_matches_pallas_interpret(band):
    rng = np.random.default_rng(3)
    pairs = (EDGE_PAIRS + random_pairs(rng, 16, 10, 48, 0.1))[:16]
    pat, plen, txt, tlen, valid = _pack(pairs, 128)
    pcfg = PallasConfig(
        penalties=Penalties(2, 3, 1), max_steps=40, wf_width=128,
        tile_batch=8, band=band,
    )
    with pltpu.force_tpu_interpret_mode():
        out_p = align_batch_pallas(
            pcfg, jnp.asarray(pat), jnp.asarray(txt),
            jnp.asarray(plen), jnp.asarray(tlen), jnp.asarray(valid),
        )
        dp = np.asarray(out_p["distance"])
        fp = np.asarray(out_p["finished"])
    out_t = engine_torch.align_batch_device(
        engine_torch.config_from_tpu(pcfg),
        *engine_torch.batch_to_tensors(pat, plen, txt, tlen, valid, "cpu"),
    )
    ft = out_t["finished"].numpy()
    np.testing.assert_array_equal(ft, fp)
    np.testing.assert_array_equal(out_t["distance"].numpy()[ft], dp[fp])
    assert fp.sum() >= 10


def test_clz_matches_numpy_on_power_of_two_boundaries():
    vals = {0, 2**32 - 1}
    for i in range(33):
        vals |= {2**i - 1, 2**i, 2**i + 1}
    vals = sorted(v for v in vals if 0 <= v < 2**32)
    got = engine_torch._clz32(torch.tensor(vals, dtype=torch.int64))
    want = [32 - int(v).bit_length() for v in vals]
    assert got.tolist() == want
    # The LCP step: eq = clz >> 1, with clz(0) == 32 -> 16 matched bases.
    assert (got >> 1).tolist() == [w >> 1 for w in want]


def test_argmin_ties_resolve_to_first_index():
    """The band re-centre relies on torch.argmin returning the first index
    of the minimum (engine_xla.py:327-330: the sentinel wins ties)."""
    cand = torch.tensor([[5, 3, 3, 7], [2, 2, 2, 2], [9, 8, 1, 1]])
    assert torch.argmin(cand, dim=1).tolist() == [1, 0, 2]


def test_config_from_tpu():
    pen = Penalties(2, 3, 1)
    c = engine_torch.config_from_tpu(XlaConfig(
        penalties=pen, max_steps=90, wf_width=200, compute_cigar=False,
        band=25, score_limit=57,
    ))
    assert c == engine_torch.EngineConfig(pen, 90, 200, 25, 57)
    p = engine_torch.config_from_tpu(PallasConfig(
        penalties=pen, max_steps=90, wf_width=256, score_cap=58,
    ))
    assert (p.wf_width, p.band, p.score_limit) == (256, -1, 57)
    assert engine_torch.config_from_tpu(PallasConfig(
        penalties=pen, max_steps=90, wf_width=256,
    )).score_limit is None
    with pytest.raises(NotImplementedError):
        engine_torch.config_from_tpu(XlaConfig(
            penalties=pen, max_steps=90, wf_width=200, compute_cigar=True,
        ))


def test_batch_to_tensors_keeps_word_bits():
    words = np.array([[0, 1, 0x80000000, 0xFFFFFFFF]], dtype=np.uint32)
    pat, txt, plen, tlen, valid = engine_torch.batch_to_tensors(
        words, np.array([7]), words, np.array([9]), np.array([True]), "cpu"
    )
    assert pat.dtype == torch.int32 and valid.dtype == torch.bool
    assert (pat.numpy().view(np.uint32) == words).all()
    assert plen.tolist() == [7] and tlen.tolist() == [9]


def test_cuda_wrapper_on_cpu_tensors_runs_the_plain_version():
    pairs = EDGE_PAIRS + make_pairs(5, sizes=(20, 70), errs=(0.0, 0.1))
    pat, plen, txt, tlen, valid = _pack(pairs, 8)
    args = engine_torch.batch_to_tensors(pat, plen, txt, tlen, valid, "cpu")
    cfg = engine_torch.EngineConfig(Penalties(2, 3, 1), 80, 64, 10)
    before = engine_cuda.LAUNCHES
    got = engine_cuda.align_batch_cuda(cfg, *args)
    want = engine_torch.align_batch_device(cfg, *args)
    assert engine_cuda.LAUNCHES == before
    assert torch.equal(got["distance"], want["distance"])
    assert torch.equal(got["finished"], want["finished"])
    # Any other device is refused, never computed on the CPU.
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError):
        engine_cuda.align_batch_cuda(cfg, *meta)
