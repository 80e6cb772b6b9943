"""The port's CIGAR path against wfa_tpu's on the CPU.

1. The plain engine's CIGAR-mode ``choices``/``lo_trace`` equal the XLA
   engine's in every lane.
2. The plain K2 (plain engine + relayout) equals the Pallas kernel's
   ``choice_words``/``lo_trace`` in interpret mode, on the region a backward
   walk can read: finished lanes, scheduled scores 1..distance, the
   diagonals of each score's window.  The rest is masked: the Pallas tile
   runs on past a lane's distance and records choices outside the band
   window, the port's kernel does neither.
3. The plain K3 fed the Pallas kernel's own table equals the Pallas walk
   (``traceback_batch_device``), and the plain K2 + K3 equals
   ``align_cigar_fused``.
4. ``align_pairs(compute_cigar=True, backend='torch')`` equals
   ``wfa_tpu.align_pairs(..., backend='xla')`` on error and CIGAR.

Every comparison is of integers or strings, exact (tolerance 0).  These
compile CIGAR-mode reference programs, so they have a file of their own.
"""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import wfa_tpu
import wfa_tpu_torch
from wfa_tpu.ops.engine_pallas import PallasConfig, align_batch_pallas
from wfa_tpu.ops.engine_xla import EngineConfig as XlaConfig
from wfa_tpu.ops.engine_xla import align_batch_device as xla_align
from wfa_tpu.ops.packing import pack_batch
from wfa_tpu.ops.traceback_pallas import (
    TracebackConfig as PallasTbConfig, traceback_batch_device,
)
from wfa_tpu.schedule import build_schedule
from wfa_tpu.types import Penalties
from wfa_tpu.utils.io import read_seq_file
from wfa_tpu_torch.ops import engine_torch, traceback_torch
from wfa_tpu_torch.utils.synth import EDGE_PAIRS, random_pairs
from wfa_tpu_torch.utils.verification import affine_score, check_cigar

from test_engine import make_pairs

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

DATA = Path(__file__).parent / "data"


def _packed(pairs, nwords):
    pat, plen, vp = pack_batch([p for p, _ in pairs], nwords)
    txt, tlen, vt = pack_batch([t for _, t in pairs], nwords)
    return pat, plen, txt, tlen, vp & vt


def _jax_args(packed):
    pat, plen, txt, tlen, valid = packed
    return (jnp.asarray(pat), jnp.asarray(txt), jnp.asarray(plen),
            jnp.asarray(tlen), jnp.asarray(valid))


def _torch_args(packed):
    pat, plen, txt, tlen, valid = packed
    return engine_torch.batch_to_tensors(pat, plen, txt, tlen, valid, "cpu")


@pytest.mark.parametrize(
    "band,pen,width",
    [(-1, Penalties(2, 3, 1), 64), (10, Penalties(2, 3, 1), 48),
     (10, Penalties(4, 1, 2), 64), (25, Penalties(70, 6, 2), 64)],
    ids=["exact", "banded-w48", "banded-x4o1e2", "banded-x70"],
)
def test_twin_cigar_tables_match_xla(band, pen, width):
    rng = np.random.default_rng(width + pen.x)
    pairs = (make_pairs(29, sizes=(10, 60, 110), errs=(0.0, 0.1))
             + EDGE_PAIRS + random_pairs(rng, 8, 40, 250, 0.3))
    packed = _packed(pairs, 17)
    xcfg = XlaConfig(penalties=pen, max_steps=60, wf_width=width,
                     compute_cigar=True, band=band)
    out_x = xla_align(xcfg, *_jax_args(packed))
    out_t = engine_torch.align_batch_device(
        engine_torch.config_from_tpu(xcfg), *_torch_args(packed)
    )
    np.testing.assert_array_equal(out_t["finished"].numpy(), np.asarray(out_x["finished"]))
    np.testing.assert_array_equal(out_t["distance"].numpy(), np.asarray(out_x["distance"]))
    np.testing.assert_array_equal(out_t["choices"].numpy(), np.asarray(out_x["choices"]))
    np.testing.assert_array_equal(out_t["lo_trace"].numpy(), np.asarray(out_x["lo_trace"]))
    fin = np.asarray(out_x["finished"])
    assert fin.any() and not fin.all()


def _pallas_case(band):
    pen = Penalties(2, 3, 1)
    # One tile of 8 lanes that all finish early: interpret mode runs the
    # tile until its slowest lane is done, at ~0.2 s a score.
    rng = np.random.default_rng(41 + band)
    pairs = (random_pairs(rng, 5, 20, 110, 0.15, n_rate=0.0, empty_rate=0.0)
             + [EDGE_PAIRS[10], EDGE_PAIRS[0], EDGE_PAIRS[6]])
    packed = _packed(pairs, 128)
    sched = build_schedule(pen, 100, None)
    pcfg = PallasConfig(
        penalties=pen, max_steps=100, wf_width=128, tile_batch=8, band=band,
        compute_cigar=True, score_cap=sched.unfinished_score + 1,
        two_score_body=0,
    )
    tb = PallasTbConfig(
        penalties=pen, wf_width=128, score_cap=pcfg.score_cap,
        banded=band > 0, lo_pad=pcfg.lo_pad if band > 0 else 0,
    )
    return pairs, packed, pcfg, tb


def _port_tb_config(tb):
    return traceback_torch.TracebackConfig(
        penalties=wfa_tpu_torch.Penalties(tb.penalties.x, tb.penalties.o, tb.penalties.e),
        wf_width=tb.wf_width, score_cap=tb.score_cap, banded=tb.banded,
        lo_pad=tb.lo_pad,
    )


@pytest.mark.parametrize("band", [-1, 10], ids=["exact", "banded"])
def test_plain_k2_k3_match_pallas_interpret(band):
    pairs, packed, pcfg, tb = _pallas_case(band)
    jargs = _jax_args(packed)
    with pltpu.force_tpu_interpret_mode():
        out_p = align_batch_pallas(pcfg, *jargs)
        words_p = np.array(out_p["choice_words"])
        lo_p = np.array(out_p["lo_trace"]) if band > 0 else None
        dist_p = np.array(out_p["distance"])
        fin_p = np.array(out_p["finished"])
        tk = jargs[3] - jargs[2]
        tb_p = traceback_batch_device(
            tb, out_p["choice_words"], out_p.get("lo_trace"),
            out_p["distance"], out_p["finished"], tk,
        )
        ops_p, nops_p = np.asarray(tb_p["ops"]), np.asarray(tb_p["n_ops"])
    # align_cigar_fused is these two calls and this concatenation
    # (traceback_pallas.py:346-375); composing it here saves a second ~20 s
    # interpret-mode compile of the alignment kernel.
    fused_p = np.concatenate([
        np.stack([dist_p, fin_p.astype(np.int32), nops_p,
                  np.zeros_like(nops_p)], axis=1), ops_p,
    ], axis=1)

    # 2. The plain K2 on the readable region.
    cfg = engine_torch.config_from_tpu(pcfg)
    targs = _torch_args(packed)
    plain = engine_torch.cigar_tables(cfg, pcfg.score_cap, *targs)
    np.testing.assert_array_equal(plain["finished"].numpy(), fin_p)
    np.testing.assert_array_equal(plain["distance"].numpy()[fin_p], dist_p[fin_p])
    other = {"choice_words": torch.from_numpy(words_p)}
    if band > 0:
        other["lo_trace"] = torch.from_numpy(lo_p)
    assert engine_torch.tables_equal(cfg, pcfg.score_cap, plain, other)
    assert (plain["finished"] & (plain["distance"] > 0)).sum() >= 4

    # 3. The plain K3 on Pallas's own table, then the plain K2 + K3.
    ptb = _port_tb_config(tb)
    got = traceback_torch.traceback_batch_device(
        ptb, torch.from_numpy(words_p),
        torch.from_numpy(lo_p) if band > 0 else None,
        torch.from_numpy(dist_p), torch.from_numpy(fin_p),
        targs[3] - targs[2],
    )
    np.testing.assert_array_equal(got["n_ops"].numpy(), nops_p)
    np.testing.assert_array_equal(got["ops"].numpy(), ops_p)
    fused = traceback_torch.align_cigar_fused(cfg, ptb, *targs)
    assert fused.shape == fused_p.shape
    np.testing.assert_array_equal(fused.numpy(), fused_p)
    assert (nops_p[fin_p & (dist_p > 0)] > 0).all()


def test_plain_k3_reports_corrupt_and_missing_walks():
    """The Pallas walk's error rules: a diagonal outside the window gives
    n_ops = -1, an unfinished lane or distance 0 gives no walk."""
    pen = wfa_tpu_torch.Penalties(2, 3, 1)
    tb = traceback_torch.TracebackConfig(pen, 32, 40, banded=False)
    words = torch.zeros((tb.num_chunks, 4, 32), dtype=torch.int32)
    dist = torch.tensor([6, 6, 0, 6], dtype=torch.int32)
    fin = torch.tensor([True, True, True, False])
    tk = torch.tensor([0, 40, 0, 0], dtype=torch.int32)  # lane 1 off the window
    out = traceback_torch.traceback_batch_device(tb, words, None, dist, fin, tk)
    # Lane 0: all-zero choices are mismatches (M from X): 3 SUBs, 6 -> 0.
    assert out["n_ops"].tolist() == [3, -1, 0, 0]
    assert out["ops"][0, 0].item() == 2 | 2 << 2 | 2 << 4


def _cigar_opts(pen, max_error, band=-1, retries=1):
    return wfa_tpu_torch.AlignmentOptions(
        penalties=wfa_tpu_torch.Penalties(*pen), max_error=max_error,
        compute_cigar=True, band=band, device_retries=retries, backend="torch",
    )


@pytest.mark.parametrize(
    "pen,max_error,band,retries,n",
    [((1, 2, 1), 100, -1, 1, 40), ((5, 3, 2), 12, -1, 0, 40),
     ((2, 3, 1), 60, 10, 1, 24)],
    ids=["exact-p0", "cpu-fallback-p2", "banded"],
)
def test_align_pairs_cigar_matches_xla(pen, max_error, band, retries, n):
    batch = read_seq_file(DATA / "wfa.utest.seq", n)
    pats = batch.patterns + [b"ACGTNACGT", b"GATTACAGATTACA"]
    txts = batch.texts + [b"ACGTAACGT", b"GATTACCGATTAC"]
    opts = _cigar_opts(pen, max_error, band, retries)
    got = wfa_tpu_torch.align_pairs(pats, txts, opts)
    ref = wfa_tpu.align_pairs(pats, txts, wfa_tpu.AlignmentOptions(
        penalties=wfa_tpu.Penalties(*pen), max_error=max_error,
        compute_cigar=True, band=band, device_retries=retries,
        backend="xla", data_parallel=False,
    ))
    assert [r.error for r in got] == [r.error for r in ref]
    assert [r.cigar for r in got] == [r.cigar for r in ref]
    assert [r.finished_on_accelerator for r in got] == [
        r.finished_on_accelerator for r in ref]
    p = wfa_tpu_torch.Penalties(*pen)
    for r, a, b in zip(got, pats, txts):
        assert check_cigar(r.cigar, a, b) and affine_score(r.cigar, p) == r.error
    on_card = sum(r.finished_on_accelerator for r in got)
    assert 0 < on_card
    if max_error == 12:
        assert on_card < len(got)  # the CPU fallback ran


def test_pipeline_cigar_equals_one_call():
    batch = read_seq_file(DATA / "wfa.utest.seq", 21)
    opts = _cigar_opts((1, 2, 1), 50)
    whole = wfa_tpu_torch.align_pairs(batch.patterns, batch.texts, opts)
    piped = wfa_tpu_torch.align_pairs_pipelined(
        batch.patterns, batch.texts, dataclasses.replace(opts, batch_size=8)
    )
    assert [(r.error, r.cigar) for r in piped] == [(r.error, r.cigar) for r in whole]
