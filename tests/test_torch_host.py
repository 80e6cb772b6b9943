"""Each host module the port copied from wfa_tpu equals its original on the
same inputs: the schedule, packing, tier planning, the readers and writer,
the native bindings (CPU fallback with and without CIGAR, the CIGAR
decoders), the Python decoders, verification, options and penalties
parsing.  Every comparison is exact (arrays equal, strings equal)."""
import dataclasses
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import wfa_tpu.aligner as tpu_aligner
import wfa_tpu.cli as tpu_cli
import wfa_tpu.native as tpu_native
import wfa_tpu.params as tpu_params
import wfa_tpu.traceback as tpu_traceback
import wfa_tpu.utils.cpu_wfa as tpu_cpu_wfa
import wfa_tpu.utils.io as tpu_io
import wfa_tpu.utils.presort as tpu_presort
import wfa_tpu.utils.verification as tpu_verification
from wfa_tpu.ops import packing as tpu_packing
from wfa_tpu.schedule import build_schedule as tpu_build_schedule
from wfa_tpu.types import Penalties as TpuPenalties

import wfa_tpu_torch.aligner as aligner
import wfa_tpu_torch.cli as cli
import wfa_tpu_torch.native as native
import wfa_tpu_torch.params as params
import wfa_tpu_torch.traceback as traceback
import wfa_tpu_torch.utils.cpu_wfa as cpu_wfa
import wfa_tpu_torch.utils.io as io_
import wfa_tpu_torch.utils.presort as presort
import wfa_tpu_torch.utils.verification as verification
from wfa_tpu_torch.ops import packing
from wfa_tpu_torch.schedule import build_schedule
from wfa_tpu_torch.types import (
    MAX_SEQ_LEN, OFFSET_NULL, OPS_ASCII, AffineOp, GapOp, KernelResult, Penalties,
)
from wfa_tpu_torch.utils.synth import EDGE_PAIRS, random_pairs

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

DATA = Path(__file__).parent / "data"
PENALTIES = [(2, 3, 1), (1, 0, 1), (4, 1, 2), (70, 6, 2)]


def _pairs(seed=5, n=40, lo=0, hi=300):
    return EDGE_PAIRS + random_pairs(np.random.default_rng(seed), n, lo, hi)


def test_types_match():
    import wfa_tpu.types as t

    assert (MAX_SEQ_LEN, OFFSET_NULL) == (t.MAX_SEQ_LEN, t.OFFSET_NULL)
    assert {m.name: int(m) for m in AffineOp} == {m.name: int(m) for m in t.AffineOp}
    assert {m.name: int(m) for m in GapOp} == {m.name: int(m) for m in t.GapOp}
    assert OPS_ASCII == t.OPS_ASCII
    assert [(f.name, f.type) for f in dataclasses.fields(KernelResult)] == [
        (f.name, f.type) for f in dataclasses.fields(t.KernelResult)]
    assert dataclasses.asdict(KernelResult(7, True)) == dataclasses.asdict(
        t.KernelResult(7, True))
    for pen in PENALTIES + [(-2, -3, -1)]:
        a, b = Penalties(*pen), TpuPenalties(*pen)
        assert (a.x, a.o, a.e, a.active_working_set) == (
            b.x, b.o, b.e, b.active_working_set)


@pytest.mark.parametrize("pen", PENALTIES)
@pytest.mark.parametrize("max_steps,score_limit", [(80, None), (300, 57), (3000, None)])
def test_schedule_matches(pen, max_steps, score_limit):
    a = build_schedule(Penalties(*pen), max_steps, score_limit)
    b = tpu_build_schedule(TpuPenalties(*pen), max_steps, score_limit)
    for f in dataclasses.fields(b):
        if f.name == "penalties":
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
            assert va.dtype == vb.dtype
        else:
            assert va == vb, f.name
    assert a.ring_size == b.ring_size


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("nwords", [1, 8, 33])
def test_pack_batch_matches(monkeypatch, path, nwords):
    seqs = [p for p, _ in _pairs()] + [b"ACGT" * 200, b"acgtn", b"A" * 16]
    if path == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(tpu_packing, "_native_pack_ok", False)
    got = packing.pack_batch(seqs, nwords)
    want = tpu_packing.pack_batch(seqs, nwords)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    np.testing.assert_array_equal(packing._ACGT, tpu_packing._ACGT)


@pytest.mark.parametrize(
    "band,cigar,max_error,hint",
    [(-1, False, 100, False), (-1, True, 3000, False), (25, False, 300, True),
     (0, True, 50, True)],
)
def test_plan_tiers_matches(band, cigar, max_error, hint):
    rng = np.random.default_rng(max_error)
    lens = rng.integers(0, 20000, 60)
    hints = rng.random(60) if hint else None
    kw = dict(max_error=max_error, band=band, compute_cigar=cigar)
    got = aligner._plan_tiers(
        lens, params.AlignmentOptions(**kw), max_error, hints)
    want = tpu_aligner._plan_tiers(
        lens, tpu_params.AlignmentOptions(**kw), max_error, hints)
    assert [dataclasses.asdict(p) for p in got] == [
        dataclasses.asdict(p) for p in want]
    for L in (0, 62, 63, 1000, 32766):
        assert aligner._tier_of(L) == tpu_aligner._tier_of(L)


def test_params_match():
    for me in (1, 63, 64, 200, 511, 512, 3000):
        assert params.default_band_width(me) == tpu_params.default_band_width(me)
        assert params.default_max_error(me, 7, Penalties(4, 1, 2)) == (
            tpu_params.default_max_error(me, 7, TpuPenalties(4, 1, 2)))
    assert params.AUTO_BAND_INTERVAL == tpu_params.AUTO_BAND_INTERVAL
    a, b = params.AlignmentOptions(), tpu_params.AlignmentOptions()
    for f in dataclasses.fields(a):
        if f.name not in ("penalties", "backend"):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
    for band in (-1, 0, 10):
        a = params.AlignmentOptions(band=band)
        b = tpu_params.AlignmentOptions(band=band)
        assert (a.resolved_band(), a.banded) == (b.resolved_band(), b.banded)


@pytest.mark.parametrize("n", [None, 7])
def test_readers_and_writer_match(n, tmp_path):
    seq = DATA / "wfa.utest.seq"
    a, b = io_.read_seq_file(seq, n), tpu_io.read_seq_file(seq, n)
    assert (a.patterns, a.texts) == (b.patterns, b.texts)
    q, t = DATA / "test_hifi.query.fasta", DATA / "test_hifi.target.fasta"
    a, b = io_.read_fasta_pair(q, t, n), tpu_io.read_fasta_pair(q, t, n)
    assert (a.patterns, a.texts) == (b.patterns, b.texts)
    assert native.read_seq_native(str(seq)) == tpu_native.read_seq_native(str(seq))
    assert native.read_fasta_native(str(q), str(t)) == (
        tpu_native.read_fasta_native(str(q), str(t)))
    results = [aligner.AlignmentResult(error=i, cigar=f"{i}M") for i in range(len(a))]
    out_a, out_b = io.StringIO(), io.StringIO()
    io_.write_alignments(out_a, results, a, verbose=True)
    tpu_io.write_alignments(out_b, results, b, verbose=True)
    assert out_a.getvalue() == out_b.getvalue()


@pytest.mark.parametrize("cigar", [False, True])
@pytest.mark.parametrize("adaptive", [False, True])
def test_native_cpu_align_batch_matches(cigar, adaptive):
    pairs = _pairs(11, 30, 0, 400)
    pats, txts = [p for p, _ in pairs], [t for _, t in pairs]
    mask = np.ones(len(pairs), dtype=np.int8)
    mask[3] = 0
    pen = (2, 3, 1)
    got = native.cpu_align_batch(pats, txts, Penalties(*pen), mask, cigar,
                                 adaptive=adaptive)
    want = tpu_native.cpu_align_batch(pats, txts, TpuPenalties(*pen), mask,
                                      cigar, adaptive=adaptive)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert native.cpu_align_single(pats[5], txts[5], Penalties(*pen)) == (
        tpu_native.cpu_align_single(pats[5], txts[5], TpuPenalties(*pen)))


@pytest.mark.parametrize("pen", [(2, 3, 1), (5, 3, 2)])
def test_python_fallback_and_verification_match(pen):
    pairs = [(p, t) for p, t in _pairs(3, 12, 0, 120) if b"N" not in p + t]
    for p, t in pairs:
        got = cpu_wfa.align_one_py(p, t, Penalties(*pen), True)
        want = tpu_cpu_wfa.align_one_py(p, t, TpuPenalties(*pen), True)
        assert got == want
        assert verification.check_cigar(got[1], p, t) == (
            tpu_verification.check_cigar(want[1], p, t))
        assert verification.affine_score(got[1], Penalties(*pen)) == (
            tpu_verification.affine_score(want[1], TpuPenalties(*pen))) == got[0]
    with pytest.raises(ValueError):
        verification.parse_cigar("3M2")


@pytest.mark.parametrize("band", [-1, 10])
def test_cigar_decoders_match(band):
    """The op-stream and packed-table decoders, native and Python, give the
    same CIGARs on a real table and real walks (the plain K2 + K3)."""
    import torch

    from wfa_tpu_torch.ops import engine_torch, traceback_torch

    pairs = _pairs(4, 16, 20, 200)
    pats, txts = [p for p, _ in pairs], [t for _, t in pairs]
    pen, tpen = Penalties(2, 3, 1), TpuPenalties(2, 3, 1)
    args = engine_torch.batch_to_tensors(
        *packing.pack_batch(pats, 16)[:2], *packing.pack_batch(txts, 16)[:2],
        packing.pack_batch(pats, 16)[2] & packing.pack_batch(txts, 16)[2], "cpu",
    )
    score_cap = build_schedule(pen, 80, None).unfinished_score + 1
    cfg = engine_torch.EngineConfig(pen, 80, 64, band, score_cap - 1)
    tb = traceback_torch.TracebackConfig(
        pen, 64, score_cap, band > 0,
        engine_torch.lo_pad(score_cap) if band > 0 else 0,
    )
    tables = engine_torch.cigar_tables(cfg, score_cap, *args)
    fused = traceback_torch.align_cigar_fused(cfg, tb, *args).numpy()
    dist, fin, n_ops = fused[:, 0], fused[:, 1] != 0, fused[:, 2]
    ops = np.ascontiguousarray(fused[:, 4:])
    assert (n_ops > 0).sum() >= 10
    got = native.cigar_from_ops_batch(ops, n_ops, fin, pats, txts)
    assert got[0] == tpu_native.cigar_from_ops_batch(ops, n_ops, fin, pats, txts)[0]
    words = tables["choice_words"].numpy()
    lo = tables["lo_trace"].numpy() if band > 0 else None
    packed = native.traceback_batch_packed(words, lo, -32, dist, fin, pats, txts, pen)
    assert packed[0] == tpu_native.traceback_batch_packed(
        words, lo, -32, dist, fin, pats, txts, tpen)[0]
    assert packed[0] == got[0]
    # Each Python decoder equals its original.  It need not equal the
    # native one: at distance 0 it writes f"{len(text)}M" ("0M" for an
    # empty pair, native ""), and ops_to_cigar can split a run ("1I1I38I",
    # native "40I"); ROADMAP queue 3 records both.
    for b in np.flatnonzero(fin & (n_ops >= 0)):
        args_b = (ops[b], int(n_ops[b]), pats[b], txts[b])
        py = traceback.recover_cigar_from_stream(*args_b)
        assert py == tpu_traceback.recover_cigar_from_stream(*args_b)
        assert verification.check_cigar(py, pats[b], txts[b])
        assert traceback.ops_from_stream(ops[b], int(n_ops[b])) == (
            tpu_traceback.ops_from_stream(ops[b], int(n_ops[b])))
        lo_b = lo[b] if lo is not None else None
        packed_args = (words[:, b], lo_b, -32, int(dist[b]), pats[b], txts[b])
        assert traceback.recover_cigar_packed(
            packed_args[0], lo_b, -32, pen, *packed_args[3:]) == (
            tpu_traceback.recover_cigar_packed(
                packed_args[0], lo_b, -32, tpen, *packed_args[3:]))


@pytest.mark.parametrize("pen", [(2, 3, 1), (1, 0, 1), (4, 1, 2)])
def test_gotoh_distance_matches(pen):
    pairs = EDGE_PAIRS + random_pairs(np.random.default_rng(sum(pen)), 12, 0, 200)
    for p, t in pairs:
        assert verification.gotoh_distance(p, t, Penalties(*pen)) == \
            tpu_verification.gotoh_distance(p, t, TpuPenalties(*pen))


def test_presort_and_penalty_parsing_match():
    pairs = [(p, t) for p, t in _pairs(8, 10, 100, 9000)]
    pats, txts = [p for p, _ in pairs], [t for _, t in pairs]
    lens = np.array([max(len(p), len(t)) for p, t in pairs])
    np.testing.assert_array_equal(
        presort.divergence_scores(pats, txts, lens),
        tpu_presort.divergence_scores(pats, txts, lens))
    assert presort.MIN_PRESORT_TIER == tpu_presort.MIN_PRESORT_TIER
    for arg in (None, "1,2,1", "-5,3,2", "70,6,2"):
        a, b = cli._parse_penalties(arg), tpu_cli._parse_penalties(arg)
        assert (a.x, a.o, a.e) == (b.x, b.o, b.e)
    for bad in ("1,2", "a,b,c", "1,2,3,4"):
        with pytest.raises(ValueError):
            cli._parse_penalties(bad)
