"""The port's aligner (wfa_tpu_torch/aligner.py) against wfa_tpu's XLA route,
the golden score files and the stored HiFi banded reference; plus the CUDA
route's launch-geometry rules, which are host arithmetic.  All comparisons
are of integers and exact."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import wfa_tpu
import wfa_tpu_torch
from wfa_tpu.ops.packing import pack_batch
from wfa_tpu.utils.io import read_seq_file
from wfa_tpu_torch import AlignmentOptions, Penalties
from wfa_tpu_torch.aligner import _TierPlan, _tier_geometry_cuda
from wfa_tpu_torch.ops import engine_cuda, engine_torch

DATA = Path(__file__).parent / "data"
H100_SMEM = 232448  # bytes a block may opt in to on an H100


def tpu_opts(opts, **kw):
    """wfa_tpu's options with the same field values, on one device."""
    fields = {f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)}
    fields["penalties"] = wfa_tpu.Penalties(*(getattr(opts.penalties, k) for k in "xoe"))
    return wfa_tpu.AlignmentOptions(**{**fields, "data_parallel": False, **kw})


def golden(tag):
    path = DATA / "results" / f"test.score.affine.{tag}.alg"
    return [int(line.split()[0]) for line in path.read_text().splitlines() if line.strip()]


@pytest.mark.parametrize(
    "pen,tag",
    [(Penalties(1, 2, 1), "p0"), (Penalties(3, 1, 4), "p1"), (Penalties(5, 3, 2), "p2")],
)
def test_torch_backend_matches_xla_and_goldens(pen, tag):
    batch = read_seq_file(DATA / "wfa.utest.seq", 60)
    opts = AlignmentOptions(penalties=pen, max_error=10000, backend="torch")
    got = wfa_tpu_torch.align_pairs(batch.patterns, batch.texts, opts)
    ref = wfa_tpu.align_pairs(
        batch.patterns, batch.texts,
        tpu_opts(opts, backend="xla"),
    )
    assert [r.error for r in got] == [r.error for r in ref]
    assert [
        r.finished_on_accelerator for r in got
    ] == [r.finished_on_accelerator for r in ref]
    assert [-r.error for r in got] == golden(tag)[:60]


def _hifi_reference():
    return json.loads((DATA / "hifi_banded_w512_b25.json").read_text())


def test_torch_backend_matches_xla_hifi_banded():
    """The 16 HiFi pairs of least reference distance, banded at W=512 and
    band 25 (bench.py::_bench_hifi_banded's configuration)."""
    batch = read_seq_file(DATA / "test_hifi.seq")
    idx = np.argsort(_hifi_reference()["distance"], kind="stable")[:16]
    pats = [batch.patterns[i] for i in idx]
    txts = [batch.texts[i] for i in idx]
    opts = AlignmentOptions(
        penalties=Penalties(2, 3, 1), max_error=3000, band=25,
        band_width=512, backend="torch",
    )
    got = wfa_tpu_torch.align_pairs(pats, txts, opts)
    ref = wfa_tpu.align_pairs(
        pats, txts, tpu_opts(opts, backend="xla")
    )
    assert [r.error for r in got] == [r.error for r in ref]
    assert all(r.finished_on_accelerator for r in got)


def test_twin_matches_stored_hifi_reference():
    ref = _hifi_reference()
    assert ref["config"] == {
        "penalties": [2, 3, 1], "wf_width": 512, "band": 25, "max_steps": 3000,
    }
    batch = read_seq_file(DATA / "test_hifi.seq", 4)
    nw = max(max(len(p), len(t)) for p, t in batch.pairs()) // 16 + 2
    pat, plen, vp = pack_batch(batch.patterns, nw)
    txt, tlen, vt = pack_batch(batch.texts, nw)
    out = engine_torch.align_batch_device(
        engine_torch.EngineConfig(Penalties(2, 3, 1), 3000, 512, 25),
        *engine_torch.batch_to_tensors(pat, plen, txt, tlen, vp & vt, "cpu"),
    )
    assert out["distance"].tolist() == ref["distance"][:4]
    assert out["finished"].tolist() == ref["finished"][:4]


def test_pipeline_and_aligner_object_match_one_call():
    batch = read_seq_file(DATA / "wfa.utest.seq", 30)
    opts = AlignmentOptions(
        penalties=Penalties(1, 2, 1), max_error=2, device_retries=0,
        backend="torch",
    )
    whole = [r.error for r in wfa_tpu_torch.align_pairs(
        batch.patterns, batch.texts, opts)]
    piped = wfa_tpu_torch.align_pairs_pipelined(
        batch.patterns, batch.texts, dataclasses.replace(opts, batch_size=7)
    )
    aligner = wfa_tpu_torch.WfaAligner(opts)
    for p, t in batch.pairs():
        aligner.add_sequences(p, t)
    assert [r.error for r in piped] == whole
    assert [r.error for r in aligner.align()] == whole
    assert whole == [-g for g in golden("p0")[:30]]
    # max_error 2 gives an empty schedule: every pair of nonzero distance
    # goes to the CPU fallback.
    assert not all(r.finished_on_accelerator for r in piped)


def _geom(tier, wf_width, pen=Penalties(2, 3, 1), banded=False,
          smem=H100_SMEM, score_limit=None, cigar=False):
    opts = AlignmentOptions(penalties=pen, band=25 if banded else -1,
                            compute_cigar=cigar)
    if score_limit is None and not banded:
        score_limit = 2 * pen.o + pen.e * 2 * (tier + 2) + pen.x
    plan = _TierPlan(tier, [0], wf_width, 8, tier // 16 + 1, score_limit)
    cfg, full, cert, score_cap = _tier_geometry_cuda(
        plan, opts, 3000, 25 if banded else -1, smem)
    assert (score_cap > 0) == cigar
    return cfg, full, cert


def test_geometry_widths_and_caps():
    assert engine_cuda.max_width(5, H100_SMEM) == 3840
    assert engine_cuda.max_width(4, H100_SMEM) == 4736
    assert engine_cuda.smem_bytes(5, 512) == 4 * (3 * 5 * 512 + 10 + 66)
    # Narrow exact: rounded up to 128 diagonals, untruncated.
    cfg, full, cert = _geom(1024, 2053)
    assert cfg.wf_width == 2176 and full
    assert cfg.score_limit == 2 * 3 + 2 * (1024 + 2) + 2


def test_geometry_exact_truncates_and_certifies():
    """Exact windows past the shared-memory ring take K4's global ring up to
    16384 diagonals; only past that are they truncated and certified."""
    from wfa_tpu_torch.aligner import _CUDA_CALL_BATCH, _distance_call_batch

    # seq_10K_n100 at -e 3000: W=6001 -> 6016 on the global ring, untruncated.
    cfg, full, cert = _geom(16384, 6001)
    assert (cfg.wf_width, cfg.ring_global, full) == (6016, True, True)
    assert cfg.score_limit == 2 * 3 + 2 * (16384 + 2) + 2
    assert cert == 3 + 1 * (6016 // 2 + 1)
    # Past 16384 diagonals: truncated there; the loop stops at the certificate.
    cfg, full, cert = _geom(16384, 20001)
    assert (cfg.wf_width, cfg.ring_global, full) == (16384, True, False)
    assert cert == 3 + 1 * (16384 // 2 + 1)
    assert cfg.score_limit == cert
    # A window that fits stays on the shared ring; a smaller shared memory
    # sends narrower windows to the global ring.
    cfg, full, _ = _geom(1024, 2053)
    assert (cfg.wf_width, cfg.ring_global, full) == (2176, False, True)
    assert engine_cuda.max_width(5, 48 * 1024) == 768
    cfg, full, _ = _geom(1024, 2053, smem=48 * 1024)
    assert (cfg.wf_width, cfg.ring_global, full) == (2176, True, True)
    # K4's launches keep the edge ring in the memory budget: at W=6016 the
    # centre holds 3712 diagonals, so 2**16 pairs would need 9 GB of edges.
    opts = AlignmentOptions(penalties=Penalties(2, 3, 1))
    assert engine_cuda.centre_width(5, 6016, 1025, False, H100_SMEM) == 3712
    assert engine_cuda.ring_bytes(5, 6016, 3712) == 138_240
    call_b = _distance_call_batch(opts, 138_240)
    assert 100 <= call_b and call_b * 138_240 <= 1 << 30
    assert _distance_call_batch(opts, 0) == _CUDA_CALL_BATCH


def test_geometry_banded_never_truncates():
    cfg, full, _ = _geom(16384, 512, banded=True)
    assert (cfg.wf_width, cfg.band, cfg.score_limit, full) == (512, 25, None, True)
    cfg, _, _ = _geom(128, 128, pen=Penalties(70, 6, 2), banded=True)
    assert engine_cuda.smem_bytes(71, cfg.wf_width) <= H100_SMEM
    with pytest.raises(ValueError):
        _geom(1024, 512, pen=Penalties(70, 6, 2), banded=True)


def test_geometry_invariants_fuzz():
    rng = np.random.default_rng(42)
    for _ in range(300):
        pen = Penalties(*(int(v) for v in rng.integers(1, 12, 3)))
        tier = int(rng.choice([64, 128, 1024, 4096, 16384]))
        wf = int(rng.integers(3, 2 * tier + 6))
        banded = bool(rng.random() < 0.4)
        smem = int(rng.choice([48 * 1024, 100 * 1024, H100_SMEM]))
        A = pen.active_working_set
        if banded and engine_cuda.smem_bytes(A, -(-wf // 128) * 128) > smem:
            with pytest.raises(ValueError):
                _geom(tier, wf, pen, banded, smem)
            continue
        cfg, full, cert = _geom(tier, wf, pen, banded, smem)
        w = -(-wf // 128) * 128
        assert cfg.wf_width % 128 == 0
        assert engine_cuda.smem_bytes(A, cfg.wf_width,
                                      ring_global=cfg.ring_global) <= smem
        assert cfg.ring_global == (not banded
                                   and w > engine_cuda.max_width(A, smem))
        assert cfg.wf_width == (min(w, 16384) if cfg.ring_global else w)
        assert cert == pen.o + pen.e * (cfg.wf_width // 2 + 1)
        assert full == (cfg.wf_width >= wf)
        if not full:
            assert cfg.score_limit <= cert


def test_geometry_cigar_mode():
    """CIGAR mode: K2's row words narrow the shared ring's exact cap; the
    table holds scores below score_cap = unfinished_score + 1, capped at the
    certificate when the window is truncated; the schedule runs to
    score_cap - 1; the per-launch batch keeps the table, and K4's ring, in
    the budget."""
    from wfa_tpu_torch.aligner import _cigar_call_batch
    from wfa_tpu_torch.ops.engine_torch import num_chunks
    from wfa_tpu_torch.schedule import build_schedule

    pen = Penalties(2, 3, 1)
    assert engine_cuda.max_width(5, H100_SMEM, cigar=True) == 3584
    assert engine_cuda.smem_bytes(5, 512, cigar=True) == (
        engine_cuda.smem_bytes(5, 512) + 4 * 512)
    opts = AlignmentOptions(penalties=pen, compute_cigar=True)
    # HiFi banded: W=512, untruncated; ~377 rows of 2 KB per lane.
    plan = _TierPlan(16384, [0], 512, 8, 1025, None)
    cfg, full, cert, cap = _tier_geometry_cuda(
        plan, AlignmentOptions(penalties=pen, band=25, compute_cigar=True),
        3000, 25, H100_SMEM)
    assert full and cap == build_schedule(pen, 3000, None).unfinished_score + 1
    assert cfg.score_limit == cap - 1 and cfg.compute_cigar
    assert num_chunks(cap) == 377
    assert _cigar_call_batch(opts, cap, 512) * num_chunks(cap) * 512 * 4 <= 1 << 30
    # seq_10K_n100 at -e 3000: past the CIGAR cap, on K4 with the whole
    # window.
    limit = 2 * 3 + 2 * (16384 + 2) + 2
    plan = _TierPlan(16384, [0], 6001, 8, 1025, limit)
    cfg, full, cert, cap = _tier_geometry_cuda(plan, opts, 3000, -1, H100_SMEM)
    assert (cfg.wf_width, cfg.ring_global, full) == (6016, True, True)
    assert cap == build_schedule(pen, 3000, limit).unfinished_score + 1
    assert cfg.score_limit == cap - 1
    centre = engine_cuda.centre_width(5, 6016, 1025, True, H100_SMEM)
    ring = engine_cuda.ring_bytes(5, 6016, centre)
    call_b = _cigar_call_batch(opts, cap, 6016, ring)
    per_lane = num_chunks(cap) * 6016 * 4 + ring
    assert 1 <= call_b and call_b * per_lane <= 1 << 30
    assert _cigar_call_batch(opts, cap, 6016) > call_b
    # Past 16384 diagonals: truncated and certified, the table capped.
    plan = _TierPlan(16384, [0], 20001, 8, 1025, limit)
    cfg, full, cert, cap = _tier_geometry_cuda(plan, opts, 10000, -1, H100_SMEM)
    assert (cfg.wf_width, cfg.ring_global, full) == (16384, True, False)
    assert cap == cert + 1 and cfg.score_limit == cert
    # A budget past 2**31 table cells: the kernels index with 64-bit offsets.
    big = dataclasses.replace(opts, memory_budget_bytes=64 << 30)
    ring = engine_cuda.ring_bytes(
        5, 16384, engine_cuda.centre_width(5, 16384, 1025, True, H100_SMEM))
    assert _cigar_call_batch(big, cap, 16384, ring) * num_chunks(cap) * 16384 > 2**31
