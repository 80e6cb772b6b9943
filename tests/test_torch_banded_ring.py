"""Banded windows wider than a block's shared memory (K4 with a band).

The CUDA route's planner sends a banded window past ``engine_cuda.max_width``
to K4 at its own W (``ring_global``), never truncated or certified, where
``wfa_tpu`` runs its XLA engine.  Here, on the CPU: the planner's arithmetic
at a small shared memory (so that W=512 already exceeds a shared ring), the
config and launch counts, and ``align_pairs`` on seeded 1 kbp pairs at such
a config, through the plain engine (``backend='torch'``) and through the
CUDA route's tier loop with the wrappers on CPU tensors (their plain
versions), against ``wfa_tpu.align_pairs(backend='xla')``.  Every comparison
is of integers or strings, exact.  K4 itself runs on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase banded-ring).
"""
import numpy as np
import pytest
import torch

import wfa_tpu
import wfa_tpu_torch
from wfa_tpu_torch import AlignmentOptions, Penalties, aligner
from wfa_tpu_torch.aligner import _RING_MAX_W, _TierPlan, _tier_geometry_cuda
from wfa_tpu_torch.ops import engine_cuda, engine_torch
from wfa_tpu_torch.utils.synth import random_pairs
from wfa_tpu_torch.utils.verification import check_cigar

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

H100_SMEM = 232448   # bytes a block may opt in to on an H100
SMALL_SMEM = 16384   # a shared ring holds 256 diagonals, 128 with CIGARs
PEN = Penalties(2, 3, 1)


def _geometry(width, cigar, smem=SMALL_SMEM, tier=1024):
    opts = AlignmentOptions(penalties=PEN, band=25, band_width=width,
                            compute_cigar=cigar)
    plan = _TierPlan(tier, [0], width, 8, tier // 16 + 1, None)
    return _tier_geometry_cuda(plan, opts, 300, 25, smem)


@pytest.mark.parametrize("cigar", [False, True], ids=["distance", "cigar"])
def test_planner_sends_wide_bands_to_k4(cigar):
    assert engine_cuda.max_width(5, SMALL_SMEM, cigar) == (128 if cigar else 256)
    cfg, full, cert, cap = _geometry(512, cigar)
    assert (cfg.wf_width, cfg.ring_global, cfg.band, full) == (512, True, 25, True)
    assert cfg.score_limit == (cap - 1 if cigar else None)
    assert cert == PEN.o + PEN.e * (512 // 2 + 1)
    # 256 diagonals fit a shared ring without the choice row words only.
    cfg, full, _, _ = _geometry(256, cigar)
    assert (cfg.wf_width, cfg.ring_global, full) == (256, cigar, True)
    # On an H100: the CLI's -B auto -t 4096 on 20 kbp reads, and a band
    # wider than the exact ring's cap, are K4 at their own W.
    cfg, full, _, _ = _geometry(4096, cigar, H100_SMEM, tier=32768)
    assert (cfg.wf_width, cfg.ring_global, full) == (4096, True, True)
    assert engine_cuda.centre_width(5, 4096, 2049, cigar, H100_SMEM) < 4096
    cfg, full, _, _ = _geometry(20001, cigar, H100_SMEM, tier=32768)
    assert cfg.wf_width == 20096 > _RING_MAX_W and cfg.ring_global and full
    # The one raise left: K4's packed rows (2049 words each) and one centre
    # granule do not fit.
    with pytest.raises(ValueError, match="K4"):
        _geometry(512, cigar, tier=32768)


def test_config_takes_a_band_with_the_global_ring():
    cfg = engine_torch.EngineConfig(PEN, 50, 512, band=25, ring_global=True)
    assert cfg.banded and cfg.ring_global
    before = dict(engine_cuda.LAUNCHES)
    engine_cuda._count("wfa_distance", cfg, True)
    engine_cuda._count("wfa_cigar", cfg, True)
    engine_cuda._count("wfa_cigar", engine_torch.EngineConfig(
        PEN, 50, 512, ring_global=True), True)
    after = engine_cuda.LAUNCHES
    assert after["wfa_distance_ring_banded"] == before["wfa_distance_ring_banded"] + 1
    assert after["wfa_cigar_ring_banded"] == before["wfa_cigar_ring_banded"] + 1
    assert after["wfa_cigar_ring"] == before["wfa_cigar_ring"] + 1
    assert after["wfa_distance_ring"] == before["wfa_distance_ring"]


def _pairs():
    rng = np.random.default_rng(2026)
    return random_pairs(rng, 10, 900, 1100, 0.12, n_rate=0.0)


@pytest.mark.parametrize("cigar", [False, True], ids=["distance", "cigar"])
def test_align_pairs_banded_ring_matches_xla(monkeypatch, cigar):
    """W=512, band 10, at a shared memory where W=512 takes K4: the plain
    engine and the CUDA route's loop on CPU tensors give wfa_tpu's XLA
    results, distances, flags and CIGARs."""
    pairs = _pairs()
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    opts = AlignmentOptions(penalties=PEN, max_error=400, band=10,
                            band_width=512, compute_cigar=cigar,
                            backend="torch")
    ref = wfa_tpu.align_pairs(pats, txts, wfa_tpu.AlignmentOptions(
        penalties=wfa_tpu.Penalties(2, 3, 1), max_error=400, band=10,
        band_width=512, compute_cigar=cigar, backend="xla",
        data_parallel=False))
    plain = wfa_tpu_torch.align_pairs(pats, txts, opts)

    rings = []
    run = aligner._run_tier_cuda

    def on_cpu(*args):
        rings.append(aligner._tier_geometry_cuda(
            args[3], args[4], args[5], args[6], SMALL_SMEM)[0].ring_global)
        return run(*args, device=torch.device("cpu"), smem=SMALL_SMEM)

    monkeypatch.setattr(aligner, "_resolve_backend", lambda name: "cuda")
    monkeypatch.setattr(aligner, "_run_tier_cuda", on_cpu)
    routed = wfa_tpu_torch.align_pairs(pats, txts, opts)
    assert rings and all(rings)
    for got in (plain, routed):
        assert [r.error for r in got] == [r.error for r in ref]
        assert [r.finished_on_accelerator for r in got] == [
            r.finished_on_accelerator for r in ref]
        assert [r.cigar for r in got] == [r.cigar for r in ref]
    # One pair (an empty pattern, distance 965) is past max_error: the CPU
    # fallback aligns it on every route.
    assert [r.finished_on_accelerator for r in ref].count(False) == 1
    if cigar:
        assert all(check_cigar(r.cigar, p, t) for r, p, t in zip(ref, pats, txts))
