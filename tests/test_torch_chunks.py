"""The CUDA route's chunk loop (``aligner._run_tier_cuda``) on the CPU.

The loop packs, launches and copies back every chunk of a tier before it
decodes the first (``wfa_tpu/aligner.py:387-524``), with at most
``_pending_depth`` chunks in flight.  Here it runs on an explicit CPU device,
where the CUDA wrappers run their plain versions, at a shared memory small
enough that the exact window takes K4 (whose edge ring, and in CIGAR mode the
choice table, the memory budget bounds), and at a budget that cuts the tier
into four chunks.  The results must equal one chunk's, a depth of one's and
``wfa_tpu``'s XLA route's, in order, with the same pairs sent to the CPU
fallback.  Every comparison is of integers or strings, exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

import wfa_tpu
import wfa_tpu_torch
from wfa_tpu_torch import AlignmentOptions, Penalties, aligner
from wfa_tpu_torch.aligner import _TierPlan, _tier_geometry_cuda
from wfa_tpu_torch.ops import engine_cuda, engine_torch
from wfa_tpu_torch.parallel import mesh as parallel_mesh
from wfa_tpu_torch.utils.synth import random_pairs

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

SMALL_SMEM = 16384   # a shared ring holds 256 diagonals, 128 with CIGARs
PEN = Penalties(2, 3, 1)
MAX_ERROR = 150
N_PAIRS = 28         # one tier (1024); 8 pairs a chunk -> 8, 8, 8, 4


def _pairs():
    rng = np.random.default_rng(10)
    return random_pairs(rng, N_PAIRS, 600, 900, 0.08, n_rate=0.05)


def _per_lane(opts) -> int:
    """Bytes of one lane that the budget bounds on this tier (K4's edge ring
    and, with CIGARs, the choice table): the planner's own arithmetic."""
    plan = _TierPlan(1024, [0], 2 * MAX_ERROR + 1, 8, 65,
                     2 * PEN.o + PEN.e * 2 * 1026 + PEN.x)
    cfg, _, _, cap = _tier_geometry_cuda(plan, opts, MAX_ERROR, -1, SMALL_SMEM)
    assert cfg.ring_global and cfg.wf_width == 384
    centre = engine_cuda.centre_width(5, 384, 65, opts.compute_cigar, SMALL_SMEM)
    ring = engine_cuda.ring_bytes(5, 384, centre)
    if not opts.compute_cigar:
        return ring
    return engine_torch.num_chunks(cap) * 384 * 4 + ring


def _run(monkeypatch, pats, txts, opts, max_pending=None, mesh=None):
    """align_pairs through the CUDA route's loop on the CPU (``mesh``: split
    over those CPU devices, as ``data_mesh()`` gives cards): the results and
    each tier's (chunks, depth, most in flight)."""
    stats = []
    run = aligner._run_tier_cuda
    where = {"smem": SMALL_SMEM}
    if mesh is None:
        where["device"] = torch.device("cpu")

    def on_cpu(*args):
        out = run(*args, **where)
        stats.append(out)
        return out

    with monkeypatch.context() as m:
        m.setattr(aligner, "_resolve_backend", lambda name: "cuda")
        m.setattr(aligner, "_run_tier_cuda", on_cpu)
        m.setattr(aligner, "_MAX_PENDING", max_pending)
        m.setattr(parallel_mesh, "data_mesh", lambda devices=None: mesh)
        res = wfa_tpu_torch.align_pairs(pats, txts, opts)
    return res, stats


def _summary(res):
    return [(r.error, r.cigar, r.finished_on_accelerator) for r in res]


@pytest.mark.parametrize("cigar", [False, True], ids=["distance", "cigar"])
def test_chunk_loop_equals_one_chunk_and_xla(monkeypatch, cigar):
    pairs = _pairs()
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    base = AlignmentOptions(penalties=PEN, max_error=MAX_ERROR,
                            compute_cigar=cigar, device_retries=0)
    small = dataclasses.replace(base, memory_budget_bytes=8 * _per_lane(base))

    chunked, stats = _run(monkeypatch, pats, txts, small)
    assert [s["chunks"] for s in stats] == [4]
    # Every chunk is packed and launched before the first is decoded.
    assert stats[0]["depth"] == stats[0]["peak"] == 4

    whole, stats = _run(monkeypatch, pats, txts, base)
    assert [(s["chunks"], s["peak"]) for s in stats] == [(1, 1)]
    assert _summary(chunked) == _summary(whole)

    for cap in (1, 2):
        capped, stats = _run(monkeypatch, pats, txts, small, max_pending=cap)
        assert stats[0]["chunks"] == 4
        assert stats[0]["peak"] <= stats[0]["depth"] == cap
        assert _summary(capped) == _summary(chunked)

    ref = wfa_tpu.align_pairs(pats, txts, wfa_tpu.AlignmentOptions(
        penalties=wfa_tpu.Penalties(2, 3, 1), max_error=MAX_ERROR,
        compute_cigar=cigar, device_retries=0, backend="xla",
        data_parallel=False))
    assert [r.error for r in chunked] == [r.error for r in ref]
    assert [r.finished_on_accelerator for r in chunked] == [
        r.finished_on_accelerator for r in ref]
    if cigar:
        assert [r.cigar for r in chunked] == [r.cigar for r in ref]
    # Pairs with an N and pairs past max_error went to the CPU fallback;
    # most finished on the device.
    on_device = sum(r.finished_on_accelerator for r in chunked)
    assert N_PAIRS // 2 < on_device < N_PAIRS


@pytest.mark.parametrize("cigar", [False, True], ids=["distance", "cigar"])
def test_sharded_chunk_loop_equals_one_device(monkeypatch, cigar):
    """With two devices in data_mesh() each chunk is split over both
    (``mesh.*_sharded(wait=False)``) and every chunk is still dispatched
    before the first is decoded; the results equal one device's."""
    pairs = _pairs()
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    opts = AlignmentOptions(penalties=PEN, max_error=MAX_ERROR,
                            compute_cigar=cigar, device_retries=0)
    opts = dataclasses.replace(opts, memory_budget_bytes=4 * _per_lane(opts))
    one, stats = _run(monkeypatch, pats, txts,
                      dataclasses.replace(opts, data_parallel=False))
    assert [(s["chunks"], s["peak"]) for s in stats] == [(7, 7)]
    cpu = torch.device("cpu")
    split, stats = _run(monkeypatch, pats, txts, opts, mesh=[cpu, cpu])
    assert [(s["chunks"], s["peak"]) for s in stats] == [(4, 4)]
    assert _summary(split) == _summary(one)


def test_pending_depth_bound():
    assert aligner._pending_depth(4, 1000, 1 << 30) == 4
    assert aligner._pending_depth(4, 1000, 2500) == 2
    assert aligner._pending_depth(4, 1000, 10) == 1
    assert aligner._pending_depth(1, 1000, 1 << 30) == 1
