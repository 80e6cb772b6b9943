"""The CUDA kernels against their plain PyTorch versions on the card.

K1 (wfa_tpu_torch/ops/csrc/wfa_distance.cu): ``distance`` and ``finished``
equal in every lane.  K2 (the same source, CIGAR mode): distances and flags
equal, and the choice table and ``lo_trace`` equal wherever a backward walk
can read them (``engine_torch.tables_equal``).  K3
(wfa_tpu_torch/ops/csrc/wfa_traceback.cu): the fused rows (distance,
finished, n_ops, 0, op stream) equal.  Tolerance 0 throughout.

Needs an NVIDIA GPU and nvcc; without them every test skips.  The file
imports no jax, so on a machine without it run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from wfa_tpu_torch.ops import engine_cuda, engine_torch, traceback_torch
from wfa_tpu_torch.ops.packing import pack_batch
from wfa_tpu_torch.schedule import build_schedule
from wfa_tpu_torch.types import Penalties
from wfa_tpu_torch.utils.synth import EDGE_PAIRS, random_pairs

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tensors(pairs, device, invalid_every=0):
    lmax = max(max(len(p), len(t)) for p, t in pairs)
    nw = lmax // 16 + 2
    pat, plen, vp = pack_batch([p for p, _ in pairs], nw)
    txt, tlen, vt = pack_batch([t for _, t in pairs], nw)
    valid = vp & vt
    if invalid_every:
        valid[::invalid_every] = False
    return engine_torch.batch_to_tensors(pat, plen, txt, tlen, valid, device)


@pytest.mark.parametrize(
    "band,pen,width",
    [(-1, Penalties(2, 3, 1), 128), (10, Penalties(2, 3, 1), 128),
     (25, Penalties(4, 1, 2), 512), (-1, Penalties(1, 0, 1), 1024),
     (10, Penalties(70, 6, 2), 128), (-1, Penalties(2, 3, 1), 32)],
)
def test_kernel_equals_plain_version(device, band, pen, width):
    rng = np.random.default_rng(width + pen.x + band)
    pairs = EDGE_PAIRS + random_pairs(rng, 64, 10, 600)
    args = _tensors(pairs, device, invalid_every=9)
    cfg = engine_torch.EngineConfig(pen, 120, width, band)
    before = engine_cuda.LAUNCHES["wfa_distance"]
    got = engine_cuda.align_batch_cuda(cfg, *args)
    torch.cuda.synchronize()
    assert engine_cuda.LAUNCHES["wfa_distance"] == before + 1
    want = engine_torch.align_batch_device(cfg, *args)
    assert torch.equal(got["finished"], want["finished"])
    assert torch.equal(got["distance"], want["distance"])


def test_kernel_refuses_what_it_cannot_run(device):
    args = _tensors(EDGE_PAIRS, device)
    pen = Penalties(2, 3, 1)
    with pytest.raises(ValueError):   # W not a multiple of 32
        engine_cuda.align_batch_cuda(
            engine_torch.EngineConfig(pen, 50, 100, -1), *args)
    with pytest.raises(ValueError):   # ring larger than shared memory
        engine_cuda.align_batch_cuda(
            engine_torch.EngineConfig(Penalties(70, 6, 2), 50, 512, 25), *args)
    with pytest.raises(ValueError):   # wrong dtype
        engine_cuda.align_batch_cuda(
            engine_torch.EngineConfig(pen, 50, 128, -1),
            args[0].long(), *args[1:])


def _cigar_configs(pen, max_steps, width, band):
    score_cap = build_schedule(pen, max_steps, None).unfinished_score + 1
    cfg = engine_torch.EngineConfig(
        pen, max_steps, width, band, score_limit=score_cap - 1,
        compute_cigar=True,
    )
    tb = traceback_torch.TracebackConfig(
        pen, width, score_cap, banded=band > 0,
        lo_pad=engine_torch.lo_pad(score_cap) if band > 0 else 0,
    )
    return cfg, tb


@pytest.mark.parametrize(
    "band,pen,width",
    [(-1, Penalties(2, 3, 1), 128), (10, Penalties(2, 3, 1), 128),
     (25, Penalties(4, 1, 2), 512), (-1, Penalties(1, 0, 1), 512),
     (10, Penalties(70, 6, 2), 128)],
)
def test_k2_k3_equal_plain_version(device, band, pen, width):
    rng = np.random.default_rng(7 * width + pen.x + band)
    pairs = EDGE_PAIRS + random_pairs(rng, 48, 10, 500)
    args = _tensors(pairs, device, invalid_every=11)
    cfg, tb = _cigar_configs(pen, 120, width, band)
    before = dict(engine_cuda.LAUNCHES)
    got = engine_cuda.cigar_tables_cuda(cfg, tb.score_cap, *args)
    fused = engine_cuda.traceback_cuda(
        tb, got["choice_words"], got.get("lo_trace"), got["distance"],
        got["finished"], args[3] - args[2],
    )
    torch.cuda.synchronize()
    assert engine_cuda.LAUNCHES["wfa_cigar"] == before["wfa_cigar"] + 1
    assert engine_cuda.LAUNCHES["wfa_traceback"] == before["wfa_traceback"] + 1
    plain = engine_torch.cigar_tables(cfg, tb.score_cap, *args)
    assert torch.equal(got["finished"], plain["finished"])
    assert torch.equal(got["distance"], plain["distance"])
    assert engine_torch.tables_equal(cfg, tb.score_cap, plain, got)
    want = traceback_torch.align_cigar_fused(cfg, tb, *args)
    assert torch.equal(fused, want)
    assert torch.equal(engine_cuda.align_cigar_cuda(cfg, tb, *args), want)
    walked = plain["finished"] & (plain["distance"] > 0)
    assert bool((want[:, 2][walked] > 0).all())


def test_k3_walk_errors_equal_plain_version(device):
    """A table of zeros: lanes whose diagonal leaves the window are corrupt
    (-1), unfinished and distance-0 lanes have no walk (0)."""
    pen = Penalties(2, 3, 1)
    tb = traceback_torch.TracebackConfig(pen, 64, 40, banded=False)
    words = torch.zeros((tb.num_chunks, 4, 64), dtype=torch.int32, device=device)
    dist = torch.tensor([6, 6, 0, 6], dtype=torch.int32, device=device)
    fin = torch.tensor([True, True, True, False], device=device)
    tk = torch.tensor([0, 40, 0, 0], dtype=torch.int32, device=device)
    got = engine_cuda.traceback_cuda(tb, words, None, dist, fin, tk)
    want = engine_cuda.traceback_cuda(
        tb, words.cpu(), None, dist.cpu(), fin.cpu(), tk.cpu()
    )
    assert torch.equal(got.cpu(), want)
    assert got[:, 2].tolist() == [3, -1, 0, 0]
