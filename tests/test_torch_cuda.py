"""K1 (wfa_tpu_torch/ops/csrc/wfa_distance.cu) against its plain PyTorch
version on the card: ``distance`` and ``finished`` equal in every lane.

Needs an NVIDIA GPU and nvcc; without them every test skips.  The file
imports no jax, so on a machine without it run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from wfa_tpu.ops.packing import pack_batch
from wfa_tpu.types import Penalties
from wfa_tpu_torch.ops import engine_cuda, engine_torch
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
    before = engine_cuda.LAUNCHES
    got = engine_cuda.align_batch_cuda(cfg, *args)
    torch.cuda.synchronize()
    assert engine_cuda.LAUNCHES == before + 1
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
