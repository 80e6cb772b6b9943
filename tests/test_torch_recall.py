"""Band recall on long reads (``tools/torch_nanopore_recall.py``) against
wfa_tpu: the read generators give the same bytes as ``bench._mutate_batch``
and ``tools/nanopore_recall.py::_mutate_bursts`` from the same seed; the
plain engine's banded distances and flags on burst reads equal the XLA
engine's; and the tool's ``--small`` table (and, marked slow, its
``--small20`` table) equals the XLA tables of BASELINE.md."""
import ast
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from wfa_tpu.ops.engine_xla import EngineConfig as XlaConfig
from wfa_tpu.ops.engine_xla import align_batch_device as xla_align
from wfa_tpu.ops.packing import pack_batch as tpu_pack_batch
from wfa_tpu.types import Penalties as TpuPenalties
from wfa_tpu_torch.ops import engine_torch
from wfa_tpu_torch.utils.synth import mutate_batch, mutate_bursts

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import torch_nanopore_recall as recall  # noqa: E402

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _tpu_mutate_bursts():
    """``_mutate_bursts`` of tools/nanopore_recall.py, which runs jax and
    device work when imported: its definition alone, with ``bench`` and
    ``np`` in scope."""
    path = ROOT / "tools" / "nanopore_recall.py"
    fn = next(node for node in ast.parse(path.read_text()).body
              if isinstance(node, ast.FunctionDef) and node.name == "_mutate_bursts")
    scope = {"bench": bench, "np": np}
    exec(compile(ast.Module([fn], type_ignores=[]), str(path), "exec"), scope)
    return scope["_mutate_bursts"]


@pytest.mark.parametrize("burst", [False, True], ids=["uniform", "burst"])
def test_read_generators_match(burst):
    ours, theirs = np.random.default_rng(7), np.random.default_rng(7)
    pats = [ours.choice(_BASES, size=20000).tobytes() for _ in range(6)]
    assert pats == [theirs.choice(_BASES, size=20000).tobytes() for _ in range(6)]
    if burst:
        got, want = mutate_bursts(ours, pats), _tpu_mutate_bursts()(theirs, pats)
    else:
        got, want = mutate_batch(ours, pats, 0.06), bench._mutate_batch(theirs, pats, 0.06)
    assert got == want
    # The generators are left in the same state: the pairs a tool draws
    # next for its cross-check are the same too.
    assert ours.integers(1 << 30, size=4).tolist() == theirs.integers(1 << 30, size=4).tolist()
    pats_t, txts_t, _ = recall.long_reads(burst, n=6)
    assert (pats_t, txts_t) == (pats, got)


def test_burst_reads_plain_engine_matches_xla():
    """Four ~1 kbp burst reads (two 50-150 bp events each) at W=65, band
    25: per-pair distances and flags equal."""
    rng = np.random.default_rng(11)
    pats = [rng.choice(_BASES, size=int(rng.integers(900, 1100))).tobytes()
            for _ in range(4)]
    txts = mutate_bursts(rng, pats, n_bursts=2, indel=(50, 151), patch=(50, 151),
                         tail=400)
    nw = max(max(len(p), len(t)) for p, t in zip(pats, txts)) // 16 + 2
    pat, plen, vp = tpu_pack_batch(pats, nw)
    txt, tlen, vt = tpu_pack_batch(txts, nw)
    xcfg = XlaConfig(penalties=TpuPenalties(2, 3, 1), max_steps=600, wf_width=65,
                     band=25, compute_cigar=False)
    want = xla_align(xcfg, jnp.asarray(pat), jnp.asarray(txt), jnp.asarray(plen),
                     jnp.asarray(tlen), jnp.asarray(vp & vt))
    got = engine_torch.align_batch_device(
        engine_torch.config_from_tpu(xcfg),
        *engine_torch.batch_to_tensors(pat, plen, txt, tlen, vp & vt, "cpu"))
    np.testing.assert_array_equal(got["distance"].numpy(), np.asarray(want["distance"]))
    np.testing.assert_array_equal(got["finished"].numpy(), np.asarray(want["finished"]))
    assert int(got["distance"].max()) > 150     # the events cost their length


def test_small_table_matches_baseline():
    """BASELINE.md:88-92, the XLA engine's table: (width, finished,
    score == optimal, largest inflation) of 12 pairs."""
    assert recall.small() == [(129, 12, 1, 897), (257, 12, 5, 897), (513, 12, 12, 0)]


@pytest.mark.slow
def test_small20_table_matches_baseline():
    """BASELINE.md:99-104, the XLA engine's table of 8 pairs of 20 kbp."""
    assert recall.small20() == [(129, 6, 0, 738), (257, 6, 5, 443),
                                (513, 6, 6, 0), (1025, 8, 8, 0)]


def test_card_modes_refuse_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--burst"]):
        assert recall.main(argv) == 2
        assert "CUDA" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        recall.card_recall(False, torch.device("cpu"))
