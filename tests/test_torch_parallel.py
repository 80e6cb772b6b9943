"""The port's data-parallel and multi-host layer (wfa_tpu_torch/parallel/)
against wfa_tpu/parallel/ on the same numpy-seeded inputs.

* The sharded engines on lists of CPU devices: ``align_batch_sharded``
  (the plain engine, distance and CIGAR) against the XLA engine shard-mapped
  over four virtual CPU devices; ``align_batch_pallas_sharded`` against the
  Pallas kernel shard-mapped over two, in interpret mode; the fused CIGAR
  rows and the walk alone on an uneven split against one unsplit call.
* The host-shard helpers against wfa_tpu's, on the cases of
  tests/test_distributed.py; ``initialize`` without a coordinator and
  ``allgather_scores`` with one process.
* A real 2-process gloo run (unequal shards, the allgather's padding) and
  the CLI's multi-host branch, against wfa_tpu's scores and the goldens.

Every output is an integer; every tolerance is 0.  ``probe_order`` is in
tests/test_torch_probe.py, so that its interpret-mode compile and this
file's run on separate workers.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wfa_tpu.ops.engine_pallas import PallasConfig
from wfa_tpu.ops.engine_xla import EngineConfig as XlaConfig
from wfa_tpu.ops.packing import pack_batch
from wfa_tpu.parallel import distributed as jax_distributed
from wfa_tpu.parallel import mesh as jax_mesh
from wfa_tpu.types import Penalties as JaxPenalties
from wfa_tpu_torch.ops import engine_cuda, engine_torch, traceback_torch
from wfa_tpu_torch.parallel import distributed, mesh
from wfa_tpu_torch.types import Penalties
from wfa_tpu_torch.utils.synth import EDGE_PAIRS, random_pairs

# Several test processes share the machine's cores with jax's; two
# intra-op threads each keep them from crowding one another.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
CPU = torch.device("cpu")


def _packed(pairs, nwords):
    pat, plen, vp = pack_batch([p for p, _ in pairs], nwords)
    txt, tlen, vt = pack_batch([t for _, t in pairs], nwords)
    return pat, plen, txt, tlen, vp & vt


def _jax_args(packed):
    pat, plen, txt, tlen, valid = packed
    return (jnp.asarray(pat), jnp.asarray(txt), jnp.asarray(plen),
            jnp.asarray(tlen), jnp.asarray(valid))


def _torch_args(packed):
    return engine_torch.batch_to_tensors(*packed, "cpu")


def test_data_mesh_and_shard_arithmetic():
    # No card here: the default is this process's CUDA devices, none.
    assert mesh.data_mesh() == [torch.device("cuda", i)
                                for i in range(torch.cuda.device_count())]
    assert mesh.data_mesh(["cpu", CPU]) == [CPU, CPU]
    assert mesh.shard_count(None) == 1 and mesh.shard_count([CPU] * 3) == 3
    assert [mesh.pad_to_multiple(n, 8) for n in (0, 1, 8, 9)] == [
        jax_mesh.pad_to_multiple(n, 8) for n in (0, 1, 8, 9)] == [0, 8, 8, 16]


@pytest.mark.parametrize("cigar", [False, True], ids=["distance", "cigar"])
@pytest.mark.parametrize("band", [-1, 10], ids=["exact", "banded"])
def test_align_batch_sharded_matches_xla_sharded(band, cigar):
    """Four blocks of 6: the plain engine on [cpu] x 4 against the XLA
    engine shard-mapped over four CPU devices, in every lane; in CIGAR mode
    the per-step choices and window bases too, each block's loop ending
    with its own pairs."""
    rng = np.random.default_rng(31 + band)
    pairs = EDGE_PAIRS[:10] + random_pairs(rng, 14, 20, 200, 0.2)
    packed = _packed(pairs, 14)
    xcfg = XlaConfig(penalties=JaxPenalties(2, 3, 1), max_steps=60,
                     wf_width=64, band=band, compute_cigar=cigar)
    want = jax_mesh.align_batch_sharded(
        xcfg, jax_mesh.data_mesh(jax.devices()[:4]), *_jax_args(packed))
    got = mesh.align_batch_sharded(
        engine_torch.config_from_tpu(xcfg), [CPU] * 4, *_torch_args(packed))
    keys = ["distance", "finished"] + (["choices", "lo_trace"] if cigar else [])
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    fin = got["finished"].numpy()
    assert fin.any() and not fin.all()
    whole = engine_torch.align_batch_device(
        engine_torch.config_from_tpu(xcfg), *_torch_args(packed))
    for k in ("distance", "finished"):
        np.testing.assert_array_equal(got[k].numpy(), whole[k].numpy(), k)


def test_align_batch_pallas_sharded_matches_pallas_sharded():
    """tests/test_sharded_pallas.py's case: the plain version of K1 on
    [cpu] x 2 against the Pallas kernel shard-mapped over two CPU devices
    in interpret mode, on ``finished`` and ``distance[finished]``."""
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for _ in range(16):
        p = rng.choice(bases, size=64)
        t = p.copy()
        t[rng.integers(0, 64, size=2)] = rng.choice(bases, size=2)
        pairs.append((bytes(p), bytes(t)))
    packed = _packed(pairs, 128)
    pcfg = PallasConfig(penalties=JaxPenalties(2, 3, 1), max_steps=32,
                        wf_width=128, tile_batch=8)
    with pltpu.force_tpu_interpret_mode():
        want = jax_mesh.align_batch_pallas_sharded(
            pcfg, jax_mesh.data_mesh(jax.devices()[:2]), *_jax_args(packed))
        dist_p = np.asarray(want["distance"])
        fin_p = np.asarray(want["finished"])
    got = mesh.align_batch_pallas_sharded(
        engine_torch.config_from_tpu(pcfg), [CPU] * 2, *_torch_args(packed))
    fin = got["finished"].numpy()
    np.testing.assert_array_equal(fin, fin_p)
    np.testing.assert_array_equal(got["distance"].numpy()[fin], dist_p[fin_p])
    assert fin.all()


def _cigar_case(band):
    pen = Penalties(2, 3, 1)
    rng = np.random.default_rng(5 + band)
    pairs = EDGE_PAIRS[:4] + random_pairs(rng, 7, 20, 120, 0.2, n_rate=0.0)
    cap = 61
    cfg = engine_torch.EngineConfig(pen, 60, 64, band, score_limit=cap - 1,
                                    compute_cigar=True)
    tb = traceback_torch.TracebackConfig(
        pen, 64, cap, banded=band > 0,
        lo_pad=engine_torch.lo_pad(cap) if band > 0 else 0)
    return cfg, tb, _torch_args(_packed(pairs, 9))


@pytest.mark.parametrize("band", [-1, 10], ids=["exact", "banded"])
def test_cigar_fused_and_traceback_sharded_uneven_split(band):
    """11 pairs over [cpu] x 3 (4, 4, 3): the fused rows of K2 + K3 and of
    K3 alone on one call's tables equal one unsplit call's; a batch smaller
    than the mesh uses one device a pair."""
    cfg, tb, args = _cigar_case(band)
    want = traceback_torch.align_cigar_fused(cfg, tb, *args)
    got = mesh.align_cigar_fused_sharded(cfg, tb, [CPU] * 3, *args)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (want[:, 2] > 0).sum() >= 6

    tables = engine_torch.cigar_tables(cfg, tb.score_cap, *args)
    tk = args[3] - args[2]
    walk = (tables["choice_words"], tables.get("lo_trace"),
            tables["distance"], tables["finished"], tk)
    np.testing.assert_array_equal(
        mesh.traceback_batch_sharded(tb, [CPU] * 3, *walk).numpy(),
        engine_cuda.traceback_cuda(tb, *walk).numpy())
    np.testing.assert_array_equal(
        mesh.align_cigar_fused_sharded(cfg, tb, [CPU] * 16, *args).numpy(),
        want.numpy())


def test_sharded_refuses_an_empty_mesh_or_batch():
    cfg, tb, args = _cigar_case(10)
    with pytest.raises(ValueError, match="device"):
        mesh.align_cigar_fused_sharded(cfg, tb, [], *args)
    with pytest.raises(ValueError, match="empty"):
        mesh.align_cigar_fused_sharded(cfg, tb, [CPU] * 2,
                                       *(a[:0] for a in args))


@pytest.mark.parametrize("n,nproc", [(103, 8), (10, 4), (64, 8), (5, 8), (7, 1)])
def test_host_shard_helpers_match_wfa_tpu(n, nproc):
    pats = [bytes([65 + i % 26]) * (i + 1) for i in range(n)]
    txts = [bytes([97 + i % 26]) * (i + 1) for i in range(n)]
    shards = []
    for pid in range(nproc):
        mine = distributed.host_shard(n, pid, nproc)
        np.testing.assert_array_equal(mine, jax_distributed.host_shard(n, pid, nproc))
        got = distributed.shard_batch(pats, txts, "res.out", pid, nproc)
        assert got == jax_distributed.shard_batch(pats, txts, "res.out", pid, nproc)
        assert got[2] == f"res.out.{pid}"
        assert distributed.shard_batch(pats, txts, None, pid, nproc)[2] is None
        shards.append(mine)
    np.testing.assert_array_equal(np.sort(np.concatenate(shards)), np.arange(n))
    scores = np.arange(n) * 3 - 7
    per_host = [scores[s] for s in shards]
    merged = distributed.merge_sharded_scores(per_host, n)
    np.testing.assert_array_equal(merged, scores)
    np.testing.assert_array_equal(
        merged, jax_distributed.merge_sharded_scores(per_host, n))


def test_single_process_defaults(monkeypatch):
    """Without a coordinator ``initialize`` is a no-op and everything is one
    process: the defaults shard nothing and the gather stacks the local
    scores, padded to ``total``."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    np.testing.assert_array_equal(distributed.host_shard(7), np.arange(7))
    local = np.array([3, -1, 42], dtype=np.int32)
    got = distributed.allgather_scores(local)
    assert got.shape == (1, 3) and got.dtype == np.int32
    np.testing.assert_array_equal(got, local[None])
    np.testing.assert_array_equal(
        distributed.allgather_scores(local, total=5), [[3, -1, 42, -1, -1]])
    with pytest.raises(ValueError, match="RANK"):
        distributed.initialize("localhost:1")


_WORKER = """\
import sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
torch.set_num_threads(1)
pid, nproc, port = (int(v) for v in sys.argv[1:4])
from wfa_tpu_torch.parallel import distributed
distributed.initialize(f"localhost:{{port}}", nproc, pid)
assert distributed.process_count() == nproc
assert distributed.process_index() == pid
pats = [bytes([65 + i % 4]) * 8 + b"ACGT" * 12 for i in range(9)]
txts = [p[:20] + p[21:] + b"G" for p in pats]
sp, st, _ = distributed.shard_batch(pats, txts, None)
from wfa_tpu_torch import AlignmentOptions, Penalties, align_pairs
res = align_pairs(sp, st, AlignmentOptions(
    penalties=Penalties(2, 3, 1), max_error=20, backend="torch"))
local = np.array([r.error for r in res], dtype=np.int32)
g = distributed.allgather_scores(local, total=9)
assert g.shape == (nproc, 5), g.shape
if pid == 0:
    print("MERGED", " ".join(map(str, distributed.merge_sharded_scores(list(g), 9))))
print("OK", pid, len(sp))
"""


def test_two_process_gloo_run_matches_wfa_tpu(tmp_path):
    """Two real processes join a gloo group on localhost, align their
    unequal strided shards (5 and 4 of 9 pairs) on the plain engine, gather
    the padded scores and merge them: wfa_tpu's XLA scores."""
    from wfa_tpu import AlignmentOptions, align_pairs

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(root=str(ROOT)))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(p), "2", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for p in range(2)
    ]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    assert "OK 0 5" in outs[0] and "OK 1 4" in outs[1], outs
    merged = [int(v) for v in outs[0].split("MERGED", 1)[1].split("\n")[0].split()]

    pats = [bytes([65 + i % 4]) * 8 + b"ACGT" * 12 for i in range(9)]
    txts = [p[:20] + p[21:] + b"G" for p in pats]
    ref = align_pairs(pats, txts, AlignmentOptions(
        penalties=JaxPenalties(2, 3, 1), max_error=20, backend="xla",
        data_parallel=False))
    assert merged == [r.error for r in ref]


def test_cli_multihost_branch_reproduces_goldens(tmp_path, monkeypatch):
    """The CLI's multi-host branch with two processes emulated: each writes
    its strided shard to OUTPUT.{pid}; merged, the scores are the golden
    file's."""
    from wfa_tpu_torch.cli import main

    nproc, n = 2, 24
    per_host = []
    for pid in range(nproc):
        monkeypatch.setattr(distributed, "process_count", lambda: nproc)
        monkeypatch.setattr(distributed, "process_index", lambda p=pid: p)
        out = tmp_path / "shard.out"
        assert main([
            "-i", str(DATA / "wfa.utest.seq"), "-n", str(n), "-g", "1,2,1",
            "-e", "25", "--backend", "torch", "-o", str(out),
        ]) == 0
        lines = (tmp_path / f"shard.out.{pid}").read_text().splitlines()
        assert len(lines) == len(range(pid, n, nproc))
        per_host.append(np.array([int(ln.split("\t")[0]) for ln in lines]))
    assert not (tmp_path / "shard.out").exists()
    gold = (DATA / "results" / "test.score.affine.p0.alg").read_text().splitlines()
    merged = distributed.merge_sharded_scores(per_host, n)
    assert merged.tolist() == [int(ln.split()[0]) for ln in gold[:n]]
