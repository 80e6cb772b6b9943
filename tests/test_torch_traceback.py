"""K3's windowed walk, stated in numpy and held to the plain walk on the CPU.

The kernel (wfa_tpu_torch/ops/csrc/wfa_traceback.cu) cannot run here.  What
it reads and when can: ``walk_model`` below follows one warp's walk as the
kernel does, load for load.  The current choice row's window (32 words
from the walk's diagonal - 16, clamped to [0, W)) sits in one of ``SLOTS``
slots (the kernel copies each into shared memory asynchronously and takes
the current one into registers); entering a row issues the window of the
row ``SLOTS - 1`` below it into the slot just freed, centred on the
diagonal the walk would have there if k did not move (k - lo(top score of
that row)); a row the walk jumps to without a prefetch, and the first row,
load at entry and re-issue the rows below; a diagonal outside the current
window reloads it centred on the diagonal (a miss); ``lo_trace`` arrives in
aligned 32-score chunks, two chunks ahead.  The model gives the op streams
and op counts, which must equal ``traceback_torch.traceback_batch_device``
on plain-K2 tables (banded with re-centres that move ``lo`` past the
window, exact, walks that start at the window's edges), on forged corrupt
tables, on a distance past ``lo_pad`` and on a stream that overflows
``opw``; and it counts the loads, which must equal the rows the walk
enters plus the misses plus the prefetches never entered.
``tests/test_torch_cuda.py`` holds the kernel's own counts to the model's.
Every comparison is exact."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from wfa_tpu_torch.ops import engine_torch, traceback_torch
from wfa_tpu_torch.ops.packing import pack_batch
from wfa_tpu_torch.schedule import build_schedule
from wfa_tpu_torch.types import AffineOp, Penalties
from wfa_tpu_torch.utils.synth import (
    EDGE_PAIRS, edge_pairs, forged_walks, overflow_walks, random_pairs,
)

torch.set_num_threads(2)

SLOTS = 4   # kSlots in csrc/wfa_traceback.cu: the current row + 3 ahead
HALF = 16   # kHalf: the window is the 32 words from k - lo - 16 on
_M_FROM_X, _M_FROM_I = 0, 1


@dataclasses.dataclass
class Walk:
    ops: list            # opw stream words, u32 values
    n_ops: int
    rows: int = 0        # rows the walk entered
    loads: int = 0       # window loads issued
    misses: int = 0      # reloads of the current row's window
    cold: int = 0        # row entries with no window in flight (the first too)
    unentered: int = 0   # loads of rows the walk never entered


def walk_model(tb, words, lo, dist, fin, tk, b):
    """Alignment ``b``'s walk as one warp of K3 runs it (numpy in, a Walk
    out); ``words`` [C, B, W] and ``lo`` [B, lo_pad] (or None) numpy."""
    C, _, W = words.shape
    span = 2 * HALF
    pen = tb.penalties
    opw = tb.opw
    max_ops = opw * traceback_torch.OPS_PER_WORD
    S = lo.shape[1] if lo is not None else 0
    walk = bool(fin[b]) and int(dist[b]) > 0
    st = Walk(ops=[0] * opw, n_ops=0)
    d = int(dist[b]) if walk else 0
    k = int(tk[b])
    mat = p = acc = 0
    err = False
    tag = [-1] * SLOTS
    base = [0] * SLOTS
    entered = [True] * SLOTS     # no load pending in an empty slot
    c0, have_nxt = None, False   # lo chunk held: scores c0 .. c0 + 31

    def prologue():
        """(row, diagonal) of the next read, or None: the walk is over or
        corrupt.  The row check comes before any read."""
        nonlocal err, c0, have_nxt
        if err or d <= 0:
            return None
        r = d >> 3
        if r >= C:
            err = True
            return None
        if lo is None:
            lo_d = -(W // 2)
        else:
            ld = min(d, S - 1)
            if c0 is None or ld < c0:   # a new chunk (the next two in flight)
                c0 = ld & ~31
                have_nxt = c0 >= 32
            lo_d = int(lo[b, ld])
        j = k - lo_d
        if j < 0 or j >= W:
            err = True
            return None
        return r, j

    def centre(rr, j):
        """Where row rr's window is centred: the diagonal k would have at
        the top score of row rr, where that score's lo is in the chunks
        held; else the current diagonal."""
        if lo is None:
            return j
        sc = min(8 * rr + 7, S - 1)
        if sc >= c0 or (have_nxt and sc >= c0 - 32):
            return k - int(lo[b, sc])
        return j

    def load(slot, rr, c):
        if rr < 0:
            tag[slot] = -1
            return
        if not entered[slot]:
            st.unentered += 1
        tag[slot] = rr
        base[slot] = min(max(c - HALF, 0), max(W - span, 0))
        entered[slot] = False
        st.loads += 1

    def enter(slot, r, j, cold):
        """Enter row r in ``slot``; with ``cold`` it loads there now and
        re-issues the rows below that no slot holds in order."""
        st.rows += 1
        if cold:
            st.cold += 1
            load(slot, r, j)
            for t in range(1, SLOTS):
                sl = (slot + t) % SLOTS
                if tag[sl] != r - t:
                    load(sl, r - t, centre(r - t, j))
        entered[slot] = True

    def step(word):
        nonlocal d, k, mat, p, acc, err
        ch = (word >> (4 * (d & 7))) & 0xF
        if mat == 0:
            op = int(AffineOp.SUB)
            frm = ch & 3
            if frm == _M_FROM_X:
                d -= pen.x
            else:
                mat = 1 if frm == _M_FROM_I else 2
        else:
            op = int(AffineOp.INS) if mat == 1 else int(AffineOp.DEL)
            k += -1 if mat == 1 else 1
            if ch & (4 if mat == 1 else 8):
                d -= pen.e
            else:
                d -= pen.o + pen.e
                mat = 0
        acc |= op << (2 * (p & 15))
        if (p & 15) == 15:
            st.ops[p >> 4] = acc
            acc = 0
        p += 1
        if p >= max_ops:
            err = True

    nxt = prologue()
    if nxt is not None:
        r, j = nxt
        s = 0
        R = r
        enter(0, r, j, cold=True)
        while True:
            if not base[s] <= j < base[s] + span:
                load(s, R, j)
                entered[s] = True
                st.misses += 1
            step(int(words[r, b, j]) & 0xFFFFFFFF)
            nxt = prologue()
            if nxt is None:
                break
            r, j = nxt
            if r != R:
                s1 = (s + 1) % SLOTS
                if tag[s1] == r:
                    load(s, r - (SLOTS - 1), centre(r - (SLOTS - 1), j))
                    enter(s1, r, j, cold=False)
                else:
                    enter(s1, r, j, cold=True)
                R, s = r, s1
    st.unentered += sum(not e for e in entered)
    if p & 15:
        st.ops[p >> 4] = acc
    ok = not err and d == 0 and k == 0 and mat == 0
    st.n_ops = (p if ok else -1) if walk else 0
    return st


def model_batch(tb, words, lo, dist, fin, tk):
    """walk_model over the batch: (ops int64 [B, opw] of u32 values, n_ops
    [B], stats int64 [B, 4]: rows, loads, misses, cold entries, the
    kernel's per-walk counters), and the Walks."""
    args = [t.numpy() if t is not None else None
            for t in (words, lo, dist, fin, tk)]
    walks = [walk_model(tb, *args, b) for b in range(dist.shape[0])]
    ops = np.array([w.ops for w in walks], dtype=np.int64).reshape(len(walks), tb.opw)
    n_ops = np.array([w.n_ops for w in walks], dtype=np.int64)
    stats = np.array([[w.rows, w.loads, w.misses, w.cold] for w in walks],
                     dtype=np.int64).reshape(len(walks), 4)
    return ops, n_ops, stats, walks


# ---- the cases (also run on the card by tests/test_torch_cuda.py) ----

def _tables(pen, max_steps, width, band, pairs):
    """Plain K2 on ``pairs``: (TracebackConfig, choice_words, lo_trace or
    None, distance, finished, target_k), CPU tensors."""
    score_cap = build_schedule(pen, max_steps, None).unfinished_score + 1
    cfg = engine_torch.EngineConfig(pen, max_steps, width, band,
                                    score_limit=score_cap - 1, compute_cigar=True)
    tb = traceback_torch.TracebackConfig(
        pen, width, score_cap, banded=band > 0,
        lo_pad=engine_torch.lo_pad(score_cap) if band > 0 else 0,
    )
    nw = max(max(len(p), len(t)) for p, t in pairs) // 16 + 2
    pat, plen, vp = pack_batch([p for p, _ in pairs], nw)
    txt, tlen, vt = pack_batch([t for _, t in pairs], nw)
    args = engine_torch.batch_to_tensors(pat, plen, txt, tlen, vp & vt, "cpu")
    t = engine_torch.cigar_tables(cfg, score_cap, *args)
    return (tb, t["choice_words"], t.get("lo_trace"), t["distance"],
            t["finished"], args[3] - args[2])


NAMES = ("banded-narrow", "banded-x4o1e2", "banded-x70", "exact", "exact-edges",
         "exact-b1", "forged-exact", "forged-banded", "forged-lo-pad", "overflow")


@functools.cache
def traceback_cases():
    """{name: (name, tb, words, lo, dist, fin, tk)} of every case, CPU
    tensors; built at first use, not at collection (every test worker
    collects this file)."""
    rng = np.random.default_rng(20261017)
    pen = Penalties(2, 3, 1)
    cases = [
        ("banded-narrow", *_tables(pen, 200, 96, 5, EDGE_PAIRS + random_pairs(
            rng, 40, 60, 400, 0.3, n_rate=0.0))),
        ("banded-x4o1e2", *_tables(Penalties(4, 1, 2), 200, 96, 10, random_pairs(
            rng, 24, 100, 400, 0.3, n_rate=0.0))),
        ("banded-x70", *_tables(Penalties(70, 6, 2), 400, 64, 25, random_pairs(
            rng, 16, 30, 200, 0.3, n_rate=0.0))),
        ("exact", *_tables(pen, 200, 128, -1, EDGE_PAIRS + random_pairs(
            rng, 32, 10, 300, 0.3))),
        ("exact-edges", *_tables(pen, 120, 128, -1, edge_pairs(rng, 128, 6))),
        ("exact-b1", *_tables(Penalties(1, 0, 1), 200, 96, -1, random_pairs(
            rng, 1, 200, 200, 0.2, n_rate=0.0, empty_rate=0.0))),
    ]
    exact_tb = traceback_torch.TracebackConfig(pen, 64, 120, banded=False)
    band_tb = traceback_torch.TracebackConfig(pen, 64, 120, banded=True,
                                              lo_pad=engine_torch.lo_pad(120))
    cases.append(("forged-exact", exact_tb, *forged_walks(rng, exact_tb, 37)))
    cases.append(("forged-banded", band_tb, *forged_walks(rng, band_tb, 37)))
    # lo_pad 64 below the rows' 8 * 17 scores: reads past it clamp to 63.
    short_tb = traceback_torch.TracebackConfig(pen, 64, 120, banded=True, lo_pad=64)
    cases.append(("forged-lo-pad", short_tb, *forged_walks(rng, short_tb, 37)))
    overflow = overflow_walks()
    assert overflow[0].opw * 16 == 2048 and overflow[0].num_chunks == 129
    cases.append(("overflow", *overflow))
    assert tuple(c[0] for c in cases) == NAMES
    return {c[0]: c for c in cases}


@pytest.mark.parametrize("name", NAMES)
def test_model_equals_plain_walk(name):
    _, tb, words, lo, dist, fin, tk = traceback_cases()[name]
    want = traceback_torch.traceback_batch_device(tb, words, lo, dist, fin, tk)
    ops, n_ops, stats, walks = model_batch(tb, words, lo, dist, fin, tk)
    np.testing.assert_array_equal(n_ops, want["n_ops"].numpy())
    np.testing.assert_array_equal(ops, want["ops"].numpy().astype(np.int64) & 0xFFFFFFFF)
    for w in walks:
        assert w.loads == w.rows + w.misses + w.unentered
        assert w.cold <= w.rows
    if name in ("banded-narrow", "exact", "exact-edges"):
        walked = fin & (dist > 0)
        assert bool((want["n_ops"][walked] > 0).all())


def test_cases_reach_what_they_are_for():
    """Each stress case does what it is named for: re-centres move lo past
    the window (misses), walks start within 6 diagonals of each end of the
    row, the forged tables give corrupt walks, reads past lo_pad happen and
    the stream overflows."""
    by = traceback_cases()

    def run(name):
        tb, words, lo, dist, fin, tk = by[name][1:]
        return model_batch(tb, words, lo, dist, fin, tk)

    assert run("banded-narrow")[2][:, 2].sum() > 0
    tb, _, _, dist, fin, tk = (by["exact-edges"][i] for i in (1, 2, 3, 4, 5, 6))
    j0 = (tk + tb.wf_width // 2)[fin & (dist > 0)]
    assert int(j0.min()) <= 6 and int(j0.max()) >= tb.wf_width - 6
    for name in ("forged-exact", "forged-banded", "forged-lo-pad"):
        assert (run(name)[1] == -1).sum() > 0
    tb, dist = by["forged-lo-pad"][1], by["forged-lo-pad"][4]
    assert bool(((dist >= tb.lo_pad) & (dist >> 3 < tb.num_chunks)).any())
    assert run("overflow")[1].tolist() == [2000, -1, -1]
    assert by["exact-b1"][4].shape[0] == 1
