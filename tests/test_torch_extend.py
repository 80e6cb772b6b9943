"""K1's and K2's warp-cooperative extension and their row placement, on the CPU.

The kernels (wfa_tpu_torch/ops/csrc/wfa_distance.cu) cannot run here.  What
they compute can: ``_warp_extend`` below states ``extend_warp``'s rule for
one warp of 32 lanes in numpy, ballot for ballot (each lane's first 16-base
compare, then each lane whose run goes on served in turn by the whole warp,
32 words a round, ended by the first word with fewer than 16 equal bases,
with the kernel's clamps and tail rule), and is held equal to the plain
engine's extension ``engine_torch._extend`` on seeded inputs.  The shared-memory arithmetic of
the row placement is held to values worked by hand.  Every comparison is
exact."""
import numpy as np
import pytest
import torch

from wfa_tpu_torch.ops import engine_cuda, engine_torch
from wfa_tpu_torch.ops.packing import pack_batch
from wfa_tpu_torch.types import OFFSET_NULL
from wfa_tpu_torch.utils.synth import long_run_pairs

torch.set_num_threads(2)

H100_SMEM = 232448  # bytes a block may opt in to on an H100
_BASES = b"ACGT"
_MASK = 0xFFFFFFFF


def _clz(x: int) -> int:
    return 32 - x.bit_length()


def _load16(row: np.ndarray, nw: int, pos: int) -> int:
    """csrc load16: the funnel shift of words pos>>4 and pos>>4 + 1, words
    past the row read as zero."""
    idx = pos >> 4
    hi = int(row[idx]) if idx < nw else 0
    lo = int(row[idx + 1]) if idx + 1 < nw else 0
    sh = 2 * (pos & 15)
    return ((hi << sh) | (lo >> (32 - sh))) & _MASK if sh else hi


def _match16(pat, txt, nw, plen, tlen, v, h) -> int:
    """csrc match16: equal bases of the 16 at v and h, each clamped to
    [0, its length]; bases past either end are mismatches."""
    vc = min(max(v, 0), plen)
    hc = min(max(h, 0), tlen)
    diff = _load16(pat, nw, vc) ^ _load16(txt, nw, hc)
    return min(_clz(diff) >> 1, min(plen - vc, tlen - hc))


def _warp_extend(offs, ks, go, pat, txt, nw, plen, tlen):
    """csrc extend_warp for one warp: (results of the 32 lanes, the 512-base
    rounds the whole warp ran for the lanes it served)."""
    v = [o - k for o, k in zip(offs, ks)]
    h = list(offs)
    invalid = [o < 0 or vv > plen or hh > tlen for o, vv, hh in zip(offs, v, h)]
    acc = [0] * 32
    more = [False] * 32
    for lane in range(32):
        if go[lane] and not invalid[lane] and v[lane] < plen and h[lane] < tlen:
            acc[lane] = _match16(pat, txt, nw, plen, tlen, v[lane], h[lane])
            v[lane] += acc[lane]
            h[lane] += acc[lane]
            more[lane] = acc[lane] == 16 and v[lane] < plen and h[lane] < tlen
    rounds = 0
    for src in [lane for lane in range(32) if more[lane]]:   # the ballot, in __ffs order
        sv, sh, run = v[src], h[src], 0
        while True:
            rounds += 1
            eq = [_match16(pat, txt, nw, plen, tlen, sv + 16 * i, sh + 16 * i)
                  for i in range(32)]
            short = [i for i in range(32) if eq[i] != 16]
            if short:
                run += 16 * short[0] + eq[short[0]]
                break
            run += 512
            sv += 512
            sh += 512
            if sv >= plen or sh >= tlen:
                break
        acc[src] += run
    out = [OFFSET_NULL if bad else o + a for o, a, bad in zip(offs, acc, invalid)]
    return out, rounds


def _packed(pairs):
    nw = max(max(len(p), len(t)) for p, t in pairs) // 16 + 2
    pat, plen, _ = pack_batch([p for p, _ in pairs], nw)
    txt, tlen, _ = pack_batch([t for _, t in pairs], nw)
    return np.asarray(pat, np.uint32), np.asarray(txt, np.uint32), plen, tlen, nw


def _plain(offs, ks, pat, txt, plen, tlen):
    """engine_torch._extend on [B, 32] lanes, its inputs as
    align_batch_device builds them (one zero pad word a row)."""
    def words(a):
        t = torch.from_numpy(a.astype(np.int64))
        return torch.cat([t, torch.zeros((t.shape[0], 1), dtype=torch.int64)], 1)

    return engine_torch._extend(
        torch.tensor(offs, dtype=torch.int32), torch.tensor(ks, dtype=torch.int32),
        words(pat), words(txt),
        torch.tensor(plen, dtype=torch.int32)[:, None],
        torch.tensor(tlen, dtype=torch.int32)[:, None],
    ).tolist()


def _check(pairs, lanes, go=None):
    """Each pair's 32 (offset, diagonal) lanes through the warp model and
    the plain extension; returns the warp model's rounds."""
    pat, txt, plen, tlen, nw = _packed(pairs)
    go = go or [[True] * 32 for _ in pairs]
    offs = [[o for o, _ in row] for row in lanes]
    ks = [[k for _, k in row] for row in lanes]
    want = _plain(offs, ks, pat, txt, plen, tlen)
    rounds = []
    for b in range(len(pairs)):
        got, r = _warp_extend(offs[b], ks[b], go[b], pat[b], txt[b], nw,
                              int(plen[b]), int(tlen[b]))
        for lane in range(32):
            if go[b][lane] or got[lane] == OFFSET_NULL:
                assert got[lane] == want[b][lane], (b, lane, offs[b][lane], ks[b][lane])
        rounds.append(r)
    return rounds


def _with_mismatches(rng, length, positions):
    """A random pattern and the text with a substitution at each position."""
    pat = bytearray(_BASES[i] for i in rng.integers(0, 4, length))
    txt = bytearray(pat)
    for p in positions:
        txt[p] = _BASES[(_BASES.index(txt[p]) + 1) % 4]
    return bytes(pat), bytes(txt)


def test_runs_of_given_lengths_on_diagonal_zero():
    """Runs of 15, 16, 17, 511, 512, 513 and 2100 bases start at the lanes'
    offsets (mismatches end each); one run ends exactly at the sequences'
    common end (37 bases; 3,744 in all); the rest of the warp starts at
    random offsets of diagonal 37, where runs are short."""
    rng = np.random.default_rng(6)
    runs = [15, 16, 17, 511, 512, 513, 2100]
    starts, mism = [], []
    pos = 0
    for r in runs:
        starts.append(pos)
        mism.append(pos + r)
        pos += r + 1
    length = pos + 37
    pair = _with_mismatches(rng, length, mism)
    lanes = [(o, 0) for o in starts + [pos]]
    lanes += [(int(v), 37) for v in rng.integers(37, length, 32 - len(lanes))]
    lone = [(starts[-1], 0)] + lanes[len(starts) + 1:]
    lone += [(40 + i, 37) for i in range(32 - len(lone))]
    rounds = _check([pair, pair], [lanes, lone])
    # One round of the warp for each run past 16 bases, five for the
    # 2100-base run (the serial loop ran 132 rounds for it): 11; alone, 5.
    assert rounds == [11, 5]


def test_runs_to_either_end_and_offsets_at_the_ends():
    """The text a prefix of the pattern (runs end at tlen), the pattern a
    prefix of the text (at plen), identical pairs; offsets on every
    diagonal from -40 to 40 including v == plen, h == tlen, v > plen,
    h > tlen and negative offsets (NULL)."""
    rng = np.random.default_rng(7)
    base = bytes(_BASES[i] for i in rng.integers(0, 4, 3003))
    pairs = [(base, base[:2990]), (base[:2981], base), (base, base),
             (base[:1000], base[:1000])]
    lanes = []
    for p, t in pairs:
        plen, tlen = len(p), len(t)
        row = [(tlen, tlen - plen), (plen, 0), (tlen + 1, tlen - plen),
               (plen + 5, 0), (-1, 0), (-7, -3), (0, 0), (0, -5), (3, 5),
               (tlen - 1, tlen - plen), (tlen - 16, tlen - plen),
               (tlen - 17, tlen - plen), (tlen - 512, tlen - plen),
               (tlen - 513, tlen - plen)]
        row += [(int(o), int(k)) for o, k in zip(rng.integers(-20, tlen + 20, 32),
                                                 rng.integers(-40, 41, 32))]
        lanes.append(row[:32])
    _check(pairs, lanes)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_long_run_pairs_and_idle_lanes(seed):
    """``utils.synth.long_run_pairs`` (the kernels' long-run cases on the
    card), offsets near each pair's path, a third of the lanes idle: an idle
    lane never joins the served lanes, so a busy one's result cannot change."""
    rng = np.random.default_rng(seed)
    pairs = long_run_pairs(rng, 6)
    lanes, go = [], []
    for p, t in pairs:
        k0 = len(t) - len(p)
        offs = rng.integers(0, max(len(t), 1), 32)
        ks = [int(k) for k in rng.integers(-2, 3, 32) + (k0 if rng.random() < 0.5 else 0)]
        lanes.append([(int(min(o, len(p) + k)), k) for o, k in zip(offs, ks)])
        go.append([bool(g) for g in rng.random(32) > 0.33])
    _check(pairs, lanes, go)


def test_homopolymer_warp_serves_every_lane():
    """Homopolymers of unequal length: every lane's run goes past 16 bases,
    so the warp serves all 32 in turn; lengths not multiples of 16."""
    pairs = [(b"A" * 1999, b"A" * 2003), (b"C" * 517, b"C" * 517 + b"G")]
    lanes = [[(lane * 7, lane - 16) for lane in range(32)] for _ in pairs]
    rounds = _check(pairs, lanes)
    assert rounds[0] >= 32


def test_row_placement_arithmetic():
    """The HiFi tier (W=512, band 25, A=5, 1025 words a row) stages its rows
    beside the ring; the widest exact shared ring (W=3840) cannot for a
    10 kbp tier and can for rows of at most 217 words."""
    ring = 3 * 5 * 512 + 2 * 5 + 66
    assert engine_cuda.smem_bytes(5, 512, nwords=1025) == 4 * (ring + 2 * 1026) == 39232
    assert engine_cuda.smem_bytes(5, 512, True, nwords=1025) == 39232 + 4 * 512
    assert engine_cuda.rows_fit(5, 512, 1025, False, H100_SMEM)
    assert engine_cuda.rows_fit(5, 512, 1025, True, H100_SMEM)
    # W=3840: the ring alone takes 230,704 of the 232,448 bytes.
    assert engine_cuda.smem_bytes(5, 3840) == 230704
    assert engine_cuda.smem_bytes(5, 3840, nwords=1025) == 238912
    assert not engine_cuda.rows_fit(5, 3840, 1025, False, H100_SMEM)
    assert engine_cuda.smem_bytes(5, 3840, nwords=217) == H100_SMEM
    assert engine_cuda.rows_fit(5, 3840, 217, False, H100_SMEM)
    assert not engine_cuda.rows_fit(5, 3840, 218, False, H100_SMEM)
    # K2's widest exact ring, W=3584: rows of at most 345 words.
    assert engine_cuda.rows_fit(5, 3584, 345, True, H100_SMEM)
    assert not engine_cuda.rows_fit(5, 3584, 346, True, H100_SMEM)
    # max_width and K4's block are unchanged by the placement.
    assert engine_cuda.max_width(5, H100_SMEM) == 3840
    assert engine_cuda.smem_bytes(5, 6016, False, True, 3712, 1025) == (
        4 * (15 * 3712 + 76 + 2 * 1026))
