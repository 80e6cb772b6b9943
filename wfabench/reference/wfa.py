"""The benchmark's plain reference: gap-affine distances in plain PyTorch,
batched over pairs, on any device.

It imports nothing of the program and takes nothing the program made: it
reads the sequences itself.  Exact mode gives the optimal gap-affine
distance (match 0, mismatch x, gap o + n*e), the quantity the program
promises in exact mode, by Gotoh's dynamic programme (``gotoh``), checked
against the reference project's golden scores.  Banded mode is the
adaptive band that the program promises at the same window width W and
re-centre interval, by the wavefront algorithm (``_run``): a frozen
transcription of the port's plain engine's rules (window growth, clamping
hi first, re-centring on the parent M[d-x] once it is W wide, the reference
project's tie-breaking of packed (offset, op) maxima), checked against the
stored W=512 scores of the HiFi pairs.  Parents are kept by score, not in
ring slots, and done pairs are not extended: only the distance is read.
The same loop with a narrow centred window is the exact configurations'
control (``run_window``).

``distances`` is the entry point.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

NULL = -32000           # "this wavefront cell does not exist"
_BIG = 2**20            # window bound standing in for a missing parent
_MASK32 = 0xFFFFFFFF
_MAX_CHUNKS = 256       # most 16-base chunks an extension pass compares
_INT32_MAX = 2**31 - 1
# ASCII -> 2-bit code; other bytes are refused.
_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i


@dataclasses.dataclass(frozen=True)
class Setting:
    """What the reference computes: penalties (x, o, e); ``band`` > 0 the
    adaptive band re-centred every ``band`` scores at ``wf_width``
    diagonals, else exact; ``max_steps`` the program's step budget (its
    ``max_error``), after which a banded pair is unfinished."""

    x: int
    o: int
    e: int
    max_steps: int
    band: int = -1
    wf_width: int = 0

    @property
    def banded(self) -> bool:
        return self.band > 0


def scores(x: int, o: int, e: int, max_steps: int,
           limit: int | None = None) -> list[tuple[int, bool, bool, bool]]:
    """The scores a WFA loop computes, in order, after score 0: (d, M[d-x]
    exists, M[d-o-e] exists, I/D[d-e] exist).  A score exists where a gap
    can open or extend into it (then it is a full M/I/D step) or M[d-x]
    exists.  Like the reference project's loop, only full steps count
    towards ``max_steps``, starting from 1, and the loop runs while fewer
    than ``max_steps - 1`` have been counted."""
    m_ok = {0: True}
    i_ok: dict[int, bool] = {}
    out = []
    d, steps = 1, 1
    while steps < max_steps - 1 and (limit is None or d <= limit):
        mx = m_ok.get(d - x, False)
        moe = m_ok.get(d - o - e, False)
        ide = i_ok.get(d - e, False)
        gap = moe or ide
        i_ok[d] = gap
        m_ok[d] = gap or mx
        if gap:
            steps += 1
        if gap or mx:
            out.append((d, mx, moe, ide))
        d += 1
    return out


def pack(seqs: list[bytes], nwords: int) -> torch.Tensor:
    """2-bit codes, 16 bases a 32-bit word with the first base in the top
    bits, as int64 [B, nwords + 1] (a zero word at the end)."""
    codes = np.zeros((len(seqs), (nwords + 1) * 16), dtype=np.int64)
    for b, s in enumerate(seqs):
        c = _CODE[np.frombuffer(s, np.uint8)]
        if (c == 255).any():
            raise ValueError("the reference takes only A, C, G and T")
        codes[b, : len(s)] = c
    weights = 4 ** np.arange(15, -1, -1, dtype=np.int64)
    return torch.from_numpy(codes.reshape(len(seqs), nwords + 1, 16) @ weights)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    _, bitlen = torch.frexp(x.to(torch.float64))
    return 32 - bitlen.to(torch.int64)


def _load16(words: torch.Tensor, row: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The 16 bases from base ``pos`` of row ``row``, as one 32-bit word."""
    last = words.shape[1] - 1
    flat = words.view(-1)
    base = row * words.shape[1]
    idx = pos >> 4
    sh = 2 * (pos & 15)
    w1 = flat[base + torch.clamp(idx, max=last)]
    w2 = flat[base + torch.clamp(idx + 1, max=last)]
    hi = (w1 << sh) & _MASK32
    lo = torch.where(sh == 0, torch.zeros_like(w2), w2 >> (32 - sh))
    return hi | lo


def _past_end(nxt: torch.Tensor, limit: torch.Tensor) -> torch.Tensor:
    """Bits of a 16-base chunk ending at ``nxt`` that lie past ``limit``."""
    sh = torch.clamp(2 * (nxt - limit), 0, 32)
    keep = torch.where(sh == 32, torch.zeros_like(sh), (_MASK32 << sh) & _MASK32)
    return ~keep & _MASK32


def extend(offs, k, pat, txt, plen, tlen, live=None) -> torch.Tensor:
    """Slide every diagonal's offset over matching bases.  ``offs`` int32
    [B, W] (text positions), ``k`` its diagonals, ``plen``/``tlen`` [B, 1];
    ``live`` [B, 1] (optional) leaves the other pairs' lanes as they are.
    Offsets outside the matrix become NULL.  The first pass compares 16
    bases on every lane; the lanes that matched them all go on with four
    times as many bases a pass, so that a long run costs few passes."""
    v = (offs - k).to(torch.int64)
    shape = v.shape
    h = offs.to(torch.int64).expand_as(v)
    pl = plen.to(torch.int64).expand_as(v)
    tl = tlen.to(torch.int64).expand_as(v)
    invalid = (h < 0) | (v > pl) | (h > tl)
    active = ~invalid & (v < pl) & (h < tl)
    if live is not None:
        active &= live
    acc = torch.zeros(v.numel(), dtype=torch.int64, device=v.device)
    lane = active.flatten().nonzero().squeeze(1)
    row = lane // shape[1]
    v, h = v.flatten()[lane], h.flatten()[lane]
    pl, tl = pl.flatten()[lane], tl.flatten()[lane]
    chunks = 1
    while lane.numel():
        step = 16 * torch.arange(chunks, dtype=torch.int64, device=v.device)
        p2, t2 = pl[:, None], tl[:, None]
        vc = torch.minimum(torch.clamp(v[:, None] + step, min=0), p2)
        hc = torch.minimum(torch.clamp(h[:, None] + step, min=0), t2)
        diff = _load16(pat, row[:, None], vc) ^ _load16(txt, row[:, None], hc)
        diff = diff | _past_end(vc + 16, p2) | _past_end(hc + 16, t2)
        eq = _clz32(diff) >> 1
        nfull = torch.cumprod((eq == 16).to(torch.int64), dim=1).sum(dim=1)
        part = torch.gather(eq, 1, torch.clamp(nfull, max=chunks - 1)[:, None])
        ext = 16 * nfull + torch.where(nfull < chunks, part[:, 0], 0)
        acc[lane] += ext
        v, h = v + ext, h + ext
        keep = ((nfull == chunks) & (v < pl) & (h < tl)).nonzero().squeeze(1)
        lane, row, v, h, pl, tl = (t[keep] for t in (lane, row, v, h, pl, tl))
        chunks = min(4 * chunks, _MAX_CHUNKS)
    out = offs + acc.view(shape).to(torch.int32)
    return torch.where(invalid, torch.full_like(offs, NULL), out)


def _gather(parent, rel, extent) -> torch.Tensor:
    """``parent`` read at per-pair shifted lanes; NULL outside [0, extent]."""
    oob = (rel < 0) | (rel > extent)
    vals = torch.gather(parent, 1, torch.clamp(rel, 0, parent.shape[1] - 1).long())
    return torch.where(oob, torch.full_like(vals, NULL), vals)


def _run(st: Setting, pats: list[bytes], txts: list[bytes], device,
         width: int, limit: int | None) -> tuple[np.ndarray, np.ndarray]:
    """One pass over a block: (distance, finished)."""
    B = len(pats)
    i32 = dict(dtype=torch.int32, device=device)
    lmax = max(max(len(p), len(t)) for p, t in zip(pats, txts))
    nw = lmax // 16 + 1
    pat, txt = pack(pats, nw).to(device), pack(txts, nw).to(device)
    plen = torch.tensor([len(p) for p in pats], **i32)[:, None]
    tlen = torch.tensor([len(t) for t in txts], **i32)[:, None]
    tk = (tlen - plen)[:, 0]
    W, W2 = width, width // 2
    null = torch.full((B, W), NULL, **i32)
    jr = torch.arange(W, **i32)[None, :]

    zero = torch.zeros((B, 1), **i32)
    init = extend(zero, zero, pat, txt, plen, tlen)[:, 0]
    M0 = null.clone()
    M0[:, 0 if st.banded else W2] = init
    done = (tk == 0) & (init == tlen[:, 0])
    fin = done.clone()
    dist = torch.zeros(B, **i32)
    lo0 = torch.zeros(B, **i32) if st.banded else None
    # score -> (M, I, D, lo, ext); I and D only where a gap exists.
    wf = {0: (M0, None, None, lo0, torch.zeros(B, **i32) if st.banded else None)}
    exact_k = jr - W2
    keep = max(st.x, st.o + st.e) + 1

    for n, (d, has_x, has_oe, has_e) in enumerate(scores(st.x, st.o, st.e,
                                                         st.max_steps, limit)):
        if n % 16 == 0 and bool(done.all()):
            break
        px = wf.get(d - st.x) if has_x else None
        poe = wf.get(d - st.o - st.e) if has_oe else None
        pe = wf.get(d - st.e) if has_e else None
        if st.banded:
            def bounds(p):
                if p is None:
                    big = torch.full((B,), _BIG, **i32)
                    return -big, big
                return p[3] + p[4], p[3]

            hx, lx = bounds(px)
            hoe, loe = bounds(poe)
            he, le = bounds(pe)
            hi_n = torch.maximum(hx, torch.maximum(hoe, he) + 1)
            lo_n = torch.minimum(lx, torch.minimum(loe, le) - 1)
            t = torch.clamp((hi_n - lo_n) - (W - 1), min=0)
            hi_n = hi_n - (t + 1) // 2
            lo_n = lo_n + t // 2
            if d % st.band == 0 and px is not None and (poe or pe):
                Mx, lo_x, ext_x = px[0], px[3], px[4]
                kx = lo_x[:, None] + jr
                d2t = torch.where(Mx >= 0,
                                  torch.maximum(plen - (Mx - kx), tlen - Mx),
                                  _INT32_MAX)
                d2t = torch.where(jr < ext_x[:, None], d2t, _INT32_MAX)
                cand = torch.cat([2 * (tlen + plen), d2t], dim=1)
                amin = torch.argmin(cand, dim=1).to(torch.int32)
                lo_rc = lo_x + torch.clamp(amin - 1, min=0) - W2
                rc = ext_x >= W - 1
                lo_n = torch.where(rc, lo_rc, lo_n)
                hi_n = torch.where(rc, lo_rc + W - 1, hi_n)
            ext_n = hi_n - lo_n

            def read(p, which, dk):
                if p is None or p[which] is None:
                    return null
                rel = (lo_n - p[3])[:, None] + jr + dk
                return _gather(p[which], rel, p[4][:, None])

            I_open, I_ext = read(poe, 0, -1) + 1, read(pe, 1, -1) + 1
            D_open, D_ext = read(poe, 0, +1), read(pe, 2, +1)
            X_off = read(px, 0, 0) + 1
            k_lane = lo_n[:, None] + jr
        else:
            # Only the lanes of the cone: leaving diagonal 0 by r costs at
            # least o + r * e.  The rest of the window stays NULL.
            R = min(W2, max(0, (d - st.o) // st.e) + 1)
            a, b = W2 - R, min(W, W2 + R + 1)

            def cone(p, which, dk):
                """Lanes a..b-1 of the parent's row, read at k + dk."""
                if p is None or p[which] is None:
                    return null[:, a:b]
                lo, hi = a + dk, b + dk
                part = p[which][:, max(lo, 0):min(hi, W)]
                return torch.nn.functional.pad(part, (max(0, -lo), max(0, hi - W)),
                                               value=NULL)

            I_open, I_ext = cone(poe, 0, -1) + 1, cone(pe, 1, -1) + 1
            D_open, D_ext = cone(poe, 0, 1), cone(pe, 2, 1)
            X_off = cone(px, 0, 0) + 1
            k_lane = exact_k[:, a:b]
            lo_n = torch.full((B,), -W2, **i32)
            ext_n = torch.full((B,), W - 1, **i32)

        # Maxima of (offset << 2 | op): on a tie a gap extends rather than
        # opens (2 > 1), and M takes DEL(3) over SUB(2) over INS(1).
        I_new = torch.maximum(I_open * 4 + 1, I_ext * 4 + 2) >> 2
        D_new = torch.maximum(D_open * 4 + 1, D_ext * 4 + 2) >> 2
        M_pb = torch.maximum(torch.maximum(X_off * 4 + 2, D_new * 4 + 3),
                             I_new * 4 + 1)
        M_new = extend(M_pb >> 2, k_lane, pat, txt, plen, tlen, ~done[:, None])
        if st.banded:
            live = jr <= ext_n[:, None]
            I_new = torch.where(live, I_new, NULL)
            D_new = torch.where(live, D_new, NULL)
            M_new = torch.where(live, M_new, NULL)
        else:
            rows = []
            for part in (M_new, I_new, D_new):
                full = null.clone()
                full[:, a:b] = part
                rows.append(full)
            M_new, I_new, D_new = rows
        at_t = _gather(M_new, (tk - lo_n)[:, None], ext_n[:, None])[:, 0]
        # Banded, a pair also stops where the target's offset is passed,
        # unfinished.
        reach = tk.abs() <= d
        hit = reach & (at_t == tlen[:, 0])
        newly = (reach & (at_t >= tlen[:, 0]) if st.banded else hit) & ~done
        fin = torch.where(newly, hit, fin)
        dist = torch.where(newly, d, dist)
        done = done | newly
        wf[d] = (M_new, I_new if has_oe or has_e else None,
                 D_new if has_oe or has_e else None, lo_n, ext_n)
        wf.pop(d - keep, None)
    return dist.cpu().numpy(), fin.cpu().numpy()


def gotoh(st: Setting, pats: list[bytes], txts: list[bytes],
          device="cpu") -> np.ndarray:
    """Optimal gap-affine distances by Gotoh's dynamic programme, a row of
    the pattern at a time for every pair at once: H the best cost, D a gap
    along the pattern, I a gap along the text, the latter from a running
    minimum, I[j] = o + e*j + min over k < j of (min(diag, D)[k] - e*k)."""
    B = len(pats)
    i32 = dict(dtype=torch.int32, device=device)
    n = torch.tensor([len(p) for p in pats], **i32)
    m = torch.tensor([len(t) for t in txts], dtype=torch.int64, device=device)
    N, Mx = int(n.max()), int(m.max())
    P = np.full((B, max(N, 1)), 4, dtype=np.uint8)
    T = np.full((B, Mx), 5, dtype=np.uint8)
    for b, (p, t) in enumerate(zip(pats, txts)):
        P[b, : len(p)] = np.frombuffer(p, np.uint8)
        T[b, : len(t)] = np.frombuffer(t, np.uint8)
    P, T = torch.from_numpy(P).to(device), torch.from_numpy(T).to(device)
    inf = 2**29
    ej = st.e * torch.arange(Mx + 1, **i32)[None, :]
    H = (st.o + ej).expand(B, Mx + 1).clone()
    H[:, 0] = 0
    D = torch.full((B, Mx + 1), inf, **i32)
    ans = H.gather(1, m[:, None])[:, 0]
    edge = torch.full((B, 1), inf, **i32)
    for i in range(1, N + 1):
        sub = torch.where(P[:, i - 1, None] == T, 0, st.x).to(torch.int32)
        D = torch.minimum(H + (st.o + st.e), D + st.e)
        G = torch.cat([D[:, :1], torch.minimum(H[:, :-1] + sub, D[:, 1:])], dim=1)
        run = torch.cummin(G - ej, dim=1).values
        I = st.o + ej + torch.cat([edge, run[:, :-1]], dim=1)
        H = torch.minimum(G, I)
        ans = torch.where(n == i, H.gather(1, m[:, None])[:, 0], ans)
    return ans.cpu().numpy().astype(np.int64)


def distances(st: Setting, pats: list[bytes], txts: list[bytes],
              device="cpu", block: int = 1024) -> tuple[np.ndarray, np.ndarray]:
    """(distance, finished) of every pair.

    Banded: the adaptive band at ``st.wf_width``, run for ``st.max_steps``
    as the program runs it, in blocks of ``block`` pairs; a pair it does not
    finish is reported so.  Exact: ``gotoh``, every pair finished."""
    if not st.banded:
        return gotoh(st, pats, txts, device), np.ones(len(pats), dtype=bool)
    dist = np.zeros(len(pats), dtype=np.int64)
    fin = np.zeros(len(pats), dtype=bool)
    for b0 in range(0, len(pats), block):
        idx = np.arange(b0, min(b0 + block, len(pats)))
        d, f = _run(st, [pats[i] for i in idx], [txts[i] for i in idx],
                    device, st.wf_width, None)
        dist[idx], fin[idx] = d, f
    return dist, fin


def run_window(st: Setting, pats: list[bytes], txts: list[bytes],
               device="cpu") -> tuple[np.ndarray, np.ndarray]:
    """What a centred window of ``st.wf_width`` diagonals finds up to the
    score ``st.max_steps``, with no certificate: where the optimal path
    leaves the window, a higher score or none.  The exact configurations'
    control."""
    run = dataclasses.replace(st, band=-1, max_steps=10**9)
    return _run(run, pats, txts, device, st.wf_width, st.max_steps)
