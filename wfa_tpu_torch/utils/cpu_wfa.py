"""Pure-Python scalar WFA, the CPU fallback when the native library is not
built.  The port's own copy of ``wfa_tpu/utils/cpu_wfa.py``: the same
recurrence and tie-breaking as native/wfa_cpu.cpp; slow but exact.
"""
from __future__ import annotations

import numpy as np

from ..traceback import ops_to_cigar
from ..types import AffineOp, Penalties

_NULL = -(1 << 28)


def align_one_py(
    pattern: bytes, text: bytes, pen: Penalties, want_cigar: bool
) -> tuple[int, str | None]:
    x, o, e = pen.x, pen.o, pen.e
    plen, tlen = len(pattern), len(text)
    target_k = tlen - plen
    p = np.frombuffer(pattern, dtype=np.uint8).astype(np.int16)
    t = np.frombuffer(text, dtype=np.uint8).astype(np.int16)

    def extend(k: int, off: int) -> int:
        v, h = off - k, off
        if off < 0 or v > plen or h > tlen:
            return _NULL
        m = min(plen - v, tlen - h)
        neq = np.nonzero(p[v : v + m] != t[h : h + m])[0]
        return off + (int(neq[0]) if neq.size else m)

    ring = max(o + e, x) + 1
    wfs: list[dict | None] = [None] * ring
    w0 = {
        "lo": 0, "hi": 0,
        "m": np.array([extend(0, 0)]),
        "i": np.array([_NULL]), "d": np.array([_NULL]),
    }
    wfs[0] = w0
    m_exist = [True]
    i_exist = [False]
    choices: list[np.ndarray | None] = [None]
    choice_lo = [0]

    def cigar_from(d_final: int) -> str:
        ops_rev = []
        mat, d, k = 0, d_final, target_k
        while d > 0:
            c = int(choices[d][k - choice_lo[d]])
            if mat == 0:
                ops_rev.append(AffineOp.SUB)
                mc = c & 3
                if mc == 0:
                    d -= x
                elif mc == 1:
                    mat = 1
                else:
                    mat = 2
            elif mat == 1:
                ops_rev.append(AffineOp.INS)
                if c & 4:
                    d -= e
                else:
                    mat = 0
                    d -= o + e
                k -= 1
            else:
                ops_rev.append(AffineOp.DEL)
                if c & 8:
                    d -= e
                else:
                    mat = 0
                    d -= o + e
                k += 1
        ops_rev.reverse()
        return ops_to_cigar(ops_rev, pattern, text)

    if target_k == 0 and w0["m"][0] == tlen:
        return 0, (f"{tlen}M" if want_cigar else None)

    def read(wf, key, ks):
        if wf is None:
            return np.full(ks.shape, _NULL)
        idx = ks - wf["lo"]
        ok = (idx >= 0) & (idx <= wf["hi"] - wf["lo"])
        vals = wf[key][np.clip(idx, 0, wf["hi"] - wf["lo"])]
        return np.where(ok, vals, _NULL)

    hard_cap = (plen + tlen + 4) * max(x, o + e) + o + 8
    for d in range(1, hard_cap + 1):
        gap = (d - o - e >= 0 and m_exist[d - o - e]) or (
            d - e >= 0 and i_exist[d - e]
        )
        m = gap or (d - x >= 0 and m_exist[d - x])
        i_exist.append(gap)
        m_exist.append(m)
        choices.append(None)
        choice_lo.append(0)
        if not m:
            continue
        wx = wfs[(d - x) % ring] if d - x >= 0 and m_exist[d - x] else None
        woe = wfs[(d - o - e) % ring] if d - o - e >= 0 and m_exist[d - o - e] else None
        wie = wfs[(d - e) % ring] if d - e >= 0 and i_exist[d - e] else None

        if gap:
            hi_id = max(
                woe["hi"] if woe else _NULL, wie["hi"] if wie else _NULL
            ) + 1
            lo_id = min(
                woe["lo"] if woe else -_NULL, wie["lo"] if wie else -_NULL
            ) - 1
            hi = max(wx["hi"] if wx else _NULL, hi_id)
            lo = min(wx["lo"] if wx else -_NULL, lo_id)
        else:
            hi, lo = wx["hi"], wx["lo"]
        lo = max(lo, -plen - 1)
        hi = min(hi, tlen + 1)
        if hi < lo:
            continue
        ks = np.arange(lo, hi + 1)

        i_open = read(woe, "m", ks - 1) + 1
        i_ext = read(wie, "i", ks - 1) + 1
        ipb = np.maximum((i_open << 2) | 1, (i_ext << 2) | 2)
        ivals = ipb >> 2
        d_open = read(woe, "m", ks + 1)
        d_ext = read(wie, "d", ks + 1)
        dpb = np.maximum((d_open << 2) | 1, (d_ext << 2) | 2)
        dvals = dpb >> 2
        xvals = read(wx, "m", ks) + 1
        mpb = np.maximum(
            np.maximum((xvals << 2) | 2, (dvals << 2) | 3), (ivals << 2) | 1
        )
        mcand = mpb >> 2
        mvals = np.array([extend(int(k), int(c)) for k, c in zip(ks, mcand)])

        if want_cigar:
            mop = mpb & 3
            mc = np.where(mop == 2, 0, np.where(mop == 1, 1, 2)).astype(np.uint8)
            ch = mc | (((ipb & 3) == 2).astype(np.uint8) << 2) | (
                ((dpb & 3) == 2).astype(np.uint8) << 3
            )
            choices[d] = ch
            choice_lo[d] = lo

        wfs[d % ring] = {"lo": lo, "hi": hi, "m": mvals, "i": ivals, "d": dvals}

        if abs(target_k) <= d and lo <= target_k <= hi:
            if mvals[target_k - lo] == tlen:
                return d, (cigar_from(d) if want_cigar else None)
    raise RuntimeError("WFA fallback did not converge")
