#!/usr/bin/env python3
"""Band-width recall on Nanopore-like 20 kbp reads, on the PyTorch/CUDA port.

The port's counterpart of ``tools/nanopore_recall.py``, with the same modes,
reads and printed lines; it imports no jax, nothing of ``wfa_tpu`` and not
``bench``.

    python3 tools/torch_nanopore_recall.py            # on the card
    python3 tools/torch_nanopore_recall.py --burst    # on the card
    python3 tools/torch_nanopore_recall.py --small    # on the CPU
    python3 tools/torch_nanopore_recall.py --small20  # on the CPU

The default mode and ``--burst`` align 128 pairs of 20 kbp (seed 7) on the
card: uniform 6% error, or 1% background error plus three 200-500 bp indel
or high-error events a read.  The exact reference distances come from K4 at
W=6144, where a distance below o + e*(W/2+1) = 3076 (penalties 2,3,1) is
certified optimal; every pair must be certified, and a sample is held
against the native CPU oracle.  Then K1 runs banded (band 25) at W = 128,
256, 512 and 1024, and each width prints how many pairs finished, how many
scored the optimum and the largest inflation; then the same lines at the
wide widths, W = 2048 (K1) and 4096 (banded K4: wider than a block's
shared memory holds as a ring).  Without a CUDA device these modes exit
nonzero; they never run on the CPU.

``--small`` (12 x 3 kbp, two 100-300 bp events a read) and ``--small20``
(8 x 20 kbp burst reads) run the plain PyTorch engine on the CPU at the odd
widths 129, 257, 513 (and 1025), against CPU-oracle distances, as the JAX
tool runs its XLA engine on the CPU; K1 takes only multiples of 32.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from wfa_tpu_torch import Penalties, native
from wfa_tpu_torch.ops import engine_cuda, engine_torch
from wfa_tpu_torch.ops.packing import pack_batch
from wfa_tpu_torch.utils.synth import mutate_batch, mutate_bursts

PENALTIES = Penalties(2, 3, 1)
BAND = 25
MAX_STEPS = 5000
EXACT_WIDTH = 6144
CARD_WIDTHS = (128, 256, 512, 1024)
# Banded widths past 1024: K1 at 2048, banded K4 at 4096 on an H100.
WIDE_WIDTHS = (2048, 4096)
# A distance below this leaves the centred +-W/2 window of the exact pass
# never, so it is optimal (3076 at W=6144).
CERT_BOUND = PENALTIES.o + PENALTIES.e * (EXACT_WIDTH // 2 + 1)
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def long_reads(burst: bool, n: int = 128, length: int = 20000, seed: int = 7):
    """``(patterns, texts, rng)``: ``n`` random patterns of ``length`` bases
    and their texts at 6% error (``burst``: 1% and three events), and the
    generator after those draws, from which the JAX tool draws the pairs it
    cross-checks."""
    rng = np.random.default_rng(seed)
    pats = [rng.choice(_BASES, size=length).tobytes() for _ in range(n)]
    txts = mutate_bursts(rng, pats) if burst else mutate_batch(rng, pats, 0.06)
    return pats, txts, rng


def tensors(pats, txts, nwords: int, device):
    """The packed batch on ``device``: ``(pat, txt, plen, tlen, valid)``."""
    pat, plen, vp = pack_batch(pats, nwords)
    txt, tlen, vt = pack_batch(txts, nwords)
    return engine_torch.batch_to_tensors(pat, plen, txt, tlen, vp & vt, device)


def card_words(pats, txts) -> int:
    """Packed words a row on the card: the JAX tool's ``nwp``, the longest
    read's words plus 16, rounded up to 128."""
    lmax = max(max(len(p), len(t)) for p, t in zip(pats, txts))
    return ((lmax // 16 + 16 + 127) // 128) * 128


def exact_config() -> engine_torch.EngineConfig:
    """K4's certified exact pass: the JAX tool's ``score_cap = CERT_BOUND +
    1`` is ``score_limit = CERT_BOUND`` here (the loop runs while d <
    score_cap)."""
    return engine_torch.EngineConfig(PENALTIES, MAX_STEPS, EXACT_WIDTH, -1,
                                     score_limit=CERT_BOUND, ring_global=True)


def banded_config(width: int, max_steps: int = MAX_STEPS) -> engine_torch.EngineConfig:
    return engine_torch.EngineConfig(PENALTIES, max_steps, width, BAND)


def wide_config(width: int, device, cigar: bool = False) -> engine_torch.EngineConfig:
    """``banded_config(width)`` on ``device``'s kernels: K1 (K2) where a
    block's shared memory holds the ring, else banded K4 (``ring_global``),
    as ``align_pairs`` plans it."""
    smem = engine_cuda.smem_optin(device)
    ring = width > engine_cuda.max_width(PENALTIES.active_working_set, smem, cigar)
    return dataclasses.replace(banded_config(width), ring_global=ring)


def wide_recall(res: dict, device) -> dict:
    """K1/K4 banded at ``WIDE_WIDTHS`` on ``card_recall``'s packed reads:
    each width's output (``outs``) and ``recall_row`` (``rows``)."""
    outs = {w: engine_cuda.align_batch_cuda(wide_config(w, device), *res["args"])
            for w in WIDE_WIDTHS}
    return {"outs": outs,
            "rows": [recall_row(w, o, res["exact"]) for w, o in outs.items()]}


def recall_row(width: int, out: dict, exact: np.ndarray) -> tuple[int, int, int, int]:
    """``(width, finished, score == optimal, largest inflation)`` of one
    banded run against the exact distances."""
    d = out["distance"].cpu().numpy()
    f = out["finished"].cpu().numpy()
    opt = (d == exact) & f
    return width, int(f.sum()), int(opt.sum()), int((d - exact)[f].max(initial=0))


def row_line(row: tuple[int, int, int, int], n: int) -> str:
    width, fin, opt, infl = row
    return (f"band width {width:4d}: finished {fin}/{n}, score==optimal "
            f"{opt}/{n} ({100.0 * opt / n:.1f}%), max inflation {infl}")


def card_recall(burst: bool, device, n_check: int = 4) -> dict:
    """The default (``burst``: ``--burst``) mode on ``device``, a CUDA
    device: K4's certified exact distances, ``n_check`` of them held
    against the CPU oracle, and K1 banded at ``CARD_WIDTHS``.  Returns the
    reads, the packed ``args``, ``exact`` (numpy), ``checked`` (the pairs
    the oracle saw), ``outs`` (K1's output at each width) and ``rows``
    (``recall_row`` at each width).  Raises RuntimeError if a pair is not
    certified or the oracle disagrees."""
    if device.type != "cuda":
        raise RuntimeError(f"the card modes run on a CUDA device, not {device}")
    pats, txts, rng = long_reads(burst)
    n = len(pats)
    args = tensors(pats, txts, card_words(pats, txts), device)
    out = engine_cuda.align_batch_cuda(exact_config(), *args)
    exact = out["distance"].cpu().numpy()
    certified = out["finished"].cpu().numpy() & (exact < CERT_BOUND)
    if not certified.all():
        raise RuntimeError(f"exact pass uncertified: pairs "
                           f"{np.flatnonzero(~certified).tolist()}")
    checked = rng.choice(n, size=n_check, replace=False)
    oracle, _, _ = native.cpu_align_batch(
        [pats[i] for i in checked], [txts[i] for i in checked], PENALTIES,
        np.ones(n_check, dtype=np.int8), False)
    if oracle.tolist() != exact[checked].tolist():
        raise RuntimeError(f"K4 and the CPU oracle differ on pairs {checked.tolist()}: "
                           f"{exact[checked].tolist()} against {oracle.tolist()}")
    outs = {w: engine_cuda.align_batch_cuda(banded_config(w), *args)
            for w in CARD_WIDTHS}
    return {"patterns": pats, "texts": txts, "args": args, "exact": exact,
            "checked": checked, "outs": outs,
            "rows": [recall_row(w, o, exact) for w, o in outs.items()]}


def _plain_rows(pats, txts, exact, widths, max_steps, timed=False):
    """The plain engine on the CPU, banded at each width: the printed lines
    and ``recall_row``s."""
    lmax = max(max(len(p), len(t)) for p, t in zip(pats, txts))
    args = tensors(pats, txts, lmax // 16 + 2, "cpu")
    rows = []
    for width in widths:
        t0 = time.time()
        out = engine_torch.align_batch_device(banded_config(width, max_steps), *args)
        rows.append(recall_row(width, out, exact))
        print(row_line(rows[-1], len(pats))
              + (f"  [{time.time() - t0:.0f}s]" if timed else ""), flush=True)
    return rows


def small() -> list[tuple[int, int, int, int]]:
    """``--small``: 12 x 3 kbp reads at 1% error with two 100-300 bp events
    each, the plain engine at W = 129, 257, 513 (max_steps 2500)."""
    rng = np.random.default_rng(7)
    pats = [rng.choice(_BASES, size=3000).tobytes() for _ in range(12)]
    txts = mutate_bursts(rng, pats, n_bursts=2, indel=(100, 301),
                         patch=(50, 200), tail=400)
    exact = np.array([native.cpu_align_single(p, t, PENALTIES)
                      for p, t in zip(pats, txts)])
    print(f"exact (CPU oracle): {exact.min()}..{exact.max()}", flush=True)
    return _plain_rows(pats, txts, exact, (129, 257, 513), 2500)


def small20() -> list[tuple[int, int, int, int]]:
    """``--small20``: 8 x 20 kbp burst reads, the plain engine at W = 129,
    257, 513, 1025 (max_steps the largest exact distance + 1200)."""
    pats, txts, _ = long_reads(True, n=8)
    t0 = time.time()
    exact = np.array([native.cpu_align_single(p, t, PENALTIES)
                      for p, t in zip(pats, txts)])
    print(f"exact (CPU oracle): {exact.min()}..{exact.max()} "
          f"({time.time() - t0:.1f}s)", flush=True)
    return _plain_rows(pats, txts, exact, (129, 257, 513, 1025),
                       int(exact.max()) + 1200, timed=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--burst", action="store_true",
                      help="burst reads on the card (1%% error plus three events)")
    mode.add_argument("--small", action="store_true",
                      help="12 x 3 kbp burst reads, plain engine on the CPU")
    mode.add_argument("--small20", action="store_true",
                      help="8 x 20 kbp burst reads, plain engine on the CPU")
    args = ap.parse_args(argv)
    if args.small:
        small()
        return 0
    if args.small20:
        small20()
        return 0
    if not torch.cuda.is_available():
        print("torch_nanopore_recall: the default and --burst modes need a CUDA "
              "device (--small and --small20 run on the CPU)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    res = card_recall(args.burst, device)
    exact = res["exact"]
    print(f"exact distances: {exact.min()}..{exact.max()} (all certified)")
    for row in res["rows"]:
        print(row_line(row, len(exact)))
    for row in wide_recall(res, device)["rows"]:
        print(row_line(row, len(exact)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
