"""API walkthrough of the PyTorch/CUDA port with manually tuned options.

The port's counterpart of examples/manual_example.py (the reference's
examples/manual_example.c): the full tuning surface — max_error, banded
(heuristic) execution with an explicit band width and re-centering interval,
batch size for the streaming pipeline, backend selection, and distance-only
mode.

Run:  python examples/torch_manual_example.py [--backend auto|cuda|torch]

``auto`` (the default) and ``cuda`` need a CUDA device; ``torch`` runs the
plain engine on the CPU.
"""
import argparse
import random
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from wfa_tpu_torch import AlignmentOptions, Penalties, align_pairs_pipelined
from wfa_tpu_torch.aligner import BACKENDS


def noisy_copy(rng: random.Random, seq: str, err: float) -> str:
    out = list(seq)
    for _ in range(int(len(seq) * err)):
        op = rng.choice("XID")
        pos = rng.randrange(max(1, len(out)))
        if op == "X":
            out[pos] = rng.choice("ACGT")
        elif op == "I":
            out.insert(pos, rng.choice("ACGT"))
        elif len(out) > 1:
            del out[pos]
    return "".join(out)


def make_batch(seed: int = 42, n: int = 64) -> tuple[list[bytes], list[bytes]]:
    """``n`` random 1 kbp patterns and their copies at 5% error."""
    rng = random.Random(seed)
    patterns, texts = [], []
    for _ in range(n):
        s = "".join(rng.choice("ACGT") for _ in range(1000))
        patterns.append(s.encode())
        texts.append(noisy_copy(rng, s, 0.05).encode())
    return patterns, texts


def options(backend: str) -> AlignmentOptions:
    return AlignmentOptions(
        penalties=Penalties(x=5, o=3, e=2),
        # Kernel step budget; pairs needing more error go to the CPU engine
        # (reference: wfa_alignment_options_t.max_error).
        max_error=400,
        # Adaptive band: window of `band_width` diagonals, re-centered every
        # `band` scores (reference: -B/-t flags; band=0 would mean auto=25).
        band=25,
        band_width=128,
        # Streaming pipeline batch (reference: wfagpu_set_batch_size).
        batch_size=32,
        compute_cigar=False,
        # "auto" and "cuda" run the CUDA kernels; "torch" the plain engine
        # on the CPU.
        backend=backend,
    )


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backend", choices=BACKENDS, default="auto")
    args = p.parse_args(argv)
    patterns, texts = make_batch()
    results = align_pairs_pipelined(patterns, texts, options(args.backend))

    on_dev = sum(r.finished_on_accelerator for r in results)
    print(f"aligned {len(results)} pairs ({on_dev} on the device engine)")
    for i in (0, 1, 2):
        print(f"pair {i}: score {-results[i].error}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
