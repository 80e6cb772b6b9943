"""Minimal API walkthrough of the PyTorch/CUDA port with auto-derived options.

The port's counterpart of examples/auto_example.py (the reference's
examples/auto_example.c): create an aligner, add sequence pairs, align with
default (auto-derived) options, print score + CIGAR per pair.

Run:  python examples/torch_auto_example.py [--backend auto|cuda|torch]

``auto`` (the default) and ``cuda`` need a CUDA device; ``torch`` runs the
plain engine on the CPU.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from wfa_tpu_torch import AlignmentOptions, Penalties, WfaAligner
from wfa_tpu_torch.aligner import BACKENDS

PAIRS = [
    ("GATTACA", "GATCACA"),
    ("ACGTACGTACGTACGT", "ACGTACGTTCGTACGT"),
    (
        "TCTTTACTCGCGCGTTGGAGAAATACAATAGT",
        "TCTATACTGCGCGTTTGGAGAAATAAAATAGT",
    ),
]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backend", choices=BACKENDS, default="auto")
    args = p.parse_args(argv)
    # Options mirror wfagpu_set_default_options: penalties (x=2, o=3, e=1),
    # auto max_error from the first pair, CIGAR on.
    aligner = WfaAligner(AlignmentOptions(
        penalties=Penalties(2, 3, 1), compute_cigar=True, backend=args.backend,
    ))
    for pattern, text in PAIRS:
        aligner.add_sequences(pattern, text)

    results = aligner.align()
    for (pattern, text), res in zip(PAIRS, results):
        print(f"pattern: {pattern}")
        print(f"text:    {text}")
        print(f"score:   {-res.error}   cigar: {res.cigar}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
