#!/usr/bin/env python
"""Standalone CIGAR output validator, on the PyTorch/CUDA port.

The port's counterpart of ``tools/check_cigars.py``, on ``wfa_tpu_torch``'s
readers and verification alone (no jax, nothing of ``wfa_tpu``), and the
equivalent of the reference's tests/tools/check_cigars.py: parse an aligner
output file (lines of ``score<TAB>cigar[<TAB>pattern<TAB>text]``), replay
every run-length CIGAR against its sequences, recompute the gap-affine score,
and report correct/incorrect counts.

Sequences come either from the output file itself (``-O`` verbose outputs) or
from the original ``.seq`` input via ``--seq``.

Usage:
    python tools/torch_check_cigars.py out.txt --seq pairs.seq -g 2,3,1
    python tools/torch_check_cigars.py verbose_out.txt -g 2,3,1
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from wfa_tpu_torch.types import Penalties
from wfa_tpu_torch.utils.io import read_seq_file
from wfa_tpu_torch.utils.verification import affine_score, check_cigar


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("output", help="aligner output file")
    ap.add_argument("--seq", help=".seq input file with the aligned pairs")
    ap.add_argument("-g", "--affine-penalties", default="2,3,1",
                    help="penalties x,o,e used for the run")
    args = ap.parse_args(argv)

    x, o, e = (int(v) for v in args.affine_penalties.split(","))
    pen = Penalties(abs(x), abs(o), abs(e))

    batch = read_seq_file(args.seq) if args.seq else None

    ncorrect = nincorrect = 0
    with open(args.output) as f:
        for i, line in enumerate(f):
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            score = int(parts[0])
            cigar = parts[1]
            if len(parts) >= 4:
                pattern, text = parts[2].encode(), parts[3].encode()
            elif batch is not None and i < len(batch):
                pattern, text = batch.patterns[i], batch.texts[i]
            else:
                print(f"line {i}: no sequences available", file=sys.stderr)
                nincorrect += 1
                continue
            ok = check_cigar(cigar, pattern, text)
            ok = ok and affine_score(cigar, pen) == -score
            ncorrect += ok
            nincorrect += not ok
            if not ok:
                print(f"line {i}: INCORRECT (score {score}, cigar "
                      f"{cigar[:40]}...)", file=sys.stderr)

    print(f"correct={ncorrect} incorrect={nincorrect}")
    return 1 if nincorrect else 0


if __name__ == "__main__":
    sys.exit(main())
