"""Command-line aligner of the PyTorch/CUDA port (``wfa.affine.gpu``).

The flags and output format of ``wfa_tpu/cli.py`` (the reference CLI surface,
tools/aligner.c:60-187): one line ``-error<TAB>cigar`` per alignment, ``-O``
appends the pattern and text.  ``--backend`` takes ``auto``, ``torch`` or
``cuda``.  Distance mode only: ``-x`` and ``--profile`` are not supported yet.

    python -m wfa_tpu_torch.cli -i tests/data/wfa.utest.seq -g 1,2,1 -e 10000 -o scores.out
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from wfa_tpu import native
from wfa_tpu.cli import _parse_penalties
from wfa_tpu.params import AlignmentOptions
from wfa_tpu.utils.io import (
    SequenceBatch, read_fasta_pair, read_seq_file, write_alignments,
)
from wfa_tpu.utils.logger import LOG, set_verbosity
from wfa_tpu.utils.timers import timed

from .aligner import BACKENDS
from .ops._build import ensure_native
from .pipeline import align_pairs_pipelined
from .utils.device_query import describe


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="wfa.affine.gpu",
        description="Batch gap-affine pairwise alignment (WFA) on a CUDA GPU",
    )
    p.add_argument("-i", "--input-seq", help=".seq file (alternating >pattern / <text lines)")
    p.add_argument("-Q", "--input-fasta-query", help="FASTA with query (pattern) sequences")
    p.add_argument("-T", "--input-fasta-target", help="FASTA with target (text) sequences")
    p.add_argument("-n", "--num-alignments", type=int, help="number of alignments to read (default: all)")
    p.add_argument("-g", "--affine-penalties", default=None, help="penalties x,o,e (default 2,3,1)")
    p.add_argument("-x", "--compute-cigar", action="store_true", help="compute the optimal alignment path (CIGAR; not supported yet)")
    p.add_argument("-c", "--check", action="store_true", help="check alignment correctness against the CPU oracle")
    p.add_argument("-e", "--max-distance", type=int, help="maximum error the kernel computes (default: ~10%% of first pair)")
    p.add_argument("-b", "--batch-size", type=int, help="alignments per pipeline batch")
    p.add_argument("-B", "--band", default=None, help="banded (heuristic) execution; value = re-centering interval, 'auto' = 25")
    p.add_argument("-t", "--band-width", type=int, default=None, help="band window width in diagonals (reference: threads per block)")
    p.add_argument("-w", "--workers", type=int, default=None, help="accepted for compatibility; the kernel runs one block per alignment")
    p.add_argument("-o", "--output-file", help="output file for results")
    p.add_argument("-p", "--print-output", action="store_true", help="print output to stderr")
    p.add_argument("-O", "--output-verbose", action="store_true", help="append pattern/text columns to the output")
    p.add_argument("--backend", choices=BACKENDS, default="auto", help="device engine selection")
    p.add_argument("--profile", metavar="DIR", help="profiler trace (not supported yet)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _read_input(args) -> SequenceBatch | None:
    if args.input_seq:
        if ensure_native():
            pats, txts = native.read_seq_native(args.input_seq)
            n = args.num_alignments or len(pats)
            return SequenceBatch(pats[:n], txts[:n])
        return read_seq_file(args.input_seq, args.num_alignments)
    if args.input_fasta_query and args.input_fasta_target:
        if ensure_native():
            pats, txts = native.read_fasta_native(
                args.input_fasta_query, args.input_fasta_target
            )
            n = args.num_alignments or len(pats)
            return SequenceBatch(pats[:n], txts[:n])
        return read_fasta_pair(
            args.input_fasta_query, args.input_fasta_target,
            args.num_alignments,
        )
    return None


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.verbose:
        set_verbosity("DEBUG")
    if args.compute_cigar or args.profile:
        flag = "-x/--compute-cigar" if args.compute_cigar else "--profile"
        LOG.error("%s is not supported by wfa_tpu_torch yet (see ROADMAP.md).", flag)
        return 1

    LOG.info("Detected %s", describe())
    try:
        pen = _parse_penalties(args.affine_penalties)
    except ValueError as exc:
        LOG.error("%s", exc)
        return 1

    with timed("file read"):
        batch = _read_input(args)
    if batch is None:
        LOG.error("No input file provided.")
        return 1
    LOG.info("Penalties: M=0, X=%d, O=%d, E=%d.", pen.x, pen.o, pen.e)

    max_error = args.max_distance
    if max_error is None and len(batch):
        # CLI default: ~10% error of the first pair, floor 20
        # (tools/aligner.c:319-338).
        max_error = int(
            max(len(batch.texts[0]), len(batch.patterns[0])) * 0.1
        ) * max(pen.x, pen.o, pen.e)
        max_error = max(max_error, 20)
        LOG.info("No maximum error provided by the user, using %d", max_error)
    elif max_error is not None and max_error <= 0:
        LOG.error("Maximum error supported by the kernel must be > 0.")
        return 1

    band = -1
    if args.band is not None:
        band = 25 if args.band == "auto" else int(args.band)
        if band < 0:
            LOG.error("Band must be positive (band=%d).", band)
            return 1
        if band == 0:
            band = 25

    # Default pipeline batch = N/10 (lib/alignment_parameters.h:100-103).
    batch_size = args.batch_size
    if batch_size is None and len(batch) >= 20:
        batch_size = max(1, len(batch) // 10)

    opts = AlignmentOptions(
        penalties=pen,
        max_error=max_error,
        batch_size=batch_size,
        band=band,
        band_width=args.band_width,
        backend=args.backend,
    )

    t0 = time.time()
    results = align_pairs_pipelined(batch.patterns, batch.texts, opts)
    wall = time.time() - t0
    print(
        f"Alignment computed. Wall time: {wall:.3f}s "
        f"({len(results) / wall:.3f} alignments per second)"
    )

    if args.check:
        # Scores against the exact CPU oracle; in banded mode a score off the
        # optimum counts as incorrect and recall is reported.
        if ensure_native():
            oracle, _, _ = native.cpu_align_batch(
                batch.patterns, batch.texts, pen,
                np.ones(len(batch), dtype=np.int8), False, adaptive=False,
            )
        else:
            from wfa_tpu.utils.cpu_wfa import align_one_py

            oracle = [
                align_one_py(p, t, pen, False)[0]
                for p, t in zip(batch.patterns, batch.texts)
            ]
        ncorrect = sum(r.error == oracle[i] for i, r in enumerate(results))
        nincorrect = len(results) - ncorrect
        print(f"correct={ncorrect} incorrect={nincorrect}", file=sys.stderr)
        if opts.banded and results:
            print(
                f"recall={100.0 * ncorrect / len(results):.2f}%"
                f" ({ncorrect}/{len(results)} scores optimal)",
                file=sys.stderr,
            )

    if args.output_file or args.print_output:
        fp = sys.stderr if args.print_output else open(args.output_file, "w")
        try:
            write_alignments(fp, results, batch, verbose=args.output_verbose)
        finally:
            if not args.print_output:
                fp.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
