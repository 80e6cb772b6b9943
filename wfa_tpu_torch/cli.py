"""Command-line aligner of the PyTorch/CUDA port (``wfa.affine.gpu``).

The flags and output format of ``wfa_tpu/cli.py`` (the reference CLI surface,
tools/aligner.c:60-187): one line ``-error<TAB>cigar`` per alignment, ``-O``
appends the pattern and text.  ``--backend`` takes ``auto`` (the card, as
``cuda``), ``torch`` (the plain engine on the CPU) or ``cuda``.
``--profile DIR`` writes a ``torch.profiler`` trace of the alignment run to
``DIR/trace.json``.  In a run of several processes (one a host, each having
called ``parallel.distributed.initialize``) each aligns its strided shard
and writes ``OUTPUT.{process index}``.

    python -m wfa_tpu_torch.cli -i tests/data/wfa.utest.seq -g 1,2,1 -e 10000 -o scores.out
    python -m wfa_tpu_torch.cli -i tests/data/wfa.utest.seq -n 50 -g 1,2,1 -e 100 -x -c
"""
from __future__ import annotations

import argparse
import collections
import sys
import time

import numpy as np

from . import native
from .aligner import BACKENDS, _resolve_backend
from .parallel import distributed
from .params import AlignmentOptions
from .pipeline import align_pairs_pipelined
from .types import Penalties
from .utils.cpu_wfa import align_one_py
from .utils.device_query import describe
from .utils.io import SequenceBatch, read_fasta_pair, read_seq_file, write_alignments
from .utils.logger import LOG, set_verbosity
from .utils.timers import TRACE, device_trace, timed
from .utils.verification import affine_score, check_cigar


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
    p.add_argument("-x", "--compute-cigar", action="store_true", help="compute the optimal alignment path (CIGAR)")
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
    p.add_argument("--profile", metavar="DIR", help="write a torch.profiler trace of the alignment run to DIR/trace.json")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _parse_penalties(arg: str | None) -> Penalties:
    """Parse ``-g x,o,e`` or raise ValueError (the reference CLI parses or
    errors out, tools/aligner.c:265-283)."""
    if not arg:
        return Penalties(2, 3, 1)
    parts = arg.split(",")
    try:
        if len(parts) != 3:
            raise ValueError
        x, o, e = (int(v) for v in parts)
    except ValueError:
        raise ValueError(
            f"Invalid penalties {arg!r}: expected x,o,e (e.g. -g 2,3,1)."
        ) from None
    return Penalties(abs(x), abs(o), abs(e))


def _read_input(args) -> SequenceBatch | None:
    if args.input_seq:
        if native.available():
            pats, txts = native.read_seq_native(args.input_seq)
            n = args.num_alignments or len(pats)
            return SequenceBatch(pats[:n], txts[:n])
        return read_seq_file(args.input_seq, args.num_alignments)
    if args.input_fasta_query and args.input_fasta_target:
        if native.available():
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


def _check(args, batch: SequenceBatch, results, pen: Penalties, banded: bool) -> None:
    """-c: scores against the exact CPU oracle and, with -x, each CIGAR
    replayed and rescored; in banded mode a score off the optimum counts as
    incorrect and recall is reported (wfa_tpu/cli.py:209-255)."""
    if native.available():
        oracle, _, _ = native.cpu_align_batch(
            batch.patterns, batch.texts, pen,
            np.ones(len(batch), dtype=np.int8), False, adaptive=False,
        )
    else:
        oracle = [
            align_one_py(p, t, pen, False)[0]
            for p, t in zip(batch.patterns, batch.texts)
        ]
    ncorrect = noptimal = 0
    for i, r in enumerate(results):
        ok = True
        if args.compute_cigar:
            ok = check_cigar(r.cigar, batch.patterns[i], batch.texts[i])
            ok = ok and affine_score(r.cigar, pen) == r.error
        optimal = r.error == oracle[i]
        noptimal += optimal
        ncorrect += ok and optimal
    print(f"correct={ncorrect} incorrect={len(results) - ncorrect}",
          file=sys.stderr)
    if banded and results:
        print(
            f"recall={100.0 * noptimal / len(results):.2f}%"
            f" ({noptimal}/{len(results)} scores optimal)",
            file=sys.stderr,
        )


def _log_stages(calls: list[dict]) -> None:
    """One line per host stage of the run's ``align_pairs`` calls, one for
    the time no leaf stage covers, and one of the calls' counters (summed
    over the calls; a level, ``TRACE.levels``, at its highest)."""
    stages: dict[str, dict] = {}
    counters: collections.Counter = collections.Counter()
    for c in calls:
        for name, st in c["stages"].items():
            tot = stages.setdefault(name, {"calls": 0, "n": 0, "wall": 0.0, "self": 0.0})
            tot["calls"] += 1
            for key in ("n", "wall", "self"):
                tot[key] += st[key]
        for name, n in c["counters"].items():
            counters[name] = (max(counters[name], n) if name in TRACE.levels
                              else counters[name] + n)
    for name, st in stages.items():
        LOG.info("stage %s: %d of %d calls, %d spans, wall %.3f ms, self %.3f ms",
                 name, st["calls"], len(calls), st["n"], st["wall"] * 1e3,
                 st["self"] * 1e3)
    LOG.info("stage other: wall %.3f ms; the calls' thread cpu %.3f ms",
             sum(c["other"] for c in calls) * 1e3, sum(c["cpu"] for c in calls) * 1e3)
    LOG.info("counters: %s", " ".join(f"{k}={v}" for k, v in sorted(counters.items())))


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.verbose:
        set_verbosity("DEBUG")

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
        if max_error > 8000:
            LOG.warning(
                "Automatically generated maximum error is very high; consider"
                " limiting it with '-e'."
            )
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

    try:
        _resolve_backend(args.backend)
    except RuntimeError as exc:   # no CUDA device for auto or cuda
        LOG.error("%s", exc)
        return 1

    # Multi-host run (the caller has run parallel.distributed.initialize):
    # each process aligns its strided shard of the input and writes its own
    # output file (merge offline or with allgather_scores).  max_error above
    # was derived from the global first pair, so every process runs the
    # same configuration.
    if distributed.process_count() > 1:
        pats, txts, args.output_file = distributed.shard_batch(
            batch.patterns, batch.texts, args.output_file
        )
        batch = SequenceBatch(pats, txts)
        LOG.info(
            "multi-host: process %d/%d aligning %d pairs",
            distributed.process_index(), distributed.process_count(),
            len(batch),
        )

    # Default pipeline batch = N/10 (lib/alignment_parameters.h:100-103).
    batch_size = args.batch_size
    if batch_size is None and len(batch) >= 20:
        batch_size = max(1, len(batch) // 10)

    opts = AlignmentOptions(
        penalties=pen,
        max_error=max_error,
        compute_cigar=args.compute_cigar,
        batch_size=batch_size,
        band=band,
        band_width=args.band_width,
        backend=args.backend,
    )

    t0 = time.time()
    t_run = time.perf_counter()
    with TRACE.enabled(args.verbose), device_trace(args.profile):
        results = align_pairs_pipelined(batch.patterns, batch.texts, opts)
    wall = time.time() - t0
    print(
        f"Alignment computed. Wall time: {wall:.3f}s "
        f"({len(results) / wall:.3f} alignments per second)"
    )
    if args.verbose:
        _log_stages(TRACE.calls(t_run, time.perf_counter()))

    if args.check:
        _check(args, batch, results, pen, opts.banded)

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
