"""Sequence readers and the result writer.

The port's own copy of ``wfa_tpu/utils/io.py`` (Python equivalents of the
reference's utils/sequence_reader.c):

* ``.seq`` format: alternating ``>pattern`` / ``<text`` lines
  (sequence_reader.c:193-227).
* FASTA pair mode: two files (query = patterns, target = texts), ``>``-header
  delimited multi-line records (sequence_reader.c:241-392); sequences of
  length >= MAX_SEQ_LEN are rejected like the reference.

The C++ readers (``wfa_tpu_torch.native.read_seq_native`` and
``read_fasta_native``) implement the same contract; these are the portable
fallback and the test reference.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

from ..types import MAX_SEQ_LEN


@dataclasses.dataclass
class SequenceBatch:
    """A batch of (pattern, text) pairs."""

    patterns: list[bytes]
    texts: list[bytes]

    def __len__(self) -> int:
        return len(self.patterns)

    def pairs(self):
        return zip(self.patterns, self.texts)


def read_seq_file(path: str | Path, num_pairs: int | None = None) -> SequenceBatch:
    """Read a .seq file: '>' lines are patterns, '<' lines are texts."""
    patterns: list[bytes] = []
    texts: list[bytes] = []
    with open(path, "rb") as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line[:1] == b">":
                patterns.append(line[1:])
            elif line[:1] == b"<":
                texts.append(line[1:])
            else:
                raise ValueError(f"malformed .seq line: {line[:20]!r}...")
            if num_pairs is not None and len(texts) >= num_pairs:
                break
    # A trailing unpaired pattern is dropped: sequences are read in pairs.
    return SequenceBatch(patterns[: len(texts)], texts)


def _read_fasta(path: str | Path, limit: int | None) -> list[bytes]:
    seqs: list[bytes] = []
    cur: list[bytes] = []
    with open(path, "rb") as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line[:1] == b">":
                if cur:
                    seqs.append(b"".join(cur))
                    cur = []
                    if limit is not None and len(seqs) >= limit:
                        return seqs
            else:
                cur.append(line)
        if cur:
            seqs.append(b"".join(cur))
    return seqs


def read_fasta_pair(
    query_path: str | Path,
    target_path: str | Path,
    num_pairs: int | None = None,
) -> SequenceBatch:
    """Query FASTA = patterns, target FASTA = texts (reference -Q/-T)."""
    q = _read_fasta(query_path, num_pairs)
    t = _read_fasta(target_path, num_pairs)
    n = min(len(q), len(t))
    q, t = q[:n], t[:n]
    for s in q + t:
        if len(s) >= MAX_SEQ_LEN:
            raise ValueError(
                f"sequence of length {len(s)} >= MAX_SEQ_LEN ({MAX_SEQ_LEN})"
            )
    return SequenceBatch(q, t)


def write_alignments(
    fp,
    results,
    batch: SequenceBatch | None = None,
    verbose: bool = False,
) -> None:
    """Reference CLI output: '-error<TAB>cigar[<TAB>pattern<TAB>text]' per
    line (tools/aligner.c:497-509; the score is printed negated)."""
    for i, r in enumerate(results):
        if verbose and batch is not None:
            fp.write(
                f"{-r.error}\t{r.cigar}\t"
                f"{batch.patterns[i].decode()}\t{batch.texts[i].decode()}\n"
            )
        else:
            fp.write(f"{-r.error}\t{r.cigar}\n")
