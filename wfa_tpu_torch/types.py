"""Core types of the port: penalties, results, the 2-bit op encoding.

The port's own copy of ``wfa_tpu/types.py`` (which follows the reference's
lib/wfa_types.h:28-64, lib/affine_penalties.h:25-30 and
lib/alignment_results.h:30-48), with the same names.  Offsets are signed
16-bit values on the reference's optimized path, so the longest supported
sequence is 2^15 bases (lib/wfa_types.h:28-32).
"""
from __future__ import annotations

import dataclasses
from enum import IntEnum

# Longest sequence the device path takes (lib/wfa_types.h:31).
MAX_SEQ_LEN = 1 << 15

# "This wavefront cell does not exist"
# (lib/kernels/common_alignment_kernels.cuh:27).
OFFSET_NULL = -32000


class AffineOp(IntEnum):
    """2-bit alignment-op encoding (lib/wfa_types.h:44-49)."""

    NOOP = 0
    INS = 1
    SUB = 2
    DEL = 3


# ASCII rendering of ops in CIGARs (lib/wfa_types.h:51).
OPS_ASCII = ("?", "I", "X", "D")


class GapOp(IntEnum):
    """Gap provenance of I/D cells (lib/wfa_types.h:53-56).  EXTEND > OPEN,
    so that offset ties prefer gap extension, as the reference's packed
    64-bit max does (lib/kernels/sequence_alignment_kernel.cu:177-178)."""

    OPEN = 1
    EXTEND = 2


@dataclasses.dataclass(frozen=True)
class Penalties:
    """Gap-affine penalties; match is always 0 (lib/affine_penalties.h:25-30)."""

    x: int = 2  # mismatch
    o: int = 3  # gap open
    e: int = 1  # gap extend

    def __post_init__(self) -> None:
        for name in ("x", "o", "e"):
            v = getattr(self, name)
            if v < 0:
                # The reference CLI takes |v| (tools/aligner.c:277-279).
                object.__setattr__(self, name, -v)
        if self.x == 0 or self.e == 0:
            raise ValueError("penalties x and e must be > 0")

    @property
    def active_working_set(self) -> int:
        """Ring size: wavefronts kept live = max(o+e, x)+1
        (lib/kernels/sequence_alignment_kernel.cu:394)."""
        return max(self.o + self.e, self.x) + 1


@dataclasses.dataclass
class AlignmentResult:
    """Per-alignment result (lib/alignment_results.h:30-48).

    ``error`` is the positive alignment distance; the CLI prints its negation
    (tools/aligner.c:506-508).  ``cigar`` is the run-length ASCII CIGAR
    ("10M2X3I...") or empty in distance-only mode.
    """

    error: int = 0
    cigar: str = ""
    finished_on_accelerator: bool = True
    # False only when the device could not finish the pair and the CPU
    # fallback was disabled (cpu_fallback=False): ``error``/``cigar`` are then
    # placeholders (lib/alignment_results.h:37).
    finished: bool = True


@dataclasses.dataclass
class KernelResult:
    """One alignment's kernel result (lib/alignment_results.h:37-42)."""

    distance: int
    finished: bool
