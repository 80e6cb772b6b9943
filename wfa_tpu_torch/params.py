"""Alignment options and their defaults.

The port's own copy of ``wfa_tpu/params.py`` (the counterpart of the
reference's ``wfa_alignment_options_t``, lib/alignment_parameters.h:33-106,
tools/aligner.c:311-416), with the same field names so options built for
either package mean the same thing.

* ``max_error``  — kernel step budget (the reference's max_steps).
* ``band_width`` — explicit wavefront-window width of the banded mode (the
  reference's is implicitly ``threads_per_block``, tools/aligner.c:413).
* ``batch_size`` — host streaming-pipeline batch (lib/align.cu:177).
* ``band``       — re-centering interval; <0 disables (exact mode), 0 means
  "auto" = 25 (tools/aligner.c:409-412).
* ``tile_batch``, ``memory_budget_bytes`` — per-call batch sizing.
* ``data_parallel`` — split each launch over this process's cards.
* ``probe_order``  — order the pairs of long-read tiers by distances a
  narrow-band K1 pass measures, in place of the host's estimate.
"""
from __future__ import annotations

import dataclasses

from .types import Penalties

AUTO_BAND_INTERVAL = 25  # tools/aligner.c:411


def default_max_error(
    first_pattern_len: int,
    first_text_len: int,
    penalties: Penalties,
    floor: int = 50,
) -> int:
    """Assume ~10% error between sequences; alignments beyond this error go
    to the CPU (lib/alignment_parameters.h:87-93; the CLI uses floor=20,
    tools/aligner.c:336)."""
    max_error = int(max(first_text_len, first_pattern_len) * 0.1)
    max_error *= max(penalties.x, penalties.o, penalties.e)
    return max(max_error, floor)


def default_band_width(max_error: int) -> int:
    """Window width from the largest wavefront — the reference's
    threads-per-block lookup (lib/alignment_parameters.h:60-71,
    tools/aligner.c:352-357), used as the band width."""
    max_wf_size = 2 * max_error + 1
    if max_wf_size <= 128:
        return 64
    if max_wf_size <= 256:
        return 128
    if max_wf_size <= 512:
        return 256
    if max_wf_size <= 1024:
        return 512
    return 1024


@dataclasses.dataclass
class AlignmentOptions:
    penalties: Penalties = dataclasses.field(default_factory=Penalties)
    max_error: int | None = None       # None: auto from the first pair
    compute_cigar: bool = False
    batch_size: int | None = None      # None: all pairs in one pipeline batch
    band: int = -1                     # re-center interval; 0 = auto (25)
    band_width: int | None = None      # None: auto table
    tile_batch: int | None = None      # None: auto from the memory budget
    memory_budget_bytes: int = 1 << 30
    # Run the CPU fallback for unfinished/invalid pairs (the reference always
    # does, lib/align.cu:236-249).
    cpu_fallback: bool = True
    # Pairs left unfinished at ``max_error`` get up to this many further
    # device passes at a doubled error budget before the CPU takes over.
    device_retries: int = 1
    # "auto" (the card, as "cuda"), "torch" (the plain engine on the CPU)
    # or "cuda" (wfa_tpu_torch.aligner.BACKENDS).
    backend: str = "auto"
    # Split each launch's batch over every device of
    # parallel.mesh.data_mesh() (this process's cards; pure data
    # parallelism).  Ignored with one device and by the plain engine.
    data_parallel: bool = True
    # Two-pass ordered tiling: a narrow-band (W=128) distance-only K1 pass
    # measures each long-read pair's distance, and the main pass orders the
    # pairs within each tier by it instead of by the host-side divergence
    # estimate.  Results are the same either way; default off.
    probe_order: bool = False

    def resolved_band(self) -> int:
        if self.band == 0:
            return AUTO_BAND_INTERVAL
        return self.band

    @property
    def banded(self) -> bool:
        return self.band >= 0
