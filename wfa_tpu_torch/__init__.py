"""wfa_tpu_torch — the PyTorch/CUDA port of wfa_tpu.

Batch gap-affine pairwise DNA alignment with the wavefront algorithm (WFA),
distance mode, on an NVIDIA Hopper GPU through a hand-written CUDA kernel,
with a plain PyTorch engine for the CPU.  The host layer (types, options,
schedule, packing, readers, native CPU fallback) is imported from ``wfa_tpu``
as it is; this package never imports jax.
"""
from wfa_tpu.params import AlignmentOptions, default_band_width, default_max_error
from wfa_tpu.types import MAX_SEQ_LEN, AlignmentResult, Penalties

from .aligner import WfaAligner, align_pairs
from .pipeline import align_pairs_pipelined

__version__ = "0.1.0"

__all__ = [
    "WfaAligner",
    "align_pairs",
    "align_pairs_pipelined",
    "AlignmentOptions",
    "AlignmentResult",
    "Penalties",
    "MAX_SEQ_LEN",
    "default_band_width",
    "default_max_error",
]
