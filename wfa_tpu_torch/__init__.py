"""wfa_tpu_torch — the PyTorch/CUDA port of wfa_tpu.

Batch gap-affine pairwise DNA alignment with the wavefront algorithm (WFA),
distance and CIGAR, on an NVIDIA Hopper GPU through hand-written CUDA
kernels, with a plain PyTorch engine for the CPU.  The package stands alone:
it keeps its own copy of each host module of ``wfa_tpu`` it needs (types,
options, schedule, packing, readers, the native host library's bindings,
CIGAR decoding) and imports neither ``wfa_tpu`` nor jax.
"""
from .aligner import WfaAligner, align_pairs
from .params import AlignmentOptions, default_band_width, default_max_error
from .pipeline import align_pairs_pipelined
from .types import MAX_SEQ_LEN, AlignmentResult, Penalties

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
