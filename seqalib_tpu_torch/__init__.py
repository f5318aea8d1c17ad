"""seqalib_tpu_torch — the PyTorch + CUDA port of seqalib_tpu.

Runs the strip engine's local and global alignment (scores, canonical
coordinates, full CIGARs) on an NVIDIA Hopper card through hand-written
CUDA kernels, and on the CPU through their plain PyTorch versions.  It
imports the jax-free shared layer of ``seqalib_tpu`` (types, oracle, CIGAR
codec, bucketing helpers) and never JAX itself.
"""

from seqalib_tpu.types import (  # noqa: F401
    BLOSUM62,
    AlignResult,
    ScoringParams,
    decode_dna,
    decode_protein,
    encode_dna,
    encode_protein,
)

from .api import align, align_batch  # noqa: F401
