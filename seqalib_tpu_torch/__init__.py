"""seqalib_tpu_torch — the PyTorch + CUDA port of seqalib_tpu.

Runs local and global alignment (scores, canonical coordinates, full
CIGARs) and banded global alignment of long reads (``band=``) on an NVIDIA
Hopper card through hand-written CUDA kernels, and on the CPU through their
plain PyTorch versions.  It keeps its own copies of the types, the oracle
and the CIGAR codec, and imports nothing of ``seqalib_tpu`` or JAX.
"""

from .types import (  # noqa: F401
    BLOSUM62,
    AlignResult,
    ScoringParams,
    decode_dna,
    decode_protein,
    encode_dna,
    encode_protein,
)

from .api import align, align_batch  # noqa: F401
