"""seqalib_tpu_torch — the PyTorch + CUDA port of seqalib_tpu.

Runs local and global alignment (scores, canonical coordinates, full
CIGARs), sharded over a pair mesh of devices and processes with
``mesh=make_pair_mesh(...)``, all-vs-all products with resume
(``align_all_vs_all``), banded
global alignment of long reads (``band=``), the
full-matrix alignment of one long pair split over a list of devices
(``align_score_sp``, ``align_sp``) and banded long pairs split into row
blocks over a list of devices (``align_score_banded_sp``,
``align_banded_sp``) on an NVIDIA Hopper card through
hand-written CUDA kernels, and on the CPU through their plain PyTorch
versions.  It keeps its own copies of the types, the oracle, the CIGAR
codec and the generic-container aligners (``models.generic``), and
imports nothing of ``seqalib_tpu`` or JAX.
"""

from .types import (  # noqa: F401
    BLOSUM62,
    DNA_ALPHABET,
    NEG_INF,
    PROTEIN_ALPHABET,
    AlignConfig,
    AlignResult,
    ScoringParams,
    decode_dna,
    decode_protein,
    encode_dna,
    encode_protein,
)

from .api import align, align_all_vs_all  # noqa: F401
from .parallel.band_pipeline import make_band_mesh  # noqa: F401
from .parallel.dist import make_pair_mesh  # noqa: F401
from .telemetry import traced

__version__ = "0.3.0"


def align_batch(queries, targets, scoring=None, mode="global", backend="strip", **kw):
    """Align many pairs (length-bucketed, device-batched).  Global by
    default, as ``seqalib_tpu.align_batch``; ``api.align_batch`` defaults to
    local, as ``seqalib_tpu.api.align_batch`` does.  See
    ``seqalib_tpu_torch.api``."""
    from .api import align_batch as _align_batch

    return _align_batch(queries, targets, scoring=scoring, mode=mode, backend=backend,
                        **kw)


@traced("seqalib.align_score_sp")
def align_score_sp(query, target, scoring, mesh, mode="global", **kw):
    """Affine score of ONE long pair computed by row-blocks x column tiles
    over ``mesh`` (a tuple of devices, ``make_band_mesh``).  ``mode``:
    "global" (NW) or "local" (SW).  ``query``/``target``: 1-D letter codes.
    See ``parallel.band_pipeline.nw_affine_score_sp`` /
    ``sw_affine_score_sp``."""
    from .parallel.band_pipeline import nw_affine_score_sp, sw_affine_score_sp

    if mode == "local":
        return sw_affine_score_sp(query, target, scoring, mesh, **kw)
    if mode != "global":
        raise ValueError(f"mode must be 'global' or 'local', got {mode!r}")
    return nw_affine_score_sp(query, target, scoring, mesh, **kw)


@traced("seqalib.align_score_banded_sp")
def align_score_banded_sp(queries, targets, scoring, band, mesh, **kw):
    """Banded affine global score(s) with each pair's band split into row
    blocks over ``mesh`` (a tuple of devices), the blocks relayed from one
    device to the next; one pair (1-D codes) or a batch.  See
    ``parallel.banded_sp.banded_nw_affine_score_sp``."""
    from .parallel.banded_sp import banded_nw_affine_score_sp

    return banded_nw_affine_score_sp(queries, targets, scoring, band, mesh, **kw)


@traced("seqalib.align_banded_sp")
def align_banded_sp(query, target, scoring, band, mesh, **kw):
    """Banded affine global alignment (score + full CIGAR) of one long pair,
    or a batch, with the band relayed as row blocks over ``mesh``;
    re-score-verified traceback.  See
    ``parallel.banded_sp.banded_nw_affine_align_sp``."""
    from .parallel.banded_sp import banded_nw_affine_align_sp

    return banded_nw_affine_align_sp(query, target, scoring, band, mesh, **kw)


@traced("seqalib.align_sp")
def align_sp(query, target, scoring, mesh, **kw):
    """Global affine alignment (score + full CIGAR) of ONE long pair over
    ``mesh``: the pipeline fill with boundary checkpoints, then a walk that
    recomputes only the pointer tiles the optimal path visits.  See
    ``parallel.band_pipeline.nw_affine_align_sp``."""
    from .parallel.band_pipeline import nw_affine_align_sp

    return nw_affine_align_sp(query, target, scoring, mesh, **kw)

