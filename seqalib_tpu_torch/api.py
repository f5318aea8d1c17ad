"""Public alignment API of the port (counterpart of ``seqalib_tpu/api.py``).

``align``: one pair.  ``align_batch``: many pairs through the bucketed
dispatcher.  Same parameters as the JAX package, plus ``device``
(default ``"cuda"``).  Backends: ``"strip"`` (the default: the CUDA
kernels on a CUDA device, their plain PyTorch versions on the CPU; with
``band=`` and ``mode="global"`` the banded long-read path) and
``"oracle"`` (the port's NumPy oracle, ``oracle_fast``: bit for bit
``oracle.py``, vectorized over anti-diagonals, ``band=`` included).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .types import (
    PROTEIN_SIZE,
    AlignResult,
    ScoringParams,
    encode_dna,
    encode_protein,
)

BACKENDS = ("strip", "oracle")


def _coerce(seq, sp: ScoringParams) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        return seq if seq.dtype == np.uint8 else seq.astype(np.uint8)
    if sp.matrix is not None and sp.matrix.shape[0] >= PROTEIN_SIZE:
        return encode_protein(seq)
    return encode_dna(seq)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def align(
    query,
    target,
    scoring: Optional[ScoringParams] = None,
    mode: str = "global",
    band: Optional[int] = None,
    backend: str = "strip",
    device="cuda",
) -> AlignResult:
    """Align one query/target pair and return score, coords, CIGAR."""
    return align_batch(
        [query], [target], scoring=scoring, mode=mode, band=band,
        backend=backend, device=device,
    )[0]


def align_batch(
    queries: Sequence,
    targets: Sequence,
    scoring: Optional[ScoringParams] = None,
    mode: str = "local",
    band: Optional[int] = None,
    backend: str = "strip",
    traceback: bool = True,
    mesh=None,
    device="cuda",
) -> List[AlignResult]:
    """Align pairs[i] = (queries[i], targets[i]) through the length-bucketed
    dispatcher on ``device``."""
    if mode not in ("local", "global"):
        raise ValueError(f"mode must be global|local, got {mode!r}")
    if band is not None and mode == "local":
        raise ValueError(
            "banded local alignment is out of contract: band= applies to "
            'mode="global" only (BASELINE.json:10 is banded affine NW)'
        )
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    sp = scoring if scoring is not None else ScoringParams.linear()
    qs = [_coerce(q, sp) for q in queries]
    ts = [_coerce(t, sp) for t in targets]
    if len(qs) != len(ts):
        raise ValueError("queries and targets must have equal length")

    if backend == "oracle":
        from .oracle_fast import align_oracle

        return [align_oracle(q, t, sp, mode=mode, band=band) for q, t in zip(qs, ts)]
    if mesh is not None:
        raise NotImplementedError(
            "mesh dispatch is not ported yet (ROADMAP.md Queue 1 item 8)"
        )
    from .parallel.dispatch import dispatch_batch

    return dispatch_batch(qs, ts, sp, mode=mode, band=band, traceback=traceback,
                          device=_device(device))
