"""Scoring state carried from ``ScoringParams`` to the device.

``sentinel_table`` builds the (A+1, A+1) substitution table with a zero
sentinel row and column, the same numbers the JAX package scores with.
Unlike the TPU kernels, which take a scalar match/mismatch pair for tables
of 8 rows or fewer, every kernel here looks the score up in a table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .transfer import to_device
from .types import ScoringParams

# score of a padding sentinel letter (index >= A1) against anything; any
# negative value works, the sentinel cells never reach a valid cell
SENT_SCORE = -64
# the JAX kernels' packed-nibble profile stores score + 4 in four bits, so
# it takes tables in [-4, 11] and scores its sentinels -4; the port looks
# every score up, but routes by this range as the JAX package does
NIBBLE_BIAS = 4


def fits_nibbles(table) -> bool:
    """True when every score of ``table`` lies in [-4, 11]."""
    t = np.asarray(table)
    return bool(t.min() >= -NIBBLE_BIAS and t.max() <= 15 - NIBBLE_BIAS)


def scoring_params(match: int, mismatch: int, gap_open: int, gap_extend: int,
                   matrix=None) -> ScoringParams:
    """The port's ``ScoringParams`` from plain numbers and an optional
    (A, A) numpy matrix: the fields of the JAX package's class, so that a
    caller holding one can hand the same scoring to the port."""
    return ScoringParams(
        match=int(match), mismatch=int(mismatch), gap_open=int(gap_open),
        gap_extend=int(gap_extend),
        matrix=None if matrix is None else np.array(matrix, dtype=np.int32),
    )


def sentinel_table(sp: ScoringParams) -> np.ndarray:
    """(A+1, A+1) int32 substitution table with a zero sentinel row and
    column (the sentinel is the last index)."""
    m = sp.substitution_matrix()
    a = m.shape[0]
    out = np.zeros((a + 1, a + 1), dtype=np.int32)
    out[:a, :a] = m
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class Tables:
    """Device substitution table plus gap constants.

    ``table`` is (A1, A1) int32 and ``host`` the same table in numpy;
    letters A1 and A1 + 1 are the query and target padding sentinels.  A
    gap of length L costs ``gap_open + L * gap_extend`` when ``affine``,
    else ``L * gap_extend``."""

    table: torch.Tensor
    gap_open: int
    gap_extend: int
    affine: bool
    host: np.ndarray

    @property
    def A1(self) -> int:
        return int(self.table.shape[0])


def tables_from_params(sp: ScoringParams, device) -> Tables:
    """``Tables`` on ``device`` for ``sp``."""
    host = np.ascontiguousarray(sentinel_table(sp), np.int32)
    return Tables(
        table=to_device(host, device),
        gap_open=int(sp.gap_open),
        gap_extend=int(sp.gap_extend),
        affine=sp.is_affine,
        host=host,
    )
