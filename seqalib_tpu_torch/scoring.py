"""Scoring state carried from the shared ``ScoringParams`` to the device.

Both packages score through ``seqalib_tpu.parallel.dispatch.sentinel_table``
(the (A+1, A+1) substitution table with a zero sentinel row and column),
so the port and the JAX reference use the same numbers.  Unlike the TPU
kernels, which take a scalar match/mismatch pair for tables of 8 rows or
fewer, every kernel here looks the score up in this table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from seqalib_tpu.parallel.dispatch import sentinel_table
from seqalib_tpu.types import ScoringParams

# score of a padding sentinel letter (index >= A1) against anything; any
# negative value works, the sentinel cells never reach a valid cell
SENT_SCORE = -64


@dataclasses.dataclass(frozen=True)
class Tables:
    """Device substitution table plus gap constants.

    ``table`` is (A1, A1) int32; letters A1 and A1 + 1 are the query and
    target padding sentinels.  A gap of length L costs
    ``gap_open + L * gap_extend`` when ``affine``, else ``L * gap_extend``."""

    table: torch.Tensor
    gap_open: int
    gap_extend: int
    affine: bool

    @property
    def A1(self) -> int:
        return int(self.table.shape[0])


def tables_from_params(sp: ScoringParams, device) -> Tables:
    """``Tables`` on ``device`` for ``sp``."""
    table = torch.from_numpy(np.ascontiguousarray(sentinel_table(sp), np.int32))
    return Tables(
        table=table.to(device),
        gap_open=int(sp.gap_open),
        gap_extend=int(sp.gap_extend),
        affine=sp.is_affine,
    )
