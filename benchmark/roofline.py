"""The least time the card could take for the work a call requires.

Peaks (NVIDIA H100 SXM data sheet, at its 700 W limit; a run states the
card's power limit beside every share):

* INT32: 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.73e12 operations a
  second.  The recurrence is integer adds and maxima, which the INT32 pipe
  runs; no tensor core computes it.
* HBM3: 3.35e12 bytes a second.

Work is counted from the equations, never from a kernel: a cell of the
affine (Gotoh) recurrence is

    E = max(E_left + e, H_left + (o + e))      2 adds, 1 max
    F = max(F_up + e,   H_up + (o + e))        2 adds, 1 max
    D = H_diag + (q_i == t_j ? match : mismatch)   1 compare, 1 select, 1 add
    H = max(D, E, F)                           2 max

so ``OPS_PER_CELL`` = 11 int32 operations.  Bytes: every input letter read
once and every output written once: a fill writes one 4-byte score a pair;
a pointer recompute writes the four traceback bits of each cell (half a
byte).  A band's cells are those the banded recurrence defines (the
reference's ``band_cells``), a full matrix's n x m.  The recompute of a
checkpointed traceback counts as the fill it redoes plus its pointer bytes.
"""

from __future__ import annotations

INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
OPS_PER_CELL = 11
SCORE_BYTES = 4
POINTER_BYTES_PER_CELL = 0.5


def least_s(ops: float, nbytes: float) -> float:
    """The larger of the operation bound and the memory bound."""
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def fill_s(cells: int, letters: int, pairs: int) -> float:
    """A score fill: every cell once, letters in, a score a pair out."""
    return least_s(cells * OPS_PER_CELL, letters + pairs * SCORE_BYTES)


def pointer_fill_s(cells: int, letters: int) -> float:
    """A fill that writes every cell's traceback bits."""
    return least_s(cells * OPS_PER_CELL, letters + cells * POINTER_BYTES_PER_CELL)
