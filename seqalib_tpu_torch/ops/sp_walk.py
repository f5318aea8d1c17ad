"""Traceback walk over one batch of the long pair's pointer tiles: a kernel
of the port alone, in place of the JAX package's host walk
(``seqalib_tpu/parallel/band_pipeline.py:562-597``, inside
``nw_affine_align_sp``), which copies every recomputed tile to the host to
read one byte of each step of the path.

``sp_walk(P, i, j, state, i0=, j0=)`` walks one batch of ``sp_tile_ptr``'s
pointer tiles: ``P`` (K, C, rows) uint8, tile g covering columns
``j0 - g * C + 1 .. j0 - g * C + C`` and rows ``i0 + 1 .. i0 + rows``, the
byte of cell (row ``i0 + p + 1``, column ``j0 - g * C + c``) at
``P[g][ptr_index(p, c, C)]``.  From cell (i, j) in ``state``
(``utils.cigar.ST_H``, ``ST_E``, ``ST_F``) it runs the oracle's H/E/F
state machine with its byte rules (``ops/sp_tile.py``), one op
(``utils.cigar.OP_M/I/D``) a move, until i reaches the block top ``i0`` or
j the batch's left edge ``j0 - (K - 1) * C``; a byte with no move
(``PTR_STOP``) in state H stops it with the error flag set.  Returns one
uint8 tensor on P's device: ``HEADER_BYTES`` of int32 (end i, end j, end
state, ops walked, error), then the ops in walk order, from (i, j) back,
in room for rows + K * C of them (the bytes past the ops walked are
undefined).  ``read_walk`` decodes
its host copy and raises the ``RuntimeError`` of a byte with no move.

A CPU tensor runs ``sp_walk_ref``; a CUDA tensor launches the kernel
(``csrc/sp_walk.cu``: a warp walks, staging the cells of its next 32 steps
in shared memory) and nothing else: no sync and no copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import PTR_DIAG, PTR_LEFT, PTR_UP
from ..utils.cigar import OP_D, OP_I, OP_M, ST_E, ST_F, ST_H
from . import launches
from .sp_tile import ptr_index

HEADER_BYTES = 20  # int32: end i, end j, end state, ops walked, error


def out_bytes(K: int, C: int, rows: int) -> int:
    """Bytes of a walk's output: the header, then room for every op a walk
    through K tiles of C columns and ``rows`` rows can take."""
    return HEADER_BYTES + rows + K * C


def _check(P, i, j, state, i0, j0):
    if P.dtype != torch.uint8 or P.dim() != 3 or 0 in P.shape:
        raise ValueError("sp_walk: P must be a (K, C, rows) uint8 tensor")
    K, C, rows = P.shape
    if not (i0 < i <= i0 + rows and j0 - (K - 1) * C < j <= j0 + C):
        raise ValueError(f"sp_walk: start cell ({i}, {j}) lies outside the batch")
    if state not in (ST_H, ST_E, ST_F):
        raise ValueError(f"sp_walk: unknown state {state}")


def read_walk(out: np.ndarray):
    """``(i, j, state, ops)`` of a walk from the host copy of its output:
    the end cell and state, and the ops walked as a list of ints in walk
    order.  Raises the ``RuntimeError`` of a byte with no move in state H."""
    i, j, state, n, error = out[:HEADER_BYTES].view(np.int32).tolist()
    if error:
        raise RuntimeError(f"SP walk: no move at ({i}, {j})")
    return i, j, state, out[HEADER_BYTES: HEADER_BYTES + n].tolist()


def sp_walk_ref(P, i: int, j: int, state: int, *, i0: int, j0: int):
    """Plain version: the Python walk of ``nw_affine_align_sp``, tile by tile
    through the batch, on a host copy of P."""
    K, C, rows = P.shape
    tiles = P.cpu().numpy()
    lo = j0 - (K - 1) * C
    ops: list = []
    error = 0
    while i > i0 and j > lo and not error:
        g = (j0 + C - j) // C  # the tile of column j, and its left column jt
        jt = j0 - g * C
        T = tiles[g]
        while i > i0 and j > jt:
            byte = int(T[ptr_index(i - i0 - 1, j - jt, C)])
            if state == ST_H:
                ph = byte & 3
                if ph == PTR_DIAG:
                    ops.append(OP_M)
                    i -= 1
                    j -= 1
                elif ph == PTR_UP:
                    state = ST_F
                elif ph == PTR_LEFT:
                    state = ST_E
                else:
                    error = 1
                    break
            elif state == ST_F:
                ops.append(OP_I)
                if not (byte >> 3) & 1:
                    state = ST_H
                i -= 1
            else:  # E
                ops.append(OP_D)
                if not (byte >> 2) & 1:
                    state = ST_H
                j -= 1
    out = np.zeros(out_bytes(K, C, rows), np.uint8)
    out[:HEADER_BYTES] = np.array([i, j, state, len(ops), error], np.int32).view(np.uint8)
    out[HEADER_BYTES: HEADER_BYTES + len(ops)] = ops
    return torch.from_numpy(out).to(P.device)


def sp_walk(P, i: int, j: int, state: int, *, i0: int, j0: int):
    """Walk one batch; see the module docstring.  A CPU tensor runs
    ``sp_walk_ref``; a CUDA tensor the kernel, counted under ``sp_walk``."""
    P = P.contiguous()
    _check(P, i, j, state, i0, j0)
    if P.device.type == "cpu":
        return sp_walk_ref(P, i, j, state, i0=i0, j0=j0)
    if P.device.type != "cuda":
        raise ValueError(f"sp_walk: unsupported device {P.device}")
    from .._build import launch

    K, C, rows = P.shape
    out = torch.empty(out_bytes(K, C, rows), dtype=torch.uint8, device=P.device)
    launch("sp_walk", P.device, "seqalib_sp_walk", P.data_ptr(), K, C, rows, i, j, state,
           i0, j0, out.data_ptr())
    launches["sp_walk"] += 1
    return out
