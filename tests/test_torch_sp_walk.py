"""The long pair's walk through one batch of pointer tiles
(``seqalib_tpu_torch/ops/sp_walk.py``) on the CPU, where the wrapper runs
its plain version: against a walk written independently over the batch
unfolded to a dense (rows, K * C) matrix of bytes, on random batches
(small and large tiles, long gap runs, every start state), and its
argument checks, error and output layout.  The kernel is held to the plain
version on the card in ``tests/test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from seqalib_tpu_torch.ops import launches
from seqalib_tpu_torch.ops.sp_tile import ptr_index
from seqalib_tpu_torch.ops.sp_walk import HEADER_BYTES, out_bytes, read_walk, sp_walk
from seqalib_tpu_torch.types import PTR_DIAG, PTR_LEFT, PTR_UP
from seqalib_tpu_torch.utils.cigar import OP_D, OP_I, OP_M, ST_E, ST_F, ST_H


def _dense(P):
    """The batch's bytes as a (rows, K * C) matrix, column x = the batch's
    column lo + 1 + x."""
    K, C, rows = P.shape
    out = np.zeros((rows, K * C), np.uint8)
    for g in range(K):
        for p in range(rows):
            for c in range(1, C + 1):
                out[p, (K - 1 - g) * C + c - 1] = P[g][ptr_index(p, c, C)]
    return out


def _dense_walk(D, i, j, state, i0, lo):
    """The oracle's state machine over the dense matrix, one op a move."""
    ops = []
    while i > i0 and j > lo:
        byte = int(D[i - i0 - 1, j - lo - 1])
        ph = byte & 3
        if state == ST_H and ph == PTR_DIAG:
            ops.append(OP_M)
            i, j = i - 1, j - 1
        elif (state == ST_H and ph == PTR_UP) or state == ST_F:
            ops.append(OP_I)
            state = ST_F if (byte >> 3) & 1 else ST_H
            i -= 1
        elif (state == ST_H and ph == PTR_LEFT) or state == ST_E:
            ops.append(OP_D)
            state = ST_E if (byte >> 2) & 1 else ST_H
            j -= 1
        else:
            return i, j, state, ops, 1
    return i, j, state, ops, 0


def _batch(rng, K, C, rows, gaps):
    P = rng.integers(1, 16, (K, C, rows)).astype(np.uint8)
    P[(P & 3) == 0] |= 1  # every byte has a move in state H
    if gaps:  # mostly gap opens that extend: runs of I and D far past 32 ops
        P = (rng.choice([PTR_UP, PTR_LEFT], P.shape) | 12).astype(np.uint8)
        P[rng.random(P.shape) < 0.02] = PTR_DIAG
    return P


@pytest.mark.parametrize("gaps", [False, True])
@pytest.mark.parametrize("K, C, rows", [(1, 128, 90), (3, 8, 70), (4, 33, 41), (2, 1, 9),
                                        (5, 16, 130)])
def test_the_walk_follows_the_dense_matrix_walk(K, C, rows, gaps):
    rng = np.random.default_rng(K * 1000 + C * 10 + rows + gaps)
    P = _batch(rng, K, C, rows, gaps)
    D = _dense(P)
    i0, j0 = 200, 500
    lo = j0 - (K - 1) * C
    before = dict(launches)
    for _ in range(12):
        i = i0 + int(rng.integers(1, rows + 1))
        j = lo + int(rng.integers(1, K * C + 1))
        state = int(rng.integers(0, 3))
        out = sp_walk(torch.from_numpy(P), i, j, state, i0=i0, j0=j0)
        assert out.dtype == torch.uint8 and out.shape == (out_bytes(K, C, rows),)
        ei, ej, est, ops, err = _dense_walk(D, i, j, state, i0, lo)
        assert not err and (ei == i0 or ej == lo)
        assert read_walk(out.numpy()) == (ei, ej, est, ops)
    assert launches == before  # the plain version counts no launch


def test_a_byte_with_no_move_in_state_h_sets_the_error_and_raises():
    P = np.zeros((2, 16, 10), np.uint8)
    out = sp_walk(torch.from_numpy(P), 105, 40, ST_H, i0=100, j0=32).numpy()
    assert out[:HEADER_BYTES].view(np.int32).tolist() == [105, 40, ST_H, 0, 1]
    with pytest.raises(RuntimeError, match=r"SP walk: no move at \(105, 40\)"):
        read_walk(out)
    # in a gap state the byte's move bits are not read: the run goes on
    P[:] = 4  # extend E everywhere
    i, j, state, ops = read_walk(sp_walk(torch.from_numpy(P), 105, 40, ST_E, i0=100,
                                         j0=32).numpy())
    assert (i, j, state, ops) == (105, 16, ST_E, [OP_D] * 24)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    P = torch.ones((2, 16, 10), dtype=torch.uint8)
    for i, j in ((100, 40), (111, 40), (105, 16), (105, 49)):
        with pytest.raises(ValueError, match="outside the batch"):
            sp_walk(P, i, j, ST_H, i0=100, j0=32)
    with pytest.raises(ValueError, match="state"):
        sp_walk(P, 105, 40, 3, i0=100, j0=32)
    with pytest.raises(ValueError, match="uint8"):
        sp_walk(P.int(), 105, 40, ST_H, i0=100, j0=32)
    with pytest.raises(ValueError, match="uint8"):
        sp_walk(torch.ones((0, 16, 10), dtype=torch.uint8), 105, 40, ST_H, i0=100, j0=32)
