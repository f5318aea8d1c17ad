"""Banded traceback walk (counterpart of ``banded_pallas.band_walk_range``
with ``packed=True``).

``band_walk(ptr, i, j, st, done, k0=, dhi=)`` walks one super-block of
``band_fill``'s pointer nibbles: ``ptr`` (KW / 2, B, Wp) uint8 holds
diagonals ``[k0, k0 + KW)`` (``k0`` even), diagonal ``k0 + x`` of slot ``p``
at ``ptr[x // 2, b, p] >> 4 * (x % 2)``.  Each walker stands on cell
(i, j) in state ``st`` (0 = H, 1 = E, 2 = F); while its diagonal ``i + j``
lies in the block it reads the nibble of slot ``i - ihat(i + j)`` (clamped
to the window), stops at a STOP pointer in state H, and otherwise emits one
op (``utils.cigar.OP_M/I/D``) and steps back.  Returns ``(ops, i, j, st,
done)``: ``ops`` (B, KW) uint8, column ``x`` the op consumed at diagonal
``k0 + x`` (255 = none), and the walkers' (B,) int32 states, which the
next (lower) super-block resumes from.

``i_floor``: before the read on every diagonal of the block, a walker on a
row ``<= i_floor`` is marked done (banded sequence parallelism: local row
0 is the block above's last row, whose pointers are never read).  The
default -1 never stops a walker.  Kernel: ``csrc/band_walk.cu`` (a CTA
per pair: one thread walks, the others stage the band bytes it reads
next in shared memory).
"""

from __future__ import annotations

import torch

from ..types import PTR_DIAG, PTR_LEFT, PTR_STOP, PTR_UP
from ..utils.cigar import OP_D, OP_I, OP_M, OP_PAD, ST_E, ST_F, ST_H
from . import launches


def _check(ptr, state, k0):
    if ptr.dtype != torch.uint8 or ptr.dim() != 3:
        raise ValueError("band_walk: ptr must be a (KW / 2, B, Wp) uint8 tensor")
    B = ptr.shape[1]
    for v in state:
        if v.dtype != torch.int32 or v.shape != (B,) or v.device != ptr.device:
            raise ValueError(f"band_walk: walker state must be ({B},) int32")
    if k0 < 0 or k0 % 2:
        raise ValueError(f"band_walk: k0 must be even and >= 0, got {k0}")


def band_walk_ref(ptr, i, j, st, done, *, k0: int, dhi: int, i_floor: int = -1):
    """Plain PyTorch version: the lockstep walk (one op per active pair
    per step), vectorized over pairs."""
    KW2, B, Wp = ptr.shape
    KW = 2 * KW2
    dev = ptr.device
    i, j, st = i.long(), j.long(), st.long()
    done = (done != 0) | ((i <= i_floor) & (KW > 0))  # the test on the top diagonal
    ops = torch.full((B, KW), OP_PAD, dtype=torch.uint8, device=dev)
    rows = torch.arange(B, device=dev)
    while True:
        k = i + j
        act_blk = ~done & (k >= k0) & (k < k0 + KW)
        if not bool(act_blk.any()):
            break
        x = (k - k0).clamp(0, KW - 1)
        ih = ((k - dhi + 1) // 2).clamp(min=0)  # floor division
        p = (i - ih).clamp(0, Wp - 1)
        nib = (ptr[x // 2, rows, p].long() >> (4 * (x % 2))) & 15
        ph = nib & 3
        in_h = st == ST_H
        done = done | (act_blk & in_h & (ph == PTR_STOP))
        act = act_blk & ~done
        act_m = act & in_h & (ph == PTR_DIAG)
        act_i = act & ((in_h & (ph == PTR_UP)) | (st == ST_F))
        act_d = act & ((in_h & (ph == PTR_LEFT)) | (st == ST_E))
        op = torch.where(act_m, OP_M, torch.where(act_i, OP_I, OP_D))
        ops[rows[act], x[act]] = op[act].to(torch.uint8)
        ext_e = ((nib >> 2) & 1) == 1
        ext_f = ((nib >> 3) & 1) == 1
        st = torch.where(
            act_m, ST_H,
            torch.where(act_i, torch.where(ext_f, ST_F, ST_H),
                        torch.where(act_d, torch.where(ext_e, ST_E, ST_H), st)),
        )
        i = i - (act_m | act_i).long()
        j = j - (act_m | act_d).long()
        # the floor test on the diagonal below this one, if the block has it
        done = done | (act & (i <= i_floor) & (x >= 1))
    return (ops, i.to(torch.int32), j.to(torch.int32), st.to(torch.int32),
            done.to(torch.int32))


def band_walk(ptr, i, j, st, done, *, k0: int, dhi: int, i_floor: int = -1):
    """Walk every pair through one super-block; see the module docstring.
    The input states are not modified.  A CPU tensor runs
    ``band_walk_ref``; a CUDA tensor the kernel.  A call with
    ``i_floor >= 0`` counts under ``band_walk/floor``."""
    ptr = ptr.contiguous()
    # the kernel updates the walker state in place: work on copies
    state = [v.to(torch.int32).clone().contiguous() for v in (i, j, st, done)]
    _check(ptr, state, k0)
    if ptr.device.type == "cpu":
        return band_walk_ref(ptr, *state, k0=k0, dhi=dhi, i_floor=i_floor)
    if ptr.device.type != "cuda":
        raise ValueError(f"band_walk: unsupported device {ptr.device}")
    from .._build import launch

    KW2, B, Wp = ptr.shape
    ops = torch.empty((B, 2 * KW2), dtype=torch.uint8, device=ptr.device)
    if B == 0 or KW2 == 0:
        return (ops.fill_(OP_PAD), *state)
    launch(
        "band_walk", ptr.device, "seqalib_band_walk",
        ptr.data_ptr(), 2 * KW2, B, Wp, k0, dhi, i_floor,
        *(v.data_ptr() for v in state), ops.data_ptr(),
    )
    launches["band_walk/floor" if i_floor >= 0 else "band_walk"] += 1
    return (ops, *state)
