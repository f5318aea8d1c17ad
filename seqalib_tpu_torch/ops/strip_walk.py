"""Traceback walk (counterpart of ``strip_pallas.strip_walk_range``).

``strip_walk(P, i, j, st, done, affine=)`` walks every pair's pointer
matrix ``P`` (B, R, C) uint8 (the layout of ``strip_fill``) from cell
(i, j) in state ``st`` (0 = H, 1 = E, 2 = F) until i < 1 or j < 1, or a
STOP pointer in state H.  Returns ``(ops, i, j, st, done)``: ``ops``
(B, R + C) uint8 holds the emitted ops (``utils.cigar.OP_M/I/D``) in
start -> end order at the end of each row, 255 before them; the rest are
the walkers' final (B,) int32 states.  Kernel: ``csrc/strip_walk.cu``.
"""

from __future__ import annotations

import torch

from ..types import PTR_DIAG, PTR_LEFT, PTR_STOP, PTR_UP
from ..utils.cigar import OP_D, OP_I, OP_M, OP_PAD

from . import launches

ST_H, ST_E, ST_F = 0, 1, 2


def _check(P, state):
    if P.dtype != torch.uint8 or P.dim() != 3:
        raise ValueError("strip_walk: P must be a (B, R, C) uint8 tensor")
    B, R, C = P.shape
    for v in state:
        if v.dtype != torch.int32 or v.shape != (B,) or v.device != P.device:
            raise ValueError(f"strip_walk: walker state must be ({B},) int32")
    i, j = state[0], state[1]
    if bool(((i > R) | (j > C)).any()):
        raise ValueError("strip_walk: a start cell lies outside P")


def strip_walk_ref(P, i, j, st, done, *, affine: bool):
    """Plain PyTorch version: a lockstep walk vectorized over pairs."""
    B, R, C = P.shape
    L = R + C
    dev = P.device
    i, j, st = i.long(), j.long(), st.long()
    done = done != 0
    ops = torch.full((B, L), OP_PAD, dtype=torch.uint8, device=dev)
    pos = torch.full((B,), L, dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    while True:
        done = done | (i < 1) | (j < 1)
        if bool(done.all()):
            break
        byte = P[rows, (i - 1).clamp(0, R - 1), (j - 1).clamp(0, C - 1)].long()
        ph = byte & 3
        in_h = st == ST_H
        done = done | (in_h & (ph == PTR_STOP))
        act = ~done
        act_m = act & in_h & (ph == PTR_DIAG)
        act_i = act & ((in_h & (ph == PTR_UP)) | (st == ST_F))
        act_d = act & ((in_h & (ph == PTR_LEFT)) | (st == ST_E))
        op = torch.where(act_m, OP_M, torch.where(act_i, OP_I, OP_D))
        pos = pos - act.long()
        ops[rows[act], pos[act]] = op[act].to(torch.uint8)
        if affine:
            ext_e = ((byte >> 2) & 1) == 1
            ext_f = ((byte >> 3) & 1) == 1
            st = torch.where(
                act_m, ST_H,
                torch.where(
                    act_i, torch.where(ext_f, ST_F, ST_H),
                    torch.where(act_d, torch.where(ext_e, ST_E, ST_H), st),
                ),
            )
        i = i - (act_m | act_i).long()
        j = j - (act_m | act_d).long()
    return (ops, i.to(torch.int32), j.to(torch.int32), st.to(torch.int32),
            done.to(torch.int32))


def strip_walk(P, i, j, st, done, *, affine: bool):
    """Walk every pair; see the module docstring.  A CPU tensor runs
    ``strip_walk_ref``; a CUDA tensor the kernel."""
    P = P.contiguous()
    # the kernel updates the walker state in place: work on copies
    state = [v.to(torch.int32).clone().contiguous() for v in (i, j, st, done)]
    _check(P, state)
    if P.device.type == "cpu":
        return strip_walk_ref(P, *state, affine=affine)
    if P.device.type != "cuda":
        raise ValueError(f"strip_walk: unsupported device {P.device}")
    from .._build import launch

    B, R, C = P.shape
    ops = torch.full((B, R + C), OP_PAD, dtype=torch.uint8, device=P.device)
    if B == 0:
        return (ops, *state)
    launch(
        "strip_walk", P.device, "seqalib_strip_walk",
        P.data_ptr(), R, C, *(v.data_ptr() for v in state), ops.data_ptr(),
        R + C, B, int(affine),
    )
    launches["strip_walk"] += 1
    return (ops, *state)
