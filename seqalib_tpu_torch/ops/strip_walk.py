"""Traceback walk that writes CIGARs (counterpart of
``strip_pallas.strip_walk_range`` followed by ``_cigars_from_ops``).

``strip_walk(P, i, j, st, done, affine=)`` walks every pair's pointer
matrix ``P`` (B, R, C) uint8 (the layout of ``strip_fill``) from cell
(i, j) in state ``st`` (0 = H, 1 = E, 2 = F) until i < 1 or j < 1, or a
STOP pointer in state H.  Returns ``(text, nchar, state)``: the CIGAR
text of ``utils.cigar`` in rows of ``text_width(R, C)`` bytes (``nchar``
``BAD_START`` for a pair whose start cell lies outside P, i > R or j > C,
which walks nothing), and ``state`` (4, B) int32, the walkers' final i, j,
st, done.

The CIGAR is the implicit boundary run the walk stopped at (i' > 0: i'
I ops down column 0, else j' D ops along row 0), then the ops walked in
start -> end order, run-length encoded: the boundary run merges with the
first run walked when their ops agree.  It equals ``_cigars_from_ops`` of
the JAX walk's op matrix and final (i', j').

A CPU tensor runs ``strip_walk_ref`` and refuses a start cell outside P at
once.  A CUDA tensor launches the kernel (``csrc/strip_walk.cu``) and
nothing else: no device-to-host sync and no copy, so the range check is
deferred to ``cigars_from_text``, which raises the same ``ValueError``
(the caller copies ``nchar`` to the host in the copy it makes anyway).  The
kernel copies 16-byte segments of P: a CUDA P must start 16-byte aligned.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import PTR_DIAG, PTR_LEFT, PTR_STOP, PTR_UP
from ..utils.cigar import (BAD_START, OP_D, OP_I, OP_M, OP_PAD, ST_E, ST_F, ST_H, bad_start,
                           op_rows_to_cigars, pack_text)
from . import launches


def text_width(R: int, C: int) -> int:
    """Bytes of a text row: a walk takes at most R + C ops, a run of n ops
    at most 2n bytes, and the boundary run adds a letter and 10 digits."""
    return 2 * (R + C) + 12


def _check(P, state):
    if P.dtype != torch.uint8 or P.dim() != 3:
        raise ValueError("strip_walk: P must be a (B, R, C) uint8 tensor")
    B = P.shape[0]
    for v in state:
        if v.dtype != torch.int32 or v.shape != (B,) or v.device != P.device:
            raise ValueError(f"strip_walk: walker state must be ({B},) int32")


def strip_walk_ref(P, i, j, st, done, *, affine: bool):
    """Plain PyTorch version: a lockstep walk vectorized over pairs, its op
    rows encoded with ``op_rows_to_cigars`` and packed at the rows' ends."""
    B, R, C = P.shape
    dev = P.device
    i0, j0, st0, done0 = i, j, st, done
    bad = (i > R) | (j > C)
    i, j, st = i.long(), j.long(), st.long()
    done = (done != 0) | bad
    L = R + C
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
    ih, jh = i.cpu().numpy(), j.cpu().numpy()
    strings = op_rows_to_cigars(ops.cpu().numpy(), np.where(ih > 0, OP_I, OP_D),
                                np.where(ih > 0, ih, np.maximum(jh, 0)))
    text, nchar = pack_text(strings, text_width(R, C))
    nchar[bad.cpu().numpy()] = BAD_START
    state = torch.stack([torch.where(bad, i0, i.to(torch.int32)),
                         torch.where(bad, j0, j.to(torch.int32)),
                         torch.where(bad, st0, st.to(torch.int32)),
                         torch.where(bad, done0, done.to(torch.int32))])
    return (torch.from_numpy(text).to(dev), torch.from_numpy(nchar).to(dev), state)


def strip_walk(P, i, j, st, done, *, affine: bool):
    """Walk every pair; see the module docstring.  A CPU tensor runs
    ``strip_walk_ref``; a CUDA tensor the kernel."""
    P = P.contiguous()
    state = [v.to(torch.int32).contiguous() for v in (i, j, st, done)]
    _check(P, state)
    B, R, C = P.shape
    if P.device.type == "cpu":
        bad = ((state[0] > R) | (state[1] > C)).nonzero()
        if len(bad):
            raise bad_start(int(bad[0, 0]))
        return strip_walk_ref(P, *state, affine=affine)
    if P.device.type != "cuda":
        raise ValueError(f"strip_walk: unsupported device {P.device}")
    if P.data_ptr() % 16:
        raise ValueError("strip_walk: P must start 16-byte aligned on the card")
    from .._build import launch

    W = text_width(R, C)
    text = torch.empty((B, W), dtype=torch.uint8, device=P.device)
    nchar = torch.empty((B,), dtype=torch.int32, device=P.device)
    out = torch.empty((4, B), dtype=torch.int32, device=P.device)
    if B == 0:
        return text, nchar, out
    launch(
        "strip_walk", P.device, "seqalib_strip_walk",
        P.data_ptr(), R, C, *(v.data_ptr() for v in state), text.data_ptr(), W,
        nchar.data_ptr(), out.data_ptr(), B, int(affine),
    )
    launches["strip_walk"] += 1
    return text, nchar, out
