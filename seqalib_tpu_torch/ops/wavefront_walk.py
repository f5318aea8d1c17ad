"""Traceback walk over ``wavefront_fill``'s pointer stream that writes
CIGARs (a kernel of the port with no Pallas counterpart: it takes the place
of the JAX wide-table route's host walks, ``native.walk_to_cigars`` and
``wavefront_pallas._host_traceback_affine``, and of the XLA route's
``wavefront_xla._global_walk``, both its branches).

``wavefront_walk(P, i, j)`` walks every pair's pointer stream ``P`` (K, B,
Np) uint8, ``P[k, b, i]`` the byte of cell (i, j = k - i) (the layout of
``ops.wavefront.wavefront_fill``), from cell (i[b], j[b]) in state H
through the affine H/E/F state machine, until a STOP pointer in state H.
With ``affine=False`` it walks a linear-gap stream: only the byte's two
pointer bits (``p & 3``), no E/F state, as the JAX package's
``_host_traceback_linear`` and the linear branch of ``_global_walk``.
The stream holds the bytes of row 0 and column 0, so a walk ends at (0, 0)
with no implicit boundary run.  Returns ``(text, nchar, state)`` as
``strip_walk`` does: the CIGAR text of ``utils.cigar`` in rows of
``text_width(K)`` bytes (``nchar`` ``BAD_START`` for a pair whose start
cell lies outside the stream, i or j < 0, i >= Np or i + j >= K, which
walks nothing), and the walkers' final i, j, st, done; the final i and j
are the pair's ``qs`` and ``ts``.

A walk that would leave the matrix (i or j < 0; the fill's streams never
lead there) stops at that cell with done = 0.

A CPU tensor runs ``wavefront_walk_ref`` and refuses a start cell outside
the stream at once.  A CUDA tensor launches the kernel
(``csrc/wavefront_walk.cu``) and nothing else: no device-to-host sync and
no copy; the range check is deferred to ``cigars_from_text``, as
``strip_walk``'s is.  The kernel copies 16-byte segments of P: a CUDA P
must start 16-byte aligned and have Np a multiple of 16.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import PTR_DIAG, PTR_STOP, PTR_UP
from ..utils.cigar import (BAD_START, OP_D, OP_I, OP_M, OP_PAD, ST_E, ST_F, ST_H, bad_start,
                           op_rows_to_cigars, pack_text)
from . import launches

_EXT_E_BIT = 2
_EXT_F_BIT = 3


def text_width(K: int) -> int:
    """Bytes of a text row: a walk from a cell of the stream takes at most
    K ops, and a run of n ops at most 2n bytes."""
    return 2 * K


def _check(P, i, j):
    if P.dtype != torch.uint8 or P.dim() != 3:
        raise ValueError("wavefront_walk: P must be a (K, B, Np) uint8 tensor")
    B = P.shape[1]
    for v in (i, j):
        if v.dtype != torch.int32 or v.shape != (B,) or v.device != P.device:
            raise ValueError(f"wavefront_walk: i and j must be ({B},) int32 on {P.device}")


def _outside(P, i, j):
    K, _, Np = P.shape
    return (i < 0) | (j < 0) | (i >= Np) | (i + j >= K)


def wavefront_walk_ref(P, i, j, *, affine: bool = True):
    """Plain version: the lockstep walk of the JAX package's
    ``_host_traceback_affine`` (``affine=False``: of
    ``_host_traceback_linear``, the byte's two pointer bits), vectorized
    over pairs in NumPy, its op rows encoded with ``op_rows_to_cigars``
    and packed at the rows' ends."""
    K, B, Np = P.shape
    dev = P.device
    Ph = P.cpu().numpy()
    i0 = i.cpu().numpy().astype(np.int64)
    j0 = j.cpu().numpy().astype(np.int64)
    bad = _outside(P, i0, j0)
    ci, cj = np.where(bad, 0, i0), np.where(bad, 0, j0)
    st = np.zeros(B, np.int64)
    done = np.zeros(B, bool)
    live = ~bad
    barr = np.arange(B)
    ops = []
    while live.any():
        byte = Ph[np.maximum(ci + cj, 0), barr, np.maximum(ci, 0)].astype(np.int64)
        if not affine:
            byte &= 3
        ph = byte & 3
        in_h = st == ST_H
        stop = live & in_h & (ph == PTR_STOP)
        done |= stop
        live &= ~stop
        act_m = live & in_h & (ph == PTR_DIAG)
        act_i = live & ~act_m & ((in_h & (ph == PTR_UP)) | (st == ST_F))
        act_d = live & ~act_m & ~act_i
        ops.append(np.where(act_m, OP_M, np.where(act_i, OP_I,
                                                  np.where(act_d, OP_D, OP_PAD))))
        ext_e = (byte >> _EXT_E_BIT) & 1 == 1
        ext_f = (byte >> _EXT_F_BIT) & 1 == 1
        st = np.where(act_m, ST_H,
                      np.where(act_i, np.where(ext_f, ST_F, ST_H),
                               np.where(act_d, np.where(ext_e, ST_E, ST_H), st)))
        ci = ci - (act_m | act_i)
        cj = cj - (act_m | act_d)
        live &= (ci >= 0) & (cj >= 0)
    walked = (np.stack(ops, axis=1) if ops else np.full((B, 1), OP_PAD)).astype(np.uint8)
    strings = op_rows_to_cigars(walked[:, ::-1])
    text, nchar = pack_text(strings, text_width(K))
    nchar[bad] = BAD_START
    state = np.stack([np.where(bad, i0, ci), np.where(bad, j0, cj),
                      np.where(bad, ST_H, st), done.astype(np.int64)]).astype(np.int32)
    return (torch.from_numpy(text).to(dev), torch.from_numpy(nchar).to(dev),
            torch.from_numpy(state).to(dev))


def wavefront_walk(P, i, j, *, affine: bool = True):
    """Walk every pair; see the module docstring.  A CPU tensor runs
    ``wavefront_walk_ref``; a CUDA tensor the kernel.  Counts under
    ``wavefront_walk``, linear under ``wavefront_walk/linear``."""
    P = P.contiguous()
    i, j = i.to(torch.int32).contiguous(), j.to(torch.int32).contiguous()
    _check(P, i, j)
    K, B, Np = P.shape
    if P.device.type == "cpu":
        bad = _outside(P, i, j).nonzero()
        if len(bad):
            raise bad_start(int(bad[0, 0]))
        return wavefront_walk_ref(P, i, j, affine=affine)
    if P.device.type != "cuda":
        raise ValueError(f"wavefront_walk: unsupported device {P.device}")
    if P.data_ptr() % 16 or Np % 16:
        raise ValueError("wavefront_walk: on the card P must start 16-byte aligned and "
                         "have Np a multiple of 16")
    from .._build import launch

    W = text_width(K)
    text = torch.empty((B, W), dtype=torch.uint8, device=P.device)
    nchar = torch.empty((B,), dtype=torch.int32, device=P.device)
    out = torch.empty((4, B), dtype=torch.int32, device=P.device)
    if B == 0:
        return text, nchar, out
    launch("wavefront_walk", P.device, "seqalib_wavefront_walk", P.data_ptr(), K, B, Np,
           i.data_ptr(), j.data_ptr(), text.data_ptr(), W, nchar.data_ptr(),
           out.data_ptr(), int(not affine))
    launches["wavefront_walk" if affine else "wavefront_walk/linear"] += 1
    return text, nchar, out
