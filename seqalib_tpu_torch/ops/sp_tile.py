"""One R x C Gotoh tile of ONE long pair (counterpart of
``seqalib_tpu/ops/sp_tile_pallas.py::sp_tile`` and of its XLA twin
``seqalib_tpu/parallel/band_pipeline.py::_tile_scan``).

The sequence-parallel pipeline (``parallel/band_pipeline.py``) splits a
pair's DP matrix into row-blocks of R rows times column tiles of C
columns; a tile starts at global row ``i0`` (rows ``i0 + 1 .. i0 + R``)
and column ``j0`` (columns ``j0 + 1 .. j0 + C``).  Boundary protocol:

* in: ``qb`` (R,) the block's query letters; ``tk`` (C + 1,) the tile's
  target letters, ``tk[c]`` = letter of column ``j0 + c`` (``tk[0]`` is
  not read); ``htop`` (C + 1,) H of row ``i0`` at columns ``j0 .. j0 + C``
  (the corner first); ``ftop`` (C,) F of row ``i0`` at columns
  ``j0 + 1 .. j0 + C``; ``hcol``/``ecol`` (R,) H/E of column ``j0``;
  ``cap`` (1,) the running capture;
* out: ``hbot``/``fbot`` (C,) H/F of the tile's bottom row, ``hcol``/
  ``ecol`` (R,) H/E of its right column ``j0 + C``, ``cap`` (1,) the
  capture max-merged with this tile's, and in ``"ptr"`` mode ``ptr``.

Modes:

* ``"global"``: ``_sp_tile_kernel``'s tile; the capture is cell (n, m),
  taken only by the tile that owns column m (``c`` in 1..C);
* ``"local"``: Smith-Waterman, H clamped at 0; the capture is the running
  max over every cell with row <= n and column <= m
  (``_tile_scan(local=True)``);
* ``"ptr"``: the global recurrence, plus the (C, R) uint8 pointer tile:
  cell (row ``i0 + p + 1``, column ``j0 + c``) at ``[(p + c - 1) % C, p]``
  (``ptr_index``), the byte ``PTR_* | ext_e << 2 | ext_f << 3`` with the
  oracle's tie-breaks (diag, then up (F), then left (E); extend wins ties
  against open).  This is the anti-diagonal layout ``[c + p - 1, p]`` of
  ``_tile_scan(want_ptr=True)`` folded modulo C: the kernel's bytes of
  one anti-diagonal stay one contiguous run, and the tile holds R x C
  bytes, not (R + C - 1) x R.

Scoring: ``tab`` (NT, NT) int32, ``tab[qletter, tletter]`` with letters
clamped to [0, NT - 1], for any table (the Pallas tile refuses tables
outside the packed-nibble range; this lookup answers as the XLA body);
or, with ``tab=None``, ``match`` when the two letters are equal and
``mismatch`` otherwise.

In JAX the ``local`` and ``ptr`` modes are XLA scans, not Pallas; here all
three are one CUDA kernel (``csrc/sp_tile.cu``), because the plain version
below takes one Python step per anti-diagonal substep: at one device a
10 kb pair's tile is 10 240 rows tall, so ~10^4 substeps of ~20 tensor ops
for every tile, seconds per tile even on the card.  ``strip`` sets the
kernel's strip height (rows computed together, a multiple of 32 up to
1024); it changes no output.
"""

from __future__ import annotations

import torch

from ..types import PTR_DIAG, PTR_LEFT, PTR_UP
from . import launches

MODES = {"global": 0, "local": 1, "ptr": 2}
NEG = -(1 << 28)  # band_pipeline.NEG: dominates any score, no int32 overflow
MAX_STRIP = 1024
# the kernel keeps the score table in shared memory
MAX_TABLE = 66


def ptr_index(p, c, C: int):
    """Where the pointer tile keeps the byte of the tile's row ``p``
    (0-based) and column ``c`` (1-based)."""
    return (p + c - 1) % C, p


def default_strip(R: int) -> int:
    """The kernel's strip height for an R-row tile: R rounded up to a
    warp, at most ``MAX_STRIP``."""
    return min(MAX_STRIP, -(-max(R, 1) // 32) * 32)


def _check(qb, tk, htop, ftop, hcol, ecol, cap, tab, C, mode, strip):
    if mode not in MODES:
        raise ValueError(f"sp_tile: unknown mode {mode!r}")
    dev = qb.device
    R = qb.shape[0] if qb.dim() == 1 else -1
    shapes = (("qb", qb, (R,)), ("tk", tk, (C + 1,)), ("htop", htop, (C + 1,)),
              ("ftop", ftop, (C,)), ("hcol", hcol, (R,)), ("ecol", ecol, (R,)),
              ("cap", cap, (1,)))
    if R < 1 or C < 1:
        raise ValueError("sp_tile: need R >= 1 rows and C >= 1 columns")
    for name, x, shape in shapes:
        if x.dtype != torch.int32 or x.device != dev or tuple(x.shape) != shape:
            raise ValueError(f"sp_tile: {name} must be {shape} int32 on {dev}")
    if tab is not None:
        NT = tab.shape[0]
        if (tab.dtype != torch.int32 or tab.device != dev or tab.shape != (NT, NT)
                or not 1 <= NT <= MAX_TABLE):
            raise ValueError(f"sp_tile: tab must be (NT, NT) int32, NT <= {MAX_TABLE}")
    if strip and (strip % 32 or not 32 <= strip <= MAX_STRIP):
        raise ValueError(f"sp_tile: strip must be a multiple of 32 up to {MAX_STRIP}")


def sp_tile_ref(qb, tk, htop, ftop, hcol, ecol, cap, tab, *, i0: int, j0: int,
                n: int, m: int, C: int, match: int, mismatch: int, gap_open: int,
                gap_extend: int, mode: str, strip: int = 0):
    """Plain PyTorch version: ``_tile_scan``'s lane-per-row sweep, one
    Python step per anti-diagonal substep (int32, the kernel's values)."""
    del strip  # the whole tile is one sweep here
    dev = qb.device
    R = qb.shape[0]
    lanes = torch.arange(R, device=dev)
    ivec = i0 + lanes + 1
    e = gap_extend
    oe = gap_open + gap_extend
    i32 = dict(dtype=torch.int32, device=dev)
    neg = torch.full((R,), NEG, **i32)
    H1, H2, E1, F1 = neg, neg, neg, neg
    hc_out, ec_out = hcol.clone(), ecol.clone()
    best = neg
    if tab is not None:
        NT = tab.shape[0]
        tabf = tab.flatten()
        qrow = qb.clamp(0, NT - 1).long() * NT
        tkc = tk.clamp(0, NT - 1).long()
    hlast, flast, ptrs = [], [], []
    for k in range(R + C - 1):
        c = k - lanes + 1
        valid = (c >= 1) & (c <= C)
        W = c.clamp(0, C)
        if tab is not None:
            s = tabf[qrow + tkc[W]]
        else:
            s = torch.where(qb == tk[W], match, mismatch).to(torch.int32)
        up_H = torch.cat([htop[min(k + 1, C)].view(1), H1[:-1]])
        up_F = torch.cat([ftop[min(k, C - 1)].view(1), F1[:-1]])
        diag = torch.cat([htop[min(k, C)].view(1),
                          torch.where(c[1:] == 1, hcol[:-1], H2[:-1])])
        at_c1 = c == 1
        left_H = torch.where(at_c1, hcol, H1)
        left_E = torch.where(at_c1, ecol, E1)
        e_ext, e_opn = left_E + e, left_H + oe
        f_ext, f_opn = up_F + e, up_H + oe
        E_new = torch.maximum(e_ext, e_opn)
        F_new = torch.maximum(f_ext, f_opn)
        dval = diag + s
        H_new = torch.maximum(dval, torch.maximum(E_new, F_new))
        if mode == "local":
            H_new = H_new.clamp(min=0)
        at_cC = c == C
        hc_out = torch.where(at_cC, H_new, hc_out)
        ec_out = torch.where(at_cC, E_new, ec_out)
        jvec = j0 + c
        if mode == "local":
            hit = valid & (ivec <= n) & (jvec <= m)
        else:
            hit = valid & (ivec == n) & (jvec == m)
        best = torch.maximum(best, torch.where(hit, H_new, NEG))
        hlast.append(H_new[-1])
        flast.append(F_new[-1])
        if mode == "ptr":
            ph = torch.where(dval == H_new, PTR_DIAG,
                             torch.where(F_new == H_new, PTR_UP, PTR_LEFT))
            byte = ph | ((e_ext >= e_opn).int() << 2) | ((f_ext >= f_opn).int() << 3)
            ptrs.append(byte.to(torch.uint8))
        H2, H1, E1, F1 = H1, H_new, E_new, F_new
    out = {
        "hbot": torch.stack(hlast[R - 1:]).to(torch.int32),
        "fbot": torch.stack(flast[R - 1:]).to(torch.int32),
        "hcol": hc_out,
        "ecol": ec_out,
        "cap": torch.maximum(cap, best.max()).view(1).to(torch.int32),
    }
    if mode == "ptr":  # substep k = c + p - 1 holds row p's column c
        slot = torch.arange(C, device=dev)[:, None]
        out["ptr"] = torch.stack(ptrs)[lanes + (slot - lanes) % C, lanes]
    return out


def sp_tile(qb, tk, htop, ftop, hcol, ecol, cap, tab, *, i0: int, j0: int, n: int,
            m: int, C: int, match: int, mismatch: int, gap_open: int,
            gap_extend: int, mode: str, strip: int = 0):
    """Compute one tile; see the module docstring.  No input is modified.
    A CPU tensor runs ``sp_tile_ref``; a CUDA tensor the kernel."""
    qb, tk, htop, ftop, hcol, ecol, cap = (
        x.contiguous() for x in (qb, tk, htop, ftop, hcol, ecol, cap))
    if tab is not None:
        tab = tab.contiguous()
    _check(qb, tk, htop, ftop, hcol, ecol, cap, tab, C, mode, strip)
    kw = dict(i0=i0, j0=j0, n=n, m=m, C=C, match=match, mismatch=mismatch,
              gap_open=gap_open, gap_extend=gap_extend, mode=mode)
    if qb.device.type == "cpu":
        return sp_tile_ref(qb, tk, htop, ftop, hcol, ecol, cap, tab, **kw)
    if qb.device.type != "cuda":
        raise ValueError(f"sp_tile: unsupported device {qb.device}")
    from .._build import check, current_stream, lib

    dev = qb.device
    R = qb.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    out = {"hbot": torch.empty(C, **i32), "fbot": torch.empty(C, **i32),
           "hcol": torch.empty(R, **i32), "ecol": torch.empty(R, **i32),
           "cap": torch.empty(1, **i32)}
    ptr = None
    if mode == "ptr":
        ptr = out["ptr"] = torch.empty((C, R), dtype=torch.uint8, device=dev)
    stream = current_stream(dev)
    rc = lib().seqalib_sp_tile(
        qb.data_ptr(), tk.data_ptr(), htop.data_ptr(), ftop.data_ptr(),
        hcol.data_ptr(), ecol.data_ptr(), cap.data_ptr(),
        tab.data_ptr() if tab is not None else None,
        tab.shape[0] if tab is not None else 0, match, mismatch, R, C, i0, j0, n, m,
        gap_open, gap_extend, MODES[mode], strip or default_strip(R),
        out["hbot"].data_ptr(), out["fbot"].data_ptr(), out["hcol"].data_ptr(),
        out["ecol"].data_ptr(), out["cap"].data_ptr(),
        ptr.data_ptr() if ptr is not None else None, stream,
    )
    check("sp_tile", rc)
    launches[f"sp_tile/{mode}"] += 1
    return out
