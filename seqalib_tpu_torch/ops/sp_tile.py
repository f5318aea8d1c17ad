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
for every tile, seconds per tile even on the card.

Three entry points launch it:

* ``sp_tile_run``: a run of T consecutive tiles of one block (columns
  ``j0 + 1 .. j0 + T * C``) in one launch, in ``"global"`` or ``"local"``
  mode: the same outputs as T chained ``sp_tile`` calls, the bottom rows
  over all T * C columns, and with ``want_cols`` the right column of every
  tile, (T, R), which the traceback keeps as the next tile's boundary;
* ``sp_tile_ptr``: K pointer tiles of one block side by side, tile g at
  columns ``j0 - g * C + 1 ..``, each from its own boundaries, on the rows
  ``qb`` holds (the rows a walk can still reach);
* ``sp_tile``: one tile in any mode.

The kernel cuts a tile's rows into strips of ``strip`` rows (a multiple
of 32 up to 1024, ``DEFAULT_STRIP`` by default), one CTA each, pipelined
along the columns; it changes no output.
"""

from __future__ import annotations

import torch

from ..types import PTR_DIAG, PTR_LEFT, PTR_UP
from . import launches

MODES = {"global": 0, "local": 1, "ptr": 2}
NEG = -(1 << 28)  # band_pipeline.NEG: dominates any score, no int32 overflow
MAX_STRIP = 1024
# rows per CTA: a 16 384-row block is 128 strips, about one per SM
DEFAULT_STRIP = 128
REF_CHUNK = 64  # substeps whose scores the plain version gathers at once
# the kernel keeps the score table in shared memory
MAX_TABLE = 66


def ptr_index(p, c, C: int):
    """Where the pointer tile keeps the byte of the tile's row ``p``
    (0-based) and column ``c`` (1-based)."""
    return (p + c - 1) % C, p


def default_strip(R: int) -> int:
    """The kernel's strip height for an R-row tile: R rounded up to a
    warp, at most ``DEFAULT_STRIP``."""
    return min(DEFAULT_STRIP, -(-max(R, 1) // 32) * 32)


def _check(qb, tk, htop, ftop, hcol, ecol, cap, tab, C, mode, strip, K=None, W=None):
    """Types, shapes and devices of one launch: a run of W columns (K is
    None) or K stacked tiles of C columns."""
    if mode not in MODES:
        raise ValueError(f"sp_tile: unknown mode {mode!r}")
    dev = qb.device
    R = qb.shape[0] if qb.dim() == 1 else -1
    if K is None:
        W = W or C
        shapes = (("qb", qb, (R,)), ("tk", tk, (W + 1,)), ("htop", htop, (W + 1,)),
                  ("ftop", ftop, (W,)), ("hcol", hcol, (R,)), ("ecol", ecol, (R,)),
                  ("cap", cap, (1,)))
    else:
        shapes = (("qb", qb, (R,)), ("tk", tk, (K * C + 1,)), ("htop", htop, (K, C + 1)),
                  ("ftop", ftop, (K, C)), ("hcol", hcol, (K, R)), ("ecol", ecol, (K, R)),
                  ("cap", cap, (1,)))
    if R < 1 or C < 1 or (W is not None and (W < C or W % C)) or (K is not None and K < 1):
        raise ValueError("sp_tile: need R >= 1 rows and whole tiles of C >= 1 columns")
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
    Python step per anti-diagonal substep (int32, the kernel's values).
    The letters' scores are gathered ``REF_CHUNK`` substeps at a time, and
    what touches one lane of a substep (the left column, the right column,
    the capture) is indexed, not masked."""
    del strip  # the whole tile is one sweep here
    dev = qb.device
    R = qb.shape[0]
    lanes = torch.arange(R, device=dev)
    e = gap_extend
    oe = gap_open + gap_extend
    i32 = dict(dtype=torch.int32, device=dev)
    # distinct tensors: lane k of H1 and E1 is overwritten in place below
    H1, H2, E1, F1 = (torch.full((R,), NEG, **i32) for _ in range(4))
    if tab is not None:
        NT = tab.shape[0]
        tabf = tab.flatten()
        qrow = qb.clamp(0, NT - 1).long() * NT
        tkc = tk.clamp(0, NT - 1).long()
    # the capture: global, the one cell (n, m); local, rows <= n, columns <= m
    pn, cm = n - i0 - 1, m - j0
    if mode == "local":
        pn, cm = min(pn, R - 1), min(cm, C)
    hits, hcs, ecs, hlast, flast, ptrs = [], [], [], [], [], []
    for k in range(R + C - 1):
        x = k % REF_CHUNK
        if x == 0:  # the scores of substeps k .. k + REF_CHUNK - 1, lane by lane
            ks = torch.arange(k, min(k + REF_CHUNK, R + C - 1), device=dev)[:, None]
            W = (ks - lanes + 1).clamp(0, C)
            if tab is not None:
                S = tabf[qrow + tkc[W]]
            else:
                S = torch.where(qb == tk[W], match, mismatch).to(torch.int32)
        # lane p holds column c = k - p + 1; lane k is at column 1, whose
        # left neighbours are the tile's left column
        up_H = torch.cat([htop[min(k + 1, C)].view(1), H1[:-1]])
        up_F = torch.cat([ftop[min(k, C - 1)].view(1), F1[:-1]])
        diag = torch.cat([htop[min(k, C)].view(1), H2[:-1]])
        if k < R:
            H1[k] = hcol[k]
            E1[k] = ecol[k]
            if k >= 1:
                diag[k] = hcol[k - 1]
        e_ext, e_opn = E1 + e, H1 + oe
        f_ext, f_opn = up_F + e, up_H + oe
        E_new = torch.maximum(e_ext, e_opn)
        F_new = torch.maximum(f_ext, f_opn)
        dval = diag + S[x]
        H_new = torch.maximum(dval, torch.maximum(E_new, F_new))
        if mode == "local":
            H_new = H_new.clamp(min=0)
            lo, hi = max(0, k + 1 - cm), min(k, pn)
            if lo <= hi:
                hits.append(H_new[lo: hi + 1].max())
        elif k == pn + cm - 1 and 0 <= pn < R and 1 <= cm <= C:
            hits.append(H_new[pn])
        if k >= C - 1:  # lane k - C + 1 is at the right column
            hcs.append(H_new[k - C + 1: k - C + 2])
            ecs.append(E_new[k - C + 1: k - C + 2])
        if k >= R - 1:  # the bottom row
            hlast.append(H_new[R - 1:])
            flast.append(F_new[R - 1:])
        if mode == "ptr":
            ph = torch.where(dval == H_new, PTR_DIAG,
                             torch.where(F_new == H_new, PTR_UP, PTR_LEFT))
            byte = ph | ((e_ext >= e_opn).int() << 2) | ((f_ext >= f_opn).int() << 3)
            ptrs.append(byte.to(torch.uint8))
        H2, H1, E1, F1 = H1, H_new, E_new, F_new
    best = torch.stack(hits).max() if hits else torch.tensor(NEG, **i32)
    out = {
        "hbot": torch.cat(hlast).to(torch.int32),
        "fbot": torch.cat(flast).to(torch.int32),
        "hcol": torch.cat(hcs),  # every lane reaches column C
        "ecol": torch.cat(ecs),
        "cap": torch.maximum(cap, best).view(1).to(torch.int32),
    }
    if mode == "ptr":  # substep k = c + p - 1 holds row p's column c
        slot = torch.arange(C, device=dev)[:, None]
        out["ptr"] = torch.stack(ptrs)[lanes + (slot - lanes) % C, lanes]
    return out


def sp_tile_run_ref(qb, tk, htop, ftop, hcol, ecol, cap, tab, *, i0: int, j0: int,
                    n: int, m: int, C: int, match: int, mismatch: int, gap_open: int,
                    gap_extend: int, mode: str, strip: int = 0, want_cols: bool = False):
    """Plain version of a run: T successive ``sp_tile_ref`` calls, each
    tile's right column the next one's left."""
    T = ftop.shape[0] // C
    kw = dict(n=n, m=m, C=C, match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend, mode=mode, strip=strip)
    hbot, fbot, hcols, ecols = [], [], [], []
    for t in range(T):
        x = t * C
        out = sp_tile_ref(qb, tk[x: x + C + 1], htop[x: x + C + 1], ftop[x: x + C], hcol,
                          ecol, cap, tab, i0=i0, j0=j0 + x, **kw)
        hcol, ecol, cap = out["hcol"], out["ecol"], out["cap"]
        hbot.append(out["hbot"])
        fbot.append(out["fbot"])
        hcols.append(hcol)
        ecols.append(ecol)
    res = {"hbot": torch.cat(hbot), "fbot": torch.cat(fbot), "hcol": hcol, "ecol": ecol,
           "cap": cap}
    if want_cols:
        res["hcols"], res["ecols"] = torch.stack(hcols), torch.stack(ecols)
    return res


def sp_tile_ptr_ref(qb, tk, htop, ftop, hcol, ecol, cap, tab, *, i0: int, j0: int,
                    n: int, m: int, C: int, match: int, mismatch: int, gap_open: int,
                    gap_extend: int, strip: int = 0):
    """Plain version of a pointer batch: one ``sp_tile_ref`` per tile, on
    the rows ``qb`` holds; the outputs stacked, the captures merged."""
    K = htop.shape[0]
    outs = []
    for g in range(K):
        x = (K - 1 - g) * C  # tile g's letters in tk
        outs.append(sp_tile_ref(qb, tk[x: x + C + 1], htop[g], ftop[g], hcol[g], ecol[g],
                                cap, tab, i0=i0, j0=j0 - g * C, n=n, m=m, C=C,
                                match=match, mismatch=mismatch, gap_open=gap_open,
                                gap_extend=gap_extend, mode="ptr"))
    res = {k: torch.stack([o[k] for o in outs]) for k in ("hbot", "fbot", "hcol", "ecol",
                                                         "ptr")}
    res["cap"] = torch.stack([o["cap"] for o in outs]).max(0).values
    return res


def _launch(qb, tk, htop, ftop, hcol, ecol, cap, tab, *, i0, j0, jt, n, m, C, W, G,
            match, mismatch, gap_open, gap_extend, mode, strip, want_cols):
    """One kernel launch over G tiles of W columns; the outputs."""
    from .._build import launch

    dev = qb.device
    R = qb.shape[0]
    strip = strip or default_strip(R)
    nstrip = -(-R // strip)
    i32 = dict(dtype=torch.int32, device=dev)
    ncol = W // C if want_cols else G
    out = {"hbot": torch.empty((G, W), **i32), "fbot": torch.empty((G, W), **i32),
           "hcols": torch.empty((ncol, R), **i32), "ecols": torch.empty((ncol, R), **i32),
           "cap": cap.clone()}
    ptr = None
    if mode == "ptr":
        ptr = out["ptr"] = torch.empty((G, C, R), dtype=torch.uint8, device=dev)
    xh = torch.empty((G * (nstrip - 1), W), **i32)
    xf = torch.empty_like(xh)
    sync = torch.zeros(1 + G * nstrip, **i32)
    launch(
        "sp_tile", dev, "seqalib_sp_run",
        qb.data_ptr(), tk.data_ptr(), htop.data_ptr(), ftop.data_ptr(),
        hcol.data_ptr(), ecol.data_ptr(), tab.data_ptr() if tab is not None else None,
        tab.shape[0] if tab is not None else 0, match, mismatch, R, W, C, G, i0, j0, jt,
        n, m, gap_open, gap_extend, MODES[mode], strip,
        out["hbot"].data_ptr(), out["fbot"].data_ptr(), out["hcols"].data_ptr(),
        out["ecols"].data_ptr(), int(want_cols), out["cap"].data_ptr(),
        ptr.data_ptr() if ptr is not None else None, xh.data_ptr(), xf.data_ptr(),
        sync.data_ptr(),
    )
    return out


def _cuda_or_cpu(x, name):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type == "cpu"


def sp_tile_run(qb, tk, htop, ftop, hcol, ecol, cap, tab, *, i0: int, j0: int, n: int,
                m: int, C: int, match: int, mismatch: int, gap_open: int, gap_extend: int,
                mode: str, strip: int = 0, want_cols: bool = False):
    """A run of T = ``len(ftop) // C`` consecutive tiles of one block in
    one launch; see the module docstring.  ``tk``/``htop`` (T * C + 1,),
    ``ftop`` (T * C,).  Returns ``hbot``/``fbot`` (T * C,), ``hcol``/
    ``ecol`` (R,) of the last tile's right column, ``cap``, and with
    ``want_cols`` ``hcols``/``ecols`` (T, R).  No input is modified.  A CPU
    tensor runs ``sp_tile_run_ref``; a CUDA tensor the kernel, counted
    under ``sp_tile/{mode}`` (T = 1) or ``sp_tile/run_{mode}``."""
    qb, tk, htop, ftop, hcol, ecol, cap = (
        x.contiguous() for x in (qb, tk, htop, ftop, hcol, ecol, cap))
    if tab is not None:
        tab = tab.contiguous()
    if mode == "ptr":
        raise ValueError("sp_tile_run: a run fills (global, local); sp_tile_ptr emits pointers")
    W = ftop.shape[0] if ftop.dim() == 1 else -1
    _check(qb, tk, htop, ftop, hcol, ecol, cap, tab, C, mode, strip, W=W)
    kw = dict(i0=i0, j0=j0, n=n, m=m, C=C, match=match, mismatch=mismatch,
              gap_open=gap_open, gap_extend=gap_extend, mode=mode, strip=strip,
              want_cols=want_cols)
    if _cuda_or_cpu(qb, "sp_tile_run"):
        return sp_tile_run_ref(qb, tk, htop, ftop, hcol, ecol, cap, tab, **kw)
    out = _launch(qb, tk, htop, ftop, hcol, ecol, cap, tab, jt=j0, W=W, G=1, **kw)
    res = {"hbot": out["hbot"][0], "fbot": out["fbot"][0], "hcol": out["hcols"][-1],
           "ecol": out["ecols"][-1], "cap": out["cap"]}
    if want_cols:
        res["hcols"], res["ecols"] = out["hcols"], out["ecols"]
    T = W // C
    launches[f"sp_tile/{mode}" if T == 1 else f"sp_tile/run_{mode}"] += 1
    return res


def sp_tile_ptr(qb, tk, htop, ftop, hcol, ecol, cap, tab, *, i0: int, j0: int, n: int,
                m: int, C: int, match: int, mismatch: int, gap_open: int,
                gap_extend: int, strip: int = 0):
    """K pointer tiles of one block in one launch; see the module
    docstring.  Tile g covers columns ``j0 - g * C + 1 .. j0 - g * C + C``
    and rows ``i0 + 1 .. i0 + len(qb)``; ``htop`` (K, C + 1), ``ftop`` (K,
    C), ``hcol``/``ecol`` (K, len(qb)) its boundaries, ``tk`` (K * C + 1,)
    the letters of columns ``j0 - (K - 1) * C .. j0 + C``.  Returns
    ``ptr`` (K, C, R) and each tile's ``hbot``/``fbot`` (K, C), ``hcol``/
    ``ecol`` (K, R), and ``cap`` (1,).  A CPU tensor runs
    ``sp_tile_ptr_ref``; a CUDA tensor the kernel, counted under
    ``sp_tile/ptr`` (K = 1) or ``sp_tile/ptr_batch``."""
    qb, tk, htop, ftop, hcol, ecol, cap = (
        x.contiguous() for x in (qb, tk, htop, ftop, hcol, ecol, cap))
    if tab is not None:
        tab = tab.contiguous()
    K = htop.shape[0] if htop.dim() == 2 else 0
    _check(qb, tk, htop, ftop, hcol, ecol, cap, tab, C, "ptr", strip, K=K)
    kw = dict(i0=i0, j0=j0, n=n, m=m, C=C, match=match, mismatch=mismatch,
              gap_open=gap_open, gap_extend=gap_extend, strip=strip)
    if _cuda_or_cpu(qb, "sp_tile_ptr"):
        return sp_tile_ptr_ref(qb, tk, htop, ftop, hcol, ecol, cap, tab, **kw)
    out = _launch(qb, tk, htop, ftop, hcol, ecol, cap, tab, jt=j0 - (K - 1) * C, W=C,
                  G=K, mode="ptr", want_cols=False, **kw)
    launches["sp_tile/ptr" if K == 1 else "sp_tile/ptr_batch"] += 1
    return {"hbot": out["hbot"], "fbot": out["fbot"], "hcol": out["hcols"],
            "ecol": out["ecols"], "cap": out["cap"], "ptr": out["ptr"]}


def sp_tile(qb, tk, htop, ftop, hcol, ecol, cap, tab, *, i0: int, j0: int, n: int,
            m: int, C: int, match: int, mismatch: int, gap_open: int,
            gap_extend: int, mode: str, strip: int = 0):
    """Compute one tile in any mode; see the module docstring: a run of
    one tile, or a pointer batch of one.  No input is modified."""
    kw = dict(i0=i0, j0=j0, n=n, m=m, C=C, match=match, mismatch=mismatch,
              gap_open=gap_open, gap_extend=gap_extend, strip=strip)
    if mode != "ptr":
        return sp_tile_run(qb, tk, htop, ftop, hcol, ecol, cap, tab, mode=mode, **kw)
    one = [x.reshape(1, -1) for x in (htop, ftop, hcol, ecol)]
    out = sp_tile_ptr(qb, tk, *one, cap, tab, **kw)
    return {k: v[0] if k != "cap" else v for k, v in out.items()}
