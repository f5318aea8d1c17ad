"""Banded affine fill (counterpart of ``banded_pallas.band_fill_range`` /
``_band_kernel``).

The band of a bucket is the diagonal span ``dlo <= j - i <= dhi``.  On
anti-diagonal ``k`` slot ``p`` holds cell ``i = ihat(k) + p``,
``j = k - i``, with ``ihat(k) = max(0, floor((k - dhi + 1) / 2))``; a
state row is ``Wp`` slots wide, so the state is O(band), whatever the
lengths.  Neighbours: left ``H[k-1][p+d1]``, up ``H[k-1][p+d1-1]``,
diagonal ``H[k-2][p+d2-1]`` with ``d1 = ihat(k) - ihat(k-1)``,
``d2 = ihat(k) - ihat(k-2)``; slot indices wrap around ``Wp`` (the TPU
kernel's circular lane rolls), which only ever brings in a slot that is
NEG or a cell that is thrown away.

Inputs, for a batch of B pairs:

* ``qk`` (B, Lq) / ``tk`` (B, Lt) int32 letters, 1-based:
  ``qk[:, x] = q[x - 1]``, ``tk[:, x] = t[x - 1]``; index 0 and every
  index past a sequence hold a sentinel letter, and reads past the arrays
  take letter ``NT - 1``.  A slot whose column is negative reads letter 0
  (the TPU kernel's target window starts zeroed); such cells are masked
  or never win;
* ``tab`` (NT, NT) int32: ``tab[qletter, tletter]`` is the score.  The
  caller builds it so that every sentinel scores as the TPU kernel scores
  it (``band_table``);
* ``qlen``, ``tlen``, ``dlo_p``, ``dhi_p`` (B,) int32: each pair's lengths
  and its own band bounds (the bucket's ``dlo``/``dhi`` only set the slot
  geometry);
* ``state`` (NS, B, Wp) int32: H at k-1, H at k-2, E and F at k-1 (all
  NEG_INF to start at k = 0); in ``emode`` also BV and BK;
* ``score`` (B, Wp) int32: the running final-cell capture (``fill``) or
  the ``tie_safe`` edge bound EV (``emode``), NEG_INF to start.

Modes, over diagonals ``[k0, k1)``:

* ``"fill"``: cells outside the pair's band or matrix are NEG_INF; the
  final cell (qlen, tlen) is max-merged into ``score`` at
  ``k == qlen + tlen < K``; with ``CK`` the state entering every CK-th
  diagonal is kept (``ckpt`` (NC, 4, B, Wp));
* ``"ptr"``: the same recurrence, emitting each cell's pointer nibble
  ``PTR_* | ext_e << 2 | ext_f << 3``, two diagonals per byte
  (``ptr[(k - k0) // 2, b, p]``, even ``k - k0`` in the low nibble);
* ``"emode"``: no mask (the slot window is the band); H is floored at
  ``EMODE_FLOOR`` (cells past the pair sink a gap or a mismatch a
  diagonal: near int32's range they wrapped on the card); slot ``Wp - 1``
  is forced to NEG_INF; BV/BK keep each slot's first maximum and its
  diagonal (strict ``>``); with ``tie_safe``, EV[p] keeps
  ``max(cand - smax * i)`` where cand is E at slot 0 once ``k > dhi`` and
  F at slot ``Wp - 2``.

Banded sequence parallelism (``parallel/banded_sp.py``) resumes a row
block from the block above it, in ``fill`` and ``ptr`` modes:

* ``bh``, ``bf`` (B, Wb) int32: local row 0 is the previous block's last
  row.  On every diagonal ``k <= dhi``, after the mask and the origin,
  slot 0 (cell (0, k)) takes H = ``bh[:, min(k, Wb - 1)]`` and F =
  ``bf[:, min(k, Wb - 1)]``; E is never injected (row 1 does not read it).
  The pointer nibbles still come from the unmasked values;
* ``want_bout``: ``out["bout"]`` (2, B, Wbo) int32, ``Wbo =
  ceil(dhi - dlo + 1, 128)``, captures row ``bout_row``: on diagonal k,
  column ``x = k - 2 * bout_row`` (when ``0 <= x < Wbo``) takes H and F of
  slot ``bout_row - ihat(k)``, or 0 when that slot lies outside
  ``[0, Wp)`` (the TPU kernel's sum over an empty mask).  Columns no
  diagonal of ``[k0, k1)`` reaches stay NEG_INF.

Returns a dict with ``state`` and ``score`` after ``k1 - 1``, plus
``ckpt``, ``ptr`` or ``bout``.  Kernel: ``csrc/band_fill.cu`` (slot rows
in registers up to Wp ``MAX_WP_REGISTERS``, in a global scratch above).
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import NEG_INF, PTR_DIAG, PTR_LEFT, PTR_STOP, PTR_UP
from . import launches

MODES = {"fill": 0, "ptr": 1, "emode": 2}
LANES = 128
REF_CHUNK = 64  # diagonals whose scores and mask the plain version gathers at once
# emode's floor for H (csrc/band_fill.cu kEmodeFloor, which says why no int32
# sum wraps above it); no cell of the pair, and no cell at the usual scales,
# comes near it
EMODE_FLOOR = -(1 << 30) - (1 << 29)
# the kernel keeps the (NT, NT) score table in shared memory: the 63
# letters strip_fill takes, plus the zero sentinel row and two sentinels
MAX_TABLE = 66
# the kernel runs one CTA of at most 512 threads per pair, each thread
# holding at most 16 slots in registers; wider slot rows go to its wide
# variant, which keeps them in a global scratch of 7 rows per pair
MAX_WP_REGISTERS = 16 * 512


def n_state(mode: str) -> int:
    """Rows of ``state``: H1, H2, E, F, plus BV, BK in ``emode``."""
    return 6 if mode == "emode" else 4


def ihat(k: int, dhi: int) -> int:
    """First band row on anti-diagonal ``k`` (floor division)."""
    return max(0, (k - dhi + 1) // 2)


def band_table(table: np.ndarray, sent_score: int) -> np.ndarray:
    """(A + 2, A + 2) int32 score table for ``band_fill``: ``table`` over
    the A real letters, and ``sent_score`` for every pair that involves
    letter A or A + 1, the query and target sentinels."""
    A = int(np.asarray(table).shape[0])
    out = np.full((A + 2, A + 2), sent_score, np.int32)
    out[:A, :A] = np.asarray(table)
    return out


def bout_width(dlo: int, dhi: int) -> int:
    """Columns of the boundary capture: the bucket's band span, rounded up
    to the TPU kernel's 128 lanes."""
    return -(-(dhi - dlo + 1) // LANES) * LANES


def _check(qk, tk, vecs, state, score, tab, mode, k0, k1, CK, bh, bf, want_bout,
           bout_row):
    if mode not in MODES:
        raise ValueError(f"band_fill: unknown mode {mode!r}")
    dev = qk.device
    for name, x in (("qk", qk), ("tk", tk), ("state", state), ("score", score),
                    ("tab", tab)):
        if x.dtype != torch.int32 or x.device != dev:
            raise ValueError(f"band_fill: {name} must be int32 on {dev}")
    if qk.dim() != 2 or tk.dim() != 2 or tk.shape[0] != qk.shape[0]:
        raise ValueError("band_fill: qk and tk must be (B, Lq) and (B, Lt)")
    B = qk.shape[0]
    if state.dim() != 3 or state.shape[:2] != (n_state(mode), B):
        raise ValueError(f"band_fill: state must be ({n_state(mode)}, {B}, Wp)")
    Wp = state.shape[2]
    if Wp < 2 or score.shape != (B, Wp):
        raise ValueError(f"band_fill: score must be ({B}, {Wp}), Wp >= 2")
    for v in vecs:
        if v.dtype != torch.int32 or v.shape != (B,) or v.device != dev:
            raise ValueError(f"band_fill: per-pair vectors must be ({B},) int32")
    NT = tab.shape[0]
    if tab.shape != (NT, NT) or not 1 <= NT <= MAX_TABLE:
        raise ValueError(f"band_fill: tab must be (NT, NT) with NT <= {MAX_TABLE}")
    if not 0 <= k0 <= k1:
        raise ValueError("band_fill: need 0 <= k0 <= k1")
    if mode == "ptr" and (k1 - k0) % 2:
        raise ValueError("band_fill: ptr mode packs two diagonals: k1 - k0 must be even")
    if CK < 0 or (CK and mode != "fill"):
        raise ValueError("band_fill: checkpoints (CK > 0) are a fill-mode output")
    if (bh is None) != (bf is None):
        raise ValueError("band_fill: bh and bf come together")
    if (bh is not None or want_bout) and mode == "emode":
        raise ValueError("band_fill: boundary injection and capture are fill/ptr modes")
    if bh is not None:
        for name, x in (("bh", bh), ("bf", bf)):
            if (x.dtype != torch.int32 or x.device != dev or x.dim() != 2
                    or x.shape[0] != B or x.shape[1] < 1 or x.shape != bh.shape):
                raise ValueError(f"band_fill: {name} must be ({B}, Wb) int32 on {dev}")
    if bout_row < 0:
        raise ValueError("band_fill: bout_row must be >= 0")


def band_fill_ref(qk, tk, qlen, tlen, dlo_p, dhi_p, state, score, tab, *,
                  k0: int, k1: int, K: int, dlo: int, dhi: int, gap_open: int,
                  gap_extend: int, mode: str, CK: int = 0, tie_safe: bool = False,
                  smax: int = 0, bh=None, bf=None, want_bout: bool = False,
                  bout_row: int = 0):
    """Plain PyTorch version: vectorized over (B, Wp), one Python step per
    anti-diagonal (int64 arithmetic, same values); the letters' scores and
    the band mask are gathered ``REF_CHUNK`` diagonals at a time."""
    dev = qk.device
    B, Lq = qk.shape
    Lt = tk.shape[1]
    Wp = state.shape[2]
    NT = tab.shape[0]
    e = gap_extend
    oe = gap_open + gap_extend
    NEG = NEG_INF
    emode = mode == "emode"
    H1, H2, E1, F1 = (state[r].long() for r in range(4))
    if emode:
        BV, BK = state[4].long(), state[5].long()
    sc = score.long().clone()
    tabf = tab.long().flatten()
    # letters outside [0, NT) read as NT - 1, as in the kernel
    qk = torch.where((qk < 0) | (qk >= NT), NT - 1, qk.long())
    tk = torch.where((tk < 0) | (tk >= NT), NT - 1, tk.long())
    p = torch.arange(Wp, device=dev)[None, :]
    qlv, tlv, dlv, dhv = (x.long()[:, None] for x in (qlen, tlen, dlo_p, dhi_p))
    ckpts, ptrs = [], []
    lo = None
    if want_bout:
        Wbo = bout_width(dlo, dhi)
        bout = torch.full((2, B, Wbo), NEG, dtype=torch.long, device=dev)
    if bh is not None:
        Wb = bh.shape[1]
        bh, bf = bh.long(), bf.long()
    fins = set((qlv + tlv).flatten().tolist())  # the diagonals of the final cells
    rows_b = torch.arange(B, device=dev)[None, :, None]
    qlv3, tlv3, dlv3, dhv3 = (x[None] for x in (qlv, tlv, dlv, dhv))
    for c0 in range(k0, k1, REF_CHUNK):
        # the letters' scores and the band mask of a chunk of diagonals at once
        ks = torch.arange(c0, min(c0 + REF_CHUNK, k1), device=dev)[:, None, None]
        I = torch.div(ks - dhi + 1, 2, rounding_mode="floor").clamp(min=0) + p
        J = ks - I
        qc = torch.where(I < Lq, qk[rows_b, I.clamp(max=Lq - 1)], NT - 1)
        tc = tk[rows_b, J.clamp(0, Lt - 1)]
        tc = torch.where(J < 0, 0, torch.where(J >= Lt, NT - 1, tc))
        S = tabf[qc * NT + tc]
        if not emode:
            OK = ((J - I >= dlv3) & (J - I <= dhv3) & (I <= qlv3) & (J >= 0)
                  & (J <= tlv3))
        for c in range(ks.shape[0]):
            k = c0 + c
            if CK and (k - k0) % CK == 0:
                ckpts.append(torch.stack([H1, H2, E1, F1]))
            ih = ihat(k, dhi)
            d1 = ih - ihat(k - 1, dhi)
            d2 = ih - ihat(k - 2, dhi)
            # out[p] = x[p + c] with wrap-around: torch.roll by -c
            Hl = torch.roll(H1, -d1, 1)
            Hu = torch.roll(H1, 1 - d1, 1)
            Hd = torch.roll(H2, 1 - d2, 1)
            El = torch.roll(E1, -d1, 1)
            Fu = torch.roll(F1, 1 - d1, 1)
            E_ext, E_opn = El + e, Hl + oe
            F_ext, F_opn = Fu + e, Hu + oe
            En = torch.maximum(E_ext, E_opn)
            Fn = torch.maximum(F_ext, F_opn)
            d = Hd + S[c]
            best = torch.maximum(torch.maximum(d, Fn), En)
            origin = p == 0 if k == 0 else None  # cell (0, 0)
            if mode == "ptr":  # from the unmasked values, as the TPU kernel
                ptr = torch.where(d == best, PTR_DIAG,
                                  torch.where(Fn == best, PTR_UP, PTR_LEFT))
                if origin is not None:
                    ptr = torch.where(origin, PTR_STOP, ptr)
                nib = ptr | ((E_ext >= E_opn).long() << 2) | ((F_ext >= F_opn).long() << 3)
                if (k - k0) % 2 == 0:
                    lo = nib
                else:
                    ptrs.append((lo | (nib << 4)).to(torch.uint8))
            if emode:
                edge = p == Wp - 1
                Hn = best.clamp(min=EMODE_FLOOR)
                if origin is not None:
                    Hn = torch.where(origin, 0, Hn)
                Hn = torch.where(edge, NEG, Hn)
                En = torch.where(edge, NEG, En)
                Fn = torch.where(edge, NEG, Fn)
                upd = Hn > BV
                BV = torch.where(upd, Hn, BV)
                BK = torch.where(upd, k, BK)
                if tie_safe:
                    cand = torch.where((p == 0) & (k > dhi), En,
                                       torch.where(p == Wp - 2, Fn, NEG))
                    sc = torch.maximum(sc, cand - smax * I[c])
            else:
                ok = OK[c] if origin is None else OK[c] & ~origin
                Hn = torch.where(ok, best, NEG)
                if origin is not None:
                    Hn = torch.where(origin, 0, Hn)
                En = torch.where(ok, En, NEG)
                Fn = torch.where(ok, Fn, NEG)
                if bh is not None and k <= dhi:  # local row 0: the block above's last row
                    Hn[:, 0] = bh[:, min(k, Wb - 1)]
                    Fn[:, 0] = bf[:, min(k, Wb - 1)]
                x = k - 2 * bout_row
                if want_bout and 0 <= x < Wbo:
                    pc = bout_row - ih
                    inside = 0 <= pc < Wp
                    bout[0, :, x] = Hn[:, pc] if inside else 0
                    bout[1, :, x] = Fn[:, pc] if inside else 0
                if mode == "fill" and k < K and k in fins:
                    fin = (k == qlv + tlv) & (I[c] == qlv)
                    sc = torch.where(fin, torch.maximum(Hn, sc), sc)
            H2, H1, E1, F1 = H1, Hn, En, Fn
    rows = [H1, H2, E1, F1] + ([BV, BK] if emode else [])
    out = {"state": torch.stack(rows).to(torch.int32), "score": sc.to(torch.int32)}
    if CK:
        out["ckpt"] = (torch.stack(ckpts).to(torch.int32) if ckpts else
                       torch.empty((0, 4, B, Wp), dtype=torch.int32, device=dev))
    if mode == "ptr":
        out["ptr"] = (torch.stack(ptrs) if ptrs else
                      torch.empty((0, B, Wp), dtype=torch.uint8, device=dev))
    if want_bout:
        out["bout"] = bout.to(torch.int32)
    return out


def band_fill(qk, tk, qlen, tlen, dlo_p, dhi_p, state, score, tab, *, k0: int,
              k1: int, K: int, dlo: int, dhi: int, gap_open: int, gap_extend: int,
              mode: str, CK: int = 0, tie_safe: bool = False, smax: int = 0,
              bh=None, bf=None, want_bout: bool = False, bout_row: int = 0):
    """Fill diagonals [k0, k1) of every pair; see the module docstring.
    ``state`` and ``score`` are not modified.  A CPU tensor runs
    ``band_fill_ref``; a CUDA tensor the kernel.  A call with ``bh``
    counts under ``band_fill/relay`` (fill) or ``band_fill/relay_ptr``; one
    with Wp > ``MAX_WP_REGISTERS`` (the kernel's wide variant) under
    ``band_fill/wide``, ``band_fill/wide_ptr`` or ``band_fill/wide_emode``."""
    qk, tk, state, score, tab = (x.contiguous() for x in (qk, tk, state, score, tab))
    vecs = [v.to(torch.int32).contiguous() for v in (qlen, tlen, dlo_p, dhi_p)]
    if bh is not None and bf is not None:
        bh, bf = bh.contiguous(), bf.contiguous()
    _check(qk, tk, vecs, state, score, tab, mode, k0, k1, CK, bh, bf, want_bout,
           bout_row)
    kw = dict(k0=k0, k1=k1, K=K, dlo=dlo, dhi=dhi, gap_open=gap_open,
              gap_extend=gap_extend, mode=mode, CK=CK, tie_safe=tie_safe, smax=smax,
              bh=bh, bf=bf, want_bout=want_bout, bout_row=bout_row)
    if qk.device.type == "cpu":
        return band_fill_ref(qk, tk, *vecs, state, score, tab, **kw)
    if qk.device.type != "cuda":
        raise ValueError(f"band_fill: unsupported device {qk.device}")
    B, Wp = score.shape
    from .._build import launch

    dev = qk.device
    # the kernel updates state and score in place: work on copies
    out = {"state": state.clone(), "score": score.clone()}
    ckpt = ptr = None
    if CK:
        nc = -(-(k1 - k0) // CK)
        ckpt = out["ckpt"] = torch.empty((nc, 4, B, Wp), dtype=torch.int32, device=dev)
    if mode == "ptr":
        ptr = out["ptr"] = torch.empty(((k1 - k0) // 2, B, Wp), dtype=torch.uint8,
                                       device=dev)
    bout = None
    if want_bout:
        bout = out["bout"] = torch.full((2, B, bout_width(dlo, dhi)), NEG_INF,
                                        dtype=torch.int32, device=dev)
    if B == 0 or k1 == k0:
        return out
    wide = Wp > MAX_WP_REGISTERS
    scratch = torch.empty((B, 7, Wp), dtype=torch.int32, device=dev) if wide else None
    launch(
        "band_fill", dev, "seqalib_band_fill", qk.data_ptr(), qk.shape[1], tk.data_ptr(), tk.shape[1],
        *(v.data_ptr() for v in vecs), tab.data_ptr(), tab.shape[0], B, Wp,
        k0, k1, K, dhi, gap_open, gap_extend, MODES[mode], CK, int(tie_safe), smax,
        out["state"].data_ptr(), out["score"].data_ptr(),
        ckpt.data_ptr() if ckpt is not None else None,
        ptr.data_ptr() if ptr is not None else None,
        bh.data_ptr() if bh is not None else None,
        bf.data_ptr() if bh is not None else None,
        bh.shape[1] if bh is not None else 0,
        bout.data_ptr() if bout is not None else None,
        bout.shape[2] if bout is not None else 0, bout_row,
        scratch.data_ptr() if wide else None,
    )
    launches[launch_key(mode, bh is not None, Wp)] += 1
    return out


def launch_key(mode: str, relay: bool, Wp: int) -> str:
    """The ``launches`` key of a CUDA ``band_fill`` call: the wide variant
    (Wp > ``MAX_WP_REGISTERS``) by mode, resumed blocks under ``relay``."""
    if Wp > MAX_WP_REGISTERS:
        return "band_fill/wide" + ("" if mode == "fill" else f"_{mode}")
    if relay:
        return "band_fill/relay" if mode == "fill" else "band_fill/relay_ptr"
    return f"band_fill/{mode}"
