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
* ``"emode"``: no mask (the slot window is the band); slot ``Wp - 1`` is
  forced to NEG_INF; BV/BK keep each slot's first maximum and its
  diagonal (strict ``>``); with ``tie_safe``, EV[p] keeps
  ``max(cand - smax * i)`` where cand is E at slot 0 once ``k > dhi`` and
  F at slot ``Wp - 2``.

Returns a dict with ``state`` and ``score`` after ``k1 - 1``, plus
``ckpt`` or ``ptr``.  Kernel: ``csrc/band_fill.cu``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import NEG_INF, PTR_DIAG, PTR_LEFT, PTR_STOP, PTR_UP
from . import launches

MODES = {"fill": 0, "ptr": 1, "emode": 2}
# the kernel keeps the (NT, NT) score table in shared memory: the 63
# letters strip_fill takes, plus the zero sentinel row and two sentinels
MAX_TABLE = 66


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


def _check(qk, tk, vecs, state, score, tab, mode, k0, k1, CK):
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


def band_fill_ref(qk, tk, qlen, tlen, dlo_p, dhi_p, state, score, tab, *,
                  k0: int, k1: int, K: int, dlo: int, dhi: int, gap_open: int,
                  gap_extend: int, mode: str, CK: int = 0, tie_safe: bool = False,
                  smax: int = 0):
    """Plain PyTorch version: vectorized over (B, Wp), one Python step per
    anti-diagonal (int64 arithmetic, same values)."""
    del dlo  # the slot geometry needs only dhi
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
    for k in range(k0, k1):
        if CK and (k - k0) % CK == 0:
            ckpts.append(torch.stack([H1, H2, E1, F1]))
        ih = ihat(k, dhi)
        d1 = ih - ihat(k - 1, dhi)
        d2 = ih - ihat(k - 2, dhi)
        i = ih + p
        j = k - i
        qc = torch.where(i < Lq, qk.gather(1, i.clamp(max=Lq - 1).expand(B, -1)), NT - 1)
        tc = tk.gather(1, j.clamp(0, Lt - 1).expand(B, -1))
        tc = torch.where(j < 0, 0, torch.where(j >= Lt, NT - 1, tc))
        s = tabf[qc * NT + tc]
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
        d = Hd + s
        best = torch.maximum(torch.maximum(d, Fn), En)
        origin = (k == 0) & (i == 0)
        if mode == "ptr":  # from the unmasked values, as the TPU kernel
            ptr = torch.where(d == best, PTR_DIAG,
                              torch.where(Fn == best, PTR_UP, PTR_LEFT))
            nib = (torch.where(origin, PTR_STOP, ptr)
                   | ((E_ext >= E_opn).long() << 2) | ((F_ext >= F_opn).long() << 3))
            if (k - k0) % 2 == 0:
                lo = nib
            else:
                ptrs.append((lo | (nib << 4)).to(torch.uint8))
        if emode:
            edge = p == Wp - 1
            Hn = torch.where(edge, NEG, torch.where(origin, 0, best))
            En = torch.where(edge, NEG, En)
            Fn = torch.where(edge, NEG, Fn)
            upd = Hn > BV
            BV = torch.where(upd, Hn, BV)
            BK = torch.where(upd, k, BK)
            if tie_safe:
                cand = torch.where((p == 0) & (k > dhi), En,
                                   torch.where(p == Wp - 2, Fn, NEG))
                sc = torch.maximum(sc, cand - smax * i)
        else:
            dkj = j - i
            ok = ((dkj >= dlv) & (dkj <= dhv) & (i <= qlv) & (j >= 0) & (j <= tlv)
                  & ~origin)
            Hn = torch.where(origin, 0, torch.where(ok, best, NEG))
            En = torch.where(ok, En, NEG)
            Fn = torch.where(ok, Fn, NEG)
            if mode == "fill" and k < K:
                fin = (k == qlv + tlv) & (i == qlv)
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
    return out


def band_fill(qk, tk, qlen, tlen, dlo_p, dhi_p, state, score, tab, *, k0: int,
              k1: int, K: int, dlo: int, dhi: int, gap_open: int, gap_extend: int,
              mode: str, CK: int = 0, tie_safe: bool = False, smax: int = 0):
    """Fill diagonals [k0, k1) of every pair; see the module docstring.
    ``state`` and ``score`` are not modified.  A CPU tensor runs
    ``band_fill_ref``; a CUDA tensor the kernel."""
    qk, tk, state, score, tab = (x.contiguous() for x in (qk, tk, state, score, tab))
    vecs = [v.to(torch.int32).contiguous() for v in (qlen, tlen, dlo_p, dhi_p)]
    _check(qk, tk, vecs, state, score, tab, mode, k0, k1, CK)
    kw = dict(k0=k0, k1=k1, K=K, dlo=dlo, dhi=dhi, gap_open=gap_open,
              gap_extend=gap_extend, mode=mode, CK=CK, tie_safe=tie_safe, smax=smax)
    if qk.device.type == "cpu":
        return band_fill_ref(qk, tk, *vecs, state, score, tab, **kw)
    if qk.device.type != "cuda":
        raise ValueError(f"band_fill: unsupported device {qk.device}")
    from .._build import check, lib

    dev = qk.device
    B, Wp = score.shape
    # the kernel updates state and score in place: work on copies
    out = {"state": state.clone(), "score": score.clone()}
    ckpt = ptr = None
    if CK:
        nc = -(-(k1 - k0) // CK)
        ckpt = out["ckpt"] = torch.empty((nc, 4, B, Wp), dtype=torch.int32, device=dev)
    if mode == "ptr":
        ptr = out["ptr"] = torch.empty(((k1 - k0) // 2, B, Wp), dtype=torch.uint8,
                                       device=dev)
    if B == 0 or k1 == k0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib().seqalib_band_fill(
        qk.data_ptr(), qk.shape[1], tk.data_ptr(), tk.shape[1],
        *(v.data_ptr() for v in vecs), tab.data_ptr(), tab.shape[0], B, Wp,
        k0, k1, K, dhi, gap_open, gap_extend, MODES[mode], CK, int(tie_safe), smax,
        out["state"].data_ptr(), out["score"].data_ptr(),
        ckpt.data_ptr() if ckpt is not None else None,
        ptr.data_ptr() if ptr is not None else None, stream,
    )
    check("band_fill", rc)
    launches[f"band_fill/{mode}"] += 1
    return out
