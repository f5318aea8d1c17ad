"""Anti-diagonal-vectorized NumPy oracle: bit-identical to ``oracle``, ~100x
faster on kb-scale pairs.

A copy of the JAX package's ``seqalib_tpu/oracle_fast.py``.  It re-implements
the fills of ``oracle`` with NumPy fancy-indexing over anti-diagonals; every
tie-break is the same where-cascade order as the scalar loops (DIAG > UP >
LEFT; extend >= open; local clamp at 0).

Public surface mirrors ``oracle``: nw_linear, sw_linear, nw_affine,
sw_affine, align_oracle.
"""

from __future__ import annotations

import numpy as np

from . import oracle as _o
from .types import (
    NEG_INF,
    PTR_DIAG,
    PTR_LEFT,
    PTR_STOP,
    PTR_UP,
    AlignResult,
    ScoringParams,
)
from .utils.cigar import ops_to_cigar


def _subst_table(sp: ScoringParams, q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Dense int64 substitution table covering every letter code in q/t."""
    if sp.matrix is not None:
        return np.asarray(sp.matrix, dtype=np.int64)
    hi = 1 + max(int(q.max(initial=0)), int(t.max(initial=0)))
    S = np.full((hi, hi), sp.mismatch, dtype=np.int64)
    np.fill_diagonal(S, sp.match)
    return S


def _diag_ranges(n: int, m: int, lo_i: int):
    """Yield (k, ii, jj) for anti-diagonals k with i >= lo_i, j >= lo_i."""
    for k in range(2 * lo_i, n + m + 1):
        i0 = max(lo_i, k - m)
        i1 = min(n, k - lo_i)
        if i0 > i1:
            continue
        ii = np.arange(i0, i1 + 1)
        yield k, ii, k - ii


def _nw_linear_fill(q, t, sp):
    n, m = len(q), len(t)
    g = np.int64(sp.gap_extend)
    S = _subst_table(sp, q, t)
    q = np.asarray(q, np.int64)
    t = np.asarray(t, np.int64)
    H = np.zeros((n + 1, m + 1), dtype=np.int64)
    P = np.zeros((n + 1, m + 1), dtype=np.uint8)
    H[1:, 0] = np.arange(1, n + 1, dtype=np.int64) * g
    P[1:, 0] = PTR_UP
    H[0, 1:] = np.arange(1, m + 1, dtype=np.int64) * g
    P[0, 1:] = PTR_LEFT
    for k, ii, jj in _diag_ranges(n, m, 1):
        d = H[ii - 1, jj - 1] + S[q[ii - 1], t[jj - 1]]
        u = H[ii - 1, jj] + g
        l = H[ii, jj - 1] + g
        best = np.maximum(d, np.maximum(u, l))
        H[ii, jj] = best
        P[ii, jj] = np.where(
            d == best, PTR_DIAG, np.where(u == best, PTR_UP, PTR_LEFT)
        ).astype(np.uint8)
    return H, P


def nw_linear(q: np.ndarray, t: np.ndarray, sp: ScoringParams) -> AlignResult:
    assert not sp.is_affine, "nw_linear requires gap_open == 0"
    n, m = len(q), len(t)
    H, P = _nw_linear_fill(q, t, sp)
    ops = _o._walk_linear(P, n, m)
    return AlignResult(int(H[n, m]), 0, n, 0, m, ops_to_cigar(ops))


def _ext_linear_fill(q, t, sp):
    n, m = len(q), len(t)
    g = np.int64(sp.gap_extend)
    S = _subst_table(sp, q, t)
    q = np.asarray(q, np.int64)
    t = np.asarray(t, np.int64)
    H = np.full((n + 1, m + 1), NEG_INF, dtype=np.int64)
    H[0, 0] = 0
    H[1:, 0] = np.arange(1, n + 1, dtype=np.int64) * g
    H[0, 1:] = np.arange(1, m + 1, dtype=np.int64) * g
    for k, ii, jj in _diag_ranges(n, m, 1):
        H[ii, jj] = np.maximum(
            H[ii - 1, jj - 1] + S[q[ii - 1], t[jj - 1]],
            np.maximum(H[ii - 1, jj] + g, H[ii, jj - 1] + g),
        )
    return H


def sw_linear(q: np.ndarray, t: np.ndarray, sp: ScoringParams) -> AlignResult:
    assert not sp.is_affine, "sw_linear requires gap_open == 0"
    g = np.int64(sp.gap_extend)
    S = _subst_table(sp, q, t)
    n, m = len(q), len(t)
    qa = np.asarray(q, np.int64)
    ta = np.asarray(t, np.int64)
    H = np.zeros((n + 1, m + 1), dtype=np.int64)
    for k, ii, jj in _diag_ranges(n, m, 1):
        cand = np.maximum(
            H[ii - 1, jj - 1] + S[qa[ii - 1], ta[jj - 1]],
            np.maximum(H[ii - 1, jj] + g, H[ii, jj - 1] + g),
        )
        H[ii, jj] = np.maximum(cand, 0)
    best, bi, bj = _o._argmax_first(H)
    if best == 0:
        return AlignResult(0, 0, 0, 0, 0, "")
    Hr = _ext_linear_fill(q[:bi][::-1], t[:bj][::-1], sp)
    rbest, ri, rj = _o._argmax_first(Hr)
    assert rbest == best, "reverse extension must reproduce the local score"
    si, sj = bi - ri, bj - rj
    win = nw_linear(q[si:bi], t[sj:bj], sp)
    assert win.score == best, "window-global score must equal the local score"
    return AlignResult(int(best), si, bi, sj, bj, win.cigar)


def _gotoh_fill(q, t, sp, local, band=None):
    """Vectorized twin of oracle._gotoh_fill — identical outputs."""
    n, m = len(q), len(t)
    o, e = np.int64(sp.gap_open), np.int64(sp.gap_extend)
    S = _subst_table(sp, q, t)
    qa = np.asarray(q, np.int64)
    ta = np.asarray(t, np.int64)

    if band is not None:
        dlo = min(0, m - n) - band
        dhi = max(0, m - n) + band
    else:
        dlo, dhi = -(n + 1), m + 1

    # sentinel tail keeps the diag gather in bounds for empty/edge rows
    # (its value never reaches a cell: has_d is False there)
    qa = np.concatenate([qa, np.zeros(1, np.int64)])
    ta = np.concatenate([ta, np.zeros(1, np.int64)])

    NEG = np.int64(NEG_INF)
    H = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    E = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    F = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    PH = np.zeros((n + 1, m + 1), dtype=np.uint8)
    EXT_E = np.zeros((n + 1, m + 1), dtype=bool)
    EXT_F = np.zeros((n + 1, m + 1), dtype=bool)
    H[0, 0] = 0

    for k, ii, jj in _diag_ranges(n, m, 0):
        if k == 0:
            continue  # only (0, 0), preset
        ib = (jj - ii >= dlo) & (jj - ii <= dhi)
        if not ib.any():
            continue
        # E: j > 0 (left neighbors live on diagonal k-1)
        has_j = jj > 0
        jm = np.maximum(jj - 1, 0)
        ext = E[ii, jm] + e
        opn = H[ii, jm] + o + e
        ee_win = ext >= opn
        Ev = np.where(has_j, np.where(ee_win, ext, opn), NEG)
        # F: i > 0
        has_i = ii > 0
        im = np.maximum(ii - 1, 0)
        extf = F[im, jj] + e
        opnf = H[im, jj] + o + e
        ef_win = extf >= opnf
        Fv = np.where(has_i, np.where(ef_win, extf, opnf), NEG)
        # diag
        has_d = has_i & has_j
        d = np.where(
            has_d,
            H[im, jm] + S[qa[np.maximum(ii - 1, 0)], ta[np.maximum(jj - 1, 0)]],
            NEG,
        )
        best = np.maximum(d, np.maximum(Fv, Ev))
        ph = np.where(
            d == best, PTR_DIAG, np.where(Fv == best, PTR_UP, PTR_LEFT)
        ).astype(np.uint8)
        Hv = best
        if local:
            clamp = best <= 0
            Hv = np.where(clamp, 0, best)
            ph = np.where(clamp, PTR_STOP, ph).astype(np.uint8)
        # out-of-band cells keep their NEG/0 defaults (scalar `continue`)
        sel_e = ib & has_j
        sel_f = ib & has_i
        E[ii[sel_e], jj[sel_e]] = Ev[sel_e]
        EXT_E[ii[sel_e], jj[sel_e]] = ee_win[sel_e]
        F[ii[sel_f], jj[sel_f]] = Fv[sel_f]
        EXT_F[ii[sel_f], jj[sel_f]] = ef_win[sel_f]
        H[ii[ib], jj[ib]] = Hv[ib]
        PH[ii[ib], jj[ib]] = ph[ib]
    return H, PH, EXT_E, EXT_F


def nw_affine(
    q: np.ndarray, t: np.ndarray, sp: ScoringParams, band: int | None = None
) -> AlignResult:
    n, m = len(q), len(t)
    if band is not None and not (
        min(0, m - n) - band <= m - n <= max(0, m - n) + band
    ):
        raise ValueError("band does not contain the (n, m) endpoint")
    H, PH, EXT_E, EXT_F = _gotoh_fill(q, t, sp, local=False, band=band)
    ops, si, sj = _o._walk_affine(PH, EXT_E, EXT_F, n, m)
    assert si == 0 and sj == 0, "global traceback must reach (0, 0)"
    return AlignResult(int(H[n, m]), 0, n, 0, m, ops_to_cigar(ops))


def sw_affine(q: np.ndarray, t: np.ndarray, sp: ScoringParams) -> AlignResult:
    H, _, _, _ = _gotoh_fill(q, t, sp, local=True)
    best, bi, bj = _o._argmax_first(H)
    if best <= 0:
        return AlignResult(0, 0, 0, 0, 0, "")
    Hr, _, _, _ = _gotoh_fill(q[:bi][::-1], t[:bj][::-1], sp, local=False)
    rbest, ri, rj = _o._argmax_first(Hr)
    assert rbest == best, "reverse extension must reproduce the local score"
    si, sj = bi - ri, bj - rj
    win = nw_affine(q[si:bi], t[sj:bj], sp)
    assert win.score == best, "window-global score must equal the local score"
    return AlignResult(best, si, bi, sj, bj, win.cigar)


def align_oracle(
    q: np.ndarray,
    t: np.ndarray,
    sp: ScoringParams,
    mode: str = "global",
    band: int | None = None,
) -> AlignResult:
    """Dispatch mirroring oracle.align_oracle, on the vectorized fills."""
    q = np.asarray(q)
    t = np.asarray(t)
    if mode == "local":
        return sw_affine(q, t, sp) if sp.is_affine else sw_linear(q, t, sp)
    if band is not None or sp.is_affine:
        return nw_affine(q, t, sp, band=band)
    return nw_linear(q, t, sp)
