"""Pure-NumPy oracle: the bit-exact correctness contract of the port.

A copy of the JAX package's ``seqalib_tpu/oracle.py`` (same recurrences,
same tie-breaks), kept so that the port imports nothing of that package.
Every backend must reproduce these scores, coordinates and CIGAR strings
exactly:

  * max-cascade tie-break everywhere: DIAG > UP > LEFT (UP consumes query ->
    CIGAR I; LEFT consumes target -> CIGAR D);
  * affine: H-choice DIAG > F(up) > E(left); E/F prefer EXTEND over OPEN
    on ties;
  * local (SW): a cell whose best candidate is <= 0 scores 0; the end
    coordinate is the argmax cell with smallest i, then smallest j, among
    ties;
  * local START coordinate (canonical, two-pass definition): among all
    optimal alignments ending at the canonical end (qe, te), the start is
    the one found by the *anchored reverse extension* problem — align
    reverse(q[:qe]) vs reverse(t[:te]) with the GLOBAL recurrence (gap
    boundaries, no zero clamp, alignment anchored at the reversed origin
    = the original end cell) and take the first score-max cell in scan
    order (smallest i', then smallest j');
  * local CIGAR (canonical): the DIAG > UP > LEFT / extend >= open global
    traceback of the window q[qs:qe] x t[ts:te] (whose optimal global
    score provably equals the local score);
  * banded global: cells with (j - i) outside [min(0, m-n) - w,
    max(0, m-n) + w] are -inf.

These are deliberately straightforward scalar loops.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .types import (
    NEG_INF,
    PTR_DIAG,
    PTR_LEFT,
    PTR_STOP,
    PTR_UP,
    AlignResult,
    ScoringParams,
)
from .utils.cigar import OP_D, OP_I, OP_M, ops_to_cigar


def _subst_lookup(sp: ScoringParams):
    if sp.matrix is None:
        match, mismatch = sp.match, sp.mismatch
        return lambda a, b: match if a == b else mismatch
    mat = sp.matrix
    return lambda a, b: int(mat[a, b])


# ---------------------------------------------------------------------------
# Needleman-Wunsch, linear gap
# ---------------------------------------------------------------------------


def nw_linear(q: np.ndarray, t: np.ndarray, sp: ScoringParams) -> AlignResult:
    """Global alignment, linear gap g = sp.gap_extend, full traceback."""
    assert not sp.is_affine, "nw_linear requires gap_open == 0"
    n, m = len(q), len(t)
    g = sp.gap_extend
    s = _subst_lookup(sp)

    H = np.zeros((n + 1, m + 1), dtype=np.int64)
    P = np.zeros((n + 1, m + 1), dtype=np.uint8)
    for i in range(1, n + 1):
        H[i, 0] = i * g
        P[i, 0] = PTR_UP
    for j in range(1, m + 1):
        H[0, j] = j * g
        P[0, j] = PTR_LEFT
    for i in range(1, n + 1):
        qi = int(q[i - 1])
        for j in range(1, m + 1):
            d = H[i - 1, j - 1] + s(qi, int(t[j - 1]))
            u = H[i - 1, j] + g
            l = H[i, j - 1] + g
            best = max(d, u, l)
            H[i, j] = best
            P[i, j] = PTR_DIAG if d == best else (PTR_UP if u == best else PTR_LEFT)

    ops = _walk_linear(P, n, m)
    return AlignResult(int(H[n, m]), 0, n, 0, m, ops_to_cigar(ops))


def _walk_linear(P: np.ndarray, i: int, j: int) -> List[int]:
    ops: List[int] = []
    while True:
        p = P[i, j]
        if p == PTR_STOP:
            break
        if p == PTR_DIAG:
            ops.append(OP_M)
            i -= 1
            j -= 1
        elif p == PTR_UP:
            ops.append(OP_I)
            i -= 1
        else:
            ops.append(OP_D)
            j -= 1
    ops.reverse()
    return ops


# ---------------------------------------------------------------------------
# Smith-Waterman, linear gap
# ---------------------------------------------------------------------------


def _ext_linear_fill(q: np.ndarray, t: np.ndarray, sp: ScoringParams) -> np.ndarray:
    """Anchored extension fill, linear gap: the NW recurrence (gap
    boundaries, no zero clamp) whose cell (i, j) holds the best score of an
    alignment consuming q[:i] and t[:j] ENTIRELY (anchored at the origin)."""
    n, m = len(q), len(t)
    g = sp.gap_extend
    s = _subst_lookup(sp)
    H = np.full((n + 1, m + 1), NEG_INF, dtype=np.int64)
    H[0, 0] = 0
    for i in range(1, n + 1):
        H[i, 0] = i * g
    for j in range(1, m + 1):
        H[0, j] = j * g
    for i in range(1, n + 1):
        qi = int(q[i - 1])
        for j in range(1, m + 1):
            H[i, j] = max(
                H[i - 1, j - 1] + s(qi, int(t[j - 1])),
                H[i - 1, j] + g,
                H[i, j - 1] + g,
            )
    return H


def _argmax_first(H: np.ndarray) -> Tuple[int, int, int]:
    """(value, i, j) of the first maximum in row-major scan order —
    the canonical smallest-i, then smallest-j tie-break."""
    flat = int(np.argmax(H))
    i, j = divmod(flat, H.shape[1])
    return int(H[i, j]), i, j


def sw_linear(q: np.ndarray, t: np.ndarray, sp: ScoringParams) -> AlignResult:
    """Local alignment, linear gap; score, coords, CIGAR (two-pass canon)."""
    assert not sp.is_affine, "sw_linear requires gap_open == 0"
    n, m = len(q), len(t)
    g = sp.gap_extend
    s = _subst_lookup(sp)

    H = np.zeros((n + 1, m + 1), dtype=np.int64)
    best, bi, bj = 0, 0, 0
    for i in range(1, n + 1):
        qi = int(q[i - 1])
        for j in range(1, m + 1):
            cand = max(
                H[i - 1, j - 1] + s(qi, int(t[j - 1])),
                H[i - 1, j] + g,
                H[i, j - 1] + g,
            )
            if cand <= 0:
                continue  # H stays 0
            H[i, j] = cand
            if cand > best:
                best, bi, bj = cand, i, j
            # ties: keep smallest i, then smallest j -- scan order guarantees it

    if best == 0:
        return AlignResult(0, 0, 0, 0, 0, "")
    # pass 2: canonical start via anchored reverse extension (module docstring)
    Hr = _ext_linear_fill(q[:bi][::-1], t[:bj][::-1], sp)
    rbest, ri, rj = _argmax_first(Hr)
    assert rbest == best, "reverse extension must reproduce the local score"
    si, sj = bi - ri, bj - rj
    # pass 3: canonical CIGAR = global walk of the window
    win = nw_linear(q[si:bi], t[sj:bj], sp)
    assert win.score == best, "window-global score must equal the local score"
    return AlignResult(int(best), si, bi, sj, bj, win.cigar)


# ---------------------------------------------------------------------------
# Gotoh affine gap, global and local
# ---------------------------------------------------------------------------


def _gotoh_fill(
    q: np.ndarray,
    t: np.ndarray,
    sp: ScoringParams,
    local: bool,
    band: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Fill H/E/F with pointer + extend-bit matrices.

    Returns (H, PH, EXT_E, EXT_F):
      PH: H's provenance: STOP | DIAG | UP (chose F) | LEFT (chose E).
      EXT_E[i,j]: E[i,j] came from E[i,j-1]+e (extend) vs H[i,j-1]+o+e (open).
      EXT_F[i,j]: F[i,j] came from F[i-1,j]+e vs H[i-1,j]+o+e.
    E consumes the target (LEFT, CIGAR D); F consumes the query (UP, CIGAR I).
    """
    n, m = len(q), len(t)
    o, e = sp.gap_open, sp.gap_extend
    s = _subst_lookup(sp)

    if band is not None:
        dlo = min(0, m - n) - band
        dhi = max(0, m - n) + band
    else:
        dlo, dhi = -(n + 1), m + 1

    H = np.full((n + 1, m + 1), NEG_INF, dtype=np.int64)
    E = np.full((n + 1, m + 1), NEG_INF, dtype=np.int64)
    F = np.full((n + 1, m + 1), NEG_INF, dtype=np.int64)
    PH = np.zeros((n + 1, m + 1), dtype=np.uint8)
    EXT_E = np.zeros((n + 1, m + 1), dtype=bool)
    EXT_F = np.zeros((n + 1, m + 1), dtype=bool)

    H[0, 0] = 0
    for i in range(n + 1):
        for j in range(m + 1):
            if i == 0 and j == 0:
                continue
            if not (dlo <= j - i <= dhi):
                continue  # out of band: stays NEG_INF
            if j > 0:
                ext = E[i, j - 1] + e
                opn = H[i, j - 1] + o + e
                if ext >= opn:  # tie-break: extend > open
                    E[i, j] = ext
                    EXT_E[i, j] = True
                else:
                    E[i, j] = opn
            if i > 0:
                ext = F[i - 1, j] + e
                opn = H[i - 1, j] + o + e
                if ext >= opn:
                    F[i, j] = ext
                    EXT_F[i, j] = True
                else:
                    F[i, j] = opn
            d = (
                H[i - 1, j - 1] + s(int(q[i - 1]), int(t[j - 1]))
                if (i > 0 and j > 0)
                else NEG_INF
            )
            best = max(d, F[i, j], E[i, j])
            if local and best <= 0:
                H[i, j] = 0
                PH[i, j] = PTR_STOP
            else:
                H[i, j] = best
                PH[i, j] = (
                    PTR_DIAG
                    if d == best
                    else (PTR_UP if F[i, j] == best else PTR_LEFT)
                )
    return H, PH, EXT_E, EXT_F


def _walk_affine(
    PH: np.ndarray, EXT_E: np.ndarray, EXT_F: np.ndarray, i: int, j: int
) -> Tuple[List[int], int, int]:
    """Affine traceback state machine from (i, j) in state H.

    Returns (ops, start_i, start_j).
    """
    ops: List[int] = []
    state = "H"
    while True:
        if state == "H":
            p = PH[i, j]
            if p == PTR_STOP:
                break
            if p == PTR_DIAG:
                ops.append(OP_M)
                i -= 1
                j -= 1
            elif p == PTR_UP:
                state = "F"
            else:
                state = "E"
        elif state == "F":
            ops.append(OP_I)
            was_ext = EXT_F[i, j]
            i -= 1
            if not was_ext:
                state = "H"
        else:  # state == "E"
            ops.append(OP_D)
            was_ext = EXT_E[i, j]
            j -= 1
            if not was_ext:
                state = "H"
    ops.reverse()
    return ops, i, j


def nw_affine(
    q: np.ndarray, t: np.ndarray, sp: ScoringParams, band: int | None = None
) -> AlignResult:
    """Global affine-gap (Gotoh) alignment; optionally banded (config 4)."""
    n, m = len(q), len(t)
    if band is not None and not (min(0, m - n) - band <= m - n <= max(0, m - n) + band):
        raise ValueError("band does not contain the (n, m) endpoint")
    H, PH, EXT_E, EXT_F = _gotoh_fill(q, t, sp, local=False, band=band)
    ops, si, sj = _walk_affine(PH, EXT_E, EXT_F, n, m)
    assert si == 0 and sj == 0, "global traceback must reach (0, 0)"
    return AlignResult(int(H[n, m]), 0, n, 0, m, ops_to_cigar(ops))


def sw_affine(q: np.ndarray, t: np.ndarray, sp: ScoringParams) -> AlignResult:
    """Local affine-gap (Gotoh) alignment: score, coords, CIGAR (config 3,
    two-pass canonical coords — see module docstring)."""
    H, _, _, _ = _gotoh_fill(q, t, sp, local=True)
    # argmax with canonical tie-break: smallest i, then smallest j.
    best, bi, bj = _argmax_first(H)
    if best <= 0:
        return AlignResult(0, 0, 0, 0, 0, "")
    # pass 2: canonical start via anchored reverse extension.  The anchored
    # fill is exactly the global Gotoh fill (gap boundaries, no clamp).
    Hr, _, _, _ = _gotoh_fill(q[:bi][::-1], t[:bj][::-1], sp, local=False)
    rbest, ri, rj = _argmax_first(Hr)
    assert rbest == best, "reverse extension must reproduce the local score"
    si, sj = bi - ri, bj - rj
    # pass 3: canonical CIGAR = global walk of the window
    win = nw_affine(q[si:bi], t[sj:bj], sp)
    assert win.score == best, "window-global score must equal the local score"
    return AlignResult(best, si, bi, sj, bj, win.cigar)


# ---------------------------------------------------------------------------
# Dispatch helper mirroring the public API
# ---------------------------------------------------------------------------


def align_oracle(
    q: np.ndarray,
    t: np.ndarray,
    sp: ScoringParams,
    mode: str = "global",
    band: int | None = None,
) -> AlignResult:
    if mode == "global":
        if band is not None or sp.is_affine:
            return nw_affine(q, t, sp, band=band)
        return nw_linear(q, t, sp)
    if sp.is_affine:
        return sw_affine(q, t, sp)
    return sw_linear(q, t, sp)
