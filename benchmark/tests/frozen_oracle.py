"""A frozen copy of the port's scalar oracle (``oracle.py``): global and
local alignment, affine (Gotoh, banded or not) and linear, with its tie
order, its canonical local coordinates and its traceback, kept here so that
the benchmark's tests hold its reference to the oracle as it stood when the
benchmark was written, without importing the program.

Ties: H prefers DIAG, then UP (F, CIGAR I), then LEFT (E, CIGAR D); E and
F prefer extend to open.  Local: a cell whose best candidate is <= 0 is 0;
the end is the first maximum in row-major order, the start the first
maximum of the anchored reverse extension, the CIGAR the global walk of the
window.  Straightforward scalar loops: tiny pairs only.
"""

from __future__ import annotations

import numpy as np

NEG_INF = -(1 << 30)
PTR_STOP, PTR_DIAG, PTR_UP, PTR_LEFT = 0, 1, 2, 3


def _gotoh_fill(q, t, table, o, e, band=None, local=False):
    n, m = len(q), len(t)
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
                continue
            if j > 0:
                ext = E[i, j - 1] + e
                opn = H[i, j - 1] + o + e
                if ext >= opn:
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
            d = (H[i - 1, j - 1] + int(table[q[i - 1], t[j - 1]])
                 if (i > 0 and j > 0) else NEG_INF)
            best = max(d, F[i, j], E[i, j])
            if local and best <= 0:
                H[i, j] = 0
                PH[i, j] = PTR_STOP
                continue
            H[i, j] = best
            PH[i, j] = (PTR_DIAG if d == best
                        else (PTR_UP if F[i, j] == best else PTR_LEFT))
    return H, PH, EXT_E, EXT_F


def _walk_affine(PH, EXT_E, EXT_F, i, j):
    ops = []
    state = "H"
    while True:
        if state == "H":
            p = PH[i, j]
            if p == PTR_STOP:
                break
            if p == PTR_DIAG:
                ops.append("M")
                i -= 1
                j -= 1
            elif p == PTR_UP:
                state = "F"
            else:
                state = "E"
        elif state == "F":
            ops.append("I")
            was_ext = EXT_F[i, j]
            i -= 1
            if not was_ext:
                state = "H"
        else:
            ops.append("D")
            was_ext = EXT_E[i, j]
            j -= 1
            if not was_ext:
                state = "H"
    ops.reverse()
    return ops, i, j


def _cigar(ops):
    out, prev, run = [], None, 0
    for op in ops:
        if op == prev:
            run += 1
        else:
            if run:
                out.append(f"{run}{prev}")
            prev, run = op, 1
    if run:
        out.append(f"{run}{prev}")
    return "".join(out)


def nw_affine(q, t, table, gap_open, gap_extend, band=None):
    """(score, 0, n, 0, m, cigar) of the global affine alignment."""
    n, m = len(q), len(t)
    H, PH, EXT_E, EXT_F = _gotoh_fill(q, t, table, gap_open, gap_extend, band)
    ops, si, sj = _walk_affine(PH, EXT_E, EXT_F, n, m)
    if si != 0 or sj != 0:
        raise RuntimeError("global traceback must reach (0, 0)")
    return int(H[n, m]), 0, n, 0, m, _cigar(ops)


def nw_linear(q, t, table, gap):
    """(score, 0, n, 0, m, cigar) of the global alignment with linear gaps."""
    n, m = len(q), len(t)
    H = np.zeros((n + 1, m + 1), dtype=np.int64)
    P = np.zeros((n + 1, m + 1), dtype=np.uint8)
    for i in range(1, n + 1):
        H[i, 0] = i * gap
        P[i, 0] = PTR_UP
    for j in range(1, m + 1):
        H[0, j] = j * gap
        P[0, j] = PTR_LEFT
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d = H[i - 1, j - 1] + int(table[q[i - 1], t[j - 1]])
            u = H[i - 1, j] + gap
            left = H[i, j - 1] + gap
            best = max(d, u, left)
            H[i, j] = best
            P[i, j] = PTR_DIAG if d == best else (PTR_UP if u == best else PTR_LEFT)
    ops, i, j = [], n, m
    while P[i, j] != PTR_STOP:
        p = P[i, j]
        ops.append("M" if p == PTR_DIAG else ("I" if p == PTR_UP else "D"))
        i -= p in (PTR_DIAG, PTR_UP)
        j -= p in (PTR_DIAG, PTR_LEFT)
    return int(H[n, m]), 0, n, 0, m, _cigar(ops[::-1])


def _argmax_first(H):
    i, j = divmod(int(np.argmax(H)), H.shape[1])
    return int(H[i, j]), i, j


def sw(q, t, table, gap_open, gap_extend):
    """(score, qs, qe, ts, te, cigar) of the local alignment (the oracle's
    two-pass canonical coordinates)."""
    H, _, _, _ = _gotoh_fill(q, t, table, gap_open, gap_extend, local=True)
    best, bi, bj = _argmax_first(H)
    if best <= 0:
        return 0, 0, 0, 0, 0, ""
    Hr, _, _, _ = _gotoh_fill(q[:bi][::-1], t[:bj][::-1], table, gap_open, gap_extend)
    rbest, ri, rj = _argmax_first(Hr)
    assert rbest == best, "reverse extension must reproduce the local score"
    si, sj = bi - ri, bj - rj
    win = align(q[si:bi], t[sj:bj], table, gap_open, gap_extend)
    assert win[0] == best, "window-global score must equal the local score"
    return best, si, bi, sj, bj, win[5]


def align(q, t, table, gap_open, gap_extend, mode="global", band=None):
    """The oracle's dispatch: linear gaps without a band walk linearly."""
    if mode == "local":
        return sw(q, t, table, gap_open, gap_extend)
    if band is None and gap_open == 0:
        return nw_linear(q, t, table, gap_extend)
    return nw_affine(q, t, table, gap_open, gap_extend, band)
