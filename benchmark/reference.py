"""Plain NumPy reference: affine-gap (Gotoh) alignment, global (banded or
over the full matrix) or local (Smith-Waterman), with the canonical
traceback.

It imports nothing of the program under test.  Semantics (the oracle's,
letter for letter):

* ``H(0, 0) = 0``; ``E(i, j) = max(E(i, j-1) + e, H(i, j-1) + o + e)`` for
  ``j > 0``; ``F(i, j) = max(F(i-1, j) + e, H(i-1, j) + o + e)`` for ``i > 0``;
  ``H = max(H(i-1, j-1) + s(q_i, t_j), F, E)``.  A gap of k letters costs
  ``o + k e``.
* With a band ``w`` only the cells with ``min(0, m-n) - w <= j - i <=
  max(0, m-n) + w`` exist; every other cell is ``NEG``.
* Ties: H prefers the diagonal, then F (UP, CIGAR ``I``: a query letter),
  then E (LEFT, CIGAR ``D``: a target letter); a gap state prefers extend
  to open (``>=``).  With linear gaps (``o == 0``) and no band the walk
  has no gap states: every step chooses DIAG > UP > LEFT anew.
* Local: a cell whose best candidate is ``<= 0`` scores 0 and stops the
  walk.  The end is the first maximum in row-major order; the start is the
  first maximum, in row-major order, of the global fill of the reversed
  prefixes ``q[:end]``, ``t[:end]`` (the anchored reverse extension); the
  CIGAR is the global walk of the window between them.  A best score
  ``<= 0`` is ``(0, 0, 0, 0, 0, "")``.

The fill runs row by row, every pair of a batch at once.  A row is a window
of ``D`` slots: slot ``s`` of row ``i`` is column ``j = step * i + lo + s``
(``step`` 1 and ``lo`` the band's lower diagonal for a band, ``step`` 0 and
``lo`` 0 for the full matrix), so only the band is kept.  E's chain along a
row is a prefix maximum: for ``o <= 0`` an E that opens from an H which
itself came from E never beats extending that E, so
``E(s) = max(seed chain, max_{s' < s} Hp(s') + o + (s - s') e)`` with ``Hp =
max(diagonal, F)`` (and 0, in local mode), which ``np.maximum.accumulate``
computes over the row.

``saturate=(lo, hi)`` clamps every computed value into ``[lo, hi]``, which
emulates a kernel with saturating 16-bit scores (the control that a check
must fail).
"""

from __future__ import annotations

import numpy as np

NEG = -(1 << 30)
_FLOOR = -(1 << 60)  # below every value the fill can make
PTR_STOP, PTR_DIAG, PTR_UP, PTR_LEFT = 0, 1, 2, 3
EXT_E_BIT, EXT_F_BIT = 4, 8


def substitution_table(match: int, mismatch: int, letters: int = 4) -> np.ndarray:
    """(letters, letters) table: ``match`` on the diagonal, ``mismatch`` off it."""
    tab = np.full((letters, letters), mismatch, np.int64)
    np.fill_diagonal(tab, match)
    return tab


def band_cells(n: int, m: int, band: int | None) -> int:
    """Cells (i, j), 0 <= i <= n, 0 <= j <= m, that the fill computes: the
    band's (or the whole matrix's), the origin included."""
    if band is None:
        return (n + 1) * (m + 1)
    lo, hi = min(0, m - n) - band, max(0, m - n) + band
    d = np.arange(lo, hi + 1, dtype=np.int64)  # diagonal j - i
    first = np.maximum(0, -d)  # first row of the diagonal
    last = np.minimum(n, m - d)
    return int(np.maximum(0, last - first + 1).sum())


def _geometry(ns, ms, band):
    if band is None:
        lo = np.zeros(len(ns), np.int64)
        width = ms + 1
        return lo, width, 0
    lo = np.minimum(0, ms - ns) - band
    hi = np.maximum(0, ms - ns) + band
    return lo, hi - lo + 1, 1


def fill(qs, ts, table, gap_open: int, gap_extend: int, band: int | None = None,
         pointers: bool = True, saturate: tuple[int, int] | None = None,
         local: bool = False, track: bool = False):
    """Fill every pair of the batch.  ``qs``, ``ts``: sequences of 1-D letter
    codes (indices into ``table``).  Returns ``(scores, ptr, geom)``: the
    scores (P,) at (n, m), with ``pointers`` the (max n + 1, P, D) bytes
    ``PH | E ext << 2 | F ext << 3`` of every slot (else None), and the
    geometry the walk needs; with ``track`` also ``(best, i, j)``, each
    pair's first maximum of H in row-major order.  ``local`` clamps H at 0
    (a cell whose best candidate is ``<= 0`` is 0, its pointer STOP).
    Values are int32: every one the fill makes lies above ``NEG - 2 ** 29 -
    4 (n + m) max|e|``, far from int32's floor."""
    o, e = int(gap_open), int(gap_extend)
    if o > 0 or e > 0:
        raise ValueError("the prefix-maximum fill needs gap_open <= 0 and gap_extend <= 0")
    dt = np.int32
    table = np.asarray(table, np.int64)
    P = len(qs)
    ns = np.array([len(q) for q in qs], np.int64)
    ms = np.array([len(t) for t in ts], np.int64)
    lo, width, step = _geometry(ns, ms, band)
    D = int(width.max())
    nmax, mmax = int(ns.max()), int(ms.max())
    slots = np.arange(D, dtype=np.int64)
    s_ok = slots[None, :] < width[:, None]
    uniform = bool(s_ok.all())
    pr = np.arange(P)

    # the target's letter scores against every query letter, columns
    # shifted by ``off``: prof[a, p, off + j] = s(a, t_p[j - 1]) for 1 <= j
    # <= m_p, and PAD (no diagonal move) at every other column
    pad = -(1 << 29)
    off = int(max(0, -lo.min())) + 1
    Tw = off + mmax + nmax * step + D + 1
    T = np.full((P, Tw), -1, np.int64)
    for p, t in enumerate(ts):
        T[p, off + 1: off + 1 + len(t)] = t
    prof = np.where(T[None] >= 0, table[:, np.maximum(T, 0)], pad).astype(dt)
    win = np.lib.stride_tricks.sliding_window_view(prof, D, axis=2)
    Q = np.zeros((P, nmax + 1), np.int64)
    for p, q in enumerate(qs):
        Q[p, 1: 1 + len(q)] = q

    sat = saturate is not None
    neg = dt(saturate[0] if sat else NEG)
    floor = dt(-(1 << 31) + (1 << 24))

    def clamp(x):
        return np.clip(x, saturate[0], saturate[1], out=x) if sat else x

    # H and F with one pad slot: the cells at [c0, c0 + D), so that the
    # diagonal neighbours are buf[:, 0:D] and the upper ones buf[:, 1:D+1]
    # (band: (i-1, j-1) is slot s, (i-1, j) slot s + 1; full matrix: slot
    # s - 1 and slot s)
    c0 = 0 if step else 1
    Hb = np.full((P, D + 1), neg, dt)
    Fb = np.full((P, D + 1), neg, dt)
    El = np.full((P, D + 1), neg, dt)  # E and H of the row, shifted one right
    Hl = np.full((P, D + 1), neg, dt)
    se = (slots * e).astype(dt)
    ptr = np.zeros((nmax + 1, P, D), np.uint8) if pointers else None
    scores = np.zeros(P, np.int64)
    best = np.full(P, -(1 << 62), np.int64)
    best_i = np.zeros(P, np.int64)
    best_j = np.zeros(P, np.int64)
    for i in range(nmax + 1):
        lo_i = lo + i * step
        interior = uniform and lo_i.min() >= 1 and (lo_i + width - 1).max() <= ms.min() \
            and i <= ns.min()
        if not interior:
            j = lo_i[:, None] + slots[None, :]
            valid = s_ok & (j >= 0) & (j <= ms[:, None]) & (i <= ns[:, None])
        if i == 0:
            d = np.full((P, D), neg, dt)
            Fn = np.full((P, D), neg, dt)
            fext = np.zeros((P, D), bool)
        else:
            sub = win[Q[:, i], pr, lo_i + off]
            d = clamp(Hb[:, 0:D] + sub)
            fo = clamp(Hb[:, 1:D + 1] + dt(o + e))
            Fn = clamp(Fb[:, 1:D + 1] + dt(e))
            if pointers:
                fext = Fn >= fo
            np.maximum(Fn, fo, out=Fn)
        Hp = np.maximum(d, Fn)
        if i == 0:
            Hp = np.where(j == 0, dt(0), Hp)
        raw = Hp
        if local:
            Hp = np.maximum(Hp, dt(0))
        # E(s) = s e + max_{s0 <= s' < s} (Hp(s') + o - s' e); the slot s0
        # (column 0, or the band's left edge, whose left neighbour is NEG)
        # takes E = NEG there, NEG + e at an edge: that chain never beats an
        # in-band Hp, which every row has
        A = Hp + dt(o)
        A -= se
        if not interior:
            A = np.where(valid, A, floor)
        B = np.maximum.accumulate(A, axis=1)
        En = np.empty((P, D), dt)
        En[:, 1:] = B[:, :-1]
        En[:, 1:] += se[1:]
        clamp(En)
        s0 = np.minimum(np.maximum(0, -lo_i), D - 1)
        j0 = lo_i + s0
        En[pr, s0] = np.where(j0 >= 1, clamp(np.array(neg + e, dt)), neg)
        if not interior:
            En = np.where(valid & (j >= 1), En, neg)
        Hn = np.maximum(Hp, En)
        if i == 0:
            Hn = np.where(j == 0, dt(0), Hn)
        if pointers:
            Hl[:, 1:], El[:, 1:] = Hn, En
            Hl[pr, s0] = neg  # slot s0's left neighbour lies outside the band
            El[pr, s0] = neg
            eext = clamp(El[:, :D] + dt(e)) >= clamp(Hl[:, :D] + dt(o + e))
            isf = Fn == Hn
            ph = np.where(d == Hn, np.uint8(PTR_DIAG), np.uint8(PTR_LEFT) - isf.view(np.uint8))
            if i == 0:
                ph = np.where(j == 0, np.uint8(PTR_STOP), ph)
            if local:
                ph = np.where(np.maximum(raw, En) <= 0, np.uint8(PTR_STOP), ph)
            ph |= eext.view(np.uint8) << 2
            ph |= fext.view(np.uint8) << 3
            ptr[i] = ph
        if interior:
            Hb[:, c0:c0 + D] = Hn
            Fb[:, c0:c0 + D] = Fn
        else:
            Hb[:, c0:c0 + D] = np.where(valid, Hn, neg)
            Fb[:, c0:c0 + D] = np.where(valid, Fn, neg)
        if track:
            Hm = Hn if interior else np.where(valid, Hn, floor)
            row = Hm.max(axis=1)
            up = row > best
            best = np.where(up, row, best)
            best_i = np.where(up, i, best_i)
            best_j = np.where(up, lo_i + Hm.argmax(axis=1), best_j)
        last = ns == i
        if last.any():
            s_end = np.clip(ms - lo_i, 0, D - 1)
            scores[last] = Hb[pr, c0 + s_end][last]
    if track:
        return scores, ptr, (ns, ms, lo, step), (best, best_i, best_j)
    return scores, ptr, (ns, ms, lo, step)


def walk(ptr: np.ndarray, geom, p: int, linear: bool = False) -> str:
    """The CIGAR of pair ``p``: the oracle's H/E/F state machine from (n, m),
    or with ``linear`` its one-state walk (a gap step goes back to H)."""
    ns, ms, lo, step = geom
    i, j = int(ns[p]), int(ms[p])
    lo_p = int(lo[p])
    plane = ptr[:, p, :]
    ops = []  # (op, run) from the end
    state = 0  # 0 H, 1 F (UP, I), 2 E (LEFT, D)
    run_op, run = -1, 0
    while True:
        if i < 0 or j < 0:
            raise RuntimeError(f"walk of pair {p} left the matrix")
        b = int(plane[i, j - step * i - lo_p])
        if linear:
            b &= 3
        if state == 0:
            ph = b & 3
            if ph == PTR_STOP:
                break
            if ph == PTR_DIAG:
                op = 0
                i -= 1
                j -= 1
            elif ph == PTR_UP:
                state = 1
                continue
            else:
                state = 2
                continue
        elif state == 1:
            op = 1
            if not b & EXT_F_BIT:
                state = 0
            i -= 1
        else:
            op = 2
            if not b & EXT_E_BIT:
                state = 0
            j -= 1
        if op == run_op:
            run += 1
        else:
            if run:
                ops.append((run_op, run))
            run_op, run = op, 1
    if i != 0 or j != 0:
        raise RuntimeError(f"walk of pair {p} ended at ({i}, {j}), not (0, 0)")
    if run:
        ops.append((run_op, run))
    return "".join(f"{r}{'MID'[op]}" for op, r in reversed(ops))


def align(qs, ts, table, gap_open: int, gap_extend: int, band: int | None = None,
          traceback: bool = True, saturate: tuple[int, int] | None = None,
          mode: str = "global"):
    """``[(score, query_start, query_end, target_start, target_end, cigar)]``
    for every pair; ``cigar`` is None without traceback."""
    if mode == "local":
        return _local(qs, ts, table, gap_open, gap_extend, band, traceback, saturate)
    scores, ptr, geom = fill(qs, ts, table, gap_open, gap_extend, band=band,
                             pointers=traceback, saturate=saturate)
    linear = gap_open == 0 and band is None
    out = []
    for p in range(len(qs)):
        cigar = walk(ptr, geom, p, linear) if traceback else None
        out.append((int(scores[p]), 0, len(qs[p]), 0, len(ts[p]), cigar))
    return out


def _local(qs, ts, table, o, e, band, traceback, saturate):
    """Local alignment of every pair: the end, the start by the anchored
    reverse extension, the CIGAR of the window (module docstring)."""
    if band is not None:
        raise ValueError("local alignment has no band")
    _, _, _, (best, ei, ej) = fill(qs, ts, table, o, e, pointers=False, saturate=saturate,
                                   local=True, track=True)
    out = [(0, 0, 0, 0, 0, "" if traceback else None)] * len(qs)
    hit = [p for p in range(len(qs)) if best[p] > 0]
    if not hit:
        return out
    rq = [qs[p][: ei[p]][::-1] for p in hit]
    rt = [ts[p][: ej[p]][::-1] for p in hit]
    _, _, _, (_, ri, rj) = fill(rq, rt, table, o, e, pointers=False, saturate=saturate,
                                track=True)
    si, sj = ei[hit] - ri, ej[hit] - rj
    cigars = [None] * len(hit)
    if traceback:
        win = align([qs[p][a:b] for p, a, b in zip(hit, si, ei[hit])],
                    [ts[p][a:b] for p, a, b in zip(hit, sj, ej[hit])],
                    table, o, e, saturate=saturate)
        cigars = [w[5] for w in win]
    for k, p in enumerate(hit):
        out[p] = (int(best[p]), int(si[k]), int(ei[p]), int(sj[k]), int(ej[p]), cigars[k])
    return out


def for_cell(sc, request: dict, qs, ts, saturate=None, gap_open=None):
    """The answers a cell's calls owe for the pairs ``(qs, ts)``: its
    configuration's ``cells.Scoring`` ``sc``, with a CIGAR where the request
    asks for the alignment.  ``saturate`` and ``gap_open`` break a guarantee
    (the controls)."""
    o = sc.gap_open if gap_open is None else gap_open
    return align(qs, ts, sc.table, o, sc.gap_extend, band=sc.band,
                 traceback=request["answers"] == "alignment", saturate=saturate, mode=sc.mode)
