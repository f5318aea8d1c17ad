"""Generic-container aligner API mirroring the reference's template surface.

The reference (SeqALib, SURVEY.md §1.1/§2.1) is a header-only C++ template
library: ``ScoringSystem{gapPenalty, matchProfit, allowMismatch}``, an
``AlignedSequence<Ty, Blank>`` result (list of aligned entry pairs with
match flags and a Blank sentinel for gaps), and one aligner strategy class
per algorithm (``NeedlemanWunschSA``, ``HirschbergSA``,
``DiagonalWindowsSA``, ``SmithWatermanSA``/Gotoh variants), each taking a
user *match function* over element pairs.

This module is the Python equivalent for arbitrary element types (the
original use case aligned LLVM instruction streams, not DNA): any sequence
of hashable/comparable objects and any ``match_fn(a, b) -> bool``.  It runs
on the CPU — per-cell Python callbacks are not accelerator-expressible
(SURVEY.md §7 "Deliberate omissions"); the integer-alphabet fast path is
``seqalib_tpu_torch.align`` / ``align_batch``.  A copy of
``seqalib_tpu/models/generic.py``, which is pure Python: the port imports
nothing of the JAX package (``tests/test_torch_copies.py`` holds the copy
to the original).

Tie-break semantics are identical to the engine contract (SURVEY.md §2.2):
DIAG > UP (consume s1) > LEFT (consume s2).  ``FOGSAA`` (branch-and-bound
global alignment) lives here too: its best-first search is control-flow
divergent and therefore CPU-only; the accelerated engine covers the same
capability (optimal global alignment) with exact NW (SURVEY.md §2.1).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, List, Optional, Sequence, Tuple

MatchFn = Callable[[Any, Any], bool]


@dataclasses.dataclass(frozen=True)
class ScoringSystem:
    """Reference-equivalent scoring config (SURVEY.md §2.1).

    gap_penalty: score added per gap element (<= 0).
    match_profit: score added per matching pair (>= 0).
    allow_mismatch: if False, mismatched pairs may never align against each
        other (they must be separated by gaps); if True they align with
        ``mismatch_penalty``.
    """

    gap_penalty: int = -1
    match_profit: int = 2
    allow_mismatch: bool = True
    mismatch_penalty: int = -1


@dataclasses.dataclass(frozen=True)
class AlignedEntry:
    """One column of an alignment: (a, b, is_match); gap side holds Blank."""

    a: Any
    b: Any
    is_match: bool


class AlignedSequence:
    """Reference-equivalent alignment container (list of AlignedEntry)."""

    def __init__(self, entries: List[AlignedEntry], score: int, blank: Any = None):
        self.entries = entries
        self.score = score
        self.blank = blank

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def matches(self) -> int:
        return sum(1 for e in self.entries if e.is_match)

    def cigar(self) -> str:
        """CIGAR view (M both, I = s1 consumed, D = s2 consumed)."""
        out: List[str] = []
        run_op, run_len = "", 0
        for ent in self.entries:
            op = "M" if (ent.a is not self.blank and ent.b is not self.blank) else (
                "I" if ent.b is self.blank else "D"
            )
            if op == run_op:
                run_len += 1
            else:
                if run_len:
                    out.append(f"{run_len}{run_op}")
                run_op, run_len = op, 1
        if run_len:
            out.append(f"{run_len}{run_op}")
        return "".join(out)

    def __repr__(self):
        return f"AlignedSequence(score={self.score}, len={len(self.entries)})"


class SequenceAligner:
    """Base aligner: subclass per strategy (reference ``SequenceAligner``)."""

    def __init__(
        self,
        scoring: Optional[ScoringSystem] = None,
        match_fn: Optional[MatchFn] = None,
        blank: Any = None,
    ):
        self.scoring = scoring if scoring is not None else ScoringSystem()
        self.match_fn = match_fn if match_fn is not None else (lambda a, b: a == b)
        self.blank = blank

    # -- scoring helpers ---------------------------------------------------
    def _pair_score(self, a, b) -> Optional[int]:
        """Score of aligning a against b, or None if disallowed."""
        if self.match_fn(a, b):
            return self.scoring.match_profit
        if self.scoring.allow_mismatch:
            return self.scoring.mismatch_penalty
        return None

    def get_alignment(self, s1: Sequence, s2: Sequence) -> AlignedSequence:
        raise NotImplementedError

    # -- shared DP core ----------------------------------------------------
    def _nw_matrix(self, s1, s2, band: Optional[int] = None):
        """Full NW score+pointer fill; returns (H, P). O(n*m)."""
        NEG = -(1 << 50)
        g = self.scoring.gap_penalty
        n, m = len(s1), len(s2)
        if band is not None:
            dlo = min(0, m - n) - band
            dhi = max(0, m - n) + band
        else:
            dlo, dhi = -(n + 1), m + 1
        H = [[NEG] * (m + 1) for _ in range(n + 1)]
        P = [[0] * (m + 1) for _ in range(n + 1)]
        H[0][0] = 0
        for j in range(1, m + 1):
            if dlo <= j <= dhi:
                H[0][j] = j * g
                P[0][j] = 3  # LEFT
        for i in range(1, n + 1):
            if dlo <= -i <= dhi:
                H[i][0] = i * g
                P[i][0] = 2  # UP
            a = s1[i - 1]
            for j in range(1, m + 1):
                if not (dlo <= j - i <= dhi):
                    continue
                ps = self._pair_score(a, s2[j - 1])
                d = H[i - 1][j - 1] + ps if ps is not None else NEG
                u = H[i - 1][j] + g
                l = H[i][j - 1] + g
                best = max(d, u, l)
                H[i][j] = best
                P[i][j] = 1 if d == best else (2 if u == best else 3)
        return H, P

    def _walk(self, s1, s2, P) -> List[AlignedEntry]:
        i, j = len(s1), len(s2)
        ents: List[AlignedEntry] = []
        while i > 0 or j > 0:
            p = P[i][j]
            if p == 1:
                a, b = s1[i - 1], s2[j - 1]
                ents.append(AlignedEntry(a, b, self.match_fn(a, b)))
                i, j = i - 1, j - 1
            elif p == 2:
                ents.append(AlignedEntry(s1[i - 1], self.blank, False))
                i -= 1
            elif p == 3:
                ents.append(AlignedEntry(self.blank, s2[j - 1], False))
                j -= 1
            else:  # unreachable cell (band edge): fall back to gaps
                if i > 0:
                    ents.append(AlignedEntry(s1[i - 1], self.blank, False))
                    i -= 1
                else:
                    ents.append(AlignedEntry(self.blank, s2[j - 1], False))
                    j -= 1
        ents.reverse()
        return ents


class NeedlemanWunschSA(SequenceAligner):
    """Global alignment, full O(n*m) matrix (reference NeedlemanWunschSA.h)."""

    def get_alignment(self, s1, s2) -> AlignedSequence:
        H, P = self._nw_matrix(s1, s2)
        return AlignedSequence(self._walk(s1, s2, P), H[len(s1)][len(s2)], self.blank)


class DiagonalWindowsSA(SequenceAligner):
    """Banded global alignment within a diagonal window (reference
    DiagonalWindowsSA.h).  ``window`` is the band half-width."""

    def __init__(self, *args, window: int = 16, **kw):
        super().__init__(*args, **kw)
        self.window = window

    def get_alignment(self, s1, s2) -> AlignedSequence:
        H, P = self._nw_matrix(s1, s2, band=self.window)
        return AlignedSequence(self._walk(s1, s2, P), H[len(s1)][len(s2)], self.blank)


class HirschbergSA(SequenceAligner):
    """Linear-space global alignment by divide and conquer (reference
    HirschbergSA.h): two O(n*m/2) score-row scans find the optimal split of
    s2 for the midpoint of s1; recurse on the quadrants."""

    def _score_row(self, s1, s2) -> List[int]:
        NEG = -(1 << 50)
        g = self.scoring.gap_penalty
        prev = [j * g for j in range(len(s2) + 1)]
        for i in range(1, len(s1) + 1):
            cur = [i * g] + [0] * len(s2)
            a = s1[i - 1]
            for j in range(1, len(s2) + 1):
                ps = self._pair_score(a, s2[j - 1])
                d = prev[j - 1] + ps if ps is not None else NEG
                cur[j] = max(d, prev[j] + g, cur[j - 1] + g)
            prev = cur
        return prev

    def get_alignment(self, s1, s2) -> AlignedSequence:
        ents, score = self._hirschberg(list(s1), list(s2))
        return AlignedSequence(ents, score, self.blank)

    def _hirschberg(self, s1, s2) -> Tuple[List[AlignedEntry], int]:
        g = self.scoring.gap_penalty
        if len(s1) <= 1 or len(s2) <= 1:
            H, P = self._nw_matrix(s1, s2)
            return self._walk(s1, s2, P), H[len(s1)][len(s2)]
        mid = len(s1) // 2
        left = self._score_row(s1[:mid], s2)
        right = self._score_row(s1[mid:][::-1], s2[::-1])[::-1]
        split, best = 0, None
        for j in range(len(s2) + 1):
            v = left[j] + right[j]
            if best is None or v > best:
                best, split = v, j
        e1, sc1 = self._hirschberg(s1[:mid], s2[:split])
        e2, sc2 = self._hirschberg(s1[mid:], s2[split:])
        return e1 + e2, sc1 + sc2


class GotohSA(SequenceAligner):
    """Full-matrix AFFINE-gap alignment for arbitrary elements, global or
    local (``local=True`` = Smith-Waterman-style zero clamp + argmax end,
    the engine's config-3 capability at the generic-API layer).  Same
    tie-breaks as the engine contract: DIAG > UP > LEFT, extend >= open,
    smallest-i-then-j argmax."""

    def __init__(self, *args, gap_open: int = 0, gap_extend: int | None = None,
                 local: bool = False, **kw):
        super().__init__(*args, **kw)
        self.gap_open = gap_open
        self.gap_extend = (
            gap_extend if gap_extend is not None else self.scoring.gap_penalty
        )
        self.local = local

    def get_alignment(self, s1, s2) -> AlignedSequence:
        NEG = -(1 << 50)
        o, e = self.gap_open, self.gap_extend
        n, m = len(s1), len(s2)
        H = [[NEG] * (m + 1) for _ in range(n + 1)]
        E = [[NEG] * (m + 1) for _ in range(n + 1)]
        F = [[NEG] * (m + 1) for _ in range(n + 1)]
        PH = [[0] * (m + 1) for _ in range(n + 1)]  # 0 STOP 1 DIAG 2 UP 3 LEFT
        XE = [[False] * (m + 1) for _ in range(n + 1)]
        XF = [[False] * (m + 1) for _ in range(n + 1)]
        H[0][0] = 0
        best, bi, bj = 0, 0, 0
        for i in range(n + 1):
            for j in range(m + 1):
                if i == 0 and j == 0:
                    continue
                if j > 0:
                    ext, opn = E[i][j - 1] + e, H[i][j - 1] + o + e
                    XE[i][j] = ext >= opn
                    E[i][j] = max(ext, opn)
                if i > 0:
                    ext, opn = F[i - 1][j] + e, H[i - 1][j] + o + e
                    XF[i][j] = ext >= opn
                    F[i][j] = max(ext, opn)
                d = NEG
                if i > 0 and j > 0:
                    ps = self._pair_score(s1[i - 1], s2[j - 1])
                    if ps is not None:
                        d = H[i - 1][j - 1] + ps
                cand = max(d, F[i][j], E[i][j])
                if self.local and cand <= 0:
                    H[i][j] = 0
                    PH[i][j] = 0
                    continue
                H[i][j] = cand
                PH[i][j] = 1 if d == cand else (2 if F[i][j] == cand else 3)
                if self.local and cand > best:
                    best, bi, bj = cand, i, j
        i, j = (bi, bj) if self.local else (n, m)
        score = best if self.local else H[n][m]
        ents: List[AlignedEntry] = []
        state = "H"
        while True:
            if state == "H":
                p = PH[i][j]
                if p == 0:
                    break
                if p == 1:
                    a, b = s1[i - 1], s2[j - 1]
                    ents.append(AlignedEntry(a, b, self.match_fn(a, b)))
                    i, j = i - 1, j - 1
                elif p == 2:
                    state = "F"
                else:
                    state = "E"
            elif state == "F":
                ents.append(AlignedEntry(s1[i - 1], self.blank, False))
                was = XF[i][j]
                i -= 1
                if not was:
                    state = "H"
            else:
                ents.append(AlignedEntry(self.blank, s2[j - 1], False))
                was = XE[i][j]
                j -= 1
                if not was:
                    state = "H"
            if not self.local and i == 0 and j == 0:
                break
        ents.reverse()
        return AlignedSequence(ents, int(score), self.blank)


class MyersMillerSA(SequenceAligner):
    """Linear-space AFFINE-gap global alignment (Myers & Miller 1988) —
    the affine upgrade of :class:`HirschbergSA` (round-1 deferral,
    SURVEY.md §8).

    Gap runs score ``gap_open + len * gap_extend`` (engine convention,
    SURVEY.md §2.2; both <= 0); ``gap_open=0`` degenerates to Hirschberg.
    The divide step computes forward (CC, DD) and reverse (RR, SS) score
    vectors of the two halves, where DD/SS constrain the path to end in a
    vertical gap at the midline; a straddling vertical gap is merged with
    a single ``-gap_open`` credit and the recursion carries open-gap
    boundary flags (tb/te) so sub-problems never double-charge an open.
    O(min) memory, ~2x the fill work of the full matrix.

    Optimal score is guaranteed (exhaustively tested vs the Gotoh
    oracle); among co-optimal alignments the emitted column order may
    differ from the engine's canonical DIAG > UP > LEFT walk.
    """

    def __init__(self, *args, gap_open: int = 0, gap_extend: int | None = None,
                 **kw):
        super().__init__(*args, **kw)
        self.gap_open = gap_open
        self.gap_extend = (
            gap_extend if gap_extend is not None else self.scoring.gap_penalty
        )

    _NEG = -(1 << 50)

    def _s(self, a, b) -> int:
        ps = self._pair_score(a, b)
        return self._NEG if ps is None else ps

    # -- forward/reverse boundary-flagged score vectors ---------------------
    def _vectors(self, A, B, tb):
        """(CC, DD) after consuming all of A: CC[j] = best score of A vs
        B[:j]; DD[j] = ditto constrained to end in a vertical gap (covering
        A[-1]).  tb = open charge for a vertical gap starting at the top
        boundary (0 if one is already open there)."""
        o, e = self.gap_open, self.gap_extend
        M = len(B)
        CC = [0] + [o + j * e for j in range(1, M + 1)]
        DD = [self._NEG] * (M + 1)
        for i in range(1, len(A) + 1):
            oo = tb if i == 1 else o  # top-boundary merge on the first row
            prev0 = CC[0]
            DD[0] = max(DD[0] + e, CC[0] + oo + e)
            CC[0] = DD[0]
            erun = self._NEG
            a = A[i - 1]
            for j in range(1, M + 1):
                DD[j] = max(DD[j] + e, CC[j] + oo + e)
                erun = max(erun + e, CC[j - 1] + o + e)
                diag = prev0 + self._s(a, B[j - 1])
                prev0 = CC[j]
                CC[j] = max(diag, DD[j], erun)
        return CC, DD

    def _gap_entries(self, seq, vertical):
        if vertical:
            return [AlignedEntry(x, self.blank, False) for x in seq]
        return [AlignedEntry(self.blank, x, False) for x in seq]

    def _diff(self, A, B, tb, te) -> List[AlignedEntry]:
        o, e = self.gap_open, self.gap_extend
        N, M = len(A), len(B)
        if N == 0:
            return self._gap_entries(B, vertical=False)
        if M == 0:
            # one vertical gap, open merged with the cheaper boundary
            return self._gap_entries(A, vertical=True)
        if N == 1:
            # best single-row layout: delete A[0] + insert B as one run,
            # or align A[0] with some B[j] between two insert runs
            best_v = (max(tb, te) + e) + (o + M * e)
            best_j, best_s = None, None
            for j in range(M):
                v = (
                    (o + j * e if j > 0 else 0)
                    + self._s(A[0], B[j])
                    + (o + (M - 1 - j) * e if j < M - 1 else 0)
                )
                if best_s is None or v > best_s:
                    best_s, best_j = v, j
            if best_s is not None and best_s >= best_v:
                j = best_j
                return (
                    self._gap_entries(B[:j], False)
                    + [AlignedEntry(A[0], B[j], self.match_fn(A[0], B[j]))]
                    + self._gap_entries(B[j + 1 :], False)
                )
            return self._gap_entries(A, True) + self._gap_entries(B, False)
        mid = N // 2
        CCf, DDf = self._vectors(A[:mid], B, tb)
        CCr, DDr = self._vectors(A[mid:][::-1], B[::-1], te)
        best, split, straddle = None, 0, False
        for j in range(M + 1):
            c1 = CCf[j] + CCr[M - j]
            c2 = DDf[j] + DDr[M - j] - o  # merged straddling vertical gap
            if best is None or c1 > best:
                best, split, straddle = c1, j, False
            if c2 > best:
                best, split, straddle = c2, j, True
        if straddle:
            return (
                self._diff(A[: mid - 1], B[:split], tb, 0)
                + self._gap_entries(A[mid - 1 : mid + 1], True)
                + self._diff(A[mid + 1 :], B[split:], 0, te)
            )
        return self._diff(A[:mid], B[:split], tb, o) + self._diff(
            A[mid:], B[split:], o, te
        )

    def get_alignment(self, s1, s2) -> AlignedSequence:
        ents = self._diff(list(s1), list(s2), self.gap_open, self.gap_open)
        return AlignedSequence(ents, self._score_entries(ents), self.blank)

    def _score_entries(self, ents) -> int:
        """Affine re-scoring of an emitted alignment (engine convention)."""
        o, e = self.gap_open, self.gap_extend
        total, run = 0, None  # run: 'I' | 'D' | None
        for ent in ents:
            if ent.a is not self.blank and ent.b is not self.blank:
                total += self._s(ent.a, ent.b)
                run = None
            else:
                op = "I" if ent.b is self.blank else "D"
                total += e if run == op else o + e
                run = op
        return total


class FOGSAA(SequenceAligner):
    """Branch-and-bound optimal global alignment (reference FOGSAA.h,
    SURVEY.md §2.1: "priority-queue expansion").

    Best-first expansion of the alignment DAG ordered by
    ``present score + Fmax(remainder)``, where the optimistic future score
    ``Fmax(x1, x2) = min(x1, x2) * best_pair + |x1 - x2| * gap`` is
    admissible (never underestimates) and consistent for ``gap <= 0 <=
    match``, so the first time the terminal node (n, m) is popped its
    score is the NW-optimal global score and no node is expanded twice.
    Branches whose optimistic total cannot beat an already-found terminal
    score are never popped — the pruning that defines FOGSAA.  Among
    co-optimal alignments the returned path may differ from NW's strict
    DIAG > UP > LEFT order (children are enqueued diagonal-first, so ties
    lean the same way, but global tie order is not guaranteed — the score
    is).

    Falls back to :class:`NeedlemanWunschSA` when ``gap_penalty > 0`` or
    ``match_profit < 0`` (the bound is only admissible outside that
    regime).  ``expanded`` records the node count of the last search for
    pruning diagnostics.
    """

    expanded: int = 0

    def get_alignment(self, s1, s2) -> AlignedSequence:
        sc = self.scoring
        best_pair = max(
            sc.match_profit,
            sc.mismatch_penalty if sc.allow_mismatch else sc.match_profit,
        )
        if sc.gap_penalty > 0 or best_pair < 0:
            return NeedlemanWunschSA(sc, self.match_fn, self.blank).get_alignment(
                s1, s2
            )
        n, m = len(s1), len(s2)
        g = sc.gap_penalty

        def fmax(i: int, j: int) -> int:
            x1, x2 = n - i, m - j
            return min(x1, x2) * best_pair + abs(x1 - x2) * g

        NEG = -(1 << 50)
        best_g = {(0, 0): 0}
        parent = {}  # (i, j) -> (pi, pj, AlignedEntry)
        heap = [(-fmax(0, 0), 0, 0, 0)]  # (-f, push-order, i, j)
        cnt = 0
        self.expanded = 0
        while heap:
            nf, _, i, j = heapq.heappop(heap)
            gc = best_g[(i, j)]
            if -nf != gc + fmax(i, j):
                continue  # stale entry: a better path reached (i, j) later
            self.expanded += 1
            if i == n and j == m:
                ents: List[AlignedEntry] = []
                while (i, j) != (0, 0):
                    i, j, ent = parent[(i, j)]
                    ents.append(ent)
                ents.reverse()
                return AlignedSequence(ents, gc, self.blank)
            # children diagonal-first so equal-f ties pop DIAG > UP > LEFT
            kids = []
            if i < n and j < m:
                ps = self._pair_score(s1[i], s2[j])
                if ps is not None:
                    kids.append(
                        (i + 1, j + 1, gc + ps,
                         AlignedEntry(s1[i], s2[j], self.match_fn(s1[i], s2[j])))
                    )
            if i < n:
                kids.append((i + 1, j, gc + g, AlignedEntry(s1[i], self.blank, False)))
            if j < m:
                kids.append(
                    (i, j + 1, gc + g, AlignedEntry(self.blank, s2[j], False))
                )
            for kid in kids:
                ci, cj, cg, ent = kid
                if cg > best_g.get((ci, cj), NEG):
                    best_g[(ci, cj)] = cg
                    parent[(ci, cj)] = (i, j, ent)
                    cnt += 1
                    heapq.heappush(heap, (-(cg + fmax(ci, cj)), cnt, ci, cj))
        # unreachable terminal: possible only with allow_mismatch=False and
        # no all-gap route pruned — the all-gap path always exists, so this
        # is truly unreachable; guard for safety.
        raise RuntimeError("FOGSAA search exhausted without reaching (n, m)")


class SmithWatermanSA(SequenceAligner):
    """Local alignment (reference SW capability, BASELINE.json:8)."""

    def get_alignment(self, s1, s2) -> AlignedSequence:
        g = self.scoring.gap_penalty
        n, m = len(s1), len(s2)
        H = [[0] * (m + 1) for _ in range(n + 1)]
        P = [[0] * (m + 1) for _ in range(n + 1)]
        best, bi, bj = 0, 0, 0
        for i in range(1, n + 1):
            a = s1[i - 1]
            for j in range(1, m + 1):
                ps = self._pair_score(a, s2[j - 1])
                d = H[i - 1][j - 1] + ps if ps is not None else -(1 << 50)
                u = H[i - 1][j] + g
                l = H[i][j - 1] + g
                cand = max(d, u, l)
                if cand <= 0:
                    continue
                H[i][j] = cand
                P[i][j] = 1 if d == cand else (2 if u == cand else 3)
                if cand > best:
                    best, bi, bj = cand, i, j
        ents: List[AlignedEntry] = []
        i, j = bi, bj
        while P[i][j] != 0:
            p = P[i][j]
            if p == 1:
                a, b = s1[i - 1], s2[j - 1]
                ents.append(AlignedEntry(a, b, self.match_fn(a, b)))
                i, j = i - 1, j - 1
            elif p == 2:
                ents.append(AlignedEntry(s1[i - 1], self.blank, False))
                i -= 1
            else:
                ents.append(AlignedEntry(self.blank, s2[j - 1], False))
                j -= 1
        ents.reverse()
        return AlignedSequence(ents, best, self.blank)
