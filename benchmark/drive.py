"""Call the program under test the way a user does, as a traffic file's
``request`` says, and bring every answer to one form.

``request``: ``entry`` (a public function of ``seqalib_tpu_torch``),
``args`` and ``kwargs``, whose strings starting with ``$`` stand for
``$queries`` / ``$targets`` (the call's batch), ``$query`` / ``$target``
(its one pair), ``$scoring`` and ``$mode`` (the configuration's, read once
by ``cells.scoring``), ``$band``, ``$mesh`` (the configuration's mesh of
``mesh`` entries naming the card) and ``$device``; ``pairing``: ``zip``
(the default: query k against target k) or ``all_vs_all`` (every query
against every target, answers in row-major order); ``answers``: ``score``
or ``alignment``.

An answer is ``(score, query_start, query_end, target_start, target_end,
cigar)``; a bare score from a score-only entry is ``(score,)``; without an
alignment the CIGAR is dropped.  Two answers are compared on the fields
both have.
"""

from __future__ import annotations

FIELDS = ("score", "qs", "qe", "ts", "te")


def program_scoring(st, sc):
    """The program's ``ScoringParams`` for a ``cells.Scoring``."""
    if sc.matrix is not None:
        return st.ScoringParams(gap_open=sc.gap_open, gap_extend=sc.gap_extend,
                                matrix=sc.matrix)
    return st.ScoringParams(match=sc.match, mismatch=sc.mismatch, gap_open=sc.gap_open,
                            gap_extend=sc.gap_extend)


def pairs(request: dict, nq: int, nt: int) -> list:
    """The (query, target) indices of a call's answers, in their order."""
    if request.get("pairing", "zip") == "all_vs_all":
        return [(i, j) for i in range(nq) for j in range(nt)]
    return [(k, k) for k in range(nq)]


def make_call(st, sc, config: dict, request: dict, device):
    """A function of one batch ``(queries, targets)`` returning its answers;
    ``sc`` is the configuration's ``cells.Scoring``."""
    fn = getattr(st, request["entry"])
    fixed = {
        "$scoring": program_scoring(st, sc),
        "$mode": sc.mode,
        "$band": sc.band,
        "$mesh": st.make_band_mesh([device] * int(config.get("mesh", 1))),
        "$device": device,
    }
    alignment = request["answers"] == "alignment"

    def bind(x, qs, ts):
        if not (isinstance(x, str) and x.startswith("$")):
            return x
        per_call = {"$queries": qs, "$targets": ts}
        if len(qs) == 1:
            per_call.update({"$query": qs[0], "$target": ts[0]})
        if x in per_call:
            return per_call[x]
        return fixed[x]

    def call(qs, ts):
        args = [bind(a, qs, ts) for a in request["args"]]
        kwargs = {k: bind(v, qs, ts) for k, v in request.get("kwargs", {}).items()}
        return normalize(fn(*args, **kwargs), alignment)

    return call


def normalize(out, alignment: bool) -> list:
    if isinstance(out, int):
        return [(int(out),)]
    if isinstance(out, dict):  # all against all: (n_queries, n_targets) arrays
        cols = [out[f].reshape(-1).tolist() for f in FIELDS]
        return [tuple(int(v) for v in row) for row in zip(*cols)]
    items = out if isinstance(out, list) else [out]
    res = []
    for r in items:
        t = (int(r.score), int(r.query_start), int(r.query_end), int(r.target_start),
             int(r.target_end))
        res.append(t + (r.cigar,) if alignment else t)
    return res


def same(answer, expected) -> bool:
    """Whether ``answer`` agrees with ``expected`` on every field it has."""
    return answer is not None and len(answer) <= len(expected) and \
        tuple(answer) == tuple(expected[: len(answer)])


def call_cells(band, qs, ts, index) -> int:
    """The cells a call is credited with: n m a pair, n 2 w in a band;
    ``index`` is the call's ``pairs``."""
    if band is not None:
        return sum(len(qs[i]) * 2 * band for i, _ in index)
    return sum(len(qs[i]) * len(ts[j]) for i, j in index)
