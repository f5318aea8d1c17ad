"""Seeded differential sweep of the public entry points.

``draws(seed)`` makes the pairs: lengths 1-400 (the edge lengths 1, 2,
31-33, 63-65, 127-129, 255-257, 383-385 and 400, random lengths that are
no power of two, pairs of 1 against 400 and others whose length delta is
far larger than the shorter side, short pairs of 1-8 letters, local
pairs that score 0), both modes,
and six scorings (``SCORINGS``): DNA with linear and affine gaps,
BLOSUM62 o=-10 e=-1, the wide table 2 x BLOSUM62 o=-20 e=-2, BLOSUM62 with
``gap_open=0``, and DNA affine scaled by 2^k near int32's range (k the
largest with |o| + (n + m) * max(|e|, |s|) <= 2^29, ``overflow_shift``).
The first ``SUBSET`` draws keep both lengths of a pair inside one of three
length buckets (16, 32, 64): they are the sample the quick test runs.

``run_route(api, name, draws)`` sends the draws through one route of
``ROUTES`` (``align_batch`` on the strip route under both pass-2 engines,
with and without traceback, and on ``"xla"``; ``band=`` 1, 3, 16 and 800;
``align``; ``align_all_vs_all``; both full-matrix SP entry points and
both banded-SP ones) and returns ``Result``s: what the route gave, and
what the oracle is asked for the same pair.  ``api`` is ``PortAPI(device)``
here; anything with the same methods (the JAX package's, in the tests)
runs the same draws.  ``check(results, oracle)`` lists the mismatches
against ``oracle_fast``; ``identity_checks(device)`` holds the identities
of ``tests/test_torch_properties.py`` on ``device``.

Used by ``tests/test_torch_sweep.py`` (the CPU and the card) and
``chip_smoke.py``'s sweep phase.
"""

from __future__ import annotations

import dataclasses
import os
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np

from .oracle_fast import align_oracle, nw_affine, sw_affine
from .types import BLOSUM62, AlignResult, ScoringParams, encode_dna
from .utils.cigar import transpose_cigar

SEED = 0
MAX_LEN = 400
EDGE_LENGTHS = (1, 2, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257, 383, 384, 385,
                400)
# (shorter, longer) sides of pairs whose delta dwarfs the shorter one
SKEWED = ((1, 400), (2, 385), (5, 300), (1, 129), (31, 400), (3, 257))
# short pairs, each scoring and mode twice: at the overflow scale their 2^k is
# the largest, while local pass 2 fills a window sized by the bucket
SHORT = ((1, 1), (2, 3), (3, 4), (5, 7), (8, 8), (1, 2), (4, 3), (7, 5), (6, 6), (2, 1),
         (3, 5), (8, 7))
# the quick sample: both sides of a pair inside one bucket_len bucket
SUBSET_BUCKETS = ((1, 16), (17, 32), (33, 64))
SUBSET = 36
COUNT = 240  # the whole sweep
BANDS = (1, 3, 16, 2 * MAX_LEN)  # the last holds every pair: the full matrix
SP_C = 32  # SP tiles: a 400-letter target is 13 of them
SP_BAND = 16  # banded SP: the band of align_banded_sp
SP_SCORE_BAND = 3  # and of align_score_banded_sp
MESH = 2
AVALL_SIDE = 3  # all-vs-all: 3 reads x 3 references of one group
OVERFLOW = 1 << 29

DNA_AFFINE = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
SCORINGS = {  # name -> (scoring; None: scaled per pair, alphabet)
    "dna_linear": (ScoringParams.linear(), 4),
    "dna_affine": (DNA_AFFINE, 4),
    "blosum62": (ScoringParams.blosum62(gap_open=-10, gap_extend=-1), 20),
    "wide": (ScoringParams(gap_open=-20, gap_extend=-2, matrix=2 * BLOSUM62), 20),
    "open0": (ScoringParams(gap_open=0, gap_extend=-4, matrix=BLOSUM62), 20),
    "overflow": (None, 4),
}
# the query letters of local affine pairs on "xla" (test_torch_wavefront_modes.py's
# draw): none scores above 0 against letter 0
LEAK_FREE = {4: (1, 2, 3), 20: tuple(x for x in range(20) if BLOSUM62[x, 0] <= 0)}


def overflow_shift(n: int, m: int) -> int:
    """The largest k with |o| + (n + m) * max(|e|, |s|) <= 2^29 for DNA
    affine scoring times 2^k."""
    base = -DNA_AFFINE.gap_open + (n + m) * max(-DNA_AFFINE.gap_extend, -DNA_AFFINE.mismatch,
                                                 DNA_AFFINE.match)
    return int(np.floor(np.log2(OVERFLOW / base)))


def scoring(name: str, shift: int = 0) -> ScoringParams:
    sp, _ = SCORINGS[name]
    if sp is not None:
        return sp
    s = 1 << shift
    return ScoringParams(match=DNA_AFFINE.match * s, mismatch=DNA_AFFINE.mismatch * s,
                         gap_open=DNA_AFFINE.gap_open * s, gap_extend=DNA_AFFINE.gap_extend * s)


@dataclasses.dataclass(frozen=True, eq=False)
class Draw:
    index: int
    q: np.ndarray  # uint8 letter codes
    t: np.ndarray
    scoring: str
    mode: str
    shift: int = 0  # the overflow scoring's 2^k

    @property
    def sp(self) -> ScoringParams:
        return scoring(self.scoring, self.shift)

    @property
    def group(self) -> Tuple[str, int, str]:
        return self.scoring, self.shift, self.mode

    def letters_for(self, route: str) -> np.ndarray:
        """The query a route takes: on "xla" (``align``'s default backend),
        local affine pairs map their query into the letters that never score
        above 0 against letter 0."""
        if ((route.startswith("xla") or route == "align") and self.mode == "local"
                and self.sp.is_affine):
            free = np.asarray(LEAK_FREE[SCORINGS[self.scoring][1]], np.uint8)
            return free[self.q % len(free)]
        return self.q


def _not_pow2(rng) -> int:
    while True:
        x = int(rng.integers(1, MAX_LEN + 1))
        if x & (x - 1):
            return x


def draws(seed: int = SEED, count: int = COUNT) -> List[Draw]:
    """The sweep's pairs; the first ``SUBSET`` are the quick sample (each
    scoring and mode once per bucket of ``SUBSET_BUCKETS``)."""
    rng = np.random.default_rng(seed)
    names = list(SCORINGS)
    out: List[Draw] = []

    def add(n, m, name, mode):
        alpha = SCORINGS[name][1]
        q = rng.integers(0, alpha, n).astype(np.uint8)
        t = rng.integers(0, alpha, m).astype(np.uint8)
        if min(n, m) > 8 and rng.random() < 0.5:  # a shared run: a real local hit
            k = int(rng.integers(1, min(n, m) // 2 + 1))
            a, b = int(rng.integers(0, n - k + 1)), int(rng.integers(0, m - k + 1))
            t[b: b + k] = q[a: a + k]
        if len(out) % 17 == 5 and name.startswith("dna"):  # disjoint letters: local 0
            q[:], t[:] = 0, 1
        shift = overflow_shift(n, m) if name == "overflow" else 0
        out.append(Draw(len(out), q, t, name, mode, shift))

    for x in range(SUBSET):
        lo, hi = SUBSET_BUCKETS[(x // (2 * len(names))) % len(SUBSET_BUCKETS)]
        edges = [v for v in (1, 2, 16, 17, 31, 32, 33, 63, 64) if lo <= v <= hi]
        n = edges[x % len(edges)] if x % 3 == 0 else int(rng.integers(lo, hi + 1))
        m = int(rng.integers(lo, hi + 1))
        add(n, m, names[x % len(names)], ("global", "local")[(x // len(names)) % 2])
    x = 0
    while len(out) < count:
        name, mode = names[x % len(names)], ("global", "local")[(x // len(names)) % 2]
        if x < len(EDGE_LENGTHS):
            n, m = EDGE_LENGTHS[x], EDGE_LENGTHS[(x * 7 + 3) % len(EDGE_LENGTHS)]
        elif x < len(EDGE_LENGTHS) + 2 * len(SKEWED):
            a, b = SKEWED[(x - len(EDGE_LENGTHS)) // 2]
            n, m = (a, b) if x % 2 else (b, a)
        elif x < len(EDGE_LENGTHS) + 2 * len(SKEWED) + 2 * len(SHORT):
            j = x - len(EDGE_LENGTHS) - 2 * len(SKEWED)
            n, m = SHORT[(j + j // len(names)) % len(SHORT)]
        else:
            r = rng.random()
            n = int(rng.choice(EDGE_LENGTHS)) if r < 0.3 else _not_pow2(rng)
            m = int(rng.choice(EDGE_LENGTHS)) if r > 0.7 else _not_pow2(rng)
        add(n, m, name, mode)
        x += 1
    return out


# ---- routes ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Result:
    """One route's answer for one pair, beside what the oracle is asked:
    ``kind`` "align" (``align_oracle``) or "affine" (``nw_affine`` /
    ``sw_affine``: the SP paths are Gotoh at any gap_open), at ``band``;
    ``form`` what is compared: "full" ``str(AlignResult)``, "coords" (no
    CIGAR) or "score"."""
    route: str
    label: str
    q: np.ndarray
    t: np.ndarray
    scoring: str
    shift: int
    mode: str
    kind: str
    band: Optional[int]
    form: str
    got: str


def coords(r: AlignResult) -> str:
    return f"score={r.score} q[{r.query_start}:{r.query_end}] t[{r.target_start}:{r.target_end}]"


def render(r, form: str) -> str:
    if form == "score":
        return f"score={r if isinstance(r, (int, np.integer)) else r.score}"
    return str(r) if form == "full" else coords(r)


@contextmanager
def pass2_engine(name: Optional[str]):
    """``SEQALIB_FUSED_PASS2`` set to ``name`` (None: left as it is)."""
    old = os.environ.get("SEQALIB_FUSED_PASS2")
    if name is not None:
        os.environ["SEQALIB_FUSED_PASS2"] = name
    try:
        yield
    finally:
        if name is not None:
            if old is None:
                del os.environ["SEQALIB_FUSED_PASS2"]
            else:
                os.environ["SEQALIB_FUSED_PASS2"] = old


class PortAPI:
    """The port's public entry points on one device; ``mesh`` is a mesh of
    ``MESH`` entries naming it."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)

    @staticmethod
    def scoring(sp):
        return sp

    def mesh(self):
        from .parallel.band_pipeline import make_band_mesh

        return make_band_mesh([self.device] * MESH)

    def align_batch(self, qs, ts, sp, mode, **kw):
        from .api import align_batch

        return align_batch(qs, ts, scoring=sp, mode=mode, device=self.device, **kw)

    def align(self, q, t, sp, mode, **kw):
        from .api import align

        return align(q, t, sp, mode=mode, device=self.device, **kw)

    def align_all_vs_all(self, reads, refs, sp, mode):
        from .api import align_all_vs_all

        return align_all_vs_all(reads, refs, sp, mode=mode, chunk_pairs=4,
                                device=self.device)

    def sp(self, name, *args, **kw):
        from . import align_banded_sp, align_score_banded_sp, align_score_sp, align_sp

        fn = {"align_sp": align_sp, "align_score_sp": align_score_sp,
              "align_banded_sp": align_banded_sp,
              "align_score_banded_sp": align_score_banded_sp}[name]
        return fn(*args, **kw)


# name -> (modes, what the route runs); a route of one mode skips the other's draws
ROUTES = {
    "strip": (("global", "local"), dict(backend="strip")),
    "pallas_score": (("global", "local"), dict(backend="pallas", traceback=False)),
    "strip_pass2": (("local",), dict(backend="strip", pass2="strip")),
    "strip_pass2_score": (("local",), dict(backend="pallas", traceback=False, pass2="strip")),
    "xla": (("global", "local"), dict(backend="xla")),
    "xla_score": (("global", "local"), dict(backend="xla", traceback=False)),
    **{f"band{w}": (("global",), dict(backend="strip", band=w)) for w in BANDS},
    "xla_band16": (("global",), dict(backend="xla", band=16)),
    "align": (("global", "local"), {}),
    "all_vs_all": (("global", "local"), {}),
    "sp": (("global",), {}),
    "sp_score": (("global", "local"), {}),
    "banded_sp": (("global",), dict(band=SP_BAND)),
    "banded_sp_score": (("global",), dict(band=SP_SCORE_BAND)),
}
# banded SP takes matrices in [-4, 11] only, as the JAX package's (it raises)
SKIP = {"banded_sp": ("wide",), "banded_sp_score": ("wide",)}


def groups(ds: List[Draw], modes, skip=()) -> Dict[tuple, List[Draw]]:
    out: Dict[tuple, List[Draw]] = {}
    for d in ds:
        if d.mode in modes and d.scoring not in skip:
            out.setdefault(d.group, []).append(d)
    return out


def run_route(api, name: str, ds: List[Draw]) -> List[Result]:
    """Send ``ds`` (the draws of the route's modes) through route ``name``
    of ``api``, one call per (scoring, shift, mode) group where the entry
    point takes a batch."""
    modes, kw = ROUTES[name]
    kw = dict(kw)
    pass2 = kw.pop("pass2", None)
    out: List[Result] = []

    def res(d, got, kind="align", band=None, form="full", label="", q=None, t=None):
        out.append(Result(name, label or f"#{d.index}", d.letters_for(name) if q is None else q,
                          d.t if t is None else t, d.scoring, d.shift, d.mode, kind, band,
                          form, got))

    for (sc, shift, mode), g in groups(ds, modes, SKIP.get(name, ())).items():
        sp = api.scoring(scoring(sc, shift))
        if name == "align":
            for d in g:
                res(d, str(api.align(d.letters_for(name), d.t, sp, mode)))
        elif name == "all_vs_all":
            reads, refs = [d.q for d in g[:AVALL_SIDE]], [d.t for d in g[:AVALL_SIDE]]
            prod = api.align_all_vs_all(reads, refs, sp, mode)
            for a, q in enumerate(reads):
                for b, t in enumerate(refs):
                    r = AlignResult(*(int(prod[k][a, b]) for k in ("score", "qs", "qe", "ts",
                                                                   "te")), "")
                    res(g[a], coords(r), form="coords", label=f"#{g[a].index}x#{g[b].index}",
                        t=t)
        elif name in ("sp", "sp_score"):
            mesh = api.mesh()
            for d in g:
                q, t = d.q.astype(np.int32), d.t.astype(np.int32)
                if name == "sp":
                    res(d, str(api.sp("align_sp", q, t, sp, mesh, C=SP_C)), kind="affine")
                else:
                    got = api.sp("align_score_sp", q, t, sp, mesh, mode=mode, C=SP_C)
                    res(d, render(int(got), "score"), kind="affine", form="score")
        elif name in ("banded_sp", "banded_sp_score"):
            mesh = api.mesh()
            band = kw["band"]
            qs = [d.q.astype(np.int32) for d in g]
            ts = [d.t.astype(np.int32) for d in g]
            if name == "banded_sp":
                got = api.sp("align_banded_sp", qs, ts, sp, band, mesh)
                for d, r in zip(g, got):
                    res(d, str(r), kind="affine", band=band)
            else:
                got = api.sp("align_score_banded_sp", qs, ts, sp, band, mesh)
                for d, s in zip(g, got):
                    res(d, render(int(s), "score"), kind="affine", band=band, form="score")
        else:
            form = "full" if kw.get("traceback", True) else "coords"
            qs = [d.letters_for(name) for d in g]
            with pass2_engine(pass2):
                got = api.align_batch(qs, [d.t for d in g], sp, mode, **kw)
            for d, r in zip(g, got):
                res(d, render(r, form), band=kw.get("band"), form=form)
    return out


def oracle_key(r: Result) -> tuple:
    return (r.q.tobytes(), r.t.tobytes(), r.scoring, r.shift, r.mode, r.kind, r.band)


def oracle_one(job) -> AlignResult:
    """The oracle's answer for one ``oracle_key`` (picklable for a pool)."""
    qb, tb, sc, shift, mode, kind, band = job
    q, t = np.frombuffer(qb, np.uint8), np.frombuffer(tb, np.uint8)
    sp = scoring(sc, shift)
    if kind == "align":
        return align_oracle(q, t, sp, mode=mode, band=band)
    return nw_affine(q, t, sp, band=band) if mode == "global" else sw_affine(q, t, sp)


def oracle_results(results: List[Result], processes: int = 1) -> Dict[tuple, AlignResult]:
    """``oracle_one`` of every distinct pair the results ask for."""
    jobs = list(dict.fromkeys(oracle_key(r) for r in results))
    if processes > 1 and len(jobs) > 1:
        import multiprocessing as mp

        with mp.get_context("fork").Pool(processes) as pool:
            return dict(zip(jobs, pool.map(oracle_one, jobs, chunksize=4)))
    return {j: oracle_one(j) for j in jobs}


def check(results: List[Result], oracle: Dict[tuple, AlignResult]) -> List[str]:
    """The results that differ from the oracle, one line each."""
    bad = []
    for r in results:
        want = render(oracle[oracle_key(r)], r.form)
        if r.got != want:
            bad.append(f"{r.route} {r.label} {r.scoring}<<{r.shift} {r.mode} "
                       f"{len(r.q)}x{len(r.t)}: got {r.got!r}, oracle {want!r}")
    return bad


# ---- identities -----------------------------------------------------------


def rescore(q, t, cigar: str, sp: ScoringParams) -> int:
    """Score of ``cigar`` aligning ``q`` to ``t`` from their first letters."""
    import re

    table = sp.substitution_matrix().astype(np.int64)
    i = j = score = 0
    for n, op in re.findall(r"(\d+)([MID])", cigar):
        n = int(n)
        if op == "M":
            score += int(table[q[i: i + n], t[j: j + n]].sum())
            i, j = i + n, j + n
        else:
            score += sp.gap_open + n * sp.gap_extend
            i, j = i + (n if op == "I" else 0), j + (n if op == "D" else 0)
    return score


ADVERSARIAL = [("A", "A"), ("A", "G"), ("A", "GGGGGGGG"), ("ACGT" * 4, "ACGT" * 4),
               ("AAAAAAAA", "CCCCCCCC"), ("ACGT" * 4, "TGCA"), ("A" * 16, "A" * 17),
               ("A" * 15, "A" * 16)]
LIN = ScoringParams.linear(match=2, mismatch=-3, gap=-2)
AFF = ScoringParams.affine(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
BLO = ScoringParams.blosum62(gap_open=-10, gap_extend=-1)


def identity_pairs(seed: int, count: int, lo: int, hi: int, alpha: int = 4):
    rng = np.random.default_rng(seed)
    qs = [rng.integers(0, alpha, int(rng.integers(lo, hi + 1))).astype(np.uint8)
          for _ in range(count)]
    ts = [rng.integers(0, alpha, int(rng.integers(lo, hi + 1))).astype(np.uint8)
          for _ in range(count)]
    return qs, ts


def symmetry(api, backend: str, sp: ScoringParams, qs, ts):
    """score(q, t) == score(t, q) in both modes; the transposed CIGAR of
    align(t, q) re-scores on (q, t) to the same score; SW >= 0."""
    for mode in ("global", "local"):
        fw = api.align_batch(qs, ts, sp, mode, backend=backend)
        bw = api.align_batch(ts, qs, sp, mode, backend=backend)
        for q, t, a, b in zip(qs, ts, fw, bw):
            assert a.score == b.score, (mode, a, b)
            cig = transpose_cigar(b.cigar)
            qq, tt = q[b.target_start: b.target_end], t[b.query_start: b.query_end]
            assert rescore(qq, tt, cig, sp) == a.score, (mode, a, b)
            if mode == "local":
                assert a.score >= 0


def self_alignment(api, backend: str, sp: ScoringParams, qs):
    """NW(x, x) equals the sum of the table's diagonal over x, CIGAR {n}M."""
    table = sp.substitution_matrix()
    for q, r in zip(qs, api.align_batch(qs, qs, sp, "global", backend=backend)):
        assert r.score == int(table[q, q].sum()) and r.cigar == f"{len(q)}M", (q, r)


def zero_local(api, backend: str):
    """Local pairs with no positive cell: score 0, the oracle's ``str()``."""
    qs = [encode_dna("AAAA"), encode_dna("A"), encode_dna("ACAC")]
    ts = [encode_dna("CCCCCC"), encode_dna("G"), encode_dna("GTTG")]
    sp = ScoringParams.linear(match=2, mismatch=-3, gap=-2)
    for q, t, r in zip(qs, ts, api.align_batch(qs, ts, api.scoring(sp), "local",
                                               backend=backend)):
        assert r.score == 0 and str(r) == str(align_oracle(q, t, sp, mode="local")), r


def adversarial(api, backend: str):
    qs = [encode_dna(a) for a, _ in ADVERSARIAL]
    ts = [encode_dna(b) for _, b in ADVERSARIAL]
    for mode in ("global", "local"):
        for sp in (LIN, AFF):
            got = api.align_batch(qs, ts, api.scoring(sp), mode, backend=backend)
            for q, t, r in zip(qs, ts, got):
                assert str(r) == str(align_oracle(q, t, sp, mode=mode)), (backend, mode, r)


def reverse_canonical(api, backend: str):
    """q = AC, t = ACGGAC: the canonical local result is q[0:2] t[0:2]."""
    q, t = encode_dna("AC"), encode_dna("ACGGAC")
    sp = ScoringParams.linear(match=2, mismatch=-3, gap=-2)
    r = api.align_batch([q], [t], api.scoring(sp), "local", backend=backend)[0]
    assert (r.query_start, r.query_end, r.target_start, r.target_end) == (0, 2, 0, 2), r
    assert str(r) == str(align_oracle(q, t, sp, mode="local")), r


def traceback_free_coords(api, backend: str, qs, ts, sp: ScoringParams, pass2=None):
    """``traceback=False`` coordinates equal ``traceback=True`` ones."""
    with pass2_engine(pass2):
        a = api.align_batch(qs, ts, sp, "local", backend=backend)
        b = api.align_batch(qs, ts, sp, "local", backend=backend, traceback=False)
    for x, y in zip(a, b):
        assert coords(x) == coords(y), (backend, pass2, x, y)


def banded_local_raises(api, backends=("oracle", "xla", "pallas", "strip")):
    """``band=`` with local mode raises the same ValueError from
    ``align`` and ``align_batch`` on every backend.  Returns the messages."""
    q = np.array([0, 1, 2, 3], np.uint8)
    t = np.array([0, 1, 1, 3], np.uint8)
    sp = api.scoring(ScoringParams.affine())
    said = []
    for backend in backends:
        for call in (lambda: api.align_batch([q], [t], sp, "local", band=4, backend=backend),
                     lambda: api.align(q, t, sp, "local", band=4, backend=backend)):
            try:
                call()
            except ValueError as e:
                assert "banded local" in str(e), (backend, e)
                said.append(str(e))
            else:
                raise AssertionError(f"{backend}: banded local did not raise")
    return said


def zero_open_equals_linear(device, qs, ts, sp: ScoringParams):
    """Gotoh with gap_open 0 scores as the linear recurrence, in both modes:
    kernel 7's fill (``wavefront_fill``, affine forced) and the strip route
    (``strip_bucket`` with affine tables).  Returns the scores of the two
    fills of kernel 7 and of the strip route, by mode."""
    from .ops.strip import strip_bucket
    from .ops.wavefront import _geometry, stage_wavefront, wavefront_fill
    from .ops.wavefront_xla import local_end
    from .parallel.dispatch import _pad_stack
    from .scoring import tables_from_params

    assert sp.gap_open == 0
    L = max(max(map(len, qs)), max(map(len, ts)))
    q, t = _pad_stack(qs, L), _pad_stack(ts, L)
    qlen = np.array([len(x) for x in qs], np.int32)
    tlen = np.array([len(x) for x in ts], np.int32)
    lin = tables_from_params(sp, device)
    aff = dataclasses.replace(lin, affine=True)
    out = {}
    for mode in ("global", "local"):
        B, n, m, Np, K = _geometry(q, t)
        qpad, tk, ql, tl, tab = stage_wavefront(q, t, qlen, tlen, sp, device)
        scores = []
        for affine in (True, False):
            r = wavefront_fill(qpad, tk, ql, tl, tab, K=K, band=None, gap_open=0,
                               gap_extend=sp.gap_extend, want_ptr=False, mode=mode,
                               affine=affine, stride=m + 1 if mode == "local" else None)
            s = r["score"] if mode == "global" else local_end(r["bv"], r["bk"], n + 1)[0]
            scores.append(s.cpu().numpy())
        assert np.array_equal(*scores), (mode, scores)
        strip = [strip_bucket(q, t, qlen, tlen, tb, mode=mode)["score"] for tb in (aff, lin)]
        assert np.array_equal(*strip), (mode, strip)
        assert np.array_equal(scores[0], strip[0]), (mode, scores[0], strip[0])
        out[mode] = scores[0]
    return out


def pass2_never_overestimates(device, pass2: str, seed: int = 0):
    """``local_fused`` at WR=128 on 8 self-alignments of 384 letters with 6
    mutations each: ``score2 <= score``, strictly (the span exceeds WR).
    Returns (score, score2)."""
    import torch

    from .ops.row_window import error_words
    from .ops.strip import local_fused, stage_strip
    from .scoring import tables_from_params

    sp = ScoringParams.affine(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    B, L = 8, 384
    q, t = overestimate_batch(seed, B, L)
    tables = tables_from_params(sp, device)
    lens = np.full(B, L, np.int32)
    qpad, t2, ql, tl = stage_strip(q, t, lens, lens, tables.A1, torch.device(device))
    out = local_fused(qpad, t2, ql, tl, tables, mq=L, WR=128, pass2=pass2, tie_safe=False,
                      err=error_words(5, torch.device(device)))
    score, score2 = out["score"].cpu().numpy(), out["score2"].cpu().numpy()
    assert (score2 <= score).all() and (score2 < score).all(), (pass2, score, score2)
    return score, score2


def overestimate_batch(seed: int, B: int, L: int):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, L).astype(np.int32)
    q = np.stack([base] * B)
    t = q.copy()
    for b in range(B):
        idx = rng.choice(L, 6, replace=False)
        t[b, idx] = (t[b, idx] + 1) % 4
    return q, t


def batch_invariance(api, backend: str, qs, ts, sp: ScoringParams, mode: str, mesh):
    """A pair's result in a shuffled batch of mixed lengths equals its
    result alone and on ``mesh``."""
    order = np.random.default_rng(1).permutation(len(qs))
    mixed = api.align_batch([qs[x] for x in order], [ts[x] for x in order], sp, mode,
                            backend=backend)
    sharded = api.align_batch(qs, ts, sp, mode, backend=backend, mesh=mesh)
    for k, x in enumerate(order):
        alone = api.align_batch([qs[x]], [ts[x]], sp, mode, backend=backend)[0]
        assert str(mixed[k]) == str(alone) == str(sharded[x]), (x, mixed[k], alone, sharded[x])


def identity_checks(device) -> int:
    """Every identity of ``tests/test_torch_properties.py`` on ``device``,
    port only (no JAX), at lengths up to 300; raises on the first that
    fails, else returns the number of checks made."""
    import torch

    from .parallel.dist import make_pair_mesh

    api = PortAPI(device)
    dna = ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)
    lin_pairs, blo_pairs = identity_pairs(3, 6, 1, 200), identity_pairs(3, 6, 1, 200, 20)
    qs, ts = identity_pairs(4, 6, 5, 300)
    mixed = identity_pairs(5, 9, 1, 300, 20)
    mesh = make_pair_mesh([torch.device(device)] * 3)
    checks = [lambda: zero_open_equals_linear(device, qs, ts, dna),
              lambda: traceback_free_coords(api, "xla", qs, ts, AFF),
              lambda: banded_local_raises(api)]
    for sp, (pq, pt) in ((LIN, lin_pairs), (BLO, blo_pairs)):
        for backend in ("strip", "xla"):
            checks += [lambda sp=sp, pq=pq, pt=pt, b=backend: symmetry(api, b, sp, pq, pt),
                       lambda sp=sp, pq=pq, b=backend: self_alignment(api, b, sp, pq)]
    for pass2 in ("banded", "strip"):
        checks += [lambda p=pass2: pass2_never_overestimates(device, p),
                   lambda p=pass2: traceback_free_coords(api, "strip", qs, ts, AFF, p)]
    for backend in ("strip", "pallas", "xla"):
        checks += [lambda b=backend: reverse_canonical(api, b),
                   lambda b=backend: adversarial(api, b),
                   lambda b=backend: zero_local(api, b)]
        if backend != "pallas":
            checks += [lambda b=backend, m=mode: batch_invariance(api, b, *mixed, BLO, m, mesh)
                       for mode in ("global", "local")]
    for check in checks:
        check()
    return len(checks)
