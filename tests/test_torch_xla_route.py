"""Port parity for the ``backend="xla"`` route (``ops/wavefront_xla.py``:
kernel 7's fills and the wavefront walk, their plain versions on the CPU):
``align_batch(..., backend="xla", device="cpu")`` against the JAX
package's ``align_batch(..., backend="xla")`` (its full-matrix wavefront,
``wavefront_xla.wavefront_bucket``) and the oracle, at the
``str(AlignResult)`` level.

* global and local, linear and affine gaps, DNA and BLOSUM62, with and
  without traceback, an empty query and a local pair with no positive cell
  among the pairs;
* a band (global only: the band forces affine gaps, as in the JAX route);
* the two adversarial co-optimal ties of ``tests/test_fused_tie_boundary.py``
  (class A: the canonical start 70 diagonals off the anchor; class B:
  beyond the pass-2 column clamp): this route's reverse extension spans
  every query row, so it returns the oracle's canonical outcome;
* the dispatch: ``"xla"`` sends every bucket, banded or not, to the route
  (``run_bucket(backend="xla")``), under a mesh too (a launch per shard),
  ``"strip"`` and ``"pallas"`` do not.
"""

import numpy as np
import pytest
import torch

import seqalib_tpu as sa
import seqalib_tpu_torch as st
from seqalib_tpu.types import BLOSUM62
from seqalib_tpu.types import ScoringParams as JaxScoringParams
from seqalib_tpu_torch.ops import wavefront_xla as xla_mod
from seqalib_tpu_torch.parallel import dispatch
from seqalib_tpu_torch.scoring import scoring_params

SCORINGS = {  # name -> (JAX scoring, alphabet)
    "dna_linear": (JaxScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2), 4),
    "dna_affine": (JaxScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2), 4),
    "blosum62_affine": (JaxScoringParams(gap_open=-10, gap_extend=-1, matrix=BLOSUM62), 20),
    "blosum62_linear": (JaxScoringParams(gap_open=0, gap_extend=-4, matrix=BLOSUM62), 20),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psp(jsp):
    return scoring_params(jsp.match, jsp.mismatch, jsp.gap_open, jsp.gap_extend, jsp.matrix)


def _pairs(alpha, seed):
    """Pairs of one (64, 64) length bucket, plus an empty query and a local
    pair with no positive cell (letters that never match, every score < 0
    under both tables)."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for L in (60, 41, 55, 33, 48):
        q = rng.integers(0, alpha, L).astype(np.uint8)
        t = np.concatenate([rng.integers(0, alpha, 4), q[2:L - 3], rng.integers(0, alpha, 6)])
        t = np.delete(t, [9, 10, 11]) if L > 40 else np.insert(t, 7, [1, 2])
        t[::7] = rng.integers(0, alpha, len(t[::7]))
        qs.append(q)
        ts.append(t[:64].astype(np.uint8))
    qs.append(np.zeros(0, np.uint8))
    ts.append(rng.integers(0, alpha, 37).astype(np.uint8))
    # DNA A against C, BLOSUM62 W against D (-4): no positive cell
    qs.append(np.zeros(40, np.uint8) + (17 if alpha == 20 else 0))
    ts.append(np.zeros(35, np.uint8) + (3 if alpha == 20 else 1))
    return qs, ts


def _strs(res, traceback):
    return [str(r) if traceback else str(r).rsplit(" ", 1)[0] for r in res]


@pytest.mark.parametrize("traceback", [True, False])
@pytest.mark.parametrize("mode", ["global", "local"])
@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_xla_route_matches_jax_and_the_oracle(scoring, mode, traceback):
    jsp, alpha = SCORINGS[scoring]
    qs, ts = _pairs(alpha, len(scoring))
    got = st.align_batch(qs, ts, scoring=_psp(jsp), mode=mode, traceback=traceback,
                         backend="xla", device="cpu")
    jax = sa.align_batch(qs, ts, scoring=jsp, mode=mode, traceback=traceback, backend="xla")
    assert [str(r) for r in got] == [str(r) for r in jax]
    want = [sa.align(q, t, scoring=jsp, mode=mode, backend="oracle") for q, t in zip(qs, ts)]
    assert _strs(got, traceback) == _strs(want, traceback)
    if mode == "local":
        assert (got[-1].score, got[-1].cigar) == (0, "")
    if traceback:
        assert all(r.cigar for r in got[:5])


@pytest.mark.parametrize("scoring", ["dna_affine", "blosum62_linear"])
def test_xla_route_with_a_band_matches_jax_and_the_oracle(scoring):
    jsp, alpha = SCORINGS[scoring]
    qs, ts = _pairs(alpha, 7)
    qs, ts = qs[:-1], ts[:-1]
    got = st.align_batch(qs, ts, scoring=_psp(jsp), mode="global", band=6, backend="xla",
                         device="cpu")
    jax = sa.align_batch(qs, ts, scoring=jsp, mode="global", band=6, backend="xla")
    assert [str(r) for r in got] == [str(r) for r in jax]
    want = [sa.align(q, t, scoring=jsp, mode="global", band=6, backend="oracle")
            for q, t in zip(qs, ts)]
    assert [str(r) for r in got] == [str(r) for r in want]


def _tie_a():
    """``test_fused_tie_boundary._tie_problem``: class A."""
    A, M, N = list(range(0, 7)), list(range(7, 14)), list(range(14, 21))
    rq = np.full(49, 28, np.uint8)
    rq[0:7], rq[7:14], rq[42:49] = A, M, N
    rt = np.full(84, 29, np.uint8)
    rt[0:7], rt[42:49], rt[77:84] = A, N, M
    mat = np.full((30, 30), -4, np.int32)
    for x in A + M + N:
        mat[x, x] = 11
    return rq[::-1].copy(), rt[::-1].copy(), mat


def _tie_b():
    """``test_fused_tie_boundary._tie_problem_b``: class B."""
    X, Z, Y, JQ, JT = 0, 1, 2, 3, 4
    rq = np.full(124, JQ, np.uint8)
    rq[0:28], rq[28:56], rq[84:124] = X, Z, Y
    rt = np.full(260, JT, np.uint8)
    rt[0:28], rt[28:68], rt[232:260] = X, Y, Z
    mat = np.full((12, 12), -4, np.int32)
    mat[X, X] = mat[Z, Z] = 11
    mat[Y, Y] = 4
    return rq[::-1].copy(), rt[::-1].copy(), mat


@pytest.mark.parametrize("tie,want", [
    (_tie_a, "score=84 q[35:49] t[0:84] 7M70D7M"),
    (_tie_b, "score=412 q[68:124] t[0:260] 28M204D28M"),
], ids=["class_a", "class_b"])
def test_xla_route_returns_the_canonical_start_of_the_adversarial_ties(tie, want):
    q, t, mat = tie()
    jsp = JaxScoringParams(gap_open=0, gap_extend=-1, matrix=mat)
    assert str(sa.align(q, t, scoring=jsp, mode="local", backend="oracle")) == want
    got = st.align(q, t, scoring=_psp(jsp), mode="local", backend="xla", device="cpu")
    assert str(got) == want
    assert str(sa.align(q, t, scoring=jsp, mode="local", backend="xla")) == want


def test_dispatch_sends_every_xla_bucket_to_the_route(monkeypatch):
    """``"xla"`` runs ``xla_launch`` for every bucket, a banded one with a
    DNA table included (which ``"strip"`` sends to the banded route); under
    a mesh ``"xla"`` runs it on every shard (``dist.wavefront_sharded``), as
    in the JAX package, and returns the strip route's results."""
    from seqalib_tpu_torch.parallel import dist

    seen = []
    real = xla_mod.xla_launch

    def spy(*a, **k):
        seen.append((k["mode"], k["band"]))
        return real(*a, **k)

    monkeypatch.setattr(dispatch, "xla_launch", spy)
    monkeypatch.setattr(dist, "xla_launch", spy)
    jsp, alpha = SCORINGS["dna_affine"]
    qs, ts = _pairs(alpha, 3)
    qs, ts = qs[:5], ts[:5]
    sp = _psp(jsp)
    st.align_batch(qs, ts, scoring=sp, mode="local", backend="xla", device="cpu")
    st.align_batch(qs, ts, scoring=sp, mode="global", band=5, backend="xla", device="cpu")
    assert seen == [("local", None), ("global", 5)]
    for backend in ("strip", "pallas"):
        st.align_batch(qs, ts, scoring=sp, mode="local", backend=backend, device="cpu")
        st.align_batch(qs, ts, scoring=sp, mode="global", band=5, backend=backend,
                       device="cpu")
    got = st.align_batch(qs, ts, scoring=sp, mode="local", backend="xla",
                         mesh=["cpu"] * 2)
    assert seen[2:] == [("local", None)] * 2
    want = st.align_batch(qs, ts, scoring=sp, mode="local", backend="strip", device="cpu")
    assert [str(r) for r in got] == [str(r) for r in want]
    with pytest.raises(ValueError, match="out of contract"):
        xla_mod.xla_launch(np.zeros((1, 4), np.int32), np.zeros((1, 4), np.int32), [4], [4],
                           sp, mode="local", band=3, want_tb=False, device="cpu")


def test_all_vs_all_on_the_xla_route_matches_jax():
    jsp, alpha = SCORINGS["dna_linear"]
    rng = np.random.default_rng(5)
    reads = [rng.integers(0, alpha, int(n)).astype(np.uint8) for n in (20, 31, 25)]
    refs = [rng.integers(0, alpha, int(n)).astype(np.uint8) for n in (40, 52)]
    got = st.align_all_vs_all(reads, refs, scoring=_psp(jsp), backend="xla", device="cpu")
    want = sa.align_all_vs_all(reads, refs, scoring=jsp, backend="xla")
    for f in ("score", "qs", "qe", "ts", "te"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("mode", ["global", "local"])
def test_xla_route_cuts_a_stream_over_the_budget_into_parts(mode, monkeypatch):
    """A bucket whose pointer stream (K x B x Np bytes) exceeds
    ``SEQALIB_PTR_HBM_CAP`` is filled and walked in parts under it, as the
    strip engine cuts its global batches: the results are the same."""
    from seqalib_tpu_torch.ops import wavefront as wf_mod

    jsp, alpha = SCORINGS["blosum62_affine"]
    qs, ts = _pairs(alpha, 11)
    kw = dict(scoring=_psp(jsp), mode=mode, backend="xla", device="cpu")
    want = st.align_batch(qs, ts, **kw)
    parts = []
    real = wf_mod._launch_part

    def count(q, *a, **k):
        parts.append(len(q))
        return real(q, *a, **k)

    monkeypatch.setattr(wf_mod, "_launch_part", count)
    # three pairs' streams of the 64 x 64 bucket: (64 + 64 + 1) x 128 bytes each
    monkeypatch.setenv("SEQALIB_PTR_HBM_CAP", str(3 * 129 * 128))
    got = st.align_batch(qs, ts, **kw)
    assert [str(r) for r in got] == [str(r) for r in want]
    assert max(parts) <= 3 and len(parts) >= 2
