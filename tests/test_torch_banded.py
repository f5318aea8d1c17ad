"""Port parity for config 4, banded long reads: ``banded_align_batch`` and
``align_batch(band=)`` of ``seqalib_tpu_torch`` on the CPU (plain kernel
versions) against the JAX ``banded_align_batch`` in interpret mode and
against the oracle's banded Gotoh (``nw_affine(band=)``).  Exact equality
of ``str(AlignResult)``.  The cases mirror ``tests/test_banded.py``.
"""

import numpy as np
import pytest
import torch

import seqalib_tpu_torch as st
from seqalib_tpu import align_batch as jax_align_batch
from seqalib_tpu.models.banded import banded_align_batch as jax_banded_align_batch
from seqalib_tpu.oracle import nw_affine
from seqalib_tpu.types import ScoringParams as JaxScoringParams
from seqalib_tpu_torch.models import banded as port_banded
from seqalib_tpu_torch.models.banded import banded_align_batch
from seqalib_tpu_torch.ops import launches
from seqalib_tpu_torch.parallel import dispatch as port_dispatch
from seqalib_tpu_torch.scoring import scoring_params

JSP = JaxScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
SP = scoring_params(2, -3, -5, -2)
JBLOSUM = JaxScoringParams.blosum62()
BLOSUM = scoring_params(0, 0, JBLOSUM.gap_open, JBLOSUM.gap_extend, JBLOSUM.matrix)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them fast when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bucket(seed, qlens, tlens, alpha=4):
    rng = np.random.default_rng(seed)
    B, n, m = len(qlens), max(qlens), max(tlens)
    qs = np.zeros((B, n), np.int32)
    ts = np.zeros((B, m), np.int32)
    for b in range(B):
        qs[b, : qlens[b]] = rng.integers(0, alpha, qlens[b])
        ts[b, : tlens[b]] = rng.integers(0, alpha, tlens[b])
    return qs, ts, np.asarray(qlens), np.asarray(tlens)


def _oracle(qs, ts, qlen, tlen, jsp, band):
    return [str(nw_affine(qs[b, : qlen[b]], ts[b, : tlen[b]], jsp, band=band))
            for b in range(len(qlen))]


def _port(qs, ts, qlen, tlen, sp, band, **kw):
    return [str(r) for r in banded_align_batch(qs, ts, qlen, tlen, sp, band,
                                               device="cpu", **kw)]


# (qlens, tlens, band, CK, scoring): each runs through JAX once per module
JAX_CASES = {
    "square": ([64, 64], [64, 64], 12, 32, "dna"),
    "mixed_lengths": ([50, 40, 30], [54, 44, 34], 6, 16, "dna"),
    "mixed_deltas": ([60, 50, 64, 40], [60, 64, 48, 40], 8, None, "dna"),
    "blosum62": ([40, 56], [44, 50], 8, 16, "blosum62"),
}


@pytest.fixture(scope="module", params=sorted(JAX_CASES))
def jax_case(request):
    qlens, tlens, band, CK, scoring = JAX_CASES[request.param]
    alpha = 20 if scoring == "blosum62" else 4
    qs, ts, qlen, tlen = _bucket(len(request.param), qlens, tlens, alpha)
    jsp, sp = (JBLOSUM, BLOSUM) if scoring == "blosum62" else (JSP, SP)
    jax = jax_banded_align_batch(qs, ts, qlen, tlen, jsp, band, traceback=True, CK=CK)
    return dict(args=(qs, ts, qlen, tlen), jsp=jsp, sp=sp, band=band, CK=CK,
                jax=[str(r) for r in jax])


def test_banded_matches_jax_and_oracle(jax_case):
    qs, ts, qlen, tlen = jax_case["args"]
    before = dict(launches)
    got = _port(qs, ts, qlen, tlen, jax_case["sp"], jax_case["band"], CK=jax_case["CK"])
    assert launches == before  # the CPU path runs the plain versions
    assert got == jax_case["jax"]
    assert got == _oracle(qs, ts, qlen, tlen, jax_case["jsp"], jax_case["band"])


@pytest.mark.parametrize(
    "qlens,tlens,band,CK",
    [
        ([40], [30], 8, 16),  # negative delta (target shorter)
        ([33], [47], 16, 20),  # band wider than needed
        ([17], [19], 3, 8),  # tiny
        ([0, 5], [4, 0], 4, 8),  # empty sequences
    ],
)
def test_banded_parity(qlens, tlens, band, CK):
    qs, ts, qlen, tlen = _bucket(sum(qlens), qlens, tlens)
    assert _port(qs, ts, qlen, tlen, SP, band, CK=CK) == _oracle(qs, ts, qlen, tlen,
                                                                JSP, band)


def test_banded_mutated_copy():
    """Realistic long-read case: target = query with SNPs + indels."""
    rng = np.random.default_rng(0)
    n = 192
    q = rng.integers(0, 4, n).astype(np.int32)
    t = q.copy()
    idx = rng.choice(n, 16, replace=False)
    t[idx] = (t[idx] + 1 + rng.integers(0, 3, 16)) % 4
    t = np.delete(t, [50, 51, 52])
    t = np.insert(t, 120, [0, 1]).astype(np.int32)
    got = _port(q[None], t[None], np.array([n]), np.array([len(t)]), SP, 10, CK=48)
    assert got == [str(nw_affine(q, t, JSP, band=10))]
    assert "D" in got[0] and "I" in got[0]


def test_banded_score_only():
    qs, ts, qlen, tlen = _bucket(1, [48, 48], [52, 52])
    res = banded_align_batch(qs, ts, qlen, tlen, SP, 8, traceback=False, CK=32,
                             device="cpu")
    for b in range(2):
        ref = nw_affine(qs[b], ts[b], JSP, band=8)
        assert (res[b].score, res[b].cigar) == (ref.score, "")
    res = banded_align_batch(qs, ts, qlen, tlen, BLOSUM, 12, traceback=False,
                             device="cpu")
    assert res[0].score == nw_affine(qs[0], ts[0], JBLOSUM, band=12).score


def test_banded_matches_unbanded_when_wide():
    """banded(w >= max(n, m)) == the full matrix."""
    qs, ts, qlen, tlen = _bucket(2, [40], [44])
    res = banded_align_batch(qs, ts, qlen, tlen, SP, 64, CK=32, device="cpu")
    ref = nw_affine(qs[0], ts[0], JSP, band=None)
    assert (res[0].score, res[0].cigar) == (ref.score, ref.cigar)


@pytest.mark.parametrize("band,CK", [(63, 64), (64, 64), (7, 64)])
def test_banded_phase_boundary_geometries(band, CK):
    """dhi + 1 exactly on, just past, and well inside a chunk boundary
    (the JAX driver's clamp/dyn/steady split; the port has none, and must
    give the same results)."""
    qs, ts, qlen, tlen = _bucket(band, [150], [150])
    assert _port(qs, ts, qlen, tlen, SP, band, CK=CK) == _oracle(qs, ts, qlen, tlen,
                                                                JSP, band)


def test_many_super_blocks_equal_one(monkeypatch):
    """A traceback over super-blocks of one chunk each (the walker state
    carried from block to block) gives the single-block results."""
    qs, ts, qlen, tlen = _bucket(4, [90, 70, 81], [84, 77, 90])
    one = _port(qs, ts, qlen, tlen, SP, 10, CK=16)
    monkeypatch.setattr(port_banded, "SB_BYTES", 1)
    assert port_banded.super_block_chunks(16, 3, 128) == 1
    assert _port(qs, ts, qlen, tlen, SP, 10, CK=16) == one
    assert one == _oracle(qs, ts, qlen, tlen, JSP, 10)


def test_banded_rejects_wide_range_matrix():
    """Tables outside [-4, 11] take the full-matrix wavefront (kernel 7),
    as in the JAX package: ``banded_align_batch`` refuses them, and the
    dispatcher sends them through the length buckets to that route."""
    wide = np.full((4, 4), -20, np.int32)
    np.fill_diagonal(wide, 20)
    sp = scoring_params(0, 0, -5, -2, wide)
    jsp = JaxScoringParams(gap_open=-5, gap_extend=-2, matrix=wide)
    qs, ts, qlen, tlen = _bucket(5, [16], [16])
    with pytest.raises(NotImplementedError, match="kernel 7"):
        banded_align_batch(qs, ts, qlen, tlen, sp, 4, device="cpu")
    got = st.align_batch([qs[0]], [ts[0]], scoring=sp, mode="global", band=4,
                         device="cpu")
    jax = jax_align_batch([qs[0]], [ts[0]], scoring=jsp, mode="global", band=4,
                          backend="pallas")
    assert [str(r) for r in got] == [str(r) for r in jax] == _oracle(qs, ts, qlen, tlen,
                                                                      jsp, 4)


def test_banded_routes_through_align_batch(monkeypatch):
    """align_batch(band=, mode="global") groups pairs by quantized delta,
    runs the groups that share one slot window through one
    banded_align_batch and keeps input order."""
    calls = []
    orig = port_dispatch.banded_align_batch

    def spy(qs, *a, **k):
        calls.append(len(qs))
        return orig(qs, *a, **k)

    monkeypatch.setattr(port_dispatch, "banded_align_batch", spy)
    rng = np.random.default_rng(6)
    lens = [(200, 210), (60, 20), (70, 75), (0, 9), (100, 140)]
    qs = [rng.integers(0, 20, a).astype(np.uint8) for a, _ in lens]
    ts = [rng.integers(0, 20, b).astype(np.uint8) for _, b in lens]
    got = st.align_batch(qs, ts, scoring=BLOSUM, mode="global", band=32, device="cpu")
    want = [str(nw_affine(q.astype(np.int32), t.astype(np.int32), JBLOSUM, band=32))
            for q, t in zip(qs, ts)]
    assert [str(r) for r in got] == want
    # delta // 32: -2, 1, and 0 for three pairs; the joined bands [-72, 72]
    # keep the groups' slot window (Wp 128): one call
    assert calls == [5]
    oracle = st.align_batch(qs, ts, scoring=BLOSUM, mode="global", band=32,
                            backend="oracle", device="cpu")
    assert [str(r) for r in oracle] == want
