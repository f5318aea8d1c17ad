"""Port parity for banded sequence parallelism: ``align_score_banded_sp``
and ``align_banded_sp`` of ``seqalib_tpu_torch`` (plain fill and walk on
the CPU, meshes of 1, 2 and 8 ``"cpu"`` entries) against the JAX
``banded_nw_affine_score_sp`` / ``banded_nw_affine_align_sp`` on the
conftest-faked 8-device CPU mesh (Pallas in interpret mode), against the
banded oracle, and against the port's own single-device banded engine.
Exact equality of scores and of ``str(AlignResult)``.

The shapes are the non-slow ones of ``tests/test_banded_sp.py``: blocks
shorter and taller than the band, (n, m) mid-block and near a block edge,
blocks past the end of a pair, two relay groups, mixed deltas.  Each JAX
geometry compiles once in interpret mode (5-20 s), so the JAX reference
runs at the port's mesh of 8 on the cases marked for it (two score shapes,
one single-pair align, the matrix align, the batched align) and is shared
through module-level caches; every case is held to the oracle.
"""

import functools

import numpy as np
import pytest
import torch

import seqalib_tpu_torch as st
from seqalib_tpu.oracle_fast import nw_affine
from seqalib_tpu.parallel import banded_sp as jsp
from seqalib_tpu.types import ScoringParams as JaxScoringParams
from seqalib_tpu_torch.models.banded import banded_align_batch
from seqalib_tpu_torch.ops import launches
from seqalib_tpu_torch.parallel import banded_sp as psp
from seqalib_tpu_torch.scoring import scoring_params

JSP = JaxScoringParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-2)
MESHES = [1, 2, 8]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them fast when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psp(jsp_):
    return scoring_params(jsp_.match, jsp_.mismatch, jsp_.gap_open, jsp_.gap_extend,
                          jsp_.matrix)


def _mesh(D):
    return st.make_band_mesh(["cpu"] * D)


@functools.lru_cache(maxsize=None)
def _jax_mesh():
    return jsp.make_band_mesh()


def _pairs(seed, qlens, tlens, alpha=4):
    rng = np.random.default_rng(seed)
    return ([rng.integers(0, alpha, size=L).astype(np.int32) for L in qlens],
            [rng.integers(0, alpha, size=L).astype(np.int32) for L in tlens])


def _mutated_pair(seed, L, rate):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, size=L).astype(np.int32)
    t = q.copy()
    idx = rng.random(L) < rate
    t[idx] = (t[idx] + rng.integers(1, 4, int(idx.sum()))) % 4
    return q, t


# name -> (qlens, tlens, band, JAX reference at the mesh of 8)
SCORE_CASES = {
    "257x251_b16": ([257], [251], 16, True),  # R = 33 < Dband: short blocks
    "1000x970_b24": ([1000], [970], 24, False),  # R > Dband, (n, m) mid-block
    "512x600_b32": ([512], [600], 32, False),  # asymmetric band
    "batch3_b20": ([300, 280, 311], [300, 301, 280], 20, False),  # mixed deltas
    "groups2_9x64_b8": ([64] * 9, [64] * 9, 8, True),  # two relay groups
}


@functools.lru_cache(maxsize=None)
def _score_case(name):
    qlens, tlens, band, with_jax = SCORE_CASES[name]
    qs, ts = _pairs(len(name), qlens, tlens)
    oracle = [nw_affine(q, t, JSP, band=band).score for q, t in zip(qs, ts)]
    jax = jsp.banded_nw_affine_score_sp(qs, ts, JSP, band, _jax_mesh(), CK=64) \
        if with_jax else None
    return qs, ts, band, oracle, jax


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("name", sorted(SCORE_CASES))
def test_score_matches_jax_and_oracle(name, D):
    qs, ts, band, oracle, jax = _score_case(name)
    before = dict(launches)
    got = st.align_score_banded_sp(qs, ts, _psp(JSP), band, _mesh(D), CK=64)
    assert launches == before  # the CPU path runs the plain versions
    assert got == oracle
    if jax is not None:
        assert got == jax


@pytest.mark.parametrize("D", MESHES)
def test_single_pair_form(D):
    (q,), (t,) = _pairs(5, [400], [390])
    got = st.align_score_banded_sp(q, t, _psp(JSP), 16, _mesh(D), CK=64)
    assert isinstance(got, int)
    assert got == nw_affine(q, t, JSP, band=16).score


@pytest.mark.parametrize("D", MESHES)
def test_empty_and_tiny(D):
    rng = np.random.default_rng(6)
    qs = [np.zeros(0, np.int32), rng.integers(0, 4, 3).astype(np.int32)]
    ts = [rng.integers(0, 4, 5).astype(np.int32), np.zeros(0, np.int32)]
    got = st.align_score_banded_sp(qs, ts, _psp(JSP), 8, _mesh(D), CK=64)
    assert got == [nw_affine(q, t, JSP, band=8).score for q, t in zip(qs, ts)]


_MUT_Q, _MUT_T = _mutated_pair(11, 3000, 0.08)  # a long-read shape: 3 kb, 8% subs
# name -> (q, t, band, CK, JAX reference at the mesh of 8)
ALIGN_CASES = {
    "257x251_b16": (*_pairs(257 * 13 + 251, [257], [251]), 16, 64, True),
    "1000x970_b24": (*_pairs(1000 * 13 + 970, [1000], [970]), 24, 64, False),
    "512x600_b32": (*_pairs(512 * 13 + 600, [512], [600]), 32, 64, False),
    "mutated_3kb_b32": ([_MUT_Q], [_MUT_T], 32, 128, False),
}


@functools.lru_cache(maxsize=None)
def _align_case(name):
    (q,), (t,), band, CK, with_jax = ALIGN_CASES[name]
    oracle = str(nw_affine(q, t, JSP, band=band))
    jax = str(jsp.banded_nw_affine_align_sp(q, t, JSP, band, _jax_mesh(), CK=CK)) \
        if with_jax else None
    return q, t, band, CK, oracle, jax


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("name", sorted(ALIGN_CASES))
def test_align_matches_jax_and_oracle(name, D):
    q, t, band, CK, oracle, jax = _align_case(name)
    got = st.align_banded_sp(q, t, _psp(JSP), band, _mesh(D), CK=CK)
    assert str(got) == oracle
    if jax is not None:
        assert str(got) == jax


def test_align_empty():
    got = st.align_banded_sp(np.zeros(0, np.int32), np.arange(4, dtype=np.int32) % 4,
                             _psp(JSP), 8, _mesh(8))
    assert (got.score, got.cigar) == (JSP.gap_open + 4 * JSP.gap_extend, "4D")


@functools.lru_cache(maxsize=None)
def _matrix_case():
    rng = np.random.default_rng(29)
    mat = rng.integers(-4, 6, size=(8, 8)).astype(np.int32)
    np.fill_diagonal(mat, rng.integers(4, 11, size=8))
    jspm = JaxScoringParams(gap_open=-6, gap_extend=-1, matrix=mat)
    q = rng.integers(0, 8, 300).astype(np.int32)
    t = rng.integers(0, 8, 280).astype(np.int32)
    jax = str(jsp.banded_nw_affine_align_sp(q, t, jspm, 24, _jax_mesh(), CK=64))
    return q, t, jspm, nw_affine(q, t, jspm, band=24), jax


@pytest.mark.parametrize("D", MESHES)
def test_matrix_scoring(D):
    """An 8 x 8 substitution matrix (the JAX package's packed-nibble
    profile route; the port looks it up in a table)."""
    q, t, jspm, ref, jax = _matrix_case()
    assert st.align_score_banded_sp(q, t, _psp(jspm), 24, _mesh(D), CK=64) == ref.score
    got = str(st.align_banded_sp(q, t, _psp(jspm), 24, _mesh(D), CK=64))
    assert got == str(ref)
    assert got == jax


def test_wide_matrix_raises():
    mat = np.full((4, 4), -30, np.int32)
    np.fill_diagonal(mat, 50)
    spm = scoring_params(0, 0, -6, -1, mat)
    z = np.zeros(16, np.int32)
    with pytest.raises(NotImplementedError):
        st.align_score_banded_sp(z, z, spm, 4, _mesh(2))
    with pytest.raises(NotImplementedError):
        st.align_banded_sp(z, z, spm, 4, _mesh(2))


@pytest.mark.parametrize("D", MESHES)
def test_cross_engine_mixed_batch(D):
    """The relay equals the port's single-device banded engine on a batch
    of mixed lengths and deltas."""
    qlens = [200, 450, 133, 390, 512]
    tlens = [230, 440, 150, 360, 500]
    qs, ts = _pairs(31, qlens, tlens)
    got = st.align_score_banded_sp(qs, ts, _psp(JSP), 40, _mesh(D), CK=64)
    W = max(qlens + tlens)
    qm = np.zeros((5, W), np.int32)
    tm = np.zeros((5, W), np.int32)
    for b in range(5):
        qm[b, : qlens[b]] = qs[b]
        tm[b, : tlens[b]] = ts[b]
    ref = banded_align_batch(qm, tm, np.array(qlens), np.array(tlens), _psp(JSP), 40,
                             traceback=False, device="cpu")
    assert got == [r.score for r in ref]


BATCH_QLENS = [257, 190, 301, 0, 244, 257, 130, 222, 260, 180]  # > GB pairs
BATCH_TLENS = [251, 200, 280, 5, 260, 257, 150, 199, 255, 190]


@functools.lru_cache(maxsize=None)
def _batched_align():
    qs, ts = _pairs(77, BATCH_QLENS, BATCH_TLENS)
    jax = [str(r) for r in jsp.banded_nw_affine_align_sp(qs, ts, JSP, 24, _jax_mesh(),
                                                         CK=64)]
    return qs, ts, jax


@pytest.mark.parametrize("D", MESHES)
def test_align_batched(D):
    """Two relay groups of walkers, mixed lengths and deltas, an empty pair
    answered on the host."""
    assert len(BATCH_QLENS) == psp.GB + 2
    qs, ts, jax = _batched_align()
    got = st.align_banded_sp(qs, ts, _psp(JSP), 24, _mesh(D), CK=64)
    assert [str(r) for r in got] == jax
    for b, r in enumerate(got):
        if BATCH_QLENS[b] == 0:
            assert r.cigar == f"{BATCH_TLENS[b]}D"
        else:
            assert str(r) == str(nw_affine(qs[b], ts[b], JSP, band=24)), b


def test_pointer_cap_raises(monkeypatch):
    # one block's packed pointers: Kp * GB * Wp / 2 bytes, read at call time
    q, t = _pairs(3, [300], [300])
    monkeypatch.setenv("SEQALIB_SP_PTR_CAP", str(1024))
    with pytest.raises(RuntimeError, match="SEQALIB_SP_PTR_CAP"):
        st.align_banded_sp(q[0], t[0], _psp(JSP), 8, _mesh(2))
    monkeypatch.setenv("SEQALIB_SP_PTR_CAP", str(10**9))
    got = st.align_banded_sp(q[0], t[0], _psp(JSP), 8, _mesh(2))
    assert str(got) == str(nw_affine(q[0], t[0], JSP, band=8))


def test_handoff_invariant_is_checked(monkeypatch):
    """A walk that leaves a block elsewhere than its row 0 raises."""
    real = psp.band_walk

    def stop_early(ptr, i, j, st_, done, **kw):
        return real(ptr, i, j, st_, done, **dict(kw, i_floor=5))

    monkeypatch.setattr(psp, "band_walk", stop_early)
    q, t = _pairs(4, [200], [190])
    with pytest.raises(RuntimeError, match="handoff"):
        st.align_banded_sp(q[0], t[0], _psp(JSP), 8, _mesh(2))
