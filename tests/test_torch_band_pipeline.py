"""Port parity for the full-matrix sequence-parallel path:
``nw_affine_score_sp``, ``sw_affine_score_sp`` and ``nw_affine_align_sp``
of ``seqalib_tpu_torch`` (plain tile on the CPU, meshes of 1, 2 and 8
``"cpu"`` entries) against the JAX functions on the conftest-faked
8-device CPU mesh, with both tile bodies (``xla``, and ``pallas`` in
interpret mode where it applies), and against the oracle.  Exact equality
of scores and of ``str(AlignResult)``.  The shapes are those of
``tests/test_band_pipeline.py``.  A mesh of ``"cpu"`` entries names one
device, so the fill runs block by block; the per-step pipeline that
distinct devices take is forced on such meshes as well, and the walk's
pointer recompute is run with its byte budget cut to one tile a launch and
to a few.  The JAX results are computed once per case (``lru_cache``) and
shared by every mesh and variant of it.
"""

import functools

import numpy as np
import pytest
import torch

import seqalib_tpu_torch as st
from seqalib_tpu.oracle import nw_affine, sw_affine
from seqalib_tpu.parallel import band_pipeline as jbp
from seqalib_tpu.types import ScoringParams as JaxScoringParams
from seqalib_tpu_torch.ops import launches
from seqalib_tpu_torch.ops import sp_walk as sp_walk_mod
from seqalib_tpu_torch.parallel import band_pipeline as pbp
from seqalib_tpu_torch.scoring import scoring_params
from seqalib_tpu_torch.utils.cigar import rescore_global_affine

JSP = JaxScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
JBLOSUM = JaxScoringParams.blosum62()
JWIDE = JaxScoringParams(match=40, mismatch=-40, gap_open=-5, gap_extend=-2,
                         matrix=np.where(np.eye(4, dtype=bool), 40, -40).astype(np.int32))
MESHES = [1, 2, 8]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them fast when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psp(jsp):
    return scoring_params(jsp.match, jsp.mismatch, jsp.gap_open, jsp.gap_extend, jsp.matrix)


def _mesh(D):
    return st.make_band_mesh(["cpu"] * D)


@functools.lru_cache(maxsize=None)
def _jax_mesh():
    return jbp.make_band_mesh()


def _random_pair(n, m, seed, alpha=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, alpha, n).astype(np.int32),
            rng.integers(0, alpha, m).astype(np.int32))


def _mutated_copy(seed, gap_runs):
    rng = np.random.default_rng(seed)
    n = 384
    q = rng.integers(0, 4, n).astype(np.int32)
    t = q.copy()
    idx = rng.choice(n, 20, replace=False)
    t[idx] = (t[idx] + 1 + rng.integers(0, 3, 20)) % 4
    if gap_runs:  # a 12-column gap and a 9-row insertion cross tile edges
        t = np.delete(t, np.arange(100, 112))
        t = np.insert(t, 250, rng.integers(0, 4, 9))
    else:
        t = np.delete(t, [100, 101])
        t = np.insert(t, 250, [1, 2, 3])
    return q, t.astype(np.int32)


# name -> (q, t, jax scoring, C, JAX tile bodies to compare, sp_sub)
SCORE_CASES = {
    "300x280_C64": (*_random_pair(300, 280, 300280), JSP, 64, ("xla", "pallas"), None),
    "256x256_C32": (*_random_pair(256, 256, 256256), JSP, 32, ("xla",), None),
    "skewed_97x203_C50": (*_random_pair(97, 203, 97203), JSP, 50, ("xla", "pallas"), None),
    "few_rows_5x400": (*_random_pair(5, 400, 5400), JSP, 64, ("xla",), None),
    "m_below_C_40x7": (*_random_pair(40, 7, 40007), JSP, 16, ("xla",), None),
    "R_over_C_300x100_C8": (*_random_pair(300, 100, 300100), JSP, 8, ("xla",), None),
    "strips_2100x450_sub1": (*_random_pair(2100, 450, 2100457), JSP, 128, ("pallas",), 1),
    "sub2_520x260": (*_random_pair(520, 260, 520267), JSP, 64, ("pallas",), 2),
    "blosum62_150x190": (*_random_pair(150, 190, 5, 20), JBLOSUM, 48, ("xla",), None),
    "blosum62_270x210": (*_random_pair(270, 210, 9, 20), JBLOSUM, 64, ("pallas",), 1),
    "wide_table_130x110": (*_random_pair(130, 110, 13), JWIDE, 32, ("xla",), None),
    "mutated_copy": (*_mutated_copy(11, False), JSP, 96, ("xla",), None),
}


@functools.lru_cache(maxsize=None)
def _jax_score(name):
    q, t, jsp, C, bodies, sub = SCORE_CASES[name]
    scores = {b: jbp.nw_affine_score_sp(q, t, jsp, _jax_mesh(), C=C, backend=b,
                                        sp_sub=sub if b == "pallas" else None)
              for b in bodies}
    return scores, nw_affine(q, t, jsp).score


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("name", sorted(SCORE_CASES))
def test_score_sp_matches_jax_and_oracle(name, D):
    q, t, jsp, C, _, sub = SCORE_CASES[name]
    jax_scores, oracle = _jax_score(name)
    before = dict(launches)
    got = st.align_score_sp(q, t, _psp(jsp), _mesh(D), C=C, sp_sub=sub)
    assert launches == before  # the CPU path runs the plain tile
    assert set(jax_scores.values()) == {oracle}
    assert got == oracle


LOCAL_CASES = {
    "300x280_C64": (*_random_pair(300, 280, 300 * 7 + 280), 64),
    "skewed_97x203_C50": (*_random_pair(97, 203, 97 * 7 + 203), 50),
    "m_below_C_40x7": (*_random_pair(40, 7, 40 * 7 + 7), 16),
}


@functools.lru_cache(maxsize=None)
def _jax_local(name):
    q, t, C = LOCAL_CASES[name]
    return jbp.sw_affine_score_sp(q, t, JSP, _jax_mesh(), C=C), sw_affine(q, t, JSP).score


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("name", sorted(LOCAL_CASES))
def test_local_score_sp_matches_jax_and_oracle(name, D):
    q, t, C = LOCAL_CASES[name]
    jax_score, want = _jax_local(name)
    assert jax_score == want
    assert st.align_score_sp(q, t, _psp(JSP), _mesh(D), mode="local", C=C) == want


def test_local_empty_and_disjoint():
    sp = _psp(JSP)
    for D in MESHES:
        assert pbp.sw_affine_score_sp(np.zeros(0, np.int32), np.arange(3) % 4, sp,
                                      _mesh(D)) == 0
        # disjoint alphabets: the best local alignment is empty
        assert st.align_score_sp(np.zeros(40, np.int32), np.ones(35, np.int32), sp,
                                 _mesh(D), mode="local", C=16) == 0


ALIGN_CASES = {
    "400x520_C128": (*_random_pair(400, 520, 400520), JSP, 128, "xla", None),
    "333x290_C64": (*_random_pair(333, 290, 333290), JSP, 64, "xla", None),
    "small_97x203_C50": (*_random_pair(97, 203, 97203), JSP, 50, "xla", None),
    "few_rows_5x400": (*_random_pair(5, 400, 5400), JSP, 64, "xla", None),
    "m_below_C_40x7": (*_random_pair(40, 7, 40007), JSP, 16, "xla", None),
    "gap_runs": (*_mutated_copy(17, True), JSP, 96, "xla", None),
    "blosum62_200x240": (*_random_pair(200, 240, 29, 20), JBLOSUM, 64, "xla", None),
    "pallas_fill_260x245": (*_random_pair(260, 245, 17), JSP, 64, "pallas", 1),
}


@functools.lru_cache(maxsize=None)
def _jax_align(name):
    q, t, jsp, C, body, sub = ALIGN_CASES[name]
    got = jbp.nw_affine_align_sp(q, t, jsp, _jax_mesh(), C=C, backend=body, sp_sub=sub)
    return str(got), str(nw_affine(q, t, jsp))


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("name", sorted(ALIGN_CASES))
def test_align_sp_matches_jax_and_oracle(name, D):
    q, t, jsp, C, _, sub = ALIGN_CASES[name]
    jax_str, oracle = _jax_align(name)
    got = st.align_sp(q, t, _psp(jsp), _mesh(D), C=C, sp_sub=sub)
    assert jax_str == oracle
    assert str(got) == oracle


def test_degenerate_pairs():
    sp = _psp(JSP)
    mesh = _mesh(8)
    assert st.align_score_sp([], [], sp, mesh) == 0
    assert st.align_score_sp([1, 2], [], sp, mesh) == sp.gap_open + 2 * sp.gap_extend
    got = st.align_sp([1, 2], [], sp, mesh)
    assert (got.score, got.cigar) == (sp.gap_open + 2 * sp.gap_extend, "2I")
    got = st.align_sp([], [3], sp, mesh)
    assert (got.score, got.cigar) == (sp.gap_open + sp.gap_extend, "1D")
    # a 1 x 1 matrix-scoring pair
    one = st.align_score_sp([1], [1], _psp(JBLOSUM), mesh)
    assert one == nw_affine(np.array([1]), np.array([1]), JBLOSUM).score


def test_make_band_mesh():
    assert _mesh(3) == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="at least one"):
        st.make_band_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            st.make_band_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            st.make_band_mesh(["cuda:0"])
    with pytest.raises(ValueError, match="global"):
        st.align_score_sp([1], [1], _psp(JSP), _mesh(1), mode="semi")


def test_rescore_rejects_a_cigar_that_does_not_consume():
    with pytest.raises(RuntimeError, match="consume"):
        rescore_global_affine(np.zeros(3), np.zeros(3), [0, 0], _psp(JSP))


@pytest.mark.parametrize("D", [2, 8])
@pytest.mark.parametrize("name", ["300x280_C64", "blosum62_150x190"])
def test_per_step_pipeline_matches_jax_and_oracle(name, D, monkeypatch):
    """The pipeline of distinct devices (one tile a launch per block and
    step, packets handed down) on meshes of one device."""
    monkeypatch.setattr(pbp, "one_device", lambda mesh: False)
    q, t, jsp, C, _, sub = SCORE_CASES[name]
    _, oracle = _jax_score(name)
    assert st.align_score_sp(q, t, _psp(jsp), _mesh(D), C=C, sp_sub=sub) == oracle
    if name in LOCAL_CASES:
        q, t, C = LOCAL_CASES[name]
        want = _jax_local(name)[1]
    else:
        want = sw_affine(q, t, JSP).score
    assert st.align_score_sp(q, t, _psp(JSP), _mesh(D), mode="local", C=C) == want


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("name", ["400x520_C128", "gap_runs"])
def test_per_step_pipeline_align_matches_jax_and_oracle(name, D, monkeypatch):
    monkeypatch.setattr(pbp, "one_device", lambda mesh: False)
    q, t, jsp, C, _, sub = ALIGN_CASES[name]
    jax_str, oracle = _jax_align(name)
    assert str(st.align_sp(q, t, _psp(jsp), _mesh(D), C=C, sp_sub=sub)) == oracle == jax_str


def _count_ptr_batches(monkeypatch):
    """Record the tiles of every pointer recompute ``align_sp`` makes, and
    every walk through one: (start, end, block top, left edge)."""
    calls, walks = [], []
    real, real_walk = pbp.sp_tile_ptr, pbp.sp_walk

    def counted(qb, tk, htop, *args, **kw):
        calls.append(htop.shape[0])
        return real(qb, tk, htop, *args, **kw)

    def walked(P, i, j, state, *, i0, j0):
        out = real_walk(P, i, j, state, i0=i0, j0=j0)
        end = sp_walk_mod.read_walk(out.numpy())[:2]
        walks.append(((i, j), end, i0, j0 - (P.shape[0] - 1) * P.shape[1]))
        return out

    monkeypatch.setattr(pbp, "sp_tile_ptr", counted)
    monkeypatch.setattr(pbp, "sp_walk", walked)
    return calls, walks


@pytest.mark.parametrize("fill", ["block_by_block", "per_step"])
@pytest.mark.parametrize("D", [1, 2, 8])
@pytest.mark.parametrize("name", ["400x520_C128", "blosum62_200x240", "gap_runs",
                                  "m_below_C_40x7"])
def test_pointer_batches_give_the_same_alignment(name, D, fill, monkeypatch):
    """The walk's recompute with a budget of one tile a launch (K = 1) and
    the default (K > 1): the same result, and batches make fewer launches
    than tiles walked.  Each batch is walked once (``sp_walk``, its plain
    version here), from where the last walk ended, until the path leaves it
    at the block top or the batch's left edge.  Both fills build the
    boundary record the batches are cut from: block by block (one device)
    and the per-step pipeline of distinct devices (forced)."""
    if fill == "per_step":
        monkeypatch.setattr(pbp, "one_device", lambda mesh: False)
    q, t, jsp, C, _, sub = ALIGN_CASES[name]
    jax_str, oracle = _jax_align(name)
    calls, walks = _count_ptr_batches(monkeypatch)
    per_launch = {}
    for budget in (1, pbp.PTR_BATCH_BYTES):
        monkeypatch.setattr(pbp, "PTR_BATCH_BYTES", budget)
        calls.clear()
        walks.clear()
        assert str(st.align_sp(q, t, _psp(jsp), _mesh(D), C=C, sp_sub=sub)) == oracle
        per_launch[budget] = list(calls)
        assert len(walks) == len(calls)
        starts, ends = [w[0] for w in walks], [w[1] for w in walks]
        assert starts == [(len(q), len(t))] + ends[:-1] and 0 in ends[-1]
        assert all(end[0] == i0 or end[1] == lo for _, end, i0, lo in walks)
    walked = len(per_launch[1])  # one launch per tile the walk entered
    assert set(per_launch[1]) == {1}
    assert jax_str == oracle
    if D < 8 and min(len(q), len(t)) > C:  # a block the walk crosses several tiles of
        assert max(per_launch[pbp.PTR_BATCH_BYTES]) >= 2
        assert len(per_launch[pbp.PTR_BATCH_BYTES]) < walked


def test_a_pointer_byte_with_no_move_raises_as_the_host_walk_did(monkeypatch):
    """A recompute that gave a tile with no move in state H (a zeroed tile)
    stops the walk with the error the host walk raised."""
    real = pbp.sp_tile_ptr

    def zeroed(*args, **kw):
        out = real(*args, **kw)
        out["ptr"].zero_()
        return out

    monkeypatch.setattr(pbp, "sp_tile_ptr", zeroed)
    q, t, jsp, C, _, sub = ALIGN_CASES["333x290_C64"]
    with pytest.raises(RuntimeError, match=r"SP walk: no move at \(333, 290\)"):
        st.align_sp(q, t, _psp(jsp), _mesh(2), C=C, sp_sub=sub)


def test_fault_7_sp_scores_below_the_jax_sentinel_follow_the_oracle():
    """Fault 7 (ROADMAP Queue 3): the JAX package's full-matrix SP path
    starts its capture and its E/F boundaries at -2^28, so a global score
    below that comes back as -2^28 and its walk's re-score check raises.
    The port's sentinel is -2^30: both SP entry points give the oracle's
    result.  100 x letter 0 against 90 x letter 1, DNA 2/-3, o=-5, e=-2
    times 2^20, global, on meshes of 2."""
    import jax

    q, t = np.zeros(100, np.int32), np.ones(90, np.int32)
    s = 1 << 20
    jsp = JaxScoringParams(match=2 * s, mismatch=-3 * s, gap_open=-5 * s, gap_extend=-2 * s)
    want = nw_affine(q, t, jsp)
    assert str(want) == "score=-309329920 q[0:100] t[0:90] 10I90M"
    jmesh = jbp.make_band_mesh(jax.devices()[:2])
    assert jbp.nw_affine_score_sp(q, t, jsp, jmesh, C=128) == -(1 << 28) == -268435456
    with pytest.raises(RuntimeError, match="rescore -309329920 != fill score -268435456"):
        jbp.nw_affine_align_sp(q, t, jsp, jmesh, C=128)
    for D in (1, 2):
        assert st.align_score_sp(q, t, _psp(jsp), _mesh(D), C=128) == want.score
        assert str(st.align_sp(q, t, _psp(jsp), _mesh(D), C=128)) == str(want)
