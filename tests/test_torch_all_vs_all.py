"""The port's ``align_all_vs_all`` (config 5) on the CPU against the JAX
``align_all_vs_all(backend="xla")`` and the oracle, its resume shards in
both directions between the packages, and the launch/finalize split of
the strip engine under it (``run_bucket(launch_only=True)``).

The JAX run compiles once per bucket pair: it is shared through a module
fixture, and its shards are the ones the port resumes."""

import numpy as np
import pytest
import torch

import seqalib_tpu as sa
import seqalib_tpu.api as sa_api
import seqalib_tpu.parallel.dispatch as sa_dispatch
import seqalib_tpu_torch as st
import seqalib_tpu_torch.api as st_api
import seqalib_tpu_torch.parallel.dispatch as st_dispatch
from seqalib_tpu import oracle_fast
from seqalib_tpu.oracle import sw_linear
from seqalib_tpu.types import ScoringParams
from seqalib_tpu_torch.scoring import scoring_params

SP = ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)
PSP = scoring_params(2, -3, 0, -2)
FIELDS = ("score", "qs", "qe", "ts", "te")
CHUNK = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(rng, n_reads=4, n_refs=3):
    # tests/test_all_vs_all.py's product: reads in two buckets, refs in two
    reads = [rng.integers(0, 4, int(rng.integers(20, 40))).astype(np.uint8)
             for _ in range(n_reads)]
    refs = [rng.integers(0, 4, int(rng.integers(40, 80))).astype(np.uint8)
            for _ in range(n_refs)]
    return reads, refs


@pytest.fixture(scope="module")
def product(tmp_path_factory):
    """The inputs, and the JAX result with the shards it wrote."""
    reads, refs = _mk(np.random.default_rng(0))
    d = str(tmp_path_factory.mktemp("jax_shards"))
    out = sa.align_all_vs_all(reads, refs, scoring=SP, backend="xla", chunk_pairs=CHUNK,
                              resume_dir=d)
    return reads, refs, out, d


def _raise(*a, **k):
    raise AssertionError("resume must not realign finished chunks")


def _same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_matches_jax_and_the_oracle(product):
    reads, refs, jax_out, _ = product
    got = st.align_all_vs_all(reads, refs, scoring=PSP, chunk_pairs=CHUNK, device="cpu")
    assert got["score"].shape == (4, 3) and got["score"].dtype == np.int32
    _same(got, jax_out)
    for i, q in enumerate(reads):
        for j, t in enumerate(refs):
            ref = sw_linear(q, t, SP)
            assert tuple(int(got[f][i, j]) for f in FIELDS) == (
                ref.score, ref.query_start, ref.query_end, ref.target_start,
                ref.target_end), (i, j)
    # one chunk per bucket pair: the JAX package pads its tail chunks to a
    # pinned shape, the port does not; the results are the same
    _same(st.align_all_vs_all(reads, refs, scoring=PSP, device="cpu"), jax_out)


def test_port_resumes_shards_written_by_jax(product, monkeypatch):
    reads, refs, jax_out, d = product
    monkeypatch.setattr(st_dispatch, "run_bucket", _raise)
    got = st.align_all_vs_all(reads, refs, scoring=PSP, chunk_pairs=CHUNK, resume_dir=d,
                              device="cpu")
    _same(got, jax_out)


def test_jax_resumes_shards_written_by_the_port(product, tmp_path, monkeypatch):
    reads, refs, jax_out, _ = product
    d = str(tmp_path / "port_shards")
    first = st.align_all_vs_all(reads, refs, scoring=PSP, chunk_pairs=CHUNK, resume_dir=d,
                                device="cpu")
    _same(first, jax_out)
    monkeypatch.setattr(sa_dispatch, "run_bucket", _raise)
    got = sa.align_all_vs_all(reads, refs, scoring=SP, backend="xla", chunk_pairs=CHUNK,
                              resume_dir=d)
    _same(got, jax_out)


def test_resume_does_not_realign(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    reads = [rng.integers(0, 4, 24).astype(np.uint8) for _ in range(5)]
    refs = [rng.integers(0, 4, 40).astype(np.uint8) for _ in range(3)]
    d = str(tmp_path / "shards")
    base = st.align_all_vs_all(reads, refs, scoring=PSP, chunk_pairs=4, device="cpu")
    first = st.align_all_vs_all(reads, refs, scoring=PSP, chunk_pairs=4, resume_dir=d,
                                device="cpu")
    _same(first, base)
    assert len(list(tmp_path.joinpath("shards").glob("chunk_*.npz"))) == 4  # 15 pairs
    monkeypatch.setattr(st_dispatch, "run_bucket", _raise)
    _same(st.align_all_vs_all(reads, refs, scoring=PSP, chunk_pairs=4, resume_dir=d,
                              device="cpu"), base)


def test_stale_shards_are_recomputed_after_a_scoring_change(tmp_path, caplog):
    rng = np.random.default_rng(2)
    reads = [rng.integers(0, 4, 18).astype(np.uint8) for _ in range(3)]
    refs = [rng.integers(0, 4, 24).astype(np.uint8) for _ in range(2)]
    d = str(tmp_path / "shards")
    sp2 = scoring_params(9, -1, 0, -1)
    st.align_all_vs_all(reads, refs, scoring=PSP, chunk_pairs=2, resume_dir=d, device="cpu")
    with caplog.at_level("WARNING", logger="seqalib_tpu_torch.api"):
        got = st.align_all_vs_all(reads, refs, scoring=sp2, chunk_pairs=2, resume_dir=d,
                                  device="cpu")
    assert "stale" in caplog.text
    _same(got, st.align_all_vs_all(reads, refs, scoring=sp2, chunk_pairs=2, device="cpu"))


@pytest.mark.parametrize("sp", [SP, ScoringParams.blosum62()], ids=["dna", "blosum62"])
def test_shard_key_is_the_jax_packages(sp):
    rng = np.random.default_rng(3)
    alpha = 4 if sp.matrix is None else 20
    qs = [rng.integers(0, alpha, n).astype(np.uint8) for n in (5, 9)]
    rs = [rng.integers(0, alpha, n).astype(np.uint8) for n in (7, 3, 11)]
    psp = scoring_params(sp.match, sp.mismatch, sp.gap_open, sp.gap_extend, sp.matrix)
    for mode in ("local", "global"):
        assert st_api._avall_key(qs, rs, 8, psp, mode) == sa_api._avall_key(qs, rs, 8, sp,
                                                                             mode)


def test_all_vs_all_refuses_what_it_does_not_run():
    with pytest.raises(TypeError, match="make_pair_mesh"):
        st.align_all_vs_all(["ACGT"], ["AGT"], mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        st.align_all_vs_all(["ACGT"], ["AGT"], backend="oracle", device="cpu")


@pytest.mark.parametrize("mode,traceback", [("local", False), ("local", True),
                                            ("global", True)])
def test_launch_only_equals_the_eager_call(mode, traceback):
    rng = np.random.default_rng(4)
    q = rng.integers(0, 4, size=(5, 40)).astype(np.int32)
    t = rng.integers(0, 4, size=(5, 50)).astype(np.int32)
    qlen, tlen = np.array([40, 33, 0, 12, 39]), np.array([50, 41, 7, 0, 20])
    args = (q, t, qlen, tlen, PSP, mode, None, traceback, torch.device("cpu"))
    finish = st_dispatch.run_bucket(*args, launch_only=True)
    assert callable(finish)
    got, want = finish(), st_dispatch.run_bucket(*args)
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "cigars":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dispatch_launches_every_bucket_before_finalizing(monkeypatch):
    events = []
    real = st_dispatch.run_bucket

    def spy(q, *a, **k):
        assert k.get("launch_only") is True
        key = q.shape[1]
        events.append(("launch", key))
        finish = real(q, *a, **k)

        def traced():
            events.append(("finish", key))
            return finish()
        return traced

    monkeypatch.setattr(st_dispatch, "run_bucket", spy)
    rng = np.random.default_rng(5)
    lens = [(0, 5), (3, 0), (17, 300), (260, 40), (70, 90), (5, 140)]
    qs = [rng.integers(0, 4, size=a).astype(np.uint8) for a, _ in lens]
    ts = [rng.integers(0, 4, size=b).astype(np.uint8) for _, b in lens]
    res = st.align_batch(qs, ts, scoring=PSP, mode="local", device="cpu")
    kinds = [e[0] for e in events]
    assert kinds == ["launch"] * (len(kinds) // 2) + ["finish"] * (len(kinds) // 2)
    assert len(kinds) >= 8  # several buckets
    want = [str(oracle_fast.align_oracle(q, t, SP, mode="local")) for q, t in zip(qs, ts)]
    assert [str(r) for r in res] == want
