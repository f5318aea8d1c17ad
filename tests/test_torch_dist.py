"""The port's pair-stream distribution layer (``parallel/dist.py``) on the
CPU: ``align_batch`` and ``align_all_vs_all`` with ``mesh=`` against
``mesh=None``, the oracle and, on one shared shape, the JAX package's
sharded ``align_batch`` on the conftest's faked 8-device CPU mesh; the
banded and wide-table routes under a mesh; ``backend="xla"`` under a mesh
(the full-matrix wavefront sharded, banded or not, as in the JAX
package) against ``mesh=None`` and the JAX package's sharded ``"xla"``
run; an escalation inside a shard; resume shards across mesh sizes and
packages; the backend names; and the route a multi-process world
refuses.

The JAX run compiles once per mode (interpret mode): it is shared through
a module fixture."""

import numpy as np
import pytest
import torch

import seqalib_tpu as sa
import seqalib_tpu.parallel.dispatch as sa_dispatch
import seqalib_tpu_torch as st
import seqalib_tpu_torch.parallel.dispatch as st_dispatch
from seqalib_tpu.oracle import align_oracle as jax_oracle
from seqalib_tpu.types import ScoringParams
from seqalib_tpu_torch.oracle_fast import align_oracle
from seqalib_tpu_torch.parallel import dist
from seqalib_tpu_torch.scoring import scoring_params

DNA = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
PDNA = scoring_params(2, -3, -5, -2)
PBLOSUM = scoring_params(0, 0, -10, -1, sa.BLOSUM62)
FIELDS = ("score", "qs", "qe", "ts", "te")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(seed, B, lo, hi, alpha=4):
    rng = np.random.default_rng(seed)
    qs = [rng.integers(0, alpha, int(rng.integers(lo, hi + 1))).astype(np.uint8)
          for _ in range(B)]
    ts = [rng.integers(0, alpha, int(rng.integers(lo, hi + 1))).astype(np.uint8)
          for _ in range(B)]
    return qs, ts


def _strs(res):
    return [str(r) for r in res]


@pytest.fixture(scope="module")
def shared():
    """One shape for both packages: 17 DNA pairs of 17-32 letters (one
    bucket), and the JAX package's sharded results on its 8-device mesh."""
    from seqalib_tpu.parallel.dist import make_pair_mesh as jax_pair_mesh

    qs, ts = _pairs(11, 17, 17, 32)
    jmesh = jax_pair_mesh()
    assert jmesh.devices.size == 8
    want = {mode: _strs(sa.align_batch(qs, ts, scoring=DNA, mode=mode, backend="pallas",
                                       mesh=jmesh))
            for mode in ("local", "global")}
    return qs, ts, want


@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_sharded_equals_unsharded_and_the_oracle(k, mode):
    mesh = st.make_pair_mesh(["cpu"] * k)
    assert mesh == (torch.device("cpu"),) * k
    sp = PBLOSUM if k == 3 else PDNA
    for B in sorted({1, k - 1, k + 1, 2 * k + 1}):
        qs, ts = _pairs(100 * k + B, B, 5, 60, alpha=20 if k == 3 else 4)
        got = _strs(st.align_batch(qs, ts, scoring=sp, mode=mode, mesh=mesh))
        assert len(got) == B
        assert got == _strs(st.align_batch(qs, ts, scoring=sp, mode=mode, device="cpu")), B
        assert got == [str(align_oracle(q, t, sp, mode=mode)) for q, t in zip(qs, ts)], B
        if k == 8:  # and the JAX package's oracle
            assert got == [str(jax_oracle(q, t, DNA, mode=mode)) for q, t in zip(qs, ts)]


@pytest.mark.parametrize("mode", ["local", "global"])
def test_sharded_equals_the_jax_packages_sharded_run(shared, mode):
    qs, ts, want = shared
    for k in (8, 3):
        got = st.align_batch(qs, ts, scoring=PDNA, mode=mode, backend="pallas",
                             mesh=["cpu"] * k)
        assert _strs(got) == want[mode], k


def test_backend_names_run_the_strip_route():
    """Every device backend's name gives the strip route's results, through
    ``align_batch`` and ``align``; an unknown name raises."""
    qs, ts = _pairs(5, 6, 10, 40)
    want = _strs(st.align_batch(qs, ts, scoring=PDNA, mode="local", device="cpu"))
    for name in ("pallas", "xla"):
        got = st.align_batch(qs, ts, scoring=PDNA, mode="local", backend=name, device="cpu")
        assert _strs(got) == want, name
        assert str(st.align(qs[0], ts[0], scoring=PDNA, mode="local", backend=name,
                            device="cpu")) == want[0]
    with pytest.raises(ValueError, match="backend"):
        st.align_batch(qs, ts, backend="tpu", device="cpu")


def test_strip_sharded_launches_every_shard_before_finalizing(monkeypatch):
    import seqalib_tpu_torch.ops.strip as strip

    events = []
    real = strip.strip_launch

    def spy(q, t, qlen, tlen, tables, **kw):
        events.append(("launch", len(qlen), tables.table.device))
        finish = real(q, t, qlen, tlen, tables, **kw)

        def traced():
            events.append(("finish", len(qlen)))
            return finish()
        return traced

    monkeypatch.setattr(dist, "strip_launch", spy)
    qs, ts = _pairs(6, 7, 10, 40)
    q = st_dispatch._pad_stack(qs, 64)
    t = st_dispatch._pad_stack(ts, 64)
    qlen = np.array([len(x) for x in qs])
    tlen = np.array([len(x) for x in ts])
    mesh = st.make_pair_mesh(["cpu"] * 3)
    fin = dist.strip_sharded(mesh, q, t, qlen, tlen, PDNA, mode="local", want_tb=True,
                             launch_only=True)
    assert [e[:2] for e in events] == [("launch", 3), ("launch", 2), ("launch", 2)]
    assert all(e[2] == torch.device("cpu") for e in events)
    out = fin()
    assert [e[0] for e in events[3:]] == ["finish"] * 3
    assert sorted(out) == sorted(FIELDS + ("cigars",))
    want = [align_oracle(a, b, PDNA, mode="local") for a, b in zip(qs, ts)]
    assert [int(s) for s in out["score"]] == [w.score for w in want]
    assert out["cigars"] == [w.cigar for w in want]
    # more shards than pairs: the empty ones are skipped
    events.clear()
    one = dist.strip_sharded(st.make_pair_mesh(["cpu"] * 4), q[:2], t[:2], qlen[:2], tlen[:2], PDNA,
                             mode="global", want_tb=False)
    assert [e[:2] for e in events if e[0] == "launch"] == [("launch", 1), ("launch", 1)]
    assert sorted(one) == sorted(FIELDS)


# backend="xla" under a mesh: (mode, scoring, band) cases, on the shared
# module shape (17 DNA or protein pairs of 17-32 letters, one bucket)
WIDE = ScoringParams(gap_open=-20, gap_extend=-2, matrix=2 * sa.BLOSUM62)
XLA_CASES = {
    "local_affine": ("local", DNA, None),
    "local_linear": ("local", ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2),
                     None),
    "global_affine": ("global", DNA, None),
    "global_linear": ("global", ScoringParams.linear(), None),
    "global_band_scalar": ("global", DNA, 6),
    "global_band_wide": ("global", WIDE, 6),
}


def _xla_pairs(jsp):
    alpha = 20 if jsp.matrix is not None and jsp.matrix.shape[0] >= 20 else 4
    return _pairs(13, 17, 17, 32, alpha=alpha)


@pytest.fixture(scope="module")
def shared_xla():
    """The JAX package's ``align_batch(backend="xla")`` on its 8-device mesh
    for each case of ``XLA_CASES`` (one compile per case)."""
    from seqalib_tpu.parallel.dist import make_pair_mesh as jax_pair_mesh

    jmesh = jax_pair_mesh()
    out = {}
    for name, (mode, jsp, band) in XLA_CASES.items():
        qs, ts = _xla_pairs(jsp)
        out[name] = _strs(sa.align_batch(qs, ts, scoring=jsp, mode=mode, band=band,
                                         backend="xla", mesh=jmesh))
    return out


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("case", sorted(XLA_CASES))
def test_xla_backend_under_a_mesh_equals_unsharded_and_jax(shared_xla, case, k):
    mode, jsp, band = XLA_CASES[case]
    qs, ts = _xla_pairs(jsp)
    sp = scoring_params(jsp.match, jsp.mismatch, jsp.gap_open, jsp.gap_extend, jsp.matrix)
    kw = dict(scoring=sp, mode=mode, band=band, backend="xla")
    got = _strs(st.align_batch(qs, ts, mesh=["cpu"] * k, **kw))
    assert got == _strs(st.align_batch(qs, ts, device="cpu", **kw))
    assert got == shared_xla[case]
    if k == 3:
        assert got == [str(align_oracle(q, t, sp, mode=mode, band=band))
                       for q, t in zip(qs, ts)]


def test_xla_sharded_launches_every_shard_before_finalizing(monkeypatch):
    """``backend="xla"`` under a mesh runs ``xla_launch`` on each shard, all
    of them before any is finalized, in local mode too (pass (a) enqueued
    at the launch, passes (b) and (c) in the finalizes); a band with a DNA
    table included, which never reaches the banded route."""
    events = []
    real = dist.xla_launch

    def spy(q, t, qlen, tlen, sp, **kw):
        events.append(("launch", len(qlen), kw["device"], kw["mode"]))
        finish = real(q, t, qlen, tlen, sp, **kw)

        def traced():
            events.append(("finish", len(qlen)))
            return finish()
        return traced

    def refuse(*a, **k):
        raise AssertionError("an xla bucket reached the banded route")

    monkeypatch.setattr(dist, "xla_launch", spy)
    monkeypatch.setattr(st_dispatch, "dispatch_banded", refuse)
    qs, ts = _pairs(6, 7, 33, 60)  # one (64, 64) bucket
    mesh = st.make_pair_mesh(["cpu"] * 3)
    for mode, band in (("local", None), ("global", None), ("global", 5)):
        events.clear()
        got = st.align_batch(qs, ts, scoring=PDNA, mode=mode, band=band, backend="xla",
                             mesh=mesh)
        assert [e[:2] for e in events] == [("launch", 3), ("launch", 2), ("launch", 2),
                                           ("finish", 3), ("finish", 2), ("finish", 2)]
        assert all(e[2] == torch.device("cpu") and e[3] == mode for e in events[:3])
        assert _strs(got) == [str(align_oracle(q, t, PDNA, mode=mode, band=band))
                              for q, t in zip(qs, ts)]
    q = st_dispatch._pad_stack(qs, 64)
    t = st_dispatch._pad_stack(ts, 64)
    qlen = np.array([len(x) for x in qs])
    tlen = np.array([len(x) for x in ts])
    events.clear()
    fin = dist.wavefront_sharded(mesh, q, t, qlen, tlen, PDNA, mode="local", band=None,
                                 want_tb=False, launch_only=True)
    assert [e[0] for e in events] == ["launch"] * 3
    out = fin()
    assert [e[0] for e in events[3:]] == ["finish"] * 3
    assert sorted(out) == sorted(FIELDS)


def test_shard_bounds_and_gather_in_one_process():
    for B in range(0, 30):
        for n in range(1, 10):
            b = dist.shard_bounds(B, n)
            sizes = [hi - lo for lo, hi in b]
            assert len(b) == n and sum(sizes) == B and max(sizes) - min(sizes) <= 1
            assert all(b[i][1] == b[i + 1][0] for i in range(n - 1))
    out = {"score": np.arange(3)}
    assert dist.world() == (0, 1)
    assert dist.gather_to_host(out) is out
    assert dist.broadcast_host(out["score"]) is out["score"]


def test_escalation_inside_a_shard():
    """Alignments taller than a 128-row pass-2 window escalate inside their
    shard's finalize, through the sync call and through launch_only."""
    rng = np.random.default_rng(5)
    sp = scoring_params(2, -3, -4, -1)
    n = 200
    base = rng.integers(0, 4, n).astype(np.int32)
    q = np.stack([base] * 3)
    t = q.copy()
    t[1, 50] = (t[1, 50] + 1) % 4
    qlen = np.full(3, n)
    mesh = st.make_pair_mesh(["cpu"] * 2)
    kw = dict(mode="local", want_tb=True, WR=128)
    out = dist.strip_sharded(mesh, q, t, qlen, qlen, sp, **kw)
    out2 = dist.strip_sharded(mesh, q, t, qlen, qlen, sp, launch_only=True, **kw)()
    for b in range(3):
        ref = align_oracle(q[b].astype(np.uint8), t[b].astype(np.uint8), sp, mode="local")
        for o in (out, out2):
            got = (int(o["score"][b]), int(o["qs"][b]), int(o["qe"][b]), int(o["ts"][b]),
                   int(o["te"][b]), o["cigars"][b])
            assert got == (ref.score, ref.query_start, ref.query_end, ref.target_start,
                           ref.target_end, ref.cigar), b
        assert out["qe"][b] - out["qs"][b] > 128  # the escalation was taken


def _long_pairs(seed, B):
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for n in rng.integers(40, 90, size=B):
        q = rng.integers(0, 4, int(n)).astype(np.uint8)
        t = q.copy()
        k = max(1, int(n) // 10)
        idx = rng.choice(int(n), k, replace=False)
        t[idx] = (t[idx] + 1 + rng.integers(0, 3, k)) % 4
        qs.append(q)
        ts.append(t)
    return qs, ts


def test_banded_route_splits_groups_over_the_mesh(monkeypatch):
    qs, ts = _long_pairs(7, 9)
    want = _strs(st.align_batch(qs, ts, scoring=PDNA, mode="global", band=16, device="cpu"))
    assert want == [str(align_oracle(q, t, PDNA, mode="global", band=16))
                    for q, t in zip(qs, ts)]
    calls = []
    real = st_dispatch.banded_align_batch

    def spy(qb, *a, **k):
        calls.append((len(qb), k["device"]))
        return real(qb, *a, **k)

    monkeypatch.setattr(st_dispatch, "banded_align_batch", spy)
    got = st.align_batch(qs, ts, scoring=PDNA, mode="global", band=16, mesh=["cpu"] * 3)
    assert _strs(got) == want
    groups = {}
    for q, t in zip(qs, ts):
        groups[(len(t) - len(q)) // 16] = groups.get((len(t) - len(q)) // 16, 0) + 1
    # each group of g pairs in min(3, g) parts of ceil(g / min(3, g)) pairs
    parts = sum(-(-g // -(-g // min(3, g))) for g in groups.values())
    assert len(calls) == parts and sum(c[0] for c in calls) == len(qs)


def test_wide_table_route_under_a_mesh():
    wide = scoring_params(0, 0, -20, -2, 2 * sa.BLOSUM62)
    qs, ts = _pairs(8, 5, 20, 50, alpha=20)
    want = st.align_batch(qs, ts, scoring=wide, mode="global", band=8, device="cpu")
    got = st.align_batch(qs, ts, scoring=wide, mode="global", band=8, mesh=["cpu"] * 3)
    assert _strs(got) == _strs(want)
    assert _strs(want) == [str(align_oracle(q, t, wide, mode="global", band=8))
                           for q, t in zip(qs, ts)]
    got = st.align_batch(qs, ts, scoring=wide, mode="global", band=8, traceback=False,
                         mesh=["cpu"] * 2)
    assert [r.score for r in got] == [r.score for r in want]


def test_multiprocess_world_refuses_the_banded_and_wide_routes(monkeypatch):
    """Under a world of 2 the banded route refuses; the wide-table route
    no longer does: it runs this rank's shards and hands them to the
    gather (a two-process run in ``test_torch_multihost.py`` checks the
    gathered batch)."""
    monkeypatch.setattr(dist, "world", lambda: (0, 2))
    qs, ts = _long_pairs(9, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        st.align_batch(qs, ts, scoring=PDNA, mode="global", band=16, mesh=["cpu"] * 2)
    wide = scoring_params(0, 0, -20, -2, 2 * sa.BLOSUM62)
    wq, wt = _pairs(8, 4, 20, 50, alpha=20)
    q, t = st_dispatch._pad_stack(wq, 64), st_dispatch._pad_stack(wt, 64)
    qlen, tlen = np.array([len(x) for x in wq]), np.array([len(x) for x in wt])
    gathered = []
    monkeypatch.setattr(dist, "gather_to_host", lambda out: gathered.append(out) or out)
    got = dist.wavefront_sharded(dist.make_pair_mesh(["cpu"] * 2), q, t, qlen, tlen, wide,
                                 band=8, want_tb=True)
    # rank 0 of 2 with a mesh of 2: shards 0 and 1 of 4, the first 2 pairs
    want = st.align_batch(wq[:2], wt[:2], scoring=wide, mode="global", band=8, device="cpu")
    assert len(gathered) == 1
    assert [f"score={got['score'][b]} q[{got['qs'][b]}:{got['qe'][b]}] "
            f"t[{got['ts'][b]}:{got['te'][b]}] {got['cigars'][b]}"
            for b in range(len(got["score"]))] == _strs(want)
    # without a mesh nothing is distributed, and nothing refuses
    st.align_batch(qs, ts, scoring=PDNA, mode="global", band=16, device="cpu")


def test_multiprocess_world_runs_xla_with_a_band(monkeypatch):
    """Under a world of 2, ``backend="xla"`` with a band and a DNA table
    runs this rank's shards of the full-matrix wavefront and hands them to
    the gather, where the banded route (``"strip"``, ``"pallas"``) raises; a
    local ``"xla"`` bucket does the same."""
    monkeypatch.setattr(dist, "world", lambda: (0, 2))
    qs, ts = _long_pairs(9, 4)
    for backend in ("strip", "pallas"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            st.align_batch(qs, ts, scoring=PDNA, mode="global", band=16, backend=backend,
                           mesh=["cpu"] * 2)
    gathered = []
    monkeypatch.setattr(dist, "gather_to_host", lambda out: gathered.append(out) or out)
    q, t = st_dispatch._pad_stack(qs, 96), st_dispatch._pad_stack(ts, 96)
    qlen, tlen = np.array([len(x) for x in qs]), np.array([len(x) for x in ts])
    mesh = dist.make_pair_mesh(["cpu"] * 2)
    for mode, band in (("global", 16), ("local", None)):
        # the route align_batch takes: run_bucket(backend="xla") under the mesh
        got = st_dispatch.run_bucket(q, t, qlen, tlen, PDNA, mode, band, True, None,
                                     mesh=mesh, backend="xla")
        # rank 0 of 2 with a mesh of 2: shards 0 and 1 of 4, the first 2 pairs
        want = st.align_batch(qs[:2], ts[:2], scoring=PDNA, mode=mode, band=band,
                              backend="xla", device="cpu")
        assert [f"score={got['score'][b]} q[{got['qs'][b]}:{got['qe'][b]}] "
                f"t[{got['ts'][b]}:{got['te'][b]}] {got['cigars'][b]}"
                for b in range(len(got["score"]))] == _strs(want)
    assert len(gathered) == 2


def test_mesh_arguments_are_checked():
    with pytest.raises(TypeError, match="make_pair_mesh"):
        st.align_batch(["ACGT"], ["AGT"], mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="make_pair_mesh"):
        st.align_batch(["ACGT"], ["AGT"], mesh="cpu")
    with pytest.raises(ValueError, match="at least one"):
        st.align_batch(["ACGT"], ["AGT"], mesh=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="make_pair_mesh: no CUDA"):
            st.make_pair_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            st.align_batch(["ACGT"], ["AGT"], mesh=["cuda:0"])


def _product(seed=0):
    rng = np.random.default_rng(seed)
    reads = [rng.integers(0, 4, int(rng.integers(20, 40))).astype(np.uint8) for _ in range(5)]
    refs = [rng.integers(0, 4, int(rng.integers(40, 150))).astype(np.uint8)
            for _ in range(3)]
    return reads, refs


def _same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _raise(*a, **k):
    raise AssertionError("resume must not realign finished chunks")


def test_all_vs_all_with_and_without_a_mesh(tmp_path, monkeypatch):
    reads, refs = _product()
    base = st.align_all_vs_all(reads, refs, scoring=PDNA, chunk_pairs=4, device="cpu")
    for i, q in enumerate(reads):
        for j, t in enumerate(refs):
            ref = align_oracle(q, t, PDNA, mode="local")
            assert tuple(int(base[f][i, j]) for f in FIELDS) == (
                ref.score, ref.query_start, ref.query_end, ref.target_start,
                ref.target_end)
    d = str(tmp_path / "mesh3")
    _same(st.align_all_vs_all(reads, refs, scoring=PDNA, chunk_pairs=4, mesh=["cpu"] * 3,
                              resume_dir=d, backend="pallas"), base)
    _same(st.align_all_vs_all(reads, refs, scoring=PDNA, chunk_pairs=4, mesh=["cpu"] * 8,
                              backend="xla"), base)
    # the shards written on a mesh of 3 resume without a mesh, on a mesh of 8
    # and in the JAX package, none realigning a chunk
    monkeypatch.setattr(st_dispatch, "run_bucket", _raise)
    _same(st.align_all_vs_all(reads, refs, scoring=PDNA, chunk_pairs=4, resume_dir=d,
                              device="cpu"), base)
    _same(st.align_all_vs_all(reads, refs, scoring=PDNA, chunk_pairs=4, resume_dir=d,
                              mesh=["cpu"] * 8), base)
    monkeypatch.setattr(sa_dispatch, "run_bucket", _raise)
    _same(sa.align_all_vs_all(reads, refs, scoring=DNA, backend="xla", chunk_pairs=4,
                              resume_dir=d), base)


def test_all_vs_all_resumes_unsharded_shards_on_a_mesh(tmp_path, monkeypatch):
    reads, refs = _product(1)
    d = str(tmp_path / "none")
    first = st.align_all_vs_all(reads, refs, scoring=PDNA, chunk_pairs=3, resume_dir=d,
                                device="cpu")
    monkeypatch.setattr(st_dispatch, "run_bucket", _raise)
    _same(st.align_all_vs_all(reads, refs, scoring=PDNA, chunk_pairs=3, resume_dir=d,
                              mesh=["cpu"] * 3), first)


def test_host_group_is_made_once_per_default_group(monkeypatch):
    """Under a default group that is not gloo (NCCL gathers no CPU tensors)
    the host results travel over a gloo group made once for it; a new
    default group replaces it, so one is kept at most."""
    import torch.distributed as tdist

    made = []
    monkeypatch.setattr(tdist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(tdist, "new_group", lambda **kw: made.append(kw) or len(made))
    monkeypatch.setattr(dist, "_HOST_GROUP", [])
    from types import SimpleNamespace

    monkeypatch.setattr(tdist, "group", SimpleNamespace(WORLD=object()))
    assert dist._host_group() == dist._host_group() == 1
    monkeypatch.setattr(tdist, "group", SimpleNamespace(WORLD=object()))
    assert dist._host_group() == 2
    assert made == [{"backend": "gloo"}] * 2 and len(dist._HOST_GROUP) == 2
    monkeypatch.setattr(tdist, "get_backend", lambda group=None: "gloo")
    assert dist._host_group() is None
