"""The port's telemetry (``seqalib_tpu_torch/telemetry.py``): a span costs
an attribute read while no profiler records; while one records, each path
marks its phases, nested as the module says; the counters count on a card
and stay put on the CPU."""

import numpy as np
import pytest
import torch

import seqalib_tpu_torch as st
from seqalib_tpu_torch import ops, telemetry
from seqalib_tpu_torch.ops.sp_walk import out_bytes
from seqalib_tpu_torch.parallel import band_pipeline as pbp

DNA = st.ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
LAUNCH_KEYS = {
    "row_window", "strip_fill/local", "strip_fill/emode", "strip_fill/gmode", "strip_walk",
    "band_fill/fill", "band_fill/ptr", "band_fill/emode", "band_fill/relay",
    "band_fill/relay_ptr", "band_fill/wide", "band_fill/wide_ptr", "band_fill/wide_emode",
    "band_fill/wide_scratch", "band_fill/wide_scratch_ptr", "band_fill/wide_scratch_emode",
    "band_walk", "band_walk/floor", "band_cigar", "sp_tile/global", "sp_tile/local",
    "sp_tile/ptr", "sp_tile/run_global", "sp_tile/run_local", "sp_tile/ptr_batch", "sp_walk",
    "wavefront_fill/ptr",
    "wavefront_fill/score", "wavefront_fill/lin_ptr", "wavefront_fill/lin_score",
    "wavefront_fill/local", "wavefront_fill/local_lin", "wavefront_fill/local_ptr",
    "wavefront_fill/local_lin_ptr", "wavefront_walk", "wavefront_walk/linear",
}


def _pair(n=300, m=280, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, n).astype(np.uint8)
    t = q[:m].copy()
    flip = rng.random(m) < 0.1
    t[flip] = rng.integers(0, 4, int(flip.sum()))
    return q, t


def _spans(fn):
    """The ``seqalib.*`` ranges a CPU profiler records while ``fn`` runs:
    (name, start_ns, end_ns), by start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("seqalib.")), key=lambda x: x[1])


def _named(got, name):
    return [g for g in got if g[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _run_every_entry():
    q, t = _pair()
    mesh = st.make_band_mesh(["cpu"] * 2)
    st.align_sp(q, t, DNA, mesh, C=64)
    st.align_score_sp(q, t, DNA, mesh)
    st.align_score_sp(q, t, DNA, mesh, mode="local")
    st.align_banded_sp(q, t, DNA, 16, mesh)
    st.align_score_banded_sp([q, q], [t, q], DNA, 16, mesh)
    st.align_batch(["ACGTACGTTA", "ACGT" * 40], ["ACGACGTTA", "ACGA" * 40], scoring=DNA,
                   device="cpu")
    st.align_batch(["ACGTACGTTA" * 5], ["ACGACGTTA" * 5], scoring=DNA, band=8, device="cpu")
    st.align("ACGTACGT", "ACGACGT", scoring=DNA, device="cpu")
    st.align_all_vs_all(["ACGTACGT", "TTGACA"], ["ACGACGT"], scoring=DNA, device="cpu")


def test_without_a_profiler_a_span_is_the_shared_null_context_and_builds_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range was built for {name}")

    monkeypatch.setattr(telemetry, "_Range", refuse)
    assert telemetry.span("seqalib.a") is telemetry.span("seqalib.b")
    _run_every_entry()
    # the entry points keep their names and documentation
    assert st.align_sp.__name__ == "align_sp" and "long pair" in st.align_sp.__doc__


def test_every_entry_point_is_one_root_span():
    got = _spans(_run_every_entry)
    roots = [g[0] for g in got if g[0].startswith("seqalib.align")]
    assert roots == ["seqalib.align_sp", "seqalib.align_score_sp", "seqalib.align_score_sp",
                     "seqalib.align_banded_sp", "seqalib.align_score_banded_sp",
                     "seqalib.align_batch", "seqalib.align_batch", "seqalib.align",
                     "seqalib.align_batch", "seqalib.align_all_vs_all"]
    # every other span lies inside a root
    tops = [g for g in got if g[0].startswith("seqalib.align")]
    assert all(any(_inside(g, r) for r in tops) for g in got)


@pytest.mark.parametrize("D", [1, 2])
def test_the_long_pair_alignment_marks_its_phases_nested(D):
    q, t = _pair()
    got = _spans(lambda: st.align_sp(q, t, DNA, st.make_band_mesh(["cpu"] * D), C=64))
    (root,) = _named(got, "seqalib.align_sp")
    assert all(_inside(g, root) for g in got)
    (stage,) = _named(got, "seqalib.sp.stage")
    fills = _named(got, "seqalib.sp.fill")
    ckpts = _named(got, "seqalib.sp.checkpoint")
    (wait,) = _named(got, "seqalib.sp.score_wait")
    (walk,) = _named(got, "seqalib.sp.walk")
    (rescore,) = _named(got, "seqalib.sp.rescore")
    assert len(fills) == len(ckpts) == D  # a fill and its checkpoints a block
    assert stage[2] <= fills[0][1] and fills[-1][2] <= wait[1]
    assert wait[2] <= walk[1] and walk[2] <= rescore[1]
    batches = _named(got, "seqalib.sp.ptr_batch")
    launches = _named(got, "seqalib.sp.ptr_launch")
    copies = _named(got, "seqalib.sp.ptr_copy")
    assert batches and len(batches) == len(launches) == len(copies)
    for b, la, co in zip(batches, launches, copies):
        assert _inside(b, walk) and _inside(la, b) and _inside(co, b) and la[2] <= co[1]


@pytest.mark.parametrize("mode", ["global", "local"])
def test_the_long_pair_score_marks_staging_fill_and_wait(mode):
    q, t = _pair()
    got = _spans(lambda: st.align_score_sp(q, t, DNA, st.make_band_mesh(["cpu"]), mode=mode))
    assert [g[0] for g in got] == ["seqalib.align_score_sp", "seqalib.sp.stage",
                                   "seqalib.sp.fill", "seqalib.sp.score_wait"]
    assert all(_inside(g, got[0]) for g in got)


def test_a_bucketed_batch_marks_each_bucket_s_launch_and_finalize():
    got = _spans(lambda: st.align_batch(["ACGTACGTTA", "ACGT" * 40], ["ACGACGTTA", "ACGA" * 40],
                                        scoring=DNA, device="cpu"))
    (root,) = _named(got, "seqalib.align_batch")
    launches = _named(got, "seqalib.bucket.launch")
    finals = _named(got, "seqalib.bucket.finalize")
    assert len(launches) == len(finals) == 2  # two length buckets
    assert all(_inside(g, root) for g in got)
    assert max(e for _, _, e in launches) <= min(s for _, s, _ in finals)


@pytest.mark.parametrize("traceback", [True, False])
def test_a_banded_batch_marks_its_group_and_phases(traceback):
    got = _spans(lambda: st.align_batch(["ACGTACGTTA" * 5], ["ACGACGTTA" * 5], scoring=DNA,
                                        band=8, traceback=traceback, device="cpu"))
    (group,) = _named(got, "seqalib.banded.group")
    names = [g[0] for g in got if _inside(g, group) and g is not group]
    if traceback:
        assert names[:2] == ["seqalib.banded.stage", "seqalib.banded.fill"]
        assert names[-2:] == ["seqalib.banded.ops_copy", "seqalib.banded.cigar"]
        assert set(names[2:-2]) == {"seqalib.banded.block"}
    else:
        assert names == ["seqalib.banded.stage", "seqalib.banded.fill"]


def test_the_launch_counter_keeps_its_keys_and_the_cpu_counts_nothing(monkeypatch):
    assert ops.launches is telemetry.launches
    assert ops.reset_launches is telemetry.reset_launches
    assert set(telemetry.launches) == LAUNCH_KEYS
    monkeypatch.setitem(telemetry.launches, "sp_tile/ptr_batch",
                        telemetry.launches["sp_tile/ptr_batch"] + 2)
    before = telemetry.snapshot()
    _run_every_entry()
    assert telemetry.snapshot() == before  # plain versions: no launch, no copy
    saved = dict(telemetry.launches)
    try:
        ops.reset_launches()
        assert set(telemetry.launches.values()) == {0} and telemetry.snapshot()["launches"] == 0
    finally:
        telemetry.launches.update(saved)


def test_a_copy_counts_the_bytes_of_cuda_tensors_only(monkeypatch):
    monkeypatch.setattr(telemetry, "d2h_bytes", 0)
    telemetry.count_d2h(torch.zeros(5, dtype=torch.int32), torch.zeros(3, dtype=torch.uint8))
    assert telemetry.d2h_bytes == 0


@pytest.mark.cuda
def test_align_sp_on_the_card_counts_its_pointer_rows_scores_and_launches(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the counters count the card's launches and copies")
    shapes = []
    real = pbp.sp_tile_ptr

    def recorded(*args, **kw):
        out = real(*args, **kw)
        shapes.append(tuple(out["ptr"].shape))  # (K tiles, C columns, rows)
        return out

    monkeypatch.setattr(pbp, "sp_tile_ptr", recorded)
    q, t = _pair(3000, 2900)
    mesh = st.make_band_mesh(["cuda"])
    st.align_sp(q, t, DNA, mesh)  # the first call builds and loads the kernels
    shapes.clear()
    before = telemetry.snapshot()
    got = st.align_sp(q, t, DNA, mesh)
    after = telemetry.snapshot()
    batches = list(shapes)
    assert batches and all(C == 128 for _, C, _ in batches)
    # each batch's walk sends back its header and room for its ops, not its
    # pointer rows; and the one block's score
    assert after["d2h_bytes"] - before["d2h_bytes"] == sum(
        out_bytes(K, C, rows) for K, C, rows in batches) + 4
    # the fill, then a recompute and a walk a batch
    assert after["launches"] - before["launches"] == 1 + 2 * len(batches)
    assert str(got) == str(st.align_sp(q, t, DNA, st.make_band_mesh(["cpu"])))
