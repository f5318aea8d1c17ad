import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import cells
import marks
import spans

W = {"pairs": [(100, 100)], "band": None, "traceback": True}
READERS = ("host_lead_ms", "launch_gap_ms", "host_tail_ms", "device_busy_pct",
           "sp_tile.roofline_pct", "band_fill.roofline_pct")
NEW = ("stage_ms", "walk_ms", "rescore_ms", "ptr_copy_ms")

CALLS = [("bench.call", 0, 100), ("bench.call", 110, 200)]
OPS = [("void sp_run_kernel<0>(RunArgs)", 10, 30), ("void sp_run_kernel<2>(RunArgs)", 50, 60),
       ("void sp_run_kernel<0>(RunArgs)", 150, 190)]
HOST = [("aten::copy_", 30, 55), ("cudaStreamSynchronize", 60, 100), ("aten::to", 100, 140)]
# the program's marks: call 0 aligns with a CIGAR, call 1 scores
MARKS = [("seqalib.align_sp", 2, 98), ("seqalib.sp.stage", 3, 9), ("seqalib.sp.fill", 9, 12),
         ("seqalib.sp.score_wait", 12, 30), ("seqalib.sp.walk", 31, 80),
         ("seqalib.sp.ptr_batch", 35, 62), ("seqalib.sp.ptr_launch", 35, 40),
         ("seqalib.sp.ptr_copy", 40, 62), ("seqalib.sp.rescore", 80, 97),
         ("seqalib.align_score_sp", 112, 199), ("seqalib.sp.stage", 113, 145),
         ("seqalib.sp.fill", 145, 148), ("seqalib.sp.score_wait", 148, 195)]


def window(with_marks=True):
    return spans.build_window(CALLS, OPS, HOST + (MARKS if with_marks else []), [W, W])


def test_the_program_s_marks_change_no_reading_of_the_accepted_metrics():
    a, b = window(False), window(True)
    assert a.ops == b.ops and [c.ops for c in a.calls] == [c.ops for c in b.calls]
    assert [spans.lead_gap_tail(c) for c in a.calls] == [spans.lead_gap_tail(c) for c in b.calls]
    for name in READERS:
        assert cells.reader(name)(a) == cells.reader(name)(b), name
    ba, bb = spans.breakdown(a, top=100), spans.breakdown(b, top=100)
    assert ba["device_ops"] == bb["device_ops"]
    # the same idle time; where no ATen op or runtime call covers it, the
    # program's innermost mark names it instead of ``python``
    assert sum(v for _, v in ba["idle_gaps"]) == pytest.approx(130e-9)
    assert sum(v for _, v in bb["idle_gaps"]) == pytest.approx(130e-9)
    assert dict(bb["idle_gaps"])["call: seqalib.sp.stage"] == pytest.approx(38e-9)


def test_marks_go_to_the_call_that_holds_their_start_and_self_time_drops_children():
    own = marks.marks(window())
    assert [len(x) for x in own] == [9, 4]
    assert {m[0] for m in own[1]} == {"seqalib.align_score_sp", "seqalib.sp.stage",
                                      "seqalib.sp.fill", "seqalib.sp.score_wait"}
    walk = [i for i, m in enumerate(own[0]) if m[0] == "seqalib.sp.walk"][0]
    assert marks.self_ns(own[0], walk) == 49 - 27  # the batch 35-62 inside
    batch = [i for i, m in enumerate(own[0]) if m[0] == "seqalib.sp.ptr_batch"][0]
    assert marks.self_ns(own[0], batch) == 0  # launch and copy cover it
    assert marks.marks(window(False)) == [[], []]


def test_idle_by_span_names_the_innermost_mark():
    got = marks.idle_by_span(window(), top=None)
    # call 0 idle: 0-10, 30-50, 60-100; call 1: 110-150, 190-200 (ns)
    assert {k: round(v * 1e9) for k, v in got} == {
        "outside the port": 2 + 2 + 2 + 1,  # 0-2, 98-100, 110-112, 199-200
        "seqalib.align_sp": 1 + 1 + 1,  # 2-3, 30-31, 97-98
        "seqalib.align_score_sp": 1 + 4,  # 112-113, 195-199
        "seqalib.sp.stage": 6 + 32,  # 3-9, 113-145
        "seqalib.sp.fill": 1 + 3,  # 9-10, 145-148
        "seqalib.sp.score_wait": 2 + 5,  # 148-150, 190-195
        "seqalib.sp.walk": 4 + 18,  # 31-35, 62-80
        "seqalib.sp.ptr_launch": 5,  # 35-40: the launch, not its batch, is innermost
        "seqalib.sp.ptr_copy": 10 + 2,  # 40-50, 60-62
        "seqalib.sp.rescore": 17,  # 80-97
    }
    assert got[0][0] == "seqalib.sp.stage" and len(marks.idle_by_span(window(), top=3)) == 3
    assert sum(v for _, v in got) == pytest.approx((70 + 50) * 1e-9)
    named = 38 + 4 + 7 + 22 + 5 + 12 + 17
    assert marks.named_idle_share(window()) == pytest.approx(named / (named + 3 + 5))
    assert marks.named_idle_share(window(False)) is None


def test_the_new_readers_on_a_synthetic_window():
    w = window()
    assert cells.reader("stage_ms.sp")(w) == pytest.approx((6 + 32) / 2 / 1e6)
    assert cells.reader("walk_ms.sp_cigar")(w) == pytest.approx(22 / 1e6)
    assert cells.reader("rescore_ms.sp_cigar")(w) == pytest.approx(17 / 1e6)
    assert cells.reader("ptr_copy_ms.sp_cigar")(w) == pytest.approx(22 / 1e6)
    # a window of a program without the spans: nothing to read, no value
    for name in NEW:
        assert cells.reader(name)(window(False)) is None


def test_a_call_s_batches_are_summed():
    extra = [("seqalib.sp.ptr_copy", 70, 75)]
    w = spans.build_window(CALLS, OPS, HOST + MARKS + extra, [W, W])
    assert cells.reader("ptr_copy_ms")(w) == pytest.approx(27 / 1e6)


class _Event:
    def __init__(self, name, device, start, duration, kind=None):
        self._v = name, device, start, duration
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return 0


@pytest.mark.parametrize("typed", [False, True])
def test_raw_program_marks_are_host_ops_and_never_kernels_or_calls(typed):
    evs = [_Event("bench.call", "DeviceType.CPU", 0, 100, "user_annotation" if typed else None),
           _Event("seqalib.align_sp", "DeviceType.CPU", 1, 98, "cpu_op" if typed else None),
           _Event("seqalib.sp.stage", "DeviceType.CPU", 2, 5, "cpu_op" if typed else None),
           _Event("sp_run_kernel<0>", "DeviceType.CUDA", 10, 20, "kernel" if typed else None)]
    w = spans.window_from_events(evs, [W])
    assert [(c.start, c.end) for c in w.calls] == [(0, 100)]
    assert w.ops == [("sp_run_kernel<0>", 10, 30)]
    assert w.host == [("seqalib.align_sp", 1, 99), ("seqalib.sp.stage", 2, 7)]
    assert cells.reader("stage_ms")(w) == pytest.approx(5 / 1e6)


def test_a_profile_of_the_program_reaches_the_readers():
    import seqalib_tpu_torch as st

    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, 200).astype(np.uint8)
    t = q[:190].copy()
    sp = st.ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
    mesh = st.make_band_mesh(["cpu"])
    work = {"pairs": [(200, 190)], "band": None, "traceback": True}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for call in (lambda: st.align_sp(q, t, sp, mesh, C=64),
                     lambda: st.align_score_sp(q, t, sp, mesh)):
            with torch.profiler.record_function(spans.CALL_SPAN):
                call()
    w = spans.window_from_events(prof.profiler.kineto_results.events(), [work, work])
    own = marks.marks(w)
    assert own[0][0][0] == "seqalib.align_sp" and own[1][0][0] == "seqalib.align_score_sp"
    for name in NEW:
        assert cells.reader(name)(w) > 0, name
    assert all(c.start <= m[1] and m[2] <= c.end for c, x in zip(w.calls, own) for m in x)


def test_the_marks_module_imports_nothing_of_the_program():
    tree = ast.parse((Path(marks.__file__)).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not names & {"seqalib_tpu_torch", "seqalib_tpu", "jax"}
