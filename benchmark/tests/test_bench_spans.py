import pytest

import cells
import roofline
import reference
import spans

W = {"pairs": [(100, 100)], "band": 8, "traceback": True}


def window():
    # two calls: [0, 100] with ops at 10-30 and 50-60; [110, 200] with one op 150-190
    calls = [("bench.call", 0, 100), ("bench.call", 110, 200)]
    ops = [("band_fill_kernel<0, 1, false, false>", 10, 30), ("band_walk_kernel", 50, 60),
           ("band_fill_kernel<1, 1, false, false>", 150, 190), ("late", 300, 310)]
    host = [("aten::copy_", 30, 55), ("cudaStreamSynchronize", 60, 100), ("aten::to", 100, 140)]
    return spans.build_window(calls, ops, host, [W, W])


def test_union_and_gaps():
    assert spans.union_ns([(0, 10), (5, 20), (30, 40)]) == 30
    assert spans.union_ns([]) == 0
    assert spans.idle_gaps([(10, 20), (15, 30), (50, 60)], 0, 70) == [(0, 10), (30, 50), (60, 70)]
    assert spans.idle_gaps([(0, 100)], 10, 50) == []


def test_ops_go_to_the_call_they_start_in():
    w = window()
    assert [len(c.ops) for c in w.calls] == [2, 1]
    assert (w.start, w.end) == (0, 200) and len(w.ops) == 3  # the late op is outside


def test_lead_gap_tail():
    w = window()
    assert spans.lead_gap_tail(w.calls[0]) == (10, 20, 40)  # 30 -> 50 idle inside the call
    assert spans.lead_gap_tail(w.calls[1]) == (40, 0, 10)
    assert spans.lead_gap_tail(spans.Call(0, 1, W)) is None


def test_readers_on_a_synthetic_window():
    w = window()
    assert cells.reader("host_lead_ms")(w) == pytest.approx((10 + 40) / 2 / 1e6)
    assert cells.reader("launch_gap_ms")(w) == pytest.approx(10 / 1e6)
    assert cells.reader("host_tail_ms")(w) == pytest.approx(25 / 1e6)
    assert cells.reader("device_busy_pct")(w) == pytest.approx(100 * 70 / 200)
    cells_ = reference.band_cells(100, 100, 8)
    least = 2 * roofline.fill_s(cells_, 200, 1) + 2 * roofline.pointer_fill_s(cells_, 200)
    assert cells.reader("band_fill.roofline_pct")(w) == pytest.approx(100 * least / 60e-9)
    assert cells.reader("sp_tile.roofline_pct")(w) is None  # nothing to read: no value


@pytest.mark.parametrize("traceback", [True, False])
def test_sp_reader_counts_the_pointer_recompute_as_a_pointer_fill(traceback):
    work = {"pairs": [(64, 64)], "band": None, "traceback": traceback}
    ops = [("void sp_run_kernel<0>(RunArgs)", 10, 110)]
    if traceback:
        ops.append(("void sp_run_kernel<2>(RunArgs)", 200, 900))
    w = spans.build_window([("bench.call", 0, 1000)], ops, [], [work])
    least = roofline.fill_s(64 * 64, 128, 1)
    spent = 100e-9
    if traceback:
        least += roofline.pointer_fill_s(64 * 64, 128)
        spent += 700e-9
    assert cells.reader("sp_tile.roofline_pct")(w) == pytest.approx(100 * least / spent)


def test_breakdown_labels_idle_time_by_the_host():
    b = spans.breakdown(window())
    assert b["device_ops"][0] == ["band_fill_kernel<1, 1, false, false>", 40e-9]
    gaps = dict(b["idle_gaps"])
    assert gaps["call: cudaStreamSynchronize"] == pytest.approx(40e-9)  # 60-100
    assert gaps["call: aten::copy_"] == pytest.approx(20e-9)  # 30-50
    assert gaps["between calls: aten::to"] == pytest.approx(10e-9)  # 100-110
    assert gaps["call: aten::to"] == pytest.approx(30e-9)  # 110-140
    assert gaps["call: python"] == pytest.approx(30e-9)  # 0-10, 140-150, 190-200
    assert sum(gaps.values()) == pytest.approx(130e-9)


def test_roofline_counts():
    assert roofline.OPS_PER_CELL == 11
    assert roofline.INT32_OPS_PER_S == pytest.approx(16.73e12, rel=1e-3)
    # 1000 x 1000 cells: 11e6 ops bound the fill; pointers add 0.5 MB, still under the op bound
    assert roofline.fill_s(10**6, 2000, 1) == pytest.approx(11e6 / roofline.INT32_OPS_PER_S)
    assert roofline.pointer_fill_s(10**6, 2000) == pytest.approx(11e6 / roofline.INT32_OPS_PER_S)
    # a memory-bound case: few cells, many letters
    assert roofline.least_s(0, 3.35e9) == pytest.approx(1e-3)


class _Event:
    def __init__(self, name, device, start, duration, correlation=0):
        self._v = name, device, start, duration, correlation

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_raw_events_without_an_activity_type():
    # the call span shows on both timelines; only the host's is the call
    evs = [_Event("bench.call", "DeviceType.CPU", 0, 100),
           _Event("bench.call", "DeviceType.CUDA", 5, 90),
           _Event("sp_run_kernel<0>", "DeviceType.CUDA", 10, 20),
           _Event("aten::copy_", "DeviceType.CPU", 1, 3)]
    w = spans.window_from_events(evs, [W])
    assert [(c.start, c.end) for c in w.calls] == [(0, 100)]
    assert w.ops == [("sp_run_kernel<0>", 10, 30)] and w.host == [("aten::copy_", 1, 4)]


def test_device_clock_offset_is_taken_out_per_call():
    # the device's clock reads 1 500 ns late; ops are launched at 10 and 60,
    # the first starts 2 ns after its launch: the call really ends 5 after
    # its last op, though the raw trace puts that op past the call's end
    off = 1500
    evs = [_Event("bench.call", "DeviceType.CPU", 0, 100),
           _Event("cudaLaunchKernel", "DeviceType.CPU", 10, 4, 7),
           _Event("cudaMemcpyAsync", "DeviceType.CPU", 60, 35, 8),
           _Event("k", "DeviceType.CUDA", 12 + off, 40, 7),
           _Event("Memcpy DtoH (Device -> Pageable)", "DeviceType.CUDA", 70 + off, 25, 8)]
    w = spans.window_from_events(evs, [W])
    assert w.ops == [("k", 10, 50), ("Memcpy DtoH (Device -> Pageable)", 68, 93)]
    assert spans.lead_gap_tail(w.calls[0]) == (10, 18, 7)
