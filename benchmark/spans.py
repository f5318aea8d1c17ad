"""Reduce a traced window to what the per-layer readers need.

The traced run wraps every call in a ``record_function`` span named
``CALL_SPAN``.  From the profiler's raw events this module keeps three
lists of ``(name, start_ns, end_ns)``: the call spans, the device
operations (kernels, copies and sets on a CUDA device), and the host's
operations (ATen ops and CUDA runtime calls).  A device op belongs to the
call whose span holds the host call that launched it (the runtime call
with its correlation id).  The device's timestamps can stand off the
host's by a millisecond or more within a run (a call's last op read as
ending after the call returned), so each call's device ops are shifted by
one offset: the smallest lag between an op's launch and its start, which
the call's first op, launched onto an idle card, sets.  Each call ends with
its results on the host, so none of its operations runs after it.
Everything else here is arithmetic on intervals, testable without a card.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

CALL_SPAN = "bench.call"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver")


@dataclass
class Call:
    start: int
    end: int
    work: dict  # what the call was asked to do (the cell's geometry)
    ops: list = field(default_factory=list)  # (name, start_ns, end_ns)


@dataclass
class Window:
    start: int
    end: int
    calls: list  # [Call]
    ops: list  # every device op in the window: (name, start_ns, end_ns)
    host: list  # host ops: (name, start_ns, end_ns), sorted by start

    def __post_init__(self):
        self.call_starts = [c.start for c in self.calls]
        self.host_starts = [h[1] for h in self.host]
        # every instant at which what the host does may change
        self.edges = sorted(set(self.call_starts + [c.end for c in self.calls]
                                + self.host_starts + [h[2] for h in self.host]))

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


def union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0)


def idle_gaps(intervals, start: int, end: int):
    """The (start, end) gaps inside [start, end] that no interval covers."""
    gaps, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        gaps.append((cur, end))
    return [(s, e) for s, e in gaps if e > s]


def lead_gap_tail(call: Call):
    """(lead, gap, tail) of one call in ns: span start to its first device
    op; device idle time between its first and last op; last op's end to
    the span's end.  None for a call that ran nothing on the device."""
    if not call.ops:
        return None
    first = min(s for _, s, _ in call.ops)
    last = max(e for _, _, e in call.ops)
    busy = union_ns([(s, e) for _, s, e in call.ops])
    return first - call.start, (last - first) - busy, call.end - last


def _kind(ev) -> str:
    """The event's activity type; torch builds whose raw events lack
    ``activity_type`` are told apart by device and name (the call span also
    shows on the device's timeline, as an annotation)."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    on_device = str(ev.device_type()).endswith("CUDA")
    if ev.name() == CALL_SPAN:
        return "gpu_user_annotation" if on_device else "user_annotation"
    return "kernel" if on_device else "cpu_op"


def _correlation(ev):
    return ev.correlation_id() if hasattr(ev, "correlation_id") else None


def mean_part_ms(window: Window, part: int):
    """The mean over calls of ``lead_gap_tail``'s part ``part`` (0 lead, 1
    gap, 2 tail), in ms; None when no call ran anything on the device."""
    vals = [x[part] for x in map(lead_gap_tail, window.calls) if x is not None]
    return sum(vals) / len(vals) / 1e6 if vals else None


def window_from_events(events, works) -> Window:
    """Build the Window from the profiler's raw events (objects with
    ``name()``, ``device_type()``, ``start_ns()``, ``duration_ns()`` and
    ``correlation_id()``) and the list of per-call ``work`` dicts, in call
    order."""
    spans, ops, host, launched = [], [], [], {}
    for ev in events:
        kind = _kind(ev)
        name, start = ev.name(), ev.start_ns()
        end = start + ev.duration_ns()
        if kind == "user_annotation" and name == CALL_SPAN:
            spans.append((name, start, end))
        elif kind in DEVICE_KINDS:
            ops.append((name, start, end, _correlation(ev)))
        elif kind in HOST_KINDS:
            host.append((name, start, end))
            if name.startswith("cu"):  # a CUDA runtime or driver call
                launched[_correlation(ev)] = start
    ops = [(n, s, e, launched.get(c) if c else None) for n, s, e, c in ops]
    return build_window(spans, ops, host, works)


def build_window(spans, ops, host, works) -> Window:
    """``ops``: (name, start, end) or (name, start, end, launch), ``launch``
    the host time of the call that launched it, or None."""
    spans = sorted(spans, key=lambda x: x[1])
    if len(spans) != len(works):
        raise RuntimeError(f"{len(spans)} call spans traced for {len(works)} calls")
    calls = [Call(s, e, w) for (_, s, e), w in zip(spans, works)]
    if not calls:
        raise RuntimeError("no call in the traced window")
    starts = [c.start for c in calls]
    mine: list = [[] for _ in calls]
    for op in ops:
        launch = op[3] if len(op) > 3 else None
        at = op[1] if launch is None else launch
        k = bisect.bisect_right(starts, at) - 1
        if k >= 0 and at <= calls[k].end:
            mine[k].append((op[0], op[1], op[2], launch))
    for call, own in zip(calls, mine):
        lags = [s - launch for _, s, _, launch in own if launch is not None]
        shift = min(lags) if lags else 0
        call.ops = sorted(((n, s - shift, e - shift) for n, s, e, _ in own),
                          key=lambda x: x[1])
    ops = sorted((op for c in calls for op in c.ops), key=lambda x: x[1])
    return Window(calls[0].start, calls[-1].end, calls, ops, sorted(host, key=lambda x: x[1]))


def host_label(w: Window, t: int, look_back: int = 256) -> str:
    """What the host was doing at time ``t``: the innermost host op that
    covers it (the latest started among those that still run), else
    ``python`` (host code outside any torch op), prefixed by whether a
    call was running."""
    k = bisect.bisect_right(w.call_starts, t) - 1
    where = "call" if k >= 0 and t <= w.calls[k].end else "between calls"
    i = bisect.bisect_right(w.host_starts, t) - 1
    for h in range(i, max(-1, i - look_back), -1):
        if w.host[h][2] >= t:
            return f"{where}: {w.host[h][0]}"
    return f"{where}: python"


def breakdown(w: Window, top: int = 10) -> dict:
    """The device ops that took most time (summed by name) and the device's
    idle time summed by what the host was doing meanwhile, in seconds."""
    by_op: dict = {}
    for name, s, e in w.ops:
        by_op[name] = by_op.get(name, 0) + (e - s)
    by_gap: dict = {}
    for s, e in idle_gaps([(s, e) for _, s, e in w.ops], w.start, w.end):
        # cut the gap where the host's activity changes, label each piece
        cuts = w.edges[bisect.bisect_right(w.edges, s): bisect.bisect_left(w.edges, e)]
        for a, b in zip([s] + cuts, cuts + [e]):
            label = host_label(w, (a + b) / 2)
            by_gap[label] = by_gap.get(label, 0) + (b - a)

    def ranked(d):
        return [[k[:120], v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_gap)}
