"""The program's own spans in a traced window.

The program marks the phases of a call with profiler ranges named
``seqalib.*`` (``seqalib_tpu_torch/telemetry.py``), which the trace holds
as host ops: ``spans.window_from_events`` keeps them in ``Window.host``
with the ATen ops, on the host clock the calls' device ops are placed
against.  A mark belongs to the call whose span holds its start.  This
module gives each call's marks, a span's time per call (in all, or its
self time: less what the marks inside it cover), and the device's idle
time inside calls by the innermost mark that covers it.  A window of a
program without such spans has no marks, and every reader of them returns
None.  Like ``spans.py``, it imports nothing of the program.
"""

from __future__ import annotations

import bisect

import spans

PREFIX = "seqalib."
ROOT = "seqalib.align"  # the prefix of the public calls' spans
OUTSIDE = "outside the port"


def marks(window) -> list:
    """Per call, in call order, its marks ``(name, start_ns, end_ns)``."""
    own: list = [[] for _ in window.calls]
    for name, s, e in window.host:
        if name.startswith(PREFIX):
            k = bisect.bisect_right(window.call_starts, s) - 1
            if k >= 0 and s <= window.calls[k].end:
                own[k].append((name, s, e))
    return own


def self_ns(call_marks: list, i: int) -> int:
    """Mark ``i``'s duration less what the other marks inside it cover."""
    _, s, e = call_marks[i]
    inside = [(a, b) for j, (_, a, b) in enumerate(call_marks)
              if j != i and s <= a and b <= e]
    return (e - s) - spans.union_ns(inside)


def mean_ms(window, name: str, self_time: bool = False):
    """The mean, over the calls that hold a mark ``name``, of the time such
    marks take in the call (summed; ``self_time``: each less the marks
    inside it), in ms; None when no call holds one."""
    vals = []
    for own in marks(window):
        hit = [i for i, m in enumerate(own) if m[0] == name]
        if hit:
            vals.append(sum(self_ns(own, i) if self_time else own[i][2] - own[i][1]
                            for i in hit))
    return sum(vals) / len(vals) / 1e6 if vals else None


def idle_by_span(window, top: int | None = 10) -> list:
    """The device's idle time inside calls, summed by the innermost mark
    that covers it (``OUTSIDE`` where none does), most first, in seconds:
    ``[[name, s], ...]``, the first ``top`` (every one with None)."""
    by: dict = {}
    for call, own in zip(window.calls, marks(window)):
        for s, e in spans.idle_gaps([(a, b) for _, a, b in call.ops], call.start, call.end):
            cuts = sorted({x for _, a, b in own for x in (a, b) if s < x < e})
            for a, b in zip([s] + cuts, cuts + [e]):
                t = (a + b) / 2
                cover = [m for m in own if m[1] <= t <= m[2]]
                # innermost: the latest started, of those the first to end
                label = max(cover, key=lambda m: (m[1], -m[2]))[0] if cover else OUTSIDE
                by[label] = by.get(label, 0) + (b - a)
    ranked = sorted(by.items(), key=lambda kv: -kv[1])
    return [[k, v / 1e9] for k, v in (ranked if top is None else ranked[:top])]


def named_idle_share(window):
    """Of the device's idle time inside the public calls' spans
    (``seqalib.align*``), the share that a mark inside them covers; None
    without such time."""
    by = dict(idle_by_span(window, None))
    named = sum(v for k, v in by.items() if k.startswith(PREFIX) and not k.startswith(ROOT))
    root = sum(v for k, v in by.items() if k.startswith(ROOT))
    return named / (named + root) if named + root else None
