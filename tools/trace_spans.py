#!/usr/bin/env python3
"""Trace a few calls of one benchmark cell and split them by the port's own
spans and counters.

    python3 tools/trace_spans.py --workload long_pair_sp.cigar [--seed N] [--calls 20]

From the root of a checkout.  Builds the cell's pool of pairs and its call
as ``benchmark/run.py`` does (``cells``, ``generate``, ``drive``), warms up
with every batch of the pool twice, then makes ``--calls`` calls under
``torch.profiler`` (CPU and CUDA), each in the harness's call span, and
reads the trace with the harness's own ``spans.window_from_events``.
Prints one JSON line: the card's name and power limit; per call, the
difference of the port's counters (``telemetry.snapshot``: kernel launches,
bytes copied to the host, ``banded_align_batch`` calls and the slots their
fills and recomputes compute); the cell's per-layer metrics read from this
window; each ``seqalib.*`` span's mean time and self time per call
(``marks.mean_ms``); the device's idle time inside calls by the innermost
span (``marks.idle_by_span``) and the share of the idle time inside the
public call's span that a named phase covers (``marks.named_idle_share``);
and the host's cost in µs of opening and closing one span, with no
profiler recording and with one.  ``--device cpu`` runs the plain versions
of the kernels: keep the cell small there.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmark"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import cells  # noqa: E402
import drive  # noqa: E402
import generate  # noqa: E402
import marks  # noqa: E402
import spans  # noqa: E402
import seqalib_tpu_torch as st  # noqa: E402
from seqalib_tpu_torch import telemetry  # noqa: E402


def card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "-i", str(device.index or 0)],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(device)


def span_cost_us(n: int = 20000) -> dict:
    """µs to open and close one span, without and with a profiler recording."""
    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with telemetry.span("seqalib.cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = loop()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = loop()
    return {"off": off, "on": on}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cell = cells.load(args.workload)
    if device.type == "cuda":
        from seqalib_tpu_torch import _build

        _build.build()
        _build.lib()
    request = cell.traffic["request"]
    sc = cells.scoring(cell.config, int(cell.traffic["alphabet"]), cell.bench_dir)
    batches = generate.pool(args.seed, cell.traffic)
    index = drive.pairs(request, *generate.sizes(cell.traffic))
    call = drive.make_call(st, sc, cell.config, request, device)
    for b in range(2 * len(batches)):
        call(*batches[b % len(batches)])
    works = [{"pairs": [(len(qs[i]), len(ts[j])) for i, j in index], "band": sc.band,
              "traceback": request["answers"] == "alignment"} for qs, ts in batches]

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = telemetry.snapshot()
    with torch.profiler.profile(activities=acts) as prof:
        for k in range(args.calls):
            with torch.profiler.record_function(spans.CALL_SPAN):
                call(*batches[k % len(batches)])
    after = telemetry.snapshot()
    window = spans.window_from_events(prof.profiler.kineto_results.events(),
                                      [works[k % len(works)] for k in range(args.calls)])
    names = sorted({m[0] for own in marks.marks(window) for m in own})
    out = {
        "workload": args.workload, "seed": args.seed, "calls": args.calls,
        "card": card(device),
        "per_call": {k: (after[k] - before[k]) / args.calls for k in after},
        "metrics": {m["name"]: cells.reader(m["name"])(window) for m in cell.per_layer},
        "span_ms": {n: [marks.mean_ms(window, n), marks.mean_ms(window, n, self_time=True)]
                    for n in names},
        "idle_by_span": marks.idle_by_span(window),
        "named_idle_share": marks.named_idle_share(window),
        "span_cost_us": span_cost_us(),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
