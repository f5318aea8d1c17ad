#!/usr/bin/env python3
"""One run of one benchmark cell of ``seqalib_tpu_torch`` on NVIDIA cards.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration and a traffic mix; the run makes the traffic's pool of pairs
from ``--seed``, builds the port's kernels (``seqalib_tpu_torch/_build/``,
inside the checkout), warms up with every batch of the pool and for
``WARMUP_S`` seconds in all, then calls the port's public entry point in a
closed loop of one client for ``--seconds``: each call starts when the last
returned, with its answers on the host.
``--trace 0`` prints the end-to-end metrics; ``--trace 1`` runs the same
window under ``torch.profiler`` and prints the per-layer metrics, read from
the trace in memory by ``metrics/<name>.py``.

After the window the answers of the pairs that ``generate.check_sample``
draws from the seed, in every call, are compared with the plain NumPy
reference (``reference.py``); ``correct`` holds when none differs and no
call failed.  The last line of standard output is one JSON object; the
numbers compared, with their limits, are the last lines of standard error.
A run exits non-zero and prints no result without enough CUDA cards, or if
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402

import cells  # noqa: E402
import drive  # noqa: E402
import generate  # noqa: E402
import reference  # noqa: E402
import spans  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "seqalib_tpu")
WARMUP_S = 5.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``seqalib_tpu_torch`` is not ``seqalib_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def require_cards(chips: int):
    """The first CUDA device, or exit 2 when fewer than ``chips`` exist."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"benchmark: the cell needs {chips} CUDA card(s), found {n}")
        sys.exit(2)
    return torch.device("cuda:0")


def card(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        limit = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "power_limit_w": limit}


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float = T_START):
    """One run; returns (result, compared), where ``compared`` is {name:
    (value, limit)}."""
    import torch

    import seqalib_tpu_torch as st

    build_s = None
    if device.type == "cuda":
        from seqalib_tpu_torch import _build

        t0 = time.perf_counter()
        built = _build.build()
        build_s = time.perf_counter() - t0
        _build.lib()
        log(f"benchmark: kernel build {build_s:.3f} s ({'compiled' if built else 'cached'})")
    request = cell.traffic["request"]
    sc = cells.scoring(cell.config, int(cell.traffic["alphabet"]), cell.bench_dir)
    batches = generate.pool(seed, cell.traffic)
    index = drive.pairs(request, *generate.sizes(cell.traffic))
    sample = generate.check_sample(seed, cell.traffic, len(index))
    call = drive.make_call(st, sc, cell.config, request, device)
    # every batch of the pool once (every shape the window uses), then calls
    # until WARMUP_S have passed: a window's first seconds of calls ran ~10%
    # slower than the rest on the card's machine while host and card settle
    w0, k = time.perf_counter(), 0
    while k < len(batches) or time.perf_counter() - w0 < WARMUP_S:
        call(*batches[k % len(batches)])
        k += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    cells_of = [drive.call_cells(sc.band, qs, ts, index) for qs, ts in batches]
    work_of = [{"pairs": [(len(qs[i]), len(ts[j])) for i, j in index], "band": sc.band,
                "traceback": request["answers"] == "alignment"}
               for qs, ts in batches]
    sampled = {}
    for b, p in sample:
        sampled.setdefault(b, []).append(p)
    walls, works, answers = [], [], []  # answers: (batch, pair, answer)
    done_cells, attempted, failed = 0, 0, 0
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    k, out = 0, None
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        b = k % len(batches)
        qs, ts = batches[b]
        t0 = time.perf_counter()
        with torch.profiler.record_function(spans.CALL_SPAN):
            try:
                out = call(qs, ts)
            except Exception as ex:  # a failed call: its pairs count as failed
                log(f"benchmark: call {k} failed: {type(ex).__name__}: {ex}")
                out = None
        walls.append(time.perf_counter() - t0)
        works.append(work_of[b])
        attempted += len(index)
        if out is None or len(out) != len(index):
            failed += len(index)
        else:
            done_cells += cells_of[b]
        for p in sampled.get(b, []):
            answers.append((b, p, out[p] if out is not None and p < len(out) else None))
        k += 1
    window_s = time.perf_counter() - w0
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del call, out
    if device.type == "cuda":
        torch.cuda.empty_cache()

    if trace:
        window = spans.window_from_events(prof.profiler.kineto_results.events(), works)
        del prof
        metrics = {}
        for m in cell.per_layer:
            v = cells.reader(m["name"])(window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy = spans.union_ns([(s, e) for _, s, e in window.ops]) / 1e9
        extra = {"busy_s": busy, "window_s": window.seconds}
        brk = spans.breakdown(window)
    else:
        # an end-to-end metric is one of these, perhaps split by a suffix
        # (``gcups.sp``) so that a family of cells has a bound of its own
        values = {"gcups": done_cells / window_s / 1e9,
                  "call_p95_ms": float(np.percentile(np.array(walls) * 1e3, 95)),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        extra, brk = {}, None

    t0 = time.perf_counter()
    expected = dict(zip(sample, reference.for_cell(
        sc, request, [batches[b][0][index[p][0]] for b, p in sample],
        [batches[b][1][index[p][1]] for b, p in sample])))
    wrong = sum(not drive.same(a, expected[(b, p)]) for b, p, a in answers)
    log(f"benchmark: reference of {len(sample)} pairs {time.perf_counter() - t0:.3f} s; "
        f"{len(walls)} calls, {len(answers)} answers compared")
    compared = {"wrong": (wrong, 0)}
    correct = bool(answers) and failed == 0 and all(v <= lim for v, lim in compared.values())
    dev = card(device)
    dev["memory_peak_bytes"] = int(peak)
    dev.update(extra)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if brk is not None:
        result["breakdown"] = brk
    log(f"benchmark: {cell.name} seed {seed}: {len(walls)} calls in {window_s:.3f} s, "
        f"setup {setup_s:.3f} s" + (f", build {build_s:.3f} s" if build_s is not None else ""))
    fifths = [float(np.median(x)) * 1e3 for x in np.array_split(np.array(walls), 5) if len(x)]
    log(f"benchmark: call ms min {min(walls) * 1e3:.3f} median {np.median(walls) * 1e3:.3f} "
        f"max {max(walls) * 1e3:.3f}; median of each fifth of the window "
        + " ".join(f"{x:.3f}" for x in fifths))
    return result, compared


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    device = require_cards(cell.chips)
    sys.path.insert(0, str(ROOT))
    result, compared = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        log(f"benchmark: JAX or the JAX package was loaded: {bad}")
        return 3
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        log(f"check {k} {v} limit {lim}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
