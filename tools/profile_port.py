#!/usr/bin/env python3
"""Where the time of a warm ``seqalib_tpu_torch.align_batch`` call goes.

    python3 tools/profile_port.py [--config 3|1|2|4|4wide|5|sp|wide|banded_sp] [--batch B]
                                  [--calls N] [--device cuda|cpu] [--backend strip|xla]

Inputs are those of ``chip_smoke.py`` (seed 0): config 3 is B=512
BLOSUM62 o=-10 e=-1 local pairs of 1024 x 1024 with full CIGARs, config 1
is B=512 DNA global linear-gap pairs of 256 x 256, config 4 is B=64 DNA
pairs of 10 kb (the target is the query with 2% substitutions) aligned
globally in a band of 128, match 2, mismatch -3, o=-5, e=-2, with full
CIGARs; ``4wide`` is its long window, one 10 kb read against a window
17 000 letters longer (Wp 8 704: ``band_fill``'s wide variant; ``--batch``
is ignored).  Config 2 is B=512 DNA local linear-gap pairs of 512-1024 letters
(``cli.py``'s generator, seed 0), score and coordinates only.  Config 5 is
``align_all_vs_all`` of ``--batch`` reads (default 1 000) of 128-256 letters
against 100 references of 512-1 024 (the generator of ``cli.py``'s config
5), chunks of 8 192 pairs, local, score and coordinates; it runs twice:
as shipped, then with every chunk padded with zero-length pairs the way
the JAX package pins its chunk shapes (a multi-chunk bucket pair's chunks
to the full 8 192 rows, a single chunk to the next power of two), to
measure that padding.  ``sp`` is ``align_sp`` on one 10 240 x 8 192 DNA pair (the
target is the query's first 8 192 letters with 150 substitutions; the
config-4 scoring; tiles of 256 columns) over a mesh of one device, then
``align_score_sp`` global and local on a 16 384 x 16 381 pair (2%
substitutions, a 7-letter deletion, a 5-letter insertion, a 1-letter
deletion; ``--batch`` is ignored); ``wide`` is B=64 protein pairs of 1 000 letters
(5% substitutions, one deletion, one insertion) aligned globally in a
band of 64 under 2 x BLOSUM62, o=-20, e=-2, with full CIGARs: the
full-matrix wavefront route.  ``banded_sp`` is banded sequence
parallelism over a mesh of 4 entries naming the device: first
``align_score_banded_sp`` on B=16 config-4 pairs of 100 kb at band 256 (two
relay groups), then ``align_banded_sp`` on the first of them.  For each
run, after two warm-up calls the script (``--backend xla``: configs 1-4 and
``wide`` through ``align_batch(backend="xla")``, the full-matrix wavefront
route of ``ops/wavefront_xla.py``)

1. times N calls by the host clock (median, all values printed);
2. runs N calls under ``torch.profiler`` and prints each device op's total
   time, the device busy time (union of the device ops' intervals) and the
   busy share = busy time / host wall of the profiled calls;
3. runs one call under ``cProfile`` and prints the host functions with the
   largest cumulative time (cProfile inflates Python time: read the split,
   not the absolute numbers).

On a CUDA card it prints the card's name and power limit first; the last
line is a JSON summary.  ``--device cpu`` with a small ``--batch`` runs the
plain PyTorch versions and checks the script itself.
"""

import argparse
import cProfile
import io
import json
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import seqalib_tpu_torch as st  # noqa: E402
from seqalib_tpu_torch.cli import _synth as synth  # noqa: E402

AVALL_CHUNK = 8192  # config 5: pairs per chunk, as cli.py's --chunk-pairs


def long_reads(rng, batch: int, length: int):
    """Config 4's pairs: the target is the query with length // 50
    substitutions."""
    qs, ts = [], []
    for _ in range(batch):
        q = rng.integers(0, 4, length).astype(np.uint8)
        t = q.copy()
        idx = rng.choice(length, length // 50, replace=False)
        t[idx] = (t[idx] + 1 + rng.integers(0, 3, len(idx))) % 4
        qs.append(q)
        ts.append(t)
    return qs, ts


def pinned(run_bucket, reads, refs, chunk: int):
    """``run_bucket`` with the JAX package's chunk-shape pinning: each
    call padded with zero-length pairs to the full ``chunk`` rows when its
    bucket pair spans several chunks, else to the next power of two (at
    least 8, at most ``chunk``); the result cut back to the real pairs."""
    from seqalib_tpu_torch.parallel.dispatch import bucket_len

    nq, nr = {}, {}
    for s in reads:
        nq[bucket_len(len(s))] = nq.get(bucket_len(len(s)), 0) + 1
    for s in refs:
        nr[bucket_len(len(s))] = nr.get(bucket_len(len(s)), 0) + 1

    def run(q, t, qlen, tlen, *args, **kw):
        B = len(q)
        if nq[q.shape[1]] * nr[t.shape[1]] > chunk:
            rows = chunk
        else:
            rows = 8
            while rows < B:
                rows *= 2
            rows = min(rows, chunk)
        pad = rows - B
        q = np.concatenate([q, np.zeros((pad, q.shape[1]), q.dtype)])
        t = np.concatenate([t, np.zeros((pad, t.shape[1]), t.dtype)])
        qlen = np.concatenate([qlen, np.zeros(pad, qlen.dtype)])
        tlen = np.concatenate([tlen, np.zeros(pad, tlen.dtype)])
        finish = run_bucket(q, t, qlen, tlen, *args, **kw)
        return lambda: {k: v[:B] for k, v in finish().items()}

    return run


def inputs(config: str, batch: int):
    rng = np.random.default_rng(0)
    if config == "5":
        sp = st.ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)
        return synth(rng, batch, 256, 256, 4)[0], synth(rng, 100, 1024, 1024, 4)[0], sp, "local"
    if config == "2":
        sp = st.ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)
        return (*synth(rng, batch, 1024, 1024, 4), sp, "local")
    if config == "banded_sp":
        sp = st.ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
        return (*long_reads(rng, batch, 100_000), sp, "global")
    if config == "sp":
        sp = st.ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
        q = rng.integers(0, 4, 10_240).astype(np.int32)
        t = q[:8192].copy()
        idx = rng.choice(8192, 150, replace=False)
        t[idx] = (t[idx] + 1 + rng.integers(0, 3, 150)) % 4
        L = 16_384
        q16 = rng.integers(0, 4, L).astype(np.int32)
        t16 = q16.copy()
        idx = rng.choice(L, L // 50, replace=False)
        t16[idx] = (t16[idx] + 1 + rng.integers(0, 3, len(idx))) % 4
        t16 = np.insert(np.delete(t16, np.arange(L // 4, L // 4 + 7)), L * 9 // 16,
                        rng.integers(0, 4, 5))
        t16 = np.delete(t16, [L * 13 // 16]).astype(np.int32)
        return (q, q16), (t, t16), sp, "global"
    if config == "wide":
        sp = st.ScoringParams(gap_open=-20, gap_extend=-2, matrix=2 * st.BLOSUM62)
        qs, ts = [], []
        for _ in range(batch):
            q = rng.integers(0, 20, 1000).astype(np.uint8)
            t = q.copy()
            idx = rng.choice(1000, 50, replace=False)
            t[idx] = (t[idx] + 1 + rng.integers(0, 19, 50)) % 20
            a, b = sorted(rng.choice(np.arange(50, 950), 2, replace=False))
            t = np.insert(np.delete(t, [a, a + 1, a + 2]), b, rng.integers(0, 20, 2))
            qs.append(q)
            ts.append(t.astype(np.uint8))
        return qs, ts, sp, "global"
    if config == "4":
        sp = st.ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
        return (*long_reads(rng, batch, 10_000), sp, "global")
    if config == "4wide":  # config 4's long window: a 10 kb read, a window 17 000 longer
        sp = st.ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
        t = rng.integers(0, 4, 27_000).astype(np.uint8)
        q = t[8_000:18_000].copy()
        idx = rng.choice(10_000, 200, replace=False)
        q[idx] = (q[idx] + 1 + rng.integers(0, 3, 200)) % 4
        return [q], [t], sp, "global"
    if config == "3":
        sp = st.ScoringParams.blosum62(gap_open=-10, gap_extend=-1)
        alpha, L, mode = 20, 1024, "local"
    else:
        sp, alpha, L, mode = st.ScoringParams.linear(), 4, 256, "global"
    q = rng.integers(0, alpha, size=(batch, L)).astype(np.uint8)
    t = rng.integers(0, alpha, size=(batch, L)).astype(np.uint8)
    return list(q), list(t), sp, mode


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def profile(label: str, run, calls: int, dev) -> dict:
    """Walls, device time per op and busy share of ``calls`` warm calls of
    ``run``, then one call under cProfile; returns the JSON summary."""
    def synced():
        run()
        sync(dev)

    for _ in range(2):
        synced()
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        synced()
        walls.append(time.perf_counter() - t0)
    print(f"[wall] {label}: median {statistics.median(walls) * 1e3:.3f} ms over {walls}",
          flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            synced()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    per_op: dict[str, float] = {}
    intervals = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        per_op[e.name] = per_op.get(e.name, 0.0) + (t - s)
        intervals.append((s, t))
    busy = busy_us(intervals)
    for name, us in sorted(per_op.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[device] {us / calls / 1e3:9.3f} ms/call  {name[:90]}")
    share = busy / prof_wall_us
    print(f"[device] busy {busy / calls / 1e3:.3f} ms/call of "
          f"{prof_wall_us / calls / 1e3:.3f} ms/call wall: busy share "
          f"{share:.4f}, idle share {1 - share:.4f}", flush=True)

    pr = cProfile.Profile()
    pr.enable()
    synced()
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).strip_dirs().sort_stats("cumulative").print_stats(25)
    print(f"[host] {label}: cProfile, one call, by cumulative time:")
    print(buf.getvalue())
    return {
        "run": label, "calls": calls,
        "wall_ms": [w * 1e3 for w in walls],
        "device_busy_ms_per_call": busy / calls / 1e3,
        "profiled_wall_ms_per_call": prof_wall_us / calls / 1e3,
        "busy_share": share,
        "device_ms_per_call": {k: v / calls / 1e3 for k, v in per_op.items()},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("1", "2", "3", "4", "4wide", "5", "sp", "wide",
                                         "banded_sp"),
                    default="3")
    ap.add_argument("--batch", type=int, default=None,
                    help="pairs per call (default 512; 64 for config 4, 16 for banded_sp; "
                    "config 5: reads, default 1000)")
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("strip", "xla"), default="strip")
    args = ap.parse_args()
    if args.batch is None:
        args.batch = {"4": 64, "wide": 64, "banded_sp": 16, "5": 1000}.get(args.config, 512)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    qs, ts, sp, mode = inputs(args.config, args.batch)
    band = {"4": 128, "4wide": 128, "wide": 64, "banded_sp": 256}.get(args.config)
    if args.config == "sp":
        mesh = st.make_band_mesh([dev])
        (q, q16), (t, t16) = qs, ts
        runs = [("sp", lambda: st.align_sp(q, t, sp, mesh, C=256))]
        runs += [(f"sp_score_{m}", lambda m=m: st.align_score_sp(q16, t16, sp, mesh, mode=m,
                                                               C=256))
                 for m in ("global", "local")]
    elif args.config == "5":
        from seqalib_tpu_torch.parallel import dispatch

        real = dispatch.run_bucket
        pin = pinned(real, qs, ts, AVALL_CHUNK)

        def product(run_bucket):
            dispatch.run_bucket = run_bucket
            try:
                return st.align_all_vs_all(qs, ts, scoring=sp, chunk_pairs=AVALL_CHUNK,
                                           device=dev)
            finally:
                dispatch.run_bucket = real

        label = f"config 5 {len(qs)} x {len(ts)}"
        runs = [(label, lambda: product(real)),
                (f"{label}, chunks padded as the JAX package pins them",
                 lambda: product(pin))]
        a, b = product(real), product(pin)
        if any(not np.array_equal(a[f], b[f]) for f in a):
            raise AssertionError("padded chunks changed the product")
    elif args.config == "banded_sp":
        mesh = st.make_band_mesh([dev] * 4)
        runs = [("banded_sp_score", lambda: st.align_score_banded_sp(qs, ts, sp, band, mesh)),
                ("banded_sp_align", lambda: st.align_banded_sp(qs[0], ts[0], sp, band, mesh))]
    else:
        tb = args.config != "2"
        runs = [(f"config {args.config} B={args.batch} backend={args.backend}",
                 lambda: st.align_batch(qs, ts, scoring=sp, mode=mode, band=band,
                                        traceback=tb, backend=args.backend, device=dev))]
    summary = [profile(label, run, args.calls, dev) for label, run in runs]
    print(json.dumps({"config": args.config, "batch": args.batch, "runs": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
