#!/usr/bin/env python3
"""Smoke run of seqalib_tpu_torch, the PyTorch + CUDA port, on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. build the CUDA kernels from ``seqalib_tpu_torch/csrc`` and print the
   card's name and power limit;
2. compare every kernel with its plain PyTorch version, exactly, on the
   inputs the main path gives it (B=512 BLOSUM62 pairs of 1024 x 1024),
   and time both;
3. config 3, the main path: ``align_batch`` local, BLOSUM62 o=-10 e=-1,
   full CIGAR, B=512 pairs of 1024 x 1024, warm wall time, pairs/s and
   GCUPS; 32 pairs checked against the oracle;
4. config 1: global linear-gap DNA, B=512 pairs of 256 x 256, checked the
   same way;
5. every kernel of the main path was launched during config 3's runs
   (1 warm-up + 3 timed ``align_batch`` calls).

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  The script imports only the
port, NumPy and PyTorch, never JAX: the oracle it checks against is the
port's ``backend="oracle"``.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
B = 512
REPS = 3
N_ORACLE = 32
TPU_KERNELS = "seqalib_tpu/ops/strip_pallas.py"
KERNELS = {  # launch-counter key -> (CUDA source, replaced Pallas kernel)
    "row_window": ("row_window.cu", f"{TPU_KERNELS}:157"),
    "strip_fill/local": ("strip_fill.cu", f"{TPU_KERNELS}:230"),
    "strip_fill/emode": ("strip_fill.cu", f"{TPU_KERNELS}:230"),
    "strip_fill/gmode": ("strip_fill.cu", f"{TPU_KERNELS}:230"),
    "strip_walk": ("strip_walk.cu", f"{TPU_KERNELS}:2022"),
}


def say(*args):
    print(*args, flush=True)


def _flat(x):
    if isinstance(x, dict):
        return [x[k] for k in sorted(x)]
    if isinstance(x, (tuple, list)):
        return list(x)
    return [x]


def max_abs_err(a, b) -> int:
    err = 0
    for x, y in zip(_flat(a), _flat(b), strict=True):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def time_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel(name, kernel, plain):
    """Kernel and plain version on the same inputs: exact equality, then
    both timed per call (wrapper included)."""
    import torch

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain version by {err}")
    ms = time_ms(kernel, 5)
    plain_ms = time_ms(plain, 1)
    say(f"[kernel] {name}: equal to plain version; {ms:.3f} ms vs plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def kernel_phase(q, t, sp, dev):
    """Record the first call of each kernel (and fill mode) that the main
    path makes on (q, t), then run each recorded call through the kernel
    and through its plain version.  Returns the per-kernel results and the
    number of pairs whose start escalated."""
    from seqalib_tpu_torch.ops import strip as strip_mod
    from seqalib_tpu_torch.ops.row_window import row_window_ref
    from seqalib_tpu_torch.ops.strip_fill import strip_fill_ref
    from seqalib_tpu_torch.ops.strip_walk import strip_walk_ref
    from seqalib_tpu_torch.scoring import tables_from_params

    plain = {"row_window": row_window_ref, "strip_fill": strip_fill_ref,
             "strip_walk": strip_walk_ref}
    calls = {}

    def recording(name, fn):
        def wrapped(*args, **kw):
            key = f"{name}/{kw['mode']}" if name == "strip_fill" else name
            calls.setdefault(key, (fn, plain[name], args, kw))
            return fn(*args, **kw)
        return wrapped

    originals = {name: getattr(strip_mod, name) for name in plain}
    for name, fn in originals.items():
        setattr(strip_mod, name, recording(name, fn))
    try:
        n = np.full(len(q), q.shape[1])
        m = np.full(len(t), t.shape[1])
        out = strip_mod.strip_bucket(q, t, n, m, tables_from_params(sp, dev),
                                     mode="local", want_tb=True)
    finally:
        for name, fn in originals.items():
            setattr(strip_mod, name, fn)
    per_kernel = {
        key: check_kernel(key, lambda: fn(*args, **kw), lambda: ref(*args, **kw))
        for key, (fn, ref, args, kw) in calls.items()
    }
    return per_kernel, int(out["escalated"].sum())


def config_run(name, qs, ts, sp, mode, dev):
    """Warm ``align_batch`` runs: times, rates and an oracle check."""
    import torch

    import seqalib_tpu_torch as st

    run = lambda: st.align_batch(qs, ts, scoring=sp, mode=mode, traceback=True,
                                 device=dev)
    run()  # warm-up
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    cells = sum(len(a) * len(b) for a, b in zip(qs, ts))
    say(f"[{name}] B={len(qs)} {mode} wall {wall:.4f} s (reps {walls}); "
        f"{len(qs) / wall:.1f} pairs/s; {cells / wall / 1e9:.3f} GCUPS")
    picks = np.random.default_rng(SEED + 1).choice(len(qs), N_ORACLE, replace=False)
    want = st.align_batch([qs[b] for b in picks], [ts[b] for b in picks], scoring=sp,
                          mode=mode, backend="oracle")
    for b, w in zip(picks, want):
        if str(res[b]) != str(w):
            raise AssertionError(f"{name} pair {b}: {res[b]} != oracle {w}")
    say(f"[{name}] {N_ORACLE}/{N_ORACLE} pairs equal to the oracle")
    return res, wall


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from seqalib_tpu_torch import ScoringParams, _build
    from seqalib_tpu_torch.ops import launches, reset_launches

    dev = torch.device("cuda")
    say(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    out = _build.build(ptxas_verbose=True)
    say(f"[build] {time.perf_counter() - t0:.2f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("[build]", line.strip())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    say(card)

    rng = np.random.default_rng(SEED)
    sp3 = ScoringParams.blosum62(gap_open=-10, gap_extend=-1)
    q3 = rng.integers(0, 20, size=(B, 1024)).astype(np.uint8)
    t3 = rng.integers(0, 20, size=(B, 1024)).astype(np.uint8)
    per_kernel, escalated = kernel_phase(q3, t3, sp3, dev)
    say(f"[config3] escalated pairs: {escalated}/{B}")

    qs3, ts3 = list(q3), list(t3)
    reset_launches()
    config_run("config3", qs3, ts3, sp3, "local", dev)
    counts = dict(launches)

    sp1 = ScoringParams.linear()
    q1 = rng.integers(0, 4, size=(B, 256)).astype(np.uint8)
    t1 = rng.integers(0, 4, size=(B, 256)).astype(np.uint8)
    config_run("config1", list(q1), list(t1), sp1, "global", dev)

    say(f"[launches] config3 runs (1 warm-up + 3 timed): {counts}")
    missing = [k for k in KERNELS if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("JAX was imported")

    kernels = [
        {"name": k, "route": "cuda", "source": f"seqalib_tpu_torch/csrc/{src}",
         "replaces": rep, "launches": counts[k], **per_kernel[k]}
        for k, (src, rep) in KERNELS.items()
    ]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
