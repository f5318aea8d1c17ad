"""Headline benchmark of the port: GCUPS of batched 1 kb affine-gap
Smith-Waterman, score and start/end coordinates, on one device.

    python -m seqalib_tpu_torch.bench [--device cuda|cpu]

B (``BENCH_B``, default 512) BLOSUM62 protein pairs of L x L letters
(``BENCH_L``, default 1024), o=-10, e=-1 (``ScoringParams.blosum62()``),
seed 0, the letters already on the device.  The timed work is passes 1-2
of the strip engine (``ops.strip.local_fused``: the end-only local fill,
the canonical-end reduce, the reversed windows and the pass-2 reverse
extension, the launch half of a local ``strip_bucket`` without its
traceback), timed call by call with CUDA events over ``BENCH_REPS`` warm
calls (at least 10); GCUPS = B * L * L / the median call.

Prints one JSON line: ``metric`` (it names the device), ``value`` (GCUPS),
``unit``, ``pairs_per_sec``, ``escalated`` (pairs whose pass-2 score missed
the pass-1 score: their starts would come from the slower host rescan, so
a run with any is tagged INVALID-HEADLINE) and the parity of the timed
call's score and coordinates against the oracle on the first pairs.  Exits
1 when a pair disagrees with the oracle.  A failure raises: there is no
fallback to a cheaper metric.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

PARITY_PAIRS = 16  # pairs held to the oracle (about 0.5 s each on a host core)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="seqalib_tpu_torch.bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from .devices import as_device
    from .ops import strip
    from .ops.row_window import error_words, raise_on_error
    from .ops.strip_fill import raise_on_bad_length
    from .oracle_fast import align_oracle
    from .scoring import tables_from_params
    from .types import ScoringParams

    dev = as_device(args.device)
    B = int(os.environ.get("BENCH_B", "512"))
    L = int(os.environ.get("BENCH_L", "1024"))
    reps = max(10, int(os.environ.get("BENCH_REPS", "10")))

    sp = ScoringParams.blosum62()
    rng = np.random.default_rng(0)
    q = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    t = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    lens = np.full(B, L, np.int64)
    tables = tables_from_params(sp, dev)
    qpad, t2, qlen, _ = strip.stage_strip(q, t, lens, lens, tables.A1, dev)
    knobs = strip.pass2_knobs()

    def call():
        return strip.local_fused(qpad, t2, qlen, qlen, tables, mq=L, WR=knobs["WR"],
                                 pass2=knobs["pass2"], tie_safe=knobs["tie_safe"],
                                 err=error_words(5, dev), BW=knobs["BW"])

    out = {k: v.cpu().numpy() for k, v in call().items()}  # warm-up, and the checked call
    raise_on_error(out["row_err"][:4], (qpad.shape[1], t2.shape[1]) * 2)
    raise_on_bad_length(out["row_err"][4])
    escalated = int(((out["score2"] != out["score"]) & (out["score"] > 0)).sum())

    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
    per_call = statistics.median(times)

    n_check = min(PARITY_PAIRS, B)
    equal = 0
    for b in range(n_check):
        ref = align_oracle(q[b], t[b], sp, mode="local")
        equal += (int(out["score"][b]), int(out["qs"][b]), int(out["qe"][b]),
                  int(out["ts"][b]), int(out["te"][b])) == (
            ref.score, ref.query_start, ref.query_end, ref.target_start, ref.target_end)

    coords = "start+end(2pass)"
    if escalated:
        print(f"WARNING: {escalated}/{B} pairs escalated past the pass-2 window; "
              "this run is not a headline candidate", file=sys.stderr)
        coords = f"start+end(2pass,{escalated}esc,INVALID-HEADLINE)"
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({
        "metric": f"GCUPS sw-affine-blosum62-{L}x{L} B={B} coords={coords} ({name})",
        "value": round(B * L * L / per_call / 1e9, 3),
        "unit": "GCUPS",
        "pairs_per_sec": round(B / per_call, 1),
        "escalated": escalated,
        "parity_pairs": n_check,
        "parity_equal": equal,
    }))
    return 0 if equal == n_check else 1


if __name__ == "__main__":
    sys.exit(main())
