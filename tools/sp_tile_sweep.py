#!/usr/bin/env python3
"""Time the sequence-parallel tile kernel (``ops.sp_tile.sp_tile_run``) on
one card over row counts and strip heights, to split a sweep's time into
the cost of one substep and the lag of one strip behind the strip above.

    python3 tools/sp_tile_sweep.py [--cols 16384] [--calls 5] [--ablate]

Each run is one global-mode launch of R rows x ``--cols`` columns (tiles
of 256; DNA letters, match 2, mismatch -3, o=-5, e=-2, random boundaries,
seed 0), timed with CUDA events over ``--calls`` launches after a warm-up.
For each strip height RB it prints the time and, from the runs of one
strip (R = RB: no hand-off) and of many, the ns per substep of a lone strip
and the substeps each further strip adds.  ``--ablate`` instead builds
variants of ``seqalib_tpu_torch/csrc/sp_tile.cu`` (one ``nvcc`` each, all
started together) with one piece of a substep's work removed (values not
kept) and times a lone strip of 64 rows and a run of 16 384 rows with
each.  The card's name and power limit come first; the last line is a
JSON summary.  Needs a CUDA card.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from kernel_variants import build_variants as build_variants_of  # noqa: E402
from kernel_variants import card_line, time_ms  # noqa: E402
from seqalib_tpu_torch import _build  # noqa: E402
from seqalib_tpu_torch.ops.sp_tile import NEG, sp_tile_run  # noqa: E402

OUT = _build.BUILD_DIR / "sp_tile_ablation"
# variant -> (text replaced, replacement): one piece of a substep removed
ABLATIONS = {
    "shipped": None,
    "no_barrier": ("    __syncthreads();  // the substep is complete before the next reads it\n", ""),
    "no_bottom_row": ("        dn_h[c - 1] = H;\n        dn_f[c - 1] = F;\n", ""),
    "no_columns": ("        a.hcols[o + r] = H;\n        a.ecols[o + r] = E;\n", ""),
    "no_capture": ("      if (MODE == kTileLocal ? c <= cap_c : c == cap_c) best = max(best, H);\n",
                   ""),
    "bounds_256": ("__launch_bounds__(kMaxRB)", "__launch_bounds__(256)"),
    "no_unroll": ("#pragma unroll 2", "#pragma unroll 1"),
    "no_letters": ("    tc = letters[(k + 2 - p) & (kRing - 1)];  // the next substep's\n",
                   "    tc = 0;\n"),
}


def build_variants():
    """One nvcc per variant, all started together."""
    src = (_build.CSRC / "sp_tile.cu").read_text()
    for name, rep in ABLATIONS.items():
        if rep is not None:
            assert rep[0] in src, name
    return build_variants_of({name: {"sp_tile.cu": src if rep is None else src.replace(*rep)}
                              for name, rep in ABLATIONS.items()}, OUT)


def run_ms(R, W, strip, calls, dev, C=256):
    rng = np.random.default_rng(0)
    i32 = dict(dtype=torch.int32, device=dev)
    qb = torch.as_tensor(rng.integers(0, 4, R), **i32)
    tk = torch.as_tensor(rng.integers(0, 4, W + 1), **i32)
    htop = torch.as_tensor(np.abs(rng.integers(-60, 40, W + 1)), **i32)
    hcol = torch.as_tensor(np.abs(rng.integers(-60, 40, R)), **i32)
    cap = torch.full((1,), NEG, **i32)
    args = (qb, tk, htop, htop[1:] - 3, hcol, hcol - 5, cap, None)
    kw = dict(i0=0, j0=0, n=R, m=W, C=C, match=2, mismatch=-3, gap_open=-5, gap_extend=-2,
              mode="global", strip=strip)
    return time_ms(lambda: sp_tile_run(*args, **kw), calls)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cols", type=int, default=16384)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sp_tile_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    W = args.cols
    rows = []
    if args.ablate:
        for name, lib in build_variants().items():
            _build._lib = lib
            for R in (64, 16384):
                ms = run_ms(R, W, 64 if R == 64 else 0, args.calls, dev)
                print(f"[ablation] {name:14s} R {R:5d} x {W}: {ms:.4f} ms", flush=True)
                rows.append(dict(variant=name, R=R, W=W, ms=ms))
        print(json.dumps({"device": torch.cuda.get_device_name(0), "ablation": rows}))
        return 0
    for strip in (64, 128, 256, 512):
        one = run_ms(strip, W, strip, args.calls, dev)
        sub_ns = one * 1e6 / (strip + W - 1)  # a lone strip: RB + W - 1 substeps
        for R in (strip, 1024, 4096, 16384):
            ms = run_ms(R, W, strip, args.calls, dev)
            n = -(-R // strip)
            # substeps each further strip adds, at a lone strip's rate
            lag = (ms * 1e6 / sub_ns - (strip + W - 1)) / max(1, n - 1)
            print(f"strip {strip} R {R} ({n} CTAs) x {W}: {ms:.4f} ms; lone strip "
                  f"{sub_ns:.1f} ns per substep; {lag:.0f} substeps per further strip",
                  flush=True)
            rows.append(dict(strip=strip, R=R, W=W, ctas=n, ms=ms, substep_ns=sub_ns,
                             lag_substeps=lag))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
