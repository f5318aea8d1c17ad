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
each.  ``--parent DIR`` instead builds ``DIR``'s ``sp_tile.cu`` (another
checkout, e.g. ``git archive`` of the parent commit unpacked under
``_checkout/``) beside this tree's, records the tile calls of
``chip_smoke.py``'s SP phase (its pairs and calls: ``align_sp`` 10 240 x
8 192, the local score of 16 384 x 16 381, the 1 536-letter pair as one
tile) and times each call with both libraries in turns over ``--rounds``
rounds (the order swapped each round), every sentinel input at the
library's own value (``NEG`` of each tree's ``ops/sp_tile.py``), and the
two outputs held equal.  The card's name and power limit come first; the
last line is a JSON summary.  Needs a CUDA card.
"""

import argparse
import json
import re
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


def path_calls(dev):
    """{key: (fn, args, kw)}: the first call of each ``sp_tile`` key in
    ``chip_smoke.py``'s SP phase, whole, and ``key cut`` for the three keys
    that phase holds to the plain version on a cut (its first rows and
    tiles), as it cuts them."""
    import chip_smoke as cs
    from seqalib_tpu_torch import ScoringParams
    from seqalib_tpu_torch.ops import sp_tile as tile_mod
    from seqalib_tpu_torch.parallel import band_pipeline as bp_mod

    q, t, q16, t16, qo, to = cs.sp_pairs(np.random.default_rng(cs.SEED))
    sp = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
    targets = [(bp_mod, "sp_tile_run", tile_mod.sp_tile_run_ref),
               (bp_mod, "sp_tile_ptr", tile_mod.sp_tile_ptr_ref)]
    mesh = (dev,)
    calls = {}
    for run in (lambda: bp_mod.nw_affine_align_sp(q, t, sp, mesh, C=cs.SP_C),
                lambda: bp_mod.sw_affine_score_sp(q16, t16, sp, mesh, C=cs.SP_C),
                lambda: bp_mod.nw_affine_align_sp(qo, to, sp, mesh, C=cs.SP_ONE_C),
                lambda: bp_mod.sw_affine_score_sp(qo, to, sp, mesh, C=cs.SP_ONE_C)):
        more, _ = cs.record(run, targets)
        calls.update({k: (fn, args, kw) for k, (fn, _, args, kw, _) in more.items()
                      if k not in calls})
    Rc = cs.SP_CUT_ROWS
    for key in ("sp_tile/run_global", "sp_tile/run_local", "sp_tile/ptr_batch"):
        fn, args, kw = calls[key]
        qb, tk, htop, ftop, hcol, ecol, cap, tab = args
        C = kw["C"]
        if key == "sp_tile/ptr_batch":
            K = htop.shape[0]
            Kc = min(K, cs.SP_CUT_BATCH)
            cut = (qb[:Rc], tk[(K - Kc) * C:], htop[:Kc], ftop[:Kc], hcol[:Kc, :Rc],
                   ecol[:Kc, :Rc], cap, tab)
        else:
            W = cs.SP_CUT_TILES * C
            cut = (qb[:Rc], tk[:W + 1], htop[:W + 1], ftop[:W], hcol[:Rc], ecol[:Rc], cap,
                   tab)
        calls[f"{key} cut"] = (fn, cut, kw)
    return calls


def parent_turns(parent, rounds, calls_per_round, dev):
    """Each SP-phase tile call with ``parent``'s kernel and this tree's, in
    turns; returns {key: {"parent": [ms], "this": [ms]}}."""
    src = Path(parent) / "seqalib_tpu_torch" / "csrc" / "sp_tile.cu"
    text = (Path(parent) / "seqalib_tpu_torch" / "ops" / "sp_tile.py").read_text()
    parent_neg = -(1 << int(re.search(r"^NEG = -\(1 << (\d+)\)", text, re.M).group(1)))
    libs = build_variants_of({"parent": {"sp_tile.cu": src.read_text()},
                              "this": {"sp_tile.cu": (_build.CSRC / "sp_tile.cu").read_text()}},
                             _build.BUILD_DIR / "sp_tile_parent")
    negs = {"parent": parent_neg, "this": NEG}
    calls = path_calls(dev)

    def with_neg(args, neg):  # the sentinel inputs at the library's own value
        return tuple(torch.where(x == NEG, neg, x) if torch.is_tensor(x) and x.dtype ==
                     torch.int32 else x for x in args)

    times = {key: {"parent": [], "this": []} for key in calls}
    for key, (fn, args, kw) in calls.items():
        outs = {}
        for name in ("parent", "this"):
            _build._lib = libs[name]
            outs[name] = fn(*with_neg(args, negs[name]), **kw)
        for k, v in outs["parent"].items():  # a capture no cell took is the sentinel
            if v.dtype == torch.int32:
                v = torch.where(v == parent_neg, NEG, v)
            if not torch.equal(outs["this"][k], v):
                raise AssertionError(f"{key}: {k} differs between the two kernels")
    for r in range(rounds):
        order = ("parent", "this") if r % 2 == 0 else ("this", "parent")
        for key, (fn, args, kw) in calls.items():
            for name in order:
                _build._lib = libs[name]
                a = with_neg(args, negs[name])
                times[key][name].append(time_ms(lambda: fn(*a, **kw), calls_per_round))
        print(f"[turns] round {r + 1}: " + "; ".join(
            f"{k} {v['parent'][-1]:.4f} / {v['this'][-1]:.4f}" for k, v in times.items()),
            flush=True)
    for key, v in times.items():
        wins = sum(b < a for a, b in zip(v["parent"], v["this"]))
        print(f"[turns] {key}: parent {min(v['parent']):.4f}-{max(v['parent']):.4f} ms, this "
              f"{min(v['this']):.4f}-{max(v['this']):.4f} ms; this faster in {wins} of "
              f"{rounds} rounds", flush=True)
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cols", type=int, default=16384)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--parent", help="another checkout: its sp_tile kernel in turns with "
                    "this tree's at the SP phase's calls")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sp_tile_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    W = args.cols
    rows = []
    if args.parent:
        times = parent_turns(args.parent, args.rounds, args.calls, dev)
        print(json.dumps({"device": torch.cuda.get_device_name(0), "turns": times}))
        return 0
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
