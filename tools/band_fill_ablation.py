#!/usr/bin/env python3
"""Where a ``band_fill`` diagonal's time goes, by ablation, on one GPU.

    python3 tools/band_fill_ablation.py [--baseline NAME=PATH ...]

Builds variants of ``seqalib_tpu_torch/csrc/band_fill.cu`` (one ``nvcc``
each, all started together) and times each through the port's wrapper
(``ops.band_fill.band_fill``) at the main paths' shapes:

* ``config4_fill`` / ``config4_ptr``: B=64 DNA pairs of 10 kb, band 128
  (Wp 256), fill mode with checkpoints on diagonals [0, 4096), pointer mode
  on [4096, 8192);
* ``relay_fill``: B=8 pairs of 100 kb, band 256 (Wp 384), fill mode on
  [0, 4096) resumed from a boundary row, with the capture of row 1000;
* ``emode``: B=512 BLOSUM62 pairs, Wp 128, 1152 diagonals (local
  alignment's pass 2);
* ``wide_fill``: B=64, Wp 1152, fill mode on [0, 2048).

Variants: ``shipped`` (the source as it is); ``S2`` / ``S4`` (2 or 4 slots
per thread from Wp 129 on); ``no_barrier`` (the per-diagonal
``__syncthreads`` removed: wrong values, the barrier's cost); ``no_letters``
(every letter read as 0: wrong values, the letter loads' cost); and, with
``--baseline NAME=PATH``, other ``band_fill.cu`` files with the same C
interface (for example the parent commit's).  A variant that keeps the values must equal
``shipped`` on every output, or the script fails.  ``--only NAME ...``
builds and times those variants alone, and ``--rounds N`` times them in
turns, N rounds with the order swapped each round (``--shapes`` picks the
shapes).  Prints the card's name and power limit, one line per variant
and shape (ms per call, µs per anti-diagonal; per round with
``--rounds``), and a JSON summary as the last line.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from kernel_variants import build_variants, card_line, time_ms  # noqa: E402
from seqalib_tpu_torch import BLOSUM62, _build  # noqa: E402
from seqalib_tpu_torch.ops import band_fill as bf_mod  # noqa: E402
from seqalib_tpu_torch.types import NEG_INF  # noqa: E402

OUT = ROOT / "chiprun_out" / "band_fill_ablation"
REPS = 5  # timed calls per variant and shape, after one warm-up
SLOTS_LINE = "  if (a.Wp <= kMaxThreads) return launch_s<MODE, 1>(a, stream);"


def variants(baselines):
    src = (_build.CSRC / "band_fill.cu").read_text()
    assert SLOTS_LINE in src and "fetch(k + 1, ihn);" in src
    out = {
        "shipped": (src, True),
        "S2": (src.replace(SLOTS_LINE, "  if (a.Wp <= 128) return launch_s<MODE, 1>(a, stream);\n"
                           "  if (a.Wp <= 1024) return launch_s<MODE, 2>(a, stream);"), True),
        "S4": (src.replace(SLOTS_LINE, "  if (a.Wp <= 128) return launch_s<MODE, 1>(a, stream);\n"
                           "  if (a.Wp <= 2048) return launch_s<MODE, 4>(a, stream);"), True),
        "no_barrier": (src.replace(
            "    __syncthreads();  // the diagonal's edges are out", "    //"), False),
        "no_letters": (src.replace("(unsigned)__ldg(qb + i)", "0u")
                       .replace("(unsigned)__ldg(tb + j)", "0u"), False),
    }
    for spec in baselines:
        name, path = spec.split("=", 1)
        out[name] = (Path(path).read_text(), True)
    return out


def build_all(srcs):
    """One nvcc per variant, all started together."""
    return build_variants({name: {"band_fill.cu": text} for name, (text, _) in srcs.items()},
                          OUT)


def case(rng, dev, *, B, L, band, Wp, alpha, table, k0, k1, mode, **extra):
    """Letters and state of B pairs of length L (the target the query with
    2% substitutions), band ``band``: the arguments of one call."""
    q = rng.integers(0, alpha, size=(B, L))
    t = q.copy()
    sub = rng.random((B, L)) < 0.02
    t[sub] = (t[sub] + 1) % alpha
    qk = np.full((B, L + 1), alpha, np.int64)
    tk = np.full((B, L + 1), alpha + 1, np.int64)
    qk[:, 1:], tk[:, 1:] = q, t
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)  # noqa
    vecs = [as_t(np.full(B, v)) for v in (L, L, -band, band)]
    ns = bf_mod.n_state(mode)
    state = torch.full((ns, B, Wp), NEG_INF, dtype=torch.int32, device=dev)
    if mode == "emode":
        state[5] = 0
    score = torch.full((B, Wp), NEG_INF, dtype=torch.int32, device=dev)
    tab = as_t(bf_mod.band_table(table, -4))
    args = (as_t(qk), as_t(tk), *vecs, state, score, tab)
    kw = dict(k0=k0, k1=k1, K=2 * L + 1, dlo=-band, dhi=band, gap_open=-5, gap_extend=-2,
              mode=mode, **extra)
    return args, kw


def cases(dev):
    rng = np.random.default_rng(0)
    dna = np.where(np.eye(4, dtype=bool), 2, -3)
    out = {
        "config4_fill": case(rng, dev, B=64, L=10_000, band=128, Wp=256, alpha=4,
                             table=dna, k0=0, k1=4096, mode="fill", CK=512),
        "config4_ptr": case(rng, dev, B=64, L=10_000, band=128, Wp=256, alpha=4,
                            table=dna, k0=4096, k1=8192, mode="ptr"),
        "emode": case(rng, dev, B=512, L=1024, band=64, Wp=128, alpha=20, table=BLOSUM62,
                      k0=0, k1=1152, mode="emode", tie_safe=True, smax=11),
        # config 3's pass 2 as the main path calls it (tie_safe off)
        "emode_config3": case(rng, dev, B=512, L=1024, band=64, Wp=128, alpha=20,
                              table=BLOSUM62, k0=0, k1=1152, mode="emode"),
        "wide_fill": case(rng, dev, B=64, L=10_000, band=1000, Wp=1152, alpha=4, table=dna,
                          k0=0, k1=2048, mode="fill"),
    }
    bh = torch.as_tensor(-5 - 2 * np.arange(768)[None, :].repeat(8, 0), dtype=torch.int32,
                         device=dev)
    out["relay_fill"] = case(rng, dev, B=8, L=100_000, band=256, Wp=384, alpha=4, table=dna,
                             k0=0, k1=4096, mode="fill", bh=bh, bf=bh - 3, want_bout=True,
                             bout_row=1000)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", nargs="*", default=[], metavar="NAME=PATH",
                    help="other band_fill.cu files with the same C interface")
    ap.add_argument("--only", nargs="*", default=None, metavar="NAME",
                    help="build and time these variants alone (shipped first)")
    ap.add_argument("--shapes", nargs="*", default=None, metavar="SHAPE")
    ap.add_argument("--rounds", type=int, default=1, help="rounds in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("band_fill_ablation: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    srcs = variants(args.baseline)
    if args.only is not None:
        srcs = {k: v for k, v in srcs.items() if k == "shipped" or k in args.only}
    libs = build_all(srcs)
    shapes = cases(dev)
    if args.shapes is not None:
        shapes = {k: v for k, v in shapes.items() if k in args.shapes}
    ref, rows = {}, []
    for name in srcs:
        _build._lib = libs[name]
        for shape, (a, kw) in shapes.items():
            got = bf_mod.band_fill(*a, **kw)
            torch.cuda.synchronize()
            if name == "shipped":
                ref[shape] = got
            elif srcs[name][1]:
                for key, v in ref[shape].items():
                    if not torch.equal(got[key], v):
                        raise AssertionError(f"{name} {shape}: {key} differs from shipped")
    names = list(srcs)
    for r in range(args.rounds):
        for shape, (a, kw) in shapes.items():
            for name in (names if r % 2 == 0 else names[::-1]):
                _build._lib = libs[name]
                ms = time_ms(lambda: bf_mod.band_fill(*a, **kw), REPS)
                us = ms * 1e3 / (kw["k1"] - kw["k0"])
                Wp = a[6].shape[2]
                print(f"[ablation] round {r + 1} {name:10s} {shape:13s} Wp {Wp:5d} B "
                      f"{a[6].shape[1]:4d}: {ms:8.4f} ms, {us:.4f} µs per anti-diagonal"
                      + ("" if srcs[name][1] else " (values not kept)"), flush=True)
                rows.append({"variant": name, "shape": shape, "round": r + 1, "Wp": Wp,
                             "ms": ms, "us_per_diagonal": us, "exact": srcs[name][1]})
    if args.rounds > 1:
        for shape in shapes:
            spans = {n: [x["ms"] for x in rows if x["variant"] == n and x["shape"] == shape]
                     for n in names}
            print(f"[turns] {shape}: " + "; ".join(f"{n} {min(v):.4f}-{max(v):.4f} ms"
                                                   for n, v in spans.items()), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
