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
* ``wide_fill``: B=64, Wp 1152, fill mode on [0, 2048);
* ``cluster_fill_W`` / ``cluster_ptr_W`` (W 8704, 16384, 32768): the wide
  variant (a thread block cluster a pair), B=1 DNA pair of 40 kb at a band
  that fills Wp W, fill mode on [0, 2048), pointer mode on [2048, 4096):
  config 4's long-window read (Wp 8 704) and wider ones.

Variants: ``shipped`` (the source as it is); ``S2`` / ``S4`` (2 or 4 slots
per thread from Wp 129 on); ``neighbours`` (the cluster kernel's diagonal
closed by per-neighbour mbarriers, a CTA waiting on its two neighbours, in
place of the cluster barrier); ``relaxed_arrive`` (its arrive relaxed, the
edge words ordered by fences in the threads that wrote them);
``no_cluster_barrier`` (the cluster kernel's per-diagonal barrier removed:
wrong values, its cost); ``no_barrier`` (the per-diagonal
``__syncthreads`` removed: wrong values, the barrier's cost); ``no_letters``
(every letter read as 0: wrong values, the letter loads' cost); and, with
``--baseline NAME=PATH``, other ``band_fill.cu`` files with the same C
interface (for example the parent commit's; one without the launch
geometry arguments, as before the cluster variant, is called without them
and given the global scratch its wide variant needs).  A variant that keeps
the values must equal ``shipped`` on every output, or the script fails.
``--only NAME ...`` builds and times those variants alone, and
``--rounds N`` times them in
turns, N rounds with the order swapped each round (``--shapes`` picks the
shapes).  ``--geometries`` instead times the shipped cluster kernel at
Wp 8 704, 16 384 and 32 768, B = 1 and 16, with S = 2, 4, 8 and 16 slots a
thread over 512 threads (fewer where the last CTA would be empty, ``C`` =
ceil(Wp / 512 S) CTAs a pair, up to 16), fill and pointer modes, forced
through the wrapper's ``_geometry``, each against the chosen geometry's
values.  Prints the card's name and power limit, one line per variant
and shape (ms per call, µs per anti-diagonal; per round with
``--rounds``), and a JSON summary as the last line.
"""

import argparse
import json
import re
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
WIDE_WPS = (8704, 16384, 32768)  # the cluster variant's shapes
GEOMETRY_SLOTS = (2, 4, 8, 16)
# no_cluster_barrier: one cluster barrier before the final stores, so that no
# CTA leaves while another still stores into its shared memory
FINAL_STORES = ("#pragma unroll\n  for (int s = 0; s < S; ++s) {\n    const int p = base + s;\n"
                "    if (p < Wp) {\n      a.state[row + p] = h1[s];")
CLUSTER_EXIT = "if constexpr (CLUSTER) {\n    cluster_arrive();\n    cluster_wait();\n  }\n"
# neighbours: per edge word pair an mbarrier (one per side and parity) that
# the neighbour CTA arrives on, remotely, after its store; a __syncthreads for
# the CTA's own edges, and only the two threads that read the other CTAs'
# words wait, so a CTA waits on its two neighbours and not on the whole cluster
MBARRIERS = r"""
__device__ __forceinline__ void mbar_init(uint32_t addr) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(addr) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_remote(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(addr)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}

struct BandArgs {"""
NEIGHBOUR_PATCH = (
    ("\nstruct BandArgs {", MBARRIERS),
    # 4 mbarriers ([parity][left, right], 8 bytes each) before the edges
    ("  int32_t* tab = CLUSTER ? smem + 2 * ebuf : smem;  // NT * NT\n"
     "  int32_t* edge = CLUSTER ? smem : tab + NT * NT;   // [2][ebuf]\n",
     "  int32_t* tab = CLUSTER ? smem + 8 + 2 * ebuf : smem;\n"
     "  int32_t* edge = CLUSTER ? smem + 8 : tab + NT * NT;\n"
     "  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(smem);\n"),
    ("  uint32_t to_left = 0, to_right = 0;\n",
     "  uint32_t to_left = 0, to_right = 0, bar_left = 0, bar_right = 0;\n"),
    ("    to_right = map_rank(own + nwarp * kEdge * 4, (crank + 1) % ncta);\n",
     "    to_right = map_rank(own + nwarp * kEdge * 4, (crank + 1) % ncta);\n"
     "    bar_left = map_rank(bars + 8, (crank + ncta - 1) % ncta);  // its right side\n"
     "    bar_right = map_rank(bars, (crank + 1) % ncta);            // its left side\n"
     "    if (tid == 0) {\n"
     "      for (int x = 0; x < 4; ++x) mbar_init(bars + 8 * x);\n"
     "      mbar_init_fence();\n"
     "    }\n"),
    ("      if (tid == 0) st_cluster2(to_left + buf, hn[0], en[0]);\n",
     "      const uint32_t bar = (uint32_t)((k & 1) * 16);\n"
     "      if (tid == 0) {\n"
     "        st_cluster2(to_left + buf, hn[0], en[0]);\n"
     "        mbar_arrive_remote(bar_left + bar);\n"
     "      }\n"),
    ("        st_cluster2(to_right + buf, wh, wf);\n      }\n      cluster_arrive();\n",
     "        st_cluster2(to_right + buf, wh, wf);\n"
     "        mbar_arrive_remote(bar_right + bar);\n      }\n"),
    ("      cluster_wait();  // every CTA's edges of the diagonal are in\n",
     "      __syncthreads();  // the CTA's own edges are in; then each side's\n"
     "      const uint32_t bar = (uint32_t)((k & 1) * 16), parity = ((k - a.k0) >> 1) & 1;\n"
     "      if (tid == 0) mbar_wait(bars + bar, parity);\n"
     "      if (r_out) mbar_wait(bars + bar + 8, parity);\n"),
    ("2 * ((threads / 32) * kEdge + 4)) * sizeof(int32_t);",
     "2 * ((threads / 32) * kEdge + 4) + 8) * sizeof(int32_t);"),
)
# the one-CTA geometry (C, S, threads) of the S2 / S4 variants from Wp 129 on
SLOT_VARIANTS = {"S2": 2, "S4": 4}


def patched(src, pairs):
    """``src`` with each (old, new) of ``pairs`` replaced; each old text
    must occur once."""
    for old, new in pairs:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def variants(baselines):
    src = (_build.CSRC / "band_fill.cu").read_text()
    assert "fetch(k + 1, ihn);" in src
    out = {
        "shipped": (src, True),
        **{name: (src, True) for name in SLOT_VARIANTS},
        "no_barrier": (src.replace(
            "      __syncthreads();  // the diagonal's edges are out", "      //"), False),
        # the cluster kernel without its per-diagonal cluster barrier (wrong
        # values: the barrier's cost)
        "no_cluster_barrier": (patched(src, (
            ("      cluster_arrive();\n", ""),
            ("      cluster_wait();  // every CTA's edges of the diagonal are in\n", ""),
            (FINAL_STORES, CLUSTER_EXIT + FINAL_STORES))), False),
        # the cluster barrier's arrive relaxed, each diagonal's edge words
        # ordered by a fence in the threads that wrote them (CTA scope for
        # the warps' own words, cluster scope after a remote store)
        "relaxed_arrive": (patched(src, ((
            "      cluster_arrive();\n",
            "      if (tid == 0 || r_out) asm volatile(\"fence.acq_rel.cluster;\" ::: \"memory\");\n"
            "      else if (lane == 0 || lane == 31) asm volatile(\"fence.acq_rel.cta;\" ::: \"memory\");\n"
            "      asm volatile(\"barrier.cluster.arrive.relaxed.aligned;\" ::: \"memory\");\n"),)),
            True),
        # the cluster kernel closing a diagonal on per-neighbour mbarriers
        "neighbours": (patched(src, NEIGHBOUR_PATCH), True),
        "no_letters": (src.replace("(unsigned)__ldg(qb + i)", "0u")
                       .replace("(unsigned)__ldg(tb + j)", "0u"), False),
    }
    for spec in baselines:
        name, path = spec.split("=", 1)
        out[name] = (Path(path).read_text(), True)
    return out


def build_all(srcs):
    """One nvcc per variant, all started together; a source whose entry
    point takes no launch geometry gets the argument types it had."""
    libs = build_variants({name: {"band_fill.cu": text} for name, (text, _) in srcs.items()},
                          OUT)
    for name, (text, _) in srcs.items():
        if legacy(text):
            fn = libs[name].seqalib_band_fill
            fn.argtypes = fn.argtypes[:-4] + fn.argtypes[-1:]
    return libs


def legacy(text):
    """True for a ``band_fill.cu`` whose entry point takes no launch
    geometry (C, S, threads): the wrapper's last three arguments."""
    head = text[text.index('extern "C" int seqalib_band_fill('):]
    return not re.search(r"int cluster, int slots, int threads", head[: head.index("{")])


def legacy_launch(launch):
    """``_build.launch`` for a legacy ``seqalib_band_fill``: without the
    geometry, and with the global scratch its wide variant needs above Wp
    8192 (the wrapper allocates it for the scratch variant alone)."""
    def call(name, device, entry, *args):
        *head, scratch, C, S, threads = args
        keep = None
        if scratch is None and head[11] > bf_mod.MAX_WP_REGISTERS:
            keep = torch.empty((head[10], 7, head[11]), dtype=torch.int32, device=device)
            scratch = keep.data_ptr()
        launch(name, device, entry, *head, scratch)
        return keep
    return call


def run_variant(name, srcs, libs, a, kw, geometry=None):
    """One wrapper call on variant ``name``'s library."""
    _build._lib = libs[name]
    if name in SLOT_VARIANTS and geometry is None:
        Wp = a[6].shape[2]
        S = SLOT_VARIANTS[name] if 128 < Wp <= 512 * SLOT_VARIANTS[name] else None
        if S is not None:
            geometry = (1, S, -(-(-(-Wp // S)) // 32) * 32)
    launch = _build.launch
    if legacy(srcs[name][0]):
        _build.launch = legacy_launch(launch)
    try:
        return bf_mod.band_fill(*a, **kw, _geometry=geometry)
    finally:
        _build.launch = launch


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
    out.update(wide_cases(rng, dev, 1))
    return out


def wide_cases(rng, dev, B):
    """The cluster variant's shapes: B DNA pairs of 40 kb at a band that
    fills Wp (ceil128(band + 2) = Wp), fill and pointer modes."""
    dna = np.where(np.eye(4, dtype=bool), 2, -3)
    out = {}
    for Wp in WIDE_WPS:
        for mode, k0 in (("fill", 0), ("ptr", 2048)):
            out[f"cluster_{mode}_{Wp}"] = case(
                rng, dev, B=B, L=40_000, band=Wp - 64, Wp=Wp, alpha=4, table=dna, k0=k0,
                k1=k0 + 2048, mode=mode, **({"CK": 256} if mode == "fill" else {}))
    return out


def geometry_table(dev):
    """``--geometries``: the cluster kernel over slots a thread, each
    shape's outputs equal to the chosen geometry's; rows of the JSON."""
    rows = []
    for B in (1, 16):
        for shape, (a, kw) in wide_cases(np.random.default_rng(1), dev, B).items():
            Wp = a[6].shape[2]
            want = bf_mod.band_fill(*a, **kw)
            for S in GEOMETRY_SLOTS:
                C = -(-Wp // (S * 512))
                threads = -(-(-(-Wp // (S * C))) // 32) * 32
                row = {"shape": shape, "B": B, "Wp": Wp, "S": S, "C": C, "threads": threads,
                       "chosen": (C, S, threads) == bf_mod.fill_geometry(Wp)}
                if C > bf_mod.MAX_CLUSTER or C < 2:
                    row["ms"] = None
                    print(f"[geometry] {shape} B {B} S {S}: C {C} out of range", flush=True)
                    rows.append(row)
                    continue
                g = (C, S, threads)
                try:
                    got = bf_mod.band_fill(*a, **kw, _geometry=g)
                except RuntimeError as err:
                    row["ms"], row["error"] = None, str(err)
                    print(f"[geometry] {shape} B {B} S {S} C {C}: {err}", flush=True)
                    rows.append(row)
                    continue
                for key, v in want.items():
                    if not torch.equal(got[key], v):
                        raise AssertionError(f"geometry {g} {shape}: {key} differs")
                ms = time_ms(lambda: bf_mod.band_fill(*a, **kw, _geometry=g), REPS)
                row["ms"] = ms
                row["us_per_diagonal"] = us = ms * 1e3 / (kw["k1"] - kw["k0"])
                print(f"[geometry] {shape:18s} B {B:2d} Wp {Wp:5d} S {S:2d} C {C:2d} threads "
                      f"{threads:3d}: {ms:8.4f} ms, {us:.4f} µs per anti-diagonal"
                      + (" (chosen)" if row["chosen"] else ""), flush=True)
                rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", nargs="*", default=[], metavar="NAME=PATH",
                    help="other band_fill.cu files with the same C interface")
    ap.add_argument("--only", nargs="*", default=None, metavar="NAME",
                    help="build and time these variants alone (shipped first)")
    ap.add_argument("--shapes", nargs="*", default=None, metavar="SHAPE")
    ap.add_argument("--rounds", type=int, default=1, help="rounds in turns")
    ap.add_argument("--geometries", action="store_true",
                    help="time the cluster kernel over slots a thread instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("band_fill_ablation: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    if args.geometries:
        _build.lib()
        rows = geometry_table(dev)
        print(json.dumps({"device": torch.cuda.get_device_name(0), "geometries": rows}))
        return 0
    srcs = variants(args.baseline)
    if args.only is not None:
        srcs = {k: v for k, v in srcs.items() if k == "shipped" or k in args.only}
    libs = build_all(srcs)
    shapes = cases(dev)
    if args.shapes is not None:
        shapes = {k: v for k, v in shapes.items() if k in args.shapes}
    ref, rows = {}, []
    for name in srcs:
        for shape, (a, kw) in shapes.items():
            got = run_variant(name, srcs, libs, a, kw)
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
                ms = time_ms(lambda: run_variant(name, srcs, libs, a, kw), REPS)
                us = ms * 1e3 / (kw["k1"] - kw["k0"])
                Wp = a[6].shape[2]
                print(f"[ablation] round {r + 1} {name:10s} {shape:18s} Wp {Wp:5d} B "
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
