#!/usr/bin/env python3
"""Time the strip fill (``ops.strip_fill.strip_fill``) on one card over the
warps per pair, and the wavefront fill, at the main paths' shapes; count
the instructions a step issues from the SASS.

    python3 tools/strip_fill_sweep.py [--calls 5] [--warps 1,2,4,8]
                                      [--sass-only] [--sass-dump PATH]
                                      [--ablate] [--variant NAME=FILE.cu ...]

Shapes (seed 0): config 3's pass 1 (``local``, B=512 BLOSUM62 pairs of
1024 x 1024, o=-10, e=-1) and its slices of B=1 and B=64, its pass-3
``gmode`` windows with pointers and the strip engine's pass-2 ``emode``
(recorded from ``strip_bucket``), and config 1's ``gmode`` (B=512 DNA pairs
of 256 x 256, linear gaps).  Each call is timed with CUDA events over
``--calls`` calls after a warm-up, the warps per pair forced by patching
``strip_warps`` (the kernel takes 1 to 8), and every output is held equal
to the wrapper's default choice.  The wavefront part times
``wavefront_fill`` at the wide-table shapes (B=64 protein pairs of 1 000
letters, band 64, 2 x BLOSUM62 o=-20 e=-2), pointer and score-only, with
its µs per anti-diagonal.  The SASS part disassembles the built library
(``cuobjdump -sass``) and, for each ``strip_fill_kernel`` instance, counts
the instructions one step of its unrolled 32-step chunk issues (the
converged path) and their opcodes.  The card's name and power limit come
first; the last line is a JSON summary.  ``--sass-dump PATH`` writes the
whole SASS of those kernels to PATH.  ``--ablate`` times, beside the
shipped kernels, variants with one piece of the work removed (values not
kept): ``no_letters`` (every cell scores the table's first entry: no
letter loads), ``no_best`` (no best-cell tracking), ``far_only`` (the
wavefront's window kernel not launched in pointer mode) and ``no_far``
(its far pass not launched).  ``--variant NAME=FILE``: another
``strip_fill.cu`` or ``wavefront_fill.cu`` (by FILE's name) with the same
C interface, built by its own ``nvcc`` and timed after the shipped one at
the default warps (every output held equal to the shipped kernel's, unless
NAME starts with ``x_``: a variant that drops work to time it).  Needs a
CUDA card and the CUDA toolkit.
"""

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from kernel_variants import build_variants, card_line, time_ms  # noqa: E402
from seqalib_tpu_torch import BLOSUM62, ScoringParams, _build  # noqa: E402
from seqalib_tpu_torch.ops import strip as strip_mod  # noqa: E402
from seqalib_tpu_torch.ops import strip_fill as sf_mod  # noqa: E402
from seqalib_tpu_torch.ops import wavefront as wf_mod  # noqa: E402
from seqalib_tpu_torch.scoring import tables_from_params  # noqa: E402

MODES = {"0": "local", "1": "emode", "2": "gmode"}


def strip_calls(dev):
    """{shape name: (args, kwargs)} of the strip fill at the paths' shapes."""
    rng = np.random.default_rng(0)
    B = chip_smoke.B3
    q3 = rng.integers(0, 20, size=(B, 1024)).astype(np.uint8)
    t3 = rng.integers(0, 20, size=(B, 1024)).astype(np.uint8)
    q1 = rng.integers(0, 4, size=(B, 256)).astype(np.uint8)
    t1 = rng.integers(0, 4, size=(B, 256)).astype(np.uint8)
    targets = [(strip_mod, "strip_fill", sf_mod.strip_fill_ref)]
    out = {}
    for name, (q, t, sp, mode, extra) in {
        "config3": (q3, t3, ScoringParams.blosum62(gap_open=-10, gap_extend=-1), "local", {}),
        "config3_strip": (q3, t3, ScoringParams.blosum62(gap_open=-10, gap_extend=-1),
                          "local", {"pass2": "strip", "want_tb": False}),
        "config1": (q1, t1, ScoringParams.linear(), "global", {}),
    }.items():
        tables = tables_from_params(sp, dev)
        n, m = np.full(B, q.shape[1]), np.full(B, t.shape[1])
        kw = dict({"want_tb": True}, **extra)
        calls, _ = chip_smoke.record(lambda: strip_mod.strip_bucket(
            q, t, n, m, tables, mode=mode, **kw), targets)
        for key, (_, _, a, k, _) in calls.items():
            if name == "config3_strip" and key != "strip_fill/emode":
                continue
            out[f"{name} {key}"] = (a, k)
    a, k = out["config3 strip_fill/local"]
    for b in (1, 64):
        out[f"config3 strip_fill/local B={b}"] = (
            (a[0][:b], a[1][:b], a[2][:b], a[3][:b], a[4]), k)
    return out


def wavefront_calls(dev):
    rng = np.random.default_rng(0)
    qs, ts = chip_smoke.wide_pairs(rng)
    sp = ScoringParams(gap_open=-20, gap_extend=-2, matrix=2 * BLOSUM62)
    import seqalib_tpu_torch as st

    out = {}
    for tb in (True, False):
        calls, _ = chip_smoke.record(lambda: st.align_batch(
            qs, ts, scoring=sp, mode="global", band=chip_smoke.BAND7, traceback=tb,
            device=dev), [(wf_mod, "wavefront_fill", wf_mod.wavefront_fill_ref)])
        for key, (_, _, a, k, _) in calls.items():
            out[key] = (a, k)
    return out


# ablation -> (source, text replaced, replacement): one piece of work removed
ABLATIONS = {
    "x_no_letters": ("strip_fill.cu", "      const int d = Hdiag + srow[min(t, sent)];",
                     "      const int d = Hdiag + srow[0];"),
    "x_no_best": ("strip_fill.cu", "      if (MODE != kGlobal && H > sbest) {",
                  "      if (MODE != kGlobal && false) {"),
    "x_far_only": ("wavefront_fill.cu", "  return run_window(a, s);\n}", "  return 0;\n}"),
    "x_no_far": ("wavefront_fill.cu", "  if (ptr && banded) {", "  if (false) {"),
}


def variant_sources(specs, ablate):
    """{name: {file name: text}} of the ``--variant`` files and, with
    ``ablate``, of the ablations."""
    out = {}
    for spec in specs:
        name, path = spec.split("=", 1)
        out[name] = {Path(path).name: Path(path).read_text()}
    for name, (src, old, new) in (ABLATIONS.items() if ablate else ()):
        text = (_build.CSRC / src).read_text()
        assert old in text, name
        out[name] = {src: text.replace(old, new)}
    return out


def time_variants(sources, calls, dev, rows):
    """Each variant against the shipped kernel, in turns (shipped,
    variants, shipped), at the default warps."""
    built = build_variants(sources, _build.BUILD_DIR / "sweep_variants")
    libs = {name: (lib, next(iter(sources[name]))) for name, lib in built.items()}
    shipped = _build.lib()
    shapes = {"strip_fill.cu": [(f"strip {n}", sf_mod.strip_fill, a, k)
                                for n, (a, k) in strip_calls(dev).items()],
              "wavefront_fill.cu": [(f"wavefront {n}", wf_mod.wavefront_fill, a, k)
                                    for n, (a, k) in wavefront_calls(dev).items()]}
    order = [("shipped", shipped, None)] + [(n, lib, f) for n, (lib, f) in libs.items()]
    order.append(("shipped", shipped, None))
    for src, cases in shapes.items():
        if not any(f == src for _, (_, f) in libs.items()):
            continue
        for name, fn, a, k in cases:
            _build._lib = shipped
            want = fn(*a, **k)
            for vname, lib, f in order:
                if f not in (None, src):
                    continue
                _build._lib = lib
                try:
                    got = fn(*a, **k)
                    if not vname.startswith("x_") and not same(got, want):
                        raise AssertionError(f"{name}: variant {vname} differs")
                    ms = time_ms(lambda: fn(*a, **k), calls)
                finally:
                    _build._lib = shipped
                print(f"[variant] {name}: {vname} {ms:.4f} ms", flush=True)
                rows.append(dict(shape=name, variant=vname, ms=ms))


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(chip_smoke._tensors(a),
                                                 chip_smoke._tensors(b)))


def sweep_strip(warps, calls, dev, rows):
    default = sf_mod.strip_warps
    for name, (a, k) in strip_calls(dev).items():
        want = sf_mod.strip_fill(*a, **k)
        chosen = default(a[0].shape[1])
        for W in warps:
            sf_mod.strip_warps = lambda nq, W=W: W
            try:
                if not same(sf_mod.strip_fill(*a, **k), want):
                    raise AssertionError(f"{name}: {W} warps differ from {chosen}")
                ms = time_ms(lambda: sf_mod.strip_fill(*a, **k), calls)
            finally:
                sf_mod.strip_warps = default
            print(f"[strip] {name} (B {a[0].shape[0]}, {a[0].shape[1]} x {a[1].shape[1] - 1})"
                  f": {W:2d} warps {ms:.4f} ms{' (default)' if W == chosen else ''}",
                  flush=True)
            rows.append(dict(shape=name, B=a[0].shape[0], warps=W, ms=ms))


def sweep_wavefront(calls, dev, rows):
    for key, (a, k) in wavefront_calls(dev).items():
        ms = time_ms(lambda: wf_mod.wavefront_fill(*a, **k), calls)
        print(f"[wavefront] {key}: {ms:.4f} ms, {ms * 1e3 / k['K']:.4f} µs per diagonal",
              flush=True)
        rows.append(dict(key=key, ms=ms, K=k["K"]))


def steady_steps(ops, per_step_shuffles):
    """The unrolled chunk's fast path: the longest run of converged
    SHFL.UP (ptxas also emits a WARPSYNC.COLLECTIVE copy of each shuffle
    for a diverged warp, behind a BRA.DIV), split into steps of
    ``per_step_shuffles`` shuffles.  (instructions a step, opcodes a step)."""
    at = [n for n, op in enumerate(ops) if op == "SHFL.UP PT"]
    runs, cur = [], at[:1]
    for x, y in zip(at, at[1:]):
        if y - x > 48:
            runs.append(cur)
            cur = []
        cur.append(y)
    runs.append(cur)
    run = max(runs, key=len)
    steps = len(run) // per_step_shuffles - 1
    if steps < 1:
        return None, {}
    span = ops[run[0]: run[steps * per_step_shuffles]]
    mix = collections.Counter(op.split()[0].split(".")[0] for op in span)
    return len(span) / steps, {k: v / steps for k, v in mix.most_common(12)}


def sass_counts(rows, dump=None):
    """Per strip_fill_kernel instance: the instructions one step of its
    unrolled chunk issues and their opcodes; per wavefront kernel its
    size.  ``dump``: a file for the whole SASS of those kernels."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    so = _build.BUILD_DIR / _build.LIB_NAME
    text = subprocess.run([tool, "-sass", str(so)], check=True, capture_output=True,
                          text=True).stdout
    funcs = [f for f in re.split(r"\n\s*Function : ", text)[1:]
             if "strip_fill_kernel" in f.split("\n", 1)[0]
             or "wf_" in f.split("\n", 1)[0]]
    if dump:
        Path(dump).write_text("\n\nFunction : ".join([""] + funcs))
    for func in funcs:
        name = func.split("\n", 1)[0].strip()
        ops = []  # opcode and first operand, predicates dropped
        for line in func.splitlines():
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                          r"(?:\s+(\w+))?", line)
            if m:
                ops.append(f"{m.group(1)} {m.group(2) or ''}".strip())
        tag, per, mix = name, None, {}
        m = re.search(r"strip_fill_kernelILi(\d)ELb(\d)ELb(\d)E", name)
        if m:
            tag = (f"strip_fill {MODES[m.group(1)]} affine={m.group(2)} "
                   f"ptr={m.group(3)}")
            per, mix = steady_steps(ops, 1 + int(m.group(2)))
        print(f"[sass] {tag}: {len(ops)} instructions"
              + (f"; {per:.1f} a step: {mix}" if per else ""), flush=True)
        rows.append(dict(kernel=tag, total=len(ops), per_step=per, mix=mix))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--warps", default="1,2,4,8")
    ap.add_argument("--sass-only", action="store_true")
    ap.add_argument("--sass-dump")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("strip_fill_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    _build.lib()
    sass, strip_rows, wf_rows, var_rows = [], [], [], []
    sass_counts(sass, args.sass_dump)
    if args.variant or args.ablate:
        time_variants(variant_sources(args.variant, args.ablate), args.calls, dev, var_rows)
    elif not args.sass_only:
        sweep_strip([int(w) for w in args.warps.split(",")], args.calls, dev, strip_rows)
        sweep_wavefront(args.calls, dev, wf_rows)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "strip": strip_rows,
                      "wavefront": wf_rows, "variants": var_rows, "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
