#!/usr/bin/env python3
"""Time the strip fill (``ops.strip_fill.strip_fill``) on one card over the
warps per pair, and the wavefront fill, at the main paths' shapes; count
the instructions a step issues from the SASS.

    python3 tools/strip_fill_sweep.py [--calls 5] [--warps 1,2,4,8]
                                      [--strip-warps 4,8,16] [--ptr-warps 4,8]
                                      [--sass-only] [--sass-dump PATH]
                                      [--ablate] [--variant NAME=FILE.cu ...]
                                      [--parent DIR] [--rounds 5] [--shapes PREFIX]

Shapes (seed 0): config 3's pass 1 (``local``, B=512 BLOSUM62 pairs of
1024 x 1024, o=-10, e=-1) and its slices of B=1 and B=64, its pass-3
``gmode`` windows with pointers and the strip engine's pass-2 ``emode``
(recorded from ``strip_bucket``), and config 1's ``gmode`` (B=512 DNA pairs
of 256 x 256, linear gaps).  Each call is timed with CUDA events over
``--calls`` calls after a warm-up, the warps per pair forced by patching
``strip_warps`` (the kernel takes 1 to 8), and every output is held equal
to the wrapper's default choice.  The wavefront part times
``wavefront_fill`` at its paths' shapes, with its µs per anti-diagonal:
the wide-table route's banded fills (B=64 protein pairs of 1 000 letters,
band 64, 2 x BLOSUM62 o=-20 e=-2), pointer and score-only, and the
``"xla"`` route's unbanded score-only fills (the strip kernel) as
``run_bucket(backend="xla")`` makes them: config 3's pass (a) (``local``),
config 3's pairs in global mode (unbanded ``score``), config 2's fullest
bucket (``local_lin``) and all 16 of its buckets one after another, and
config 1 (``lin_score``); each strip shape also at the warps per pair of
``--strip-warps`` (patching ``wavefront_strip_warps``; the kernel takes 1
to 16).  The SASS part disassembles the built library (``cuobjdump
-sass``) and, for each ``strip_fill_kernel`` and ``wf_strip_kernel``
instance, counts the instructions one step of its unrolled 32-step chunk
issues (the converged path) and their opcodes.  The card's name and power
limit come first; the last line is a JSON summary.  ``--sass-dump PATH``
writes the whole SASS of those kernels to PATH.  ``--ablate`` times,
beside the shipped kernels, variants with one piece of the work removed
(values not kept): ``no_letters`` (every cell scores the table's first
entry: no letter loads), ``no_best`` (no best-cell tracking), ``far_only``
(the wavefront's window kernel not launched in pointer mode), ``no_far``
(its far pass not launched), and in the strip kernel ``wf_no_best`` (no
row bests), ``wf_no_start`` (no start propagation: no start cells
computed, shuffled or handed on) and ``wf_no_handoff`` (no ring hand-off
between warps: no waits, lane 0 reads nothing, lane 31 stores nothing).
The same part times the ``"xla"`` route's unbanded global fills with
pointers (the pointer strip kernel): config 3's pass (c) (unbanded
``ptr``) and config 1 with CIGARs (``lin_ptr``), each also at the warps
per pair of ``--ptr-warps`` (patching ``wavefront_strip_ptr_warps``; the
kernel takes 1 to 8), and the SASS part counts one step of each
``wf_strip_ptr_kernel`` instance too.  ``--ablate`` adds ``x_ptr_no_stream``
(the pointer strip kernel stores no pointer byte).
``--parent DIR``: the wavefront shapes of this tree and of the tree at DIR
(e.g. ``git archive`` of the parent commit unpacked under ``_checkout/``)
in two worker processes, each importing its own package and building its
own kernels, taking turns for ``--rounds`` rounds (this tree first on even
rounds); each shape's calls are made by that tree's own wrappers and
routes from the same seeded inputs.  ``--shapes PREFIX``: only the wavefront
shapes whose names start with PREFIX (e.g. ``wide``, for a tree without
the ``"xla"`` route).  ``--variant NAME=FILE``: another
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
if "--worker" in sys.argv:  # a worker imports the package of the tree it serves
    sys.path.insert(0, sys.argv[sys.argv.index("--worker") + 1])

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


def capture(run, mod, name="wavefront_fill"):
    """(args, kwargs) of every call ``run()`` makes to ``mod.name`` (a
    tree's own wrapper, whatever its launch keys)."""
    got, fn = [], getattr(mod, name)

    def wrapped(*a, **k):
        got.append((a, k))
        return fn(*a, **k)

    setattr(mod, name, wrapped)
    try:
        run()
    finally:
        setattr(mod, name, fn)
    return got


def wavefront_calls(dev, cs=None, only=""):
    """{shape name: [(args, kwargs), ...]} of ``wavefront_fill`` at the
    paths' shapes (see the module docstring) whose names start with
    ``only``, made by this process's package; ``cs``: the ``chip_smoke``
    module to record with."""
    cs = cs or chip_smoke
    import seqalib_tpu_torch as st
    from seqalib_tpu_torch import cli
    from seqalib_tpu_torch.ops import wavefront as wf
    from seqalib_tpu_torch.parallel import dispatch

    targets = [(wf, "wavefront_fill", wf.wavefront_fill_ref)]
    rng = np.random.default_rng(0)
    qs, ts = cs.wide_pairs(rng)
    sp = st.ScoringParams(gap_open=-20, gap_extend=-2, matrix=2 * st.BLOSUM62)
    out = {}
    for tb in (True, False) if "wide".startswith(only[:4]) else ():
        calls = capture(lambda: st.align_batch(qs, ts, scoring=sp, mode="global",
                                               band=cs.BAND7, traceback=tb, device=dev), wf)
        out[f"wide wavefront_fill/{'ptr' if tb else 'score'}"] = calls[:1]
    if not "xla".startswith(only[:3]):
        return {k: v for k, v in out.items() if k.startswith(only)}
    from seqalib_tpu_torch.ops import wavefront_xla as xla

    targets.append((xla, "wavefront_fill", wf.wavefront_fill_ref))
    rng = np.random.default_rng(cs.SEED)  # chip_smoke's config 3 and config 1 pairs
    q3 = rng.integers(0, 20, size=(cs.B3, 1024)).astype(np.uint8)
    t3 = rng.integers(0, 20, size=(cs.B3, 1024)).astype(np.uint8)
    q1 = rng.integers(0, 4, size=(cs.B3, 256)).astype(np.uint8)
    t1 = rng.integers(0, 4, size=(cs.B3, 256)).astype(np.uint8)
    sp3 = st.ScoringParams.blosum62(gap_open=-10, gap_extend=-1)
    full = lambda x: np.full(len(x), x.shape[1])  # noqa: E731
    q2, t2, ql2, tl2, sp2 = cs.config2_bucket(dev)
    for name, args in (("xla config 3", (q3, t3, full(q3), full(t3), sp3, "local", None, True)),
                       ("xla config 1 with CIGARs", (q1, t1, full(q1), full(t1),
                                                     st.ScoringParams.linear(), "global",
                                                     None, True)),
                       ("xla config 3 global", (q3, t3, full(q3), full(t3), sp3, "global",
                                                None, False)),
                       ("xla config 2 fullest bucket", (q2, t2, ql2, tl2, sp2, "local", None,
                                                        False)),
                       ("xla config 1", (q1, t1, full(q1), full(t1), st.ScoringParams.linear(),
                                         "global", None, False))):
        calls, _ = cs.record(lambda: dispatch.run_bucket(*args, dev, backend="xla"), targets)
        for key, (_, _, a, k, _) in calls.items():
            if k["band"] is None:
                out[f"{name} {key}"] = [(a, k)]
    a2 = argparse.Namespace(pairs=cs.BENCH_PAIRS, backend="xla", device=dev)
    sp2, qs2, ts2 = cli._bench_setup(a2, 2, np.random.default_rng(0))[:3]
    calls, _ = cs.record(lambda: st.align_batch(qs2, ts2, scoring=sp2, mode="local",
                                                traceback=False, backend="xla", device=dev),
                         targets, every=True)
    out["xla config 2, every bucket"] = [(a, k) for a, k in
                                         ((c[2], c[3]) for c in calls.values())]
    return {k: v for k, v in out.items() if k.startswith(only)}


def run_shape(calls):
    from seqalib_tpu_torch.ops import wavefront as wf

    for a, k in calls:
        wf.wavefront_fill(*a, **k)


# ablation -> (source, [(text replaced, replacement), ...]): one piece of
# work removed
ABLATIONS = {
    "x_no_letters": ("strip_fill.cu", [("      const int d = Hdiag + srow[min(t, sent)];",
                                        "      const int d = Hdiag + srow[0];")]),
    "x_no_best": ("strip_fill.cu", [("      if (MODE != kGlobal && H > sbest) {",
                                     "      if (MODE != kGlobal && false) {")]),
    "x_far_only": ("wavefront_fill.cu", [("  return run_fill(a, sl, s);\n}", "  return 0;\n}")]),
    "x_no_far": ("wavefront_fill.cu", [("  if (ptr && banded) {", "  if (false) {")]),
    "x_ptr_no_stream": ("wavefront_fill.cu", [
        ("        if (ALL || live) *o = (uint8_t)byte;\n", "")]),
    "x_wf_no_best": ("wavefront_fill.cu", [("        const bool upd = H > bv;",
                                            "        const bool upd = false;")]),
    "x_wf_no_start": ("wavefront_fill.cu", [
        ("        int sh = up == best ? sf : se;\n        sh = d == best ? SHd : sh;\n"
         "        sh = best <= 0 ? sbase + k : sh;", "        const int sh = 0;"),
        ("        const int se = AFFINE && ext_e ? SE : SH;", "        const int se = 0;"),
        ("        const int sf = AFFINE && ext_f ? u.SF : u.SH;", "        const int sf = 0;"),
        ("                LOCAL ? __shfl_up_sync(kFull, SH, 1) : 0,\n"
         "                LOCAL && AFFINE ? __shfl_up_sync(kFull, SF, 1) : 0};", "0, 0};")]),
    "x_wf_no_handoff": ("wavefront_fill.cu", [
        ("      wait_for(up_cnt, above + min((unsigned)c0 + 32, mp1));\n", ""),
        ("      if (backpressure) wait_for(down_cnt, mine + (unsigned)(c0 - kStripRing + 1));\n",
         ""),
        ("          if (lane == 0) v = Col::unpack(sc[u]);\n", ""),
        ("          if (put) {\n            if (u < 31) d_lo[u] = Col::pack(H, F, SH, SF);\n"
         "            else *d_hi = Col::pack(H, F, SH, SF);\n          }\n", "")]),
}


def variant_sources(specs, ablate):
    """{name: {file name: text}} of the ``--variant`` files and, with
    ``ablate``, of the ablations."""
    out = {}
    for spec in specs:
        name, path = spec.split("=", 1)
        out[name] = {Path(path).name: Path(path).read_text()}
    for name, (src, edits) in (ABLATIONS.items() if ablate else ()):
        text = (_build.CSRC / src).read_text()
        for old, new in edits:
            assert old in text, (name, old)
            text = text.replace(old, new)
        out[name] = {src: text}
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
                                    for n, calls in wavefront_calls(dev).items()
                                    for a, k in calls[:1]]}
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


def sweep_wavefront(calls, dev, rows, strip_warps, only="", ptr_warps=()):
    """Each wavefront shape at the default warps per pair and, for the
    strip kernels' shapes, at each of ``strip_warps`` (score-only) or
    ``ptr_warps`` (pointers) (every output held equal to the default's)."""
    for name, shape in wavefront_calls(dev, only=only).items():
        a, k = shape[0]
        kernel = wf_mod.fill_kernel(k["band"], k["want_ptr"], k.get("mode", "global"))
        attr = {"strip": "wavefront_strip_warps",
                "strip_ptr": "wavefront_strip_ptr_warps"}.get(kernel)
        default = getattr(wf_mod, attr) if attr else None
        want = wf_mod.wavefront_fill(*a, **k)
        forced = {"strip": strip_warps, "strip_ptr": list(ptr_warps)}.get(kernel, [])
        for W in [None] + forced:
            if W is not None:
                setattr(wf_mod, attr, lambda Np, W=W: W)
            try:
                if not same(wf_mod.wavefront_fill(*a, **k), want):
                    raise AssertionError(f"{name}: {W} warps differ from the default")
                ms = time_ms(lambda: run_shape(shape), calls)
                lay = chip_smoke.layout("wavefront_fill/x", a, k) if len(shape) == 1 else ""
            finally:
                if attr:
                    setattr(wf_mod, attr, default)
            print(f"[wavefront] {name} ({len(shape)} call{'s' * (len(shape) > 1)}): {ms:.4f} ms, "
                  f"{ms * 1e3 / k['K']:.4f} µs per diagonal"
                  + (f"; {W} warps forced" if W else " (default)") + (f"; {lay}" if lay else ""),
                  flush=True)
            rows.append(dict(shape=name, ms=ms, K=k["K"], warps=W, calls=len(shape)))


def parent_worker(root: str, only: str) -> int:
    """Serve timings of this tree's wavefront shapes made by the package
    at ``root``: a line "NAME<tab>CALLS" answers with the ms of one run of
    that shape's calls."""
    import importlib.util

    sys.path.insert(0, root)
    import seqalib_tpu_torch as st

    if not Path(st.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {st.__file__}, not the tree at {root}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_inputs", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from seqalib_tpu_torch import _build as build

    build.lib()
    shapes = wavefront_calls(torch.device("cuda"), cs, only)
    print(json.dumps(list(shapes)), flush=True)
    for line in sys.stdin:
        name, calls = line.rstrip("\n").split("\t")
        print(json.dumps(time_ms(lambda: run_shape(shapes[name]), int(calls))), flush=True)
    return 0


def parent_turns(parent, calls, rounds, rows, only):
    """This tree's and the parent's wavefront shapes in turns."""
    here = str(Path(__file__).resolve().parents[1])
    trees = {"change": here, "parent": str(Path(parent).resolve())}
    procs = {n: subprocess.Popen([sys.executable, __file__, "--worker", r, "--shapes", only],
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
             for n, r in trees.items()}
    try:
        names = {n: json.loads(p.stdout.readline()) for n, p in procs.items()}
        for name in names["change"]:
            if name not in names["parent"]:
                continue
            got = {n: [] for n in trees}
            for r in range(rounds):
                for n in (list(trees) if r % 2 == 0 else list(trees)[::-1]):
                    procs[n].stdin.write(f"{name}\t{calls}\n")
                    procs[n].stdin.flush()
                    got[n].append(json.loads(procs[n].stdout.readline()))
            ch, pa = got["change"], got["parent"]
            print(f"[turns] {name}: change {min(ch):.4f}-{max(ch):.4f} ms, parent "
                  f"{min(pa):.4f}-{max(pa):.4f} ms; change faster in "
                  f"{sum(x < y for x, y in zip(ch, pa))} of {rounds} rounds", flush=True)
            rows.append(dict(shape=name, change_ms=ch, parent_ms=pa))
    finally:
        for p in procs.values():
            p.stdin.close()
        for p in procs.values():
            p.wait(timeout=120)


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
        m = re.search(r"wf_strip_ptr_kernelILb(\d)E", name)
        if m:  # shuffles a step: H, then F (affine)
            affine = int(m.group(1))
            tag = f"wf_strip_ptr global affine={affine}"
            per, mix = steady_steps(ops, 1 + affine)
        m = re.search(r"wf_strip_kernelILb(\d)ELb(\d)E", name)
        if m:  # shuffles a step: H, then F (affine), SH (local), SF (both)
            local, affine = int(m.group(1)), int(m.group(2))
            tag = f"wf_strip {'local' if local else 'global'} affine={affine}"
            per, mix = steady_steps(ops, 1 + affine + local + local * affine)
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
    ap.add_argument("--strip-warps", default="4,8,16")
    ap.add_argument("--ptr-warps", default="4,8")
    ap.add_argument("--parent")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--shapes", default="")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return parent_worker(args.worker, args.shapes)
    if not torch.cuda.is_available():
        print("strip_fill_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    _build.lib()
    sass, strip_rows, wf_rows, var_rows, turn_rows = [], [], [], [], []
    sass_counts(sass, args.sass_dump)
    if args.parent:
        parent_turns(args.parent, args.calls, args.rounds, turn_rows, args.shapes)
    elif args.variant or args.ablate:
        time_variants(variant_sources(args.variant, args.ablate), args.calls, dev, var_rows)
    elif not args.sass_only:
        sweep_strip([int(w) for w in args.warps.split(",")], args.calls, dev, strip_rows)
        sweep_wavefront(args.calls, dev, wf_rows,
                        [int(w) for w in args.strip_warps.split(",") if w], args.shapes,
                        [int(w) for w in args.ptr_warps.split(",") if w])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "strip": strip_rows,
                      "wavefront": wf_rows, "variants": var_rows, "turns": turn_rows,
                      "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
