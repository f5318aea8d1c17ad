#!/usr/bin/env python3
"""Time the strip walk (``ops.strip_walk.strip_walk``) on one card over its
staged block's side, at the main paths' calls; count the instructions a
step issues from the SASS.

    python3 tools/strip_walk_sweep.py [--tiles 16,32,64] [--calls 100]
                                      [--sass-dump PATH]

Calls (the data of ``chip_smoke.py``, seed 0): config 3's pass-3 walk
(B=512 BLOSUM62 pairs of 1024 x 1024, local, o=-10, e=-1, recorded from
``strip_bucket``), config 1's (B=512 DNA pairs of 256 x 256, global,
linear gaps), and B=1: config 1's longest walk alone.  The shipped kernel
(``kTile`` in ``csrc/strip_walk.cu``) is timed first and last; each other
tile is a variant of the source with ``kTile`` replaced, built by its own
``nvcc`` (``tools/kernel_variants.py``), its text, lengths and states held
equal to the shipped kernel's.  Each is timed as the wrapper by CUDA events
over ``--calls`` calls and as the kernel alone under ``torch.profiler``,
with the ns per op of the call's longest walk.  The SASS part disassembles
the shipped library (``cuobjdump -sass``) and, for each
``strip_walk_kernel`` instance, counts the instructions of one step on
the walk's straight path (the shortest way through the innermost loop
around a step's pointer-byte load, ``LDS.U8``: a step that writes no run
and stages no block) and their opcodes.  The card's name and
power limit come first; the last line is a JSON summary.  Needs a CUDA
card and the CUDA toolkit.
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
from seqalib_tpu_torch import ScoringParams, _build  # noqa: E402
from seqalib_tpu_torch.ops import strip as strip_mod  # noqa: E402
from seqalib_tpu_torch.ops import strip_walk as sw_mod  # noqa: E402
from seqalib_tpu_torch.scoring import tables_from_params  # noqa: E402

TILE_RE = re.compile(r"constexpr int kTile = (\d+);")


def walk_calls(dev):
    """{name: (args, kwargs)} of ``strip_walk`` at the paths' calls."""
    rng = np.random.default_rng(chip_smoke.SEED)
    B = chip_smoke.B3
    q3 = rng.integers(0, 20, size=(B, 1024)).astype(np.uint8)
    t3 = rng.integers(0, 20, size=(B, 1024)).astype(np.uint8)
    q1 = rng.integers(0, 4, size=(B, 256)).astype(np.uint8)
    t1 = rng.integers(0, 4, size=(B, 256)).astype(np.uint8)
    targets = [(strip_mod, "strip_walk", sw_mod.strip_walk_ref)]
    out = {}
    for name, (q, t, sp, mode) in {
        "config 3": (q3, t3, ScoringParams.blosum62(gap_open=-10, gap_extend=-1), "local"),
        "config 1": (q1, t1, ScoringParams.linear(), "global"),
    }.items():
        tables = tables_from_params(sp, dev)
        n, m = np.full(B, q.shape[1]), np.full(B, t.shape[1])
        calls, _ = chip_smoke.record(
            lambda: strip_mod.strip_bucket(q, t, n, m, tables, mode=mode, want_tb=True),
            targets)
        _, _, args, kw, res = calls["strip_walk"]
        out[name] = (args, kw)
    b = int(np.argmax(chip_smoke.walked_ops(res)))
    P = args[0][b: b + 1].clone()  # a fresh allocation: 16-byte aligned
    out["B=1"] = ((P, *(a[b: b + 1] for a in args[1:])), kw)
    return out


def sweep(tiles, calls, dev, rows):
    """Each tile at each call, in turns (shipped, others, shipped)."""
    src = (_build.CSRC / "strip_walk.cu").read_text()
    shipped_tile = int(TILE_RE.search(src).group(1))
    others = [t for t in tiles if t != shipped_tile]
    built = build_variants({f"tile{t}": {"strip_walk.cu": TILE_RE.sub(
        f"constexpr int kTile = {t};", src)} for t in others},
        _build.BUILD_DIR / "walk_variants")
    shipped = _build.lib()
    order = ([(shipped_tile, shipped)] + [(t, built[f"tile{t}"]) for t in others]
             + [(shipped_tile, shipped)])
    for name, (a, k) in walk_calls(dev).items():
        fn = lambda: sw_mod.strip_walk(*a, **k)  # noqa: E731
        want = chip_smoke.walk_view(fn())
        steps = chip_smoke.walked_ops(want)
        for tile, lib in order:
            _build._lib = lib
            try:
                if chip_smoke.max_abs_err(chip_smoke.walk_view(fn()), want):
                    raise AssertionError(f"{name}: tile {tile} differs from {shipped_tile}")
                ms = time_ms(fn, calls)
                alone = chip_smoke.kernel_split(fn, ("strip_walk_kernel",))[
                    "strip_walk_kernel"]
            finally:
                _build._lib = shipped
            per_op = None if alone is None else alone * 1e6 / max(1, int(steps.max()))
            print(f"[walk] {name} (B {len(steps)}, longest walk {steps.max()} ops, mean "
                  f"{steps.mean():.1f}): tile {tile}{' (shipped)' if lib is shipped else ''}"
                  f" wrapper {ms:.4f} ms, kernel alone "
                  + ("not measured" if alone is None else
                     f"{alone:.4f} ms, {per_op:.1f} ns per op"), flush=True)
            rows.append(dict(call=name, tile=tile, shipped=lib is shipped, wrapper_ms=ms,
                             kernel_ms=alone, ns_per_op=per_op,
                             longest=int(steps.max())))


def step_counts(ins):
    """The walk's step on its straight path: the innermost loop around a
    ``LDS.U8`` (a step's pointer-byte load), and the shortest path through
    its body from its head to its backward branch (forward branches taken
    or not; branches out of the loop left; so a step that writes no run).
    ``ins``: [(address, opcode and first operand, branch target or None,
    predicated)].  (instructions a step, opcodes a step)."""
    at = {a: n for n, (a, _, _, _) in enumerate(ins)}
    loads = [n for n, (_, op, _, _) in enumerate(ins) if op.startswith("LDS.U8")]
    loops = [(at[t], n) for n, (a, _, t, _) in enumerate(ins)
             if t is not None and t <= a and t in at
             and any(at[t] <= x < n for x in loads)]
    if not loops:
        return None, {}
    head, back = min(loops, key=lambda lp: lp[1] - lp[0])
    dist, prev = {head: 1}, {}
    for n in range(head, back):  # a DAG: forward edges only
        if n not in dist:
            continue
        _, op, t, pred = ins[n]
        nxt = [] if op.startswith(("BRA", "EXIT")) and not pred else [n + 1]
        if t is not None and head <= at.get(t, -1) <= back:
            nxt.append(at[t])
        for m in nxt:
            if m <= back and dist[n] + 1 < dist.get(m, 1 << 30):
                dist[m], prev[m] = dist[n] + 1, n
    path, n = [back], back
    while n != head:
        n = prev[n]
        path.append(n)
    mix = collections.Counter(ins[n][1].split()[0].split(".")[0] for n in path)
    return len(path), dict(mix.most_common(12))


def sass_counts(rows, dump=None):
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    so = _build.BUILD_DIR / _build.LIB_NAME
    text = subprocess.run([tool, "-sass", str(so)], check=True, capture_output=True,
                          text=True).stdout
    funcs = [f for f in re.split(r"\n\s*Function : ", text)[1:]
             if "strip_walk_kernel" in f.split("\n", 1)[0]]
    if dump:
        Path(dump).write_text("\n\nFunction : ".join([""] + funcs))
    for func in funcs:
        name = func.split("\n", 1)[0].strip()
        print(f"[sass] {sass_line(name, func, rows)}", flush=True)


def sass_line(name, func, rows):
    ins = []  # (address, opcode and first operand, branch target, predicated)
    for line in func.splitlines():
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                      r"(?:\s+(\w+))?", line)
        if m:
            op = f"{m.group(3)} {m.group(4) or ''}".strip()
            t = re.search(r"BRA (?:!?U?P\w+, )?0x([0-9a-f]+)", line)
            ins.append((int(m.group(1), 16), op, int(t.group(1), 16) if t else None,
                        bool(m.group(2))))
    per, mix = step_counts(ins)
    tag = "strip_walk affine=" + ("1" if "ILb1E" in name else "0")
    rows.append(dict(kernel=tag, total=len(ins), per_step=per, mix=mix))
    return (f"{tag}: {len(ins)} instructions"
            + (f"; {per} a step on the straight path: {mix}" if per else ""))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", default="16,32,64")
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--sass-dump")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("strip_walk_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    _build.lib()
    sass, rows = [], []
    sass_counts(sass, args.sass_dump)
    sweep([int(t) for t in args.tiles.split(",")], args.calls, dev, rows)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "walk": rows, "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
