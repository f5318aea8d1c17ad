#!/usr/bin/env python3
"""The controls of the output check: the reference put in the program's
place with one guarantee broken, which the check must find wrong.

    python3 benchmark/control.py --workload NAME --seed N [--seed N ...]

For each seed it makes the cell's pool and check sample as a run does, and
counts the sampled answers that each control gets wrong against the
reference, by the comparison a run makes (``drive.same``):

* ``int16``: every value saturated to [-32768, 32767], as a kernel with
  16-bit scores would (the width below the program's int32);
* ``linear_gaps``: the gap-open cost dropped (a one-state recurrence in
  place of Gotoh's three).

A run's ``wrong`` counts every answer of a sampled pair in the window, so
a control that gets a pair wrong reads at least one there.  Prints one JSON
line.  Needs no card: the controls are NumPy.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import cells  # noqa: E402
import drive  # noqa: E402
import generate  # noqa: E402
import reference  # noqa: E402

CONTROLS = {
    "int16": {"saturate": (-(1 << 15), (1 << 15) - 1)},
    "linear_gaps": {"gap_open": 0},
}


def answers(sc, request, qs, ts, **control):
    try:
        return reference.for_cell(sc, request, qs, ts, **control)
    except RuntimeError:  # a walk that leaves the matrix: no answer
        return [None] * len(qs)


def readings(cell, seed: int) -> dict:
    request = cell.traffic["request"]
    sc = cells.scoring(cell.config, int(cell.traffic["alphabet"]), cell.bench_dir)
    batches = generate.pool(seed, cell.traffic)
    index = drive.pairs(request, *generate.sizes(cell.traffic))
    sample = generate.check_sample(seed, cell.traffic, len(index))
    qs = [batches[b][0][index[p][0]] for b, p in sample]
    ts = [batches[b][1][index[p][1]] for b, p in sample]
    t0 = time.perf_counter()
    ref = answers(sc, request, qs, ts)
    out = {"seed": seed, "pairs": len(sample), "reference_s": time.perf_counter() - t0}
    for name, kw in CONTROLS.items():
        got = answers(sc, request, qs, ts, **kw)
        out[name] = sum(not drive.same(g, r) for g, r in zip(got, ref))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    rows = [readings(cell, s) for s in args.seed]
    print(json.dumps({"workload": args.workload, "readings": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
