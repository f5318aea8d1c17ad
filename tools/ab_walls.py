#!/usr/bin/env python3
"""Warm walls of ``align_batch`` for two trees of the repository, taking
turns in one run on one card.

    python3 tools/ab_walls.py --parent DIR [--rounds 10] [--calls 10]
                              [--configs 3,1,2,wide,wide_score,xla3,xla2,xla1,4,4wide]

Each tree runs in a worker process of its own (this script with
``--worker ROOT``: it imports ``seqalib_tpu_torch`` from ROOT, builds its
kernels, and takes its inputs from ``tools/profile_port.py``: config 3,
config 1 and the wide table, seed 0, full CIGARs, and config 2 and the wide
table as ``wide_score``, score and coordinates only; ``xla3``, ``xla2`` and
``xla1`` are configs 3, 2 and 1 on ``backend="xla"``, the full-matrix
wavefront route, config 2 score-only; ``4`` is config 4, B=64 pairs of
10 kb at band 128, and ``4wide`` its long window, one 10 kb read against a
window 17 000 letters longer, the wide ``band_fill``).  Both workers stay alive
for the whole run.  The configs run one after another; for each, the two
workers take turns for ``--rounds`` rounds: this tree first on even
rounds, the parent first on odd ones, so that neither always runs first.
(Rounds that interleaved the configs set two copies of one tree 3 ms
apart on config 1, the same copy slower in 5 of 6 rounds, on an H100 80GB
HBM3 at 700 W.)  A worker runs two warm-up calls the first time it meets
a config, then answers with the host-clock walls of ``--calls`` calls,
each synchronized.  The script prints the card's name and power limit,
then one line per round and config with both medians, then per config the
range of each tree's medians, their medians, the distance between the
quartiles of the parent's, and the rounds the change won.  Its last line
is a JSON summary.  Needs a CUDA card.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()


def worker(root: str) -> int:
    sys.path.insert(0, root)
    import seqalib_tpu_torch as st  # the tree's own package
    import torch

    if not Path(st.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {st.__file__}, not the tree at {root}")
    sys.path.insert(1, str(HERE.parent))
    import profile_port  # its inputs; it reuses the package imported above

    from seqalib_tpu_torch import _build

    _build.lib()
    dev = torch.device("cuda")
    runs = {}
    print("ready", flush=True)
    for line in sys.stdin:
        config, calls = line.split()
        if config not in runs:
            wide = config.startswith("wide")
            xla = {"backend": "xla"} if config.startswith("xla") else {}
            base = config[3:] if xla else config
            qs, ts, sp, mode = profile_port.inputs("wide" if wide else base,
                                                   64 if wide or base == "4" else 512)
            band = 64 if wide else (128 if base in ("4", "4wide") else None)
            tb = base not in ("2", "wide_score")

            def run(qs=qs, ts=ts, sp=sp, mode=mode, band=band, tb=tb, xla=xla):
                st.align_batch(qs, ts, scoring=sp, mode=mode, band=band, traceback=tb,
                               device=dev, **xla)
                torch.cuda.synchronize()

            runs[config] = run
            for _ in range(2):
                run()
        walls = []
        for _ in range(int(calls)):
            t0 = time.perf_counter()
            runs[config]()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps(walls), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of the other tree")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--configs", default="3,1,wide")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker)
    import torch

    if not torch.cuda.is_available() or not args.parent:
        print("ab_walls: needs a CUDA card and --parent", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    trees = {"change": str(HERE.parents[1]), "parent": str(Path(args.parent).resolve())}
    procs = {name: subprocess.Popen([sys.executable, str(HERE), "--worker", root],
                                    stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
             for name, root in trees.items()}
    try:
        for name, p in procs.items():
            if p.stdout.readline().strip() != "ready":
                raise RuntimeError(f"the {name} worker did not start")
        configs = args.configs.split(",")
        medians = {c: {n: [] for n in trees} for c in configs}
        walls = {c: {n: [] for n in trees} for c in configs}
        for c in configs:
            for r in range(args.rounds):
                order = list(trees) if r % 2 == 0 else list(trees)[::-1]
                for name in order:
                    p = procs[name]
                    p.stdin.write(f"{c} {args.calls}\n")
                    p.stdin.flush()
                    w = json.loads(p.stdout.readline())
                    walls[c][name].append(w)
                    medians[c][name].append(statistics.median(w))
                print(f"[round {r}] config {c}: change {medians[c]['change'][-1]:.3f} ms, "
                      f"parent {medians[c]['parent'][-1]:.3f} ms (first: {order[0]})",
                      flush=True)
    finally:
        for p in procs.values():
            p.stdin.close()
        for p in procs.values():
            p.wait(timeout=60)
    for c in configs:
        ch, pa = medians[c]["change"], medians[c]["parent"]
        faster = sum(x < y for x, y in zip(ch, pa))
        q = statistics.quantiles(pa, n=4) if len(pa) > 1 else [pa[0]] * 3
        print(f"[walls] config {c}: change {min(ch):.3f}-{max(ch):.3f} ms (median of medians "
              f"{statistics.median(ch):.3f}), parent {min(pa):.3f}-{max(pa):.3f} "
              f"({statistics.median(pa):.3f}, quartiles {q[2] - q[0]:.3f} apart); change "
              f"faster in {faster} of {len(ch)} rounds")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "medians_ms": medians,
                      "walls_ms": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
