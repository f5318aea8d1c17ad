#!/usr/bin/env python3
"""Probe the sweep's near-overflow draws past the contract's scale, and the
tie-safe escalation there.

    python3 tools/sweep_probe.py [--device cuda] [--extra 1] [--tie-safe]

The sweep (``seqalib_tpu_torch/sweep.py``) scales DNA affine scoring by
2^k, k the largest with |o| + (n + m) max(|e|, |s|) <= 2^29.  This script
runs the sweep's overflow draws (seed 0, ``sweep.COUNT`` draws) with k
raised by each ``--extra`` (bounds up to 2^30, 2^31, ...) through every
route of ``sweep.ROUTES`` on ``--device`` and prints, per route, how many
results differ from the oracle (a route that raises says so).  With
``--tie-safe`` it also runs the local strip routes under
``SEQALIB_FUSED_TIE_SAFE=1`` on both pass-2 engines, at the contract's
scale and the raised ones.  Nothing fails: the lines are the finding.  On a
CUDA device the card's name and power limit come first.
"""

import argparse
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from seqalib_tpu_torch import sweep  # noqa: E402


def report(api, label, names, ds):
    for name in names:
        try:
            res = sweep.run_route(api, name, ds)
        except Exception as e:  # the finding: which route raises, and how
            print(f"[probe] {label} {name}: raised {type(e).__name__}: {str(e)[:160]}",
                  flush=True)
            continue
        try:
            oracle = sweep.oracle_results(res, processes=4)
        except Exception as e:  # past int32's range the oracle's own sentinels give out
            print(f"[probe] {label} {name}: the oracle raised {type(e).__name__}: "
                  f"{str(e)[:160]}", flush=True)
            continue
        bad = sweep.check(res, oracle)
        print(f"[probe] {label} {name}: {len(bad)} of {len(res)} differ from the oracle",
              flush=True)
        for line in bad[:3]:
            print("   ", line[:300], flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--extra", type=int, nargs="*", default=[1])
    ap.add_argument("--tie-safe", action="store_true")
    args = ap.parse_args()
    if args.device.startswith("cuda"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True, capture_output=True,
                             text=True).stdout.strip(), flush=True)
    api = sweep.PortAPI(args.device)
    ds = [d for d in sweep.draws() if d.scoring == "overflow"]
    for extra in args.extra:
        scaled = [dataclasses.replace(d, shift=d.shift + extra) for d in ds]
        report(api, f"2^k x {1 << extra}", list(sweep.ROUTES), scaled)
    if args.tie_safe:
        os.environ["SEQALIB_FUSED_TIE_SAFE"] = "1"
        for extra in (0, *args.extra):
            scaled = [dataclasses.replace(d, shift=d.shift + extra) for d in ds]
            report(api, f"tie-safe 2^k x {1 << extra}",
                   ["strip", "pallas_score", "strip_pass2", "strip_pass2_score"], scaled)
    return 0


if __name__ == "__main__":
    sys.exit(main())
