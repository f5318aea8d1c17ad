"""Command-line interface of the port: ``python -m seqalib_tpu_torch <command>``
(counterpart of ``seqalib_tpu/cli.py``).

  align   one pair from the command line
  bench   run a BASELINE.json benchmark config (1-5) and print JSON

The subcommands, options, defaults and printed keys are the JAX CLI's:
``--backend`` takes any name of ``api.BACKENDS`` and defaults to ``pallas``,
as the JAX CLI does (``pallas`` and ``strip`` name the port's strip route,
``xla`` its full-matrix wavefront route, ``oracle`` the oracle), and a
bench line prints the name it was given.  Beyond them, ``--device`` (default ``cuda``) is passed to every
API call, and ``--trace DIR`` writes a ``torch.profiler`` Chrome trace of
the timed run into DIR.
Config 5 runs on a pair mesh, as in the JAX CLI: every visible card with
``--device cuda``, the named device alone otherwise.  A run that fails
raises: nothing falls back to another path or device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from contextlib import contextmanager

import numpy as np

from .api import BACKENDS


def _scoring(args):
    from .types import ScoringParams

    if getattr(args, "blosum62", False):
        return ScoringParams.blosum62(gap_open=args.gap_open, gap_extend=args.gap_extend)
    return ScoringParams(match=args.match, mismatch=args.mismatch,
                         gap_open=args.gap_open, gap_extend=args.gap_extend)


def cmd_align(args) -> int:
    from .api import align

    res = align(args.query, args.target, scoring=_scoring(args), mode=args.mode,
                band=args.band, backend=args.backend, device=args.device)
    print(json.dumps({
        "score": res.score,
        "query_start": res.query_start,
        "query_end": res.query_end,
        "target_start": res.target_start,
        "target_end": res.target_end,
        "cigar": res.cigar,
    }))
    return 0


def _synth(rng, n_pairs, lq, lt, alpha):
    qs = [rng.integers(0, alpha, rng.integers(lq // 2, lq + 1)).astype(np.uint8)
          for _ in range(n_pairs)]
    ts = [rng.integers(0, alpha, rng.integers(lt // 2, lt + 1)).astype(np.uint8)
          for _ in range(n_pairs)]
    return qs, ts


def _bench_setup(args, cfg, rng):
    """Build one config's inputs and runner.  Returns (sp, qs, ts, run,
    mode, band, traceback)."""
    from .api import align_batch
    from .types import ScoringParams

    if cfg == 1:  # NW global linear, 256bp DNA, full traceback
        sp = ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)
        qs, ts = _synth(rng, args.pairs, 256, 256, 4)
        mode, band, tb = "global", None, True
    elif cfg == 2:  # SW local linear, 1kb DNA, score + coords
        sp = ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)
        qs, ts = _synth(rng, args.pairs, 1024, 1024, 4)
        mode, band, tb = "local", None, False
    elif cfg == 3:  # Gotoh affine SW, BLOSUM62 protein, traceback
        sp = ScoringParams.blosum62()
        qs, ts = _synth(rng, args.pairs, 1024, 1024, 20)
        mode, band, tb = "local", None, True
    elif cfg == 4:  # banded affine NW long reads
        sp = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
        L = args.long_len
        qs, ts = [], []
        for _ in range(max(1, args.pairs // 8)):
            q = rng.integers(0, 4, L).astype(np.uint8)
            t = q.copy()
            idx = rng.choice(L, L // 50, replace=False)
            t[idx] = (t[idx] + 1 + rng.integers(0, 3, len(idx))) % 4
            qs.append(q)
            ts.append(t.astype(np.uint8))
        mode, band, tb = "global", args.band, not args.no_tb
    else:
        raise ValueError(f"unknown config {cfg}")

    def run():
        return align_batch(qs, ts, scoring=sp, mode=mode, band=band, backend=args.backend,
                           traceback=tb, device=args.device)

    return sp, qs, ts, run, mode, band, tb


def _bench_parity(res, qs, ts, sp, mode, band, tb, n_check, backend, device):
    """Parity gate: score + coords (+ CIGAR when traceback) of n_check pairs
    against the port's vectorized oracle (``oracle_fast``, bit for bit
    ``oracle.py``).  Banded long-read pairs are too large for the oracle:
    they are gated on same-path pairs cut to oracle-feasible lengths."""
    from .oracle_fast import align_oracle

    if band is not None and len(qs[0]) > 2048:
        from .api import align_batch

        qs = [q[:1024] for q in qs[:n_check]]
        ts = [t[: 1024 + band // 2] for t in ts[:n_check]]
        res = align_batch(qs, ts, scoring=sp, mode=mode, band=band, backend=backend,
                          device=device)
    bad = 0
    for b in range(min(n_check, len(qs))):
        ref = align_oracle(qs[b], ts[b], sp, mode=mode, band=band)
        got = res[b]
        same = (got.score == ref.score and got.query_start == ref.query_start
                and got.query_end == ref.query_end and got.target_start == ref.target_start
                and got.target_end == ref.target_end)
        if tb:
            same = same and got.cigar == ref.cigar
        bad += 0 if same else 1
    return bad


@contextmanager
def _traced(trace_dir, name, device):
    """``torch.profiler`` around the timed run; its Chrome trace is written
    to ``trace_dir/name.json``."""
    if not trace_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))


def _bench_mesh(device):
    """Config 5's pair mesh: every visible card for ``cuda`` (the JAX CLI's
    ``make_pair_mesh()`` over every device), else the one device named."""
    import torch

    from .parallel.dist import make_pair_mesh

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return make_pair_mesh()
    return make_pair_mesh([dev])


def _bench_five(args) -> dict:
    """Config 5 (BASELINE.json:11): all-vs-all SW, every read against every
    reference through ``align_all_vs_all`` (bucket-grouped chunked product,
    optionally resume-sharded), sharded over ``_bench_mesh``.  Contract scale is
    ``--reads 10000 --refs 1000`` (10M pairs); the default is a small smoke.
    Pairs/s and GCUPS are end-to-end wall over the whole product."""
    from .api import align_all_vs_all
    from .types import ScoringParams

    rng = np.random.default_rng(args.seed)
    sp = ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)
    reads, _ = _synth(rng, args.reads, args.read_len, args.read_len, 4)
    refs, _ = _synth(rng, args.refs, args.ref_len, args.ref_len, 4)
    mesh = _bench_mesh(args.device)
    kw = dict(scoring=sp, mode="local", backend=args.backend, mesh=mesh,
              chunk_pairs=args.chunk_pairs)
    # warm-up at the timed run's chunk shape: enough reads x all refs to
    # fill one chunk per bucket pair; a single-chunk product warms up on a
    # small corner instead of running twice
    if len(reads) * len(refs) <= args.chunk_pairs:
        align_all_vs_all(reads[: min(64, len(reads))], refs[: min(8, len(refs))], **kw)
    else:
        n_warm = min(len(reads), max(1, -(-args.chunk_pairs // max(1, len(refs))) + 1))
        align_all_vs_all(reads[:n_warm], refs, **kw)
    with _traced(args.trace, "config5", args.device):
        t_start = time.perf_counter()
        out = align_all_vs_all(reads, refs, resume_dir=args.resume_dir, **kw)
        dt = time.perf_counter() - t_start

    n_pairs = len(reads) * len(refs)
    cells = int(sum(len(q) for q in reads)) * int(sum(len(r) for r in refs))
    res = {
        "config": 5,
        "pairs": n_pairs,
        "reads": len(reads),
        "refs": len(refs),
        "wall_s": round(dt, 3),
        "pairs_per_sec": round(n_pairs / dt, 1),
        "gcups_end_to_end": round(cells / dt / 1e9, 3),
        "backend": args.backend,
        "chunk_pairs": args.chunk_pairs,
        "devices": len(mesh),
    }
    if args.parity_check:
        from .oracle_fast import align_oracle

        prng = np.random.default_rng(args.seed + 1)
        n_check = min(args.parity_pairs, n_pairs)
        bad = 0
        for _ in range(n_check):
            i = int(prng.integers(len(reads)))
            j = int(prng.integers(len(refs)))
            ref = align_oracle(reads[i], refs[j], sp, mode="local")
            same = (int(out["score"][i, j]) == ref.score
                    and int(out["qs"][i, j]) == ref.query_start
                    and int(out["qe"][i, j]) == ref.query_end
                    and int(out["ts"][i, j]) == ref.target_start
                    and int(out["te"][i, j]) == ref.target_end)
            bad += 0 if same else 1
        res["parity_pairs"] = n_check
        res["parity_ok"] = bad == 0
        if bad:
            res["parity_failures"] = bad
    return res


def _bench_one(args, cfg) -> dict:
    if cfg == 5:
        return _bench_five(args)
    rng = np.random.default_rng(args.seed)
    sp, qs, ts, run, mode, band, tb = _bench_setup(args, cfg, rng)
    run()  # warm-up: kernel build, caches
    with _traced(args.trace, f"config{cfg}", args.device):
        t_start = time.perf_counter()
        res = run()
        dt = time.perf_counter() - t_start

    if cfg == 4:
        cells = sum(len(q) * 2 * band for q in qs)
    else:
        cells = sum(len(q) * len(t) for q, t in zip(qs, ts))
    out = {
        "config": cfg,
        "pairs": len(qs),
        "wall_s": round(dt, 3),
        "pairs_per_sec": round(len(qs) / dt, 1),
        "gcups_end_to_end": round(cells / dt / 1e9, 3),
        "backend": args.backend,
        "example": str(res[0]),
    }
    if args.parity_check:
        bad = _bench_parity(res, qs, ts, sp, mode, band, tb, args.parity_pairs,
                            args.backend, args.device)
        out["parity_pairs"] = min(args.parity_pairs, len(qs))
        out["parity_ok"] = bad == 0
        if bad:
            out["parity_failures"] = bad
    return out


def cmd_bench(args) -> int:
    """Benchmark configs (BASELINE.json:7-11), end to end through the public
    API: dispatch, padding and host decode included (kernel-only GCUPS comes
    from ``python -m seqalib_tpu_torch.bench``).  ``bench all`` runs configs
    1-5, one JSON line each, and exits 1 if any fails its parity gate."""
    cfgs = [1, 2, 3, 4, 5] if args.config == "all" else [int(args.config)]
    rc = 0
    for cfg in cfgs:
        out = _bench_one(args, cfg)
        if args.parity_check and not out.get("parity_ok", True):
            rc = 1
        print(json.dumps(out), flush=True)
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="seqalib_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("align", help="align one pair")
    pa.add_argument("query")
    pa.add_argument("target")
    pa.add_argument("--mode", choices=["global", "local"], default="global")
    pa.add_argument("--backend", choices=BACKENDS, default="pallas")
    pa.add_argument("--device", default="cuda")
    pa.add_argument("--band", type=int, default=None)
    pa.add_argument("--match", type=int, default=2)
    pa.add_argument("--mismatch", type=int, default=-3)
    pa.add_argument("--gap-open", type=int, default=0)
    pa.add_argument("--gap-extend", type=int, default=-2)
    pa.add_argument("--blosum62", action="store_true")
    pa.set_defaults(fn=cmd_align)

    pb = sub.add_parser("bench", help="run a BASELINE benchmark config")
    pb.add_argument("config", choices=["1", "2", "3", "4", "5", "all"])
    pb.add_argument("--pairs", type=int, default=64)
    pb.add_argument("--reads", type=int, default=64,
                    help="config 5: number of short reads (contract: 10000)")
    pb.add_argument("--refs", type=int, default=8,
                    help="config 5: number of references (contract: 1000)")
    pb.add_argument("--read-len", type=int, default=256)
    pb.add_argument("--ref-len", type=int, default=1024)
    pb.add_argument("--chunk-pairs", type=int, default=8192,
                    help="config 5: pairs per device batch / resume shard")
    pb.add_argument("--resume-dir", default=None,
                    help="config 5: chunk-shard checkpoint/resume directory")
    pb.add_argument("--band", type=int, default=128)
    pb.add_argument("--long-len", type=int, default=10000)
    pb.add_argument("--no-tb", action="store_true",
                    help="config 4: fill-only (skip the checkpointed traceback)")
    pb.add_argument("--backend", choices=BACKENDS, default="pallas")
    pb.add_argument("--device", default="cuda")
    pb.add_argument("--seed", type=int, default=0)
    pb.add_argument("--parity-check", action="store_true")
    pb.add_argument("--parity-pairs", type=int, default=32,
                    help="pairs gated on full score+coords+CIGAR parity vs the oracle")
    pb.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the timed run to DIR")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
