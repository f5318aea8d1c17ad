"""One rank of a multi-process check of the pair-stream distribution layer.

Run one process per rank, all with the same ``--store`` file (a
``torch.distributed.FileStore``; the ranks meet there, with no network)::

    python -m seqalib_tpu_torch.parallel.dist_check --rank 0 --world 2 --store F &
    python -m seqalib_tpu_torch.parallel.dist_check --rank 1 --world 2 --store F

Each rank builds a pair mesh of ``--mesh`` entries naming ``--device``
(default ``cuda``, which raises without a card; ``--device cpu`` runs on
the CPU), so that the bucket is cut into ``world x mesh`` shards,
rank-major, and joins a gloo group (a 60 s timeout).  Without
``--inputs`` it aligns 16 seeded DNA pairs (match 2, mismatch -3, o=-5,
e=-2) with ``align_batch(..., backend="pallas", mesh=...)``, local and
global with full CIGARs, and holds every result to the oracle at the
``str(AlignResult)`` level; then 9 seeded protein pairs on the wide-table
route (2 x BLOSUM62, o=-20, e=-2, band 8, global) with and without CIGARs,
each equal to the one-process batch (``mesh=None``) and, with CIGARs, to
the oracle; then a 6 x 4 ``align_all_vs_all`` product in
chunks of 5 pairs, every entry equal to the oracle's, with a
``resume_dir`` of each rank's own that only rank 0 writes; rank 0 then
deletes one shard, and the product run again realigns that chunk alone
on every rank and equals the first.  With ``--inputs
FILE.npz`` (arrays ``q``, ``t``, ``qlen``, ``tlen``, ``match``,
``mismatch``, ``gap_open``, ``gap_extend``, ``matrix`` (empty for none),
``mode``, ``band`` where the batch is banded and ``backend`` where it is
not ``"pallas"``) it runs that batch
once to warm up and ``--reps`` times timed, and prints the median wall
(``PAIRMESH-WALL r<rank> <s> <walls>``) and a BLAKE2b hash of the results'
``str`` joined by newlines (``PAIRMESH-HASH r<rank> <hex>``).  Either way
it checks that no module of JAX or of the JAX package was loaded, then
prints ``PAIRMESH-OK r<rank>``; a failure raises (exit code 1).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import statistics
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as tdist


def _seeded_pairs():
    # both ranks draw the same pairs: every rank holds the whole input
    rng = np.random.default_rng(123)
    qs = [rng.integers(0, 4, size=rng.integers(40, 90)).astype(np.uint8) for _ in range(16)]
    ts = [rng.integers(0, 4, size=rng.integers(40, 90)).astype(np.uint8) for _ in range(16)]
    return qs, ts


def check_seeded(rank: int, mesh) -> None:
    """The 16 seeded pairs, local and global, equal to the oracle."""
    from .. import ScoringParams, align_batch
    from ..oracle_fast import align_oracle

    sp = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
    qs, ts = _seeded_pairs()
    for mode in ("local", "global"):
        res = align_batch(qs, ts, scoring=sp, mode=mode, backend="pallas", mesh=mesh,
                          traceback=True)
        if len(res) != len(qs):
            raise AssertionError(f"rank {rank} {mode}: {len(res)} results for {len(qs)} pairs")
        for b, (q, t) in enumerate(zip(qs, ts)):
            want = str(align_oracle(q, t, sp, mode=mode))
            if str(res[b]) != want:
                raise AssertionError(f"rank {rank} {mode} pair {b}: {res[b]} != {want}")
    check_wide(rank, mesh)
    # a product in chunks of 5 pairs: every chunk sharded over the world
    with tempfile.TemporaryDirectory() as own:
        check_product(rank, mesh, sp, qs[:6], ts[:4], own)


def check_wide(rank: int, mesh) -> None:
    """The wide-table route (a table outside [-4, 11], banded, global)
    sharded over the world: equal to the one-process batch, and with
    CIGARs to the oracle."""
    from .. import BLOSUM62, ScoringParams, align_batch
    from ..oracle_fast import align_oracle

    sp = ScoringParams(gap_open=-20, gap_extend=-2, matrix=2 * BLOSUM62)
    rng = np.random.default_rng(7)
    qs = [rng.integers(0, 20, size=rng.integers(30, 60)).astype(np.uint8) for _ in range(9)]
    ts = [np.concatenate([q[3:], rng.integers(0, 20, size=rng.integers(0, 5))])
          .astype(np.uint8) for q in qs]
    kw = dict(scoring=sp, mode="global", band=8)
    oracle = [align_oracle(q, t, sp, mode="global", band=8) for q, t in zip(qs, ts)]
    for tb in (True, False):
        got = align_batch(qs, ts, mesh=mesh, traceback=tb, **kw)
        want = align_batch(qs, ts, device=mesh[0], traceback=tb, **kw)
        if list(map(str, got)) != list(map(str, want)):
            raise AssertionError(f"rank {rank} wide-table route, traceback={tb}: differs "
                                 "from the one-process batch")
        for b, (g, o) in enumerate(zip(got, oracle)):
            if (str(g) != str(o)) if tb else (g.score != o.score):
                raise AssertionError(f"rank {rank} wide pair {b}: {g} != the oracle's {o}")


def check_product(rank: int, mesh, sp, qs, ts, own: str) -> None:
    """The product equal to the oracle; then resumed from ``own``, a
    directory of this rank's that rank 0 alone writes: rank 1 finds no
    shard there, yet realigns only the chunk whose shard rank 0 deleted."""
    from .. import align_all_vs_all
    from ..oracle_fast import align_oracle
    from . import dispatch

    fields = ("score", "qs", "qe", "ts", "te")
    out = align_all_vs_all(qs, ts, scoring=sp, mesh=mesh, chunk_pairs=5, resume_dir=own)
    for i, q in enumerate(qs):
        for j, t in enumerate(ts):
            want = align_oracle(q, t, sp, mode="local")
            got = tuple(int(out[f][i, j]) for f in fields)
            if got != (want.score, want.query_start, want.query_end, want.target_start,
                       want.target_end):
                raise AssertionError(f"rank {rank} product ({i}, {j}): {got} != {want}")
    names = sorted(os.listdir(own))
    if (rank == 0) != bool(names) or (rank == 0 and len(names) < 2):
        raise AssertionError(f"rank {rank} resume dir holds {names}")
    if rank == 0:
        os.remove(os.path.join(own, names[1]))
    ran = []
    real = dispatch.run_bucket

    def counted(*a, **k):
        ran.append(len(a[0]))
        return real(*a, **k)

    dispatch.run_bucket = counted
    try:
        again = align_all_vs_all(qs, ts, scoring=sp, mesh=mesh, chunk_pairs=5, resume_dir=own)
    finally:
        dispatch.run_bucket = real
    if len(ran) != 1:
        raise AssertionError(f"rank {rank} realigned {len(ran)} chunks, not the one deleted")
    for f in fields:
        if not np.array_equal(again[f], out[f]):
            raise AssertionError(f"rank {rank} resumed product: {f} differs")
    if rank == 0 and sorted(os.listdir(own)) != names:
        raise AssertionError("rank 0 did not write the realigned chunk's shard again")


def run_inputs(rank: int, mesh, path: str, reps: int) -> None:
    """The batch of ``path``: warm-up, ``reps`` timed calls, wall and hash."""
    from .. import ScoringParams, align_batch

    with np.load(path) as z:
        q, t, qlen, tlen = z["q"], z["t"], z["qlen"], z["tlen"]
        matrix = z["matrix"]
        sp = ScoringParams(match=int(z["match"]), mismatch=int(z["mismatch"]),
                           gap_open=int(z["gap_open"]), gap_extend=int(z["gap_extend"]),
                           matrix=matrix if matrix.size else None)
        mode = str(z["mode"])
        band = int(z["band"]) if "band" in z.files else None
        backend = str(z["backend"]) if "backend" in z.files else "pallas"
    qs = [q[b, : qlen[b]] for b in range(len(qlen))]
    ts = [t[b, : tlen[b]] for b in range(len(tlen))]

    def run():
        return align_batch(qs, ts, scoring=sp, mode=mode, band=band, backend=backend,
                           mesh=mesh, traceback=True)

    res = run()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
    digest = hashlib.blake2b("\n".join(map(str, res)).encode(), digest_size=16).hexdigest()
    if walls:
        print(f"PAIRMESH-WALL r{rank} {statistics.median(walls)!r} {walls}", flush=True)
    print(f"PAIRMESH-HASH r{rank} {digest}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m seqalib_tpu_torch.parallel.dist_check")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--store", required=True, help="FileStore path shared by the ranks")
    p.add_argument("--device", default="cuda")
    p.add_argument("--mesh", type=int, default=2, help="mesh entries per rank")
    p.add_argument("--inputs", default=None, help="an .npz batch to align and hash")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)

    torch.set_num_threads(1)
    from .dist import make_pair_mesh, world

    # before the rendezvous, so that a rank without the device fails at once
    mesh = make_pair_mesh([args.device] * args.mesh)
    tdist.init_process_group("gloo", store=tdist.FileStore(args.store, args.world),
                             rank=args.rank, world_size=args.world,
                             timeout=timedelta(seconds=60))
    try:
        if world() != (args.rank, args.world):
            raise AssertionError(f"world {world()} != ({args.rank}, {args.world})")
        if args.inputs:
            run_inputs(args.rank, mesh, args.inputs, args.reps)
        else:
            check_seeded(args.rank, mesh)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "seqalib_tpu"))
        if bad:
            raise AssertionError(f"JAX or the JAX package was loaded: {bad[:5]}")
        print(f"PAIRMESH-OK r{args.rank}", flush=True)
    finally:
        tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
