"""Pair-stream distribution over a mesh of devices and over processes
(counterpart of ``seqalib_tpu/parallel/dist.py``).

The unit of parallelism is the pair.  A pair mesh is an ordered tuple of
``torch.device`` entries (``make_pair_mesh``), the same kind of mesh as the
sequence-parallel paths take; it may name one device several times.  A
bucket of B pairs is cut into contiguous shards in input order, one per
mesh entry; each shard runs the strip engine (``ops/strip.py``) or the
full-matrix wavefront (``ops/wavefront_xla.py``: the wide-table route and
``backend="xla"``) on its own device, and the results are joined in shard
order.  Every shard is launched before any is
finalized.  The banded route (``dispatch.dispatch_banded``) splits each of
its batches (the delta groups that ``banded_batches`` joins) the same way
but runs the parts one after another, each returning host results before
the next starts: on a mesh of distinct cards it gains nothing over one
card.

With ``torch.distributed`` initialized and a world of W > 1 processes, the
shard list is ``W x len(mesh)`` long, rank-major: every rank holds the
whole input, runs only its own ``len(mesh)`` shards, and ``gather_to_host``
all-gathers the small host results (the five coordinates and the CIGAR
text), so that every rank returns the whole batch in input order.  The
banded route refuses such a world (``refuse_multiprocess``).  The
gather runs over a gloo group: NCCL gathers no CPU tensors and refuses two
ranks on one card.

The JAX package pads each bucket with zero-length sentinel pairs to a
multiple of the mesh (``shard_map`` needs equal shards).  The port's
kernels take any batch, so its shards may differ in size by one and an
empty shard is skipped; the results are the same either way.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from ..devices import Mesh, device_mesh
from ..ops.strip import pass2_knobs, strip_launch
from ..ops.wavefront_xla import xla_launch
from ..scoring import tables_from_params
from ..types import ScoringParams

FIELDS = ("score", "qs", "qe", "ts", "te")
# the default process group and the gloo group made for it: one entry
_HOST_GROUP: list = []


def make_pair_mesh(devices=None) -> Mesh:
    """The pair mesh: the given devices in order (``["cpu"] * k`` on the
    CPU, ``["cuda:0"] * 4`` for four shards on one card), or every visible
    CUDA device (raises when there is none)."""
    return device_mesh(devices, "make_pair_mesh")


def as_mesh(mesh) -> Mesh:
    """``mesh`` (a sequence of devices or device names) as a pair mesh."""
    if isinstance(mesh, (str, torch.device)) or not hasattr(mesh, "__iter__"):
        raise TypeError(f"a mesh is a sequence of devices (make_pair_mesh), got {mesh!r}")
    return make_pair_mesh(list(mesh))


def world() -> tuple[int, int]:
    """(rank, world size) of the default ``torch.distributed`` group; (0, 1)
    when none is initialized."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def refuse_multiprocess(route: str) -> None:
    """Raise on a route that has no multi-process version (the banded route:
    the JAX package's places its parts on devices by index and syncs per
    part, so it has none either)."""
    if world()[1] > 1:
        raise NotImplementedError(
            f"the {route} under a mesh runs in one process only, as in the JAX "
            "package; it has no multi-process version (ROADMAP.md, Queue 1)")


def shard_bounds(B: int, n: int) -> List[tuple[int, int]]:
    """``n`` contiguous (lo, hi) shards of ``range(B)`` in order, their
    sizes differing by at most one (the first ``B % n`` one larger)."""
    base, extra = divmod(B, n)
    out, lo = [], 0
    for s in range(n):
        hi = lo + base + (s < extra)
        out.append((lo, hi))
        lo = hi
    return out


def my_shards(mesh: Mesh, B: int) -> List[tuple[torch.device, int, int]]:
    """This rank's shards of a B-pair bucket: (device, lo, hi), empty ones
    left out."""
    rank, W = world()
    D = len(mesh)
    bounds = shard_bounds(B, W * D)[rank * D: (rank + 1) * D]
    return [(dev, lo, hi) for dev, (lo, hi) in zip(mesh, bounds) if hi > lo]


def _join(parts: List[dict], want_tb: bool) -> dict:
    """The shards' results in shard order: the five fields (+ cigars)."""
    out = {f: np.concatenate([p[f] for p in parts] or [np.zeros(0, np.int32)])
           for f in FIELDS}
    if want_tb:
        out["cigars"] = [c for p in parts for c in p["cigars"]]
    return out


def strip_sharded(mesh: Mesh, q, t, qlen, tlen, sp: ScoringParams, *, mode: str,
                  want_tb: bool, launch_only: bool = False, **strip_kw):
    """Align one padded bucket (B, n) x (B, m) on the strip engine, sharded
    over ``mesh`` (and over the processes of a ``torch.distributed`` world).

    Each shard runs ``strip_launch`` on its own device with that device's
    ``Tables``; every shard is launched before any is finalized, and the
    launch half makes no device-to-host sync.  ``strip_kw`` goes to
    ``strip_launch`` (``WR``, ``pass2``, ``tie_safe``, ``BW``), over the
    pass-2 knobs this process reads once (``pass2_knobs``: every shard runs
    the same window and band; each rank of a world reads its own
    environment, as the JAX package's ranks do); the pointer budget
    (``ptr_cap_bytes``) applies to each shard.  Returns the finalize
    callable with ``launch_only``, else its result: ``score``/``qs``/``qe``/
    ``ts``/``te`` (B,) int32 (+ ``cigars`` with ``want_tb``) for the whole
    batch on every rank."""
    q, t = np.asarray(q), np.asarray(t)
    qlen, tlen = np.asarray(qlen), np.asarray(tlen)
    tables: Dict[torch.device, object] = {}
    strip_kw = {**pass2_knobs(), **strip_kw}
    pending = []
    for dev, lo, hi in my_shards(mesh, len(qlen)):
        if dev not in tables:
            tables[dev] = tables_from_params(sp, dev)
        pending.append(strip_launch(q[lo:hi], t[lo:hi], qlen[lo:hi], tlen[lo:hi],
                                    tables[dev], mode=mode, want_tb=want_tb, **strip_kw))

    def finish():
        return gather_to_host(_join([p() for p in pending], want_tb))

    return finish if launch_only else finish()


def wavefront_sharded(mesh: Mesh, q, t, qlen, tlen, sp: ScoringParams, *,
                      band: int | None, want_tb: bool, mode: str = "global",
                      launch_only: bool = False):
    """The full-matrix wavefront route of one padded bucket (``xla_launch``:
    the wide-table route, ``wavefront_bucket``, is its global mode with a
    band), sharded over ``mesh`` (and over the processes of a
    ``torch.distributed`` world) as ``strip_sharded`` shards (counterpart of
    ``wavefront_sharded``, which the JAX package runs for every ``"xla"``
    bucket under a mesh): each shard runs ``xla_launch`` on its own device,
    in any mode it takes (global, banded or not, linear or affine; local),
    and every shard is launched before any is finalized.  In global mode
    the launch half makes no device-to-host sync; in local mode each
    shard's pass (a) is enqueued first, and the finalizes run passes (b)
    and (c), which sync on the host, one shard after another.  Returns the
    finalize callable with ``launch_only``, else its result, as
    ``strip_sharded``."""
    q, t = np.asarray(q), np.asarray(t)
    qlen, tlen = np.asarray(qlen), np.asarray(tlen)
    pending = [xla_launch(q[lo:hi], t[lo:hi], qlen[lo:hi], tlen[lo:hi], sp, mode=mode,
                          band=band, want_tb=want_tb, device=dev)
               for dev, lo, hi in my_shards(mesh, len(qlen))]

    def finish():
        return gather_to_host(_join([p() for p in pending], want_tb))

    return finish if launch_only else finish()


def broadcast_host(arr: np.ndarray) -> np.ndarray:
    """Rank 0's ``arr`` on every rank (each rank passes an array of the
    same shape and dtype); ``arr`` as it is with one process."""
    _, W = world()
    if W == 1:
        return arr
    import torch.distributed as tdist

    buf = torch.from_numpy(np.ascontiguousarray(arr))
    tdist.broadcast(buf, src=0, group=_host_group())
    return buf.numpy()


def _host_group():
    """The group to gather host tensors over: the default group when it is
    gloo, else a gloo group made once for it (the last one kept)."""
    import torch.distributed as tdist

    if tdist.get_backend() == "gloo":
        return None
    default = tdist.group.WORLD
    if not _HOST_GROUP or _HOST_GROUP[0] is not default:
        _HOST_GROUP[:] = [default, tdist.new_group(backend="gloo")]
    return _HOST_GROUP[1]


def gather_to_host(out: dict) -> dict:
    """This rank's host results (``FIELDS`` (+ ``cigars``), its shards in
    order) joined with every other rank's, rank-major, on every rank.  With
    one process, ``out`` as it is.

    Ranks may hold different row counts: the counts and the CIGAR text
    widths are gathered first, then every rank's rows padded to the
    largest.  The CIGARs travel as text rows plus their lengths, never as
    pointer streams."""
    _, W = world()
    if W == 1:
        return out
    import torch.distributed as tdist

    group = _host_group()
    want_tb = "cigars" in out
    n = len(out["score"])
    text = [c.encode() for c in out["cigars"]] if want_tb else []
    sizes = [torch.zeros(2, dtype=torch.int64) for _ in range(W)]
    tdist.all_gather(sizes, torch.tensor([n, max(map(len, text), default=0)]), group=group)
    rows = [int(s[0]) for s in sizes]
    R = max(max(rows), 1)
    width = max(max(int(s[1]) for s in sizes), 1)
    vals = np.zeros((len(FIELDS), R), np.int32)
    for i, f in enumerate(FIELDS):
        vals[i, :n] = out[f]
    got_vals = [torch.zeros((len(FIELDS), R), dtype=torch.int32) for _ in range(W)]
    tdist.all_gather(got_vals, torch.from_numpy(vals), group=group)
    res = {f: np.concatenate([g[i, :r].numpy() for g, r in zip(got_vals, rows)])
           for i, f in enumerate(FIELDS)}
    if want_tb:
        rows_text = np.zeros((R, width), np.uint8)
        nchar = np.zeros(R, np.int32)
        for b, c in enumerate(text):
            rows_text[b, : len(c)] = np.frombuffer(c, np.uint8)
            nchar[b] = len(c)
        got_text = [torch.zeros((R, width), dtype=torch.uint8) for _ in range(W)]
        got_n = [torch.zeros(R, dtype=torch.int32) for _ in range(W)]
        tdist.all_gather(got_text, torch.from_numpy(rows_text), group=group)
        tdist.all_gather(got_n, torch.from_numpy(nchar), group=group)
        res["cigars"] = [bytes(g[b, : int(k[b])].numpy()).decode()
                         for g, k, r in zip(got_text, got_n, rows) for b in range(r)]
    return res


def _example_batch(B: int, L: int, alphabet: int, seed: int):
    """``__graft_entry__._example_batch``'s pairs, as lists of letter codes."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, alphabet, size=(B, L))
    t = rng.integers(0, alphabet, size=(B, L))
    qlen = rng.integers(L // 2, L + 1, size=(B,))
    tlen = rng.integers(L // 2, L + 1, size=(B,))
    return ([q[b, : qlen[b]].astype(np.uint8) for b in range(B)],
            [t[b, : tlen[b]].astype(np.uint8) for b in range(B)])


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One sharded step of the batched pipeline over a pair mesh of
    ``n_devices`` entries, each result held to the oracle at the
    ``str(AlignResult)`` level (counterpart of ``__graft_entry__``'s
    ``dryrun_multichip``): B = 2n + 1 BLOSUM62 pairs, local with full CIGARs
    on both pass-2 engines, then global; and the banded route's delta
    groups spread over the mesh (n + 3 DNA pairs, band 8).

    ``device=None`` asks for ``n_devices`` distinct CUDA devices and raises
    when fewer exist; ``device="cuda:0"`` (or ``"cpu"``) names that one
    device ``n_devices`` times.  ``SEQALIB_FUSED_PASS2`` is set for the
    strip engine's step and restored to its previous value after."""
    from ..api import align_batch
    from ..oracle_fast import align_oracle

    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(
                f"dryrun_multichip: {n_devices} CUDA devices asked for, {have} visible; "
                f"pass device= to name one device {n_devices} times")
        mesh = make_pair_mesh([f"cuda:{i}" for i in range(n_devices)])
    else:
        mesh = make_pair_mesh([device] * n_devices)

    def check(res, qs, ts, sp, mode, band=None):
        for b, (q, t) in enumerate(zip(qs, ts)):
            want = str(align_oracle(q, t, sp, mode=mode, band=band))
            if str(res[b]) != want:
                raise AssertionError(f"dryrun_multichip {mode} pair {b}: {res[b]} != {want}")

    sp = ScoringParams.blosum62()
    qs, ts = _example_batch(2 * n_devices + 1, 48, 20, seed=3)
    key = "SEQALIB_FUSED_PASS2"
    old = os.environ.get(key)
    try:
        for engine in ("banded", "strip"):
            os.environ[key] = engine
            res = align_batch(qs, ts, scoring=sp, mode="local", traceback=True, mesh=mesh)
            check(res, qs, ts, sp, "local")
    finally:
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old
    check(align_batch(qs, ts, scoring=sp, mode="global", traceback=True, mesh=mesh),
          qs, ts, sp, "global")

    sp2 = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
    rng = np.random.default_rng(9)
    qs4 = [rng.integers(0, 4, 72 - (b % 3)).astype(np.uint8) for b in range(n_devices + 3)]
    ts4 = []
    for q4 in qs4:
        t4 = q4.copy()
        t4[::17] = (t4[::17] + 1) % 4
        ts4.append(t4)
    check(align_batch(qs4, ts4, scoring=sp2, mode="global", band=8, mesh=mesh),
          qs4, ts4, sp2, "global", band=8)
