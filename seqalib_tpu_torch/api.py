"""Public alignment API of the port (counterpart of ``seqalib_tpu/api.py``).

``align``: one pair.  ``align_batch``: many pairs through the bucketed
dispatcher.  ``align_all_vs_all``: every query against every reference,
in chunks, with resume shards.  Same parameters as the JAX package, plus ``device``
(default ``"cuda"``).  Backends: ``"strip"`` (the default of
``align_batch`` and ``align_all_vs_all``: the CUDA kernels on a CUDA
device, their plain PyTorch versions on the CPU; with ``band=`` and
``mode="global"`` the banded long-read path), also named ``"pallas"`` (the
JAX package's name, so that code written for it runs here); ``"xla"`` (the
default of ``align``, as in the JAX package: its full-matrix anti-diagonal
wavefront, ``ops/wavefront_xla.py``, on the CUDA kernels of
``csrc/wavefront_fill.cu`` and ``csrc/wavefront_walk.cu``, every bucket,
banded or not); and ``"oracle"`` (the port's NumPy oracle,
``oracle_fast``: bit for bit ``oracle.py``, vectorized over anti-diagonals,
``band=`` included).

``mesh=`` (a pair mesh, ``make_pair_mesh``: a sequence of devices, which
may name one device several times) shards each bucket's pairs over the
mesh's devices, and over the processes of a ``torch.distributed`` world
(``parallel/dist.py``); ``device`` is then not used.  Each backend keeps
its route under a mesh: ``"xla"`` shards the full-matrix wavefront, banded
or not, as the JAX package does.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .devices import as_device
from .telemetry import traced
from .types import (
    PROTEIN_SIZE,
    AlignResult,
    ScoringParams,
    encode_dna,
    encode_protein,
)

# the strip route's names: the port's own and the JAX package's
STRIP_NAMES = ("strip", "pallas")
# the backends that run on a device: the strip route and the wavefront's
DEVICE_BACKENDS = STRIP_NAMES + ("xla",)
BACKENDS = DEVICE_BACKENDS + ("oracle",)
AVALL_FIELDS = ("score", "qs", "qe", "ts", "te")

log = logging.getLogger("seqalib_tpu_torch.api")


def _coerce(seq, sp: ScoringParams) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        return seq if seq.dtype == np.uint8 else seq.astype(np.uint8)
    if sp.matrix is not None and sp.matrix.shape[0] >= PROTEIN_SIZE:
        return encode_protein(seq)
    return encode_dna(seq)


@traced("seqalib.align")
def align(
    query,
    target,
    scoring: Optional[ScoringParams] = None,
    mode: str = "global",
    band: Optional[int] = None,
    backend: str = "xla",
    device="cuda",
) -> AlignResult:
    """Align one query/target pair and return score, coords, CIGAR."""
    return align_batch(
        [query], [target], scoring=scoring, mode=mode, band=band,
        backend=backend, device=device,
    )[0]


@traced("seqalib.align_batch")
def align_batch(
    queries: Sequence,
    targets: Sequence,
    scoring: Optional[ScoringParams] = None,
    mode: str = "local",
    band: Optional[int] = None,
    backend: str = "strip",
    traceback: bool = True,
    mesh=None,
    device="cuda",
) -> List[AlignResult]:
    """Align pairs[i] = (queries[i], targets[i]) through the length-bucketed
    dispatcher on ``device``, or sharded over ``mesh``."""
    if mode not in ("local", "global"):
        raise ValueError(f"mode must be global|local, got {mode!r}")
    if band is not None and mode == "local":
        raise ValueError(
            "banded local alignment is out of contract: band= applies to "
            'mode="global" only (BASELINE.json:10 is banded affine NW)'
        )
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    sp = scoring if scoring is not None else ScoringParams.linear()
    qs = [_coerce(q, sp) for q in queries]
    ts = [_coerce(t, sp) for t in targets]
    if len(qs) != len(ts):
        raise ValueError("queries and targets must have equal length")

    if backend == "oracle":
        from .oracle_fast import align_oracle

        return [align_oracle(q, t, sp, mode=mode, band=band) for q, t in zip(qs, ts)]
    from .parallel.dispatch import dispatch_batch
    from .parallel.dist import as_mesh

    mesh = None if mesh is None else as_mesh(mesh)
    return dispatch_batch(qs, ts, sp, mode=mode, band=band, traceback=traceback,
                          device=None if mesh else as_device(device), mesh=mesh,
                          backend=backend)


def _avall_key(qs, rs, chunk_pairs: int, sp: ScoringParams, mode: str) -> str:
    """Content key for resume shards: inputs, chunking, scoring, and mode
    must all match (backend is deliberately excluded — all backends are
    bit-exact by contract, so shards are interchangeable across them, and
    across this package and the JAX one).  A copy of
    ``seqalib_tpu/api.py::_avall_key``."""
    h = hashlib.blake2b(digest_size=16)
    h.update(
        str(
            (
                "avall-v2-grouped",  # chunk layout version: bucket-grouped
                len(qs),
                len(rs),
                chunk_pairs,
                mode,
                sp.match,
                sp.mismatch,
                sp.gap_open,
                sp.gap_extend,
            )
        ).encode()
    )
    if sp.matrix is not None:
        h.update(np.asarray(sp.matrix).tobytes())
    h.update(b"#")
    for s in qs:
        h.update(s.tobytes())
        h.update(b"|")
    h.update(b"#")
    for s in rs:
        h.update(s.tobytes())
        h.update(b"|")
    return h.hexdigest()


def _load_shard(shard: str, n: int, key: str, out: Dict[str, np.ndarray]) -> bool:
    """Scatter a finished chunk shard of ``n`` pairs into ``out``; False
    (and nothing scattered) when it is stale."""
    with np.load(shard) as vals:
        kv = str(vals["key"]) if "key" in vals.files else ""
        # a shard passing the key check is this layout version and always
        # stores its own index vectors: loading one without them under the
        # bucket-grouped chunk order would scatter results to the wrong pairs
        if (int(vals["n"]) == n and kv == key
                and "ii" in vals.files and "jj" in vals.files):
            for f in AVALL_FIELDS:
                out[f][vals["ii"], vals["jj"]] = vals[f]
            return True
    log.warning("resume shard %s is stale (inputs or chunking changed); recomputing", shard)
    return False


@traced("seqalib.align_all_vs_all")
def align_all_vs_all(
    queries: Sequence,
    references: Sequence,
    scoring: Optional[ScoringParams] = None,
    mode: str = "local",
    backend: str = "strip",
    mesh=None,
    chunk_pairs: int = 4096,
    resume_dir: Optional[str] = None,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """All-vs-all alignment (BASELINE.json config 5): every query against
    every reference on ``device``, streamed in chunks of at most
    ``chunk_pairs`` pairs through the strip engine, or with ``backend="xla"``
    the wavefront route (``run_bucket(backend=)``, as in the JAX package).

    Returns a dict of (n_queries, n_references) int32 arrays: score, qs,
    qe, ts, te.  Tracebacks are excluded at this scale; realign the hits
    you care about with ``align``.

    Both sides are padded into per-bucket matrices once (``bucket_len``);
    a chunk is a row gather of one (query bucket, reference bucket) block
    of the product.  Each chunk is launched (``run_bucket(launch_only=True)``)
    before the previous one is finalized, so that the host's work on one
    overlaps the device's on the other.

    ``resume_dir``: each chunk writes ``chunk_NNNNNN.npz`` atomically (tmp
    + rename) with its pair indices and a content key (``_avall_key``); a
    rerun with the same inputs and chunking loads finished shards instead
    of realigning them.  The shards are those of
    ``seqalib_tpu.align_all_vs_all``: either package resumes the other's.
    They do not depend on the mesh: a product resumes shards written with
    any mesh or none.  In a ``torch.distributed`` world every rank returns
    the whole product, and rank 0 alone reads and writes the shards: it
    sends every rank the set of chunks it resumed and their values, so the
    ranks skip the same chunks and ``resume_dir`` need not be shared.
    ``backend`` takes the device backends only: the oracle aligns no
    product (the JAX package refuses it too).

    ``mesh``: each chunk is sharded over the mesh (``run_bucket(mesh=)``),
    all of its shards in flight while the previous chunk is finalized."""
    if backend not in DEVICE_BACKENDS:
        raise ValueError(f"align_all_vs_all runs the device backends {DEVICE_BACKENDS}, "
                         f"got backend {backend!r}")
    if mode not in ("local", "global"):
        raise ValueError(f"mode must be global|local, got {mode!r}")
    from .parallel.dispatch import _pad_stack, bucket_len, run_bucket
    from .parallel.dist import as_mesh, broadcast_host, world

    mesh = None if mesh is None else as_mesh(mesh)
    dev = None if mesh else as_device(device)
    writer = world()[0] == 0
    sp = scoring if scoring is not None else ScoringParams.linear()
    qs = [_coerce(q, sp) for q in queries]
    rs = [_coerce(r, sp) for r in references]
    nq, nr = len(qs), len(rs)
    out = {f: np.zeros((nq, nr), np.int32) for f in AVALL_FIELDS}
    key = ""
    if resume_dir is not None:
        os.makedirs(resume_dir, exist_ok=True)
        key = _avall_key(qs, rs, chunk_pairs, sp, mode)

    def _groups(seqs):
        g: Dict[int, List[int]] = {}
        for i, s in enumerate(seqs):
            g.setdefault(bucket_len(len(s)), []).append(i)
        return {
            bl: (
                np.asarray(idx, np.int64),
                _pad_stack([seqs[i] for i in idx], bl),
                np.asarray([len(seqs[i]) for i in idx], np.int32),
            )
            for bl, idx in sorted(g.items())
        }

    def _collect(chunk):
        finish, ii, jj, shard = chunk
        res = finish()
        vals = {f: np.asarray(res[f], np.int32) for f in AVALL_FIELDS}
        for f in AVALL_FIELDS:
            out[f][ii, jj] = vals[f]
        if shard is not None and writer:
            tmp = shard + ".tmp.npz"
            np.savez(tmp, n=np.int64(len(ii)), key=key, ii=ii, jj=jj, **vals)
            os.replace(tmp, shard)

    qg, rg = _groups(qs), _groups(rs)
    # the chunks in order: (query bucket, reference bucket, lo, hi)
    chunks = [(qb, rb, lo, min(lo + chunk_pairs, len(qg[qb][0]) * len(rg[rb][0])))
              for qb in qg for rb in rg
              for lo in range(0, len(qg[qb][0]) * len(rg[rb][0]), chunk_pairs)]
    shards = [os.path.join(resume_dir, f"chunk_{ci:06d}.npz") if resume_dir is not None
              else None for ci in range(len(chunks))]
    # which chunks resume is decided by rank 0 alone and shared with every
    # rank, with the values it loaded: a rank that chose for itself could
    # skip a chunk whose gathers another rank joins
    fresh = np.zeros(len(chunks), np.uint8)
    if resume_dir is not None:
        if writer:
            for ci, (_, _, lo, hi) in enumerate(chunks):
                if os.path.exists(shards[ci]):
                    fresh[ci] = _load_shard(shards[ci], hi - lo, key, out)
        fresh = broadcast_host(fresh)
        if fresh.any():
            for f in AVALL_FIELDS:
                out[f] = broadcast_host(out[f])
    resumed = int(fresh.sum())

    pending = None  # the chunk in flight: (finalize, ii, jj, shard)
    for ci, (qb, rb, lo, hi) in enumerate(chunks):
        if fresh[ci]:
            continue
        qidx, Qmat, qleng = qg[qb]
        ridx, Rmat, rleng = rg[rb]
        flat = np.arange(lo, hi, dtype=np.int64)
        ai = flat // len(ridx)
        bj = flat % len(ridx)
        # no tail padding to a pinned shape, unlike the JAX package:
        # the kernels take any batch size, and the padding costs wall
        # on the card (``tools/profile_port.py --config 5`` measures it)
        finish = run_bucket(Qmat[ai], Rmat[bj], qleng[ai], rleng[bj], sp, mode,
                            None, False, dev, launch_only=True, mesh=mesh, backend=backend)
        # one-chunk lookahead: this chunk's device work is in flight
        # while the previous chunk is finalized on the host
        if pending is not None:
            _collect(pending)
        pending = (finish, qidx[ai], ridx[bj], shards[ci])
    if pending is not None:
        _collect(pending)
    if resumed:
        log.info("align_all_vs_all resumed %d finished chunk shards", resumed)
    return out
