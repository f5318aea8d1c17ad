"""Batched alignment dispatcher (counterpart of
``seqalib_tpu/parallel/dispatch.py::dispatch_batch`` / ``run_bucket``).

Three routes, chosen as the JAX package chooses them:

* banded (``band=`` with ``mode="global"``, scalar scoring or a table that
  ``banded_matrix_supported`` accepts, under ``backend="strip"`` or
  ``"pallas"``): pairs are grouped by their length delta quantized to the
  band, ``(len(t) - len(q)) // band``, as in the JAX package, and the
  groups, in that order, are joined into batches (``banded_batches``): a
  group joins the batch before it while the batch's slot window ``Wp``
  stays within the widest of its groups' own and on its groups' kernel
  variant, its pairs' CTAs within the card's SMs and its checkpoints
  within ``JOIN_BYTES``.  Each batch is aligned by one
  ``models.banded.banded_align_batch``, every pair in its own band;
* length buckets: pairs are sorted into (Lq, Lt) buckets (``bucket_len``),
  each bucket is padded and aligned by ``strip_bucket``, or, for a band
  with a wider table, by the full-matrix ``wavefront_bucket``; under
  ``backend="xla"`` every bucket, banded or not, goes to the full-matrix
  wavefront route (``ops.wavefront_xla``).  Every bucket is launched
  (``run_bucket(launch_only=True)``: ``strip_launch``, ``wavefront_launch``
  or ``xla_launch``; the first two make no device-to-host sync, the
  local ``xla_launch`` makes none before its finalize) before any is
  finalized and turned into ``AlignResult``s.

With ``mesh=`` (a pair mesh, ``parallel.dist.make_pair_mesh``) each
bucket is sharded over the mesh's devices (``dist.strip_sharded``;
``dist.wavefront_sharded`` for the wide-table route and for every
``"xla"`` bucket, banded or not, as in the JAX package: every shard
launched before any is finalized), and the banded route splits each
batch over them, assigning the parts round robin; its parts run one
after another, so it gains nothing from several cards.  The mesh comes in
as a ``Mesh`` (``api.py`` normalizes the caller's argument).  Under a
``torch.distributed`` world of more than one process the length buckets
run on every route; the banded route raises, as the JAX package's cannot
run there either (it places its parts on devices by index and syncs per
part).

Results come back in input order.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..devices import H100_SMS, Mesh, sm_count
from ..models.banded import (banded_align_batch, banded_matrix_supported, checkpoint_bytes,
                             slot_width)
from ..ops.band_fill import MAX_WP_REGISTERS, fill_geometry
from ..ops.strip import strip_launch
from ..ops.wavefront import wavefront_launch
from ..ops.wavefront_xla import xla_launch
from ..scoring import tables_from_params
from ..telemetry import span
from ..types import AlignResult, ScoringParams
from .dist import refuse_multiprocess, strip_sharded, wavefront_sharded

MIN_BUCKET = 16
JOIN_BYTES = 8 * 1024**3  # a join keeps a banded batch's checkpoints within this


def bucket_len(n: int) -> int:
    """Bucket width for a sequence of length n: the smallest power of two
    >= n (at least ``MIN_BUCKET``) up to 128, then the next multiple of 128
    (``SEQALIB_BUCKET_POLICY=pow2``: the next power of two).  The same
    buckets as the JAX package."""
    if n <= 128:
        b = MIN_BUCKET
        while b < n:
            b <<= 1
        return b
    if os.environ.get("SEQALIB_BUCKET_POLICY", "ceil128") == "pow2":
        b = 128
        while b < n:
            b <<= 1
        return b
    return -(-n // 128) * 128


def _pad_stack(seqs: List[np.ndarray], L: int) -> np.ndarray:
    out = np.zeros((len(seqs), L), dtype=np.int32)
    for r, s in enumerate(seqs):
        out[r, : len(s)] = s
    return out


def run_bucket(q, t, qlen, tlen, sp: ScoringParams, mode: str, band: Optional[int],
               traceback: bool, device, launch_only: bool = False,
               mesh: Optional[Mesh] = None, backend: str = "strip"):
    """Align one padded bucket (B, Lq) x (B, Lt) on ``device``: the strip
    engine, or with ``band`` the banded full-matrix wavefront; with
    ``backend="xla"`` the full-matrix wavefront route (``xla_launch``).
    With ``mesh`` the bucket is sharded over its devices instead
    (``device`` is not used), on the same route.

    ``launch_only``: return a 0-arg finalize callable instead of the
    result dict.  The device work is left in flight (``strip_launch``,
    ``wavefront_launch``: no device-to-host sync) so that the caller can
    prepare the next bucket meanwhile."""
    if backend == "xla":
        if mesh is not None:
            return wavefront_sharded(mesh, q, t, qlen, tlen, sp, mode=mode, band=band,
                                     want_tb=traceback, launch_only=launch_only)
        finish = xla_launch(q, t, qlen, tlen, sp, mode=mode, band=band, want_tb=traceback,
                            device=device)
        return finish if launch_only else finish()
    if band is not None:
        if mode != "global":
            raise ValueError("banded local alignment is out of contract")
        if mesh is not None:
            return wavefront_sharded(mesh, q, t, qlen, tlen, sp, band=band,
                                     want_tb=traceback, launch_only=launch_only)
        finish = wavefront_launch(q, t, qlen, tlen, sp, band=band, want_tb=traceback,
                                  device=device)
        return finish if launch_only else finish()
    if mesh is not None:
        return strip_sharded(mesh, q, t, qlen, tlen, sp, mode=mode, want_tb=traceback,
                             launch_only=launch_only)
    tables = tables_from_params(sp, device)
    finish = strip_launch(q, t, qlen, tlen, tables, mode=mode, want_tb=traceback)
    return finish if launch_only else finish()


def banded_batches(qlens: List[int], tlens: List[int], band: int, sms: int = H100_SMS,
                   cards: int = 1) -> List[List[int]]:
    """The pairs' indices, by ``banded_align_batch`` call, for pairs of
    lengths ``qlens``/``tlens`` in a band ``band``.  The delta groups
    ``(tlen - qlen) // band``, in ascending order, join the batch before
    them while the joined batch
    * keeps its slot window ``Wp`` (over the bands ``[min(0, delta) - band,
      max(0, delta) + band]``) within the widest joined group's own: every
      band holds diagonal 0, so deltas of one sign join whatever their
      spread, and two signs far apart start a new batch;
    * keeps every group on the ``band_fill`` variant of its own ``Wp``: one
      CTA a pair up to ``MAX_WP_REGISTERS``, a cluster above;
    * runs at most one CTA an SM, ``sms`` of each of ``cards`` cards: the
      pairs of a batch run at once, so a batch takes as long as its slowest
      pair where batches in turn take the sum, and past the SMs a join
      gains nothing;
    * keeps its checkpoints within ``JOIN_BYTES`` a card.
    A group is never split: one past these bounds is a batch of its own,
    as the JAX package runs it."""
    deltas = [t - q for q, t in zip(qlens, tlens)]
    groups: Dict[int, List[int]] = {}
    for idx, d in enumerate(deltas):
        groups.setdefault(d // max(band, 1), []).append(idx)
    batches: List[List[int]] = []
    lo = hi = K = widest = 0
    for _, idxs in sorted(groups.items()):
        g_lo = min(0, min(deltas[i] for i in idxs)) - band
        g_hi = max(0, max(deltas[i] for i in idxs)) + band
        g_K = max(qlens[i] + tlens[i] + 1 for i in idxs)
        own = slot_width(g_lo, g_hi)
        if batches:
            B = len(batches[-1]) + len(idxs)
            Wp = slot_width(min(lo, g_lo), max(hi, g_hi))
            if (Wp <= max(widest, own)
                    and (own > MAX_WP_REGISTERS) == (widest > MAX_WP_REGISTERS)
                    and B * max(1, fill_geometry(Wp)[0]) <= sms * cards
                    and checkpoint_bytes(B, Wp, max(K, g_K)) <= JOIN_BYTES * cards):
                batches[-1].extend(idxs)
                lo, hi, K, widest = min(lo, g_lo), max(hi, g_hi), max(K, g_K), max(widest, own)
                continue
        batches.append(list(idxs))
        lo, hi, K, widest = g_lo, g_hi, g_K, own
    return batches


def dispatch_banded(qs: List[np.ndarray], ts: List[np.ndarray], sp: ScoringParams,
                    band: int, traceback: bool, device,
                    mesh: Optional[Mesh] = None) -> List[AlignResult]:
    """The banded route: one ``banded_align_batch`` per batch of
    ``banded_batches``, or with ``mesh`` per part of a batch: each batch of
    more than one pair is split into ``min(len(mesh), len(batch))`` parts,
    and the parts go to the mesh's devices round robin (as the JAX package
    splits its delta groups, ``dispatch.py:205-233``).  The parts run one
    after another (``banded_align_batch`` returns host results), not at
    once on their devices."""
    if mesh is not None:
        refuse_multiprocess("banded route")
    cards = 1 if mesh is None else len(mesh)
    sms = sm_count(device if mesh is None else mesh[0])
    parts: List[List[int]] = []
    for idxs in banded_batches([len(q) for q in qs], [len(t) for t in ts], band, sms, cards):
        if mesh is None or len(idxs) == 1:
            parts.append(idxs)
        else:
            step = -(-len(idxs) // min(len(mesh), len(idxs)))
            parts.extend(idxs[lo: lo + step] for lo in range(0, len(idxs), step))
    results: List[Optional[AlignResult]] = [None] * len(qs)
    for pi, idxs in enumerate(parts):
        if mesh is not None:
            device = mesh[pi % len(mesh)]
        with span("seqalib.banded.group"):
            qb = _pad_stack([qs[i] for i in idxs], max(len(qs[i]) for i in idxs))
            tb = _pad_stack([ts[i] for i in idxs], max(len(ts[i]) for i in idxs))
            qlen = np.array([len(qs[i]) for i in idxs], np.int64)
            tlen = np.array([len(ts[i]) for i in idxs], np.int64)
            res = banded_align_batch(qb, tb, qlen, tlen, sp, band, traceback=traceback,
                                     device=device)
            for r, idx in enumerate(idxs):
                results[idx] = res[r]
    return results  # type: ignore[return-value]


def dispatch_batch(
    qs: List[np.ndarray],
    ts: List[np.ndarray],
    sp: ScoringParams,
    mode: str = "local",
    band: Optional[int] = None,
    traceback: bool = True,
    device="cuda",
    mesh: Optional[Mesh] = None,
    backend: str = "strip",
) -> List[AlignResult]:
    """Align all pairs on ``device``, or sharded over ``mesh``; results in
    input order.  ``backend``: ``"strip"`` and ``"pallas"`` take the strip
    and banded routes, ``"xla"`` the full-matrix wavefront, with a mesh or
    without."""
    if (band is not None and mode == "global" and backend != "xla"
            and (sp.matrix is None or banded_matrix_supported(sp.substitution_matrix()))):
        return dispatch_banded(qs, ts, sp, band, traceback, device, mesh=mesh)
    # a band with a wider table: the length buckets, as in the JAX package
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for idx, (q, t) in enumerate(zip(qs, ts)):
        buckets.setdefault((bucket_len(len(q)), bucket_len(len(t))), []).append(idx)

    pending = []
    for (Lq, Lt), idxs in sorted(buckets.items()):
        with span("seqalib.bucket.launch"):
            qb = _pad_stack([qs[i] for i in idxs], Lq)
            tb = _pad_stack([ts[i] for i in idxs], Lt)
            qlen = np.array([len(qs[i]) for i in idxs], np.int32)
            tlen = np.array([len(ts[i]) for i in idxs], np.int32)
            pending.append((idxs, run_bucket(qb, tb, qlen, tlen, sp, mode, band, traceback,
                                             device, launch_only=True, mesh=mesh,
                                             backend=backend)))

    results: List[AlignResult] = [None] * len(qs)  # type: ignore[list-item]
    for idxs, finish in pending:
        with span("seqalib.bucket.finalize"):
            out = finish()
            for r, idx in enumerate(idxs):
                results[idx] = AlignResult(
                    int(out["score"][r]),
                    int(out["qs"][r]),
                    int(out["qe"][r]),
                    int(out["ts"][r]),
                    int(out["te"][r]),
                    out["cigars"][r] if traceback else "",
                )
    return results
