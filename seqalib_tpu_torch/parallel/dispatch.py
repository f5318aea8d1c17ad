"""Batched alignment dispatcher (counterpart of
``seqalib_tpu/parallel/dispatch.py::dispatch_batch`` / ``run_bucket``,
strip route only).

Pairs are sorted into (Lq, Lt) length buckets (``bucket_len``), each bucket
is padded and aligned by ``strip_bucket``, and the results are put back in
input order.  Every bucket is launched before any is turned into
``AlignResult``s.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from seqalib_tpu.parallel.dispatch import _pad_stack, bucket_len
from seqalib_tpu.types import AlignResult, ScoringParams

from ..ops.strip import strip_bucket
from ..scoring import tables_from_params


def run_bucket(q, t, qlen, tlen, sp: ScoringParams, mode: str,
               traceback: bool, device) -> Dict[str, np.ndarray]:
    """Align one padded bucket (B, Lq) x (B, Lt) on ``device``."""
    tables = tables_from_params(sp, device)
    return strip_bucket(q, t, qlen, tlen, tables, mode=mode, want_tb=traceback)


def dispatch_batch(
    qs: List[np.ndarray],
    ts: List[np.ndarray],
    sp: ScoringParams,
    mode: str = "local",
    traceback: bool = True,
    device="cuda",
) -> List[AlignResult]:
    """Align all pairs on ``device``; results in input order."""
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for idx, (q, t) in enumerate(zip(qs, ts)):
        buckets.setdefault((bucket_len(len(q)), bucket_len(len(t))), []).append(idx)

    pending = []
    for (Lq, Lt), idxs in sorted(buckets.items()):
        qb = _pad_stack([qs[i] for i in idxs], Lq)
        tb = _pad_stack([ts[i] for i in idxs], Lt)
        qlen = np.array([len(qs[i]) for i in idxs], np.int32)
        tlen = np.array([len(ts[i]) for i in idxs], np.int32)
        pending.append(
            (idxs, run_bucket(qb, tb, qlen, tlen, sp, mode, traceback, device))
        )

    results: List[AlignResult] = [None] * len(qs)  # type: ignore[list-item]
    for idxs, out in pending:
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
