"""The ``backend="xla"`` route: the counterpart of
``seqalib_tpu/ops/wavefront_xla.py::wavefront_bucket``, named after it so
that a reader finds it.  Despite the name it runs no XLA: its fills are the
CUDA kernel of ``ops/wavefront.py`` (``csrc/wavefront_fill.cu``, the port
of the full-matrix ``_fill_kernel`` whose formulation the JAX route
shares), its walks ``csrc/wavefront_walk.cu``, and on the CPU their plain
PyTorch versions.

Every bucket of ``align_batch(..., backend="xla")`` comes here, as in the
JAX package (``dispatch.py:144-147`` there), with linear gaps unless the
scoring is affine or there is a band (``affine = sp.is_affine or band is
not None``):

* global (any band): one fill, score H(qlen, tlen), and with ``want_tb``
  the walk from (qlen, tlen) (``ops.wavefront.wavefront_launch``: no
  device-to-host sync in its launch half);
* local (no band; a band raises, as in the JAX package), the JAX route's
  three passes:

  (a) a local score-only fill (start propagation on: the TPU mode computes
      it; this route does not read ``bs``), reduced on the device to the
      canonical end: the largest best, the smallest i holding it, then its
      slot's first diagonal k (j = k - i);
  (b) the canonical start from the anchored reverse extension over the
      reversed prefixes (``ops.strip.reverse_starts``, the strip engine's
      ``emode``, which computes what ``kind="extension"`` computes there);
  (c) with ``want_tb``, a global fill with pointers over each pair's
      [qs:qe] x [ts:te] window, cut on the host to the widest window, and
      the walk; a pair with score <= 0 gets "".

  The launch half enqueues (a) and the copy of its three (B,) results with
  no device-to-host sync; the finalize waits for that copy, then runs (b)
  and (c), which copy to and from the host (``reverse_starts`` widens its
  window on the host, and (c) needs the starts).
"""

from __future__ import annotations

import numpy as np
import torch

from ..scoring import tables_from_params
from ..transfer import to_host
from ..types import ScoringParams
from ..utils import ceil_to
from .strip import TI, reverse_starts
from .wavefront import _geometry, stage_wavefront, wavefront_fill, wavefront_launch


def local_end(bv, bk, N1: int):
    """The canonical end of each pair from a local fill's per-slot bests
    (B, Np): (score, qe, te), the largest best over slots [0, N1), the
    smallest slot i holding it and j = bk[i] - i; (0, 0, 0) for a pair with
    no positive cell (``pallas_bucket``'s reduction, ``:669-677``)."""
    bv, bk = bv[:, :N1], bk[:, :N1]
    score = bv.max(dim=1).values
    iarr = torch.arange(N1, dtype=bv.dtype, device=bv.device)[None, :]
    bi = torch.where(bv == score[:, None], iarr, N1).min(dim=1).values
    bj = bk.gather(1, bi.long()[:, None])[:, 0] - bi
    empty = score <= 0
    zero = torch.zeros_like(score)
    return score, torch.where(empty, zero, bi), torch.where(empty, zero, bj)


def _windows(q, t, qs, qe, ts, te):
    """Each pair's window q[qs:qe] x t[ts:te] as letter arrays of the
    widest window's shape (what lies past a window's length is not read),
    and the window lengths."""
    wq = (qe - qs).astype(np.int64)
    wt = (te - ts).astype(np.int64)
    rows = np.arange(len(wq))[:, None]

    def cut(x, start, w):
        x = np.asarray(x)
        karr = np.arange(int(w.max(initial=0)))[None, :]
        if not x.shape[1] or not karr.shape[1]:
            return np.zeros((len(w), karr.shape[1]), np.int32)
        return x[rows, np.minimum(start[:, None] + karr, x.shape[1] - 1)].astype(np.int32)

    return cut(q, qs, wq), cut(t, ts, wt), wq, wt


def xla_launch(q, t, qlen, tlen, sp: ScoringParams, *, mode: str, band: int | None,
               want_tb: bool, device):
    """Align one padded bucket (B, n) x (B, m) on the ``"xla"`` route (see
    the module docstring): the launch half, which returns the finalize
    callable; the finalize returns score/qs/qe/ts/te (B,) int32 (+ cigars
    with ``want_tb``).  On the CPU everything runs here and the callable
    only returns the result."""
    affine = sp.is_affine or band is not None
    if mode == "global":
        return wavefront_launch(q, t, qlen, tlen, sp, band=band, want_tb=want_tb,
                                device=device, affine=affine)
    if mode != "local":
        raise ValueError(f"mode must be 'local' or 'global', got {mode!r}")
    if band is not None:
        raise ValueError("banded local alignment is out of contract")
    q, t = np.asarray(q), np.asarray(t)
    qlen = np.asarray(qlen).astype(np.int64)
    tlen = np.asarray(tlen).astype(np.int64)
    B, n, m, Np, K = _geometry(q, t)
    device = torch.device(device)
    qpad, tk, ql, tl, tab = stage_wavefront(q, t, qlen, tlen, sp, device)
    res = wavefront_fill(qpad, tk, ql, tl, tab, K=K, band=None, gap_open=sp.gap_open,
                         gap_extend=sp.gap_extend, want_ptr=False, mode="local",
                         affine=affine, stride=m + 1,
                         span=int(np.abs(tlen - qlen).max(initial=0)))
    score, qe, te = local_end(res["bv"], res["bk"], n + 1)
    wait = to_host({"score": score, "qe": qe, "te": te})

    def finish():
        host = wait()
        score = host["score"].astype(np.int32)
        qe = host["qe"].astype(np.int64)
        te = host["te"].astype(np.int64)
        tables = tables_from_params(sp, device)
        # one pass: a window of every query row finds every score
        qs, ts = reverse_starts(q, t, score, qe, te, tables, Wq0=ceil_to(max(n, 1), TI))
        out = {"score": score, "qs": qs, "qe": qe.astype(np.int32), "ts": ts,
               "te": te.astype(np.int32)}
        if not want_tb:
            return out
        live = score > 0
        cigars = [""] * B
        if live.any():
            qw, tw, wq, wt = _windows(q, t, np.where(live, qs, 0), np.where(live, qe, 0),
                                      np.where(live, ts, 0), np.where(live, te, 0))
            win = wavefront_launch(qw, tw, wq, wt, sp, band=None, want_tb=True,
                                   device=device, affine=affine)()
            if not np.array_equal(win["score"][live], score[live]):
                raise RuntimeError("window-global score must equal the local score")
            cigars = [c if ok else "" for c, ok in zip(win["cigars"], live)]
        out["cigars"] = cigars
        return out

    if device.type == "cpu":
        out = finish()
        return lambda: out
    return finish
