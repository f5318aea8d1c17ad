"""Strip engine, host side: counterparts of the functions of
``seqalib_tpu/ops/strip_pallas.py`` that are not kernels.

The same flow runs on both devices; the kernel wrappers choose the CUDA
kernel or its plain PyTorch version by the device of the tensors they get.

Local alignment (``mode="local"``) follows the two-pass canonical
coordinates contract of ``seqalib_tpu/oracle.py``:

1. pass 1: local end-only fill, reduced to the canonical end (qe, te);
2. pass 2: anchored reverse extension (``emode``) over the reversed
   prefixes, cut by ``row_window`` to WR rows x ~2*WR columns
   (``SEQALIB_FUSED_WR``, default 512, rounded up to a multiple of 128); a
   pair whose pass-2 score differs escalates to ``reverse_starts``, which
   widens its window x4 until the score is found;
3. with ``want_tb``: a global fill with pointers over each pair's
   [qs:qe] x [ts:te] window, cut by ``row_window``, walked by
   ``strip_walk``, which writes each pair's CIGAR text on the device
   (escalated pairs are rebuilt by ``window_global_cigars``).

Pass 2 runs on one of the JAX package's two engines, chosen by
``pass2`` (``SEQALIB_FUSED_PASS2``, read at the host boundary as the JAX
package reads it):

* ``"banded"`` (the default): ``band_fill`` in ``emode`` over a band of
  ``BW`` diagonals around the anchor (``SEQALIB_FUSED_BW``, default 64;
  ``banded_pass2``; from BW 8 191 on its slots take ``band_fill``'s wide
  variants); a table outside the range [-4, 11] with more than 7 letters
  stays on the strip engine, as in the JAX package;
* ``"strip"``: ``strip_fill`` in ``emode`` over the whole window.

``tie_safe`` (``SEQALIB_FUSED_TIE_SAFE=1``) escalates every pair whose
canonical start a co-optimal tie outside the window could move: on the
banded engine by the window-edge bound EV, on the strip engine every pair
whose target window was cut.  The window geometry keeps the JAX package's
128-quantum numbers (TI, LANES, the 128-slot band window), which decide
the co-optimal tie outcomes and which pairs escalate, whatever the kernels
do inside.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..scoring import NIBBLE_BIAS, Tables, fits_nibbles
from ..telemetry import count_d2h
from ..transfer import host_buffer, to_device, to_host, upload
from ..types import NEG_INF
from ..utils import ceil_to
from ..utils.cigar import cigars_from_text
from .band_fill import band_fill, band_table
from .row_window import error_words, raise_on_error, row_window
from .strip_fill import raise_on_bad_length, strip_fill
from .strip_walk import strip_walk

log = logging.getLogger("seqalib_tpu_torch.strip")

TI = 128  # row quantum of the padded query (JAX strip height)
LANES = 128  # column quantum of the padded target
WR_DEFAULT = 4 * TI  # pass-2 row window
BW_DEFAULT = 64  # banded pass 2: band half-width around the anchor diagonal
CKB = 64  # banded pass 2: the diagonal count is a multiple of this
PASS2_ENGINES = ("banded", "strip")


def pass2_knobs() -> dict:
    """The pass-2 knobs from the environment, the variables the JAX package
    reads at the same boundary (``fused_wr``, ``fused_pass2_knobs``): the
    engine (``SEQALIB_FUSED_PASS2``, default ``"banded"``), ``tie_safe``
    (``SEQALIB_FUSED_TIE_SAFE``, default off), the row window ``WR``
    (``SEQALIB_FUSED_WR``, default 512, rounded up to a multiple of TI) and
    the banded engine's half-width ``BW`` (``SEQALIB_FUSED_BW``, default 64).
    ``WR`` also sets the escalations' first window (``reverse_starts``'
    ``Wq0``)."""
    env = os.environ
    return {"pass2": env.get("SEQALIB_FUSED_PASS2", "banded"),
            "tie_safe": env.get("SEQALIB_FUSED_TIE_SAFE", "0") == "1",
            "WR": ceil_to(int(env.get("SEQALIB_FUSED_WR", str(WR_DEFAULT))), TI),
            "BW": int(env.get("SEQALIB_FUSED_BW", str(BW_DEFAULT)))}


def jax_route(tables: Tables) -> str:
    """How the JAX kernels score ``tables``: ``"scalar"`` (match/mismatch
    from ``table[0, 0]``/``table[0, 1]``, for 8 rows or fewer), ``"packed"``
    (the nibble profile) or ``"wide"`` (a table outside [-4, 11]), which
    decides the pass-2 engine and how pass 2 scores its sentinel letters."""
    if tables.A1 <= 8:
        return "scalar"
    return "packed" if fits_nibbles(tables.host) else "wide"


def ptr_cap_bytes() -> int:
    """Pointer-stream byte budget of one call (``SEQALIB_PTR_HBM_CAP``,
    default 2 GiB, as in the JAX package)."""
    return int(float(os.environ.get("SEQALIB_PTR_HBM_CAP", str(2 * 1024**3))))


def ptr_bytes_per_pair(n_pad: int, W2: int) -> int:
    """Bytes of ``strip_fill``'s dense pointer matrix for one pair."""
    return n_pad * (W2 - 1)


def prep_strip(q, t, qlen, tlen, A1: int, device):
    """Sentinel-padded query rows (B, n_pad) and shifted target columns
    (B, W2), ``t2[:, j] = t[:, j - 1]``, as int32 tensors on ``device``
    (counterpart of ``_prep_strip``)."""
    return stage_strip(q, t, qlen, tlen, A1, device)[:2]


def stage_strip(q, t, qlen, tlen, A1: int, device):
    """``prep_strip``'s letters and the lengths ``qlen``, ``tlen`` (B,), built
    in one host buffer and copied to ``device`` in one copy."""
    B, n = q.shape
    m = t.shape[1]
    SENT_Q, SENT_T = A1, A1 + 1
    n_pad = ceil_to(max(n, 1), TI)
    W2 = (ceil_to(max(m, 1), LANES) // LANES + 2) * LANES
    sizes = [B * n_pad, B * W2, B, B]
    buf = host_buffer(sum(sizes), device)
    qpad, t2, ql, tl = np.split(buf.numpy(), np.cumsum(sizes)[:-1])
    qpad, t2 = qpad.reshape(B, n_pad), t2.reshape(B, W2)
    qpad[:, n:] = SENT_Q
    qpad[:, :n] = np.where(np.arange(n)[None, :] < qlen[:, None], q, SENT_Q)
    t2[:, 0] = SENT_T
    t2[:, 1 + m:] = SENT_T
    t2[:, 1 : 1 + m] = np.where(np.arange(m)[None, :] < tlen[:, None], t, SENT_T)
    ql[:] = qlen
    tl[:] = tlen
    dev = upload(buf, device)
    qpad_d, t2_d, ql_d, tl_d = torch.split(dev, sizes)
    return qpad_d.view(B, n_pad), t2_d.view(B, W2), ql_d, tl_d


def reduce_best(bv, bk, stride: int):
    """Decode ``strip_fill``'s best key into (score, i, j); (0, 0) for a
    pair with no positive cell (counterpart of ``_reduce_best``; the
    kernel already reduced to the canonical min-key maximum)."""
    empty = bv <= 0
    zero = torch.zeros_like(bk)
    return bv, torch.where(empty, zero, bk // stride), torch.where(empty, zero, bk % stride)


def global_post(bv, P, qlen, tlen, tables: Tables, want_tb: bool, err):
    """Global (NW) assembly: the H(qlen, tlen) capture, all-gap results
    for qlen == 0 or tlen == 0, and with ``want_tb`` the walk to CIGARs
    (counterpart of ``_global_post``).  Launches the walk and the host copy
    of the score (with ``nchar`` and the fill's deferred check ``err``) and
    returns the callable that finishes on the host."""
    degq = qlen == 0
    degt = tlen == 0
    copy = {"bv": bv, "err": err}
    text = None
    if want_tb:
        start = to_device(np.stack([qlen, tlen, np.zeros_like(qlen), degq | degt]), bv.device)
        text, copy["nchar"], _ = strip_walk(P, *start, affine=tables.affine)
    wait = to_host(copy)
    return lambda: _global_finish(wait(), text, qlen, tlen, tables, want_tb)


def _global_finish(host, text, qlen, tlen, tables: Tables, want_tb: bool):
    raise_on_bad_length(host["err"][0])
    degq = qlen == 0
    degt = tlen == 0
    score = host["bv"].astype(np.int64)
    go = tables.gap_open if tables.affine else 0
    e = tables.gap_extend
    score = np.where(degq, go + tlen * e, score)
    score = np.where(degt, go + qlen * e, score)
    score = np.where(degq & degt, 0, score)
    B = len(qlen)
    out = {
        "score": score.astype(np.int32),
        "qs": np.zeros(B, np.int32),
        "qe": qlen.astype(np.int32),
        "ts": np.zeros(B, np.int32),
        "te": tlen.astype(np.int32),
    }
    if want_tb:
        cigars = cigars_from_text(text, host["nchar"])
        for b in np.nonzero(degq | degt)[0]:
            c = f"{tlen[b]}D" if tlen[b] else ""
            cigars[b] = c + (f"{qlen[b]}I" if qlen[b] else "")
        out["cigars"] = cigars
    return out


def banded_pass2(qr, tr, qe, te2, score, tables: Tables, *, mq: int, WR: int,
                 TWD: int, tie_safe: bool, BW: int = BW_DEFAULT):
    """Pass 2 on the banded engine: the anchored reverse extension of the
    reversed prefixes ``qr`` (B, WR) and ``tr`` (B, W2r) (``tr[:, 0]`` a
    sentinel) over the slot window of diagonals -BW..BW (128 slots at the
    default BW), and the
    first maximum (ri, rj) by the canonical packed index.  Returns
    ``(score2, ri, rj)``; with ``tie_safe`` a pair whose EV bound admits an
    outside tie gets ``score2 = score - 1`` (escalates).  Counterpart of
    ``_p2_banded`` (without its PC2 slicing)."""
    dev = qr.device
    B = qr.shape[0]
    A1 = tables.A1
    host = tables.host
    packed = jax_route(tables) == "packed"
    match = int(host[0, 0])
    mismatch = int(host[0, 1]) if A1 > 1 else match
    # sentinel letters score as the JAX kernel scores them: their cells are
    # not masked in emode and reach BV and EV
    sent = -NIBBLE_BIAS if packed else mismatch
    smax = 15 - NIBBLE_BIAS if packed else max(match, mismatch)
    Wpb = ceil_to((2 * BW + 1) // 2 + 2, LANES)
    Kp = ceil_to(WR + min(TWD, WR + BW) + 1, CKB)
    # 1-based letters: qk[:, x] = qr[:, x - 1]; tr already is
    qk = torch.cat([torch.full((B, 1), A1, dtype=torch.int32, device=dev),
                    qr.to(torch.int32)], 1)
    tab = to_device(band_table(host, sent), dev)
    state = torch.full((6, B, Wpb), NEG_INF, dtype=torch.int32, device=dev)
    state[5] = 0  # BK
    ev = torch.full((B, Wpb), NEG_INF, dtype=torch.int32, device=dev)
    band = torch.full((B,), BW, dtype=torch.int32, device=dev)
    r = band_fill(qk, tr.to(torch.int32), torch.clamp(qe, max=WR),
                  torch.clamp(te2, max=WR + BW), -band, band, state, ev, tab,
                  k0=0, k1=Kp, K=Kp, dlo=-BW, dhi=BW, gap_open=tables.gap_open,
                  gap_extend=tables.gap_extend, mode="emode", tie_safe=tie_safe,
                  smax=smax)
    BV, BK = r["state"][4], r["state"][5]
    # slot p on diagonal k is cell i = ihat(k) + p, j = k - i
    iv = torch.clamp((BK - BW + 1) // 2, min=0) + torch.arange(Wpb, device=dev)[None, :]
    key = iv * (mq + 1) + (BK - iv)
    score2 = BV.max(dim=1).values
    big = torch.iinfo(torch.int32).max
    pb = torch.where(BV == score2[:, None], key, big).min(dim=1).values
    empty = score2 <= 0
    zero = torch.zeros_like(pb)
    ri = torch.where(empty, zero, pb // (mq + 1))
    rj = torch.where(empty, zero, pb % (mq + 1))
    if tie_safe:
        risk = r["score"].max(dim=1).values + smax * ri + tables.gap_extend >= score
        score2 = torch.where(risk & (score2 == score), score - 1, score2)
    return score2, ri, rj


def local_fused(qpad, t2, qlen, tlen, tables: Tables, *, mq: int, WR: int,
                pass2: str, tie_safe: bool, err, BW: int = BW_DEFAULT):
    """Passes 1 and 2 on device tensors: score, canonical end (qe, te),
    start (qs, ts) and the pass-2 score ``score2`` (a pair with
    ``score2 != score`` must escalate).  ``err`` holds the deferred checks
    (``error_words(5)``: the range checks of the two pass-2 windows here and
    of the two pass-3 windows of ``local_fused_tb``, then the length check
    of every ``strip_fill`` call) and comes back as ``row_err``.
    Counterpart of ``_strip_local_fused``."""
    SENT_Q, SENT_T = tables.A1, tables.A1 + 1
    r1 = strip_fill(qpad, t2, qlen, tlen, tables, mq=mq, mode="local", err=err[4:5])
    score, qe, te = reduce_best(r1["bv"], r1["bk"], mq + 1)
    n_pad = qpad.shape[1]
    W2 = t2.shape[1]
    WR = min(WR, n_pad)  # qe <= qlen <= n_pad
    # reversed prefixes, read from the flipped arrays: row k <-> q[qe-1-k]
    # = flip(qpad)[n_pad-qe+k]; column x <-> t[te-x] = t2[te-x+1] =
    # flip(t2)[W2-2-te+x]
    qr = row_window(qpad, n_pad - qe, qe, L=WR, lo=0, fill=SENT_Q, reverse=True,
                    err=err[0:1])
    # clamped pass-2 target width: data columns 1..TWD plus 2 blocks of slack
    W2r = min(W2, (ceil_to(2 * WR, LANES) // LANES + 2) * LANES)
    TWD = W2r - 2 * LANES
    te2 = torch.clamp(te, max=TWD)
    tr = row_window(t2, W2 - 2 - te, te2 + 1, L=W2r, lo=1, fill=SENT_T, reverse=True,
                    err=err[1:2])
    if pass2 == "banded" and jax_route(tables) != "wide":
        score2, ri, rj = banded_pass2(qr, tr, qe, te2, score, tables, mq=mq, WR=WR,
                                      TWD=TWD, tie_safe=tie_safe, BW=BW)
    else:
        r2 = strip_fill(qr, tr, torch.clamp(qe, max=WR), te2, tables, mq=mq,
                        mode="emode", err=err[4:5])
        score2, ri, rj = reduce_best(r2["bv"], r2["bk"], mq + 1)
        if tie_safe:
            # a tie beyond the column clamp exists only where the target
            # window was cut: escalate those pairs
            score2 = torch.where((te > TWD) & (score2 == score), score - 1, score2)
    pos = score > 0
    zero = torch.zeros_like(score)
    return {
        "score": score,
        "qe": qe,
        "te": te,
        "qs": torch.where(pos, qe - ri, zero),
        "ts": torch.where(pos, te - rj, zero),
        "score2": score2,
        "row_err": err,
    }


def local_fused_tb(qpad, t2, qlen, tlen, tables: Tables, *, mq: int, WR: int,
                   pass2: str, tie_safe: bool, err, BW: int = BW_DEFAULT):
    """``local_fused`` plus pass 3 on device: each pair's [qs:qe] x
    [ts:te] window, cut at the pass-1 shapes, filled globally with
    pointers and walked.  Adds the window-global score ``score_w`` and
    the walk's CIGAR ``text`` and its lengths ``nchar``.  Counterpart of
    ``_strip_local_fused_tb`` (without its link-era packing)."""
    res = local_fused(qpad, t2, qlen, tlen, tables, mq=mq, WR=WR, pass2=pass2,
                      tie_safe=tie_safe, err=err, BW=BW)
    SENT_Q, SENT_T = tables.A1, tables.A1 + 1
    n_pad = qpad.shape[1]
    W2 = t2.shape[1]
    live = res["score"] > 0
    zero = torch.zeros_like(res["score"])
    wq = torch.where(live, res["qe"] - res["qs"], zero)
    wt = torch.where(live, res["te"] - res["ts"], zero)
    qw = row_window(qpad, torch.where(live, res["qs"], zero), wq, L=n_pad,
                    lo=0, fill=SENT_Q, err=err[2:3])
    # window column x <-> t[ts + x - 1] = t2[ts + x]; x = 0 stays sentinel
    tw = row_window(t2, torch.where(live, res["ts"], zero), wt + 1, L=W2, lo=1,
                    fill=SENT_T, err=err[3:4])
    r3 = strip_fill(qw, tw, wq, wt, tables, mq=mq, mode="gmode", want_ptr=True,
                    err=err[4:5])
    text, nchar, _ = strip_walk(
        r3["P"], wq, wt, zero, ((wq == 0) | (wt == 0)).to(torch.int32),
        affine=tables.affine,
    )
    res.update(score_w=r3["bv"], text=text, nchar=nchar)
    return res


def reverse_starts(q, t, score, qe, te, tables: Tables, *, Wq0: int):
    """Canonical starts of the pairs with ``score > 0`` by anchored reverse
    extension over reversed prefixes built on the host, the query side
    windowed to Wq rows and widened x4 until the score is found
    (counterpart of ``_reverse_starts``)."""
    B = len(score)
    qs = np.zeros(B, np.int32)
    ts = np.zeros(B, np.int32)
    pend = np.nonzero(score > 0)[0]
    SENT_Q, SENT_T = tables.A1, tables.A1 + 1
    device = tables.table.device
    Wq = Wq0
    while pend.size:
        qe_s = qe[pend].astype(np.int64)
        te_s = te[pend].astype(np.int64)
        n_pad = min(Wq, ceil_to(int(qe_s.max()), TI))
        wq = np.minimum(qe_s, n_pad)
        m_sub = int(te_s.max())
        W2 = (ceil_to(max(m_sub, 1), LANES) // LANES + 2) * LANES
        # reversed prefixes: row k <-> q[qe-1-k]; column x <-> t[te-x]
        idx = qe_s[:, None] - 1 - np.arange(n_pad)[None, :]
        qr = np.where(idx >= 0, q[pend[:, None], np.maximum(idx, 0)], SENT_Q)
        xarr = np.arange(W2)[None, :]
        tidx = te_s[:, None] - xarr
        tr = np.where(
            (xarr >= 1) & (tidx >= 0),
            t[pend[:, None], np.clip(tidx, 0, t.shape[1] - 1)],
            SENT_T,
        )
        res = strip_fill(to_device(qr, device), to_device(tr, device), to_device(wq, device),
                         to_device(te_s, device), tables, mq=m_sub, mode="emode")
        best = reduce_best(res["bv"], res["bk"], m_sub + 1)
        score2, ri, rj = (x.cpu().numpy() for x in best)
        count_d2h(*best)
        ok = score2 == score[pend]
        # full-height windows must reproduce the score: anything else is a
        # kernel or contract fault, not a windowing artifact
        assert np.all(ok | (qe_s > n_pad)), (
            "reverse extension lost the local score",
            pend[~(ok | (qe_s > n_pad))],
        )
        sel = pend[ok]
        qs[sel] = (qe[sel] - ri[ok]).astype(np.int32)
        ts[sel] = (te[sel] - rj[ok]).astype(np.int32)
        pend = pend[~ok]
        Wq *= 4
    return qs, ts


def window_global_cigars(q, t, score, qs, qe, ts, te, tables: Tables):
    """Canonical CIGAR of each pair: the global traceback of its window
    q[qs:qe] x t[ts:te], cut on the host and aligned by ``strip_bucket``
    in global mode; ``score <= 0`` pairs get "" (counterpart of
    ``window_global_cigars``)."""
    B, n = q.shape
    m = t.shape[1]
    sent_q, sent_t = tables.A1, tables.A1 + 1
    wq = (np.asarray(qe, np.int64) - qs).astype(np.int64)
    wt = (np.asarray(te, np.int64) - ts).astype(np.int64)
    rows = np.arange(B)[:, None]
    karr = np.arange(int(max(wq.max(), 1)))[None, :]
    qw = np.full((B, karr.shape[1]), sent_q, np.int32)
    if n:
        src = q[rows, np.minimum(np.asarray(qs)[:, None] + karr, n - 1)]
        qw = np.where(karr < wq[:, None], src, sent_q).astype(np.int32)
    karr = np.arange(int(max(wt.max(), 1)))[None, :]
    tw = np.full((B, karr.shape[1]), sent_t, np.int32)
    if m:
        src = t[rows, np.minimum(np.asarray(ts)[:, None] + karr, m - 1)]
        tw = np.where(karr < wt[:, None], src, sent_t).astype(np.int32)
    win = strip_bucket(qw, tw, wq, wt, tables, mode="global", want_tb=True)
    if not np.array_equal(win["score"], np.asarray(score)):
        raise RuntimeError("window-global score must equal the local score")
    return ["" if score[b] <= 0 else win["cigars"][b] for b in range(B)]


def strip_bucket(q, t, qlen, tlen, tables: Tables, *, mode: str,
                 want_tb: bool = False, WR: int | None = None,
                 pass2: str | None = None, tie_safe: bool | None = None,
                 BW: int | None = None):
    """Align one padded bucket: ``q`` (B, n) and ``t`` (B, m) letter arrays
    with lengths ``qlen``/``tlen``, on the device of ``tables``.

    Returns numpy ``score``/``qs``/``qe``/``ts``/``te`` (B,) int32, plus
    ``cigars`` with ``want_tb``, plus ``escalated`` (B,) bool in local
    mode (pairs whose start came from ``reverse_starts``).  ``WR`` is the
    pass-2 row window (rounded up to a multiple of 128), ``BW`` the banded
    pass 2's half-width; ``WR``, ``pass2``, ``tie_safe`` and ``BW`` default
    to ``pass2_knobs()``.  ``strip_launch(...)()``."""
    return strip_launch(q, t, qlen, tlen, tables, mode=mode, want_tb=want_tb, WR=WR,
                        pass2=pass2, tie_safe=tie_safe, BW=BW)()


def strip_launch(q, t, qlen, tlen, tables: Tables, *, mode: str,
                 want_tb: bool = False, WR: int | None = None,
                 pass2: str | None = None, tie_safe: bool | None = None,
                 BW: int | None = None):
    """The launch half of ``strip_bucket`` (same arguments): the letters'
    copies, passes 1-2 (and 3 with ``want_tb``) or the global fill and
    walk, and the copy of their small results to the host, all enqueued
    with no device-to-host sync on a CUDA device.  Returns the finalize
    callable, which waits for that copy only, raises the deferred checks,
    escalates (``reverse_starts``) and builds the CIGARs, and returns
    ``strip_bucket``'s dict.  On the CPU everything runs here and the
    callable only returns the result.  A global batch with pointers over
    the budget (``ptr_cap_bytes``) is aligned in parts at once."""
    if mode not in ("local", "global"):
        raise ValueError(f"mode must be 'local' or 'global', got {mode!r}")
    knobs = pass2_knobs()
    pass2 = knobs["pass2"] if pass2 is None else pass2
    tie_safe = knobs["tie_safe"] if tie_safe is None else tie_safe
    WR = knobs["WR"] if WR is None else WR
    BW = knobs["BW"] if BW is None else BW
    if pass2 not in PASS2_ENGINES:
        raise ValueError(f"pass2 must be one of {PASS2_ENGINES}, got {pass2!r}")
    q = np.asarray(q)
    t = np.asarray(t)
    qlen = np.asarray(qlen).astype(np.int64)
    tlen = np.asarray(tlen).astype(np.int64)
    B, n = q.shape
    m = t.shape[1]
    n_pad = ceil_to(max(n, 1), TI)
    W2 = (ceil_to(max(m, 1), LANES) // LANES + 2) * LANES
    per_pair = ptr_bytes_per_pair(n_pad, W2)
    gmode = mode == "global"
    if want_tb and gmode:
        # pointer-stream budget: chunk oversized batches and merge
        cap_pairs = max(32, ptr_cap_bytes() // per_pair)
        if B > cap_pairs:
            log.info("pointer-stream budget: chunking %d pairs into <=%d-pair "
                     "calls (%.1f MB/pair)", B, cap_pairs, per_pair / 1e6)
            parts = [
                strip_bucket(q[lo : lo + cap_pairs], t[lo : lo + cap_pairs],
                             qlen[lo : lo + cap_pairs], tlen[lo : lo + cap_pairs],
                             tables, mode=mode, want_tb=True, pass2=pass2,
                             tie_safe=tie_safe, WR=WR, BW=BW)
                for lo in range(0, B, cap_pairs)
            ]
            merged = {
                k: (sum((p[k] for p in parts), []) if k == "cigars"
                    else np.concatenate([p[k] for p in parts]))
                for k in parts[0]
            }
            return lambda: merged
    device = tables.table.device
    qpad, t2, qlen_d, tlen_d = stage_strip(q, t, qlen, tlen, tables.A1, device)
    if gmode:
        err = error_words(1, device)
        r = strip_fill(qpad, t2, qlen_d, tlen_d, tables, mq=m, mode="gmode",
                       want_ptr=want_tb, err=err)
        finish = global_post(r["bv"], r.get("P"), qlen, tlen, tables, want_tb, err)
    else:
        WR = ceil_to(WR, TI)
        fused_tb = want_tb and B * per_pair <= ptr_cap_bytes()
        fused = local_fused_tb if fused_tb else local_fused
        res = fused(qpad, t2, qlen_d, tlen_d, tables, mq=m, WR=WR, pass2=pass2,
                    tie_safe=tie_safe, err=error_words(5, device), BW=BW)
        text = res.pop("text") if fused_tb else None
        wait = to_host(res)  # nchar among them

        def finish():
            return _local_finish(wait(), text, q, t, tables, n_pad=n_pad, W2=W2, WR=WR,
                                 want_tb=want_tb, fused_tb=fused_tb)
    if device.type == "cpu":
        out = finish()
        return lambda: out
    return finish


def _local_finish(host, text, q, t, tables: Tables, *, n_pad: int, W2: int, WR: int,
                  want_tb: bool, fused_tb: bool):
    """The host half of a local ``strip_bucket``: ``host`` is the copy of
    ``local_fused``'s results, ``text`` the walk's CIGAR text (on the
    device, with ``fused_tb``)."""
    # the four row windows' and the fills' deferred checks, read in the same copy
    raise_on_error(host["row_err"][:4], (n_pad, W2, n_pad, W2))
    raise_on_bad_length(host["row_err"][4])
    B = q.shape[0]
    score = host["score"].astype(np.int32)
    qe = host["qe"].astype(np.int64)
    te = host["te"].astype(np.int64)
    qs = host["qs"].astype(np.int32)
    ts = host["ts"].astype(np.int32)
    # a pair whose alignment spans more than the pass-2 window did not
    # reproduce its score there: rerun it wider
    fail = (host["score2"] != score) & (score > 0)
    if fail.any():
        log.info("two-pass start recovery: %d/%d pairs escalated past the "
                 "%d-row window", int(fail.sum()), B, WR)
        qs2, ts2 = reverse_starts(q, t, np.where(fail, score, 0), qe, te, tables,
                                  Wq0=max(4 * TI, 2 * WR))
        qs = np.where(fail, qs2, qs)
        ts = np.where(fail, ts2, ts)
    out = {
        "score": score,
        "qs": qs.astype(np.int32),
        "qe": qe.astype(np.int32),
        "ts": ts.astype(np.int32),
        "te": te.astype(np.int32),
        "escalated": fail,
    }
    if not want_tb:
        return out
    if fused_tb:
        ok = ~fail & (score > 0)
        if not np.array_equal(host["score_w"][ok], score[ok]):
            raise RuntimeError("window-global score must equal the local score")
        # the walk's deferred range check raises here
        cigars = cigars_from_text(text, host["nchar"])
        for b in np.nonzero(score <= 0)[0]:
            cigars[b] = ""
        # escalated pairs were windowed from their pass-2 starts: rebuild
        idx = np.nonzero(fail)[0]
        if idx.size:
            fixed = window_global_cigars(q[idx], t[idx], score[idx], qs[idx],
                                         qe[idx], ts[idx], te[idx], tables)
            for r, b in enumerate(idx):
                cigars[b] = fixed[r]
    else:
        cigars = window_global_cigars(q, t, score, qs, qe, ts, te, tables)
    out["cigars"] = cigars
    return out
