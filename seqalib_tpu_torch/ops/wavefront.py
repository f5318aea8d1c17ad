"""Full-matrix anti-diagonal wavefront with a band mask, and the bucket
function around it (counterpart of ``seqalib_tpu/ops/wavefront_pallas.py``:
``_fill`` / ``_fill_kernel`` and the banded branch of ``pallas_bucket``).

The route: ``align_batch(band=w, mode="global")`` with a substitution
table outside the packed-nibble range [-4, 11] (``banded_matrix_supported``
is false) goes through the length buckets to ``wavefront_launch`` (the
launch half of ``wavefront_bucket``), as in the JAX package: the fill,
then with a CIGAR the walk on the device (``ops/wavefront_walk.py``).
Only the modes that route reaches are ported: global, affine (a band
forces affine gaps), band mask, with pointers (``want_ptr``) or
score-only.  Not ported, because no entry point reaches
them (``pallas_bucket`` sends unbanded work to the strip engine, and banded
local is out of contract): local with start propagation, linear gaps, no
band.

``wavefront_fill`` layout: lanes are query positions.  On anti-diagonal
``k`` slot ``i`` (0 <= i < Np) holds cell (i, j = k - i); every slot of
every diagonal ``k < K`` has the TPU kernel's byte, the ones with j < 0
included (a slot with j < 0 reads target letter 0), so every pointer byte
the walk can read, the extend bits of row 0 and column 0 included, is the
TPU kernel's.  The kernel keeps state only for the window of slots with
k - 2i in [dlo - 1, dhi + 1] (``window_width``); every other slot's inputs
are -inf, and its byte (``wavefront_far_bytes_ref``) depends on its
letters alone: with pointers a stateless pass writes every byte by that
rule, then the window kernel its own.  Inputs, for a batch of B pairs:

* ``qpad`` (B, Np) int32: ``qpad[:, i] = q[i - 1]`` for 1 <= i <= qlen,
  else the query sentinel;
* ``tk`` (B, Kw >= K) int32: ``tk[:, x] = t[x - 1]`` for 1 <= x <= tlen,
  else the target sentinel;
* ``qlen``, ``tlen`` (B,) int32; the band of a pair is
  ``min(0, d) - band <= j - i <= max(0, d) + band`` with d = tlen - qlen;
* ``tab`` (NT, NT) int32: ``tab[qletter, tletter]``, letters clamped to
  [0, NT - 1] (``wide_table`` scores the sentinels as the TPU kernel's
  route does).

Outputs: ``score`` (B,) int32, H of cell (qlen, tlen); with ``want_ptr``
also ``ptr`` (K, B, Np) uint8, ``ptr[k, b, i]`` = ``PTR_* | ext_e << 2 |
ext_f << 3`` of cell (i, k - i), taken before the band mask.  Kernel:
``csrc/wavefront_fill.cu``.  The window kernel's ring follows the widest
window, so the wrapper needs the largest |tlen - qlen| of the batch: from
the caller's ``span=`` (the bucket has the lengths on the host), else read
back from the device (a device-to-host sync).
"""

from __future__ import annotations

import numpy as np
import torch

from ..scoring import sentinel_table
from ..transfer import host_buffer, to_host, upload
from ..types import NEG_INF, PTR_DIAG, PTR_LEFT, PTR_STOP, PTR_UP, ScoringParams
from . import launches
from .strip_walk import cigars_from_text
from .wavefront_walk import wavefront_walk

LANES = 128
MAX_TABLE = 66  # the kernel keeps the score table in shared memory
# the window kernel's slot rows (2 H, 2 F, E, shifted H over a ring of R
# slots) stay in shared memory beside the table while they fit in this
# many bytes, else in a global scratch buffer
SMEM_BYTES = 200 * 1024
_EXT_E_BIT = 2
_EXT_F_BIT = 3
_EXT_BITS = (1 << _EXT_E_BIT) | (1 << _EXT_F_BIT)  # both extend bits


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def wide_table(sp: ScoringParams) -> np.ndarray:
    """(A + 3, A + 3) int32 table for ``wavefront_fill``: the A real
    letters score as ``sp`` (as the oracle); letters A + 1 and A + 2 are
    the query and target sentinels (the JAX kernel's ``SENT_Q = A1``,
    ``SENT_T = A1 + 1`` over the (A1, A1) sentinel table).  The sentinels
    score 0 on the JAX kernel's profile route (tables of more than 8 rows)
    and ``mismatch`` (the sentinel table's ``[0, 1]``) on its scalar route,
    where they never match."""
    table = sp.substitution_matrix()
    A = table.shape[0]
    sent = 0 if A + 1 > 8 else int(sentinel_table(sp)[0, 1])
    out = np.full((A + 3, A + 3), sent, np.int32)
    out[:A, :A] = table
    return out


def window_width(span: int, band: int, Np: int) -> int:
    """Slots of one diagonal whose state the kernel keeps: those with
    k - 2i in [dlo - 1, dhi + 1] for a band of ``band`` around deltas up to
    ``span`` (dhi - dlo = span + 2 band), at most every slot."""
    return min(Np, (span + 2 * band) // 2 + 2)


def window_ring(width: int, NT: int) -> tuple[int, bool]:
    """(R, rows in shared memory) of the window kernel for windows of
    ``width`` slots: a ring of R >= width + 2 slots, a power of 2."""
    R = 1 << (width + 1).bit_length()
    return R, 4 * (NT * NT + 6 * R) <= SMEM_BYTES


def _check(qpad, tk, qlen, tlen, tab, K):
    dev = qpad.device
    for name, x in (("qpad", qpad), ("tk", tk), ("qlen", qlen), ("tlen", tlen),
                    ("tab", tab)):
        if x.dtype != torch.int32 or x.device != dev:
            raise ValueError(f"wavefront_fill: {name} must be int32 on {dev}")
    if qpad.dim() != 2 or tk.dim() != 2 or tk.shape[0] != qpad.shape[0]:
        raise ValueError("wavefront_fill: qpad and tk must be (B, Np) and (B, Kw)")
    B = qpad.shape[0]
    if qlen.shape != (B,) or tlen.shape != (B,):
        raise ValueError(f"wavefront_fill: qlen and tlen must be ({B},)")
    if not 1 <= K <= tk.shape[1]:
        raise ValueError("wavefront_fill: need 1 <= K <= tk.shape[1]")
    NT = tab.shape[0]
    if tab.shape != (NT, NT) or not 1 <= NT <= MAX_TABLE:
        raise ValueError(f"wavefront_fill: tab must be (NT, NT) with NT <= {MAX_TABLE}")


def wavefront_fill_ref(qpad, tk, qlen, tlen, tab, *, K: int, band: int,
                       gap_open: int, gap_extend: int, want_ptr: bool):
    """Plain PyTorch version: vectorized over (B, Np), one Python step per
    anti-diagonal (int32, the kernel's values)."""
    dev = qpad.device
    B, Np = qpad.shape
    NT = tab.shape[0]
    e, oe = gap_extend, gap_open + gap_extend
    i32 = dict(dtype=torch.int32, device=dev)
    tabf = tab.flatten()
    qrow = qpad.clamp(0, NT - 1).long() * NT
    tkc = tk.clamp(0, NT - 1).long()
    iarr = torch.arange(Np, device=dev)[None, :]
    ql, tl = qlen.long(), tlen.long()
    delta = tl - ql
    dlo = (torch.clamp(delta, max=0) - band)[:, None]
    dhi = (torch.clamp(delta, min=0) + band)[:, None]
    fin = ql + tl
    rows = torch.arange(B, device=dev)
    qcol = ql.clamp(max=Np - 1)
    neg_col = torch.full((B, 1), NEG_INF, **i32)
    H1 = E1 = F1 = sH = torch.full((B, Np), NEG_INF, **i32)
    score = torch.zeros(B, **i32)
    ptrs = []
    for k in range(K):
        j = k - iarr
        W = torch.where(j < 0, 0, tkc.gather(1, j.clamp(min=0).expand(B, -1)))
        s = tabf[qrow + W]
        sH1 = torch.cat([neg_col, H1[:, :-1]], 1)
        d = sH + s
        e_ext, e_opn = E1 + e, H1 + oe
        f_ext, f_opn = torch.cat([neg_col, F1[:, :-1]], 1) + e, sH1 + oe
        En = torch.maximum(e_ext, e_opn)
        Fn = torch.maximum(f_ext, f_opn)
        best = torch.maximum(torch.maximum(d, Fn), En)
        ptr = torch.where(d == best, PTR_DIAG, torch.where(Fn == best, PTR_UP, PTR_LEFT))
        Hn = best
        if k == 0:  # the origin
            Hn = torch.where(iarr == 0, 0, Hn).to(torch.int32)
            ptr = torch.where(iarr == 0, PTR_STOP, ptr)
        dkj = k - 2 * iarr
        oob = (dkj < dlo) | (dkj > dhi)
        Hn = torch.where(oob, NEG_INF, Hn)
        En = torch.where(oob, NEG_INF, En)
        Fn = torch.where(oob, NEG_INF, Fn)
        score = torch.where(fin == k, Hn[rows, qcol], score)
        if want_ptr:
            ptrs.append((ptr | ((e_ext >= e_opn).long() << _EXT_E_BIT)
                         | ((f_ext >= f_opn).long() << _EXT_F_BIT)).to(torch.uint8))
        H1, sH, E1, F1 = Hn, sH1, En, Fn
    out = {"score": score}
    if want_ptr:
        out["ptr"] = torch.stack(ptrs)
    return out


def wavefront_far_bytes_ref(qpad, tk, tab, *, K: int, gap_open: int, gap_extend: int):
    """Plain PyTorch version of the pointer bytes of the slots whose
    inputs are all -inf (k - 2i outside [dlo - 1, dhi + 1]): (K, B, Np)
    uint8, ``(s >= max(e, o + e) ? DIAG : UP) | ext << 2 | ext << 3`` with
    s the cell's letter score and ext = (e >= o + e); the origin's byte is
    STOP with the same extend bits.  ``wavefront_fill``'s kernel writes
    these for every slot, then the band's window over them."""
    dev = qpad.device
    B, Np = qpad.shape
    NT = tab.shape[0]
    e, oe = gap_extend, gap_open + gap_extend
    qrow = qpad.clamp(0, NT - 1).long() * NT
    tkc = tk.clamp(0, NT - 1).long()
    j = torch.arange(K, device=dev)[:, None] - torch.arange(Np, device=dev)[None, :]
    W = torch.where(j[None] < 0, 0, tkc[:, j.clamp(min=0)])  # (B, K, Np)
    s = tab.flatten().long()[qrow[:, None, :] + W]
    ext = _EXT_BITS if e >= oe else 0
    byte = torch.where(s >= max(e, oe), PTR_DIAG, PTR_UP) | ext
    byte[:, 0, 0] = PTR_STOP | ext
    return byte.permute(1, 0, 2).to(torch.uint8).contiguous()


def wavefront_fill(qpad, tk, qlen, tlen, tab, *, K: int, band: int, gap_open: int,
                   gap_extend: int, want_ptr: bool, span: int | None = None):
    """Fill diagonals [0, K) of every pair; see the module docstring.  A
    CPU tensor runs ``wavefront_fill_ref``; a CUDA tensor the kernel.
    ``span``: at least the largest |tlen - qlen| of the batch (None: read
    from the device)."""
    qpad, tk, tab = qpad.contiguous(), tk.contiguous(), tab.contiguous()
    qlen, tlen = qlen.to(torch.int32).contiguous(), tlen.to(torch.int32).contiguous()
    _check(qpad, tk, qlen, tlen, tab, K)
    kw = dict(K=K, band=band, gap_open=gap_open, gap_extend=gap_extend,
              want_ptr=want_ptr)
    if qpad.device.type == "cpu":
        return wavefront_fill_ref(qpad, tk, qlen, tlen, tab, **kw)
    if qpad.device.type != "cuda":
        raise ValueError(f"wavefront_fill: unsupported device {qpad.device}")
    from .._build import launch

    dev = qpad.device
    B, Np = qpad.shape
    NT = tab.shape[0]
    out = {"score": torch.zeros(B, dtype=torch.int32, device=dev)}
    ptr = rows = None
    if want_ptr:
        ptr = out["ptr"] = torch.empty((K, B, Np), dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    if span is None:  # the ring follows the widest window: one host read
        span = int((tlen.long() - qlen.long()).abs().max())
    R, rows_in_smem = window_ring(window_width(span, band, Np), NT)
    if not rows_in_smem:
        rows = torch.empty((B, 6, R), dtype=torch.int32, device=dev)
    launch(
        "wavefront_fill", dev, "seqalib_wavefront_fill", qpad.data_ptr(), Np,
        tk.data_ptr(), tk.shape[1], qlen.data_ptr(), tlen.data_ptr(), tab.data_ptr(),
        NT, B, K, band, gap_open, gap_extend, out["score"].data_ptr(),
        ptr.data_ptr() if ptr is not None else None, R,
        rows.data_ptr() if rows is not None else None,
    )
    # one count per call: with pointers the call launches the far pass,
    # then the window kernel
    launches["wavefront_fill/" + ("ptr" if want_ptr else "score")] += 1
    return out


def _geometry(q, t):
    """(B, n, m, Np, K) of a padded bucket: Np = n + 1 rounded up to 128,
    K = n + m + 1 (the JAX ``_fill``)."""
    B, n = q.shape
    m = t.shape[1]
    return B, n, m, _ceil_to(n + 1, LANES), n + m + 1


def _fill_inputs(qpad, tk, q, t, qlen, tlen, sent_q: int, sent_t: int) -> None:
    """Write ``wavefront_fill``'s letters of a padded bucket into ``qpad``
    (B, Np) and ``tk`` (B, K), int32 arrays: ``qpad[:, i] = q[:, i - 1]``
    for 1 <= i <= qlen, ``tk[:, x] = t[:, x - 1]`` for 1 <= x <= tlen, the
    sentinels elsewhere."""
    n, m = q.shape[1], t.shape[1]
    qpad[:] = sent_q
    qpad[:, 1: 1 + n] = np.where(np.arange(n)[None, :] < qlen[:, None], q, sent_q)
    tk[:] = sent_t
    tk[:, 1: 1 + m] = np.where(np.arange(m)[None, :] < tlen[:, None], t, sent_t)


def wavefront_inputs(q, t, qlen, tlen, sp: ScoringParams):
    """``wavefront_fill``'s letter and table inputs for a padded bucket
    (B, n) x (B, m), as numpy arrays: (qpad (B, Np), tk (B, K), tab)."""
    q, t = np.asarray(q), np.asarray(t)
    B, n, m, Np, K = _geometry(q, t)
    tab = wide_table(sp)
    qpad = np.empty((B, Np), np.int32)
    tk = np.empty((B, K), np.int32)
    _fill_inputs(qpad, tk, q, t, np.asarray(qlen), np.asarray(tlen), tab.shape[0] - 2,
                 tab.shape[0] - 1)
    return qpad, tk, tab


def stage_wavefront(q, t, qlen, tlen, sp: ScoringParams, device):
    """``wavefront_inputs`` and the lengths, built in one host buffer
    (pinned for a CUDA device) and copied to ``device`` in one copy with no
    sync: (qpad, tk, qlen, tlen, tab) int32 tensors on ``device``."""
    q, t = np.asarray(q), np.asarray(t)
    B, n, m, Np, K = _geometry(q, t)
    table = wide_table(sp)
    NT = table.shape[0]
    sizes = [B * Np, B * K, B, B, NT * NT]
    buf = host_buffer(sum(sizes), device)
    qpad, tk, ql, tl, tab = np.split(buf.numpy(), np.cumsum(sizes)[:-1])
    _fill_inputs(qpad.reshape(B, Np), tk.reshape(B, K), q, t, qlen, tlen, NT - 2, NT - 1)
    ql[:] = qlen
    tl[:] = tlen
    tab[:] = table.reshape(-1)
    qpad_d, tk_d, ql_d, tl_d, tab_d = torch.split(upload(buf, device), sizes)
    return qpad_d.view(B, Np), tk_d.view(B, K), ql_d, tl_d, tab_d.view(NT, NT)


def wavefront_launch(q, t, qlen, tlen, sp: ScoringParams, *, band: int, want_tb: bool,
                     device):
    """The launch half of ``wavefront_bucket`` (same arguments): the
    letters' one copy (``stage_wavefront``), the fill, with ``want_tb`` the
    walk (``wavefront_walk``), and the copy of the small results (score,
    and with ``want_tb`` the CIGAR lengths and the walkers' final state) to
    the host behind an event, all enqueued with no device-to-host sync on a
    CUDA device: the ring's span comes from the host lengths.  The pointer
    stream is dropped once the walk is queued; only the text rows wait for
    the finalize.  Returns the finalize callable, which waits for that copy
    only, decodes the CIGARs from the text rows' used tail
    (``cigars_from_text``, which raises for a start cell outside the
    stream) and returns ``wavefront_bucket``'s dict.  On the CPU everything
    runs here and the callable only returns the result."""
    qlen = np.asarray(qlen).astype(np.int64)
    tlen = np.asarray(tlen).astype(np.int64)
    B = len(qlen)
    device = torch.device(device)
    qpad, tk, ql, tl, tab = stage_wavefront(q, t, qlen, tlen, sp, device)
    span = int(np.abs(tlen - qlen).max(initial=0))
    res = wavefront_fill(qpad, tk, ql, tl, tab, K=tk.shape[1], band=band,
                         gap_open=sp.gap_open, gap_extend=sp.gap_extend, want_ptr=want_tb,
                         span=span)
    copy = {"score": res.pop("score")}
    text = None
    if want_tb:
        text, copy["nchar"], copy["state"] = wavefront_walk(res.pop("ptr"), ql, tl)
    wait = to_host(copy)

    def finish():
        host = wait()
        out = {"score": host["score"], "qe": qlen.astype(np.int32),
               "te": tlen.astype(np.int32)}
        if not want_tb:
            out["qs"] = np.zeros(B, np.int32)
            out["ts"] = np.zeros(B, np.int32)
            return out
        out["cigars"] = cigars_from_text(text, host["nchar"])
        out["qs"] = host["state"][0].copy()
        out["ts"] = host["state"][1].copy()
        return out

    if device.type == "cpu":
        out = finish()
        return lambda: out
    return finish


def wavefront_bucket(q, t, qlen, tlen, sp: ScoringParams, *, band: int,
                     want_tb: bool, device):
    """One padded bucket (B, n) x (B, m) on the banded full-matrix route
    (``pallas_bucket``'s banded branch): global score read at (b, qlen),
    ``qs = ts = 0``, and with ``want_tb`` the CIGARs and start cells from
    the walk over the pointer stream.  Returns score/qs/qe/ts/te (+
    cigars).  ``wavefront_launch(...)()``."""
    return wavefront_launch(q, t, qlen, tlen, sp, band=band, want_tb=want_tb,
                            device=device)()
