"""Strip fill (counterpart of ``strip_pallas._strip_kernel`` / ``_strip_fill``).

One call fills the DP matrix of every pair of a batch:

* ``q`` (B, Nq) int32: query letters, row i (1-based) at ``q[:, i-1]``;
* ``t2`` (B, W) int32: target letters, column j (1-based) at ``t2[:, j]``
  (column 0 holds a sentinel, the layout of the JAX package);
* ``qlen`` / ``tlen`` (B,) int32 with ``qlen <= Nq`` and ``tlen < W``.

Modes (the JAX kernel's flags): ``"local"`` end-only SW; ``"emode"`` global
boundaries, no zero clamp, argmax tracking; ``"gmode"`` capture of
H(qlen, tlen).  Outputs, over the valid box 1 <= i <= qlen, 1 <= j <= tlen:

* ``bv`` (B,) int32: the best score (local/emode, starting from 0) or the
  captured H(qlen, tlen) (gmode; 0 when qlen or tlen is 0);
* ``bk`` (B,) int32: ``i * (mq + 1) + j`` of the first best cell in (i, j)
  scan order, 0 when no cell beats 0 (always 0 in gmode);
* ``P`` (B, Nq, W - 1) uint8 when ``want_ptr``: cell (i, j) at
  ``[:, i-1, j-1]``, bits 0-1 ``PTR_*`` (STOP where a local cell's best is
  <= 0), bit 2 E-extend, bit 3 F-extend; 0 outside the valid box.

Kernel: ``csrc/strip_fill.cu``: one CTA of ``strip_warps(Nq)`` warps per
pair, warp w running strips w, w + W, ... of 32 rows, each strip's bottom
row handed to the next through shared memory (``strip_smem`` sizes it).

A length outside its letter array is refused with a ``ValueError``.  A
call without ``err`` checks at once (on a CUDA tensor that is a
device-to-host sync).  A call on a CUDA tensor with ``err`` (a one-word
int32 tensor from ``row_window.error_words``) records the first bad pair
in the word instead and launches with every length clamped into its
array; the caller reads the word later and raises with
``raise_on_bad_length``.
"""

from __future__ import annotations

import torch

from ..types import NEG_INF, PTR_DIAG, PTR_LEFT, PTR_STOP, PTR_UP

from ..scoring import SENT_SCORE, Tables
from . import launches
from .row_window import NO_ERROR

MODES = {"local": 0, "emode": 1, "gmode": 2}
# the kernel keeps the (letters + 2)^2 table (sentinel row and column
# included) in shared memory
MAX_LETTERS = 63
MAX_WARPS = 8   # csrc/strip_fill.cu: kMaxWarps
RING = 256      # csrc/strip_fill.cu: kRing, columns of a ring between warps
# shared memory a CTA may take before the letters, then the wrap row, go to
# global memory: four CTAs of this size fit on an H100 SM (227 KB)
SMEM_BUDGET = 56 * 1024


def strip_warps(nq: int) -> int:
    """Warps per pair for a query width ``nq``: one per 32-row strip, at
    most 8 (enough to hide a step's latencies at B >= 128 pairs)."""
    return max(1, min(MAX_WARPS, -(-nq // 32)))


def strip_smem(A1: int, t_width: int, warps: int) -> tuple[int, bool, bool]:
    """(bytes, letters staged, wrap row in shared memory) of the kernel's
    dynamic shared memory: the (warps - 1) rings of RING (H, F) columns,
    the table, the counters and the reduction always; the target letters
    (4 bytes a column) and the wrap row (8 bytes a column) while they fit
    in SMEM_BUDGET, else they are read from and kept in global memory."""
    base = 8 * (warps - 1) * RING + 4 * ((A1 + 1) ** 2 + 3 * MAX_WARPS)
    letters = base + 4 * t_width <= SMEM_BUDGET
    if letters:
        base += 4 * t_width
    row = base + 8 * t_width <= SMEM_BUDGET
    return base + 8 * t_width * row, letters, row


def raise_on_bad_length(word) -> None:
    """Raise when a deferred check recorded a bad pair in ``word`` (a host
    value)."""
    if int(word) != NO_ERROR:
        raise ValueError(f"strip_fill: a length exceeds its letter array (pair {int(word)})")


def _check(q, t2, qlen, tlen, tables: Tables, mode: str, want_ptr: bool, err):
    """Check the arguments; returns the lengths to launch with."""
    if mode not in MODES:
        raise ValueError(f"strip_fill: unknown mode {mode!r}")
    if want_ptr and mode == "emode":
        raise ValueError("strip_fill: emode emits no pointers")
    dev = q.device
    if q.dtype != torch.int32 or t2.dtype != torch.int32:
        raise ValueError("strip_fill: letters must be int32")
    if q.dim() != 2 or t2.dim() != 2 or q.shape[0] != t2.shape[0]:
        raise ValueError("strip_fill: q and t2 must be (B, Nq) and (B, W)")
    B = q.shape[0]
    for name, v in (("qlen", qlen), ("tlen", tlen)):
        if v.dtype != torch.int32 or v.shape != (B,) or v.device != dev:
            raise ValueError(f"strip_fill: {name} must be ({B},) int32 on {dev}")
    if t2.device != dev or tables.table.device != dev:
        raise ValueError("strip_fill: all tensors must share one device")
    if not 0 <= tables.A1 - 1 <= MAX_LETTERS:
        raise ValueError(
            f"strip_fill: alphabet of {tables.A1 - 1} letters > {MAX_LETTERS}")
    bad = (qlen < 0) | (qlen > q.shape[1]) | (tlen < 0) | (tlen >= t2.shape[1])
    if err is not None and dev.type == "cuda":
        if err.dtype != torch.int32 or err.numel() != 1 or err.device != dev:
            raise ValueError(f"strip_fill: err must be one int32 word on {dev}")
        if B:
            first = torch.where(bad, torch.arange(B, dtype=torch.int32, device=dev),
                                NO_ERROR).amin()
            torch.minimum(err, first, out=err)
        return (qlen.clamp(0, q.shape[1]).contiguous(),
                tlen.clamp(0, max(t2.shape[1] - 1, 0)).contiguous())
    if bool(bad.any()):
        raise ValueError("strip_fill: a length exceeds its letter array")
    return qlen, tlen


def strip_fill_ref(q, t2, qlen, tlen, tables: Tables, *, mq: int, mode: str,
                   want_ptr: bool = False):
    """Plain PyTorch version: a whole-matrix anti-diagonal wavefront,
    vectorized over pairs and rows (int64 arithmetic, same outputs)."""
    dev = q.device
    B, nw = q.shape
    W = t2.shape[1]
    A1 = tables.A1
    affine = tables.affine
    e = tables.gap_extend
    oe = tables.gap_open + e
    go = tables.gap_open if affine else 0
    local = mode == "local"
    NEG = NEG_INF
    tab = torch.full((A1 + 1, A1 + 1), SENT_SCORE, dtype=torch.int64, device=dev)
    tab[:A1, :A1] = tables.table.long()
    tab = tab.flatten()
    # qi[:, i] = letter of row i (row 0 unused); letters >= A1 are sentinels
    qi = torch.cat(
        [torch.full((B, 1), A1, dtype=torch.int64, device=dev),
         q.long().clamp(0, A1)], 1
    ) * (A1 + 1)
    ti = t2.long().clamp(0, A1)
    n = qlen.long()[:, None]
    m = tlen.long()[:, None]
    i = torch.arange(nw + 1, device=dev)[None, :]
    stride = mq + 1

    def shift(x):  # out[:, i] = x[:, i - 1]
        return torch.cat([torch.full_like(x[:, :1], NEG), x[:, :-1]], 1)

    # diagonal k holds cells (i, k - i); start from k = 0 (cell (0, 0))
    neg = torch.full((B, nw + 1), NEG, dtype=torch.int64, device=dev)
    Hk2 = neg.clone()           # diagonal k - 2
    Hk1 = neg.clone()           # diagonal k - 1
    Hk1[:, 0] = 0
    Ek1 = neg.clone()
    Fk1 = neg.clone()
    best = torch.zeros(B, dtype=torch.int64, device=dev)
    bkey = torch.zeros(B, dtype=torch.int64, device=dev)
    cap = torch.zeros(B, dtype=torch.int64, device=dev)
    pcols = W - 1
    P = None
    if want_ptr:
        # one dummy slot per pair takes the writes of invalid cells
        P = torch.zeros((B, nw * pcols + 1), dtype=torch.uint8, device=dev)
    big = torch.iinfo(torch.int64).max
    K = int((qlen.long() + tlen.long()).max()) if B else 0
    for k in range(1, K + 1):
        j = k - i
        s = tab[qi + ti.gather(1, j.clamp(0, W - 1).expand(B, -1))]
        Hup = shift(Hk1)
        d = shift(Hk2) + s
        if affine:
            e_ext, e_opn = Ek1 + e, Hk1 + oe
            f_ext, f_opn = shift(Fk1) + e, Hup + oe
            E = torch.maximum(e_ext, e_opn)
            F = torch.maximum(f_ext, f_opn)
            up, left = F, E
        else:
            E = F = neg
            up, left = Hup + e, Hk1 + e
        bestv = torch.maximum(d, torch.maximum(up, left))
        H = bestv.clamp(min=0) if local else bestv
        # boundary cells (0, k) and (k, 0): H = [o +] k*e, or 0 when local
        bnd = 0 if local else go + k * e
        edge = (i == 0) | (i == k)
        H = torch.where(edge, bnd, torch.where(j < 0, NEG, H))
        E = torch.where(edge | (j < 0), NEG, E)
        F = torch.where(edge | (j < 0), NEG, F)
        valid = (i >= 1) & (i <= n) & (j >= 1) & (j <= m)
        if want_ptr:
            byte = torch.where(
                d == bestv, PTR_DIAG, torch.where(up == bestv, PTR_UP, PTR_LEFT)
            )
            if local:
                byte = torch.where(bestv <= 0, PTR_STOP, byte)
            if affine:
                byte = byte | ((e_ext >= e_opn).long() << 2)
                byte = byte | ((f_ext >= f_opn).long() << 3)
            flat = torch.where(valid, (i - 1) * pcols + (j - 1), nw * pcols)
            P.scatter_(1, flat, byte.to(torch.uint8))
        if mode == "gmode":
            hit = (n + m == k) & (n >= 1) & (m >= 1)
            cap = torch.where(hit[:, 0], H.gather(1, n)[:, 0], cap)
        else:
            vals = torch.where(valid, H, NEG)
            vmax = vals.max(1).values
            key = torch.where(vals == vmax[:, None], i * stride + j, big).min(1).values
            bkey = torch.where(
                vmax > best, key,
                torch.where(vmax == best, torch.minimum(bkey, key), bkey),
            )
            best = torch.maximum(best, vmax)
        Hk2, Hk1, Ek1, Fk1 = Hk1, H, E, F
    out = {"bv": (cap if mode == "gmode" else best).to(torch.int32)}
    out["bk"] = torch.zeros_like(out["bv"]) if mode == "gmode" else bkey.to(torch.int32)
    if want_ptr:
        out["P"] = P[:, : nw * pcols].reshape(B, nw, pcols)
    return out


def strip_fill(q, t2, qlen, tlen, tables: Tables, *, mq: int, mode: str,
               want_ptr: bool = False, err=None):
    """Fill every pair of the batch; see the module docstring.  A CPU
    tensor runs ``strip_fill_ref``; a CUDA tensor the kernel, with
    ``strip_warps(Nq)`` warps per pair."""
    q = q.contiguous()
    t2 = t2.contiguous()
    qlen = qlen.to(torch.int32).contiguous()
    tlen = tlen.to(torch.int32).contiguous()
    qlen, tlen = _check(q, t2, qlen, tlen, tables, mode, want_ptr, err)
    if q.device.type == "cpu":
        return strip_fill_ref(q, t2, qlen, tlen, tables, mq=mq, mode=mode,
                              want_ptr=want_ptr)
    if q.device.type != "cuda":
        raise ValueError(f"strip_fill: unsupported device {q.device}")
    from .._build import launch

    dev = q.device
    B, nw = q.shape
    W = t2.shape[1]
    bv = torch.zeros(B, dtype=torch.int32, device=dev)
    bk = torch.zeros(B, dtype=torch.int32, device=dev)
    out = {"bv": bv, "bk": bk}
    P = None
    if want_ptr:
        P = torch.zeros((B, nw, W - 1), dtype=torch.uint8, device=dev)
        out["P"] = P
    if B == 0:
        return out
    nwarp = strip_warps(nw)
    smem, letters, row_in_smem = strip_smem(tables.A1, W, nwarp)
    rows = None if row_in_smem else torch.empty((B, W, 2), dtype=torch.int32, device=dev)
    table = tables.table.to(torch.int32).contiguous()
    launch(
        "strip_fill", dev, "seqalib_strip_fill", q.data_ptr(), nw, t2.data_ptr(), W,
        qlen.data_ptr(), tlen.data_ptr(), table.data_ptr(), tables.A1, B, mq,
        tables.gap_open, tables.gap_extend, int(tables.affine), MODES[mode], nwarp,
        int(letters), smem, rows.data_ptr() if rows is not None else None,
        P.data_ptr() if want_ptr else None, bv.data_ptr(), bk.data_ptr(),
    )
    launches[f"strip_fill/{mode}"] += 1
    return out
