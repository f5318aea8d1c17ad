"""Full-matrix anti-diagonal wavefront fill, and the bucket function around
it (counterpart of ``seqalib_tpu/ops/wavefront_pallas.py``: ``_fill`` /
``_fill_kernel`` and the banded branch of ``pallas_bucket``).

Two routes reach it, as in the JAX package:

* ``align_batch(band=w, mode="global")`` with a substitution table outside
  the packed-nibble range [-4, 11] (``banded_matrix_supported`` is false)
  goes through the length buckets to ``wavefront_launch`` (the launch half
  of ``wavefront_bucket``): global, affine (a band forces affine gaps),
  band mask, then with a CIGAR the walk on the device
  (``ops/wavefront_walk.py``);
* ``backend="xla"`` (``ops/wavefront_xla.py``): every mode of the fill,
  global or local, linear or affine gaps, with a band mask or none.

``wavefront_fill`` computes every mode of ``_fill_kernel``: ``mode``
``"global"`` or ``"local"`` (local with start propagation when score-only),
``affine`` or linear gaps (2-bit pointers, no E/F state), ``band`` or none
(``band=None``).  Layout: lanes are query positions.  On anti-diagonal
``k`` slot ``i`` (0 <= i < Np) holds cell (i, j = k - i); every slot of
every diagonal ``k < K`` has the TPU kernel's byte, the ones with j < 0
included (a slot with j < 0 reads target letter 0), so every pointer byte
the walk can read, the extend bits of row 0 and column 0 included, is the
TPU kernel's.  With a band the kernel keeps state only for the window of
slots with k - 2i in [dlo - 1, dhi + 1] (``window_width``); every other
slot's inputs are -inf, and its byte (``wavefront_far_bytes_ref``) depends
on its letters alone: with pointers a stateless pass writes every byte by
that rule, then the window kernel its own.  Unbanded, the window is every
slot and there is no far pass.  Inputs, for a batch of B pairs:

* ``qpad`` (B, Np) int32: ``qpad[:, i] = q[i - 1]`` for 1 <= i <= qlen,
  else the query sentinel;
* ``tk`` (B, Kw >= K) int32: ``tk[:, x] = t[x - 1]`` for 1 <= x <= tlen,
  else the target sentinel;
* ``qlen``, ``tlen`` (B,) int32; the band of a pair is
  ``min(0, d) - band <= j - i <= max(0, d) + band`` with d = tlen - qlen;
* ``tab`` (NT, NT) int32: ``tab[qletter, tletter]``, letters clamped to
  [0, NT - 1] (``wide_table`` scores the sentinels as the TPU kernel's
  route does).

Outputs.  Global: ``score`` (B,) int32, H of cell (qlen, tlen).  Local:
the TPU kernel's per-slot bests over the valid cells (1 <= i <= qlen,
1 <= j <= tlen), ``bv`` (B, Np) the best H of slot i and ``bk`` the first
diagonal k reaching it (updated on a strict >), and score-only also ``bs``,
the start cell propagated to that best, packed ``i * stride + j``
(``stride`` = the padded target width + 1, the JAX kernel's ``m + 1``).
With ``want_ptr`` also ``ptr`` (K, B, Np) uint8, ``ptr[k, b, i]`` =
``PTR_*`` of cell (i, k - i), affine ``| ext_e << 2 | ext_f << 3``, taken
before the band mask.  Kernels: ``csrc/wavefront_fill.cu``, by mode
(``fill_kernel``).  An unbanded score-only fill runs the strip kernel:
pipelined strip warps per pair over the valid cells only (no output reads
another slot), sized by ``wavefront_strip_geometry``, its target columns
cut to Np + ``span`` when the caller passes one (``strip_columns``).  An
unbanded global fill with pointers runs the pointer strip kernel:
pipelined strip warps per pair over every slot of every diagonal (every
byte of the stream is an output, and global affine column 0 reads the
slots with j < 0), a strip's lanes on one diagonal at each step so that
its 32 bytes of a diagonal are one store, sized by
``wavefront_strip_ptr_geometry``.  Every other mode runs the window kernel
(after the far pass when banded with pointers); a banded window kernel's
ring follows the widest window, so the wrapper needs the largest
|tlen - qlen| of the batch: from the caller's ``span=`` (the bucket has
the lengths on the host), else read back from the device (a device-to-host
sync).

One departure from the TPU kernel, in local affine mode: the TPU kernel
computes E of column 0 from the slots with j < 0, which score target
letter 0 and so hold positive junk in local mode; that junk reaches E of
column 1 and can raise local scores above the oracle's (a 32-letter
DNA query of 30 A's against ACCGTT: 21 against the oracle's 4).  The port
sets E of column 0 to -inf, as the oracle does, after its pointer byte is
taken; where the junk stays below -gap_extend every output is the TPU
kernel's.

A second one, on the card only, in global affine mode with no band and no
pointers: the TPU kernel (and ``wavefront_fill_ref``) computes the cells
of column 0 from the slots with j < 0, whose H stays near -2^30 in global
mode; the strip kernel, which computes no such slot, gives column 0 the
oracle's boundary o + e + (i - 1) * max(e, o + e).  The two agree wherever
that junk stays below the boundary values, which only letter scores
summing towards 2^30 along a query can break
(``tests/test_torch_kernels_cuda.py`` holds a pair scoring 1.54e9).
"""

from __future__ import annotations

import numpy as np
import torch

from ..scoring import sentinel_table
from ..transfer import host_buffer, to_host, upload
from ..types import NEG_INF, PTR_DIAG, PTR_LEFT, PTR_STOP, PTR_UP, ScoringParams
from ..utils import ceil_to
from ..utils.cigar import cigars_from_text
from . import launches
from .strip import ptr_cap_bytes
from .wavefront_walk import wavefront_walk

LANES = 128
MAX_TABLE = 66  # the kernel keeps the score table in shared memory
# the window kernel's slot rows (``window_rows`` of them over a ring of R
# slots) stay in shared memory beside the table while they fit in this
# many bytes, else in a global scratch buffer
SMEM_BYTES = 200 * 1024
# the strip kernel (unbanded score-only fills): warps per pair at most
# (csrc/wavefront_fill.cu: kStripMaxWarps), columns of a ring between
# warps (kStripRing), and the shared memory a CTA may take before the
# target letters, then the wrap row, go to global memory: four CTAs of
# this size fit on an H100 SM (227 KB)
STRIP_MAX_WARPS = 16
STRIP_RING = 256
STRIP_SMEM_BUDGET = 56 * 1024
# the pointer strip kernel (unbanded global fills with pointers): warps per
# pair at most (csrc/wavefront_fill.cu: kPtrMaxWarps); its shared memory
# follows STRIP_SMEM_BUDGET too
STRIP_PTR_MAX_WARPS = 8
_EXT_E_BIT = 2
_EXT_F_BIT = 3
_EXT_BITS = (1 << _EXT_E_BIT) | (1 << _EXT_F_BIT)  # both extend bits
MODES = ("global", "local")


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


def launch_key(mode: str, affine: bool, want_ptr: bool) -> str:
    """The ``launches`` key of a ``wavefront_fill`` call: ``ptr``/``score``
    (global affine), ``lin_ptr``/``lin_score`` (global linear), ``local``,
    ``local_lin`` (score-only, with start propagation) and ``local_ptr``,
    ``local_lin_ptr``."""
    if mode == "local":
        return ("wavefront_fill/local" + ("" if affine else "_lin")
                + ("_ptr" if want_ptr else ""))
    return "wavefront_fill/" + ("" if affine else "lin_") + ("ptr" if want_ptr else "score")


def window_width(span: int, band: int | None, Np: int) -> int:
    """Slots of one diagonal whose state the kernel keeps: those with
    k - 2i in [dlo - 1, dhi + 1] for a band of ``band`` around deltas up to
    ``span`` (dhi - dlo = span + 2 band), at most every slot; every slot
    with no band."""
    if band is None:
        return Np
    return min(Np, (span + 2 * band) // 2 + 2)


def window_rows(mode: str, affine: bool, want_ptr: bool) -> int:
    """Slot rows of the window kernel's ring: H (2), the shifted H (1),
    affine F (2) and E (1); local score-only the start cells of H (2), of
    the shifted H (1) and, affine, of F (2) and E (1)."""
    rows = 6 if affine else 3
    if mode == "local" and not want_ptr:
        rows *= 2
    return rows


def window_ring(width: int, NT: int, rows: int = 6) -> tuple[int, bool]:
    """(R, rows in shared memory) of the window kernel for windows of
    ``width`` slots and ``rows`` slot rows (``window_rows``): a ring of
    R >= width + 2 slots, a power of 2."""
    R = 1 << (width + 1).bit_length()
    return R, 4 * (NT * NT + rows * R) <= SMEM_BYTES


def fill_kernel(band: int | None, want_ptr: bool, mode: str = "global") -> str:
    """The kernel a ``wavefront_fill`` call on the card launches:
    ``"strip"`` (pipelined strip warps over the valid cells) for an
    unbanded score-only fill, ``"strip_ptr"`` (pipelined strip warps over
    every slot) for an unbanded global fill with pointers, else
    ``"window"`` (a thread per slot of the band's window, or of every slot
    for an unbanded local fill with pointers)."""
    if band is None:
        if not want_ptr:
            return "strip"
        if mode == "global":
            return "strip_ptr"
    return "window"


def wavefront_strip_warps(Np: int) -> int:
    """Warps per pair of the strip kernel for ``Np`` slots: one per
    32-row strip of rows 1 .. Np - 1, at most 8."""
    return max(1, min(8, -(-(Np - 1) // 32)))


def wavefront_strip_geometry(Np: int, NT: int, cols: int, mode: str,
                             affine: bool) -> tuple[int, int, bool, bool]:
    """(warps, shared-memory bytes, letters in shared memory, wrap row in
    shared memory) of the strip kernel over ``Np`` slots, an (NT, NT) table
    and ``cols`` target columns (letters and the wrap row hold columns
    [0, cols)).  Always in shared memory: the (warps - 1) rings of
    STRIP_RING columns (16 bytes a column in local affine mode: H, F and
    their start cells; 8 otherwise), the table and the counters; the target
    letters (4 bytes a column), then the wrap row (a ring's column size a
    column), while they fit in STRIP_SMEM_BUDGET, else they are read from
    and kept in global memory."""
    warps = wavefront_strip_warps(Np)
    col = 16 if mode == "local" and affine else 8
    base = col * (warps - 1) * STRIP_RING + 4 * (NT * NT + STRIP_MAX_WARPS)
    letters = base + 4 * cols <= STRIP_SMEM_BUDGET
    if letters:
        base += 4 * cols
    row = base + col * cols <= STRIP_SMEM_BUDGET
    return warps, base + col * cols * row, letters, row


def wavefront_strip_ptr_warps(Np: int) -> int:
    """Warps per pair of the pointer strip kernel for ``Np`` slots: one per
    32-slot strip of slots 0 .. Np - 1, at most STRIP_PTR_MAX_WARPS."""
    return max(1, min(STRIP_PTR_MAX_WARPS, -(-Np // 32)))


def wavefront_strip_ptr_geometry(Np: int, NT: int, K: int,
                                 affine: bool) -> tuple[int, int, bool, bool]:
    """(warps, shared-memory bytes, letters in shared memory, wrap rows in
    shared memory) of the pointer strip kernel over ``Np`` slots, an
    (NT, NT) table and ``K`` diagonals.  Always in shared memory: the
    (warps - 1) rings of STRIP_RING entries (8 bytes an entry affine: H and
    F; 4 linear), the table and the counters; the target letters (4 bytes
    a column, K of them), then the two wrap rows (K + 1 entries each),
    while they fit in STRIP_SMEM_BUDGET, else they are read from and kept
    in global memory."""
    warps = wavefront_strip_ptr_warps(Np)
    col = 8 if affine else 4
    base = col * (warps - 1) * STRIP_RING + 4 * (NT * NT + STRIP_MAX_WARPS)
    letters = base + 4 * K <= STRIP_SMEM_BUDGET
    if letters:
        base += 4 * K
    wrap = 2 * col * (K + 1)
    rows = base + wrap <= STRIP_SMEM_BUDGET
    return warps, base + wrap * rows, letters, rows


def strip_columns(K: int, Np: int, span: int | None) -> int:
    """Target columns the strip kernel keeps: [0, K), cut to [0, Np + span)
    when ``span`` bounds |tlen - qlen| (tlen <= qlen + span <= Np - 1 +
    span)."""
    return K if span is None else max(1, min(K, Np + span))


def _check(qpad, tk, qlen, tlen, tab, K, mode, want_ptr, stride):
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
    if mode not in MODES:
        raise ValueError(f"wavefront_fill: mode must be one of {MODES}, got {mode!r}")
    if mode == "local" and not want_ptr and (stride is None or stride < 1):
        raise ValueError("wavefront_fill: local score-only mode needs stride >= 1")


def wavefront_fill_ref(qpad, tk, qlen, tlen, tab, *, K: int, band: int | None,
                       gap_open: int, gap_extend: int, want_ptr: bool,
                       mode: str = "global", affine: bool = True,
                       stride: int | None = None):
    """Plain PyTorch version: vectorized over (B, Np), one Python step per
    anti-diagonal (int32, the kernel's values), the TPU kernel's
    ``substep`` line for line."""
    dev = qpad.device
    B, Np = qpad.shape
    NT = tab.shape[0]
    local = mode == "local"
    track = local and not want_ptr  # start propagation
    e, oe = gap_extend, gap_open + gap_extend
    i32 = dict(dtype=torch.int32, device=dev)
    tabf = tab.flatten()
    qrow = qpad.clamp(0, NT - 1).long() * NT
    tkc = tk.clamp(0, NT - 1).long()
    iarr = torch.arange(Np, device=dev)[None, :]
    ql, tl = qlen.long()[:, None], tlen.long()[:, None]
    if band is not None:
        delta = tl - ql
        dlo = torch.clamp(delta, max=0) - band
        dhi = torch.clamp(delta, min=0) + band
    rows = torch.arange(B, device=dev)
    qcol = qlen.long().clamp(max=Np - 1)
    fin = (qlen + tlen).long()

    def shift1(x, fill):  # y[:, i] = x[:, i - 1], y[:, 0] = fill
        return torch.cat([torch.full((B, 1), fill, **i32), x[:, :-1]], 1)

    H1 = sH = E1 = F1 = torch.full((B, Np), NEG_INF, **i32)
    SH1 = sSH = SE1 = SF1 = BV = BK = BS = torch.zeros((B, Np), **i32)
    valid_i = (iarr >= 1) & (iarr <= ql)
    i0 = iarr == 0
    score = torch.zeros(B, **i32)
    ptrs = []
    for k in range(K):
        j = k - iarr
        W = torch.where(j < 0, 0, tkc.gather(1, j.clamp(min=0).expand(B, -1)))
        s = tabf[qrow + W]
        sH1 = shift1(H1, NEG_INF)
        d = sH + s
        if affine:
            e_ext, e_opn = E1 + e, H1 + oe
            f_ext, f_opn = shift1(F1, NEG_INF) + e, sH1 + oe
            ext_e, ext_f = e_ext >= e_opn, f_ext >= f_opn
            En = torch.maximum(e_ext, e_opn)
            Fn = torch.maximum(f_ext, f_opn)
            best = torch.maximum(torch.maximum(d, Fn), En)
            ptr = torch.where(d == best, PTR_DIAG, torch.where(Fn == best, PTR_UP, PTR_LEFT))
        else:
            u, l = sH1 + e, H1 + e
            best = torch.maximum(torch.maximum(d, u), l)
            ptr = torch.where(d == best, PTR_DIAG, torch.where(u == best, PTR_UP, PTR_LEFT))
        Hn = best
        if local:
            stop = best <= 0
            Hn = torch.where(stop, 0, Hn).to(torch.int32)
            ptr = torch.where(stop, PTR_STOP, ptr)
        # boundaries: i == 0 is cell (0, k), i == k cell (k, 0)
        bmask = i0 | (iarr == k)
        if not affine:
            if local:
                Hn = torch.where(bmask, 0, Hn).to(torch.int32)
                ptr = torch.where(bmask, PTR_STOP, ptr)
            else:
                Hn = torch.where(bmask, k * e, Hn).to(torch.int32)
                bptr = PTR_STOP if k == 0 else torch.where(i0, PTR_LEFT, PTR_UP)
                ptr = torch.where(bmask, bptr, ptr)
        else:
            if k == 0:  # the origin
                Hn = torch.where(i0, 0, Hn).to(torch.int32)
                ptr = torch.where(i0, PTR_STOP, ptr)
            if local:
                Hn = torch.where(bmask, 0, Hn).to(torch.int32)
                ptr = torch.where(bmask, PTR_STOP, ptr)
                # E of column 0 is -inf, as in the oracle (the module
                # docstring: the TPU kernel reads the j < 0 slots here)
                En = torch.where(iarr == k, NEG_INF, En).to(torch.int32)
        if track:
            sSH1 = shift1(SH1, 0)
            if affine:
                SEn = torch.where(ext_e, SE1, SH1)
                SFn = torch.where(ext_f, shift1(SF1, 0), sSH1)
                SHn = torch.where(ptr == PTR_DIAG, sSH,
                                  torch.where(ptr == PTR_UP, SFn, SEn))
                SE1, SF1 = SEn, SFn
            else:
                SHn = torch.where(ptr == PTR_DIAG, sSH,
                                  torch.where(ptr == PTR_UP, sSH1, SH1))
            SHn = torch.where(ptr == PTR_STOP, (iarr * stride + j).to(torch.int32), SHn)
            SH1, sSH = SHn, sSH1
        if band is not None:
            dkj = k - 2 * iarr
            oob = (dkj < dlo) | (dkj > dhi)
            Hn = torch.where(oob, NEG_INF, Hn).to(torch.int32)
            if affine:
                En = torch.where(oob, NEG_INF, En).to(torch.int32)
                Fn = torch.where(oob, NEG_INF, Fn).to(torch.int32)
        if local:
            upd = valid_i & (j >= 1) & (j <= tl) & (Hn > BV)
            BV = torch.where(upd, Hn, BV)
            BK = torch.where(upd, k, BK).to(torch.int32)
            if track:
                BS = torch.where(upd, SHn, BS)
        else:
            score = torch.where(fin == k, Hn[rows, qcol], score)
        if want_ptr:
            byte = ptr.long()
            if affine:
                byte = byte | (ext_e.long() << _EXT_E_BIT) | (ext_f.long() << _EXT_F_BIT)
            ptrs.append(byte.to(torch.uint8))
        H1, sH = Hn, sH1
        if affine:
            E1, F1 = En, Fn
    out = {"bv": BV, "bk": BK} if local else {"score": score}
    if track:
        out["bs"] = BS
    if want_ptr:
        out["ptr"] = torch.stack(ptrs)
    return out


def wavefront_far_bytes_ref(qpad, tk, tab, *, K: int, gap_open: int, gap_extend: int,
                            mode: str = "global", affine: bool = True):
    """Plain PyTorch version of the pointer bytes of the slots whose
    inputs are all -inf (k - 2i outside [dlo - 1, dhi + 1] of a band):
    (K, B, Np) uint8, the TPU kernel's byte from -inf neighbours, by mode
    (s the cell's letter score, ext = ``_EXT_BITS`` if affine and
    e >= o + e, else 0):

    * global affine: ``(s >= max(e, o + e) ? DIAG : UP) | ext``;
    * global linear: ``s >= e ? DIAG : UP``, but row 0 (i = 0) LEFT and
      column 0 (i = k) UP, the boundary pointers;
    * local: ``STOP | ext`` (the best is <= 0);

    and the origin's byte is ``STOP | ext``.  ``wavefront_fill``'s kernel
    writes these for every slot of a banded fill, then the band's window
    over them."""
    dev = qpad.device
    B, Np = qpad.shape
    NT = tab.shape[0]
    e, oe = gap_extend, gap_open + gap_extend
    ext = _EXT_BITS if affine and e >= oe else 0
    if mode == "local":
        byte = torch.full((B, K, Np), PTR_STOP | ext, dtype=torch.long, device=dev)
    else:
        qrow = qpad.clamp(0, NT - 1).long() * NT
        tkc = tk.clamp(0, NT - 1).long()
        j = torch.arange(K, device=dev)[:, None] - torch.arange(Np, device=dev)[None, :]
        W = torch.where(j[None] < 0, 0, tkc[:, j.clamp(min=0)])  # (B, K, Np)
        s = tab.flatten().long()[qrow[:, None, :] + W]
        byte = torch.where(s >= (max(e, oe) if affine else e), PTR_DIAG, PTR_UP) | ext
        if not affine:
            byte[:, :, 0] = PTR_LEFT
            kk = torch.arange(min(K, Np), device=dev)
            byte[:, kk, kk] = PTR_UP
    byte[:, 0, 0] = PTR_STOP | ext
    return byte.permute(1, 0, 2).to(torch.uint8).contiguous()


def wavefront_fill(qpad, tk, qlen, tlen, tab, *, K: int, band: int | None, gap_open: int,
                   gap_extend: int, want_ptr: bool, mode: str = "global",
                   affine: bool = True, stride: int | None = None,
                   span: int | None = None):
    """Fill diagonals [0, K) of every pair; see the module docstring.  A
    CPU tensor runs ``wavefront_fill_ref``; a CUDA tensor the kernel.
    ``stride``: the start cells' packing (local score-only).  ``span``: at
    least the largest |tlen - qlen| of the batch (None: read from the
    device when there is a band; with none it bounds the strip kernel's
    target columns, ``strip_columns``)."""
    qpad, tk, tab = qpad.contiguous(), tk.contiguous(), tab.contiguous()
    qlen, tlen = qlen.to(torch.int32).contiguous(), tlen.to(torch.int32).contiguous()
    _check(qpad, tk, qlen, tlen, tab, K, mode, want_ptr, stride)
    kw = dict(K=K, band=band, gap_open=gap_open, gap_extend=gap_extend,
              want_ptr=want_ptr, mode=mode, affine=affine, stride=stride)
    if qpad.device.type == "cpu":
        return wavefront_fill_ref(qpad, tk, qlen, tlen, tab, **kw)
    if qpad.device.type != "cuda":
        raise ValueError(f"wavefront_fill: unsupported device {qpad.device}")
    from .._build import launch

    dev = qpad.device
    B, Np = qpad.shape
    NT = tab.shape[0]
    local = mode == "local"
    track = local and not want_ptr
    zeros = lambda: torch.zeros((B, Np), dtype=torch.int32, device=dev)  # noqa: E731
    out = ({"bv": zeros(), "bk": zeros()} if local
           else {"score": torch.zeros(B, dtype=torch.int32, device=dev)})
    if track:
        out["bs"] = zeros()
    ptr = rows = None
    if want_ptr:
        ptr = out["ptr"] = torch.empty((K, B, Np), dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    R = warps = cols = smem = 0
    letters = False
    kernel = fill_kernel(band, want_ptr, mode)
    if kernel == "strip":
        cols = strip_columns(K, Np, span)
        warps, smem, letters, row_in_smem = wavefront_strip_geometry(Np, NT, cols, mode, affine)
        if not row_in_smem:  # the wrap row, a column of 16 or 8 bytes
            rows = torch.empty((B, cols, 4 if local and affine else 2), dtype=torch.int32,
                               device=dev)
    elif kernel == "strip_ptr":
        warps, smem, letters, rows_in_smem = wavefront_strip_ptr_geometry(Np, NT, K, affine)
        if not rows_in_smem:  # the two wrap rows, an entry of 8 or 4 bytes
            rows = torch.empty((B, 2, K + 1, 2 if affine else 1), dtype=torch.int32,
                               device=dev)
    else:
        if band is not None and span is None:  # the ring follows the widest window
            span = int((tlen.long() - qlen.long()).abs().max())
        nrows = window_rows(mode, affine, want_ptr)
        R, rows_in_smem = window_ring(window_width(span, band, Np), NT, nrows)
        if not rows_in_smem:
            rows = torch.empty((B, nrows, R), dtype=torch.int32, device=dev)
    ptr_of = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    launch(
        "wavefront_fill", dev, "seqalib_wavefront_fill", qpad.data_ptr(), Np,
        tk.data_ptr(), tk.shape[1], qlen.data_ptr(), tlen.data_ptr(), tab.data_ptr(),
        NT, B, K, 0 if band is None else band, gap_open, gap_extend, int(local),
        int(affine), int(band is not None), stride or 0, ptr_of(out.get("score")),
        ptr_of(out.get("bv")), ptr_of(out.get("bk")), ptr_of(out.get("bs")), ptr_of(ptr),
        R, ptr_of(rows), warps, cols, int(letters), smem,
    )
    # one count per call: a banded call with pointers launches the far
    # pass, then the window kernel
    launches[launch_key(mode, affine, want_ptr)] += 1
    return out


def _geometry(q, t):
    """(B, n, m, Np, K) of a padded bucket: Np = n + 1 rounded up to 128,
    K = n + m + 1 (the JAX ``_fill``)."""
    B, n = q.shape
    m = t.shape[1]
    return B, n, m, ceil_to(n + 1, LANES), n + m + 1


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


def wavefront_launch(q, t, qlen, tlen, sp: ScoringParams, *, band: int | None,
                     want_tb: bool, device, affine: bool = True):
    """The launch half of ``wavefront_bucket`` (same arguments): the
    letters' one copy (``stage_wavefront``), the fill, with ``want_tb`` the
    walk (``wavefront_walk``), and the copy of the small results (score,
    and with ``want_tb`` the CIGAR lengths and the walkers' final state) to
    the host behind an event, all enqueued with no device-to-host sync on a
    CUDA device: the ring's span comes from the host lengths.  The pointer
    stream is dropped once the walk is queued; only the text rows wait for
    the finalize.  A batch whose stream (K x B x Np bytes) exceeds
    ``ptr_cap_bytes()`` is launched in parts under that budget, one after
    another on the stream.  Returns the finalize callable, which waits for
    those copies only, decodes the CIGARs from the text rows' used tail
    (``cigars_from_text``, which raises for a start cell outside the
    stream) and returns ``wavefront_bucket``'s dict.  On the CPU everything
    runs here and the callable only returns the result."""
    q, t = np.asarray(q), np.asarray(t)
    qlen = np.asarray(qlen).astype(np.int64)
    tlen = np.asarray(tlen).astype(np.int64)
    B, _, _, Np, K = _geometry(q, t)
    step = max(1, ptr_cap_bytes() // (K * Np)) if want_tb else max(B, 1)
    device = torch.device(device)
    parts = [_launch_part(q[lo: lo + step], t[lo: lo + step], qlen[lo: lo + step],
                          tlen[lo: lo + step], sp, band=band, want_tb=want_tb,
                          device=device, affine=affine)
             for lo in range(0, max(B, 1), step)]

    def finish():
        outs = [f() for f in parts]
        if len(outs) == 1:
            return outs[0]
        return {k: (sum((o[k] for o in outs), []) if k == "cigars"
                    else np.concatenate([o[k] for o in outs])) for k in outs[0]}

    if device.type == "cpu":
        out = finish()
        return lambda: out
    return finish


def _launch_part(q, t, qlen, tlen, sp: ScoringParams, *, band: int | None, want_tb: bool,
                 device, affine: bool):
    """``wavefront_launch`` of one part of a batch."""
    B = len(qlen)
    qpad, tk, ql, tl, tab = stage_wavefront(q, t, qlen, tlen, sp, device)
    span = int(np.abs(tlen - qlen).max(initial=0))
    res = wavefront_fill(qpad, tk, ql, tl, tab, K=tk.shape[1], band=band,
                         gap_open=sp.gap_open, gap_extend=sp.gap_extend, want_ptr=want_tb,
                         affine=affine, span=span)
    copy = {"score": res.pop("score")}
    text = None
    if want_tb:
        text, copy["nchar"], copy["state"] = wavefront_walk(res.pop("ptr"), ql, tl,
                                                            affine=affine)
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
