"""Per-row dynamic window (counterpart of ``strip_pallas._row_window``).

``row_window(src, starts, hi, L=, lo=, fill=)[n, x] = src[n, starts[n] + x]``
where ``lo <= x < hi[n]``, else ``fill``; with ``reverse=True`` the window
is cut from ``torch.flip(src, [1])`` without making that copy.  The strip
engine uses it to cut the pass-2 reversed prefixes and the pass-3
alignment windows out of the padded letter arrays.  Kernel:
``csrc/row_window.cu``.

A row whose used range ``[starts + lo, starts + min(hi, L))`` leaves
``[0, W)`` is refused with a ``ValueError``.  A call without ``err``
checks at once (on a CUDA tensor that is a device-to-host sync).  A call
on a CUDA tensor with ``err`` (a one-word int32 tensor from
``error_words``) only launches the kernel, which records the first bad
row in the word with ``atomicMin``; the caller reads the word later and
raises with ``raise_on_error``.  A CPU tensor always checks at once.
"""

from __future__ import annotations

import torch

from .. import _build
from . import launches

NO_ERROR = 2**31 - 1  # an error word that recorded no bad row


def error_words(n: int, device) -> torch.Tensor:
    """``n`` deferred-check words, one per ``row_window`` call site."""
    return torch.full((n,), NO_ERROR, dtype=torch.int32, device=device)


def raise_on_error(words, widths) -> None:
    """Raise for the first word that recorded a bad row; ``widths`` are the
    sources' widths, one per word (host values)."""
    for n, W in zip((int(w) for w in words), widths):
        if n != NO_ERROR:
            raise ValueError(f"row_window: row {n} reads outside a source of width {W}")


def _check_args(src, starts, hi):
    if src.dtype is not torch.int32 or src.dim() != 2:
        raise ValueError("src must be a 2-D int32 tensor")
    N = src.shape[0]
    dev = src.device
    for name, v in (("starts", starts), ("hi", hi)):
        if v.dtype is not torch.int32 or v.shape != (N,) or v.device != dev:
            raise ValueError(f"{name} must be ({N},) int32 on {dev}")


def _int32(v):
    return (v if v.dtype is torch.int32 else v.to(torch.int32)).contiguous()


def _check_range(src, starts, hi, L, lo):
    """The rows' used ranges [starts + lo, starts + min(hi, L)) must lie in
    src; a device-to-host sync on a CUDA tensor."""
    W = src.shape[1]
    top = starts + torch.clamp(hi, max=L)
    used = top > starts + lo
    bad = used & ((starts + lo < 0) | (top > W))
    if bool(bad.any()):
        n = int(bad.nonzero()[0, 0])
        raise ValueError(
            f"row_window: row {n} reads [{int(starts[n]) + lo}, {int(top[n])}) "
            f"outside a source of width {W}"
        )


def row_window_ref(src, starts, hi, *, L: int, lo: int, fill: int,
                   reverse: bool = False):
    """Plain PyTorch version of the kernel."""
    if reverse:
        src = torch.flip(src, [1])
    N, W = src.shape
    x = torch.arange(L, device=src.device, dtype=torch.int64)[None, :]
    idx = starts.long()[:, None] + x
    keep = (x >= lo) & (x < hi.long()[:, None]) & (idx >= 0) & (idx < W)
    vals = torch.gather(src, 1, idx.clamp(0, max(W - 1, 0)))
    return torch.where(keep, vals, torch.full_like(vals, fill))


def row_window(src, starts, hi, *, L: int, lo: int, fill: int, reverse: bool = False,
               err=None):
    """(N, L) int32 window of ``src`` (N, W); see the module docstring.
    A CPU tensor runs ``row_window_ref``; a CUDA tensor the kernel."""
    # the call is bound by its host time: the deferred path checks the
    # common case (int32, contiguous, one device) in one expression and
    # leaves everything else to the general path below
    if (err is not None and src.is_cuda and src.dtype is torch.int32
            and starts.dtype is torch.int32 and hi.dtype is torch.int32
            and err.dtype is torch.int32 and src.dim() == 2 and starts.dim() == 1
            and hi.dim() == 1 and err.numel() == 1 and src.is_contiguous()
            and starts.is_contiguous() and hi.is_contiguous()
            and starts.shape[0] == hi.shape[0] == src.shape[0]
            and starts.device == hi.device == err.device == src.device):
        return _launch(src, starts, hi, L, lo, fill, reverse, err)
    src, starts, hi = src.contiguous(), _int32(starts), _int32(hi)
    _check_args(src, starts, hi)
    if not src.is_cuda:
        if src.device.type != "cpu":
            raise ValueError(f"row_window: unsupported device {src.device}")
        _check_range(src, starts, hi, L, lo)
        return row_window_ref(src, starts, hi, L=L, lo=lo, fill=fill, reverse=reverse)
    if err is None:
        _check_range(src, starts, hi, L, lo)
    elif err.dtype is not torch.int32 or err.numel() != 1 or err.device != src.device:
        raise ValueError(f"row_window: err must be one int32 word on {src.device}")
    return _launch(src, starts, hi, L, lo, fill, reverse, err)


def _launch(src, starts, hi, L, lo, fill, reverse, err):
    N, W = src.shape
    out = torch.empty(N, L, dtype=torch.int32, device=src.device)
    if N == 0:
        return out
    _build.launch(
        "row_window", src.device, "seqalib_row_window",
        src.data_ptr(), N, W, starts.data_ptr(), hi.data_ptr(), out.data_ptr(), L, lo,
        fill, reverse, None if err is None else err.data_ptr(),
    )
    launches["row_window"] += 1
    return out
