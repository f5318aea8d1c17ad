"""Per-row dynamic window (counterpart of ``strip_pallas._row_window``).

``row_window(src, starts, hi, L=, lo=, fill=)[n, x] = src[n, starts[n] + x]``
where ``lo <= x < hi[n]``, else ``fill``.  The strip engine uses it to cut
the pass-2 reversed prefixes and the pass-3 alignment windows out of the
padded letter arrays.  Kernel: ``csrc/row_window.cu``.
"""

from __future__ import annotations

import torch

from . import launches


def _check(src, starts, hi, L, lo):
    if src.dtype != torch.int32 or src.dim() != 2:
        raise ValueError("src must be a 2-D int32 tensor")
    N, W = src.shape
    for name, v in (("starts", starts), ("hi", hi)):
        if v.dtype != torch.int32 or v.shape != (N,) or v.device != src.device:
            raise ValueError(f"{name} must be ({N},) int32 on {src.device}")
    # the rows' used ranges [starts + lo, starts + min(hi, L)) must lie in src
    top = starts + torch.clamp(hi, max=L)
    used = top > starts + lo
    bad = used & ((starts + lo < 0) | (top > W))
    if bool(bad.any()):
        n = int(bad.nonzero()[0, 0])
        raise ValueError(
            f"row_window: row {n} reads [{int(starts[n]) + lo}, {int(top[n])}) "
            f"outside a source of width {W}"
        )


def row_window_ref(src, starts, hi, *, L: int, lo: int, fill: int):
    """Plain PyTorch version of the kernel."""
    N, W = src.shape
    x = torch.arange(L, device=src.device, dtype=torch.int64)[None, :]
    idx = starts.long()[:, None] + x
    keep = (x >= lo) & (x < hi.long()[:, None]) & (idx >= 0) & (idx < W)
    vals = torch.gather(src, 1, idx.clamp(0, max(W - 1, 0)))
    return torch.where(keep, vals, torch.full_like(vals, fill))


def row_window(src, starts, hi, *, L: int, lo: int, fill: int):
    """(N, L) int32 window of ``src`` (N, W); see the module docstring.
    A CPU tensor runs ``row_window_ref``; a CUDA tensor the kernel."""
    src = src.contiguous()
    starts = starts.to(torch.int32).contiguous()
    hi = hi.to(torch.int32).contiguous()
    _check(src, starts, hi, L, lo)
    if src.device.type == "cpu":
        return row_window_ref(src, starts, hi, L=L, lo=lo, fill=fill)
    if src.device.type != "cuda":
        raise ValueError(f"row_window: unsupported device {src.device}")
    from .._build import check, lib

    N, W = src.shape
    out = torch.empty((N, L), dtype=torch.int32, device=src.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = lib().seqalib_row_window(
        src.data_ptr(), N, W, starts.data_ptr(), hi.data_ptr(),
        out.data_ptr(), L, lo, fill, stream,
    )
    check("row_window", rc)
    launches["row_window"] += 1
    return out
