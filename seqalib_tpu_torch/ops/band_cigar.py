"""CIGAR text of the banded walk's op rows, written on the card: a kernel of
the port alone, in place of a host step of ``models/banded.py`` (the op
matrix copied to the host and run-length encoded there by
``utils.cigar.op_rows_to_cigars``).

``band_cigar(ops)`` takes ``ops`` (B, KW) uint8, row b pair b's ops
(``utils.cigar.OP_M/I/D``) in alignment (start -> end) order, with
``OP_PAD`` anywhere (skipped): the ``band_walk`` blocks of a traceback
joined from the lowest diagonal up.  Returns ``(text, nchar)``, the CIGAR
text of ``utils.cigar`` in rows of ``text_width(KW)`` bytes (``nchar`` 0
for a row of pads alone).

A CPU tensor runs ``band_cigar_ref``; a CUDA tensor launches the kernel
(``csrc/band_cigar.cu``: a CTA a row, scanning it from its end and writing
the text from the back) and nothing else: no sync and no copy.
"""

from __future__ import annotations

import torch

from ..utils.cigar import op_rows_to_cigars, pack_text
from . import launches


def text_width(KW: int) -> int:
    """Bytes of a text row: a row holds at most KW ops, and a run of n ops
    takes at most 2n bytes."""
    return 2 * KW


def _check(ops):
    if ops.dtype != torch.uint8 or ops.dim() != 2:
        raise ValueError("band_cigar: ops must be a (B, KW) uint8 tensor")


def band_cigar_ref(ops):
    """Plain version: ``op_rows_to_cigars`` of the rows, packed at the ends
    of the text rows."""
    text, nchar = pack_text(op_rows_to_cigars(ops.cpu().numpy()), text_width(ops.shape[1]))
    return torch.from_numpy(text).to(ops.device), torch.from_numpy(nchar).to(ops.device)


def band_cigar(ops):
    """The CIGAR text of every row; see the module docstring.  A CPU tensor
    runs ``band_cigar_ref``; a CUDA tensor the kernel, counted under
    ``band_cigar``."""
    _check(ops)
    ops = ops.contiguous()
    if ops.device.type == "cpu":
        return band_cigar_ref(ops)
    if ops.device.type != "cuda":
        raise ValueError(f"band_cigar: unsupported device {ops.device}")
    from .._build import launch

    B, KW = ops.shape
    L = text_width(KW)
    text = torch.empty((B, L), dtype=torch.uint8, device=ops.device)
    nchar = torch.empty((B,), dtype=torch.int32, device=ops.device)
    if B == 0:
        return text, nchar
    launch("band_cigar", ops.device, "seqalib_band_cigar", ops.data_ptr(), B, KW,
           text.data_ptr(), L, nchar.data_ptr())
    launches["band_cigar"] += 1
    return text, nchar
