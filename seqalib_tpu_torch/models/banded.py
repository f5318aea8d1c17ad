"""Banded long-read driver: fill with checkpoints, then checkpointed
traceback (counterpart of ``seqalib_tpu/models/banded.py``).

Config 4 of BASELINE.json: banded affine NW on 10-100 kb pairs.

1. **Fill**: ``band_fill`` in ``"fill"`` mode over all ``K = n + m + 1``
   anti-diagonals with O(band) state, keeping the state entering every
   ``CK``-th diagonal (the checkpoints, on the device).
2. **Traceback**: from the last super-block (up to 64 chunks of ``CK``
   diagonals, at most 192 MB of pointer nibbles) down to the first, each
   super-block is recomputed from its checkpoint in ``"ptr"`` mode and
   walked by ``band_walk``; the walker state stays on the device from one
   super-block to the next.  After the last, on a card, ``band_cigar``
   writes the CIGAR text of the joined op blocks there and only the text
   comes back; on the CPU the op blocks come back and
   ``op_rows_to_cigars`` encodes them.

A batch may mix length deltas: each pair keeps its own band bounds
(``dlo_p``/``dhi_p``), and the slot geometry (``dlo``, ``dhi``, ``Wp``)
covers them all.  ``align_batch`` joins the ``delta // band`` groups (the
JAX package's grouping) into one call while their bands fit the widest
group's slot window and their pairs the card's SMs
(``parallel.dispatch.banded_batches``): a call a group would run the
groups' fills and recomputes one after another, each on as few SMs as its
group has pairs.  Not carried over from the JAX package's TPU host code,
because they change no value: the clamp/dyn/steady phase split, NSUB,
letter streaming, the batch padding to a multiple of 8 and the VMEM batch
chunking.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops.band_cigar import band_cigar
from ..ops.band_fill import band_fill, band_table
from ..ops.band_walk import band_walk
from ..scoring import NIBBLE_BIAS, fits_nibbles
from ..telemetry import count_band, count_d2h, span
from ..types import NEG_INF, AlignResult, ScoringParams
from ..utils import ceil_to
from ..utils.cigar import cigars_from_text, op_rows_to_cigars

LANES = 128  # slot quantum of the band window (the TPU kernel's lane width)
SB_BYTES = 192 * 1024**2  # pointer bytes of one recomputed super-block
SB_CHUNKS = 64  # at most this many CK-chunks per super-block


def banded_matrix_supported(table) -> bool:
    """True when a substitution table fits the range the JAX banded kernel
    takes ([-4, 11], at most 30 letters).  The port looks scores up in a
    table and has no such limit, but routes exactly as the JAX package."""
    return fits_nibbles(table) and np.asarray(table).shape[0] + 1 <= 31


def slot_width(dlo: int, dhi: int) -> int:
    """``Wp``: the slots of a state row whose bands cover diagonals
    ``dlo .. dhi``."""
    return ceil_to((dhi - dlo + 1) // 2 + 2, LANES)


def checkpoint_bytes(B: int, Wp: int, K: int, CK: int = 256) -> int:
    """Bytes of a traceback batch's checkpoints, ``(Kp / CK, 4, B, Wp)``
    int32 over ``K`` diagonals (the default ``CK`` with traceback)."""
    return ceil_to(K, CK) // CK * 4 * B * Wp * 4


def _geometry(dlo: int, dhi: int, n: int, m: int):
    return slot_width(dlo, dhi), n + m + 1


def _pad_letters(seqs: np.ndarray, width: int, sentinel: int, lens: np.ndarray):
    """(B, width) i32: out[:, x] = seq[x-1] for 1 <= x <= len else sentinel."""
    B = seqs.shape[0]
    out = np.full((B, width), sentinel, np.int32)
    L = min(seqs.shape[1], width - 1)
    out[:, 1 : 1 + L] = seqs[:, :L]
    xs = np.arange(width)[None, :]
    return np.where((xs >= 1) & (xs <= lens[:, None]), out, sentinel).astype(np.int32)


def super_block_chunks(CK: int, B: int, Wp: int) -> int:
    """CK-chunks per recomputed super-block: as many as fit ``SB_BYTES``
    of packed pointers, at most ``SB_CHUNKS``."""
    return max(1, min(SB_CHUNKS, SB_BYTES // max(1, CK * B * Wp // 2)))


def banded_align_batch(
    qs: np.ndarray,
    ts: np.ndarray,
    qlen: np.ndarray,
    tlen: np.ndarray,
    sp: ScoringParams,
    band: int,
    traceback: bool = True,
    CK: Optional[int] = None,
    device=None,
) -> List[AlignResult]:
    """Banded affine-gap global alignment of one bucket.

    ``qs``/``ts``: (B, L*) letter codes with lengths ``qlen``/``tlen``.
    Scoring: match/mismatch, or a substitution matrix that
    ``banded_matrix_supported`` accepts (others raise
    ``NotImplementedError``).  ``CK``: checkpoint spacing in diagonals,
    rounded up to a multiple of 4; 256 with traceback and 512 without.
    ``device``: a ``torch.device`` (default ``cuda``)."""
    table = sp.substitution_matrix()
    if sp.matrix is not None and not banded_matrix_supported(table):
        raise NotImplementedError(
            "banded matrix scoring takes tables in [-4, 11] with at most 30 "
            "letters, as the JAX package's banded kernel; align_batch(band=) "
            "sends wider tables to the full-matrix wavefront (kernel 7, "
            "ops/wavefront.py)"
        )
    dev = torch.device("cuda" if device is None else device)
    qs = np.asarray(qs, np.int32)
    ts = np.asarray(ts, np.int32)
    qlen = np.asarray(qlen, np.int64)
    tlen = np.asarray(tlen, np.int64)
    B = qs.shape[0]
    if B == 0:
        return []
    with span("seqalib.banded.stage"):
        deltas = tlen - qlen
        # each pair's band bounds (the oracle's); the bucket's slot geometry
        # covers them all
        dlo_p = np.minimum(0, deltas) - band
        dhi_p = np.maximum(0, deltas) + band
        dlo = int(dlo_p.min())
        dhi = int(dhi_p.max())
        n = int(qlen.max())
        m = int(tlen.max())
        Wp, K = _geometry(dlo, dhi, n, m)
        if CK is None:
            CK = 256 if traceback else 512
        CK = ceil_to(CK, 4)
        Kp = ceil_to(K, CK)

        A = table.shape[0]  # letters A and A + 1 are the query/target sentinels
        # out-of-band cells are masked, so the sentinel score never reaches a
        # result; it is the JAX kernel's (-4 on its profile route, mismatch on
        # its scalar route) so that every pointer byte is the same as there
        sent = -NIBBLE_BIAS if sp.matrix is not None else sp.mismatch

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)

        qk = put(_pad_letters(qs, n + 1, A, qlen))
        tk = put(_pad_letters(ts, m + 1, A + 1, tlen))
        tab = put(band_table(table, sent))
        vecs = [put(v) for v in (qlen, tlen, dlo_p, dhi_p)]
        state0 = torch.full((4, B, Wp), NEG_INF, dtype=torch.int32, device=dev)
        score0 = torch.full((B, Wp), NEG_INF, dtype=torch.int32, device=dev)
        kw = dict(K=K, dlo=dlo, dhi=dhi, gap_open=sp.gap_open, gap_extend=sp.gap_extend)

    with span("seqalib.banded.fill"):
        fill = band_fill(qk, tk, *vecs, state0, score0, tab, k0=0, k1=Kp, mode="fill",
                         CK=CK if traceback else 0, **kw)
        count_band(qk, batches=1, slots=B * Wp * Kp)
        scores = fill["score"].max(dim=1).values  # fetched once the walk is queued
        if not traceback:
            count_d2h(scores)
            return [AlignResult(int(s), 0, int(qlen[b]), 0, int(tlen[b]), "")
                    for b, s in enumerate(scores.tolist())]

    ckpts = fill["ckpt"]  # (Kp / CK, 4, B, Wp): the state entering each chunk
    SB = super_block_chunks(CK, B, Wp)
    NC = Kp // CK
    iv, jv = vecs[0].clone(), vecs[1].clone()
    stv = torch.zeros(B, dtype=torch.int32, device=dev)
    dnv = torch.zeros(B, dtype=torch.int32, device=dev)
    blocks = []
    ci = int((qlen + tlen).max()) // CK
    while ci >= 0:
        cg = (ci // SB) * SB  # the super-block's first chunk
        k0, k1 = cg * CK, min(cg + SB, NC) * CK
        with span("seqalib.banded.block"):
            ptr = band_fill(qk, tk, *vecs, ckpts[cg], score0, tab, k0=k0, k1=k1,
                            mode="ptr", **kw)["ptr"]
            count_band(qk, slots=B * Wp * (k1 - k0))
            ops, iv, jv, stv, dnv = band_walk(ptr, iv, jv, stv, dnv, k0=k0, dhi=dhi)
        blocks.append(ops)  # column x <-> diagonal k0 + x
        ci = cg - 1
    on_card = dev.type == "cuda"
    with span("seqalib.banded.ops_copy"):
        if on_card:
            # a block's columns run by ascending diagonal: joined from the
            # lowest block up, every pair's ops stand in alignment order
            text, nchar_d = band_cigar(torch.cat(blocks[::-1], dim=1))
            nchar = nchar_d.cpu()  # the wait for every queued launch
            count_d2h(nchar_d)
        else:
            # blocks were walked from high k to low: flipping each and joining
            # them gives every pair's ops in walk (end -> start) order
            ops_t = torch.cat([blk.flip(1) for blk in blocks], dim=1)
            ops_mat = ops_t.cpu().numpy()
    with span("seqalib.banded.cigar"):
        cigars = (cigars_from_text(text, nchar) if on_card
                  else op_rows_to_cigars(ops_mat[:, ::-1]))
        count_d2h(scores)
        return [AlignResult(int(s), 0, int(qlen[b]), 0, int(tlen[b]), cigars[b])
                for b, s in enumerate(scores.tolist())]
