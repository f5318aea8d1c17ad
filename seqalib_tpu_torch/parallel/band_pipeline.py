"""Sequence-parallel pipelined wavefront for ONE long pair over a device
list (counterpart of ``seqalib_tpu/parallel/band_pipeline.py``).

The query's rows are split into ``D`` contiguous row-blocks of R rows, one
per entry of the mesh; the target's columns into tiles of C columns.  Block
``d`` computes tile ``tt`` at pipeline step ``s = tt + d``.  A tile's only
dependency on another block is its top boundary (H and F of the row
above, for its columns), produced by block ``d - 1`` one step earlier;
its left boundary (H and E of one column) is the block's own, carried
from its previous tile.  The mesh is an ordered tuple of ``torch.device``
entries (``make_band_mesh``); a mesh may name one device several times.

* Where every entry names one device, the fill runs block by block: one
  ``ops.sp_tile_run`` launch computes a block's whole row of tiles (the
  kernel pipelines its row strips across the card's SMs), and its bottom
  row is the next block's top.  At a mesh of one entry a fill is one
  launch.
* Across distinct devices, one process walks the pipeline steps, launches
  every active block's tile (a run of one) on that block's device, then
  moves each block's outgoing packet ``[corner, bottom H, bottom F]`` to
  the next block's device: the single-controller counterpart of the JAX
  ``shard_map`` + ``ppermute``.

Geometry: R = ceil(n / D) for every tile body (the JAX XLA body's rule;
the JAX Pallas body rounds R up to its 128-row strips, which changes no
score or CIGAR).  The query is padded with letter 0, the target with
``pad_letter`` (4 for match/mismatch scoring, 0 for a matrix), and padded
rows and columns never feed cell (n, m).

``nw_affine_align_sp`` keeps one record a block of the boundaries its
tiles were computed from, and walks back from (n, m).  Entering a tile it
has no pointers for, it recomputes in one launch (``ops.sp_tile_ptr``), from
slices of the record, that tile and the tiles to its left in the same
block, as many as ``PTR_BATCH_BYTES`` allows, on the rows above the entry
cell only (the walk never goes down), and walks that batch on its block's
device (``ops.sp_walk``) until the path leaves it: only the ops walked and
the walk's end (cell and state) come back to the host, which starts the
next batch from there.  The walk never returns to a tile it has left;
tiles it skips by going up a block are dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from ..devices import Mesh, device_mesh, one_device
from ..ops.sp_tile import NEG, sp_tile_ptr, sp_tile_run
from ..ops.sp_walk import read_walk, sp_walk
from ..telemetry import count_d2h, span
from ..types import AlignResult
from ..utils import ceil_to
from ..utils.cigar import OP_D, OP_I, ST_H, ops_to_cigar, rescore_global_affine

# pointer bytes (tiles x rows x C) one recompute launch of the walk may make
PTR_BATCH_BYTES = 64 * 1024**2


def make_band_mesh(devices=None) -> Mesh:
    """The mesh: the given devices in order, or every visible CUDA device
    (raises when there is none)."""
    return device_mesh(devices, "make_band_mesh")


def _sp_fill(q, t, sp, mesh: Mesh, C, sp_sub, want_tb, local=False):
    """The pipeline fill.  Returns (score, geom), with ``want_tb`` also
    block d's record ``bounds[d]`` on its device: its T tiles' top rows,
    H (T, C + 1, the left corner first) and F (T, C), and left columns, H
    and E (T, R).  ``sp_sub`` sets the kernel's strip height to
    ``sp_sub * 128`` rows."""
    with span("seqalib.sp.stage"):
        q = np.asarray(q)
        t = np.asarray(t)
        n, m = len(q), len(t)
        D = len(mesh)
        R = max(1, ceil_to(n, D) // D)
        n_tiles = max(1, ceil_to(m, C) // C)
        pad_letter = 0 if sp.matrix is not None else 4
        q_pad = np.zeros(D * R, np.int32)
        q_pad[:n] = q
        t_pad = np.full(n_tiles * C + 1, pad_letter, np.int32)
        t_pad[1: 1 + m] = t  # t_pad[x] = t[x - 1]: 1-based columns
        o, e = sp.gap_open, sp.gap_extend
        tbl = sp.substitution_matrix() if sp.matrix is not None else None
        strip = sp_sub * 128 if sp_sub else 0
        kw = dict(n=n, m=m, C=C, match=sp.match, mismatch=sp.mismatch, gap_open=o,
                  gap_extend=e, mode="local" if local else "global", strip=strip)

        def put(x, dev):
            return torch.as_tensor(np.asarray(x, np.int32)).to(dev)

        qbs = [put(q_pad[d * R: (d + 1) * R], dev) for d, dev in enumerate(mesh)]
        tks = [put(t_pad, dev) for dev in mesh]
        tabs = [put(tbl, dev) if tbl is not None else None for dev in mesh]
        rows = np.arange(1, R + 1)
        hcols = [put(np.zeros(R) if local else o + (d * R + rows) * e, dev)
                 for d, dev in enumerate(mesh)]
        ecols = [torch.full((R,), NEG, dtype=torch.int32, device=dev) for dev in mesh]
        caps = [torch.full((1,), NEG, dtype=torch.int32, device=dev) for dev in mesh]

        def init_top(j0, W, dev):
            # DP row 0 at columns j0 .. j0 + W: global H(0, j) = o + j*e (H(0, 0)
            # = 0), local 0; F = -inf; built on the device, so that the host
            # never waits for the queue
            jc = torch.arange(j0, j0 + W + 1, dtype=torch.int32, device=dev)
            h = torch.zeros_like(jc) if local else torch.where(jc == 0, 0, o + jc * e)
            return h, torch.full((W,), NEG, dtype=torch.int32, device=dev)

        one = one_device(mesh)
        if one:  # block by block: the first block's top row
            pkt = init_top(0, n_tiles * C, mesh[0])

    bounds = []
    if one:  # block by block, each block's tiles in one run
        for d in range(D):
            h_top, f_top = pkt
            with span("seqalib.sp.fill"):
                out = sp_tile_run(qbs[d], tks[d], h_top, f_top, hcols[d], ecols[d],
                                  caps[d], tabs[d], i0=d * R, j0=0, want_cols=want_tb, **kw)
                # the next block's top: corner H(i0 + R, 0), then the bottom rows
                pkt = (torch.cat([hcols[d][R - 1:], out["hbot"]]), out["fbot"])
                caps[d] = out["cap"]
            if want_tb:
                # a tile's left column is the right column of the tile before
                with span("seqalib.sp.checkpoint"):
                    bounds.append((h_top.unfold(0, C + 1, C), f_top.view(n_tiles, C),
                                   torch.cat([hcols[d][None], out["hcols"][:-1]]),
                                   torch.cat([ecols[d][None], out["ecols"][:-1]])))
    else:
        if want_tb:
            bounds = [[torch.empty((n_tiles, w), dtype=torch.int32, device=dev)
                       for w in (C + 1, C, R, R)] for dev in mesh]
        with span("seqalib.sp.fill"):
            pkts = [None] * D  # the packet each block takes at this step
            for s in range(n_tiles + D - 1):
                nxt = [None] * D
                for d, dev in enumerate(mesh):
                    tt = s - d
                    if not 0 <= tt < n_tiles:  # pipeline fill / drain: no tile
                        continue
                    j0 = tt * C
                    h_top, f_top = init_top(j0, C, dev) if d == 0 else pkts[d]
                    if want_tb:
                        for x, v in zip(bounds[d], (h_top, f_top, hcols[d], ecols[d])):
                            x[tt] = v
                    out = sp_tile_run(qbs[d], tks[d][j0: j0 + C + 1], h_top, f_top, hcols[d],
                                      ecols[d], caps[d], tabs[d], i0=d * R, j0=j0, **kw)
                    if d + 1 < D:  # corner H(i0 + R, j0), then the bottom rows
                        nd = mesh[d + 1]
                        nxt[d + 1] = (torch.cat([hcols[d][R - 1:], out["hbot"]]).to(nd),
                                      out["fbot"].to(nd))
                    hcols[d], ecols[d], caps[d] = out["hcol"], out["ecol"], out["cap"]
                pkts = nxt
    with span("seqalib.sp.score_wait"):
        score = max(int(c) for c in caps)
        count_d2h(*caps)
    geom = dict(R=R, C=C, qb=qbs, tk=tks, tab=tabs, kw=kw)
    return (score, geom, bounds) if want_tb else (score, geom)


def nw_affine_score_sp(q, t, sp, mesh: Mesh, C: int = 128, sp_sub: int = None) -> int:
    """Global affine-gap SCORE of one long pair, computed by the tiles of
    every block of ``mesh``: the exact Gotoh score of ``oracle.nw_affine``.
    Scoring: match/mismatch or any substitution matrix."""
    n, m = len(np.asarray(q)), len(np.asarray(t))
    if n == 0 or m == 0:
        if n == 0 and m == 0:
            return 0
        return sp.gap_open + max(n, m) * sp.gap_extend
    score, _ = _sp_fill(q, t, sp, mesh, C, sp_sub, want_tb=False)
    return score


def sw_affine_score_sp(q, t, sp, mesh: Mesh, C: int = 128, sp_sub: int = None) -> int:
    """LOCAL (Smith-Waterman) affine-gap SCORE of one long pair over
    ``mesh``: the max over all cells, as ``oracle.sw_affine``."""
    n, m = len(np.asarray(q)), len(np.asarray(t))
    if n == 0 or m == 0:
        return 0
    score, _ = _sp_fill(q, t, sp, mesh, C, sp_sub, want_tb=False, local=True)
    return max(0, score)


def _ptr_tiles(geom, bounds, d, tt, i, j, state):
    """Block d's tiles tt, tt - 1, ... (as many as ``PTR_BATCH_BYTES`` takes)
    recomputed from their boundaries (slices of ``bounds[d]``) as pointer
    tiles in one launch on the block's device, on the rows down to i, and
    walked there from cell (i, j) in ``state`` until the path leaves them
    (``sp_walk``).  Returns ``read_walk`` of the walk: its end cell and
    state, and its ops.  (The JAX package caches a jitted function for the
    recompute; eager PyTorch needs no cache.)"""
    C, R = geom["C"], geom["R"]
    i0, rows = d * R, i - d * R
    K = max(1, min(tt + 1, PTR_BATCH_BYTES // (rows * C)))
    with span("seqalib.sp.ptr_batch"):
        with span("seqalib.sp.ptr_launch"):
            # tiles tt - K + 1 .. tt, reversed: tile g = 0 is tt
            tiles = slice(tt - K + 1, tt + 1)
            top_h, top_f, left_h, left_e = bounds[d]
            htop, ftop = top_h[tiles].flip(0), top_f[tiles].flip(0)
            hcol, ecol = left_h[tiles, :rows].flip(0), left_e[tiles, :rows].flip(0)
            dev = hcol.device
            cap = torch.full((1,), NEG, dtype=torch.int32, device=dev)
            kw = {k: v for k, v in geom["kw"].items() if k != "mode"}
            lo = (tt - K + 1) * C
            ptr = sp_tile_ptr(geom["qb"][d][:rows], geom["tk"][d][lo: (tt + 1) * C + 1], htop,
                              ftop, hcol, ecol, cap, geom["tab"][d], i0=i0, j0=tt * C,
                              **dict(kw, n=0, m=0))["ptr"]
            walk = sp_walk(ptr, i, j, state, i0=i0, j0=tt * C)
        with span("seqalib.sp.ptr_copy"):  # waits for the recompute and the walk
            end = torch.empty(walk.shape, dtype=walk.dtype, pin_memory=walk.is_cuda)
            end.copy_(walk)
            count_d2h(walk)
    return read_walk(end.numpy())


def nw_affine_align_sp(q, t, sp, mesh: Mesh, C: int = 128, sp_sub: int = None):
    """Global affine alignment of one long pair over ``mesh``: score and
    CIGAR.  The fill keeps every tile's boundaries; the walk, the oracle's
    H/E/F state machine, recomputes each tile it enters as a pointer tile,
    on the rows above where it entered, follows the pointers on the card
    through that batch of tiles, and hops tiles and blocks from the end the
    card returns.  The CIGAR is re-scored against the fill score before
    returning."""
    q = np.asarray(q)
    t = np.asarray(t)
    n, m = len(q), len(t)
    if n == 0 or m == 0:
        score = 0 if n == m else sp.gap_open + max(n, m) * sp.gap_extend
        return AlignResult(int(score), 0, n, 0, m,
                           (f"{m}D" if m else "") if n == 0 else f"{n}I")
    score, geom, bounds = _sp_fill(q, t, sp, mesh, C, sp_sub, want_tb=True)
    with span("seqalib.sp.walk"):
        ops = _sp_walk(geom, bounds, n, m)
    with span("seqalib.sp.rescore"):
        walked = rescore_global_affine(q, t, ops, sp)
        if walked != score:  # not an assert: must survive python -O
            raise RuntimeError(f"SP traceback rescore {walked} != fill score {score}")
        return AlignResult(int(score), 0, n, 0, m, ops_to_cigar(ops))


def _sp_walk(geom, bounds, n: int, m: int) -> list:
    """The CIGAR ops of the path from (n, m) back to (0, 0), in order: a
    pointer batch at a time until the path reaches row 0 or column 0, then
    the rest of that row or column."""
    R, C = geom["R"], geom["C"]
    ops: list = []
    i, j, state = n, m, ST_H
    while i > 0 and j > 0:
        i, j, state, walked = _ptr_tiles(geom, bounds, (i - 1) // R, (j - 1) // C, i, j, state)
        ops.extend(walked)
    ops.extend([OP_D] * j if i == 0 else [OP_I] * i)
    ops.reverse()
    return ops
