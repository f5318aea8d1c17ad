"""Banded sequence parallelism: one long pair's band split into row blocks
over a device list (counterpart of ``seqalib_tpu/parallel/banded_sp.py``).

Block ``d`` of a mesh of ``D`` entries owns query rows ``[d*R, (d+1)*R]``
with ``R = ceil(n / D)``, in local coordinates ``i'' = i - d*R``,
``j'' = j - d*R - dlo_g``: the local band is ``[0, Dband - 1]`` for every
block, so one geometry serves every block and group.  A block's only
dependency on the block above is that block's last row (H and F over the
band; E stays within a row): ``band_fill`` injects it as local row 0
(``bh``/``bf``) and captures the block's own row R (``want_bout``) for the
block below.  Device 0's boundary is the DP row 0, the gap chain.

Pairs go in relay groups of ``GB``.  At super-step ``s`` block ``d`` fills
group ``s - d``, so with ``G >= D`` groups in flight every block has work.
The mesh is a tuple of ``torch.device``s (``band_pipeline.make_band_mesh``)
and may name one device several times; one process walks the super-steps,
launches each active block's fill on its device and moves each packet to
the next block's device with ``.to()``: the single-controller counterpart
of the JAX ``shard_map`` + ``ppermute``.  Each device receives only its
own letter window ``[d*R, d*R + W)``.  Scores are max-merged across
blocks (every block whose rows reach (n, m) captures the same value).

``banded_nw_affine_align_sp`` keeps the boundary each block consumed and
walks every group back from (n, m), block ``d_start`` down to 0: each
block's packed pointers are recomputed from its boundary (``band_fill``
``"ptr"`` mode with ``bh``/``bf``), walked with ``band_walk(i_floor=0)``
(a walker stops on reaching local row 0, where the block above takes it
over), and dropped before the next block's.  Every CIGAR is re-scored
against its relay score.

Not carried over, because they change no value: the TPU kernel's
clamp/dyn/steady phase runs (one ``band_fill`` call over ``[0, Kp)``
captures the same row), its NSUB unrolling and its packed-nibble profile
(the port looks scores up in a table).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..devices import Mesh
from ..models.banded import banded_matrix_supported
from ..ops.band_fill import LANES, band_fill, band_table, bout_width
from ..ops.band_walk import band_walk
from ..scoring import NIBBLE_BIAS
from ..telemetry import count_d2h
from ..types import NEG_INF, AlignResult, ScoringParams
from ..utils import ceil_to
from ..utils.cigar import OP_D, OP_PAD, ops_to_cigar, rescore_global_affine

GB = 8  # pairs per relay group (the TPU kernel's sublane-aligned batch)
PTR_CAP = 2 * 1024**3  # default SEQALIB_SP_PTR_CAP: pointer bytes of one block


def _is_single(q) -> bool:
    """One pair (1-D codes) rather than a batch."""
    if isinstance(q, np.ndarray):
        return q.ndim == 1
    return np.asarray(q[0]).ndim == 0


def _sp_setup(qs, ts, sp: ScoringParams, band: int, mesh: Mesh, CK: int):
    """Geometry and the padded, grouped letters and lengths (host arrays)."""
    qs = [np.asarray(q, np.int32) for q in qs]
    ts = [np.asarray(t, np.int32) for t in ts]
    B0 = len(qs)
    qlen = np.array([len(q) for q in qs], np.int64)
    tlen = np.array([len(t) for t in ts], np.int64)
    deltas = tlen - qlen
    dlo_p = np.minimum(0, deltas) - band
    dhi_p = np.maximum(0, deltas) + band
    dlo_g, dhi_g = int(dlo_p.min()), int(dhi_p.max())
    Dband = dhi_g - dlo_g + 1
    n = int(qlen.max())
    D = len(mesh)
    R = max(1, ceil_to(n, D) // D)
    Kloc = 2 * R + Dband
    Kp = ceil_to(Kloc, CK)
    Wp = ceil_to(Dband // 2 + 2, LANES)
    Wb = bout_width(dlo_g, dhi_g) + 2 * LANES  # the TPU kernel's aligned-block slack
    WQL = ceil_to(R + Dband // 2 + Wp + 2, LANES) + 2 * LANES
    WTL = ceil_to(Kp + 2, LANES) + 2 * LANES

    table = sp.substitution_matrix()
    if sp.matrix is not None and not banded_matrix_supported(table):
        raise NotImplementedError(
            "banded-SP matrix scoring takes tables in [-4, 11] with at most 30 "
            "letters, as the JAX package's; wider tables are single-device "
            "full-matrix territory"
        )
    A = int(table.shape[0])  # letters A and A + 1: the query and target sentinels
    sent = -NIBBLE_BIAS if sp.matrix is not None else sp.mismatch
    NG = ceil_to(B0, GB) // GB
    qg = np.full((NG, GB, (D - 1) * R + WQL), A, np.int32)
    tg = np.full((NG, GB, (D - 1) * R + WTL), A + 1, np.int32)
    # pad slots: empty pairs with a zero band; they start the walk done
    lens = np.zeros((4, NG, GB), np.int64)  # qlen, tlen, dlo_p, dhi_p
    z0 = 1 - dlo_g
    for x in range(B0):
        gi, b = divmod(x, GB)
        qg[gi, b, 1: 1 + len(qs[x])] = qs[x]  # 1-based rows; block d reads at d*R
        # target pre-shifted by dlo_g so that block d reads it at d*R too
        tg[gi, b, z0: z0 + len(ts[x])] = ts[x]
        lens[:, gi, b] = qlen[x], tlen[x], dlo_p[x], dhi_p[x]
    geom = dict(R=R, D=D, NG=NG, B0=B0, Dband=Dband, dlo_g=dlo_g, Kloc=Kloc,
                Kp=Kp, Wp=Wp, Wb=Wb, WQL=WQL, WTL=WTL, o=sp.gap_open,
                e=sp.gap_extend)
    return geom, dict(qg=qg, tg=tg, lens=lens, tab=band_table(table, sent))


def _on_devices(geom, arrays, mesh: Mesh):
    """Per block: its letter window, local lengths and band bounds, the
    pairs' own lengths, the score table and the empty start state, on the
    block's device."""
    g = geom
    R, dlo_g = g["R"], g["dlo_g"]
    blocks = []
    for d, dev in enumerate(mesh):
        qlen, tlen, dlo_p, dhi_p = arrays["lens"]
        local = np.stack([qlen - d * R, tlen - d * R - dlo_g, dlo_p - dlo_g,
                          dhi_p - dlo_g])  # (4, NG, GB)

        def put(x, dev=dev):
            return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)

        blocks.append(dict(
            qk=put(arrays["qg"][:, :, d * R: d * R + g["WQL"]]),
            tk=put(arrays["tg"][:, :, d * R: d * R + g["WTL"]]),
            vecs=put(local), lens=put(np.stack([qlen, tlen])), tab=put(arrays["tab"]),
            state=torch.full((4, GB, g["Wp"]), NEG_INF, dtype=torch.int32, device=dev),
            score=torch.full((GB, g["Wp"]), NEG_INF, dtype=torch.int32, device=dev),
        ))
    return blocks


def _fill_kw(geom):
    return dict(K=geom["Kloc"], dlo=0, dhi=geom["Dband"] - 1, gap_open=geom["o"],
                gap_extend=geom["e"], k0=0, k1=geom["Kp"])


def _block_fill(blk, gi, geom, bh, bf, mode):
    """Block ``blk``'s fill of group ``gi`` from the boundary (bh, bf)."""
    return band_fill(blk["qk"][gi], blk["tk"][gi], *blk["vecs"][:, gi], blk["state"],
                     blk["score"], blk["tab"], mode=mode, bh=bh, bf=bf,
                     want_bout=mode == "fill", bout_row=geom["R"], **_fill_kw(geom))


def _row0(blk, gi, geom):
    """Device 0's boundary: the DP row 0 (H(0, j) = o + j*e, H(0, 0) = 0,
    F = NEG_INF), built on the device from the group's target lengths."""
    tlen = blk["lens"][1, gi][:, None]
    jg = geom["dlo_g"] + torch.arange(geom["Wb"], dtype=torch.int32,
                                      device=tlen.device)[None, :]
    bh = torch.where(jg == 0, 0, torch.where((jg >= 1) & (jg <= tlen),
                                              geom["o"] + jg * geom["e"], NEG_INF))
    return bh.to(torch.int32), torch.full_like(bh, NEG_INF, dtype=torch.int32)


def _sp_relay(geom, blocks, mesh: Mesh, want_tb: bool = False):
    """The relay over ``NG + D - 1`` super-steps.  Returns the (NG * GB,)
    scores on the host and, with ``want_tb``, the boundary each block
    consumed: ``bnds[(d, gi)] = (bh, bf)`` on block d's device."""
    g = geom
    D, NG = g["D"], g["NG"]
    bnds, scores = {}, []
    pkts = [None] * D  # the boundary each block takes at this step
    for s in range(NG + D - 1):
        nxt = [None] * D
        for d, blk in enumerate(blocks):
            gi = s - d
            if not 0 <= gi < NG:  # pipeline fill / drain: no group
                continue
            bh, bf = _row0(blk, gi, g) if d == 0 else pkts[d]
            if want_tb:
                bnds[(d, gi)] = (bh, bf)
            out = _block_fill(blk, gi, g, bh, bf, "fill")
            scores.append((gi, out["score"].max(dim=1).values.to(mesh[0])))
            if d + 1 < D:  # the captured row, NEG_INF-padded to Wb columns
                nb = torch.nn.functional.pad(out["bout"], (0, g["Wb"] - out["bout"].shape[2]),
                                             value=NEG_INF).to(mesh[d + 1])
                nxt[d + 1] = (nb[0], nb[1])
        pkts = nxt
    merged = torch.full((NG, GB), NEG_INF, dtype=torch.int32, device=mesh[0])
    for gi, sc in scores:
        merged[gi] = torch.maximum(merged[gi], sc)
    count_d2h(merged)
    return merged.reshape(-1).cpu().numpy(), bnds


def banded_nw_affine_score_sp(qs, ts, sp: ScoringParams, band: int, mesh: Mesh,
                              CK: int = 512, nsub: int = 4):
    """Banded affine global SCOREs with each pair's band split into row
    blocks over ``mesh`` (module docstring): the banded oracle's score, per
    pair band ``[min(0, delta) - band, max(0, delta) + band]``.  ``qs``/``ts``:
    one pair (1-D codes) or a batch; returns an int or a list of ints.
    ``CK`` rounds the block's diagonals up (``Kp``); ``nsub`` is the JAX
    kernel's unrolling and changes no value here."""
    del nsub
    single = _is_single(qs)
    if single:
        qs, ts = [np.asarray(qs)], [np.asarray(ts)]
    geom, arrays = _sp_setup(qs, ts, sp, band, mesh, CK)
    scores, _ = _sp_relay(geom, _on_devices(geom, arrays, mesh), mesh)
    out = [int(s) for s in scores[: geom["B0"]]]
    return out[0] if single else out


def _walk_group(geom, blocks, bnds, gi, d_start):
    """Walk group ``gi`` back from (n, m), block ``d_start`` down to 0,
    holding one block's pointers at a time.  Returns the per-block op
    columns, the final walker state (global row, col - dlo_g) and a flag
    of participants that left a block elsewhere than its row 0; all on
    the devices, fetched by the caller."""
    g = geom
    R, dhi = g["R"], g["Dband"] - 1
    qlen, tlen = blocks[d_start]["lens"][:, gi]
    i, j = qlen, tlen - g["dlo_g"]  # from (n, m): global row, column - dlo_g
    st = torch.zeros_like(i)
    done = (qlen == 0).to(torch.int32)  # pad slots start done
    viol = torch.zeros((), dtype=torch.bool, device=i.device)
    ops = {}
    for d in range(d_start, -1, -1):
        dev = blocks[d]["qk"].device
        i, j, st, done, viol = (x.to(dev) for x in (i, j, st, done, viol))
        bh, bf = bnds[(d, gi)]
        ptr = _block_fill(blocks[d], gi, g, bh, bf, "ptr")["ptr"]
        partic = (done == 0) & (i > d * R)  # walkers inside this block
        ops[d], il, jl, st2, _ = band_walk(ptr, i - d * R, j - d * R, st,
                                           (~partic).to(torch.int32), k0=0, dhi=dhi,
                                           i_floor=0)
        del ptr
        i = torch.where(partic, il + d * R, i)
        j = torch.where(partic, jl + d * R, j)
        st = torch.where(partic, st2, st)
        if d == 0:
            done = torch.where(partic, 1, done)
        viol = viol | (partic & (il != 0)).any()  # the handoff invariant
    return ops, i, j, viol


def banded_nw_affine_align_sp(q, t, sp: ScoringParams, band: int, mesh: Mesh,
                              CK: int = 256, nsub: int = 4):
    """Banded affine global alignment over ``mesh``: scores and CIGARs.
    One pair (1-D codes) or a batch; the relay fills every group once,
    keeping each block's boundary, then each group is walked back block by
    block (module docstring).  Every CIGAR is re-scored against its relay
    score.  Raises ``RuntimeError`` when one block's packed pointers
    (``Kp * GB * Wp / 2`` bytes) exceed ``SEQALIB_SP_PTR_CAP`` (2 GiB by
    default).  Returns an AlignResult, or a list of them."""
    del nsub
    single = _is_single(q)
    qs = [np.asarray(q, np.int32)] if single else [np.asarray(x, np.int32) for x in q]
    ts = [np.asarray(t, np.int32)] if single else [np.asarray(x, np.int32) for x in t]
    results: list = [None] * len(qs)
    live = [x for x, (a, b) in enumerate(zip(qs, ts)) if len(a) and len(b)]
    for x in range(len(qs)):
        if x not in live:  # an empty side: one gap, answered on the host
            n, m = len(qs[x]), len(ts[x])
            score = 0 if n == m else sp.gap_open + max(n, m) * sp.gap_extend
            results[x] = AlignResult(int(score), 0, n, 0, m,
                                     (f"{m}D" if m else "") if n == 0 else f"{n}I")
    if not live:
        return results[0] if single else results
    geom, arrays = _sp_setup([qs[x] for x in live], [ts[x] for x in live], sp, band,
                             mesh, CK)
    g = geom
    ptr_bytes = g["Kp"] * GB * g["Wp"] // 2
    cap = int(os.environ.get("SEQALIB_SP_PTR_CAP", str(PTR_CAP)))
    if ptr_bytes > cap:
        raise RuntimeError(
            f"banded-SP traceback pointer block {ptr_bytes / 1e9:.1f} GB per device "
            f"exceeds SEQALIB_SP_PTR_CAP={cap}; use more devices (smaller R) or a "
            "narrower band"
        )
    blocks = _on_devices(geom, arrays, mesh)
    scores, bnds = _sp_relay(geom, blocks, mesh, want_tb=True)
    R, dlo_g = g["R"], g["dlo_g"]
    # one d_start for the batch: a group whose pairs end lower simply has no
    # participants in its top blocks
    d_start = int((arrays["lens"][0].max() - 1) // R)
    walks = [_walk_group(geom, blocks, bnds, gi, d_start) for gi in range(g["NG"])]
    for gi, (ops, i_fin, j_fin, viol) in enumerate(walks):
        if bool(viol):
            raise RuntimeError("SP block walk ended mid-block (handoff invariant)")
        # block 0 first: each block's columns run along increasing diagonals
        rows = [ops[d] for d in range(d_start + 1)]
        opsm = np.concatenate([r.cpu().numpy() for r in rows], axis=1)
        count_d2h(*rows, i_fin, j_fin)
        i_fin, j_fin = i_fin.cpu().numpy(), j_fin.cpu().numpy()
        for b in range(GB):
            idx = gi * GB + b
            if idx >= len(live):
                break
            x = live[idx]
            row = opsm[b][opsm[b] != OP_PAD]
            j_glob = int(j_fin[b]) + dlo_g
            if int(i_fin[b]) != 0 or j_glob < 0:
                raise RuntimeError(f"SP walk final state invalid (pair {x}: "
                                   f"i={int(i_fin[b])}, j={j_glob})")
            path = [OP_D] * j_glob + [int(v) for v in row]
            score = int(scores[idx])
            walked = rescore_global_affine(qs[x], ts[x], path, sp)
            if walked != score:  # not an assert: survives python -O
                raise RuntimeError(f"banded-SP traceback rescore {walked} != relay "
                                   f"score {score}")
            results[x] = AlignResult(score, 0, len(qs[x]), 0, len(ts[x]),
                                     ops_to_cigar(path))
    return results[0] if single else results
