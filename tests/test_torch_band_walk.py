"""Port parity: ``seqalib_tpu_torch.ops.band_walk`` (plain version on the
CPU) against the JAX ``band_walk_range`` Pallas kernel (``packed=True``)
in interpret mode, super-block by super-block, with the walker state
handed from each block to the next as the banded driver does.  Exact
equality of the op columns and of the walker states.

The pointer blocks come from the port's ``band_fill`` in ``"ptr"`` mode,
whose bytes equal the JAX kernel's (``test_torch_band_fill.py``); the
joined ops are also checked against the oracle's banded CIGARs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqalib_tpu.ops.banded_pallas import band_walk_range
from seqalib_tpu.oracle import nw_affine
from seqalib_tpu.types import ScoringParams as JaxScoringParams
from seqalib_tpu_torch.models.banded import _geometry, _pad_letters
from seqalib_tpu_torch.ops import launches
from seqalib_tpu_torch.ops.band_fill import band_fill, band_table
from seqalib_tpu_torch.ops.band_walk import band_walk
from seqalib_tpu_torch.types import NEG_INF
from seqalib_tpu_torch.utils.cigar import OP_PAD, ops_to_cigar

SP = JaxScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
BAND, CK, SB = 5, 16, 2  # super-blocks of 2 chunks: KW = 32 diagonals
QLEN = np.array([70, 61, 70, 30, 0])
TLEN = np.array([70, 66, 59, 34, 3])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them fast when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.int32)


@pytest.fixture(scope="module")
def blocks():
    """Every super-block's pointer nibbles, high k first, for a bucket of
    mixed deltas (a pair with qlen = 0 included)."""
    rng = np.random.default_rng(3)
    B, n, m = len(QLEN), int(QLEN.max()), int(TLEN.max())
    qs = rng.integers(0, 4, size=(B, n)).astype(np.int32)
    ts = rng.integers(0, 4, size=(B, m)).astype(np.int32)
    ts[:, 4:50] = np.delete(qs, [20, 21], axis=1)[:, 2:48]  # a 2-letter deletion
    deltas = TLEN - QLEN
    dlo_p = np.minimum(0, deltas) - BAND
    dhi_p = np.maximum(0, deltas) + BAND
    dlo, dhi = int(dlo_p.min()), int(dhi_p.max())
    Wp, K = _geometry(dlo, dhi, n, m)
    Kp = -(-K // (SB * CK)) * SB * CK  # every super-block spans SB chunks
    args = [_t(_pad_letters(qs, n + 1, 4, QLEN)), _t(_pad_letters(ts, m + 1, 5, TLEN))]
    args += [_t(v) for v in (QLEN, TLEN, dlo_p, dhi_p)]
    tab = _t(band_table(SP.substitution_matrix(), SP.mismatch))
    kw = dict(K=K, dlo=dlo, dhi=dhi, gap_open=SP.gap_open, gap_extend=SP.gap_extend)
    state0 = torch.full((4, B, Wp), NEG_INF, dtype=torch.int32)
    score0 = torch.full((B, Wp), NEG_INF, dtype=torch.int32)
    fill = band_fill(*args, state0, score0, tab, k0=0, k1=Kp, mode="fill", CK=CK, **kw)
    out = []
    for cg in range(Kp // CK - SB, -1, -SB):
        ptr = band_fill(*args, fill["ckpt"][cg], score0, tab, k0=cg * CK,
                        k1=(cg + SB) * CK, mode="ptr", **kw)["ptr"]
        out.append((cg * CK, ptr))
    return dict(qs=qs, ts=ts, dhi=dhi, Wp=Wp, blocks=out)


def _walk_all(blocks, walk):
    st = [_t(QLEN), _t(TLEN), _t(np.zeros(len(QLEN))), _t(np.zeros(len(QLEN)))]
    per_block = []
    for k0, ptr in blocks["blocks"]:
        ops, *st = walk(ptr, *st, k0)
        per_block.append((np.asarray(ops), [np.asarray(v) for v in st]))
    return per_block


def _jax_walk(blocks, i_floor=-1):
    B, Wp, dhi = len(QLEN), blocks["Wp"], blocks["dhi"]

    def walk(ptr, i, j, st, done, k0):
        KW = 2 * ptr.shape[0]
        ops, *state = band_walk_range(
            jnp.asarray(ptr.numpy().view(np.int8)), *(jnp.asarray(v.numpy()) for v in
                                                      (i, j, st, done)),
            k0, KW=KW, dhi=dhi, Wp=Wp, B=B, interpret=True, packed=True,
            i_floor=i_floor)
        return (np.asarray(ops)[:, :KW], *(torch.from_numpy(np.asarray(v).copy())
                                          for v in state))

    return _walk_all(blocks, walk)


def test_walk_matches_jax_block_by_block(blocks):
    before = dict(launches)
    got = _walk_all(blocks, lambda ptr, *st: band_walk(ptr, *st[:4], k0=st[4],
                                                       dhi=blocks["dhi"]))
    assert launches == before  # the CPU path runs the plain version
    want = _jax_walk(blocks)
    assert len(got) == len(want) > 2
    for (ops, st), (wops, wst) in zip(got, want):
        assert ops.dtype == np.uint8
        np.testing.assert_array_equal(ops, wops)
        for a, b in zip(st, wst):
            np.testing.assert_array_equal(a, b)
    assert got[-1][1][3].all()  # every walker reached the origin


def test_joined_ops_are_the_oracle_cigars(blocks):
    got = _walk_all(blocks, lambda ptr, *st: band_walk(ptr, *st[:4], k0=st[4],
                                                       dhi=blocks["dhi"]))
    ops = np.concatenate([o[:, ::-1] for o, _ in got], axis=1)
    for b in range(len(QLEN)):
        row = ops[b]
        cigar = ops_to_cigar(row[row != OP_PAD][::-1])
        ref = nw_affine(blocks["qs"][b, : QLEN[b]], blocks["ts"][b, : TLEN[b]], SP,
                        band=BAND)
        assert cigar == ref.cigar, b
    assert any("I" in c or "D" in c for c in [
        nw_affine(blocks["qs"][b, : QLEN[b]], blocks["ts"][b, : TLEN[b]], SP,
                  band=BAND).cigar for b in range(len(QLEN))])


def test_done_walkers_emit_nothing(blocks):
    k0, ptr = blocks["blocks"][0]
    B = len(QLEN)
    ops, i, j, st, done = band_walk(ptr, _t(QLEN), _t(TLEN), _t(np.zeros(B)),
                                    _t(np.ones(B)), k0=k0, dhi=blocks["dhi"])
    assert (ops.numpy() == OP_PAD).all()
    np.testing.assert_array_equal(i.numpy(), QLEN)
    np.testing.assert_array_equal(j.numpy(), TLEN)


def test_odd_k0_is_refused(blocks):
    _, ptr = blocks["blocks"][0]
    v = _t(np.zeros(len(QLEN)))
    with pytest.raises(ValueError, match="even"):
        band_walk(ptr, v, v, v, v, k0=3, dhi=blocks["dhi"])


@pytest.mark.parametrize("i_floor", [0, 9])
def test_floor_handoff_matches_jax(blocks, i_floor):
    """With ``i_floor`` a walker is done once it stands on a row <= i_floor
    (banded SP: local row 0 belongs to the block above); the walkers
    cross row i_floor inside the lowest blocks."""
    before = dict(launches)
    got = _walk_all(blocks, lambda ptr, *st: band_walk(ptr, *st[:4], k0=st[4],
                                                       dhi=blocks["dhi"], i_floor=i_floor))
    assert launches == before
    want = _jax_walk(blocks, i_floor)
    for (ops, st), (wops, wst) in zip(got, want, strict=True):
        np.testing.assert_array_equal(ops, wops)
        for a, b in zip(st, wst):
            np.testing.assert_array_equal(a, b)
    i, j, _, done = got[-1][1]
    live = QLEN > 0
    assert (i[live] == i_floor).all() and done[live].all()  # stopped on the floor
    if i_floor == 0:
        assert (j[live] > 0).any()  # ... before the column-0 end of a path


def test_floor_minus_one_never_stops(blocks):
    walk = lambda f: _walk_all(blocks, lambda ptr, *st: band_walk(  # noqa: E731
        ptr, *st[:4], k0=st[4], dhi=blocks["dhi"], **f))
    for (ops, st), (wops, wst) in zip(walk({}), walk({"i_floor": -1}), strict=True):
        np.testing.assert_array_equal(ops, wops)
        for a, b in zip(st, wst):
            np.testing.assert_array_equal(a, b)
