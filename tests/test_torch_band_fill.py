"""Port parity: ``seqalib_tpu_torch.ops.band_fill`` (plain version on the
CPU) against the JAX ``band_fill_range`` Pallas kernel in interpret mode,
in its three modes, on the same letters and states.  Exact equality: the
work is integer DP.

* ``fill``: the final-cell capture, the H/E/F rows of the state after the
  last diagonal and of every checkpoint, on a bucket of mixed length
  deltas (its fill crosses ``dhi + 1``, where ``ihat`` starts to move);
* ``ptr``: resumed from a checkpoint, every packed pointer byte (two
  diagonals per byte) and the state after it;
* ``emode`` with ``tie_safe``: BV, BK and the edge bound EV of every slot,
  on reversed-prefix inputs shaped as pass 2 builds them.

Scoring: DNA match/mismatch (the JAX kernel's scalar route) and BLOSUM62
(its packed-nibble profile route), each against the port's table lookup.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqalib_tpu.models import banded as jax_banded
from seqalib_tpu.ops import banded_pallas as bp
from seqalib_tpu.oracle import nw_affine
from seqalib_tpu.parallel.dispatch import sentinel_table
from seqalib_tpu.types import BLOSUM62, NEG_INF
from seqalib_tpu.types import ScoringParams as JaxScoringParams
from seqalib_tpu_torch.ops import launches
from seqalib_tpu_torch.ops.band_fill import band_fill, band_table

O, E = -5, -2
BAND, CK = 6, 16
QLEN = np.array([60, 52, 60, 41])
TLEN = np.array([60, 64, 48, 41])  # deltas 0, +12, -12, 0
SCORINGS = {
    "dna": (JaxScoringParams(match=2, mismatch=-3, gap_open=O, gap_extend=E), 4),
    "blosum62": (JaxScoringParams.blosum62(gap_open=O, gap_extend=E), 20),
}


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


def _j(x):
    return jnp.asarray(np.asarray(x, np.int32))


def _jax_letters(sp, qk):
    """The JAX kernel's query input: letters (scalar route) or the packed
    profile, and its match/mismatch/profile arguments."""
    if sp.matrix is None:
        return qk, dict(match=sp.match, mismatch=sp.mismatch, profile=False)
    prof = bp.build_packed_profile_np(qk, sp.substitution_matrix())
    return prof, dict(match=0, mismatch=0, profile=True)


def _sent(sp):
    """The sentinel score of the JAX kernel's route for ``sp``."""
    return -bp.NIBBLE_BIAS if sp.matrix is not None else sp.mismatch


@pytest.fixture(scope="module", params=sorted(SCORINGS))
def fill_case(request):
    """A mixed-delta bucket filled by JAX with checkpoints, then one
    super-block recomputed from a checkpoint with packed pointers."""
    sp, alpha = SCORINGS[request.param]
    rng = np.random.default_rng(len(request.param))
    B, n, m = len(QLEN), int(QLEN.max()), int(TLEN.max())
    qs = rng.integers(0, alpha, size=(B, n)).astype(np.int32)
    ts = rng.integers(0, alpha, size=(B, m)).astype(np.int32)
    ts[:, 5:40] = qs[:, 8:43]  # shared stretches: gapped optimal paths
    deltas = TLEN - QLEN
    dlo_p = np.minimum(0, deltas) - BAND
    dhi_p = np.maximum(0, deltas) + BAND
    dlo, dhi = int(dlo_p.min()), int(dhi_p.max())
    Wp, K = jax_banded._geometry(dlo, dhi, n, m)
    Kp = -(-K // CK) * CK
    A = sp.substitution_matrix().shape[0]
    qk = jax_banded._pad_letters(qs, Kp + Wp + 256, A, QLEN)
    tk = jax_banded._pad_letters(ts, Kp + 256, A + 1, TLEN)
    qin, kwj = _jax_letters(sp, qk)
    state0 = bp.init_band_state(qin, B, Wp, profile=kwj["profile"])
    score0 = np.full((B, Wp), NEG_INF, np.int32)
    geo = dict(K=K, Wp=Wp, dlo=dlo, dhi=dhi, gap_open=O, gap_extend=E, CK=CK,
               interpret=True, nsub=4, **kwj)
    vecs = (QLEN, TLEN, dlo_p, dhi_p)
    args = [_j(qin), _j(tk)] + [_j(v) for v in vecs]
    score, state, ckpt, _ = bp.band_fill_range(
        *args, _j(state0), _j(score0), k_start=0, k_end=Kp, want_ptr=False,
        want_ckpt=True, **geo)
    cg = 2  # resume from the third checkpoint, as the traceback does
    _, pstate, _, ptr = bp.band_fill_range(
        *args, ckpt[cg], _j(score0), k_start=cg * CK, k_end=Kp, want_ptr=True,
        want_ckpt=False, want_score=False, pack_ptr=True, **geo)
    port_args = [_t(qk), _t(tk)] + [_t(v) for v in vecs]
    return dict(
        sp=sp, qs=qs, ts=ts, dlo=dlo, dhi=dhi, K=K, Kp=Kp, cg=cg,
        port_args=port_args, tab=_t(band_table(sp.substitution_matrix(), _sent(sp))),
        state0=_t(state0[:4]), score0=_t(score0),
        jax=dict(score=np.asarray(score), state=np.asarray(state)[:4],
                 ckpt=np.asarray(ckpt)[:, :4], pstate=np.asarray(pstate)[:4],
                 ptr=np.asarray(ptr).view(np.uint8)),
    )


def _fill(case, **kw):
    return band_fill(*case["port_args"], case["state0"], case["score0"], case["tab"],
                     K=case["K"], dlo=case["dlo"], dhi=case["dhi"], gap_open=O,
                     gap_extend=E, **kw)


def test_fill_capture_state_and_checkpoints_match_jax(fill_case):
    before = dict(launches)
    r = _fill(fill_case, k0=0, k1=fill_case["Kp"], mode="fill", CK=CK)
    assert launches == before  # the CPU path runs the plain version
    jax = fill_case["jax"]
    np.testing.assert_array_equal(r["score"].numpy(), jax["score"])
    np.testing.assert_array_equal(r["state"].numpy(), jax["state"])
    assert r["ckpt"].shape == jax["ckpt"].shape
    np.testing.assert_array_equal(r["ckpt"].numpy(), jax["ckpt"])


def test_fill_capture_is_the_oracle_banded_score(fill_case):
    r = _fill(fill_case, k0=0, k1=fill_case["Kp"], mode="fill")
    scores = r["score"].numpy().max(axis=1)
    for b in range(len(QLEN)):
        ref = nw_affine(fill_case["qs"][b, : QLEN[b]], fill_case["ts"][b, : TLEN[b]],
                        fill_case["sp"], band=BAND)
        assert scores[b] == ref.score, b


def test_fill_in_two_ranges_equals_one(fill_case):
    # resuming from a returned state reproduces the single fill bit for bit
    Kp, cut = fill_case["Kp"], 3 * CK
    r1 = _fill(fill_case, k0=0, k1=cut, mode="fill")
    r2 = band_fill(*fill_case["port_args"], r1["state"], r1["score"], fill_case["tab"],
                   k0=cut, k1=Kp, K=fill_case["K"], dlo=fill_case["dlo"],
                   dhi=fill_case["dhi"], gap_open=O, gap_extend=E, mode="fill")
    np.testing.assert_array_equal(r2["score"].numpy(), fill_case["jax"]["score"])
    np.testing.assert_array_equal(r2["state"].numpy(), fill_case["jax"]["state"])


def test_ptr_bytes_from_a_checkpoint_match_jax(fill_case):
    cg = fill_case["cg"]
    state = torch.from_numpy(fill_case["jax"]["ckpt"][cg].copy())
    r = band_fill(*fill_case["port_args"], state, fill_case["score0"], fill_case["tab"],
                  k0=cg * CK, k1=fill_case["Kp"], K=fill_case["K"], dlo=fill_case["dlo"],
                  dhi=fill_case["dhi"], gap_open=O, gap_extend=E, mode="ptr")
    jax = fill_case["jax"]
    assert r["ptr"].dtype == torch.uint8
    assert r["ptr"].shape == jax["ptr"].shape
    np.testing.assert_array_equal(r["ptr"].numpy(), jax["ptr"])
    np.testing.assert_array_equal(r["state"].numpy(), jax["pstate"])


# ---- emode: pass 2's anchored reverse extension --------------------------

BW = 8
WR = 40


@pytest.fixture(scope="module", params=sorted(SCORINGS))
def emode_case(request):
    """Reversed-prefix inputs shaped as pass 2 builds them (sentinel
    table, 1-based letters, an unmasked 128-slot window over diagonals
    -BW..BW), filled by JAX in emode with tie_safe."""
    sp, alpha = SCORINGS[request.param]
    rng = np.random.default_rng(10 + len(request.param))
    table = sentinel_table(sp)
    A1 = table.shape[0]
    B, Wp = 4, 128
    qlen2 = np.array([WR, 31, 12, 0])
    te2 = np.array([48, 40, 20, 5])
    qr = rng.integers(0, alpha, size=(B, WR)).astype(np.int32)
    tr = rng.integers(0, alpha, size=(B, 56)).astype(np.int32)
    tr[:, :30] = qr[:, 3:33]  # an anchored run with a 3-letter gap
    tr[1, 10:14] = qr[1, 9:13]
    Kp = 96
    qk = np.full((B, Kp + Wp + 256), A1, np.int32)
    qk[:, 1 : 1 + WR] = np.where(np.arange(WR)[None, :] < qlen2[:, None], qr, A1)
    tk = np.full((B, Kp + 256), A1 + 1, np.int32)
    tk[:, 1:57] = np.where(np.arange(1, 57)[None, :] <= te2[:, None], tr, A1 + 1)
    packed = A1 > 8
    if packed:
        qin = bp.build_packed_profile_np(qk, table)
        kwj = dict(match=0, mismatch=0, profile=True)
        smax, sent = 15 - bp.NIBBLE_BIAS, -bp.NIBBLE_BIAS
        qrows = qin[:, :, :Wp]
    else:
        qin = qk
        match, mismatch = int(table[0, 0]), int(table[0, 1])
        kwj = dict(match=match, mismatch=mismatch, profile=False)
        smax, sent = max(match, mismatch), mismatch
        qrows = qk[None, :, :Wp]
    neg = np.full((1, B, Wp), NEG_INF, np.int32)
    state0 = np.concatenate([np.repeat(neg, 4, 0), qrows, np.zeros_like(neg), neg,
                             np.zeros_like(neg)])
    band = np.full(B, BW)
    score, state, _, _ = bp.band_fill_range(
        _j(qin), _j(tk), _j(qlen2), _j(te2), _j(-band), _j(band), _j(state0),
        _j(neg[0]), k_start=0, k_end=Kp, K=Kp, Wp=Wp, dlo=-BW, dhi=BW, gap_open=O,
        gap_extend=E, want_ptr=False, want_ckpt=False, CK=16, interpret=True,
        nsub=4, emode=True, tie_safe=True, smax=smax, **kwj)
    state = np.asarray(state)
    pstate = np.concatenate([np.repeat(neg, 5, 0), np.zeros_like(neg)])
    port_args = [_t(qk[:, : WR + 1]), _t(tk[:, :57]), _t(qlen2), _t(te2), _t(-band),
                 _t(band), _t(pstate), _t(neg[0]), _t(band_table(table, sent))]
    return dict(port_args=port_args, Kp=Kp, smax=smax,
                jax=dict(BV=state[-2], BK=state[-1], EV=np.asarray(score),
                         H=state[:4]))


@pytest.mark.parametrize("tie_safe", [True, False])
def test_emode_bv_bk_ev_match_jax(emode_case, tie_safe):
    # the letter arrays are cut to the data: reads past them take a sentinel
    r = band_fill(*emode_case["port_args"], k0=0, k1=emode_case["Kp"],
                  K=emode_case["Kp"], dlo=-BW, dhi=BW, gap_open=O, gap_extend=E,
                  mode="emode", tie_safe=tie_safe, smax=emode_case["smax"])
    jax = emode_case["jax"]
    st = r["state"].numpy()
    np.testing.assert_array_equal(st[4], jax["BV"])
    np.testing.assert_array_equal(st[5], jax["BK"])
    np.testing.assert_array_equal(st[:4], jax["H"])
    if tie_safe:
        np.testing.assert_array_equal(r["score"].numpy(), jax["EV"])
        assert (jax["EV"][:, 1:-2] == NEG_INF).all()  # only the edge slots bound
    else:
        assert (r["score"].numpy() == NEG_INF).all()
    assert (st[4] > NEG_INF // 2).any()


def test_bad_arguments_are_refused():
    z = torch.zeros((1, 4), dtype=torch.int32)
    v = torch.zeros(1, dtype=torch.int32)
    st = torch.zeros((4, 1, 128), dtype=torch.int32)
    sc = torch.zeros((1, 128), dtype=torch.int32)
    tab = torch.zeros((6, 6), dtype=torch.int32)
    kw = dict(K=9, dlo=-2, dhi=2, gap_open=O, gap_extend=E)
    with pytest.raises(ValueError, match="even"):
        band_fill(z, z, v, v, v, v, st, sc, tab, k0=0, k1=3, mode="ptr", **kw)
    with pytest.raises(ValueError, match="checkpoints"):
        band_fill(z, z, v, v, v, v, st, sc, tab, k0=0, k1=4, mode="ptr", CK=2, **kw)
    with pytest.raises(ValueError, match="state"):
        band_fill(z, z, v, v, v, v, st, sc, tab, k0=0, k1=4, mode="emode", **kw)
    with pytest.raises(ValueError, match="unknown mode"):
        band_fill(z, z, v, v, v, v, st, sc, tab, k0=0, k1=4, mode="walk", **kw)


# ---- banded-SP resume: boundary injection (bh/bf) and capture (bout) -------

BOUT_ROW = 20  # capture zone [40, 168): real, 0 (no slot) and NEG_INF columns


@pytest.fixture(scope="module", params=sorted(SCORINGS))
def relay_case(request):
    """A block resumed from a boundary row (H/F streams with real and
    NEG_INF entries), filled by JAX from diagonal 0 in fill and ptr modes
    with the capture of row BOUT_ROW."""
    sp, alpha = SCORINGS[request.param]
    rng = np.random.default_rng(20 + len(request.param))
    B, n, m = len(QLEN), int(QLEN.max()), int(TLEN.max())
    qs = rng.integers(0, alpha, size=(B, n)).astype(np.int32)
    ts = rng.integers(0, alpha, size=(B, m)).astype(np.int32)
    ts[:, 3:45] = qs[:, 5:47]
    deltas = TLEN - QLEN
    dlo_p = np.minimum(0, deltas) - BAND
    dhi_p = np.maximum(0, deltas) + BAND
    dlo, dhi = int(dlo_p.min()), int(dhi_p.max())
    Wp, K = jax_banded._geometry(dlo, dhi, n, m)
    Kp = -(-K // CK) * CK
    Wbo = -(-(dhi - dlo + 1) // 128) * 128
    Wb = Wbo + 256
    A = sp.substitution_matrix().shape[0]
    qk = jax_banded._pad_letters(qs, Kp + Wp + 256, A, QLEN)
    tk = jax_banded._pad_letters(ts, Kp + 256, A + 1, TLEN)
    qin, kwj = _jax_letters(sp, qk)
    state0 = bp.init_band_state(qin, B, Wp, profile=kwj["profile"])
    score0 = np.full((B, Wp), NEG_INF, np.int32)
    # a boundary row: real values on part of the band, NEG_INF elsewhere
    bh = (O + E * np.arange(Wb) + rng.integers(-6, 7, size=(B, Wb))).astype(np.int32)
    bf = (bh + rng.integers(-9, 0, size=(B, Wb))).astype(np.int32)
    bh[:, 14:] = NEG_INF
    bh[1, :3] = NEG_INF
    bf[:, 10:] = NEG_INF
    geo = dict(K=K, Wp=Wp, dlo=dlo, dhi=dhi, gap_open=O, gap_extend=E, CK=CK,
               interpret=True, nsub=4, **kwj)
    vecs = (QLEN, TLEN, dlo_p, dhi_p)
    args = [_j(qin), _j(tk)] + [_j(v) for v in vecs] + [_j(state0), _j(score0)]
    inj = dict(bh=_j(bh), bf=_j(bf), want_bout=True, bout_row=BOUT_ROW, k_start=0,
               k_end=Kp, want_ckpt=False)
    score, state, _, _, bout = bp.band_fill_range(*args, want_ptr=False, **inj, **geo)
    _, pstate, _, ptr, pbout = bp.band_fill_range(
        *args, want_ptr=True, want_score=False, pack_ptr=True, **inj, **geo)
    port_args = [_t(qk), _t(tk)] + [_t(v) for v in vecs]
    return dict(
        port_args=port_args, state0=_t(state0[:4]), score0=_t(score0), bh=_t(bh),
        bf=_t(bf), K=K, Kp=Kp, dlo=dlo, dhi=dhi,
        tab=_t(band_table(sp.substitution_matrix(), _sent(sp))),
        jax=dict(score=np.asarray(score), state=np.asarray(state)[:4],
                 bout=np.asarray(bout), pstate=np.asarray(pstate)[:4],
                 ptr=np.asarray(ptr).view(np.uint8), pbout=np.asarray(pbout)),
    )


@pytest.mark.parametrize("mode", ["fill", "ptr"])
def test_injection_and_capture_match_jax(relay_case, mode):
    c = relay_case
    before = dict(launches)
    r = band_fill(*c["port_args"], c["state0"], c["score0"], c["tab"], k0=0, k1=c["Kp"],
                  K=c["K"], dlo=c["dlo"], dhi=c["dhi"], gap_open=O, gap_extend=E,
                  mode=mode, bh=c["bh"], bf=c["bf"], want_bout=True, bout_row=BOUT_ROW)
    assert launches == before  # the CPU path runs the plain version
    jax = c["jax"]
    if mode == "fill":
        np.testing.assert_array_equal(r["score"].numpy(), jax["score"])
        np.testing.assert_array_equal(r["state"].numpy(), jax["state"])
        want_bout = jax["bout"]
    else:
        np.testing.assert_array_equal(r["ptr"].numpy(), jax["ptr"])
        np.testing.assert_array_equal(r["state"].numpy(), jax["pstate"])
        want_bout = jax["pbout"]
    bout = r["bout"].numpy()
    assert bout.shape == want_bout.shape == (2, len(QLEN), 128)
    np.testing.assert_array_equal(bout, want_bout)
    # the three kinds of capture column: a slot's value, 0 where no slot
    # holds the row, NEG_INF past the last diagonal
    x_end = c["Kp"] - 2 * BOUT_ROW
    assert (bout[:, :, x_end:] == NEG_INF).all()
    assert (bout[:, :, 19:x_end] == 0).all()
    assert ((bout[0, :, :19] > NEG_INF // 2) & (bout[0, :, :19] != 0)).any()


def test_injection_changes_the_fill(relay_case):
    # the boundary reaches the final cells: without it the scores differ
    c = relay_case
    kw = dict(k0=0, k1=c["Kp"], K=c["K"], dlo=c["dlo"], dhi=c["dhi"], gap_open=O,
              gap_extend=E, mode="fill")
    plain = band_fill(*c["port_args"], c["state0"], c["score0"], c["tab"], **kw)
    inj = band_fill(*c["port_args"], c["state0"], c["score0"], c["tab"], bh=c["bh"],
                    bf=c["bf"], **kw)
    assert "bout" not in inj
    assert not torch.equal(plain["score"], inj["score"])
    np.testing.assert_array_equal(inj["score"].numpy(), c["jax"]["score"])


def test_boundary_arguments_are_refused():
    z = torch.zeros((1, 4), dtype=torch.int32)
    v = torch.zeros(1, dtype=torch.int32)
    st = torch.zeros((4, 1, 128), dtype=torch.int32)
    sc = torch.zeros((1, 128), dtype=torch.int32)
    tab = torch.zeros((6, 6), dtype=torch.int32)
    kw = dict(K=9, dlo=-2, dhi=2, gap_open=O, gap_extend=E, k0=0, k1=4)
    bh = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        band_fill(z, z, v, v, v, v, st, sc, tab, mode="fill", bh=bh, **kw)
    with pytest.raises(ValueError, match="fill/ptr"):
        band_fill(z, z, v, v, v, v, torch.zeros((6, 1, 128), dtype=torch.int32), sc, tab,
                  mode="emode", want_bout=True, **kw)
    with pytest.raises(ValueError, match="bh must be"):
        band_fill(z, z, v, v, v, v, st, sc, tab, mode="fill", bh=bh.long(), bf=bh, **kw)


def test_fill_geometry_covers_every_wide_width():
    """``fill_geometry``: one CTA up to Wp 8 192 (the register variant's S
    and threads), a cluster of 2-16 CTAs that holds every slot, with slot
    Wp - 1 in its last CTA, at every Wp the banded geometry gives from
    8 320 to 131 072, and the scratch variant past that."""
    from seqalib_tpu_torch.ops.band_fill import MAX_WP_CLUSTER, fill_geometry, launch_key

    for Wp in range(128, 8193, 128):
        C, S, T = fill_geometry(Wp)
        assert C == 1 and S in (1, 2, 4, 8, 16) and T % 32 == 0 and T <= 512
        assert S * T >= Wp and (S == 1 or (S // 2) * 512 < Wp)
    for Wp in range(8320, MAX_WP_CLUSTER + 1, 128):
        C, S, T = fill_geometry(Wp)
        assert 2 <= C <= 16 and S in (2, 4, 8, 16) and T % 32 == 0 and 32 <= T <= 512
        assert C * S * T >= Wp > (C - 1) * S * T, Wp
        assert launch_key("ptr", True, Wp) == "band_fill/wide_ptr"
    assert MAX_WP_CLUSTER == 131072
    for Wp in (131200, 262144):
        assert fill_geometry(Wp)[0] == 0
        assert launch_key("emode", False, Wp) == "band_fill/wide_scratch_emode"
    assert launch_key("fill", True, 512, (4, 4, 32)) == "band_fill/wide"
