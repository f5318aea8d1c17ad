"""Port parity for the banded full-matrix wavefront (kernel 7's route):
``seqalib_tpu_torch.ops.wavefront`` (plain version on the CPU) against the
JAX ``wavefront_pallas._fill`` in interpret mode, and
``align_batch(band=, mode="global")`` with substitution tables outside
the packed-nibble range [-4, 11] against the JAX ``align_batch(...,
backend="pallas")`` and the oracle.

* the fill, on the JAX kernel's profile route (tables of more than 8
  rows) and its scalar route, with pointers and score-only: the score of
  cell (qlen, tlen) and every pointer byte of the K anti-diagonals, the
  slots outside the band and the matrix included;
* the two faults of the JAX route, pinned: its profile banks are a bf16
  product, so table entries beyond +-256 round; its scalar route scores
  by ``table[0, 0]`` / ``table[0, 1]``.  The port follows the oracle;
* the identity the card run checks: 2 x BLOSUM62 with o = -20, e = -2 on
  this route gives the results of BLOSUM62 with o = -10, e = -1 on the
  banded route (``band_fill``), with the score doubled;
* the split the kernel makes: outside the window k - 2i in [dlo - 1,
  dhi + 1] every pointer byte is ``wavefront_far_bytes_ref``'s rule of the
  letters alone, and ``window_width`` slots hold every window.

Exact equality: the work is integer DP.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seqalib_tpu as sa
import seqalib_tpu_torch as st
from seqalib_tpu.ops.wavefront_pallas import _fill as jax_fill
from seqalib_tpu.parallel.dispatch import sentinel_table
from seqalib_tpu.types import BLOSUM62
from seqalib_tpu.types import ScoringParams as JaxScoringParams
from seqalib_tpu_torch.ops import launches
from seqalib_tpu_torch.ops.wavefront import (wavefront_far_bytes_ref, wavefront_fill,
                                             wavefront_fill_ref, wavefront_inputs,
                                             window_ring, window_width)
from seqalib_tpu_torch.scoring import scoring_params

BAND = 6
WIDE = np.where(np.eye(4, dtype=bool), 20, -20).astype(np.int32)
SCORINGS = {  # name -> (JAX scoring, alphabet): both outside [-4, 11]
    "profile_2xblosum62": (JaxScoringParams(gap_open=-20, gap_extend=-2,
                                            matrix=2 * BLOSUM62), 20),
    "scalar_wide4": (JaxScoringParams(gap_open=-5, gap_extend=-2, matrix=WIDE), 4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them fast when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psp(jsp):
    return scoring_params(jsp.match, jsp.mismatch, jsp.gap_open, jsp.gap_extend, jsp.matrix)


def _mutated(rng, alpha, n, subs=4):
    """A query of n letters and a target with substitutions and indels."""
    q = rng.integers(0, alpha, n).astype(np.uint8)
    t = q.copy()
    if n > 12:
        t = np.insert(np.delete(t, [3, 4]), 8, rng.integers(0, alpha, 3))
        idx = rng.choice(len(t), subs, replace=False)
        t[idx] = rng.integers(0, alpha, subs)
    return q, t.astype(np.uint8)


def _bucket(alpha, seed, lens=(60, 41, 0, 55, 17)):
    """A (B, 64) x (B, 64) bucket of pairs, one of them empty."""
    rng = np.random.default_rng(seed)
    qs, ts = zip(*[_mutated(rng, alpha, n) for n in lens])
    q = np.zeros((len(qs), 64), np.int32)
    t = np.zeros((len(ts), 64), np.int32)
    for b, (a, c) in enumerate(zip(qs, ts)):
        q[b, : len(a)] = a
        t[b, : len(c)] = c
    return q, t, np.array([len(a) for a in qs]), np.array([len(c) for c in ts])


@pytest.fixture(scope="module", params=sorted(SCORINGS))
def fill_case(request):
    jsp, alpha = SCORINGS[request.param]
    q, t, qlen, tlen = _bucket(alpha, len(request.param))
    table = sentinel_table(jsp)
    jax = {}
    for want_tb in (True, False):
        res = jax_fill(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qlen),
                       jnp.asarray(tlen), jnp.asarray(table), mode="global",
                       match=int(table[0, 0]), mismatch=int(table[0, 1]),
                       gap_open=jsp.gap_open, gap_extend=jsp.gap_extend, band=BAND,
                       affine=True, want_tb=want_tb, profile=table.shape[0] > 8,
                       interpret=True)
        jax[want_tb] = {k: np.asarray(v) for k, v in res.items()}
    return dict(jsp=jsp, args=(q, t, qlen, tlen), jax=jax)


def _port_fill(case, want_ptr):
    q, t, qlen, tlen = case["args"]
    jsp = case["jsp"]
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, _psp(jsp))
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32)  # noqa: E731
    out = wavefront_fill(as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab),
                         K=tk.shape[1], band=BAND, gap_open=jsp.gap_open,
                         gap_extend=jsp.gap_extend, want_ptr=want_ptr)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("want_ptr", [True, False])
def test_fill_matches_the_jax_kernel(fill_case, want_ptr):
    q, t, qlen, tlen = fill_case["args"]
    jax = fill_case["jax"][want_ptr]
    before = dict(launches)
    got = _port_fill(fill_case, want_ptr)
    assert launches == before  # the CPU path runs the plain version
    np.testing.assert_array_equal(got["score"], jax["score"][np.arange(len(qlen)), qlen])
    if want_ptr:
        K = got["ptr"].shape[0]
        np.testing.assert_array_equal(got["ptr"], jax["P"][:K].view(np.uint8))
        # the bytes the walk reads: in-band cells of the matrix
        i = np.arange(got["ptr"].shape[2])
        for b in range(len(qlen)):
            for k in range(qlen[b] + tlen[b] + 1):
                j = k - i
                d = tlen[b] - qlen[b]
                cell = ((i <= qlen[b]) & (j >= 0) & (j <= tlen[b])
                        & (j - i >= min(0, d) - BAND) & (j - i <= max(0, d) + BAND))
                assert cell.any()
                np.testing.assert_array_equal(got["ptr"][k, b, cell],
                                              jax["P"][k, b, cell].view(np.uint8))
    else:
        assert sorted(got) == ["score"]


def _pairs(alpha, seed, B=7):
    rng = np.random.default_rng(seed)
    pairs = [_mutated(rng, alpha, int(n)) for n in rng.integers(0, 150, B)]
    pairs[0] = (pairs[0][0], pairs[0][1][:0])  # an empty target
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("traceback", [True, False])
@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_align_batch_wide_table_matches_jax_and_oracle(scoring, traceback):
    jsp, alpha = SCORINGS[scoring]
    qs, ts = _pairs(alpha, len(scoring))
    got = st.align_batch(qs, ts, scoring=_psp(jsp), mode="global", band=BAND,
                         traceback=traceback, device="cpu")
    jax = sa.align_batch(qs, ts, scoring=jsp, mode="global", band=BAND,
                         traceback=traceback, backend="pallas")
    assert [str(r) for r in got] == [str(r) for r in jax]
    want = [sa.align(q, t, scoring=jsp, mode="global", band=BAND, backend="oracle")
            for q, t in zip(qs, ts)]
    if traceback:
        assert [str(r) for r in got] == [str(r) for r in want]
        assert any("D" in r.cigar and "I" in r.cigar for r in got)
    else:
        assert [(r.score, r.cigar) for r in got] == [(w.score, "") for w in want]


def test_jax_scalar_route_misscores_small_nonuniform_tables():
    # the JAX kernel's scalar route (tables of <= 8 rows) scores every
    # mismatch table[0, 1] = -10, the A/G ones included (-30 in the table):
    # JAX returns 550 (32M) against the oracle's 538 (5M1D1I8M1D1I8M1D1I8M);
    # the port looks every score up, as the oracle (ROADMAP Queue 3)
    mat = np.array([[20, -10, -30, -30], [-10, 20, -30, -30], [-30, -30, 20, -10],
                    [-30, -30, -10, 20]], np.int32)
    jsp = JaxScoringParams(gap_open=-5, gap_extend=-2, matrix=mat)
    q = np.tile(np.arange(4, dtype=np.uint8), 8)
    t = q.copy()
    t[[5, 14, 23]] = (t[[5, 14, 23]] + 2) % 4  # mismatches that score -30
    want = sa.align(q, t, scoring=jsp, mode="global", band=5, backend="oracle")
    jax = sa.align_batch([q], [t], scoring=jsp, mode="global", band=5, backend="pallas")[0]
    got = st.align(q, t, scoring=_psp(jsp), mode="global", band=5, device="cpu")
    assert str(got) == str(want)
    assert (jax.score, jax.cigar, want.score) == (550, "32M", 538)


def test_jax_profile_route_rounds_large_entries():
    # the JAX kernel's profile banks are a bf16 one-hot product: 301 and
    # -299 round to even bf16 neighbours; the port keeps them exact
    mat = np.where(np.eye(10, dtype=bool), 301, -299).astype(np.int32)
    jsp = JaxScoringParams(gap_open=-50, gap_extend=-7, matrix=mat)
    q, t = _mutated(np.random.default_rng(4), 10, 30, subs=3)
    want = sa.align(q, t, scoring=jsp, mode="global", band=4, backend="oracle")
    jax = sa.align_batch([q], [t], scoring=jsp, mode="global", band=4, backend="pallas")[0]
    got = st.align(q, t, scoring=_psp(jsp), mode="global", band=4, device="cpu")
    assert str(got) == str(want)
    assert jax.score != want.score


def test_doubled_blosum62_equals_the_banded_route():
    """2 x BLOSUM62, o=-20, e=-2 (kernel 7's route) against BLOSUM62,
    o=-10, e=-1 (``band_fill``'s route): every comparison and tie scales
    by 2, so the coordinates and CIGARs agree and the score doubles."""
    qs, ts = _pairs(20, 11, B=6)
    one = _psp(JaxScoringParams.blosum62(gap_open=-10, gap_extend=-1))
    two = scoring_params(0, 0, -20, -2, 2 * BLOSUM62)
    a = st.align_batch(qs, ts, scoring=one, mode="global", band=16, device="cpu")
    b = st.align_batch(qs, ts, scoring=two, mode="global", band=16, device="cpu")
    for x, y in zip(a, b):
        assert (2 * x.score, x.query_start, x.query_end, x.target_start,
                x.target_end, x.cigar) == (y.score, y.query_start, y.query_end,
                                           y.target_start, y.target_end, y.cigar)


def test_wavefront_fill_refuses_bad_arguments():
    q = torch.zeros((2, 128), dtype=torch.int32)
    tab = torch.zeros((5, 5), dtype=torch.int32)
    v = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="K"):
        wavefront_fill(q, q[:, :10], v, v, tab, K=11, band=2, gap_open=-1,
                       gap_extend=-1, want_ptr=False)
    with pytest.raises(ValueError, match="tab"):
        wavefront_fill(q, q, v, v, torch.zeros((5, 4), dtype=torch.int32), K=3,
                       band=2, gap_open=-1, gap_extend=-1, want_ptr=False)
    with pytest.raises(ValueError, match="out of contract"):
        from seqalib_tpu_torch.parallel.dispatch import dispatch_batch

        dispatch_batch([np.zeros(3, np.uint8)], [np.zeros(3, np.uint8)],
                       _psp(SCORINGS["scalar_wide4"][0]), mode="local", band=3,
                       device=torch.device("cpu"))


def _window_split(q, t, qlen, tlen, psp, band):
    """The fill's pointer bytes, the far rule's, and the mask of the slots
    outside each pair's window (K, B, Np); also the widest window."""
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, psp)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32)  # noqa: E731
    K = tk.shape[1]
    kw = dict(K=K, gap_open=psp.gap_open, gap_extend=psp.gap_extend)
    full = wavefront_fill_ref(as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab),
                              band=band, want_ptr=True, **kw)["ptr"].numpy()
    far = wavefront_far_bytes_ref(as_t(qpad), as_t(tk), as_t(tab), **kw).numpy()
    d = np.asarray(tlen) - np.asarray(qlen)
    dlo = (np.minimum(0, d) - band)[None, :, None]
    dhi = (np.maximum(0, d) + band)[None, :, None]
    dkj = np.arange(K)[:, None, None] - 2 * np.arange(qpad.shape[1])[None, None, :]
    outside = (dkj < dlo - 1) | (dkj > dhi + 1)
    widest = int((~outside).sum(2).max())
    return full, far, outside, widest, int(np.abs(d).max()), qpad.shape[1]


def _check_split(case, band):
    full, far, outside, widest, span, Np = _window_split(*case, band)
    assert far.shape == full.shape and far.dtype == np.uint8
    # a band as wide as the slots leaves no slot outside the window
    assert outside.any() == (band < Np)
    np.testing.assert_array_equal(far[outside], full[outside])
    # the origin (in every window) is STOP with the far rule's extend bits
    assert (far[0, :, 0] & 3 == 0).all() and (far[0, :, 0] == full[0, :, 0]).all()
    assert window_width(span, band, Np) == widest


def test_far_bytes_equal_the_fill_outside_the_window(fill_case):
    q, t, qlen, tlen = fill_case["args"]
    _check_split((q, t, qlen, tlen, _psp(fill_case["jsp"])), BAND)


def _edge_case(name):
    """(q, t, qlen, tlen, scoring, band): pairs whose deltas pass the band,
    band 0, a band wider than the slots, a zero gap open."""
    rng = np.random.default_rng(len(name))
    two = scoring_params(0, 0, -20, -2, 2 * BLOSUM62)
    psp, band, spread = {
        "delta_beyond_band": (two, 3, 40),
        "band_0": (two, 0, 6),
        "band_over_slots": (two, 300, 20),
        "open_0": (scoring_params(0, 0, 0, -3, 2 * BLOSUM62), 9, 25),
        "scalar_wide4": (_psp(SCORINGS["scalar_wide4"][0]), 5, 30),
    }[name]
    alpha = 4 if name == "scalar_wide4" else 20
    B, n = 5, 70
    qlen = rng.integers(1, n + 1, B)
    tlen = np.clip(qlen + rng.integers(-spread, spread + 1, B), 0, n)
    qlen[0] = n
    q = rng.integers(0, alpha, (B, n)).astype(np.int32)
    t = rng.integers(0, alpha, (B, n)).astype(np.int32)
    t[:, 2:40] = q[:, 1:39]
    return (q, t, qlen, tlen, psp), band


@pytest.mark.parametrize("name", ["delta_beyond_band", "band_0", "band_over_slots",
                                  "open_0", "scalar_wide4"])
def test_far_bytes_equal_the_fill_outside_the_window_at_the_edges(name):
    case, band = _edge_case(name)
    if name == "delta_beyond_band":
        assert np.abs(case[3] - case[2]).max() > band
    if name == "band_over_slots":
        assert band >= wavefront_inputs(*case)[0].shape[1]
    _check_split(case, band)


@pytest.mark.parametrize("width,NT,want", [
    (1, 23, (4, True)),
    (66, 23, (128, True)),         # the wide-table cell: band 64
    (126, 23, (128, True)),
    (127, 66, (256, True)),
    (384, 23, (512, True)),        # a band over 384 slots
    (1024, 23, (2048, True)),
    (20_000, 23, (32_768, False)),  # rows in global memory
])
def test_window_ring_holds_the_window_and_picks_its_memory(width, NT, want):
    R, rows_in_smem = window_ring(width, NT)
    assert (R, rows_in_smem) == want
    # the ring holds the window and the two slots around it
    assert R >= width + 2 and R & (R - 1) == 0


def test_window_width_never_passes_the_slots():
    assert window_width(0, 64, 1024) == 66
    assert window_width(10, 64, 1024) == 71
    assert window_width(0, 10_000, 1024) == 1024
