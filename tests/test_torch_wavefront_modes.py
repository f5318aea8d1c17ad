"""Port parity for every mode of kernel 7 (``_fill_kernel``):
``seqalib_tpu_torch.ops.wavefront.wavefront_fill`` (its plain version, on
the CPU) against the JAX ``wavefront_pallas._fill`` in interpret mode.

* the six modes the ``"xla"`` route launches, unbanded: global linear and
  affine, with pointers and score-only; local linear and affine,
  score-only (with start propagation), on the JAX kernel's scalar route
  (a uniform DNA table) and its profile route (BLOSUM62): every output
  exactly (score or the per-slot ``bv``/``bk``/``bs``, and every byte of
  the (K, B, Np) pointer stream, the slots outside the matrix included);
* the modes no entry point reaches (local with pointers, local with a
  band, linear with a band), the same way, each on one of the two routes;
* the one departure: in local affine mode the JAX kernel computes E of
  column 0 from the slots with j < 0, which score target letter 0, so the
  two agree exactly where the queries hold no letter scoring above 0
  against letter 0 (every test of a local affine mode draws its queries
  so, and says so); on any letters the port's per-slot bests equal the
  JAX ``"xla"`` route's fill (``wavefront_xla._scan_fill``, which scores
  those slots 0), and a pinned pair shows the JAX kernel's fault;
* each mode's far-byte rule (``wavefront_far_bytes_ref``) against the
  fill outside the band's window.

Exact equality: the work is integer DP.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqalib_tpu.ops.wavefront_pallas import _fill as jax_fill
from seqalib_tpu.ops.wavefront_xla import _scan_fill
from seqalib_tpu.parallel.dispatch import sentinel_table
from seqalib_tpu.types import BLOSUM62
from seqalib_tpu.types import ScoringParams as JaxScoringParams
from seqalib_tpu_torch.ops import launches
from seqalib_tpu_torch.ops.wavefront_xla import local_end
from seqalib_tpu_torch.ops import wavefront as wf_mod
from seqalib_tpu_torch.ops.wavefront import (fill_kernel, launch_key, strip_columns,
                                             wavefront_far_bytes_ref, wavefront_fill,
                                             wavefront_fill_ref, wavefront_inputs,
                                             wavefront_strip_geometry,
                                             wavefront_strip_ptr_geometry, window_rows)
from seqalib_tpu_torch.scoring import scoring_params
from seqalib_tpu_torch.types import encode_dna

B, N, M = 8, 60, 64
BAND = 5
SCORINGS = {  # name -> (JAX scoring, alphabet, query letters free of the E leak)
    "scalar_dna": (JaxScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2), 4,
                   (1, 2, 3)),
    "profile_blosum62": (JaxScoringParams(gap_open=-10, gap_extend=-1, matrix=BLOSUM62), 20,
                         tuple(x for x in range(20) if BLOSUM62[x, 0] <= 0)),
}
# (mode, affine, want_ptr, band): the route's six, then the unreached ones
ROUTE_MODES = [("global", False, True, None), ("global", False, False, None),
               ("global", True, True, None), ("global", True, False, None),
               ("local", True, False, None), ("local", False, False, None)]
OTHER_MODES = [("local", True, True, None), ("local", False, True, None),
               ("global", False, True, BAND), ("global", False, False, BAND),
               ("local", True, False, BAND), ("local", False, True, BAND)]
# each unreached mode on one of the two routes, in turns (the file's time)
OTHER_CASES = [(name, m) for m, name in zip(OTHER_MODES, sorted(SCORINGS) * 3)]


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


def _bucket(alpha, seed, letters=None):
    """A (B, N) x (B, M) bucket: one pair of full width, one empty query,
    targets sharing a run of their query; queries drawn from ``letters``."""
    rng = np.random.default_rng(seed)
    letters = np.arange(alpha) if letters is None else np.asarray(letters)
    qlen = rng.integers(1, N + 1, B)
    tlen = rng.integers(1, M + 1, B)
    qlen[0], tlen[0], qlen[1] = N, M, 0
    q = np.zeros((B, N), np.int32)
    t = np.zeros((B, M), np.int32)
    for b in range(B):
        q[b, : qlen[b]] = rng.choice(letters, qlen[b])
        t[b, : tlen[b]] = rng.integers(0, alpha, tlen[b])
        k = min(qlen[b] - 1, tlen[b] - 3) // 2
        if k > 0:
            t[b, 3: 3 + k] = q[b, 1: 1 + k]
    return q, t, qlen, tlen


def _leak_free(mode, affine):
    return mode == "local" and affine


@functools.lru_cache(maxsize=None)
def _case(name):
    """The scoring's two buckets (any query letters, and leak-free ones)."""
    jsp, alpha, free = SCORINGS[name]
    return dict(jsp=jsp, any=_bucket(alpha, 1), free=_bucket(alpha, 2, free))


@pytest.fixture(scope="module", params=sorted(SCORINGS))
def case(request):
    return _case(request.param)


def _jax(case, mode, affine, want_ptr, band):
    jsp = case["jsp"]
    q, t, qlen, tlen = case["free" if _leak_free(mode, affine) else "any"]
    table = sentinel_table(jsp)
    res = jax_fill(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qlen), jnp.asarray(tlen),
                   jnp.asarray(table), mode=mode, match=int(table[0, 0]),
                   mismatch=int(table[0, 1]), gap_open=jsp.gap_open,
                   gap_extend=jsp.gap_extend, band=band, affine=affine, want_tb=want_ptr,
                   profile=table.shape[0] > 8, interpret=True)
    return {k: np.asarray(v) for k, v in res.items()}


def _port(case, mode, affine, want_ptr, band, inputs=None, ref=False):
    jsp = case["jsp"]
    q, t, qlen, tlen = inputs or case["free" if _leak_free(mode, affine) else "any"]
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, _psp(jsp))
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32)  # noqa: E731
    fill = wavefront_fill_ref if ref else wavefront_fill
    out = fill(as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab), K=tk.shape[1],
               band=band, gap_open=jsp.gap_open, gap_extend=jsp.gap_extend,
               want_ptr=want_ptr, mode=mode, affine=affine, stride=t.shape[1] + 1)
    return {k: v.numpy() for k, v in out.items()}


def _assert_equal_to_jax(case, wf_mode):
    mode, affine, want_ptr, band = wf_mode
    jax = _jax(case, *wf_mode)
    before = dict(launches)
    got = _port(case, *wf_mode)
    assert launches == before  # the CPU path runs the plain version
    qlen = case["free" if _leak_free(mode, affine) else "any"][2]
    if mode == "local":
        assert sorted(got) == sorted(["bv", "bk"] + (["ptr"] if want_ptr else ["bs"]))
        np.testing.assert_array_equal(got["bv"], jax["score"])
        np.testing.assert_array_equal(got["bk"], jax["bk"])
        if not want_ptr:
            np.testing.assert_array_equal(got["bs"], jax["bs"])
        assert got["bv"].max() > 0
    else:
        np.testing.assert_array_equal(got["score"], jax["score"][np.arange(B), qlen])
    if want_ptr:
        K = got["ptr"].shape[0]
        assert K == N + M + 1
        np.testing.assert_array_equal(got["ptr"], jax["P"][:K].view(np.uint8))
        if not affine:  # 2-bit pointers
            assert (got["ptr"] < 4).all()


def _mode_id(m):
    mode, affine, ptr, band = m
    return (f"{mode}-{'affine' if affine else 'linear'}-{'ptr' if ptr else 'score'}"
            + ("-band" if band is not None else ""))


@pytest.mark.parametrize("wf_mode", ROUTE_MODES, ids=_mode_id)
def test_route_modes_match_the_jax_kernel(case, wf_mode):
    _assert_equal_to_jax(case, wf_mode)


@pytest.mark.parametrize("name,wf_mode", OTHER_CASES,
                         ids=[f"{n}-{_mode_id(m)}" for n, m in OTHER_CASES])
def test_unreached_modes_match_the_jax_kernel(name, wf_mode):
    _assert_equal_to_jax(_case(name), wf_mode)


@pytest.mark.parametrize("affine", [True, False])
def test_local_ends_on_any_letters_equal_the_xla_fill(case, affine):
    """On queries of any letters the canonical ends of the port's local
    fill (``wavefront_xla.local_end`` of its per-slot bests) equal the JAX
    ``"xla"`` route's local fill (``_scan_fill``, its slots with j < 0
    scoring 0): score, i and j of every pair."""
    jsp = case["jsp"]
    q, t, qlen, tlen = case["any"]
    got = _port(case, "local", affine, False, None, inputs=case["any"])
    ends = local_end(torch.as_tensor(got["bv"]), torch.as_tensor(got["bk"]), N + 1)
    ref = _scan_fill(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qlen), jnp.asarray(tlen),
                     jnp.asarray(sentinel_table(jsp)), kind="local", gap_open=jsp.gap_open,
                     gap_extend=jsp.gap_extend, band=None, affine=affine, want_tb=False)
    for x, key in zip(ends, ("score", "bi", "bj")):
        np.testing.assert_array_equal(x.numpy(), np.asarray(ref[key]), err_msg=key)
    assert ends[0].max() > 0 and not got["bv"][:, N + 1:].any()


def test_jax_local_affine_fill_reads_column_0_e_from_the_junk_slots():
    """The fault the port departs from (ROADMAP Queue 3): a query of 30 A's
    then CG against ACCGTT, local affine DNA.  The JAX kernel's E of column
    0 comes from slots with j < 0, which score target letter A against the
    query's A's; that junk reaches column 1 and gives a best of 21.  The
    oracle's score is 4 (2M); the port's fill gives 4."""
    jsp = JaxScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
    q = np.zeros((B, 32), np.int32)
    t = np.zeros((B, 6), np.int32)
    q[:] = encode_dna("A" * 30 + "CG")
    t[:] = encode_dna("ACCGTT")
    inputs = (q, t, np.full(B, 32), np.full(B, 6))
    case = dict(jsp=jsp, any=inputs, free=inputs)
    jax = _jax(case, "local", True, False, None)
    got = _port(case, "local", True, False, None)
    assert jax["score"][0].max() == 21
    assert got["bv"][0].max() == 4
    # linear gaps have no E: the JAX kernel is right there
    assert _jax(case, "local", False, False, None)["score"][0].max() == 4


def _window_split(case, mode, affine):
    """The banded fill's pointer bytes, the far rule's, and the mask of the
    slots outside each pair's window (K, B, Np)."""
    jsp = case["jsp"]
    q, t, qlen, tlen = case["free" if _leak_free(mode, affine) else "any"]
    full = _port(case, mode, affine, True, BAND, ref=True)["ptr"]
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, _psp(jsp))
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32)  # noqa: E731
    K = tk.shape[1]
    far = wavefront_far_bytes_ref(as_t(qpad), as_t(tk), as_t(tab), K=K,
                                  gap_open=jsp.gap_open, gap_extend=jsp.gap_extend,
                                  mode=mode, affine=affine).numpy()
    d = tlen - qlen
    dlo = (np.minimum(0, d) - BAND)[None, :, None]
    dhi = (np.maximum(0, d) + BAND)[None, :, None]
    dkj = np.arange(K)[:, None, None] - 2 * np.arange(qpad.shape[1])[None, None, :]
    return full, far, (dkj < dlo - 1) | (dkj > dhi + 1)


@pytest.mark.parametrize("mode,affine", [("global", True), ("global", False),
                                         ("local", True), ("local", False)])
def test_far_bytes_equal_the_fill_outside_the_window(case, mode, affine):
    full, far, outside = _window_split(case, mode, affine)
    assert far.shape == full.shape and far.dtype == np.uint8 and outside.any()
    np.testing.assert_array_equal(far[outside], full[outside])
    assert (far[0, :, 0] & 3 == 0).all() and (far[0, :, 0] == full[0, :, 0]).all()
    if mode == "local":  # a local far slot is STOP
        assert (far & 3 == 0).all()
    if not affine:  # no extend bits
        assert (far < 4).all()


def test_launch_keys_and_ring_rows():
    assert [launch_key(*m[:3]) for m in ROUTE_MODES] == [
        "wavefront_fill/lin_ptr", "wavefront_fill/lin_score", "wavefront_fill/ptr",
        "wavefront_fill/score", "wavefront_fill/local", "wavefront_fill/local_lin"]
    assert launch_key("local", True, True) == "wavefront_fill/local_ptr"
    assert launch_key("local", False, True) == "wavefront_fill/local_lin_ptr"
    assert all(launch_key(*m[:3]) in launches for m in ROUTE_MODES + OTHER_MODES)
    assert [window_rows(*m[:3]) for m in ROUTE_MODES] == [3, 3, 6, 6, 12, 6]
    assert window_rows("local", True, True) == 6


@pytest.mark.parametrize("mode,affine,want_ptr,band", ROUTE_MODES + OTHER_MODES,
                         ids=lambda x: str(x))
def test_the_kernel_each_flag_set_launches(mode, affine, want_ptr, band):
    """On the card an unbanded score-only fill runs the strip kernel, an
    unbanded global fill with pointers the pointer strip kernel, every
    other flag set (a band, or local pointers) the window kernels."""
    if band is None and not want_ptr:
        want = "strip"
    elif band is None and mode == "global":
        want = "strip_ptr"
    else:
        want = "window"
    assert fill_kernel(band, want_ptr, mode) == want
    if mode == "global":  # the default mode
        assert fill_kernel(band, want_ptr) == want


@pytest.mark.parametrize("Np,NT,cols,mode,affine,budget,want", [
    # config 3's pass (a): every piece in shared memory, 16-byte columns
    (1152, 23, 1152, "local", True, None, (8, 53892, True, True)),
    # the columns past the budget: the wrap row goes to global memory
    (1152, 23, 2049, "local", True, None, (8, 39048, True, False)),
    (1152, 23, 1152, "local", True, 0, (8, 30852, False, False)),
    # config 2's fullest bucket and config 1: 8-byte columns
    (768, 7, 1368, "local", False, None, (8, 31012, True, True)),
    (384, 7, 384, "global", False, None, (8, 19204, True, True)),
    (384, 23, 384, "global", True, None, (8, 21124, True, True)),
    # a warp per 32 rows below 8 strips, one warp for rows 1 .. 32
    (128, 7, 200, "global", True, None, (4, 8804, True, True)),
    (33, 7, 50, "local", True, None, (1, 1260, True, True)),
])
def test_strip_geometry(Np, NT, cols, mode, affine, budget, want, monkeypatch):
    """(warps, shared bytes, letters shared, wrap row shared) of the strip
    kernel: (warps - 1) rings of 256 columns, the table and 16 counters,
    then the letters (4 bytes a column) and the wrap row (16 or 8) while
    they fit in STRIP_SMEM_BUDGET."""
    if budget is not None:
        monkeypatch.setattr(wf_mod, "STRIP_SMEM_BUDGET", budget)
    assert wavefront_strip_geometry(Np, NT, cols, mode, affine) == want


@pytest.mark.parametrize("Np,NT,K,affine,budget,want", [
    # config 3's pass (c) windows: rings, table, counters, letters, two wrap rows
    (512, 23, 891, True, None, (8, 34352, True, True)),
    # config 1 with CIGARs: 4-byte entries
    (384, 7, 513, False, None, (8, 13592, True, True)),
    # a long window: the letters fit, the wrap rows go to global memory
    (512, 23, 3000, True, None, (8, 28516, True, False)),
    (512, 23, 891, True, 0, (8, 16516, False, False)),
    # a warp per 32 slots below 8 strips; one warp for 32 slots or fewer
    (70, 7, 90, True, None, (3, 6172, True, True)),
    (32, 7, 40, False, None, (1, 748, True, True)),
])
def test_strip_ptr_geometry(Np, NT, K, affine, budget, want, monkeypatch):
    """(warps, shared bytes, letters shared, wrap rows shared) of the
    pointer strip kernel: (warps - 1) rings of 256 entries (8 bytes affine,
    4 linear), the table and 16 counters, then the letters (4 bytes a
    column) and the two wrap rows of K + 1 entries while they fit in
    STRIP_SMEM_BUDGET; warps = min(8, ceil(Np / 32))."""
    if budget is not None:
        monkeypatch.setattr(wf_mod, "STRIP_SMEM_BUDGET", budget)
    assert wavefront_strip_ptr_geometry(Np, NT, K, affine) == want
    assert wf_mod.wavefront_strip_ptr_warps(Np) == want[0]


@pytest.mark.parametrize("K,Np,span,want", [(2049, 1152, None, 2049), (2049, 1152, 0, 1152),
                                            (1409, 768, 600, 1368), (100, 1152, 5, 100),
                                            (3, 128, 0, 3)])
def test_strip_columns_follow_the_span(K, Np, span, want):
    """The strip kernel's target columns: K, cut to Np + span when the
    caller bounds |tlen - qlen| (a query of at most Np - 1 letters)."""
    assert strip_columns(K, Np, span) == want


def test_local_score_only_needs_a_stride():
    x = torch.zeros((1, 128), dtype=torch.int32)
    v = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="stride"):
        wavefront_fill(x, x, v, v, torch.zeros((4, 4), dtype=torch.int32), K=3, band=None,
                       gap_open=-1, gap_extend=-1, want_ptr=False, mode="local")
    with pytest.raises(ValueError, match="mode"):
        wavefront_fill(x, x, v, v, torch.zeros((4, 4), dtype=torch.int32), K=3, band=None,
                       gap_open=-1, gap_extend=-1, want_ptr=True, mode="extension")
