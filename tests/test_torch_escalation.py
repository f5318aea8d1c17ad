"""Escalation parity: with a pass-2 row window of WR=128, pairs whose
alignment spans more rows miss their score in pass 2 and escalate to the
widening host rescan (``reverse_starts``), and their CIGARs are rebuilt.
The port (plain kernel versions on the CPU) must escalate the same pairs
as the JAX ``strip_bucket`` under ``SEQALIB_FUSED_WR=128``, with pass 2 on
the strip engine and on the default banded engine, and return the same
results.  Exact equality.

Kept apart from ``test_torch_slice.py`` so that each file's JAX
interpret-mode compiles stay within its time budget."""

import numpy as np
import pytest
import torch

from seqalib_tpu import oracle_fast
from seqalib_tpu.ops import strip_pallas
from seqalib_tpu.parallel.dispatch import sentinel_table
from seqalib_tpu.types import ScoringParams
from seqalib_tpu_torch.ops import strip as port_strip
from seqalib_tpu_torch.scoring import scoring_params, tables_from_params

KEYS = ("score", "qs", "qe", "ts", "te", "cigars")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them fast when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, L = 8, 300
SP = ScoringParams.blosum62(gap_open=-10, gap_extend=-1)
PORT_SP = scoring_params(0, 0, SP.gap_open, SP.gap_extend, SP.matrix)


def _esc_batch():
    rng = np.random.default_rng(13)
    q = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    t = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    t[:, 40:120] = q[:, 60:140]  # 80-residue span: inside the window
    t[5] = q[5]                  # 300-residue span: escalates
    t[6, 20:230] = q[6, 30:240]  # 210-residue span: escalates
    qlen = np.full(B, L)
    tlen = np.full(B, L)
    qlen[3] = 140
    tlen[4] = 90
    return q, t, qlen, tlen


def _spy(calls, fn):
    def wrapped(q, t, score, *args, **kwargs):
        calls.append(np.nonzero(np.asarray(score) > 0)[0].tolist())
        return fn(q, t, score, *args, **kwargs)
    return wrapped


def _jax_escalation(pass2):
    q, t, qlen, tlen = _esc_batch()
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEQALIB_FUSED_PASS2", pass2)
        mp.setenv("SEQALIB_FUSED_WR", "128")
        mp.setattr(strip_pallas, "_reverse_starts",
                   _spy(calls, strip_pallas._reverse_starts))
        out = strip_pallas.strip_bucket(
            q, t, qlen, tlen, sentinel_table(SP), mode="local",
            gap_open=SP.gap_open, gap_extend=SP.gap_extend, affine=True,
            want_tb=True,
        )
    return out, calls


def _port_escalation(pass2):
    """The port at WR=128 on the same batch, with ``reverse_starts``
    watched the same way."""
    q, t, qlen, tlen = _esc_batch()
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_strip, "reverse_starts", _spy(calls, port_strip.reverse_starts))
        out = port_strip.strip_bucket(q, t, qlen, tlen,
                                      tables_from_params(PORT_SP, "cpu"),
                                      mode="local", want_tb=True, WR=128, pass2=pass2)
    return out, calls


@pytest.fixture(scope="module")
def jax_run():
    return _jax_escalation("strip")


@pytest.fixture(scope="module")
def port_run():
    return _port_escalation("strip")


@pytest.fixture(scope="module")
def jax_run_banded():
    return _jax_escalation("banded")


@pytest.fixture(scope="module")
def port_run_banded():
    return _port_escalation("banded")


def test_same_pairs_escalate(jax_run, port_run):
    (_, jax_calls), (out, calls) = jax_run, port_run
    assert jax_calls == [[5, 6]]
    assert calls == [[5, 6]]
    assert np.nonzero(out["escalated"])[0].tolist() == [5, 6]


def test_escalated_results_match_jax_and_oracle(jax_run, port_run):
    (jax_out, _), (out, _) = jax_run, port_run
    q, t, qlen, tlen = _esc_batch()
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(jax_out[k]), err_msg=k)
    assert out["cigars"][5] == "300M"
    for b in range(B):
        o = oracle_fast.align_oracle(q[b, : qlen[b]], t[b, : tlen[b]], SP, mode="local")
        assert (out["score"][b], out["qs"][b], out["qe"][b], out["ts"][b],
                out["te"][b], out["cigars"][b]) == (
            o.score, o.query_start, o.query_end, o.target_start, o.target_end, o.cigar
        ), b


def test_banded_engine_escalates_the_same_pairs(jax_run_banded, port_run_banded):
    (_, jax_calls), (out, calls) = jax_run_banded, port_run_banded
    assert calls == jax_calls == [[5, 6]]
    assert np.nonzero(out["escalated"])[0].tolist() == [5, 6]


def test_banded_engine_results_match_jax_and_strip(jax_run_banded, port_run_banded,
                                                   port_run):
    (jax_out, _), (out, _) = jax_run_banded, port_run_banded
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(jax_out[k]), err_msg=k)
        # no co-optimal ties in this batch: both engines give the oracle's
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(port_run[0][k]),
                                      err_msg=k)


def test_default_window_escalates_nothing_here():
    # the default engine (banded) at the default window
    q, t, qlen, tlen = _esc_batch()
    out = port_strip.strip_bucket(q, t, qlen, tlen, tables_from_params(PORT_SP, "cpu"),
                                  mode="local", want_tb=False)
    assert not out["escalated"].any()
    assert "cigars" not in out


def test_default_window_escalates_nothing_on_the_strip_engine():
    q, t, qlen, tlen = _esc_batch()
    out = port_strip.strip_bucket(q, t, qlen, tlen, tables_from_params(PORT_SP, "cpu"),
                                  mode="local", want_tb=False, pass2="strip")
    assert not out["escalated"].any()


def test_pointer_budget_routes_through_host_windows(port_run, monkeypatch):
    # a budget below one pair's pointer matrix: pass 3 runs on host-cut
    # windows, and the global bucket chunks them (>= 32 pairs per call)
    q, t, qlen, tlen = _esc_batch()
    tables = tables_from_params(PORT_SP, "cpu")
    monkeypatch.setenv("SEQALIB_FUSED_PASS2", "strip")
    monkeypatch.setenv("SEQALIB_PTR_HBM_CAP", "1000")
    windowed = port_strip.strip_bucket(q, t, qlen, tlen, tables, mode="local",
                                       want_tb=True, WR=128)
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(windowed[k]), np.asarray(port_run[0][k]),
                                      err_msg=k)
    qq = np.tile(q[:, :30], (5, 1))
    tt = np.tile(t[:, :40], (5, 1))
    ql, tl = np.full(40, 30), np.full(40, 40)
    chunked = port_strip.strip_bucket(qq, tt, ql, tl, tables, mode="global", want_tb=True)
    monkeypatch.delenv("SEQALIB_PTR_HBM_CAP")
    whole = port_strip.strip_bucket(qq, tt, ql, tl, tables, mode="global", want_tb=True)
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(chunked[k]), np.asarray(whole[k]), err_msg=k)


# fault 8 (ROADMAP Queue 3): short local pairs under DNA affine scoring times
# 2^k near int32's range (|o| + (n + m) max(|e|, |s|) <= 2^29); pass 2's
# window is sized by the bucket, not the pair
FAULT_8 = [(np.array([3], np.uint8), np.array([3, 3], np.uint8), 25),
           (np.array([2, 2, 3, 0, 3, 2, 0], np.uint8), np.array([3, 0, 1, 0, 3], np.uint8), 23)]


def _scaled(shift):
    s = 1 << shift
    return ScoringParams(match=2 * s, mismatch=-3 * s, gap_open=-5 * s, gap_extend=-2 * s)


@pytest.mark.parametrize("traceback", [True, False])
@pytest.mark.parametrize("case", range(len(FAULT_8)))
def test_fault_8_pass2_window_near_int32_range_follows_the_oracle(case, traceback):
    """The banded pass-2 engine (``band_fill`` in emode) fills its whole
    window unmasked: past the pair, H sank by a gap or a mismatch a diagonal,
    below -2^31 at this scale, and the kernel's int32 wrapped (the card
    raised in pass 3's row window; the JAX package's pass 2 loses the score).
    The plain version computes in int64 but hands its state back in int32,
    where it wrapped the same way.  Now H is floored at ``EMODE_FLOOR``: the
    H stays inside [EMODE_FLOOR, score], no value wraps and the result is
    the oracle's."""
    import seqalib_tpu_torch as st
    from seqalib_tpu_torch.ops import band_fill as bf_mod
    from seqalib_tpu_torch.oracle_fast import align_oracle

    q, t, shift = FAULT_8[case]
    sp = _scaled(shift)
    psp = scoring_params(sp.match, sp.mismatch, sp.gap_open, sp.gap_extend, None)
    states = []

    def spy(*a, **kw):
        out = bf_mod.band_fill(*a, **kw)
        states.append(out["state"])
        return out

    want = align_oracle(q, t, sp, mode="local")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_strip, "band_fill", spy)
        got = st.api.align_batch([q], [t], scoring=psp, mode="local", traceback=traceback,
                                 device="cpu")[0]
    assert states  # the banded engine ran
    for s in states:  # H of the last two diagonals; no value wrapped to the top
        assert int(s[:2].min()) >= bf_mod.EMODE_FLOOR
        assert int(s[:4].max()) <= want.score
    assert str(got) == str(want) if traceback else (
        (got.score, got.query_start, got.query_end, got.target_start, got.target_end)
        == (want.score, want.query_start, want.query_end, want.target_start, want.target_end))


def test_fault_8_jax_pass2_loses_the_local_score():
    """The JAX package on fault 8's first pair: its int32 pass 2 wraps and
    ``strip_bucket`` gives up (the port follows the oracle instead)."""
    q, t, shift = FAULT_8[0]
    sp = _scaled(shift)
    with pytest.raises(AssertionError, match="reverse extension lost the local score"):
        strip_pallas.strip_bucket(q[None].astype(np.int32), t[None].astype(np.int32),
                                  np.array([len(q)]), np.array([len(t)]), sentinel_table(sp),
                                  mode="local", gap_open=sp.gap_open,
                                  gap_extend=sp.gap_extend, affine=True, want_tb=False)


# fault 9 (ROADMAP Queue 3): the pass-2 row window (SEQALIB_FUSED_WR, rounded up
# to 128) and the banded engine's half-width (SEQALIB_FUSED_BW) come from the
# environment in both packages; the port used to fix them at 512 and 64.
# Pair 5 spans 300 rows (past a window of 256), pair 7 holds a 45-letter net
# gap over 100 rows (past a band of 32, inside the window)
KNOBS = [("SEQALIB_FUSED_WR", "256", [5]), ("SEQALIB_FUSED_BW", "32", [7])]


def _knob_batch():
    q, t, qlen, tlen = _esc_batch()
    t[6] = np.random.default_rng(14).integers(0, 20, size=L)
    t[6, 40:120] = q[6, 60:140]
    t[7, 20:70] = q[7, 100:150]
    t[7, 115:165] = q[7, 150:200]
    return q, t, qlen, tlen


@pytest.fixture(scope="module", params=KNOBS, ids=[k[0] for k in KNOBS])
def knob_runs(request):
    """Both packages on ``_knob_batch`` under one knob, the default banded
    engine: (knob, JAX result and escalations, port result and escalations)."""
    var, value, _ = request.param
    q, t, qlen, tlen = _knob_batch()
    jax_calls, port_calls = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(var, value)
        mp.delenv("SEQALIB_FUSED_PASS2", raising=False)
        mp.setattr(strip_pallas, "_reverse_starts",
                   _spy(jax_calls, strip_pallas._reverse_starts))
        mp.setattr(port_strip, "reverse_starts", _spy(port_calls, port_strip.reverse_starts))
        jax_out = strip_pallas.strip_bucket(
            q, t, qlen, tlen, sentinel_table(SP), mode="local", gap_open=SP.gap_open,
            gap_extend=SP.gap_extend, affine=True, want_tb=True)
        out = port_strip.strip_bucket(q, t, qlen, tlen, tables_from_params(PORT_SP, "cpu"),
                                      mode="local", want_tb=True)
    return request.param, (jax_out, jax_calls), (out, port_calls)


def test_fault_9_pass2_knobs_escalate_the_pairs_jax_escalates(knob_runs):
    """Under SEQALIB_FUSED_WR=256 and under SEQALIB_FUSED_BW=32 the port
    escalates exactly the pairs the JAX package escalates (none at the
    defaults), and returns its results."""
    (_, _, want), (jax_out, jax_calls), (out, calls) = knob_runs
    assert jax_calls == [want]
    assert calls == [want]
    assert np.nonzero(out["escalated"])[0].tolist() == want
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(jax_out[k]), err_msg=k)


def test_fault_9_knobs_are_read_as_the_jax_package_reads_them(monkeypatch):
    from seqalib_tpu.ops.strip_pallas import fused_pass2_knobs, fused_wr

    assert port_strip.pass2_knobs() == {"pass2": "banded", "tie_safe": False, "WR": 512,
                                        "BW": 64}
    monkeypatch.setenv("SEQALIB_FUSED_WR", "300")
    monkeypatch.setenv("SEQALIB_FUSED_BW", "40")
    knobs = port_strip.pass2_knobs()
    assert (knobs["WR"], knobs["BW"]) == (fused_wr(), fused_pass2_knobs(True)["bw"]) == (384, 40)


def test_fault_9_knobs_reach_every_shard_of_a_pair_mesh(knob_runs, monkeypatch):
    """The bucket sharded over a pair mesh of two CPU shards (pairs 0-3 and
    4-7, ``strip_sharded``): the knobs reach both, the escalated pair is
    the second shard's, and the results are the one-device run's."""
    from seqalib_tpu_torch.parallel.dist import make_pair_mesh, strip_sharded

    (var, value, want), _, (one, _) = knob_runs
    q, t, qlen, tlen = _knob_batch()
    monkeypatch.setenv(var, value)
    calls = []
    monkeypatch.setattr(port_strip, "reverse_starts", _spy(calls, port_strip.reverse_starts))
    out = strip_sharded(make_pair_mesh(["cpu"] * 2), q, t, qlen, tlen, PORT_SP, mode="local",
                        want_tb=True)
    assert calls == [[w - 4 for w in want]]
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(one[k]), err_msg=k)


def test_fault_9_a_band_of_128_closes_the_pinned_tie_in_both_packages(monkeypatch):
    """``tests/test_fused_tie_boundary.py``'s tie: its canonical cell lies 70
    diagonals off the anchor, outside the default band of 64, where the
    banded engine returns the in-band start (0, 35).  Under
    SEQALIB_FUSED_BW=128 both packages see it and return (35, 0); the port
    used to keep its band of 64 and return the other start."""
    from test_fused_tie_boundary import _tie_problem

    q, t, sp = _tie_problem()
    psp = scoring_params(0, 0, sp.gap_open, sp.gap_extend, sp.matrix)
    args = (q[None].astype(np.int32), t[None].astype(np.int32), np.array([len(q)]),
            np.array([len(t)]))
    monkeypatch.setenv("SEQALIB_FUSED_PASS2", "banded")
    monkeypatch.setenv("SEQALIB_FUSED_BW", "128")
    jax_out = strip_pallas.strip_bucket(*args, sentinel_table(sp), mode="local",
                                        gap_open=sp.gap_open, gap_extend=sp.gap_extend,
                                        affine=False)
    out = port_strip.strip_bucket(*args, tables_from_params(psp, "cpu"), mode="local")
    for got in (jax_out, out):
        assert tuple(int(got[k][0]) for k in ("score", "qs", "qe", "ts", "te")) == (
            84, 35, 49, 0, 84)
