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
