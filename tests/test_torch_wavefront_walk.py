"""The wide-table route's walk and launch half on the CPU
(``seqalib_tpu_torch.ops.wavefront_walk``, ``ops.wavefront.wavefront_launch``)
against the JAX package's three walks over the same pointer streams:
``wavefront_pallas._host_traceback_affine`` (+ ``ops_to_cigar``),
``wavefront_xla._global_walk`` and, where its C++ library builds,
``native.walk_to_cigars``:

* on the streams of the JAX ``_fill`` in interpret mode, at
  ``test_torch_wavefront.py``'s fill cases (its two scorings, a bucket of
  5 pairs with an empty one, band 6);
* on random walkable affine fields built as ``tests/test_native.py``
  builds them, a field per pair, with the extend bits next to row 0 and
  column 0 cleared so that every walk ends at (0, 0);
* ``wavefront_launch(...)()`` against the parent's bucket (the fill's
  plain version walked by ``_host_traceback_affine`` and encoded by
  ``op_rows_to_cigars``) and JAX ``align_batch(backend="pallas")``, with
  and without CIGARs, and at the stream's edges: ``qlen`` 0, ``tlen`` 0
  and a pair whose last slot is Np - 1;
* a start cell outside the stream raises the walk's ``ValueError`` at the
  finalize (``cigars_from_text``), as ``strip_walk``'s does;
* ``dispatch_batch`` and ``wavefront_sharded`` launch every wide bucket or
  shard before they finalize any.

Exact equality throughout: the walk is integer bookkeeping."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seqalib_tpu as sa
import seqalib_tpu_torch as st
from seqalib_tpu import native
from seqalib_tpu.ops.wavefront_pallas import _fill as jax_fill
from seqalib_tpu.ops.wavefront_pallas import _host_traceback_affine
from seqalib_tpu.ops.wavefront_xla import _global_walk
from seqalib_tpu.parallel.dispatch import sentinel_table
from seqalib_tpu.types import BLOSUM62
from seqalib_tpu.types import ScoringParams as JaxScoringParams
from seqalib_tpu.utils.cigar import OP_PAD, ops_to_cigar
from seqalib_tpu_torch.ops import launches
from seqalib_tpu_torch.ops import wavefront as wf_mod
from seqalib_tpu_torch.ops import wavefront_xla as xla_mod
from seqalib_tpu_torch.ops.wavefront import (wavefront_fill_ref, wavefront_inputs,
                                             wavefront_launch)
from seqalib_tpu_torch.ops.wavefront_walk import (text_width, wavefront_walk,
                                                  wavefront_walk_ref)
from seqalib_tpu_torch.parallel import dispatch
from seqalib_tpu_torch.scoring import scoring_params
from seqalib_tpu_torch.utils.cigar import BAD_START, cigars_from_text, op_rows_to_cigars

BAND = 6
WIDE = np.where(np.eye(4, dtype=bool), 20, -20).astype(np.int32)
SCORINGS = {  # name -> (JAX scoring, alphabet): both outside [-4, 11]
    "profile_2xblosum62": (JaxScoringParams(gap_open=-20, gap_extend=-2,
                                            matrix=2 * BLOSUM62), 20),
    "scalar_wide4": (JaxScoringParams(gap_open=-5, gap_extend=-2, matrix=WIDE), 4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psp(jsp):
    return scoring_params(jsp.match, jsp.mismatch, jsp.gap_open, jsp.gap_extend, jsp.matrix)


def _mutated(rng, alpha, n, subs=4):
    q = rng.integers(0, alpha, n).astype(np.uint8)
    t = q.copy()
    if n > 12:
        t = np.insert(np.delete(t, [3, 4]), 8, rng.integers(0, alpha, 3))
        idx = rng.choice(len(t), subs, replace=False)
        t[idx] = rng.integers(0, alpha, subs)
    return q, t.astype(np.uint8)


def _bucket(alpha, seed, lens=(60, 41, 0, 55, 17), L=64):
    rng = np.random.default_rng(seed)
    qs, ts = zip(*[_mutated(rng, alpha, n) for n in lens])
    q = np.zeros((len(qs), L), np.int32)
    t = np.zeros((len(ts), L), np.int32)
    for b, (a, c) in enumerate(zip(qs, ts)):
        q[b, : len(a)] = a
        t[b, : len(c)] = c
    return q, t, np.array([len(a) for a in qs]), np.array([len(c) for c in ts])


def _jax_walks(P, si, sj):
    """Every JAX walk of the stream P (K, B, N1) from (si, sj): a list of
    (name, cigars, final i, final j)."""
    B = P.shape[1]
    done0 = np.zeros(B, bool)
    ops_rev, fi, fj = _host_traceback_affine(P, si.copy(), sj.copy(), done0.copy(), B)
    out = [("_host_traceback_affine", [ops_to_cigar(r[r != OP_PAD][::-1]) for r in ops_rev],
            fi, fj)]
    steps = int((si + sj).max()) + 1
    gi, gj, g_rev = _global_walk(jnp.asarray(P), jnp.asarray(si, jnp.int32),
                                 jnp.asarray(sj, jnp.int32), jnp.asarray(done0),
                                 affine=True, B=B, N1=P.shape[2], steps=steps)
    g_rev = np.asarray(g_rev).T
    out.append(("_global_walk", [ops_to_cigar(r[r != OP_PAD][::-1]) for r in g_rev],
                np.asarray(gi), np.asarray(gj)))
    if native.available():
        cig, ni, nj = native.walk_to_cigars(P, si, sj, done0, True)
        out.append(("walk_to_cigars", cig, ni, nj))
    return out


def _port_walk(P, si, sj):
    text, nchar, state = wavefront_walk_ref(torch.from_numpy(np.array(P)),
                                            torch.as_tensor(si, dtype=torch.int32),
                                            torch.as_tensor(sj, dtype=torch.int32))
    return cigars_from_text(text, nchar), state.numpy()


def _same_as_jax(P, si, sj):
    cigars, state = _port_walk(P.view(np.uint8), si, sj)
    walks = _jax_walks(P, si, sj)
    for name, jc, ji, jj in walks:
        assert cigars == list(jc), name
        np.testing.assert_array_equal(state[0], ji, err_msg=name)
        np.testing.assert_array_equal(state[1], jj, err_msg=name)
    assert (state[2] == 0).all() and (state[3] == 1).all()  # every walk reached STOP
    return cigars, len(walks)


@pytest.fixture(scope="module", params=sorted(SCORINGS))
def fill_case(request):
    jsp, alpha = SCORINGS[request.param]
    q, t, qlen, tlen = _bucket(alpha, len(request.param))
    table = sentinel_table(jsp)
    res = jax_fill(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qlen), jnp.asarray(tlen),
                   jnp.asarray(table), mode="global", match=int(table[0, 0]),
                   mismatch=int(table[0, 1]), gap_open=jsp.gap_open,
                   gap_extend=jsp.gap_extend, band=BAND, affine=True, want_tb=True,
                   profile=table.shape[0] > 8, interpret=True)
    return dict(jsp=jsp, args=(q, t, qlen, tlen), P=np.asarray(res["P"]))


def test_walk_matches_the_jax_walks_on_the_fills_streams(fill_case):
    q, t, qlen, tlen = fill_case["args"]
    P = fill_case["P"]
    cigars, n_walks = _same_as_jax(P, qlen.astype(np.int64), tlen.astype(np.int64))
    assert n_walks == 2 + native.available()
    assert (qlen[2], tlen[2], cigars[2]) == (0, 0, "")  # the empty pair
    assert any("I" in c and "D" in c for c in cigars)
    # the port's fill writes the same stream: its walk is the same
    K = q.shape[1] + t.shape[1] + 1
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, _psp(fill_case["jsp"]))
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32)  # noqa: E731
    ptr = wavefront_fill_ref(as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab), K=K,
                             band=BAND, gap_open=fill_case["jsp"].gap_open,
                             gap_extend=fill_case["jsp"].gap_extend, want_ptr=True)["ptr"]
    assert _port_walk(ptr.numpy(), qlen, tlen)[0] == cigars


def _walkable_field(rng, n, m, B):
    """A random pointer field per pair (K, B, n + 1) that every affine walk
    from a cell of the matrix leaves at (0, 0) in state H: row 0 points
    left, column 0 up, (0, 0) is STOP, the interior any byte; the E bit is
    cleared in column 1 and the F bit in row 1 (else a walk would reach
    column 0 in state E, or row 0 in state F, and step out)."""
    K = n + m + 1
    P = rng.integers(0, 16, size=(K, B, n + 1)).astype(np.int8)
    k = np.arange(K)[:, None, None]
    i = np.arange(n + 1)[None, None, :]
    j = k - i
    ph = np.where(i == 0, 3, np.where(j == 0, 2, P & 3))
    ph = np.where((i == 0) & (j == 0), 0, ph)
    ext = P & 12
    ext = np.where(j == 1, ext & ~4, ext)
    ext = np.where(i == 1, ext & ~8, ext)
    return (ph | ext).astype(np.int8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_matches_the_jax_walks_on_random_walkable_fields(seed):
    rng = np.random.default_rng(seed)
    n, m, B = 24 + seed * 9, 31, 7
    P = _walkable_field(rng, n, m, B)
    si = rng.integers(0, n + 1, B).astype(np.int64)
    sj = rng.integers(0, m + 1, B).astype(np.int64)
    si[0], sj[0] = n, m
    si[1], sj[1] = 0, 0  # the origin: an empty CIGAR
    cigars, _ = _same_as_jax(P, si, sj)
    assert cigars[1] == ""


def _parent_bucket(q, t, qlen, tlen, sp, band, want_tb):
    """The parent's ``wavefront_bucket``: the fill's plain version, its
    stream walked on the host by ``_host_traceback_affine`` and encoded by
    ``op_rows_to_cigars``."""
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, sp)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32)  # noqa: E731
    res = wavefront_fill_ref(as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab),
                             K=tk.shape[1], band=band, gap_open=sp.gap_open,
                             gap_extend=sp.gap_extend, want_ptr=want_tb)
    B = len(qlen)
    out = {"score": res["score"].numpy(), "qe": np.asarray(qlen, np.int32),
           "te": np.asarray(tlen, np.int32), "qs": np.zeros(B, np.int32),
           "ts": np.zeros(B, np.int32)}
    if want_tb:
        ops_rev, fi, fj = _host_traceback_affine(res["ptr"].numpy(), np.asarray(qlen, np.int64),
                                                 np.asarray(tlen, np.int64),
                                                 np.zeros(B, bool), B)
        out.update(qs=fi.astype(np.int32), ts=fj.astype(np.int32),
                   cigars=op_rows_to_cigars(ops_rev[:, ::-1]))
    return out


def _pairs(alpha, seed, B=7):
    rng = np.random.default_rng(seed)
    pairs = [_mutated(rng, alpha, int(n)) for n in rng.integers(0, 150, B)]
    pairs[0] = (pairs[0][0], pairs[0][1][:0])  # an empty target
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("want_tb", [True, False])
@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_launch_equals_the_parents_bucket_and_jax(scoring, want_tb):
    jsp, alpha = SCORINGS[scoring]
    sp = _psp(jsp)
    qs, ts = _pairs(alpha, len(scoring))
    L = 160
    q = dispatch._pad_stack(qs, L)
    t = dispatch._pad_stack(ts, L)
    qlen = np.array([len(x) for x in qs])
    tlen = np.array([len(x) for x in ts])
    before = dict(launches)
    finish = wavefront_launch(q, t, qlen, tlen, sp, band=BAND, want_tb=want_tb,
                              device="cpu")
    got = finish()
    assert launches == before  # the CPU path runs the plain versions
    want = _parent_bucket(q, t, qlen, tlen, sp, BAND, want_tb)
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "cigars":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jax = sa.align_batch(qs, ts, scoring=jsp, mode="global", band=BAND, traceback=want_tb,
                         backend="pallas")
    mine = [f"score={got['score'][b]} q[{got['qs'][b]}:{got['qe'][b]}] "
            f"t[{got['ts'][b]}:{got['te'][b]}] {got['cigars'][b] if want_tb else ''}".rstrip()
            for b in range(len(qs))]
    assert mine == [str(r).rstrip() for r in jax]


@pytest.mark.parametrize("edge", ["qlen_0", "tlen_0", "both_0", "last_slot"])
def test_launch_at_the_streams_edges(edge):
    """Pairs that walk only row 0 or column 0, an empty pair, and a query
    whose last letter sits in the stream's last slot (qlen = Np - 1)."""
    from seqalib_tpu_torch.oracle_fast import align_oracle

    sp = scoring_params(0, 0, -20, -2, 2 * BLOSUM62)
    rng = np.random.default_rng(3)
    n = 127  # Np = 128
    q = rng.integers(0, 20, size=(3, n)).astype(np.uint8)
    t = np.concatenate([q[:, 1:], rng.integers(0, 20, size=(3, 2))], 1).astype(np.uint8)
    qlen = np.array([n, 90, 50])
    tlen = np.array([n + 1, 95, 44])
    b = {"qlen_0": 1, "tlen_0": 2, "both_0": 1, "last_slot": 0}[edge]
    if edge in ("qlen_0", "both_0"):
        qlen[b] = 0
    if edge in ("tlen_0", "both_0"):
        tlen[b] = 0
    got = wavefront_launch(q, t, qlen, tlen, sp, band=8, want_tb=True, device="cpu")()
    assert wavefront_inputs(q, t, qlen, tlen, sp)[0].shape[1] == n + 1
    for r in range(3):
        want = align_oracle(q[r, : qlen[r]], t[r, : tlen[r]], sp, mode="global", band=8)
        assert (int(got["score"][r]), int(got["qs"][r]), int(got["ts"][r]),
                got["cigars"][r]) == (want.score, want.query_start, want.target_start,
                                      want.cigar)
    want_cigar = {"qlen_0": f"{tlen[1]}D", "tlen_0": f"{qlen[2]}I", "both_0": "",
                  "last_slot": None}[edge]
    if want_cigar is not None:
        assert got["cigars"][b] == want_cigar


def test_a_start_outside_the_stream_raises_at_the_finalize():
    """The plain version marks the pair (nchar = BAD_START, its state as
    given) as the kernel does, and the finalize's decode raises; the CPU
    wrapper raises the same error at once."""
    rng = np.random.default_rng(4)
    P = torch.from_numpy(_walkable_field(rng, 20, 20, 3).view(np.uint8))
    K, _, Np = P.shape
    i = torch.tensor([20, Np, 5], dtype=torch.int32)  # pair 1: i >= Np
    j = torch.tensor([20, 0, K - 5], dtype=torch.int32)  # pair 2: i + j >= K
    text, nchar, state = wavefront_walk_ref(P, i, j)
    assert text.shape == (3, text_width(K))
    assert nchar[1] == nchar[2] == BAD_START and nchar[0] > 0
    assert state[:, 1].tolist() == [Np, 0, 0, 0] and state[:, 2].tolist() == [5, K - 5, 0, 0]
    with pytest.raises(ValueError, match="pair 1's start cell lies outside P"):
        cigars_from_text(text, nchar)
    with pytest.raises(ValueError, match="pair 1's start cell lies outside P"):
        wavefront_walk(P, i, j)
    with pytest.raises(ValueError, match="pair 0's start cell lies outside P"):
        wavefront_walk(P, torch.tensor([-1, 0, 0], dtype=torch.int32), j * 0)


def test_walk_refuses_bad_arguments():
    P = torch.zeros((9, 2, 16), dtype=torch.uint8)
    v = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="uint8"):
        wavefront_walk(P.to(torch.int32), v, v)
    with pytest.raises(ValueError, match=r"\(2,\) int32"):
        wavefront_walk(P, v[:1], v)


def test_every_wide_bucket_and_shard_launches_before_any_finalizes(monkeypatch):
    """``dispatch_batch`` launches both wide buckets, and
    ``wavefront_sharded`` all three shards (each through ``xla_launch``'s
    global mode), before it finalizes any."""
    events = []
    real = wf_mod.wavefront_launch

    def spy(q, *a, **k):
        finish = real(q, *a, **k)
        events.append(("launch", len(q)))

        def fin():
            events.append(("finish", len(q)))
            return finish()
        return fin

    monkeypatch.setattr(dispatch, "wavefront_launch", spy)
    monkeypatch.setattr(xla_mod, "wavefront_launch", spy)
    sp = scoring_params(0, 0, -20, -2, 2 * BLOSUM62)
    rng = np.random.default_rng(6)
    qs = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in (10, 12, 40, 45, 14)]
    ts = [np.concatenate([x[2:], x[:1]]) for x in qs]
    want = [str(r) for r in st.align_batch(qs, ts, scoring=sp, mode="global", band=4,
                                           backend="oracle")]
    got = st.align_batch(qs, ts, scoring=sp, mode="global", band=4, device="cpu")
    assert [e[0] for e in events] == ["launch", "launch", "finish", "finish"]
    assert [str(r) for r in got] == want
    events.clear()
    got = st.align_batch(qs, ts, scoring=sp, mode="global", band=4, mesh=["cpu"] * 3)
    # two buckets of 3 and 2 pairs: 3 shards, then 2 (the third empty)
    assert events == [("launch", 1)] * 5 + [("finish", 1)] * 5
    assert [str(r) for r in got] == want
