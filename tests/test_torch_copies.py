"""The port keeps its own copies of the JAX package's jax-free layer
(types, ``AlignConfig``, the exported names, encoders, BLOSUM62, oracle,
CIGAR codec, bucketing helpers, the sentinel table, the generic-container
aligners).  These tests hold each copy to the original on the same
inputs, so that the two packages keep scoring, bucketing and encoding
alike; and they run the port's ``dryrun_multichip`` on a CPU mesh."""

import dataclasses

import numpy as np
import pytest

import seqalib_tpu.oracle as jax_oracle
import seqalib_tpu.oracle_fast as jax_oracle_fast
import seqalib_tpu.types as jt
import seqalib_tpu.utils.cigar as jax_cigar
from seqalib_tpu.parallel import dispatch as jax_dispatch
from seqalib_tpu_torch import oracle as port_oracle
from seqalib_tpu_torch import oracle_fast as port_oracle_fast
from seqalib_tpu_torch import scoring
from seqalib_tpu_torch import types as pt
from seqalib_tpu_torch.parallel import dispatch as port_dispatch
from seqalib_tpu_torch.utils import cigar as port_cigar


def _both(sp):
    """The same scoring as a JAX-package and a port ``ScoringParams``."""
    return sp, scoring.scoring_params(sp.match, sp.mismatch, sp.gap_open,
                                      sp.gap_extend, sp.matrix)


SCORINGS = {
    "dna_linear": jt.ScoringParams.linear(),
    "dna_affine": jt.ScoringParams.affine(),
    "blosum62": jt.ScoringParams.blosum62(gap_open=-10, gap_extend=-1),
}


def test_constants_and_blosum62_are_the_same():
    assert (pt.NEG_INF, pt.PTR_STOP, pt.PTR_DIAG, pt.PTR_UP, pt.PTR_LEFT) == (
        jt.NEG_INF, jt.PTR_STOP, jt.PTR_DIAG, jt.PTR_UP, jt.PTR_LEFT)
    assert (pt.PROTEIN_SIZE, pt.PROTEIN_ALPHABET, pt.DNA_ALPHABET) == (
        jt.PROTEIN_SIZE, jt.PROTEIN_ALPHABET, jt.DNA_ALPHABET)
    np.testing.assert_array_equal(pt.BLOSUM62, jt.BLOSUM62)
    assert (port_cigar.OP_M, port_cigar.OP_I, port_cigar.OP_D, port_cigar.OP_PAD) == (
        jax_cigar.OP_M, jax_cigar.OP_I, jax_cigar.OP_D, jax_cigar.OP_PAD)


def test_encoders_are_the_same():
    for s in ["ACGTNacgtn", "", "TTTT"]:
        np.testing.assert_array_equal(pt.encode_dna(s), jt.encode_dna(s))
        assert pt.decode_dna(pt.encode_dna(s)) == jt.decode_dna(jt.encode_dna(s))
    for s in ["HEAGAWGHEE", "arndcqeghilkmfpstwyvbzx*", "UOJuoj"]:
        np.testing.assert_array_equal(pt.encode_protein(s), jt.encode_protein(s))
    for bad, enc in (("ACGX", pt.encode_dna), ("HE1", pt.encode_protein)):
        with pytest.raises(ValueError, match="invalid"):
            enc(bad)


@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_scoring_params_and_sentinel_table_are_the_same(name):
    jsp, psp = _both(SCORINGS[name])
    assert isinstance(psp, pt.ScoringParams)
    assert (psp.is_affine, psp.alphabet_size) == (jsp.is_affine, jsp.alphabet_size)
    np.testing.assert_array_equal(psp.substitution_matrix(), jsp.substitution_matrix())
    np.testing.assert_array_equal(scoring.sentinel_table(psp),
                                  jax_dispatch.sentinel_table(jsp))
    with pytest.raises(ValueError):
        scoring.scoring_params(2, -3, 1, -2)


def test_bucket_len_and_pad_stack_are_the_same(monkeypatch):
    for policy in ("ceil128", "pow2"):
        monkeypatch.setenv("SEQALIB_BUCKET_POLICY", policy)
        for n in range(0, 1100, 7):
            assert port_dispatch.bucket_len(n) == jax_dispatch.bucket_len(n), (policy, n)
    seqs = [np.arange(k, dtype=np.uint8) for k in (0, 3, 9)]
    np.testing.assert_array_equal(port_dispatch._pad_stack(seqs, 12),
                                  jax_dispatch._pad_stack(seqs, 12))


def test_ops_to_cigar_is_the_same():
    rng = np.random.default_rng(0)
    for _ in range(300):
        ops = rng.choice([0, 1, 2, 255], size=rng.integers(0, 40), p=[0.5, 0.2, 0.2, 0.1])
        assert port_cigar.ops_to_cigar(ops) == jax_cigar.ops_to_cigar(ops)
        c = jax_cigar.ops_to_cigar(ops)
        assert port_cigar.cigar_consumed(c) == jax_cigar.cigar_consumed(c)
        assert port_cigar.cigar_to_ops(c) == jax_cigar.cigar_to_ops(c)


def test_op_rows_to_cigars_equals_ops_to_cigar():
    """The batched encoder gives, row by row, the JAX package's
    ``ops_to_cigar`` of the head run followed by the row's non-pad ops."""
    rng = np.random.default_rng(1)
    for width in (0, 1, 7, 40):
        ops = rng.choice([0, 1, 2, 255], size=(9, width), p=[0.5, 0.2, 0.2, 0.1])
        ops[0] = 255  # a row with no op
        head_op = rng.integers(0, 3, 9)
        head_len = rng.integers(0, 4, 9)
        want = [jax_cigar.ops_to_cigar(np.concatenate([np.full(h, o), r[r != 255]]))
                for r, o, h in zip(ops, head_op, head_len)]
        assert port_cigar.op_rows_to_cigars(ops, head_op, head_len) == want
        assert port_cigar.op_rows_to_cigars(ops) == [
            jax_cigar.ops_to_cigar(r[r != 255]) for r in ops]


@pytest.mark.parametrize("name", sorted(SCORINGS))
@pytest.mark.parametrize("mode,band", [("local", None), ("global", None), ("global", 6)])
def test_oracles_are_the_same(name, mode, band):
    jsp, psp = _both(SCORINGS[name])
    alpha = 20 if jsp.matrix is not None else 4
    rng = np.random.default_rng(len(name) + (band or 0))
    for _ in range(6):
        q = rng.integers(0, alpha, rng.integers(0, 40)).astype(np.uint8)
        t = rng.integers(0, alpha, rng.integers(0, 40)).astype(np.uint8)
        if band is not None and abs(len(t) - len(q)) > 30:
            continue
        want = str(jax_oracle.align_oracle(q, t, jsp, mode=mode, band=band))
        assert str(port_oracle.align_oracle(q, t, psp, mode=mode, band=band)) == want
        assert str(port_oracle_fast.align_oracle(q, t, psp, mode=mode, band=band)) == want
        assert str(jax_oracle_fast.align_oracle(q, t, jsp, mode=mode, band=band)) == want


def test_host_traceback_affine_is_the_same():
    # the banded full-matrix route's host walk, on a pointer stream the
    # port's plain fill emits for a bucket with an empty pair: the port
    # keeps no copy of it since its walk runs on the card, and the walk's
    # plain version (the same lockstep walk, its ops encoded as text) gives
    # the JAX walk's CIGARs and final cells
    import torch

    from seqalib_tpu.ops.wavefront_pallas import _host_traceback_affine as jax_walk
    from seqalib_tpu.utils.cigar import OP_PAD
    from seqalib_tpu_torch.ops import wavefront as port_wf
    from seqalib_tpu_torch.ops.wavefront_walk import wavefront_walk_ref
    from seqalib_tpu_torch.utils.cigar import cigars_from_text

    rng = np.random.default_rng(2)
    jsp, sp = _both(jt.ScoringParams(gap_open=-5, gap_extend=-2,
                                     matrix=np.where(np.eye(4, dtype=bool), 20, -20)))
    qlen, tlen = np.array([40, 0, 31, 25]), np.array([37, 3, 0, 29])
    q = rng.integers(0, 4, size=(4, 48))
    t = q[:, 2:].copy()
    t[:, ::7] = (t[:, ::7] + 1) % 4
    qpad, tk, tab = port_wf.wavefront_inputs(q, t, qlen, tlen, sp)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32)  # noqa: E731
    P = port_wf.wavefront_fill(as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab),
                               K=tk.shape[1], band=8, gap_open=sp.gap_open,
                               gap_extend=sp.gap_extend, want_ptr=True)["ptr"]
    text, nchar, state = wavefront_walk_ref(P, as_t(qlen), as_t(tlen))
    ops_rev, fi, fj = jax_walk(P.numpy().view(np.int8), qlen, tlen, np.zeros(4, bool), 4)
    assert cigars_from_text(text, nchar) == [
        jax_cigar.ops_to_cigar(r[r != OP_PAD][::-1]) for r in ops_rev]
    np.testing.assert_array_equal(state[0].numpy(), fi)
    np.testing.assert_array_equal(state[1].numpy(), fj)


def test_rescore_global_affine_is_the_same():
    from seqalib_tpu.parallel.band_pipeline import _rescore_global_affine as jax_rescore
    from seqalib_tpu_torch.utils.cigar import rescore_global_affine as port

    q, t = np.array([0, 1, 2, 3, 1]), np.array([0, 2, 2, 3])
    for name in ("dna_affine", "blosum62"):
        jsp, sp = _both(SCORINGS[name])
        for ops in ([0, 0, 0, 0, 1], [1, 1, 0, 2, 0, 0], [2, 2, 2, 2, 1, 1, 1, 1, 1]):
            assert port(q, t, ops, sp) == jax_rescore(q, t, ops, jsp)
        with pytest.raises(RuntimeError, match="consume"):
            port(q, t, [0, 0], sp)


def _config_outcome(cls, **kw):
    try:
        return dataclasses.astuple(cls(**kw))
    except ValueError as e:
        return ("ValueError", str(e))


def test_align_config_is_the_same():
    import itertools

    grid = itertools.product(["global", "local", "semi"], [None, 0, 1, 7], [True, False],
                             ["oracle", "xla", "pallas", "cuda"])
    for mode, band, tb, backend in grid:
        kw = dict(mode=mode, band=band, traceback=tb, backend=backend)
        assert _config_outcome(pt.AlignConfig, **kw) == _config_outcome(jt.AlignConfig, **kw)
    assert dataclasses.astuple(pt.AlignConfig()) == dataclasses.astuple(jt.AlignConfig())
    # the port's own name for the strip route, which the JAX package calls
    # "xla" or "pallas"
    assert pt.AlignConfig(backend="strip").backend == "strip"
    with pytest.raises(ValueError, match="unknown backend"):
        jt.AlignConfig(backend="strip")


def test_exported_names_are_the_same():
    import seqalib_tpu as sa
    import seqalib_tpu_torch as st

    for name in ("DNA_ALPHABET", "PROTEIN_ALPHABET", "NEG_INF", "__version__"):
        assert getattr(st, name) == getattr(sa, name), name
    assert st.__version__ == "0.3.0"
    assert {"AlignConfig", "AlignResult", "ScoringParams", "BLOSUM62"} <= set(dir(st))
    np.testing.assert_array_equal(st.BLOSUM62, sa.BLOSUM62)


def _generic_cases():
    """tests/test_generic.py's inputs: (aligner name, kwargs, s1, s2)."""
    cases = [("NeedlemanWunschSA", {}, "ACGTACGT", "ACGACGT"),
             ("SmithWatermanSA", {}, "TTTACGTACGTTT", "GGACGTACGG"),
             ("NeedlemanWunschSA", {}, "AB", "AB")]
    rng = np.random.default_rng(3)
    for _ in range(5):
        s1 = list(rng.integers(0, 4, rng.integers(1, 40)))
        s2 = list(rng.integers(0, 4, rng.integers(1, 40)))
        cases += [("NeedlemanWunschSA", {}, s1, s2), ("HirschbergSA", {}, s1, s2)]
    rng = np.random.default_rng(4)
    cases.append(("DiagonalWindowsSA", {"window": 64}, list(rng.integers(0, 4, 30)),
                  list(rng.integers(0, 4, 33))))
    rng = np.random.default_rng(7)
    for _ in range(8):
        cases.append(("FOGSAA", {}, list(rng.integers(0, 4, rng.integers(0, 35))),
                      list(rng.integers(0, 4, rng.integers(0, 35)))))
    rng = np.random.default_rng(8)
    s1 = list(rng.integers(0, 4, 60))
    s2 = list(s1)
    s2[30] = (s2[30] + 1) % 4
    cases.append(("FOGSAA", {}, s1, s2))
    rng = np.random.default_rng(0)
    for o, e in [(-5, -1), (-3, -2), (0, -2), (-11, -1)]:
        for _ in range(3):
            q = list(rng.integers(0, 4, int(rng.integers(0, 40))))
            t = list(rng.integers(0, 4, int(rng.integers(0, 40))))
            cases.append(("MyersMillerSA", {"gap_open": o, "gap_extend": e}, q, t))
    rng = np.random.default_rng(3)
    for _ in range(6):
        q = list(rng.integers(0, 4, int(rng.integers(0, 35))))
        t = list(rng.integers(0, 4, int(rng.integers(0, 35))))
        for local in (False, True):
            cases.append(("GotohSA", {"gap_open": -5, "gap_extend": -2, "local": local},
                          q, t))
    return cases


SCORING_SYSTEMS = [dict(gap_penalty=-2, match_profit=2, mismatch_penalty=-3),
                   dict(gap_penalty=-1, match_profit=2, mismatch_penalty=-1),
                   dict(gap_penalty=-3, match_profit=2, mismatch_penalty=-3),
                   dict(match_profit=3, mismatch_penalty=-2)]


@pytest.mark.parametrize("si", range(len(SCORING_SYSTEMS)))
def test_generic_aligners_are_the_same(si):
    import seqalib_tpu.models.generic as jg
    from seqalib_tpu_torch.models import generic as pg

    def run(mod, name, kw, s1, s2, **sc):
        sa = getattr(mod, name)(mod.ScoringSystem(**sc), **kw)
        res = sa.get_alignment(s1, s2)
        return (res.score, res.cigar(), res.matches(),
                [(e.a, e.b, e.is_match) for e in res], getattr(sa, "expanded", None))

    sc = SCORING_SYSTEMS[si]
    for name, kw, s1, s2 in _generic_cases():
        assert run(pg, name, kw, s1, s2, **sc) == run(jg, name, kw, s1, s2, **sc), name
    # arbitrary objects and a match function, with mismatches disallowed
    ops1 = [("add", 1), ("mul", 2), ("ld", 3), ("st", 4)]
    ops2 = [("add", 9), ("ld", 7), ("st", 4)]
    for name in ("NeedlemanWunschSA", "FOGSAA"):
        got, want = (getattr(m, name)(m.ScoringSystem(gap_penalty=-1, match_profit=3,
                                                      allow_mismatch=False),
                                      match_fn=lambda a, b: a[0] == b[0])
                     .get_alignment(ops1, ops2) for m in (pg, jg))
        assert (got.score, got.cigar(), [(e.a, e.b) for e in got]) == (
            want.score, want.cigar(), [(e.a, e.b) for e in want])


@pytest.mark.parametrize("preset", [None, "strip"])
def test_dryrun_multichip_passes_and_restores_the_environment(preset, monkeypatch):
    import torch

    from seqalib_tpu_torch.parallel.dist import dryrun_multichip

    if preset is None:
        monkeypatch.delenv("SEQALIB_FUSED_PASS2", raising=False)
    else:
        monkeypatch.setenv("SEQALIB_FUSED_PASS2", preset)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        dryrun_multichip(4, device="cpu")
    finally:
        torch.set_num_threads(n)
    import os

    assert os.environ.get("SEQALIB_FUSED_PASS2") == preset
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="2 CUDA devices asked for, 0 visible"):
            dryrun_multichip(2)
