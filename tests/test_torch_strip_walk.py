"""Port parity: global fill + ``seqalib_tpu_torch.ops.strip_walk`` (plain
versions on the CPU) against the JAX ``strip_fill_walk_global`` (gmode
fill + ``strip_walk_range`` in interpret mode) and against the oracle.
Exact equality of CIGAR strings and walker end states."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqalib_tpu import oracle_fast
from seqalib_tpu.ops.strip_pallas import _cigars_from_ops, _prep_strip, strip_fill_walk_global
from seqalib_tpu.parallel.dispatch import sentinel_table
from seqalib_tpu.types import PTR_DIAG, PTR_STOP, PTR_UP, ScoringParams
from seqalib_tpu_torch.ops.strip import cigars_from_ops, prep_strip, strip_bucket
from seqalib_tpu_torch.ops.strip_fill import strip_fill
from seqalib_tpu_torch.ops.strip_walk import strip_walk
from seqalib_tpu_torch.scoring import tables_from_params

B, N, M = 8, 150, 170
SCORINGS = {
    "dna_linear": (ScoringParams.linear(), 4),
    "blosum62_affine": (ScoringParams.blosum62(gap_open=-10, gap_extend=-1), 20),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them fast when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(SCORINGS))
def case(request):
    sp, alpha = SCORINGS[request.param]
    rng = np.random.default_rng(11)
    q = rng.integers(0, alpha, size=(B, N)).astype(np.int32)
    t = rng.integers(0, alpha, size=(B, M)).astype(np.int32)
    t[:, 10:120] = q[:, 25:135]
    qlen = rng.integers(1, N + 1, size=B).astype(np.int64)
    tlen = rng.integers(1, M + 1, size=B).astype(np.int64)
    qlen[0], tlen[0] = N, M
    qlen[1] = 0   # all-D pair
    tlen[2] = 0   # all-I pair
    qlen[3] = tlen[3] = 0
    table = sentinel_table(sp)
    qpad, t2, kwc = _prep_strip(q, t, qlen, tlen, table, gap_open=sp.gap_open,
                                gap_extend=sp.gap_extend, affine=sp.is_affine)
    r = strip_fill_walk_global(*(jnp.asarray(x) for x in (qpad, t2, qlen, tlen, table)),
                               BSUB=B, interpret=True, **kwc)
    ifin, jfin = np.asarray(r["ifin"]), np.asarray(r["jfin"])
    jax_cigars = _cigars_from_ops(np.asarray(r["ops"]), ifin, jfin)
    return dict(sp=sp, q=q, t=t, qlen=qlen, tlen=tlen, tables=tables_from_params(sp, "cpu"),
                jax=(jax_cigars, ifin, jfin))


def _port_walk(case):
    qpad, t2 = prep_strip(case["q"], case["t"], case["qlen"], case["tlen"],
                          case["tables"].A1, "cpu")
    ql = torch.as_tensor(case["qlen"], dtype=torch.int32)
    tl = torch.as_tensor(case["tlen"], dtype=torch.int32)
    P = strip_fill(qpad, t2, ql, tl, case["tables"], mq=M, mode="gmode",
                   want_ptr=True)["P"]
    deg = ((ql == 0) | (tl == 0)).to(torch.int32)
    return strip_walk(P, ql, tl, torch.zeros_like(ql), deg,
                      affine=case["tables"].affine)


def test_walk_matches_jax(case):
    ops, ifin, jfin, st, done = _port_walk(case)
    jax_cigars, jax_i, jax_j = case["jax"]
    np.testing.assert_array_equal(ifin.numpy(), jax_i)
    np.testing.assert_array_equal(jfin.numpy(), jax_j)
    assert done.all()
    assert cigars_from_ops(ops.numpy(), ifin.numpy(), jfin.numpy()) == jax_cigars
    # the degenerate pairs are the implicit boundary runs alone
    assert jax_cigars[1] == f"{case['tlen'][1]}D"
    assert jax_cigars[2] == f"{case['qlen'][2]}I"
    assert jax_cigars[3] == ""


def test_global_bucket_matches_oracle(case):
    out = strip_bucket(case["q"], case["t"], case["qlen"], case["tlen"],
                       case["tables"], mode="global", want_tb=True)
    for b in range(B):
        o = oracle_fast.align_oracle(case["q"][b, : case["qlen"][b]],
                                     case["t"][b, : case["tlen"][b]],
                                     case["sp"], mode="global")
        got = (out["score"][b], out["qs"][b], out["qe"][b], out["ts"][b],
               out["te"][b], out["cigars"][b])
        assert got == (o.score, o.query_start, o.query_end, o.target_start,
                       o.target_end, o.cigar), b


def test_cigars_from_ops_matches_jax():
    rng = np.random.default_rng(3)
    ops = rng.integers(0, 3, size=(6, 40)).astype(np.uint8)
    ops[rng.random(ops.shape) < 0.5] = 255
    ifin = np.array([0, 3, 0, 0, 5, 0])
    jfin = np.array([0, 0, 4, 0, 0, 2])
    assert cigars_from_ops(ops, ifin, jfin) == _cigars_from_ops(ops.view(np.int8), ifin, jfin)


def test_walk_stops_at_a_stop_pointer_in_state_h():
    # local pointers carry STOP: the walk ends there without an op
    P = torch.zeros((2, 3, 3), dtype=torch.uint8)
    P[:, 2, 2] = PTR_DIAG
    P[:, 1, 1] = PTR_UP
    P[:, 0, 1] = PTR_STOP
    P[1, 0, 1] = PTR_DIAG
    z = torch.zeros(2, dtype=torch.int32)
    ops, i, j, st, done = strip_walk(P, torch.full((2,), 3, dtype=torch.int32),
                                     torch.full((2,), 3, dtype=torch.int32), z, z,
                                     affine=False)
    assert (i.tolist(), j.tolist(), done.tolist()) == ([1, 0], [2, 1], [1, 1])
    assert cigars_from_ops(ops.numpy(), [0, 0], [0, 1]) == ["1I1M", "1D1M1I1M"]
