"""Port parity: global fill + ``seqalib_tpu_torch.ops.strip_walk`` (plain
versions on the CPU) against the JAX ``strip_fill_walk_global`` (gmode
fill + ``strip_walk_range`` in interpret mode, its op matrix encoded by
``_cigars_from_ops``) and against the oracle; and the walk's CIGAR text
(the boundary run merged, right-aligned rows, the deferred range check) on
pointer matrices built by hand.  Exact equality of CIGAR strings and
walker end states."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqalib_tpu import oracle_fast
from seqalib_tpu.ops.strip_pallas import _cigars_from_ops, _prep_strip, strip_fill_walk_global
from seqalib_tpu.parallel.dispatch import sentinel_table
from seqalib_tpu.types import PTR_DIAG, PTR_LEFT, PTR_STOP, PTR_UP, ScoringParams
from seqalib_tpu_torch.ops import strip as strip_mod
from seqalib_tpu_torch.ops.strip import prep_strip, strip_bucket
from seqalib_tpu_torch.ops.strip_fill import strip_fill
from seqalib_tpu_torch.ops.strip_walk import strip_walk, strip_walk_ref, text_width
from seqalib_tpu_torch.scoring import scoring_params, tables_from_params
from seqalib_tpu_torch.utils.cigar import BAD_START, cigars_from_text

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


def _walk(P, i, j, st=None, done=None, affine=False):
    """strip_walk on small host lists; (CIGARs, (4, B) final state)."""
    i = torch.tensor(i, dtype=torch.int32)
    j = torch.tensor(j, dtype=torch.int32)
    st = torch.zeros_like(i) if st is None else torch.tensor(st, dtype=torch.int32)
    done = torch.zeros_like(i) if done is None else torch.tensor(done, dtype=torch.int32)
    text, nchar, state = strip_walk(P, i, j, st, done, affine=affine)
    assert text.shape == (P.shape[0], text_width(*P.shape[1:]))
    return cigars_from_text(text, nchar), state.tolist()


def test_walk_matches_jax(case):
    text, nchar, state = _port_walk(case)
    ifin, jfin, _, done = state
    jax_cigars, jax_i, jax_j = case["jax"]
    np.testing.assert_array_equal(ifin.numpy(), jax_i)
    np.testing.assert_array_equal(jfin.numpy(), jax_j)
    assert done.all()
    assert cigars_from_text(text, nchar) == jax_cigars
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


def _scalar_walk(P, i, j, st, affine):
    """One pair's walk, step by step: (ops start -> end, i', j', st')."""
    ops = []
    while i >= 1 and j >= 1:
        byte = int(P[i - 1, j - 1])
        ph = byte & 3
        if st == 0 and ph == PTR_STOP:
            break
        m = st == 0 and ph == PTR_DIAG
        up = (st == 0 and ph == PTR_UP) or st == 2
        ops.append(0 if m else (1 if up else 2))
        if affine:
            st = 0 if m else ((2 if byte & 8 else 0) if up else (1 if byte & 4 else 0))
        i -= m or up
        j -= not up
    return ops[::-1], i, j, st


@pytest.mark.parametrize("affine", [False, True])
def test_walk_on_random_pointer_bytes_matches_a_scalar_walk_and_jax_encoding(affine):
    """Every pointer byte and state drawn at random (STOP stops included):
    the text equals JAX's ``_cigars_from_ops`` of a step-by-step walk."""
    rng = np.random.default_rng(5 + affine)
    Bn, R, C = 24, 37, 41
    P = torch.as_tensor(rng.integers(0, 16, size=(Bn, R, C)), dtype=torch.uint8)
    i = rng.integers(0, R + 1, size=Bn)
    j = rng.integers(0, C + 1, size=Bn)
    st = rng.integers(0, 3 if affine else 1, size=Bn)
    done = (rng.random(Bn) < 0.1).astype(int)
    got, state = _walk(P, i.tolist(), j.tolist(), st.tolist(), done.tolist(), affine)
    L = R + C
    ops = np.full((Bn, L), 255, np.uint8)
    want_state = []
    for b in range(Bn):
        if done[b]:
            ob, ib, jb, sb = [], i[b], j[b], st[b]
        else:
            ob, ib, jb, sb = _scalar_walk(P[b].numpy(), i[b], j[b], st[b], affine)
        ops[b, L - len(ob):] = ob
        want_state.append((ib, jb, sb, 1))
    assert [tuple(s) for s in zip(*state)] == want_state
    fin = np.array(want_state)
    assert got == _cigars_from_ops(ops.view(np.int8), fin[:, 0], fin[:, 1])


def test_walk_stops_at_a_stop_pointer_in_state_h():
    # local pointers carry STOP: the walk ends there without an op, and the
    # boundary run i' x I comes first (pair 0: merged with the first run)
    P = torch.zeros((2, 3, 3), dtype=torch.uint8)
    P[:, 2, 2] = PTR_DIAG
    P[:, 1, 1] = PTR_UP
    P[:, 0, 1] = PTR_STOP
    P[1, 0, 1] = PTR_DIAG
    got, state = _walk(P, [3, 3], [3, 3])
    assert state[:2] + state[3:] == [[1, 0], [2, 1], [1, 1]]
    assert got == ["2I1M", "1D1M1I1M"]


@pytest.mark.parametrize("n", [9, 10, 99, 100, 1000])
def test_run_lengths_across_decimal_digits(n):
    """Three D ops, then n M ops down the diagonal: "{n}M3D", every digit
    of n written."""
    P = torch.full((1, n, n + 3), PTR_DIAG, dtype=torch.uint8)
    P[0, n - 1, n:] = PTR_LEFT
    got, state = _walk(P, [n], [n + 3])
    assert got == [f"{n}M3D"]
    assert state == [[0], [0], [0], [1]]


@pytest.mark.parametrize("last,want", [
    (PTR_UP, ["4I2M"]),         # the first op walked is I: merged with the head
    (PTR_DIAG, ["3I3M"]),       # an M: not merged
])
def test_head_run_after_a_stop(last, want):
    """From (6, 6): two M ops, then the byte at (4, 4), then a STOP."""
    P = torch.full((1, 6, 6), PTR_STOP, dtype=torch.uint8)
    P[0, 5, 5] = P[0, 4, 4] = PTR_DIAG
    P[0, 3, 3] = last
    got, state = _walk(P, [6], [6])
    assert got == want
    assert (state[0][0], state[1][0]) == ((3, 4) if last == PTR_UP else (3, 3))


@pytest.mark.parametrize("P_fill,start,want", [
    (PTR_LEFT, (3, 5), "3I5D"),   # j' = 0 with i' = 3 left: head I, then the D run
    (PTR_UP, (5, 3), "3D5I"),     # i' = 0 with j' = 3 left: head D, then the I run
])
def test_head_run_at_the_boundary(P_fill, start, want):
    P = torch.full((1, 5, 5), P_fill, dtype=torch.uint8)
    got, _ = _walk(P, [start[0]], [start[1]])
    assert got == [want]


@pytest.mark.parametrize("i,j,done,want", [
    (0, 0, 1, ""),      # done at the start, nothing left: an empty text
    (3, 5, 1, "3I"),    # done at the start: the boundary run alone
    (0, 4, 0, "4D"),    # row 0: the walk ends at once
    (4, 0, 0, "4I"),    # column 0
])
def test_walk_that_takes_no_step(i, j, done, want):
    P = torch.full((1, 5, 6), PTR_DIAG, dtype=torch.uint8)
    got, state = _walk(P, [i], [j], done=[done])
    assert got == [want]
    assert state == [[i], [j], [0], [1]]


def test_walk_of_no_pairs():
    P = torch.zeros((0, 4, 5), dtype=torch.uint8)
    got, state = _walk(P, [], [])
    assert got == [] and state == [[], [], [], []]


def test_start_outside_p_raises_at_once_on_the_cpu():
    P = torch.zeros((3, 4, 5), dtype=torch.uint8)
    for i, j in ((5, 1), (1, 6)):
        with pytest.raises(ValueError, match="pair 1's start cell lies outside P"):
            _walk(P, [1, i, 1], [1, j, 1])


def test_deferred_range_check_raises_when_decoded():
    """The plain version marks a pair that starts outside P with
    BAD_START, as the kernel does, walks the others, and ``cigars``
    raises; its state stays the start's."""
    P = torch.full((3, 4, 5), PTR_DIAG, dtype=torch.uint8)
    i = torch.tensor([4, 9, 2], dtype=torch.int32)
    j = torch.tensor([5, 2, 2], dtype=torch.int32)
    z = torch.zeros_like(i)
    text, nchar, state = strip_walk_ref(P, i, j, z, z, affine=False)
    assert nchar.tolist()[1] == BAD_START
    assert state[:, 1].tolist() == [9, 2, 0, 0]
    assert cigars_from_text(text[[0, 2]], nchar[[0, 2]]) == ["1D4M", "2M"]
    with pytest.raises(ValueError, match="pair 1's start cell lies outside P"):
        cigars_from_text(text, nchar)


@pytest.mark.parametrize("mode", ["local", "global"])
def test_strip_bucket_refuses_a_walk_start_outside_p(mode, monkeypatch):
    """A start cell pushed out of P inside ``strip_bucket`` raises the
    ValueError (on the card at the host copy, here at once)."""
    real = strip_mod.strip_walk

    def shifted(P, i, j, st, done, **kw):
        return real(P, i + P.shape[1] * (torch.arange(len(i)) == 1), j, st, done, **kw)

    monkeypatch.setattr(strip_mod, "strip_walk", shifted)
    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, size=(2, 40))
    tables = tables_from_params(scoring_params(2, -3, -5, -2, None), "cpu")
    with pytest.raises(ValueError, match="start cell lies outside P"):
        strip_bucket(q, q.copy(), np.array([40, 31]), np.array([40, 35]), tables,
                     mode=mode, want_tb=True)
