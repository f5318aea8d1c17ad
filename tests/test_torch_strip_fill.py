"""Port parity: ``seqalib_tpu_torch.ops.strip_fill`` (plain version on the
CPU) against the JAX ``_strip_fill`` Pallas kernel in interpret mode, in
its three modes (local, emode, gmode with pointers), and against the
oracle's fills.  Exact equality: the work is integer DP.

Pointer bytes are compared cell by cell over each pair's valid box with
the JAX pointer stream and with ``oracle_fast._gotoh_fill``'s
``PH | EXT_E << 2 | EXT_F << 3`` (linear gaps emit no extend bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqalib_tpu import oracle_fast
from seqalib_tpu.oracle import _argmax_first
from seqalib_tpu.ops.strip_pallas import TI, _prep_strip, _reduce_best, _strip_fill
from seqalib_tpu.parallel.dispatch import sentinel_table
from seqalib_tpu.types import ScoringParams
from seqalib_tpu_torch.ops import launches
from seqalib_tpu_torch.ops.strip import prep_strip, reduce_best
from seqalib_tpu_torch.ops.strip_fill import (MAX_WARPS, RING, SMEM_BUDGET, strip_fill,
                                             strip_smem, strip_warps)
from seqalib_tpu_torch.scoring import tables_from_params

B, N, M = 8, 150, 140  # two 128-row JAX strips
BSUB = 8
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


def _batch(alpha, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, alpha, size=(B, N)).astype(np.int32)
    t = rng.integers(0, alpha, size=(B, M)).astype(np.int32)
    t[:, 30:110] = q[:, 50:130]  # a shared region: long positive paths
    t[:, 60:64] = alpha - 1      # broken by a few substitutions
    qlen = rng.integers(1, N + 1, size=B).astype(np.int64)
    tlen = rng.integers(1, M + 1, size=B).astype(np.int64)
    qlen[0], tlen[1] = N, M
    qlen[2], tlen[3] = 0, 0  # degenerate pairs
    return q, t, qlen, tlen


@pytest.fixture(scope="module", params=sorted(SCORINGS))
def case(request):
    """One batch per scoring, with the JAX kernel's results in every mode
    (computed once: each distinct interpret-mode shape compiles for
    seconds)."""
    sp, alpha = SCORINGS[request.param]
    q, t, qlen, tlen = _batch(alpha, seed=len(request.param))
    table = sentinel_table(sp)
    qpad, t2, kwc = _prep_strip(q, t, qlen, tlen, table, gap_open=sp.gap_open,
                                gap_extend=sp.gap_extend, affine=sp.is_affine)
    args = [jnp.asarray(x) for x in (qpad, t2, qlen, tlen, table)]
    jax_out = {}
    for mode in ("local", "emode"):
        r = _strip_fill(*args, BSUB=BSUB, interpret=True, emode=mode == "emode", **kwc)
        jax_out[mode] = _reduce_best(np.asarray(r["bv"]).astype(np.int32),
                                     np.asarray(r["bk"]), M + 1)
    r = _strip_fill(*args, BSUB=BSUB, interpret=True, gmode=True, want_ptr=True, **kwc)
    bv = np.asarray(r["bv"]).astype(np.int32)
    jax_out["gmode"] = bv[np.arange(B), (np.maximum(qlen, 1) - 1) % TI]
    n_pad = qpad.shape[1]
    K = t2.shape[1] - 128  # diagonals per strip in the JAX stream
    jax_out["P"] = np.asarray(r["P"]).reshape(B // BSUB, n_pad // TI, K, BSUB, TI)
    return dict(sp=sp, q=q, t=t, qlen=qlen, tlen=tlen, qpad=qpad, t2=t2,
                jax=jax_out, tables=tables_from_params(sp, "cpu"))


def _port(case, mode, want_ptr=False):
    qpad, t2 = prep_strip(case["q"], case["t"], case["qlen"], case["tlen"],
                          case["tables"].A1, "cpu")
    ql = torch.as_tensor(case["qlen"], dtype=torch.int32)
    tl = torch.as_tensor(case["tlen"], dtype=torch.int32)
    return strip_fill(qpad, t2, ql, tl, case["tables"], mq=M, mode=mode,
                      want_ptr=want_ptr)


def _oracle_fill(case, b, local):
    qb = case["q"][b, : case["qlen"][b]]
    tb = case["t"][b, : case["tlen"][b]]
    return oracle_fast._gotoh_fill(qb, tb, case["sp"], local=local)


def test_prep_matches_jax(case):
    qpad, t2 = prep_strip(case["q"], case["t"], case["qlen"], case["tlen"],
                          case["tables"].A1, "cpu")
    np.testing.assert_array_equal(qpad.numpy(), case["qpad"].astype(np.int32))
    np.testing.assert_array_equal(t2.numpy(), case["t2"].astype(np.int32))


@pytest.mark.parametrize("mode", ["local", "emode"])
def test_best_cell_matches_jax_and_oracle(case, mode):
    before = dict(launches)
    r = _port(case, mode)
    assert launches == before  # the CPU path runs the plain version
    got = [x.numpy() for x in reduce_best(r["bv"], r["bk"], M + 1)]
    for g, w in zip(got, case["jax"][mode]):
        np.testing.assert_array_equal(g, w)
    for b in range(B):
        H = _oracle_fill(case, b, local=mode == "local")[0]
        assert tuple(int(x[b]) for x in got) == _argmax_first(H), b


def test_gmode_capture_matches_jax_and_oracle(case):
    got = _port(case, "gmode", want_ptr=True)["bv"].numpy()
    live = (case["qlen"] > 0) & (case["tlen"] > 0)
    np.testing.assert_array_equal(got[live], case["jax"]["gmode"][live])
    assert (got[~live] == 0).all()  # the host resolves degenerate pairs
    for b in np.nonzero(live)[0]:
        H = _oracle_fill(case, b, local=False)[0]
        assert got[b] == H[case["qlen"][b], case["tlen"][b]]


@pytest.mark.parametrize("mode", ["gmode", "local"])
def test_pointer_bytes_match_jax_and_oracle(case, mode):
    P = _port(case, mode, want_ptr=True)["P"].numpy()
    assert P.shape == (B, case["qpad"].shape[1], case["t2"].shape[1] - 1)
    affine = case["sp"].is_affine
    for b in range(B):
        n, m = int(case["qlen"][b]), int(case["tlen"][b])
        box = P[b, :n, :m]
        # nothing outside the valid box is written
        assert P[b].sum(dtype=np.int64) == box.sum(dtype=np.int64)
        if n == 0 or m == 0:
            continue
        _, PH, EXT_E, EXT_F = _oracle_fill(case, b, local=mode == "local")
        want = PH[1:, 1:].astype(np.int64)
        if affine:
            want = want | (EXT_E[1:, 1:] << 2) | (EXT_F[1:, 1:] << 3)
        np.testing.assert_array_equal(box, want, err_msg=f"pair {b}")
        if mode == "gmode":
            # JAX stream: cell (i, j) at [gb, s, j + p, pr, p], i = s*TI + p + 1
            ii, jj = np.meshgrid(np.arange(1, n + 1), np.arange(1, m + 1),
                                 indexing="ij")
            p = (ii - 1) % TI
            jp = case["jax"]["P"][b // BSUB, (ii - 1) // TI, jj + p, b % BSUB, p]
            np.testing.assert_array_equal(box, jp.view(np.uint8), err_msg=f"pair {b}")


def test_emode_refuses_pointers(case):
    with pytest.raises(ValueError, match="emode"):
        _port(case, "emode", want_ptr=True)


def test_lengths_past_the_letter_arrays_are_refused():
    sp = ScoringParams.linear()
    tables = tables_from_params(sp, "cpu")
    q = torch.zeros((1, 4), dtype=torch.int32)
    t2 = torch.zeros((1, 6), dtype=torch.int32)
    for ql, tl in ((5, 3), (2, 6), (-1, 1)):
        with pytest.raises(ValueError, match="exceeds"):
            strip_fill(q, t2, torch.tensor([ql], dtype=torch.int32),
                       torch.tensor([tl], dtype=torch.int32), tables, mq=5,
                       mode="local")


@pytest.mark.parametrize("nq,warps", [(0, 1), (1, 1), (31, 1), (32, 1), (33, 2), (64, 2),
                                      (65, 3), (255, 8), (256, 8), (257, 8), (1024, 8),
                                      (1029, 8)])
def test_strip_warps_is_one_per_strip_up_to_eight(nq, warps):
    assert strip_warps(nq) == warps
    assert 1 <= warps <= MAX_WARPS


@pytest.mark.parametrize("A1,W,warps", [(21, 1025, 8), (5, 257, 1), (21, 6000, 8),
                                        (21, 20_000, 8), (64, 1025, 8)])
def test_strip_smem_keeps_the_letters_then_the_row_while_they_fit(A1, W, warps):
    base = 8 * (warps - 1) * RING + 4 * ((A1 + 1) ** 2 + 3 * MAX_WARPS)
    nbytes, letters, row = strip_smem(A1, W, warps)
    assert letters == (base + 4 * W <= SMEM_BUDGET)
    assert row == (base + 4 * W * letters + 8 * W <= SMEM_BUDGET)
    assert nbytes == base + 4 * W * letters + 8 * W * row <= max(SMEM_BUDGET, base)
    if (A1, W) == (21, 1025):  # config 3: both in shared memory, 4 CTAs per SM
        assert letters and row and 4 * nbytes <= 227 * 1024
