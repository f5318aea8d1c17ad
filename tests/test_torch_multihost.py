"""The port's multi-process branch: two ranks of
``python -m seqalib_tpu_torch.parallel.dist_check`` on the CPU, joined in a
gloo group through a ``FileStore`` under ``tmp_path``, each with a pair
mesh of 2 CPU entries, so that every bucket is cut into 4 shards,
rank-major, and ``gather_to_host`` all-gathers the results.  The
counterpart of ``tests/test_multihost.py``; the workers load no JAX.

Every rendezvous and collective has a 60 s timeout in the worker; the
test gives the workers 180 s and kills both on expiry."""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

import seqalib_tpu_torch as st

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = "seqalib_tpu_torch.parallel.dist_check"
TIMEOUT = 180


def _run_ranks(tmp_path, *extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    store = str(tmp_path / "store")
    procs = [
        subprocess.Popen([sys.executable, "-m", WORKER, "--rank", str(r), "--world", "2",
                          "--store", store, "--device", "cpu", "--mesh", "2",
                          *extra],
                         cwd=REPO, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the pair-mesh workers timed out\n" + "\n".join(outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert f"PAIRMESH-OK r{r}" in out, out[-2000:]
    return outs


def test_two_process_pair_mesh(tmp_path):
    _run_ranks(tmp_path)


def _hash(res):
    return hashlib.blake2b("\n".join(map(str, res)).encode(), digest_size=16).hexdigest()


def _ranks_return(tmp_path, q, t, qlen, tlen, sp, mode, band=None, backend="pallas"):
    """Both ranks align the batch given as a file on ``backend`` and return
    the whole batch: the hash of their results equals one process's, which
    is returned."""
    B = len(qlen)
    path = str(tmp_path / "batch.npz")
    extra = {} if band is None else {"band": band}
    if backend != "pallas":
        extra["backend"] = backend
    np.savez(path, q=q, t=t, qlen=qlen, tlen=tlen, match=sp.match, mismatch=sp.mismatch,
             gap_open=sp.gap_open, gap_extend=sp.gap_extend,
             matrix=np.zeros(0) if sp.matrix is None else sp.matrix, mode=mode, **extra)
    res = st.align_batch([q[b, : qlen[b]] for b in range(B)],
                         [t[b, : tlen[b]] for b in range(B)], scoring=sp, mode=mode,
                         band=band, backend=backend, device="cpu")
    outs = _run_ranks(tmp_path, "--inputs", path, "--reps", "1")
    for r, out in enumerate(outs):
        assert f"PAIRMESH-HASH r{r} {_hash(res)}" in out, out[-2000:]
        assert f"PAIRMESH-WALL r{r} " in out
    return res


def test_two_processes_return_the_single_process_batch(tmp_path):
    """Both ranks align a BLOSUM62 batch given as a file and return the
    whole batch: the hash of its results equals one process's."""
    rng = np.random.default_rng(3)
    B, L = 11, 70
    q = rng.integers(0, 20, size=(B, L)).astype(np.uint8)
    t = rng.integers(0, 20, size=(B, L)).astype(np.uint8)
    qlen = rng.integers(1, L + 1, size=B)
    tlen = rng.integers(1, L + 1, size=B)
    sp = st.ScoringParams.blosum62(gap_open=-10, gap_extend=-1)
    _ranks_return(tmp_path, q, t, qlen, tlen, sp, "local")


def test_two_processes_run_the_wide_table_route(tmp_path):
    """The wide-table route (2 x BLOSUM62, o=-20, e=-2, band 6) in a world
    of two ranks, four shards, every rank returning the whole batch: equal
    to one process's and to the oracle, a ragged bucket with an empty
    target among its pairs."""
    from seqalib_tpu_torch.oracle_fast import align_oracle

    rng = np.random.default_rng(5)
    B, L = 9, 60
    q = rng.integers(0, 20, size=(B, L)).astype(np.uint8)
    t = np.concatenate([q[:, 2:], rng.integers(0, 20, size=(B, 2))], axis=1).astype(np.uint8)
    t[:, ::9] = rng.integers(0, 20, size=t[:, ::9].shape)
    qlen = rng.integers(L - 20, L + 1, size=B)
    tlen = np.clip(qlen + rng.integers(-5, 6, size=B), 0, L)
    tlen[4] = 0
    sp = st.ScoringParams(gap_open=-20, gap_extend=-2, matrix=2 * st.BLOSUM62)
    res = _ranks_return(tmp_path, q, t, qlen, tlen, sp, "global", band=6)
    want = [align_oracle(q[b, : qlen[b]], t[b, : tlen[b]], sp, mode="global", band=6)
            for b in range(B)]
    assert list(map(str, res)) == list(map(str, want))
    assert any("I" in r.cigar and "D" in r.cigar for r in res)


def test_two_processes_run_xla_with_a_band(tmp_path):
    """``backend="xla"`` with a band and a DNA table (which ``"pallas"``
    sends to the banded route, refused in a world of two) in a world of
    two ranks, four shards of the full-matrix wavefront: every rank returns
    the one-process batch, equal to the oracle."""
    from seqalib_tpu_torch.oracle_fast import align_oracle

    rng = np.random.default_rng(8)
    B, L = 9, 60
    q = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    t = np.concatenate([q[:, 3:], rng.integers(0, 4, size=(B, 3))], axis=1).astype(np.uint8)
    t[:, ::7] = rng.integers(0, 4, size=t[:, ::7].shape)
    qlen = rng.integers(L - 20, L + 1, size=B)
    tlen = np.clip(qlen + rng.integers(-5, 6, size=B), 0, L)
    tlen[2] = 0
    sp = st.ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
    res = _ranks_return(tmp_path, q, t, qlen, tlen, sp, "global", band=6, backend="xla")
    want = [align_oracle(q[b, : qlen[b]], t[b, : tlen[b]], sp, mode="global", band=6)
            for b in range(B)]
    assert list(map(str, res)) == list(map(str, want))


def test_two_processes_read_the_pass2_band(tmp_path, monkeypatch):
    """Fault 9 in a world of two ranks: every rank reads SEQALIB_FUSED_BW, as
    the JAX package's ranks do.  Four copies of the pinned co-optimal tie of
    ``tests/test_fused_tie_boundary.py`` (its canonical cell 70 diagonals
    off the anchor), one a shard: under a band of 128 every shard returns
    the canonical start (35, 0), as one process does; under the default
    band of 64 the in-band start (0, 35)."""
    from test_fused_tie_boundary import _tie_problem

    q, t, sp = _tie_problem()
    psp = st.ScoringParams(gap_open=sp.gap_open, gap_extend=sp.gap_extend, matrix=sp.matrix)
    B = 4
    qs, ts = np.tile(q, (B, 1)), np.tile(t, (B, 1))
    lens = (np.full(B, len(q)), np.full(B, len(t)))
    monkeypatch.setenv("SEQALIB_FUSED_PASS2", "banded")
    monkeypatch.setenv("SEQALIB_FUSED_BW", "128")
    res = _ranks_return(tmp_path, qs, ts, *lens, psp, "local")
    assert [(r.query_start, r.target_start) for r in res] == [(35, 0)] * B
    monkeypatch.delenv("SEQALIB_FUSED_BW")
    res = st.align_batch(list(qs), list(ts), scoring=psp, mode="local", device="cpu")
    assert [(r.query_start, r.target_start) for r in res] == [(0, 35)] * B


def test_worker_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``--device`` the worker asks for the card and raises where
    there is none, before it joins a rendezvous."""
    import torch

    from seqalib_tpu_torch.parallel import dist_check

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist_check.main(["--rank", "0", "--world", "2", "--store", str(tmp_path / "s")])
    assert not (tmp_path / "s").exists()
