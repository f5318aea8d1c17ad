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


def test_two_processes_return_the_single_process_batch(tmp_path):
    """Both ranks align a BLOSUM62 batch given as a file and return the
    whole batch: the hash of its results equals one process's."""
    rng = np.random.default_rng(3)
    B, L = 11, 70
    q = rng.integers(0, 20, size=(B, L)).astype(np.uint8)
    t = rng.integers(0, 20, size=(B, L)).astype(np.uint8)
    qlen = rng.integers(1, L + 1, size=B)
    tlen = rng.integers(1, L + 1, size=B)
    path = str(tmp_path / "batch.npz")
    np.savez(path, q=q, t=t, qlen=qlen, tlen=tlen, match=0, mismatch=0, gap_open=-10,
             gap_extend=-1, matrix=st.BLOSUM62, mode="local")
    sp = st.ScoringParams.blosum62(gap_open=-10, gap_extend=-1)
    res = st.align_batch([q[b, : qlen[b]] for b in range(B)],
                         [t[b, : tlen[b]] for b in range(B)], scoring=sp, mode="local",
                         device="cpu")
    digest = hashlib.blake2b("\n".join(map(str, res)).encode(), digest_size=16).hexdigest()
    outs = _run_ranks(tmp_path, "--inputs", path, "--reps", "1")
    for r, out in enumerate(outs):
        assert f"PAIRMESH-HASH r{r} {digest}" in out, out[-2000:]
        assert f"PAIRMESH-WALL r{r} " in out


def test_worker_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``--device`` the worker asks for the card and raises where
    there is none, before it joins a rendezvous."""
    import torch

    from seqalib_tpu_torch.parallel import dist_check

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist_check.main(["--rank", "0", "--world", "2", "--store", str(tmp_path / "s")])
    assert not (tmp_path / "s").exists()
