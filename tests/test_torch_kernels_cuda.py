"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
device.  These tests skip without one (``chip_smoke.py`` checks the
kernels on the card at the main path's shapes).  On a machine with a card:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Exact equality: the kernels do integer DP."""

import numpy as np
import pytest
import torch

from seqalib_tpu import oracle_fast
from seqalib_tpu.types import ScoringParams
from seqalib_tpu_torch import align_batch
from seqalib_tpu_torch.ops import launches
from seqalib_tpu_torch.ops.row_window import row_window, row_window_ref
from seqalib_tpu_torch.ops.strip import prep_strip
from seqalib_tpu_torch.ops.strip_fill import strip_fill, strip_fill_ref
from seqalib_tpu_torch.ops.strip_walk import strip_walk, strip_walk_ref
from seqalib_tpu_torch.scoring import tables_from_params

pytestmark = pytest.mark.cuda

SCORINGS = {
    "dna_linear": (ScoringParams.linear(), 4),
    "dna_affine": (ScoringParams.affine(), 4),
    "blosum62_affine": (ScoringParams.blosum62(gap_open=-10, gap_extend=-1), 20),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; kernels are checked by chip_smoke.py")
    return torch.device("cuda")


def _batch(alpha, dev, B=37, n=150, m=170, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, alpha, size=(B, n))
    t = rng.integers(0, alpha, size=(B, m))
    t[:, 20:90] = q[:, 30:100]
    qlen = rng.integers(0, n + 1, size=B)
    tlen = rng.integers(0, m + 1, size=B)
    qlen[0], tlen[0] = n, m
    qpad, t2 = prep_strip(q, t, qlen, tlen, alpha + 1, dev)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)
    return qpad, t2, as_t(qlen), as_t(tlen), m


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
@pytest.mark.parametrize("mode,want_ptr", [("local", False), ("local", True),
                                           ("emode", False), ("gmode", True)])
def test_strip_fill_kernel_matches_plain_version(dev, scoring, mode, want_ptr):
    sp, alpha = SCORINGS[scoring]
    tables = tables_from_params(sp, dev)
    qpad, t2, ql, tl, m = _batch(alpha, dev)
    before = launches[f"strip_fill/{mode}"]
    got = strip_fill(qpad, t2, ql, tl, tables, mq=m, mode=mode, want_ptr=want_ptr)
    torch.cuda.synchronize()
    assert launches[f"strip_fill/{mode}"] == before + 1
    want = strip_fill_ref(qpad, t2, ql, tl, tables, mq=m, mode=mode, want_ptr=want_ptr)
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_strip_walk_kernel_matches_plain_version(dev, scoring):
    sp, alpha = SCORINGS[scoring]
    tables = tables_from_params(sp, dev)
    qpad, t2, ql, tl, m = _batch(alpha, dev, seed=1)
    P = strip_fill(qpad, t2, ql, tl, tables, mq=m, mode="gmode", want_ptr=True)["P"]
    args = (P, ql, tl, torch.zeros_like(ql), ((ql == 0) | (tl == 0)).int())
    before = launches["strip_walk"]
    got = strip_walk(*args, affine=tables.affine)
    torch.cuda.synchronize()
    assert launches["strip_walk"] == before + 1
    want = strip_walk_ref(*args, affine=tables.affine)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lo", [0, 1])
def test_row_window_kernel_matches_plain_version(dev, lo):
    rng = np.random.default_rng(lo)
    src = torch.as_tensor(rng.integers(0, 30, size=(40, 300)), dtype=torch.int32, device=dev)
    starts = torch.as_tensor(rng.integers(0, 200, size=40), dtype=torch.int32, device=dev)
    hi = torch.as_tensor(rng.integers(0, 100, size=40), dtype=torch.int32, device=dev)
    before = launches["row_window"]
    got = row_window(src, starts, hi, L=128, lo=lo, fill=-1)
    torch.cuda.synchronize()
    assert launches["row_window"] == before + 1
    assert torch.equal(got, row_window_ref(src, starts, hi, L=128, lo=lo, fill=-1))


@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_align_batch_on_cuda_matches_oracle(dev, mode, scoring):
    sp, alpha = SCORINGS[scoring]
    rng = np.random.default_rng(7)
    qs = [rng.integers(0, alpha, size=rng.integers(0, 300)).astype(np.uint8) for _ in range(24)]
    ts = [rng.integers(0, alpha, size=rng.integers(0, 300)).astype(np.uint8) for _ in range(24)]
    ts[3] = qs[3].copy()
    got = align_batch(qs, ts, scoring=sp, mode=mode, device=dev)
    for q, t, r in zip(qs, ts, got):
        assert str(r) == str(oracle_fast.align_oracle(q, t, sp, mode=mode))
