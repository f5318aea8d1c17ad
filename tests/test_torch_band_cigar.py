"""``band_cigar``'s plain version (on the CPU) against ``op_rows_to_cigars``
and ``ops_to_cigar``, decoded through ``cigars_from_text``; and the CPU
branch of ``banded_align_batch``, which still encodes its op rows on the
host.  The kernel is held to the plain version on the same cases by
``test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from seqalib_tpu_torch.models import banded
from seqalib_tpu_torch.oracle import nw_affine
from seqalib_tpu_torch.ops import launches
from seqalib_tpu_torch.ops.band_cigar import band_cigar, text_width
from seqalib_tpu_torch.scoring import scoring_params
from seqalib_tpu_torch.utils.cigar import (OP_D, OP_I, OP_M, OP_PAD, cigars_from_text,
                                          op_rows_to_cigars, ops_to_cigar)


def _rows(*rows):
    """One (B, KW) op matrix of the rows, each padded at its end."""
    KW = max(len(r) for r in rows)
    out = np.full((len(rows), KW), OP_PAD, np.uint8)
    for b, r in enumerate(rows):
        out[b, : len(r)] = r
    return out


def _pads_around():
    P = OP_PAD
    return _rows([P, P, OP_M, OP_M, P, OP_M, P, P, OP_I, P, OP_I, OP_D, P, P, P],
                 [OP_D, P, OP_D, P, OP_M, OP_M, OP_M, P],
                 [P] * 7 + [OP_I])


def _alternating():
    """2 characters an op: the text fills its width exactly."""
    return _rows([OP_M, OP_I] * 1500 + [OP_M], [OP_D, OP_M, OP_I] * 1000)


def _digit_edges():
    return _rows([OP_M] * 9 + [OP_I] * 10 + [OP_M] * 99 + [OP_D] * 100,
                 [OP_D] * 99_999 + [OP_M] * 100_000,
                 [OP_I] * 100_000 + [OP_PAD] * 5 + [OP_I] + [OP_M],
                 [OP_M] * 99_999)


def _walk_like(B, KW, seed):
    """B rows of runs of 1-600 ops (mostly M) with OP_PAD after about half
    the ops, as the banded walk's joined blocks hold them, and a few rows
    of pads alone."""
    rng = np.random.default_rng(seed)
    out = np.full((B, KW), OP_PAD, np.uint8)
    for b in range(B):
        if b % 40 == 7:
            continue
        ops = []
        while len(ops) < KW // 2:
            op = rng.choice([OP_M, OP_I, OP_D], p=[0.8, 0.1, 0.1])
            ops += [op] * int(rng.integers(1, 600 if op == OP_M else 4))
        ops = np.array(ops[: KW // 2], np.uint8)
        cols = np.sort(rng.choice(KW, len(ops), replace=False))
        out[b, cols] = ops
    return out


CASES = {
    "pads_before_between_after": _pads_around,
    "all_pad_row": lambda: np.full((3, 37), OP_PAD, np.uint8),
    "no_columns": lambda: np.zeros((2, 0), np.uint8),
    "single_op": lambda: _rows([OP_D]),
    "single_op_among_pads": lambda: _rows([OP_PAD] * 20 + [OP_I] + [OP_PAD] * 4),
    "alternating_ops": _alternating,
    "runs_of_9_10_99999_100000": _digit_edges,
    "batch_of_1": lambda: _walk_like(1, 5_000, seed=1),
    "batch_of_132": lambda: _walk_like(132, 3_001, seed=2),
}


def _want(ops):
    """Each row's CIGAR by the plain per-row encoder, its pads dropped."""
    return [ops_to_cigar(row[row != OP_PAD].tolist()) for row in ops]


@pytest.mark.parametrize("case", sorted(CASES))
def test_band_cigar_plain_version_equals_the_host_encoders(case):
    ops = CASES[case]()
    before = launches["band_cigar"]
    text, nchar = band_cigar(torch.from_numpy(ops))
    assert launches["band_cigar"] == before  # a CPU tensor launches nothing
    B, KW = ops.shape
    assert text.shape == (B, text_width(KW)) and text.dtype == torch.uint8
    assert nchar.shape == (B,) and nchar.dtype == torch.int32
    got = cigars_from_text(text, nchar)
    assert got == op_rows_to_cigars(ops) == _want(ops)
    assert nchar.tolist() == [len(c) for c in got]
    if case == "alternating_ops":
        assert int(nchar[0]) == text_width(KW)
    if case == "all_pad_row":
        assert got == ["", "", ""]


def test_banded_align_batch_on_the_cpu_encodes_on_the_host(monkeypatch):
    """``banded_align_batch``'s CPU branch copies its op rows and calls the
    module's own ``op_rows_to_cigars`` (which the benchmark's fault test
    replaces); it never calls ``band_cigar``."""
    rng = np.random.default_rng(5)
    qlen, tlen = np.array([60, 41, 0, 75]), np.array([57, 49, 6, 75])
    qs = rng.integers(0, 4, (4, 75)).astype(np.int32)
    ts = qs.copy()
    ts[:, 30:] = rng.integers(0, 4, (4, 45))
    real, calls = banded.op_rows_to_cigars, []

    def recorded(ops, *a, **kw):
        calls.append(ops.shape)
        return real(ops, *a, **kw)

    def refused(*a, **kw):
        raise AssertionError("band_cigar called on the CPU")

    monkeypatch.setattr(banded, "op_rows_to_cigars", recorded)
    monkeypatch.setattr(banded, "band_cigar", refused)
    sp = scoring_params(2, -3, -5, -2)
    got = banded.banded_align_batch(qs, ts, qlen, tlen, sp, 6, CK=16, device="cpu")
    assert len(calls) == 1 and calls[0][0] == 4
    want = [str(nw_affine(qs[b, : qlen[b]], ts[b, : tlen[b]], sp, band=6)) for b in range(4)]
    assert [str(r) for r in got] == want
