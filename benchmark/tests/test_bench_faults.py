"""The output check against a broken program: every run here skips the
look for a card and drives the rest of a run on the CPU (the port's plain
versions) at a small size, with the timed path broken underneath, and sees
``correct`` come out false.  The faults a one-card cell can have: an answer
altered where it is produced, half of the batch left out (its answers
copied from the rest).  A step that returns its state unchanged and the
exchange between chips have no place in these cells: no state carries
from call to call, and one card exchanges nothing."""

import pytest
import torch

import added
import cells
import run
import seqalib_tpu_torch.models.banded as banded
import seqalib_tpu_torch.parallel.band_pipeline as band_pipeline
import seqalib_tpu_torch.parallel.dispatch as dispatch

CPU = torch.device("cpu")
SEED = 2**31 + 4242


BANDED = {"reads_banded.cigar": True, "reads_banded.score": False}


def small(name, tmp_path):
    """A benchmark cell at a small size, or the banded long-read cell
    (``added.py``), with or without CIGARs, added as files."""
    if name in BANDED:
        traffic = dict(added.BANDED_READS)
        traffic["request"] = dict(traffic["request"])
        traffic["request"]["kwargs"] = dict(traffic["request"]["kwargs"],
                                            traceback=BANDED[name])
        traffic["request"]["answers"] = "alignment" if BANDED[name] else "score"
        return added.add_cell(tmp_path / name, added.BANDED, traffic, cell=name)
    c = cells.load(name)
    c.traffic.update(length=160)
    return c


@pytest.fixture(autouse=True)
def _short_warmup(monkeypatch):
    monkeypatch.setattr(run, "WARMUP_S", 0.2)


def correct(name, tmp_path):
    result, compared = run.run_cell(small(name, tmp_path), SEED, 0.3, False, CPU)
    assert result["attempted"] > 0
    return result["correct"], compared["wrong"][0]


@pytest.mark.parametrize("name", ["reads_banded.cigar", "reads_banded.score",
                                  "long_pair_sp.score", "long_pair_sp.cigar"])
def test_the_sound_program_is_correct(name, tmp_path):
    assert correct(name, tmp_path) == (True, 0)


def test_an_altered_cigar_is_caught(monkeypatch, tmp_path):
    real = banded.op_rows_to_cigars

    def altered(ops, *a, **kw):
        out = real(ops, *a, **kw)
        return ["1D" + out[0][:-2] + "1I"] + out[1:] if out else out

    monkeypatch.setattr(banded, "op_rows_to_cigars", altered)
    ok, wrong = correct("reads_banded.cigar", tmp_path)
    assert not ok and wrong > 0


@pytest.mark.parametrize("name", sorted(BANDED))
def test_half_of_the_batch_left_out_is_caught(monkeypatch, name, tmp_path):
    real = dispatch.banded_align_batch

    def half(qs, ts, qlen, tlen, *a, **kw):
        h = max(1, len(qs) // 2)
        res = real(qs[:h], ts[:h], qlen[:h], tlen[:h], *a, **kw)
        return [res[b % h] for b in range(len(qs))]

    monkeypatch.setattr(dispatch, "banded_align_batch", half)
    ok, wrong = correct(name, tmp_path)
    assert not ok and wrong > 0


def test_an_altered_score_is_caught(monkeypatch, tmp_path):
    real = band_pipeline._sp_fill

    def off_by_one(*a, **kw):
        out = real(*a, **kw)
        return (out[0] - 1,) + tuple(out[1:])

    monkeypatch.setattr(band_pipeline, "_sp_fill", off_by_one)
    ok, wrong = correct("long_pair_sp.score", tmp_path)
    assert not ok and wrong > 0


def test_an_altered_sp_alignment_is_caught(monkeypatch, tmp_path):
    real = band_pipeline.ops_to_cigar
    monkeypatch.setattr(band_pipeline, "ops_to_cigar", lambda ops: real(ops[::-1]))
    ok, wrong = correct("long_pair_sp.cigar", tmp_path)
    assert not ok and wrong > 0
