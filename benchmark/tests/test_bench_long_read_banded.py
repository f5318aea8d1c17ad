"""The ultra-long read cell ``long_read_banded.100kb``: it loads by name,
its pool has the lengths and the spread of length differences it claims,
a cut of it runs ``correct`` on the CPU and is found wrong under the
``linear_gaps`` control, and its span readers return None on a window of
a program without the spans."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import added
import cells
import control
import drive
import generate
import run
import spans

ROOT = Path(__file__).resolve().parents[2]
CELL = "long_read_banded.100kb"
SEED = 2**31 + 2024
READERS = {"band_stage_ms.lr": "seqalib.banded.stage",
           "band_ops_copy_ms.lr": "seqalib.banded.ops_copy",
           "band_cigar_ms.lr": "seqalib.banded.cigar"}


def test_the_cell_loads_by_name_with_its_configuration_and_metrics():
    c = cells.load(CELL)
    assert c.chips == 1 and c.config["name"] == "long_read_banded"
    assert (c.config["mode"], c.config["band"], c.config["mesh"], c.config["reduced"]) == \
        ("global", 128, 1, [])
    sc = cells.scoring(c.config, c.traffic["alphabet"])
    assert (sc.match, sc.mismatch, sc.gap_open, sc.gap_extend) == (2, -4, -4, -2)
    assert [m["name"] for m in c.end_to_end] == ["gcups.sp_cigar", "call_p95_ms.sp_cigar",
                                                 "setup_s"]
    assert [m["name"] for m in c.per_layer] == [
        "band_fill.roofline_pct.lr", "device_busy_pct.lr", "launch_gap_ms.lr",
        *READERS, "host_lead_ms.lr", "host_tail_ms.lr"]
    assert all(callable(cells.reader(m["name"])) for m in c.per_layer)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (cfg,) = [x for x in spec["configs"] if x["name"] == "long_read_banded"]
    assert cfg["source"] == c.config["source"] and len(cfg["source"]) <= 200


def test_a_batch_holds_reads_in_range_each_with_its_own_length_difference():
    traffic = dict(cells.load(CELL).traffic, pool=1)
    (qs, ts), = generate.pool(SEED, traffic)
    assert len(qs) == len(ts) == 132
    assert all(80000 <= len(q) <= 120000 for q in qs)
    deltas = [len(t) - len(q) for q, t in zip(qs, ts)]
    assert len(set(deltas)) >= 100
    assert len({d // 128 for d in deltas}) >= 4 and max(deltas) < 0  # deletion-biased


def _cut(tmp_path):
    c = cells.load(CELL)
    traffic = dict(c.traffic, length=240, batch=8)
    return added.add_cell(tmp_path, c.config, traffic, cell="long_read_banded.cut")


def test_a_cut_of_the_cell_runs_correct_and_the_linear_gaps_control_is_wrong(tmp_path,
                                                                             monkeypatch):
    monkeypatch.setattr(run, "WARMUP_S", 0.1)
    cell = _cut(tmp_path)
    assert cell.config["band"] == 128 and cell.traffic["batch"] == 8
    result, compared = run.run_cell(cell, SEED, 0.3, False, torch.device("cpu"))
    assert result["attempted"] > 0 and result["failed"] == 0
    assert (result["correct"], compared["wrong"][0]) == (True, 0)

    def linear_gaps(st, sc, config, request, device):
        return lambda qs, ts: control.answers(sc, request, qs, ts,
                                              **control.CONTROLS["linear_gaps"])

    monkeypatch.setattr(drive, "make_call", linear_gaps)
    result, compared = run.run_cell(cell, SEED, 0.3, False, torch.device("cpu"))
    assert not result["correct"] and compared["wrong"][0] > 0


W = {"pairs": [(100, 96)], "band": 128, "traceback": True}
CALLS = [("bench.call", 0, 100), ("bench.call", 110, 200)]
OPS = [("void band_fill_kernel<0>(Args)", 20, 40), ("void band_fill_kernel<1>(Args)", 130, 170)]
MARKS = [("seqalib.align_batch", 1, 99), ("seqalib.banded.group", 2, 98),
         ("seqalib.banded.stage", 3, 19), ("seqalib.banded.fill", 19, 41),
         ("seqalib.banded.ops_copy", 50, 60), ("seqalib.banded.cigar", 60, 97),
         ("seqalib.align_batch", 111, 199), ("seqalib.banded.group", 112, 150),
         ("seqalib.banded.stage", 113, 125), ("seqalib.banded.ops_copy", 170, 174),
         ("seqalib.banded.cigar", 175, 190)]


@pytest.mark.parametrize("name", sorted(READERS))
def test_the_span_readers_read_their_span_and_none_without_it(name):
    bare = spans.build_window(CALLS, OPS, [], [W, W])
    assert cells.reader(name)(bare) is None
    w = spans.build_window(CALLS, OPS, MARKS, [W, W])
    span = READERS[name]
    want = np.mean([sum(e - s for n, s, e in MARKS if n == span and a <= s <= b)
                    for _, a, b in CALLS])
    assert cells.reader(name)(w) == pytest.approx(want / 1e6)
