import json
import re
from pathlib import Path

import pytest
import torch

import added
import cells
import run

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_and_metric_of_the_benchmark_is_found():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [w["name"] for w in spec["workloads"]]
    for w in spec["workloads"]:
        c = cells.load(w["name"])
        assert c.config["name"] == w["config"] and c.chips == w["chips"] == 1
        assert {m["name"].split(".")[0] for m in c.end_to_end} == {"setup_s", "gcups", "call_p95_ms"}
        assert c.per_layer
    reports = {e["name"]: set(e.get("workloads", names)) for e in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert callable(cells.reader(m["name"]))
        # every cell that reports a per-layer metric reports the one it moves
        assert set(m.get("workloads", names)) <= reports[m["moves"]]


def test_the_benchmark_file_keeps_the_contract_s_shapes():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in spec[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_a_cell_metric_and_configuration_added_as_files_alone_are_found(tmp_path):
    metric = "def read(window):\n    return float(len(window.calls)) or None\n"
    c = added.add_cell(tmp_path, added.BANDED, dict(added.BANDED_READS, length=1000, batch=64),
                       cell="reads_banded.1kb", metrics={"calls_traced": metric})
    assert c.config["band"] == 16 and c.traffic["length"] == 1000
    assert [m["name"] for m in c.end_to_end] == ["setup_s", "gcups.reads_banded"]
    sc = cells.scoring(c.config, c.traffic["alphabet"], c.bench_dir)
    assert (sc.mode, sc.band, sc.gap_open, int(sc.table[0, 0]), int(sc.table[0, 1])) == \
        ("global", 16, -5, 2, -3)
    # a metric split by family reads the file before its last dot
    assert cells.reader("host_lead_ms.sp") is not None
    read = cells.reader("calls_traced", bench_dir=c.bench_dir)

    class W:
        calls = [1, 2, 3]

    assert read(W()) == 3.0
    old = cells.load("long_pair_sp.score", root=tmp_path, bench_dir=c.bench_dir)
    assert "gcups.reads_banded" not in [m["name"] for m in old.end_to_end]


def test_a_named_matrix_is_read_from_its_file():
    blosum = cells.read_matrix(ROOT / "benchmark" / "matrices" / "blosum62.txt")
    assert blosum.shape == (24, 24) and (blosum == blosum.T).all()
    letters = "ARNDCQEGHILKMFPSTWYVBZX*"
    assert blosum[letters.index("W"), letters.index("W")] == 11
    assert blosum[letters.index("C"), letters.index("C")] == 9
    assert blosum[letters.index("A"), letters.index("R")] == -1
    sc = cells.scoring({"mode": "local", "scoring": {"matrix": "blosum62", "gap_open": -10,
                                                     "gap_extend": -1}}, 20)
    assert sc.matrix is sc.table and sc.mode == "local" and sc.band is None


PROTEIN = {"name": "protein_local", "mode": "local",
           "scoring": {"matrix": "blosum62", "gap_open": -10, "gap_extend": -1}, "mesh": 1}


def _run(cell):
    result, compared = run.run_cell(cell, 2**31 + 99, 0.3, False, torch.device("cpu"))
    assert result["attempted"] > 0 and result["failed"] == 0
    return result["correct"], compared["wrong"][0]


@pytest.mark.parametrize("answers", ["alignment", "score"])
def test_a_local_protein_cell_added_as_files_alone_runs_and_is_correct(tmp_path, monkeypatch,
                                                                       answers):
    monkeypatch.setattr(run, "WARMUP_S", 0.1)
    traffic = {"alphabet": 20, "length": [40, 70], "batch": 6, "pool": 2, "check": 12,
               "substitution_rate": 0.15, "indel_rate": 0.03, "indel_length": [1, 4],
               "request": {"entry": "align_batch", "args": ["$queries", "$targets"],
                           "kwargs": {"scoring": "$scoring", "mode": "$mode",
                                      "traceback": answers == "alignment", "device": "$device"},
                           "answers": answers}}
    cell = added.add_cell(tmp_path, PROTEIN, traffic)
    assert _run(cell) == (True, 0)
    # the same cell judged under the configuration's other mode is wrong
    cell.config = dict(cell.config, mode="global")
    monkeypatch.setitem(cell.traffic["request"]["kwargs"], "mode", "local")
    ok, wrong = _run(cell)
    assert not ok and wrong > 0


def test_an_all_against_all_cell_added_as_files_alone_runs_and_is_correct(tmp_path,
                                                                          monkeypatch):
    monkeypatch.setattr(run, "WARMUP_S", 0.1)
    traffic = {"alphabet": 20, "length": [30, 50], "batch": 3, "targets": 4, "pool": 1,
               "check": 12, "target": "random", "target_length": [40, 80],
               "request": {"entry": "align_all_vs_all", "args": ["$queries", "$targets"],
                           "kwargs": {"scoring": "$scoring", "mode": "$mode",
                                      "device": "$device"},
                           "pairing": "all_vs_all", "answers": "score"}}
    assert _run(added.add_cell(tmp_path, PROTEIN, traffic)) == (True, 0)
