"""Cells added as files alone: a copy of the harness's folder with a new
configuration, traffic mix and ``BENCHMARK.json`` entries, loaded by name
the way a run loads a cell.  Also the banded long-read deployment that
waits for a public source (PERF.md §7), at a size a test holds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import cells

ROOT = Path(__file__).resolve().parents[2]

BANDED = {"name": "reads_banded", "mode": "global",
          "scoring": {"match": 2, "mismatch": -3, "gap_open": -5, "gap_extend": -2},
          "band": 16, "mesh": 1}
BANDED_READS = {
    "alphabet": 4, "length": 240, "batch": 4, "pool": 2, "check": 8,
    "substitution_rate": 0.02,
    "edits": [{"op": "insert", "length": 3}, {"op": "delete", "length": 3}],
    "request": {"entry": "align_batch", "args": ["$queries", "$targets"],
                "kwargs": {"scoring": "$scoring", "mode": "$mode", "band": "$band",
                           "traceback": True, "device": "$device"},
                "answers": "alignment"},
}


def add_cell(tmp_path: Path, config: dict, traffic: dict, cell: str | None = None,
             metrics: dict | None = None) -> cells.Cell:
    """Write ``config`` and ``traffic`` (and ``metrics``: {file name: source})
    as files of a copy of the harness, add their entries to a copy of
    ``BENCHMARK.json``, and load the new cell by its name."""
    bench = tmp_path / "benchmark"
    if not bench.exists():
        shutil.copytree(ROOT / "benchmark", bench,
                        ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg, mix = config["name"], f"{config['name']}_mix"
    cell = cell or f"{cfg}.cell"
    (bench / "configs" / f"{cfg}.json").write_text(json.dumps(config))
    (bench / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
    for name, src in (metrics or {}).items():
        (bench / "metrics" / f"{name}.py").write_text(src)
    spec_path = tmp_path / "BENCHMARK.json"
    spec = json.loads((spec_path if spec_path.exists() else ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": cfg, "source": "https://example.org/x",
                            "file": f"benchmark/configs/{cfg}.json", "reduced": [], "why": "x"})
    spec["workloads"].append({"name": cell, "config": cfg, "traffic": mix, "chips": 1,
                              "why": "x"})
    spec["end_to_end"].append({"name": f"gcups.{cfg}", "unit": "GCUPS", "better": "higher",
                               "bound": 0.05, "source": "host_clock", "workloads": [cell]})
    spec_path.write_text(json.dumps(spec))
    return cells.load(cell, root=tmp_path, bench_dir=bench)
