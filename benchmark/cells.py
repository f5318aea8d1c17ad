"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``: the mode, the
scoring, the band, the mesh and the guarantees of a deployment) and a
traffic mix (``traffic/<traffic>.json``: what ``generate.py`` makes and how
the call is made).  A per-layer metric is ``metrics/<name>.py``, whose
``read(window)`` returns the value or None when it finds nothing to read.
A named substitution matrix is ``matrices/<name>.txt``.  A later cell,
configuration, matrix or metric is added as files and entries alone.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

import reference

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports
    bench_dir: Path = HERE


@dataclass
class Scoring:
    """A configuration's mode and scoring, as both the call and the
    reference take them: ``table[a, b]`` scores letter code ``a`` of the
    query against ``b`` of the target; ``matrix`` is None for a
    match/mismatch scoring."""
    mode: str
    table: np.ndarray
    gap_open: int
    gap_extend: int
    band: int | None
    match: int | None = None
    mismatch: int | None = None
    matrix: np.ndarray | None = None


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = HERE.parent, bench_dir: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files read from
    ``bench_dir``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
        bench_dir=bench_dir,
    )


def read_matrix(path: Path) -> np.ndarray:
    """A substitution matrix in the NCBI text layout: ``#`` comments, a
    header of letters, then a row per letter.  Letter code ``k`` is the
    header's ``k``-th letter."""
    rows = [ln.split() for ln in path.read_text().splitlines()
            if ln.strip() and not ln.startswith("#")]
    letters = rows[0]
    table = np.array([[int(v) for v in r[1:]] for r in rows[1:]], np.int64)
    if [r[0] for r in rows[1:]] != letters or table.shape != (len(letters),) * 2:
        raise ValueError(f"{path}: not a square matrix in the header's letter order")
    return table


def scoring(config: dict, letters: int, bench_dir: Path = HERE) -> Scoring:
    """The one reading of a configuration's ``mode``, ``scoring`` and
    ``band``.  ``scoring`` is ``{match, mismatch, gap_open, gap_extend}`` or
    ``{matrix: <name of matrices/<name>.txt>, gap_open, gap_extend}``;
    ``letters`` sizes a match/mismatch table."""
    s = config["scoring"]
    mode = config["mode"]
    if mode not in ("global", "local"):
        raise ValueError(f"mode must be global or local, got {mode!r}")
    if "matrix" in s:
        table = read_matrix(bench_dir / "matrices" / f"{s['matrix']}.txt")
        if letters > len(table):
            raise ValueError(f"{letters} letters drawn, the matrix scores {len(table)}")
        return Scoring(mode, table, int(s["gap_open"]), int(s["gap_extend"]),
                       config.get("band"), matrix=table)
    table = reference.substitution_table(int(s["match"]), int(s["mismatch"]), letters)
    return Scoring(mode, table, int(s["gap_open"]), int(s["gap_extend"]), config.get("band"),
                   match=int(s["match"]), mismatch=int(s["mismatch"]))


def reader(metric: str, bench_dir: Path = HERE):
    """The ``read`` function of ``metrics/<metric>.py``, or, for a metric
    split by the end-to-end metric it moves (``host_lead_ms.sp``), of the
    file named before its last dot (``metrics/host_lead_ms.py``)."""
    path = bench_dir / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = bench_dir / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
