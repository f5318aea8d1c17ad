import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def test_the_check_compares_whole_top_level_names():
    assert run.forbidden_modules({"seqalib_tpu_torch": 1, "seqalib_tpu_torch.ops": 1,
                                  "jaxtyping": 1, "numpy": 1}) == []
    assert run.forbidden_modules({"jax": 1, "jax.numpy": 1}) == ["jax", "jax.numpy"]
    assert run.forbidden_modules({"seqalib_tpu.api": 1}) == ["seqalib_tpu.api"]
    assert run.forbidden_modules({"jaxlib": 1, "flax.linen": 1}) == ["flax.linen", "jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & set(run.FORBIDDEN), path


def test_the_yardstick_imports_nothing_of_the_program():
    for name in ("reference.py", "roofline.py", "generate.py", "spans.py", "control.py"):
        assert "seqalib_tpu_torch" not in set(_imports(BENCH / name)), name
    for path in (BENCH / "metrics").glob("*.py"):
        assert "seqalib_tpu_torch" not in set(_imports(path)), path


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "long_pair_sp.score",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=120)


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("the path under test needs a machine with no card")
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_with_only_the_benchmark_files_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
