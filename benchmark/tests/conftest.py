"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository root.  They need no card; the ones marked ``cuda`` skip without
one, deciding inside the test."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))  # the harness's modules
sys.path.insert(0, str(HERE))  # frozen_oracle
sys.path.insert(0, str(HERE.parents[1]))  # the program under test


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
