"""One short run of a cell through the benchmark's own command, on the
card: ``python -m pytest -m cuda benchmark/tests`` on a machine with one."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "long_pair_sp.score",
                        "--seed", str(2**31 + 5), "--seconds", "2", "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0 and out["device"]["platform"] == "gpu"
    want = {"host_lead_ms.sp", "device_busy_pct.sp", "sp_tile.roofline_pct.sp"} if trace else {
        "gcups.sp", "call_p95_ms.sp", "setup_s"}
    assert want <= set(out["metrics"])
    assert list(out)[-1] == "checks"
