"""The port's CLI (``python -m seqalib_tpu_torch``) and headline bench
(``python -m seqalib_tpu_torch.bench``) on the CPU, after
``tests/test_cli.py``: ``align`` equal to the JAX CLI's JSON on every
backend name the JAX CLI takes (its default ``pallas`` included), ``bench``
configs 1, 2, 4 and 5 through their oracle parity gates, each line
echoing the backend name it was given, ``bench all`` as a module run, and
the headline's INVALID tag."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from seqalib_tpu.cli import main as jax_main
from seqalib_tpu_torch import bench as st_bench
from seqalib_tpu_torch import oracle_fast as st_oracle_fast
from seqalib_tpu_torch.cli import main
from seqalib_tpu_torch.ops import strip as strip_mod

REPO = Path(__file__).resolve().parents[1]
BENCH5 = ["--reads", "6", "--refs", "3", "--read-len", "32", "--ref-len", "64",
          "--chunk-pairs", "5"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json_lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]


ALIGN_CASES = {
    "global_dna": ["ACGTACGT", "ACGACGT"],
    "local_blosum62": ["HEAGAWGHEE", "PAWHEAE", "--mode", "local", "--blosum62",
                       "--gap-open", "-10", "--gap-extend", "-1"],
    "banded": ["ACGTACGTACGT", "ACGTACGAACGT", "--band", "4", "--gap-open", "-5"],
}


@pytest.mark.parametrize("backend", [["--backend", "oracle"],
                                     ["--backend", "strip", "--device", "cpu"],
                                     ["--backend", "pallas", "--device", "cpu"],
                                     ["--backend", "xla", "--device", "cpu"],
                                     ["--device", "cpu"]],
                         ids=["oracle", "strip", "pallas", "xla", "default"])
@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_align_equals_the_jax_cli(case, backend, capsys):
    argv = ALIGN_CASES[case]
    assert jax_main(["align", *argv, "--backend", "oracle"]) == 0
    want = _json_lines(capsys)
    assert main(["align", *argv, *backend]) == 0
    assert _json_lines(capsys) == want


def test_align_rejects_a_bad_mode_and_a_bad_backend():
    with pytest.raises(SystemExit):
        main(["align", "A", "A", "--mode", "sideways"])
    with pytest.raises(SystemExit) as exc:
        main(["align", "A", "A", "--backend", "tpu"])
    assert exc.value.code == 2


def test_align_takes_the_jax_clis_line_and_default_backend(capsys):
    """The line of the JAX CLI's own default (``--backend pallas``), on the
    port's default and on the names ``pallas`` and ``xla``."""
    argv = ["align", "ACGTACGT", "ACGTTCGT"]
    assert jax_main([*argv, "--backend", "oracle"]) == 0
    want = _json_lines(capsys)
    assert want[0]["score"] == 11 and want[0]["cigar"] == "8M"
    for extra in ([], ["--backend", "pallas"], ["--backend", "xla"]):
        assert main([*argv, *extra, "--device", "cpu"]) == 0
        assert _json_lines(capsys) == want


@pytest.mark.parametrize("config,extra", [
    ("1", ["--pairs", "6"]),
    ("2", ["--pairs", "2"]),
    ("4", ["--pairs", "8", "--long-len", "600", "--band", "32"]),
    ("5", BENCH5),
])
def test_bench_config_parity(config, extra, capsys):
    rc = main(["bench", config, *extra, "--device", "cpu", "--parity-check"])
    out = _json_lines(capsys)
    assert rc == 0 and len(out) == 1
    out = out[0]
    assert out["config"] == int(config) and out["parity_ok"] is True
    assert out["backend"] == "pallas" and out["pairs_per_sec"] > 0
    want = {"1": 6, "2": 2, "4": 1, "5": 18}[config]
    assert out["pairs"] == out["parity_pairs"] == want
    if config == "5":
        assert (out["reads"], out["refs"], out["devices"], out["chunk_pairs"]) == (6, 3, 1, 5)
    else:
        assert out["example"]


@pytest.mark.parametrize("backend", ["strip", "xla", "oracle"])
def test_bench_line_echoes_the_backend_name_it_was_given(backend, capsys):
    assert main(["bench", "1", "--pairs", "2", "--backend", backend, "--device", "cpu",
                 "--parity-check", "--parity-pairs", "2"]) == 0
    out = _json_lines(capsys)[0]
    assert (out["backend"], out["parity_ok"]) == (backend, True)


def test_bench_parity_failure_exits_1_and_trace_is_written(capsys, monkeypatch, tmp_path):
    real = st_oracle_fast.align_oracle

    def off_by_one(*a, **k):
        r = real(*a, **k)
        return type(r)(r.score + 1, r.query_start, r.query_end, r.target_start,
                       r.target_end, r.cigar)

    monkeypatch.setattr(st_oracle_fast, "align_oracle", off_by_one)
    rc = main(["bench", "5", *BENCH5, "--device", "cpu", "--parity-check",
               "--trace", str(tmp_path / "trace")])
    out = _json_lines(capsys)[0]
    assert rc == 1
    assert out["parity_ok"] is False and out["parity_failures"] == 18
    assert (tmp_path / "trace" / "config5.json").stat().st_size > 0


def test_bench_all_runs_as_a_module():
    args = ["--pairs", "2", "--long-len", "600", "--band", "32", *BENCH5]
    proc = subprocess.run(
        [sys.executable, "-m", "seqalib_tpu_torch", "bench", "all", *args, "--device", "cpu",
         "--parity-check", "--parity-pairs", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert [x["config"] for x in lines] == [1, 2, 3, 4, 5]
    assert all(x["parity_ok"] for x in lines)


@pytest.fixture
def small_bench(monkeypatch):
    monkeypatch.setenv("BENCH_B", "4")
    monkeypatch.setenv("BENCH_L", "64")


def test_headline_bench_on_the_cpu(small_bench, capsys):
    assert st_bench.main(["--device", "cpu"]) == 0
    out = _json_lines(capsys)[0]
    assert out["metric"] == "GCUPS sw-affine-blosum62-64x64 B=4 coords=start+end(2pass) (cpu)"
    assert out["unit"] == "GCUPS" and out["value"] >= 0 and out["pairs_per_sec"] > 0
    assert (out["escalated"], out["parity_pairs"], out["parity_equal"]) == (0, 4, 4)


def test_headline_bench_tags_an_escalated_run_invalid(small_bench, capsys, monkeypatch):
    real = strip_mod.local_fused

    def escalating(*a, **k):
        res = real(*a, **k)
        res["score2"] = res["score2"].clone()
        res["score2"][0] = res["score"][0] - 1
        return res

    monkeypatch.setattr(strip_mod, "local_fused", escalating)
    assert st_bench.main(["--device", "cpu"]) == 0
    out = _json_lines(capsys)[0]
    assert out["escalated"] == 1
    assert "coords=start+end(2pass,1esc,INVALID-HEADLINE)" in out["metric"]
