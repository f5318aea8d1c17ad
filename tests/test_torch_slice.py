"""Port parity for the whole slice: ``seqalib_tpu_torch.align_batch`` on the
CPU (the plain kernel versions) against the JAX ``align_batch`` with
``backend="pallas"``, with local pass 2 on either engine (the default
banded engine, or ``SEQALIB_FUSED_PASS2=strip``; both packages read the
same variable), and against the oracle.  Exact equality of
``str(AlignResult)`` and of the raw ``strip_bucket`` dicts.  The
adversarial tie pins of ``tests/test_fused_tie_boundary.py`` hold on both
engines, with and without ``tie_safe``.

Lengths stay inside one (256, 256) bucket so that each JAX configuration
compiles once (tens of seconds in interpret mode) for the module."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import seqalib_tpu as sa
import seqalib_tpu_torch as st
from seqalib_tpu import oracle_fast
from seqalib_tpu.ops.strip_pallas import strip_bucket as jax_strip_bucket
from seqalib_tpu.parallel.dispatch import _pad_stack, sentinel_table
from seqalib_tpu.types import ScoringParams
from seqalib_tpu_torch.ops.strip import strip_bucket
from seqalib_tpu_torch.scoring import scoring_params, tables_from_params

from test_fused_tie_boundary import _tie_problem, _tie_problem_b

REPO = Path(__file__).resolve().parents[1]
B = 8
KEYS = ("score", "qs", "qe", "ts", "te", "cigars")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them fast when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(alpha, seed):
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for b in range(B):
        q = rng.integers(0, alpha, size=rng.integers(130, 201)).astype(np.uint8)
        t = rng.integers(0, alpha, size=rng.integers(130, 201)).astype(np.uint8)
        if b % 2 == 0:  # a shared region with an indel: gapped alignments
            L = min(len(q), len(t)) - 40
            t[10 : 10 + L // 2] = q[20 : 20 + L // 2]
            t[15 + L // 2 : 10 + L] = q[20 + L // 2 : 15 + L]
        qs.append(q)
        ts.append(t)
    ts[1] = qs[1][: len(ts[1])].copy()  # a near-identical pair
    return qs, ts


def _port_sp(sp):
    """The port's ``ScoringParams`` for a JAX-package one."""
    return scoring_params(sp.match, sp.mismatch, sp.gap_open, sp.gap_extend, sp.matrix)


def _jax_runs(qs, ts, sp, mode, pass2):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEQALIB_FUSED_PASS2", pass2)
        res = sa.align_batch(qs, ts, scoring=sp, mode=mode, backend="pallas")
        raw = jax_strip_bucket(
            _pad_stack(qs, 256), _pad_stack(ts, 256),
            np.array([len(x) for x in qs]), np.array([len(x) for x in ts]),
            sentinel_table(sp), mode=mode, gap_open=sp.gap_open,
            gap_extend=sp.gap_extend, affine=sp.is_affine, want_tb=True,
        )
    return [str(r) for r in res], raw


# (case, pass-2 engine): the local case runs on both engines
CASES = {"local_blosum62_affine": "strip", "local_blosum62_affine-banded": "banded",
         "global_dna_linear": "strip"}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    pass2 = CASES[request.param]
    if request.param.startswith("local"):
        sp, alpha, mode = ScoringParams.blosum62(gap_open=-10, gap_extend=-1), 20, "local"
    else:
        sp, alpha, mode = ScoringParams.linear(), 4, "global"
    qs, ts = _pairs(alpha, seed=len(request.param.split("-")[0]))
    jax_str, jax_raw = _jax_runs(qs, ts, sp, mode, pass2)
    return dict(sp=sp, mode=mode, qs=qs, ts=ts, jax_str=jax_str, jax_raw=jax_raw,
                pass2=pass2)


def test_align_batch_matches_jax_and_oracle(case, monkeypatch):
    monkeypatch.setenv("SEQALIB_FUSED_PASS2", case["pass2"])
    res = st.align_batch(case["qs"], case["ts"], scoring=_port_sp(case["sp"]),
                         mode=case["mode"], device="cpu")
    got = [str(r) for r in res]
    assert got == case["jax_str"]
    want = [str(oracle_fast.align_oracle(q, t, case["sp"], mode=case["mode"]))
            for q, t in zip(case["qs"], case["ts"])]
    assert got == want
    assert any("I" in c or "D" in c for c in got)  # gapped alignments occur


def test_strip_bucket_raw_dict_matches_jax(case):
    sp = case["sp"]
    out = strip_bucket(
        _pad_stack(case["qs"], 256), _pad_stack(case["ts"], 256),
        np.array([len(x) for x in case["qs"]]), np.array([len(x) for x in case["ts"]]),
        tables_from_params(_port_sp(sp), "cpu"), mode=case["mode"], want_tb=True,
        pass2=case["pass2"],
    )
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(case["jax_raw"][k]), err_msg=k)
    if case["mode"] == "local":
        assert not out["escalated"].any()


def test_mixed_length_buckets_keep_input_order(case):
    # lengths across several (Lq, Lt) buckets, empty sequences included
    rng = np.random.default_rng(7)
    alpha = 20 if case["mode"] == "local" else 4
    lens = [(0, 5), (3, 0), (1, 1), (17, 300), (260, 40), (70, 90), (5, 140)]
    qs = [rng.integers(0, alpha, size=a).astype(np.uint8) for a, _ in lens]
    ts = [rng.integers(0, alpha, size=b).astype(np.uint8) for _, b in lens]
    res = st.align_batch(qs, ts, scoring=_port_sp(case["sp"]), mode=case["mode"],
                         device="cpu")
    want = [str(oracle_fast.align_oracle(q, t, case["sp"], mode=case["mode"]))
            for q, t in zip(qs, ts)]
    assert [str(r) for r in res] == want


def _tie_run(problem, pass2="strip", tie_safe=False):
    q, t, sp = problem()
    return strip_bucket(q[None].astype(np.int32), t[None].astype(np.int32),
                        np.array([len(q)]), np.array([len(t)]),
                        tables_from_params(_port_sp(sp), "cpu"), mode="local",
                        want_tb=True, pass2=pass2, tie_safe=tie_safe)


def test_class_a_tie_returns_the_canonical_start():
    # as the JAX strip pass-2 engine (test_strip_engine_returns_canonical_tie)
    out = _tie_run(_tie_problem)
    assert int(out["score"][0]) == 84
    assert (int(out["qs"][0]), int(out["ts"][0])) == (35, 0)
    assert (int(out["qe"][0]), int(out["te"][0])) == (49, 84)
    assert out["cigars"][0] == "7M70D7M"


def test_class_b_tie_keeps_the_pinned_start():
    # beyond the 2*WR column clamp: the pinned non-canonical start of the
    # JAX engines (test_class_b_exposure_is_pinned_without_tie_safe)
    out = _tie_run(_tie_problem_b)
    assert int(out["score"][0]) == 412
    assert (int(out["qe"][0]), int(out["te"][0])) == (124, 260)
    assert (int(out["qs"][0]), int(out["ts"][0])) == (0, 192)
    assert not out["escalated"][0]


def test_default_engine_is_banded_with_its_class_a_pin(monkeypatch):
    # with no environment set the port runs the JAX default, the banded
    # pass-2 engine, and returns its in-band co-optimal start
    # (test_banded_engine_tie_exposure_is_pinned): no escalation
    monkeypatch.delenv("SEQALIB_FUSED_PASS2", raising=False)
    monkeypatch.delenv("SEQALIB_FUSED_TIE_SAFE", raising=False)
    q, t, sp = _tie_problem()
    out = strip_bucket(q[None].astype(np.int32), t[None].astype(np.int32),
                       np.array([len(q)]), np.array([len(t)]),
                       tables_from_params(_port_sp(sp), "cpu"), mode="local",
                       want_tb=True)
    assert int(out["score"][0]) == 84
    assert (int(out["qe"][0]), int(out["te"][0])) == (49, 84)
    assert (int(out["qs"][0]), int(out["ts"][0])) == (0, 35)
    assert not out["escalated"][0]
    assert out["cigars"][0] == "7M35D35I7M"
    # align's own default is "xla", as in the JAX package: name the strip route
    res = st.align(q, t, scoring=_port_sp(sp), mode="local", backend="pallas", device="cpu")
    assert (res.query_start, res.target_start) == (0, 35)


def test_banded_engine_keeps_the_class_b_pin():
    # test_class_b_exposure_is_pinned_without_tie_safe[banded]
    out = _tie_run(_tie_problem_b, pass2="banded")
    assert int(out["score"][0]) == 412
    assert (int(out["qe"][0]), int(out["te"][0])) == (124, 260)
    assert (int(out["qs"][0]), int(out["ts"][0])) == (0, 192)
    assert not out["escalated"][0]


@pytest.mark.parametrize("pass2", ["banded", "strip"])
@pytest.mark.parametrize("problem,start,cigar", [
    (_tie_problem, (35, 0), "7M70D7M"),
    (_tie_problem_b, (68, 0), "28M204D28M"),
])
def test_tie_safe_closes_both_classes(pass2, problem, start, cigar, monkeypatch):
    # test_tie_safe_mode_closes_the_exposure / test_tie_safe_closes_class_b,
    # with tie_safe read from the environment as in the JAX package
    monkeypatch.setenv("SEQALIB_FUSED_TIE_SAFE", "1")
    monkeypatch.setenv("SEQALIB_FUSED_PASS2", pass2)
    q, t, sp = problem()
    out = strip_bucket(q[None].astype(np.int32), t[None].astype(np.int32),
                       np.array([len(q)]), np.array([len(t)]),
                       tables_from_params(_port_sp(sp), "cpu"), mode="local",
                       want_tb=True)
    assert (int(out["qs"][0]), int(out["ts"][0])) == start
    assert out["cigars"][0] == cigar
    # the banded engine escalates both; the strip engine only the pair
    # whose target window was cut (class b)
    assert bool(out["escalated"][0]) == (pass2 == "banded" or problem is _tie_problem_b)


@pytest.mark.parametrize("pass2", ["banded", "strip"])
def test_tie_safe_keeps_clean_pairs_exact(pass2):
    # test_fused_tie_boundary.py::test_tie_safe_keeps_clean_pairs_exact
    rng = np.random.default_rng(7)
    jsp = ScoringParams.blosum62()
    B, L = 8, 96
    qs = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    ts = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    out = strip_bucket(qs, ts, np.full(B, L), np.full(B, L),
                       tables_from_params(_port_sp(jsp), "cpu"), mode="local",
                       want_tb=True, pass2=pass2, tie_safe=True)
    for b in range(B):
        o = oracle_fast.align_oracle(qs[b], ts[b], jsp, mode="local")
        assert (int(out["score"][b]), int(out["qs"][b]), int(out["ts"][b]),
                out["cigars"][b]) == (o.score, o.query_start, o.target_start, o.cigar), b


def test_unknown_pass2_engine_is_refused():
    with pytest.raises(ValueError, match="pass2"):
        _tie_run(_tie_problem, pass2="none")


def test_small_nonuniform_matrix_follows_the_oracle():
    # Known divergence from JAX: for tables of <= 8 rows the JAX kernel
    # scores by table[0,0] / table[0,1] (strip_pallas._prep_strip) and
    # returns 11 here; the port looks every score up, as the oracle does.
    mat = np.array([[2, -1, -3, -3], [-1, 2, -3, -3], [-3, -3, 2, -1], [-3, -3, -1, 2]])
    sp = ScoringParams(gap_open=0, gap_extend=-2, matrix=mat)
    got = st.align("ACGTAGGCTA", "ACATGGCTTA", scoring=_port_sp(sp), mode="global",
                   device="cpu")
    want = sa.align("ACGTAGGCTA", "ACATGGCTTA", scoring=sp, mode="global", backend="oracle")
    assert str(got) == str(want)
    assert (got.score, got.cigar) == (9, "4M1I3M1D2M")


def test_oracle_backend_and_api_errors():
    sp = ScoringParams.linear()
    got = st.align_batch(["ACGT"], ["AGT"], scoring=_port_sp(sp), mode="local",
                         backend="oracle", device="cpu")
    assert str(got[0]) == str(sa.align("ACGT", "AGT", scoring=sp, mode="local", backend="oracle"))
    got = st.align_batch(["ACGTTA"], ["AGTA"], scoring=_port_sp(sp), mode="global",
                         band=2, backend="oracle", device="cpu")
    want = sa.align("ACGTTA", "AGTA", scoring=sp, mode="global", band=2, backend="oracle")
    assert str(got[0]) == str(want)
    with pytest.raises(ValueError, match="backend"):
        st.align_batch(["ACGT"], ["AGT"], backend="tpu", device="cpu")
    # a band with a table outside [-4, 11]: the full-matrix wavefront route
    wide = np.full((4, 4), -20)
    np.fill_diagonal(wide, 20)
    wsp = ScoringParams(gap_open=-5, gap_extend=-2, matrix=wide)
    got = st.align_batch(["ACGT"], ["AGT"], mode="global", band=4, device="cpu",
                         scoring=_port_sp(wsp))
    want = sa.align("ACGT", "AGT", scoring=wsp, mode="global", band=4, backend="oracle")
    assert str(got[0]) == str(want)
    with pytest.raises(TypeError, match="make_pair_mesh"):
        st.align_batch(["ACGT"], ["AGT"], mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="out of contract"):
        st.align_batch(["ACGT"], ["AGT"], mode="local", band=4, device="cpu")


def test_package_align_batch_default_mode_matches_jax():
    # the package-level align_batch is global by default in both packages,
    # api.align_batch local in both
    q, t = ["TTTTACGTACGTTTTT"], ["GGACGTACGGG"]
    want = sa.align_batch(q, t, backend="xla")
    got = st.align_batch(q, t, device="cpu")
    assert [str(r) for r in got] == [str(r) for r in want]
    assert (got[0].score, got[0].cigar) == (-8, "2I9M3I2M")
    import inspect

    import seqalib_tpu.api as sa_api
    import seqalib_tpu_torch.api as st_api

    default = [inspect.signature(f).parameters["mode"].default
               for f in (sa_api.align_batch, st_api.align_batch)]
    assert default == ["local", "local"]


def test_align_has_the_jax_packages_defaults():
    """``align`` (the package-level name and ``api.align``) takes the JAX
    package's parameters and defaults, ``backend="xla"`` included, plus
    ``device``."""
    import inspect

    import seqalib_tpu.api as sa_api
    import seqalib_tpu_torch.api as st_api

    def defaults(f, drop=()):
        return [(p.name, p.default) for p in inspect.signature(f).parameters.values()
                if p.name not in drop]

    assert st.align is st_api.align
    want = defaults(sa.align)
    assert want == defaults(sa_api.align)
    assert ("backend", "xla") in want
    assert defaults(st.align, drop=("device",)) == want
    assert inspect.signature(st.align).parameters["device"].default == "cuda"
    q, t = "TTTTACGTACGTTTTT", "GGACGTACGGG"
    assert str(st.align(q, t, device="cpu")) == str(sa.align(q, t))


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        st.align_batch(["ACGT"], ["AGT"])


def test_devices_is_a_leaf_and_band_pipeline_imports_no_api():
    """Imports point one way: ``devices.py`` imports nothing of the package,
    the long-pair module (``parallel/band_pipeline.py``) nothing of ``api``,
    and no module under ``parallel/`` takes its mesh from that module."""
    import ast

    pkg = REPO / "seqalib_tpu_torch"

    def imports(path):
        out = []
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                out.append(("." * node.level + (node.module or ""),
                            [a.name for a in node.names]))
            elif isinstance(node, ast.Import):
                out += [(a.name, []) for a in node.names]
        return out

    assert not [m for m, _ in imports(pkg / "devices.py")
                if m.startswith(".") or m.split(".")[0] == "seqalib_tpu_torch"]
    assert not [m for m, _ in imports(pkg / "parallel" / "band_pipeline.py")
                if m.split(".")[-1] == "api"]
    for path in sorted((pkg / "parallel").glob("*.py")):
        assert not [m for m, names in imports(path)
                    if m.endswith("band_pipeline") and "Mesh" in names], path


def test_port_never_imports_jax():
    # neither jax nor any module of the JAX package, after a local call, a
    # banded global call (both banded routes), both sequence-parallel ones,
    # an all-vs-all product, a call on a pair mesh, the generic aligners,
    # the distribution layer and its worker, the CLI and the headline bench
    code = (
        "import sys, numpy as np, seqalib_tpu_torch as st\n"
        "r = st.align_batch(['ACGTACGT', 'TTGCA'], ['ACGACGT', 'TTGGCA'], mode='local',\n"
        "                   device='cpu')\n"
        "assert r[0].score > 0, r\n"
        "g = st.align_batch(['ACGTACGTAA'], ['ACGACGTTA'], mode='global', band=3,\n"
        "                   device='cpu')\n"
        "assert g[0].cigar, g\n"
        "wide = st.ScoringParams(gap_open=-5, gap_extend=-2,\n"
        "                        matrix=np.where(np.eye(4, dtype=bool), 20, -20))\n"
        "w = st.align_batch(['ACGTACGTAA'], ['ACGACGTTA'], scoring=wide, mode='global',\n"
        "                   band=3, device='cpu')\n"
        "assert w[0].cigar, w\n"
        "dna = st.ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)\n"
        "a = st.align_sp(st.encode_dna('ACGTACGTAACG'), st.encode_dna('ACGACGTTACG'), dna,\n"
        "                st.make_band_mesh(['cpu'] * 2), C=4)\n"
        "assert a.cigar, a\n"
        "b = st.align_banded_sp(st.encode_dna('ACGTACGTAACG'), st.encode_dna('ACGACGTTACG'),\n"
        "                       dna, 3, st.make_band_mesh(['cpu'] * 2), CK=8)\n"
        "assert b.cigar == a.cigar, (a, b)\n"
        "import contextlib, io, os\n"
        "x = st.align_all_vs_all(['ACGTACGT', 'TTGCA'], ['ACGACGT'], chunk_pairs=1,\n"
        "                        device='cpu')\n"
        "assert x['score'].shape == (2, 1), x\n"
        "m = st.align_batch(['ACGTACGT', 'TTGCA', 'GGA'], ['ACGACGT', 'TTGGCA', 'GA'],\n"
        "                   mode='local', backend='pallas', mesh=st.make_pair_mesh(['cpu'] * 2))\n"
        "assert [str(a) for a in m[:2]] == [str(a) for a in r], (m, r)\n"
        "from seqalib_tpu_torch.models import generic\n"
        "from seqalib_tpu_torch.parallel import dist, dist_check\n"
        "nw = generic.NeedlemanWunschSA(generic.ScoringSystem()).get_alignment('AB', 'AB')\n"
        "assert nw.cigar() == '2M', nw\n"
        "from seqalib_tpu_torch import bench, cli\n"
        "os.environ.update(BENCH_B='2', BENCH_L='32')\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert cli.main(['align', 'ACGT', 'AGT', '--device', 'cpu']) == 0\n"
        "    assert cli.main(['bench', '5', '--reads', '2', '--refs', '2', '--read-len',\n"
        "                     '16', '--ref-len', '32', '--device', 'cpu',\n"
        "                     '--parity-check']) == 0\n"
        "    assert bench.main(['--device', 'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'seqalib_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
