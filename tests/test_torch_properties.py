"""The JAX suite's property identities (``tests/test_properties.py``,
``tests/test_parity_xla.py``, ``tests/test_parity_pallas.py``,
``tests/test_fused_chunk.py``) and the ones VERDICT.md found missing, held
against the port (its plain versions, on the CPU) and, where the JAX
package has the entry point, against the JAX package on the same inputs.
The port's side of each identity is ``seqalib_tpu_torch/sweep.py``'s, the
code ``chip_smoke.py`` runs on the card; the JAX side runs the same checks
through ``JaxAPI`` (``tests/_jax_api.py``).

* affine with ``gap_open=0`` scores as linear, both modes, on kernel 7's
  fill and on the strip route;
* local coordinates are reverse-canonical, on every backend;
* pass 2 never overestimates (``local_fused``, WR=128, both engines);
* the tall-alignment escalation of a DNA affine self-alignment;
* banded local raises the same ``ValueError`` from ``align`` and
  ``align_batch`` on every backend;
* ``traceback=False`` coordinates equal ``traceback=True`` ones;
* the adversarial shapes on every backend;
* batch invariance: a pair alone, in a shuffled batch of mixed lengths and
  on a mesh of 3 gives one result;
* score(q, t) == score(t, q), the transposed CIGAR of align(t, q)
  re-scores on (q, t), NW(x, x) is the table's diagonal with CIGAR
  ``{n}M``, SW >= 0 and a local result of score 0 is the oracle's.

Exact equality: the work is integer DP.
"""

import functools

import numpy as np
import pytest
import torch

from seqalib_tpu_torch import sweep
from seqalib_tpu_torch.types import ScoringParams

from _jax_api import JaxAPI

PORT = sweep.PortAPI("cpu")
DNA = ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)
TABLES = {"dna": (sweep.LIN, 4), "blosum62": (sweep.BLO, 20)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them fast when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(pallas=False):
    return JaxAPI(pallas=pallas)


def _pairs(name, seed=3, count=6, lo=1, hi=60):
    return sweep.identity_pairs(seed, count, lo, hi, TABLES[name][1])


def test_affine_zero_open_equals_linear_on_kernel_7_and_the_strip_route():
    import jax.numpy as jnp

    from seqalib_tpu.ops.wavefront_xla import wavefront_bucket
    from seqalib_tpu.parallel.dispatch import sentinel_table

    qs, ts = sweep.identity_pairs(4, 6, 5, 40)
    port = sweep.zero_open_equals_linear("cpu", qs, ts, DNA)
    L = max(map(len, qs + ts))
    q, t = np.zeros((6, L), np.int32), np.zeros((6, L), np.int32)
    for i, (a, b) in enumerate(zip(qs, ts)):
        q[i, : len(a)], t[i, : len(b)] = a, b
    lens = [jnp.asarray(np.array([len(x) for x in s], np.int32)) for s in (qs, ts)]
    table = jnp.asarray(sentinel_table(_jax().scoring(DNA)))
    for mode in ("global", "local"):
        jax_scores = [np.asarray(wavefront_bucket(
            jnp.asarray(q), jnp.asarray(t), *lens, table, mode=mode, gap_open=0,
            gap_extend=-2, band=None, affine=affine, want_tb=False)["score"])
            for affine in (True, False)]
        assert np.array_equal(*jax_scores)
        np.testing.assert_array_equal(port[mode], jax_scores[0], err_msg=mode)


@pytest.mark.parametrize("backend", ["oracle", "strip", "pallas", "xla"])
def test_local_coords_are_reverse_canonical(backend):
    sweep.reverse_canonical(PORT, backend)
    if backend != "strip":  # the JAX package has no backend of that name
        sweep.reverse_canonical(_jax(), backend)


def test_local_coords_are_reverse_canonical_on_jax_pallas():
    sweep.reverse_canonical(_jax(pallas=True), "pallas")


@functools.lru_cache(maxsize=None)
def _jax_fused(pass2):
    """JAX ``_strip_local_fused`` on ``sweep.overestimate_batch`` (interpret
    mode), as ``tests/test_properties.py`` runs it."""
    import jax

    from seqalib_tpu.ops.strip_pallas import LANES, TI, _ceil_to, _strip_local_fused
    from seqalib_tpu.parallel.dispatch import sentinel_table

    sp = _jax().scoring(ScoringParams.affine(match=2, mismatch=-3, gap_open=-4, gap_extend=-1))
    table = sentinel_table(sp)
    A1 = int(table.shape[0])
    B, L = 8, 384
    q, t = sweep.overestimate_batch(0, B, L)
    qpad = np.full((B, _ceil_to(L, TI)), A1, np.int32)
    qpad[:, :L] = q
    t2 = np.full((B, (_ceil_to(L, LANES) // LANES + 2) * LANES), A1 + 1, np.int32)
    t2[:, 1: 1 + L] = t
    out = jax.jit(lambda *a: _strip_local_fused(
        *a, BSUB=8, mq=L, match=2, mismatch=-3, gap_open=-4, gap_extend=-1, affine=True,
        profile=False, packed=False, A1=A1, dt16=False, interpret=True, WR=128,
        pass2=pass2, bw=64))(qpad, t2, np.full(B, L, np.int32), np.full(B, L, np.int32),
                             table)
    return np.asarray(out["score"]), np.asarray(out["score2"])


@pytest.mark.parametrize("pass2", ["banded", "strip"])
def test_pass2_never_overestimates(pass2):
    score, score2 = sweep.pass2_never_overestimates("cpu", pass2)
    jscore, jscore2 = _jax_fused(pass2)
    np.testing.assert_array_equal(score, jscore)
    np.testing.assert_array_equal(score2, jscore2)


@functools.lru_cache(maxsize=None)
def _tall_pair():
    base = np.random.default_rng(0).integers(0, 4, 200).astype(np.int32)
    q = np.stack([base, base])
    t = q.copy()
    t[0, 50] = (t[0, 50] + 1) % 4
    return q, t


@pytest.mark.parametrize("pass2", ["banded", "strip"])
def test_tall_local_alignment_escalates_to_the_oracles_coords(pass2):
    """``tests/test_properties.py:123``'s DNA affine self-alignment of 200
    letters at WR=128, on the same inputs (that test holds the JAX package's
    ``strip_bucket`` to the oracle there; ``test_torch_escalation.py`` holds
    both packages on BLOSUM62 pairs): its span exceeds the window, so it
    escalates, and the result is the oracle's, CIGAR included."""
    from seqalib_tpu_torch.ops.strip import strip_bucket
    from seqalib_tpu_torch.oracle_fast import sw_affine
    from seqalib_tpu_torch.scoring import tables_from_params

    sp = ScoringParams.affine(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    base = np.random.default_rng(0).integers(0, 4, 200).astype(np.int32)
    q = np.stack([base, base])
    t = q.copy()
    t[0, 50] = (t[0, 50] + 1) % 4
    lens = np.full(2, 200)
    out = strip_bucket(q, t, lens, lens, tables_from_params(sp, "cpu"), mode="local",
                       want_tb=True, WR=128, pass2=pass2)
    assert out["escalated"].all()
    for b in range(2):
        want = sw_affine(q[b], t[b], sp)
        got = (out["score"][b], out["qs"][b], out["qe"][b], out["ts"][b], out["te"][b],
               out["cigars"][b])
        assert got == (want.score, want.query_start, want.query_end, want.target_start,
                       want.target_end, want.cigar)
        assert out["qe"][b] - out["qs"][b] > 128


def test_banded_local_raises_the_same_error_everywhere():
    port = sweep.banded_local_raises(PORT)
    jax = sweep.banded_local_raises(_jax(), backends=("oracle", "xla", "pallas"))
    assert set(port) == set(jax) and len(set(port)) == 1


@pytest.mark.parametrize("route", [("strip", "banded"), ("strip", "strip"), ("xla", None)])
def test_traceback_free_coords_equal_traceback_coords(route):
    backend, pass2 = route
    qs, ts = _pairs("dna", seed=6, count=8, lo=4, hi=48)
    sweep.traceback_free_coords(PORT, backend, qs, ts, sweep.AFF, pass2)
    sweep.traceback_free_coords(_jax(), "xla", qs, ts, _jax().scoring(sweep.AFF))
    port = PORT.align_batch(qs, ts, sweep.AFF, "local", backend=backend, traceback=False)
    jax = _jax().align_batch(qs, ts, _jax().scoring(sweep.AFF), "local", backend="xla",
                             traceback=False)
    assert [sweep.coords(r) for r in port] == [sweep.coords(r) for r in jax]


@pytest.mark.parametrize("backend", ["oracle", "strip", "pallas", "xla"])
def test_adversarial_shapes(backend):
    sweep.adversarial(PORT, backend)
    if backend in ("oracle", "xla"):  # JAX "pallas": a compile per shape
        sweep.adversarial(_jax(), backend)


@pytest.mark.parametrize("mode", ["global", "local"])
@pytest.mark.parametrize("backend", ["strip", "xla"])
def test_batch_invariance(backend, mode):
    """``tests/test_fused_chunk.py:85``'s counterpart: a pair's result in a
    shuffled batch of mixed lengths equals its result alone and on a mesh of
    3 (the JAX package: its ``"xla"`` backend on a mesh of 3 CPU devices)."""
    import jax

    from seqalib_tpu.parallel.dist import make_pair_mesh
    from seqalib_tpu_torch.parallel.dist import make_pair_mesh as port_pair_mesh

    qs, ts = _pairs("blosum62", seed=5, count=7, lo=1, hi=64)
    sweep.batch_invariance(PORT, backend, qs, ts, sweep.BLO, mode,
                           port_pair_mesh(["cpu"] * 3))
    japi = _jax()
    jsp = japi.scoring(sweep.BLO)
    if backend == "xla":
        sweep.batch_invariance(japi, "xla", qs, ts, jsp, mode, make_pair_mesh(jax.devices()[:3]))
    port = PORT.align_batch(qs, ts, sweep.BLO, mode, backend=backend)
    assert [str(r) for r in port] == [str(r) for r in japi.align_batch(qs, ts, jsp, mode)]


@pytest.mark.parametrize("backend", ["strip", "xla"])
@pytest.mark.parametrize("name", sorted(TABLES))
def test_symmetry_and_transposed_cigars(name, backend):
    sp = TABLES[name][0]
    qs, ts = _pairs(name)
    sweep.symmetry(PORT, backend, sp, qs, ts)
    japi = _jax()
    sweep.symmetry(japi, "xla", japi.scoring(sp), qs, ts)
    for mode in ("global", "local"):
        port = PORT.align_batch(ts, qs, sp, mode, backend=backend)
        jax = japi.align_batch(ts, qs, japi.scoring(sp), mode, backend="xla")
        assert [str(r) for r in port] == [str(r) for r in jax]


@pytest.mark.parametrize("backend", ["strip", "xla"])
@pytest.mark.parametrize("name", sorted(TABLES))
def test_self_alignment_is_the_tables_diagonal(name, backend):
    sp = TABLES[name][0]
    qs, _ = _pairs(name, seed=7)
    sweep.self_alignment(PORT, backend, sp, qs)
    sweep.self_alignment(_jax(), "xla", _jax().scoring(sp), qs)


@pytest.mark.parametrize("backend", ["oracle", "strip", "pallas", "xla"])
def test_local_score_zero_is_the_oracles(backend):
    sweep.zero_local(PORT, backend)
    if backend in ("oracle", "xla"):
        sweep.zero_local(_jax(), backend)
