"""The seeded differential sweep (``seqalib_tpu_torch/sweep.py``): the same
draws through every route of the port (``align_batch`` on the strip route
under both pass-2 engines, with and without traceback, and on ``"xla"``;
``band=`` 1, 3, 16, 800 and 8 300 (``band_fill``'s wide variant, Wp 8 448);
``align``; ``align_all_vs_all``; both full-matrix SP entry points and both
banded-SP ones), each result held to
the oracle (``oracle_fast``) and to the JAX package's same entry point on
the same inputs, at the ``str(AlignResult)`` level (coordinates where the
route returns no CIGAR, scores for the score-only SP entry points).

* Tier 1 runs the sample (the seed's first ``sweep.SUBSET`` draws: every
  scoring and mode in three length buckets), held to the oracle, and its
  first bucket (lengths up to 16: one JAX compile per route and group; on
  the SP routes, which compile per pair, its DNA affine pairs) to JAX on
  its ``"xla"`` backend, and one group on its ``"pallas"`` backend
  (interpret mode).
* ``-m slow`` runs every draw (lengths 1-400).
* ``-m cuda`` runs every draw on the card, each result held to the oracle
  and to the port's CPU run.

The JAX package is left out where the port departs from it on purpose
(ROADMAP Queue 3): the near-overflow scoring (entries beyond +-256, and
fault 7's clamp in its SP paths) is held to the oracle only.  Exact
equality: the work is integer DP.
"""

import functools

import pytest
import torch

from seqalib_tpu_torch import sweep

from _jax_api import JaxAPI

DRAWS = sweep.draws()
SAMPLE = DRAWS[: sweep.SUBSET]
ROUTES = list(sweep.ROUTES)
NO_JAX = ("overflow",)
# tier 1 holds JAX to the sample's first bucket only (a compile per route and
# group), and on the SP routes (a compile per pair) to its DNA affine pairs
JAX_SAMPLE_LEN = 16
SP_ROUTES = ("sp", "sp_score", "banded_sp", "banded_sp_score")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them fast when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _port(route, sample):
    return sweep.run_route(sweep.PortAPI("cpu"), route, SAMPLE if sample else DRAWS)


@functools.lru_cache(maxsize=None)
def _jax(route, sample):
    if not sample:  # the CPU backend aborts once enough compiled programs pile up
        import jax

        jax.clear_caches()
    ds = [d for d in (SAMPLE if sample else DRAWS) if d.scoring not in NO_JAX
          and (not sample or max(len(d.q), len(d.t)) <= JAX_SAMPLE_LEN)
          and (not sample or route not in SP_ROUTES or d.scoring == "dna_affine")]
    return sweep.run_route(_jax_api(), route, ds)


@functools.lru_cache(maxsize=None)
def _jax_api():
    return JaxAPI()


@functools.lru_cache(maxsize=None)
def _oracle(route, sample):
    return sweep.oracle_results(_port(route, sample))


def _held_to_oracle(route, sample):
    res = _port(route, sample)
    assert res, route
    bad = sweep.check(res, _oracle(route, sample))
    assert not bad, "\n".join(bad[:20])


def _held_to_jax(route, sample):
    port = {r.label: r for r in _port(route, sample)}
    jax = _jax(route, sample)
    assert jax, route
    bad = [f"{r.label} {r.scoring} {r.mode}: port {port[r.label].got!r}, JAX {r.got!r}"
           for r in jax if port[r.label].got != r.got]
    assert not bad, "\n".join(bad[:20])


@pytest.mark.parametrize("route", ROUTES)
def test_sample_matches_the_oracle(route):
    _held_to_oracle(route, True)


@pytest.mark.parametrize("route", ROUTES)
def test_sample_matches_jax(route):
    _held_to_jax(route, True)


def test_sample_covers_every_scoring_mode_and_three_buckets_a_mode():
    from seqalib_tpu_torch.parallel.dispatch import bucket_len

    assert {(d.scoring, d.mode) for d in SAMPLE} == {
        (s, m) for s in sweep.SCORINGS for m in ("global", "local")}
    for mode in ("global", "local"):
        shapes = {(bucket_len(len(d.q)), bucket_len(len(d.t))) for d in SAMPLE
                  if d.mode == mode}
        assert len(shapes) <= 3, shapes


def test_sweep_covers_the_lengths_and_the_overflow_scale():
    lengths = {len(x) for d in DRAWS for x in (d.q, d.t)}
    assert set(sweep.EDGE_LENGTHS) <= lengths
    assert max(lengths) == sweep.MAX_LEN and min(lengths) == 1
    assert any(x & (x - 1) for x in lengths)
    assert any({len(d.q), len(d.t)} == {1, 400} for d in DRAWS)
    for d in DRAWS:
        if d.scoring == "overflow":  # the bound within a factor 2 of 2^29
            sp, n, m = d.sp, len(d.q), len(d.t)
            bound = -sp.gap_open + (n + m) * max(-sp.gap_extend, -sp.mismatch, sp.match)
            assert sweep.OVERFLOW // 2 < bound <= sweep.OVERFLOW
    zero = [d for d in DRAWS if d.mode == "local" and d.q.max(initial=0) == 0
            and d.t.min(initial=1) == 1 and d.scoring.startswith("dna")]
    assert zero  # local pairs that score 0


def test_sample_on_jax_pallas_backend():
    """A few cases on the JAX ``"pallas"`` backend (interpret mode: 5-15 s a
    shape): the sample's local BLOSUM62 pair of the 64 bucket, both pass-2
    engines, with and without traceback."""
    ds = [d for d in SAMPLE if d.group == ("blosum62", 0, "local") and len(d.q) > 32]
    assert len(ds) == 1
    api = JaxAPI(pallas=True)
    for route in ("strip", "pallas_score", "strip_pass2", "strip_pass2_score"):
        port = {r.label: r.got for r in _port(route, True)}
        for r in sweep.run_route(api, route, ds):
            assert r.got == port[r.label], (route, r)


@pytest.mark.slow
@pytest.mark.parametrize("route", ROUTES)
def test_sweep_matches_the_oracle(route):
    _held_to_oracle(route, False)


@pytest.mark.slow
@pytest.mark.parametrize("route", ROUTES)
def test_sweep_matches_jax(route):
    _held_to_jax(route, False)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py's sweep phase runs the draws on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_sweep_on_the_card(route, card):
    """Every draw through the route on the card: equal to the oracle and to
    the port's CPU run of the same draws."""
    got = sweep.run_route(sweep.PortAPI(card), route, DRAWS)
    bad = sweep.check(got, sweep.oracle_results(got, processes=4))
    assert not bad, "\n".join(bad[:20])
    cpu = _port(route, False)
    assert [(r.label, r.got) for r in got] == [(r.label, r.got) for r in cpu]


@pytest.mark.cuda
def test_identities_on_the_card(card):
    assert sweep.identity_checks(card) > 0
