"""The banded route's batches (``parallel/dispatch.py::banded_batches``) on
the CPU: reads whose length differences fall in several ``delta // band``
groups go through ``align_batch(band=)`` as one ``banded_align_batch``
while their bands fit the widest group's slot window, and in more than
one where differences of both signs widen it, where an outlier's window
takes the other ``band_fill`` variant, where the pairs outnumber the
card's SMs or where the checkpoints would pass ``JOIN_BYTES``; every
answer equals the JAX package's oracle (``seqalib_tpu.oracle_fast``) and
the benchmark's NumPy reference (``benchmark/reference.py``), with
``mesh=None`` and over a CPU mesh of two entries; and the counters of the
banded batches, which count on a card only, as the launches do."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import seqalib_tpu_torch as st
from seqalib_tpu.oracle_fast import align_oracle
from seqalib_tpu.types import ScoringParams as JaxScoringParams
from seqalib_tpu_torch import telemetry
from seqalib_tpu_torch.devices import H100_SMS
from seqalib_tpu_torch.models.banded import checkpoint_bytes, slot_width
from seqalib_tpu_torch.ops.band_fill import MAX_WP_REGISTERS
from seqalib_tpu_torch.parallel import dispatch
from seqalib_tpu_torch.scoring import scoring_params

ROOT = Path(__file__).resolve().parents[1]
SP = scoring_params(2, -4, -4, -2)  # minimap2's first affine piece
JSP = JaxScoringParams(match=2, mismatch=-4, gap_open=-4, gap_extend=-2)
BAND = 8


def _reference():
    spec = importlib.util.spec_from_file_location("bench_reference",
                                                  ROOT / "benchmark" / "reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reads(seed, cuts, lengths=(200, 261)):
    """A read of 200-260 letters a cut; its window: the read with 4%
    substitutions, then ``cut`` letters deleted at a drawn place (a
    negative cut: as many random letters inserted)."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for cut in cuts:
        q = rng.integers(0, 4, int(rng.integers(*lengths))).astype(np.uint8)
        t = q.copy()
        sub = np.flatnonzero(rng.random(len(t)) < 0.04)
        t[sub] = (t[sub] + 1 + rng.integers(0, 3, len(sub))) % 4
        at = int(rng.integers(0, len(t) - max(cut, 0) + 1))
        if cut >= 0:
            t = np.delete(t, np.arange(at, at + cut))
        else:
            t = np.insert(t, at, rng.integers(0, 4, -cut))
        qs.append(q)
        ts.append(t.astype(np.uint8))
    return qs, ts


NEGATIVE = [1, 3, 9, 12, 17, 20, 24, 27, 30, 33, 36, 40]  # deltas -1 .. -40
BOTH = [200, 190, 5, -195, -200]  # deltas of both signs, 200 apart from 0


def _want(qs, ts):
    ref = _reference()
    got = ref.align(qs, ts, ref.substitution_table(2, -4), -4, -2, band=BAND)
    oracle = [align_oracle(q, t, JSP, mode="global", band=BAND) for q, t in zip(qs, ts)]
    assert [(o.score, o.query_start, o.query_end, o.target_start, o.target_end, o.cigar)
            for o in oracle] == got
    return [str(o) for o in oracle]


def _calls(monkeypatch):
    calls = []
    real = dispatch.banded_align_batch

    def spy(qb, *a, **k):
        calls.append(len(qb))
        return real(qb, *a, **k)

    monkeypatch.setattr(dispatch, "banded_align_batch", spy)
    return calls


def _lens(qs, ts):
    return [len(q) for q in qs], [len(t) for t in ts]


def _groups(qs, ts):
    return {(len(t) - len(q)) // BAND for q, t in zip(qs, ts)}


def test_one_sign_of_delta_is_one_batch_whatever_its_groups(monkeypatch):
    qs, ts = _reads(21, NEGATIVE)
    deltas = [len(t) - len(q) for q, t in zip(qs, ts)]
    assert max(deltas) < 0 and len(_groups(qs, ts)) >= 4
    assert dispatch.banded_batches(*_lens(qs, ts), BAND) == [sorted(
        range(len(qs)), key=lambda i: (deltas[i] // BAND, i))]
    calls = _calls(monkeypatch)
    got = st.align_batch(qs, ts, scoring=SP, mode="global", band=BAND, device="cpu")
    assert calls == [len(qs)]
    assert [str(r) for r in got] == _want(qs, ts)


def test_deltas_of_both_signs_that_widen_the_window_split_the_batch(monkeypatch):
    qs, ts = _reads(22, BOTH)
    deltas = [len(t) - len(q) for q, t in zip(qs, ts)]
    assert min(deltas) < -BAND and max(deltas) > BAND
    batches = dispatch.banded_batches(*_lens(qs, ts), BAND)
    assert len(batches) > 1 and sorted(sum(batches, [])) == list(range(len(qs)))
    # each batch's window stays within its widest group's own
    for b in batches:
        lo = min(0, min(deltas[i] for i in b)) - BAND
        hi = max(0, max(deltas[i] for i in b)) + BAND
        own = max(slot_width(min(0, deltas[i]) - BAND, max(0, deltas[i]) + BAND) for i in b)
        assert slot_width(lo, hi) <= own
    calls = _calls(monkeypatch)
    got = st.align_batch(qs, ts, scoring=SP, mode="global", band=BAND, device="cpu")
    assert sorted(calls) == sorted(len(b) for b in batches)
    assert [str(r) for r in got] == _want(qs, ts)


def test_an_outlier_on_the_wide_variant_runs_alone_at_the_cell_s_scale():
    """131 reads of 80-120 kb whose deltas (-616 .. -1 442) fall in many
    groups, and one structural variant of delta -20 000, at band 128: the
    outlier's window (Wp past ``MAX_WP_REGISTERS``) would move every read
    to the cluster kernel, so it is a batch of its own; one of delta
    -7 000 keeps the single-CTA variant, and joins."""
    rng = np.random.default_rng(5)
    qlens = rng.integers(80_000, 120_001, 131).tolist()
    tlens = [q - int(d) for q, d in zip(qlens, rng.integers(616, 1443, 131))]
    for outlier, alone in ((20_000, True), (7_000, False)):
        q, t = qlens + [110_000], tlens + [110_000 - outlier]
        own = slot_width(-outlier - 128, 128)
        assert (own > MAX_WP_REGISTERS) == alone
        batches = dispatch.banded_batches(q, t, 128)
        assert len({(tl - ql) // 128 for ql, tl in zip(q, t)}) >= 6
        narrow = sorted(range(131), key=lambda i: ((t[i] - q[i]) // 128, i))
        assert batches == ([[131], narrow] if alone else [[131] + narrow])


def test_an_outlier_on_another_variant_runs_alone_through_align_batch(monkeypatch):
    """At the CPU's scale, with the register variant's bound lowered to
    one lane quantum (128 slots): the reads of ``NEGATIVE`` keep Wp 128
    and share a batch; an outlier whose deletion of 250 letters widens its
    own window to Wp 256 runs alone, and every answer is exact."""
    monkeypatch.setattr(dispatch, "MAX_WP_REGISTERS", 128)
    qs, ts = _reads(25, NEGATIVE)
    oq, ot = _reads(26, [250], lengths=(500, 521))
    qs, ts = qs + oq, ts + ot
    assert slot_width(len(ot[0]) - len(oq[0]) - BAND, BAND) == 256
    batches = dispatch.banded_batches(*_lens(qs, ts), BAND)
    assert batches[0] == [len(qs) - 1] and sorted(batches[1]) == list(range(len(qs) - 1))
    calls = _calls(monkeypatch)
    got = st.align_batch(qs, ts, scoring=SP, mode="global", band=BAND, device="cpu")
    assert calls == [1, len(qs) - 1]
    assert [str(r) for r in got] == _want(qs, ts)


def test_a_call_of_more_pairs_than_sms_splits_at_the_sms(monkeypatch):
    """140 reads in 5 delta groups, more than an H100's 132 SMs: a join
    stops where the batch would pass them (a CPU run batches as the card
    would), and every answer is exact."""
    cuts = [1, 9, 17, 25, 33] * 28
    qs, ts = _reads(27, cuts, lengths=(60, 81))
    assert len(qs) > H100_SMS and len(_groups(qs, ts)) == 5
    batches = dispatch.banded_batches(*_lens(qs, ts), BAND)
    assert len(batches) == 2 and [len(b) for b in batches] == [112, 28]
    calls = _calls(monkeypatch)
    got = st.align_batch(qs, ts, scoring=SP, mode="global", band=BAND, device="cpu")
    assert calls == [112, 28]
    assert [str(r) for r in got] == _want(qs, ts)
    # a group larger than the SMs is never split: it is a batch of its own
    q, t = _lens(qs, ts)
    assert dispatch.banded_batches(q, t, BAND, sms=20) == [
        [i for i in range(140) if cuts[i] == c] for c in (33, 25, 17, 9, 1)]


def test_a_join_keeps_the_checkpoints_within_join_bytes():
    """132 reads of 1 Mb in 8 groups (deltas -1 024 .. -1 920, Wp up to
    1 152): one batch would hold about 19 GB of checkpoints, so the groups
    join only up to ``JOIN_BYTES``."""
    qlens = [1_000_000] * 132
    tlens = [1_000_000 - 1024 - 128 * (k % 8) for k in range(132)]
    batches = dispatch.banded_batches(qlens, tlens, 128)
    assert 1 < len(batches) < 8 and sorted(sum(batches, [])) == list(range(132))
    for b in batches:
        Wp = slot_width(min(tlens[i] - qlens[i] for i in b) - 128, 128)
        K = max(qlens[i] + tlens[i] + 1 for i in b)
        assert checkpoint_bytes(len(b), Wp, K) <= dispatch.JOIN_BYTES
    assert checkpoint_bytes(132, 1152, 1_998_081) > 2 * dispatch.JOIN_BYTES


@pytest.mark.parametrize("cuts", [NEGATIVE, BOTH], ids=["negative", "both_signs"])
def test_the_parts_over_a_mesh_of_two_equal_one_device(monkeypatch, cuts):
    qs, ts = _reads(23, cuts)
    want = [str(r) for r in st.align_batch(qs, ts, scoring=SP, mode="global", band=BAND,
                                           device="cpu")]
    calls = _calls(monkeypatch)
    got = st.align_batch(qs, ts, scoring=SP, mode="global", band=BAND, mesh=["cpu"] * 2)
    assert [str(r) for r in got] == want
    batches = dispatch.banded_batches(*_lens(qs, ts), BAND, cards=2)
    assert sorted(calls) == sorted(x for b in batches
                                   for x in ([len(b)] if len(b) == 1 else
                                             [-(-len(b) // 2), len(b) // 2]))


def test_the_band_counters_count_a_card_s_batches_only(monkeypatch):
    monkeypatch.setattr(telemetry, "banded_batches", 0)
    monkeypatch.setattr(telemetry, "band_slots", 0)
    telemetry.count_band(torch.zeros(3, dtype=torch.int32), batches=1, slots=3 * 128 * 512)
    qs, ts = _reads(24, NEGATIVE[:3])
    st.align_batch(qs, ts, scoring=SP, mode="global", band=BAND, device="cpu")
    snap = telemetry.snapshot()
    assert (snap["banded_batches"], snap["band_slots"]) == (0, 0)
    assert set(snap) == {"launches", "d2h_bytes", "banded_batches", "band_slots"}
