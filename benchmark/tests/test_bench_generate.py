import re

import numpy as np

import added
import cells
import drive
import generate
import reference

SEED = 2**31 + 977


def _small(name, **kw):
    t = dict(added.BANDED_READS if name == "reads" else cells.load(name).traffic)
    t.update(kw)
    return t


def test_pool_repeats_by_seed_and_keeps_sizes():
    t = _small("reads", length=400, batch=3)
    a, b = generate.pool(SEED, t), generate.pool(SEED, t)
    c = generate.pool(SEED + 1, t)
    for (qa, ta), (qb, tb), (qc, tc) in zip(a, b, c):
        assert all(np.array_equal(x, y) for x, y in zip(qa + ta, qb + tb))
        assert [len(x) for x in qa + ta] == [len(x) for x in qc + tc]
    assert not all(np.array_equal(x, y) for x, y in zip(a[0][0], c[0][0]))
    assert len(a) == t["pool"] and all(len(qs) == 3 for qs, _ in a)


def test_reads_keep_their_length_and_differ_pair_by_pair():
    t = _small("reads", length=20000, batch=4, pool=1)
    (qs, ts), = generate.pool(SEED, t)
    for q, t_ in zip(qs, ts):
        # an insertion and a deletion of the same length: one delta group
        assert len(q) == len(t_) == 20000
        assert q.max() < 4 and t_.max() < 4
    # about 2% substitutions, a different number in each pair
    subs = [int((q[:5000] != t_[:5000]).sum()) for q, t_ in zip(qs, ts)]
    assert len(set(subs)) > 1


def test_sp_pair_edits():
    t = cells.load("long_pair_sp.score").traffic
    (qs, ts), (qs2, ts2) = generate.pool(SEED, t)
    assert len(qs[0]) == 16569 and len(ts[0]) == len(ts2[0]) == 16569 - 7 + 5 - 1
    assert not np.array_equal(qs[0], qs2[0])


def test_edits_land_where_the_reference_finds_them():
    t = _small("long_pair_sp.cigar", length=900)
    (qs, ts), = generate.pool(SEED, dict(t, pool=1))
    (score, *_, cigar), = reference.align(qs, ts, reference.substitution_table(2, -3),
                                          -5, -2)
    gaps = sorted(int(x[:-1]) for x in re.findall(r"\d+[ID]", cigar))
    assert sum(gaps) >= 13 and score > 0  # the 7, 5 and 1 letters, perhaps split


def test_check_sample_repeats_and_stays_in_the_pool():
    t = added.BANDED_READS
    s = generate.check_sample(SEED, t, t["batch"])
    assert s == generate.check_sample(SEED, t, t["batch"])
    assert len(s) == t["check"] == len(set(s))
    assert all(0 <= b < t["pool"] and 0 <= p < t["batch"] for b, p in s)


def test_length_ranges_and_indels_give_each_pair_its_own_lengths():
    t = _small("reads", length=[900, 1100], batch=16, pool=1, substitution_rate=0.01,
               indel_rate=0.01, indel_length=[1, 4], edits=[])
    (qs, ts), = generate.pool(SEED, t)
    assert all(900 <= len(q) <= 1100 for q in qs)
    assert len({len(q) for q in qs}) > 8 and len({len(t_) - len(q) for q, t_ in zip(qs, ts)}) > 3
    # an indel rate of 1% at 1-4 letters moves the length by about its share
    assert all(abs(len(t_) - len(q)) < 0.08 * len(q) for q, t_ in zip(qs, ts))
    (qs2, ts2), = generate.pool(SEED, t)
    assert all(np.array_equal(x, y) for x, y in zip(qs + ts, qs2 + ts2))


def test_all_against_all_batches_have_their_own_target_count():
    t = {"alphabet": 20, "length": [30, 50], "batch": 3, "targets": 5, "pool": 2, "check": 7,
         "target": "random", "target_length": [60, 90],
         "request": {"pairing": "all_vs_all", "answers": "score"}}
    batches = generate.pool(SEED, t)
    assert [(len(qs), len(ts)) for qs, ts in batches] == [(3, 5), (3, 5)]
    assert all(60 <= len(x) <= 90 and x.max() < 20 for _, ts in batches for x in ts)
    index = drive.pairs(t["request"], *generate.sizes(t))
    assert index[:6] == [(0, 0), (0, 1), (0, 2), (0, 3), (0, 4), (1, 0)] and len(index) == 15
    s = generate.check_sample(SEED, t, len(index))
    assert len(s) == 7 and all(p < 15 for _, p in s)
