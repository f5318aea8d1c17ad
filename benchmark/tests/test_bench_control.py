"""The controls, kept at sizes a test run holds: each cell's check must
find the reference with one guarantee broken wrong.  On the card at the
cells' own sizes: ``python3 benchmark/control.py --workload NAME --seed N``
(PERF.md gives the readings)."""

import added
import cells
import control

SEED = 2**31 + 31337


def readings(name, **traffic):
    c = cells.load(name)
    c.traffic.update(traffic)
    return control.readings(c, SEED)


def test_banded_reads_past_16_bits_fail_both_controls(tmp_path):
    # 18 kb at 2% substitutions scores ~34 000: past int16
    for answers in ("alignment", "score"):
        traffic = dict(added.BANDED_READS, length=18000, batch=1, pool=1, check=1)
        traffic["request"] = dict(traffic["request"], answers=answers)
        c = added.add_cell(tmp_path / answers, added.BANDED, traffic)
        r = control.readings(c, SEED)
        assert r["int16"] == 1 and r["linear_gaps"] == 1


def test_the_genome_pair_fails_the_linear_gap_control():
    for name in ("long_pair_sp.score", "long_pair_sp.cigar"):
        r = readings(name, length=1000)
        assert r["linear_gaps"] == r["pairs"] == 2
        assert r["int16"] == 0  # a 1 000-letter score fits 16 bits
