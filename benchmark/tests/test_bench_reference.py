import numpy as np
import pytest

import cells
import frozen_oracle
import reference

TAB = reference.substitution_table(2, -3)


def enc(s):
    return np.array(["ACGT".index(c) for c in s], np.int64)


@pytest.mark.parametrize("q, t, band, expected", [
    ("ACGT", "ACGT", None, (8, "4M")),
    ("ACGT", "ACGA", None, (3, "4M")),
    # from the end, DIAG wins its ties with UP (3M1I1M, not 4M1I) ...
    ("ACGTT", "ACGT", None, (1, "3M1I1M")),
    ("ACGT", "AACGT", 1, (1, "1D4M")),
    # ... so a gap of 2 (o + 2e = -9) is pushed to the start
    ("AAAA", "AA", None, (-5, "2I2M")),
    ("A", "", None, (-7, "1I")),
    ("", "AC", None, (-9, "2D")),
])
def test_hand_cases(q, t, band, expected):
    (score, qs, qe, ts, te, cigar), = reference.align([enc(q)], [enc(t)], TAB, -5, -2, band=band)
    assert (score, cigar) == expected
    assert (qs, qe, ts, te) == (0, len(q), 0, len(t))


@pytest.mark.parametrize("band", [None, 0, 1, 3, 8])
@pytest.mark.parametrize("gaps", [(-5, -2), (0, -2), (-1, -1)])
def test_agrees_with_the_frozen_oracle(band, gaps):
    rng = np.random.default_rng(1000 + (band or 99) * 7 + gaps[0])
    qs, ts = [], []
    while len(qs) < 12:
        n, m = int(rng.integers(0, 22)), int(rng.integers(0, 22))
        if n + m == 0 or (band is not None and abs(n - m) > abs(n - m) + band):
            continue
        # low-entropy letters make ties between paths common
        qs.append(rng.integers(0, 2, n))
        ts.append(rng.integers(0, 2, m))
    expected = [frozen_oracle.align(q, t, TAB, *gaps, band=band) for q, t in zip(qs, ts)]
    assert reference.align(qs, ts, TAB, *gaps, band=band) == expected
    scores = reference.align(qs, ts, TAB, *gaps, band=band, traceback=False)
    assert [s[:5] for s in scores] == [e[:5] for e in expected]


BLOSUM62 = cells.read_matrix(cells.HERE / "matrices" / "blosum62.txt")


@pytest.mark.parametrize("matrix", ["dna", "blosum62"])
@pytest.mark.parametrize("gaps", [(-5, -2), (0, -2), (-10, -1), (-1, -1)])
def test_local_agrees_with_the_frozen_oracle(matrix, gaps):
    rng = np.random.default_rng(7000 + gaps[0] * 3 + len(matrix))
    table, letters = (TAB, 2) if matrix == "dna" else (BLOSUM62, 20)
    qs, ts = [], []
    while len(qs) < 14:
        n, m = int(rng.integers(0, 24)), int(rng.integers(0, 24))
        q = rng.integers(0, letters, n)
        # a target sharing a stretch with the query, so that most pairs align
        t = np.concatenate([rng.integers(0, letters, m // 3), q[n // 4: n // 4 + m // 2],
                            rng.integers(0, letters, m // 4)]).astype(np.int64)
        qs.append(q)
        ts.append(t)
    expected = [frozen_oracle.align(q, t, table, *gaps, mode="local") for q, t in zip(qs, ts)]
    assert reference.align(qs, ts, table, *gaps, mode="local") == expected
    scores = reference.align(qs, ts, table, *gaps, mode="local", traceback=False)
    assert [s[:5] for s in scores] == [e[:5] for e in expected]
    assert any(e[0] > 0 for e in expected) and any(e[1] > 0 or e[3] > 0 for e in expected)


def test_local_hand_cases():
    # an exact inner match; no positive cell; the first of two equal maxima
    assert reference.align([enc("TTACGTTT")], [enc("GGACGGG")], TAB, -5, -2, mode="local") == \
        [(6, 2, 5, 2, 5, "3M")]
    assert reference.align([enc("AAAA")], [enc("CCCC")], TAB, -5, -2, mode="local") == \
        [(0, 0, 0, 0, 0, "")]
    assert reference.align([enc("ACGTTACG")], [enc("ACG")], TAB, -5, -2, mode="local") == \
        [(6, 0, 3, 0, 3, "3M")]
    with pytest.raises(ValueError):
        reference.align([enc("ACGT")], [enc("ACGT")], TAB, -5, -2, band=2, mode="local")


def test_batch_of_mixed_lengths_equals_one_by_one():
    rng = np.random.default_rng(5)
    qs = [rng.integers(0, 4, int(rng.integers(30, 90))) for _ in range(6)]
    ts = [np.concatenate([q[: len(q) // 2], rng.integers(0, 4, 3), q[len(q) // 2:]]) for q in qs]
    for band in (None, 6):
        batch = reference.align(qs, ts, TAB, -5, -2, band=band)
        assert batch == [reference.align([q], [t], TAB, -5, -2, band=band)[0]
                         for q, t in zip(qs, ts)]


def test_saturation_caps_the_score():
    q = np.zeros(40, np.int64)
    (score, *_), = reference.align([q], [q], TAB, -5, -2, band=4, saturate=(-64, 63))
    assert score == 63
    (exact, *_), = reference.align([q], [q], TAB, -5, -2, band=4)
    assert exact == 80


def test_band_cells_counts_by_brute_force():
    for n, m, band in [(5, 5, 1), (7, 3, 2), (3, 9, 0), (10, 10, None), (0, 4, 2)]:
        lo, hi = min(0, m - n) - (band or 0), max(0, m - n) + (band or 0)
        brute = sum(1 for i in range(n + 1) for j in range(m + 1)
                    if band is None or lo <= j - i <= hi)
        assert reference.band_cells(n, m, band) == brute
