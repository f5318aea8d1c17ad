"""Core types of the port: alphabets and their encoders, BLOSUM62,
``ScoringParams``, ``AlignResult``, the DP sentinel and the pointer codes.

A copy of the JAX package's ``seqalib_tpu/types.py`` (the same values and
behaviour), so that the port imports nothing of that package.  Scoring is
{match/mismatch scalars} or a substitution-matrix lookup over small
integer alphabets.  Gap model: ``gap_open o <= 0``, ``gap_extend e < 0``;
the first gap column costs ``o + e`` and each further column ``e``
(linear gaps are ``o == 0``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Large-negative sentinel standing in for -inf in integer DP.  Chosen so that
# accumulating up to ~2^21 gap-extend steps of |e| <= 2^8 can never underflow
# int32.
NEG_INF = -(1 << 30)

# ---------------------------------------------------------------------------
# Alphabets
# ---------------------------------------------------------------------------

DNA_ALPHABET = "ACGT"
DNA_SIZE = 4

# Standard NCBI 24-letter protein alphabet order used by BLOSUM62.
PROTEIN_ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"
PROTEIN_SIZE = 24

# Alphabet size padded to a small power of two.
PROTEIN_SIZE_PAD = 32

_DNA_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(DNA_ALPHABET):
    _DNA_LUT[ord(_c)] = _i
    _DNA_LUT[ord(_c.lower())] = _i
# Common ambiguity code: N -> A (documented, deterministic).
_DNA_LUT[ord("N")] = 0
_DNA_LUT[ord("n")] = 0

_PROT_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(PROTEIN_ALPHABET):
    _PROT_LUT[ord(_c)] = _i
    _PROT_LUT[ord(_c.lower())] = _i
# Ambiguous/unknown residues map to X.
for _c in "UOJ":
    _PROT_LUT[ord(_c)] = PROTEIN_ALPHABET.index("X")
    _PROT_LUT[ord(_c.lower())] = PROTEIN_ALPHABET.index("X")


def encode_dna(seq) -> np.ndarray:
    """Encode a DNA string (or iterable of chars / uint8 codes) to uint8 codes 0..3."""
    if isinstance(seq, np.ndarray) and seq.dtype == np.uint8:
        return seq
    if isinstance(seq, (bytes, bytearray)):
        raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        raw = np.frombuffer(str(seq).encode("ascii"), dtype=np.uint8)
    codes = _DNA_LUT[raw]
    if (codes == 255).any():
        bad = chr(int(raw[(codes == 255).argmax()]))
        raise ValueError(f"invalid DNA character {bad!r}")
    return codes


def decode_dna(codes: np.ndarray) -> str:
    return "".join(DNA_ALPHABET[int(c)] for c in codes)


def encode_protein(seq) -> np.ndarray:
    """Encode a protein string to uint8 codes 0..23 (BLOSUM62 order)."""
    if isinstance(seq, np.ndarray) and seq.dtype == np.uint8:
        return seq
    if isinstance(seq, (bytes, bytearray)):
        raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        raw = np.frombuffer(str(seq).encode("ascii"), dtype=np.uint8)
    codes = _PROT_LUT[raw]
    if (codes == 255).any():
        bad = chr(int(raw[(codes == 255).argmax()]))
        raise ValueError(f"invalid protein character {bad!r}")
    return codes


def decode_protein(codes: np.ndarray) -> str:
    return "".join(PROTEIN_ALPHABET[int(c)] for c in codes)


# ---------------------------------------------------------------------------
# BLOSUM62 (standard NCBI matrix, 24x24, alphabet order PROTEIN_ALPHABET)
# ---------------------------------------------------------------------------

BLOSUM62 = np.array(
    [
        #  A   R   N   D   C   Q   E   G   H   I   L   K   M   F   P   S   T   W   Y   V   B   Z   X   *
        [  4, -1, -2, -2,  0, -1, -1,  0, -2, -1, -1, -1, -1, -2, -1,  1,  0, -3, -2,  0, -2, -1,  0, -4],  # A
        [ -1,  5,  0, -2, -3,  1,  0, -2,  0, -3, -2,  2, -1, -3, -2, -1, -1, -3, -2, -3, -1,  0, -1, -4],  # R
        [ -2,  0,  6,  1, -3,  0,  0,  0,  1, -3, -3,  0, -2, -3, -2,  1,  0, -4, -2, -3,  3,  0, -1, -4],  # N
        [ -2, -2,  1,  6, -3,  0,  2, -1, -1, -3, -4, -1, -3, -3, -1,  0, -1, -4, -3, -3,  4,  1, -1, -4],  # D
        [  0, -3, -3, -3,  9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1, -3, -3, -2, -4],  # C
        [ -1,  1,  0,  0, -3,  5,  2, -2,  0, -3, -2,  1,  0, -3, -1,  0, -1, -2, -1, -2,  0,  3, -1, -4],  # Q
        [ -1,  0,  0,  2, -4,  2,  5, -2,  0, -3, -3,  1, -2, -3, -1,  0, -1, -3, -2, -2,  1,  4, -1, -4],  # E
        [  0, -2,  0, -1, -3, -2, -2,  6, -2, -4, -4, -2, -3, -3, -2,  0, -2, -2, -3, -3, -1, -2, -1, -4],  # G
        [ -2,  0,  1, -1, -3,  0,  0, -2,  8, -3, -3, -1, -2, -1, -2, -1, -2, -2,  2, -3,  0,  0, -1, -4],  # H
        [ -1, -3, -3, -3, -1, -3, -3, -4, -3,  4,  2, -3,  1,  0, -3, -2, -1, -3, -1,  3, -3, -3, -1, -4],  # I
        [ -1, -2, -3, -4, -1, -2, -3, -4, -3,  2,  4, -2,  2,  0, -3, -2, -1, -2, -1,  1, -4, -3, -1, -4],  # L
        [ -1,  2,  0, -1, -3,  1,  1, -2, -1, -3, -2,  5, -1, -3, -1,  0, -1, -3, -2, -2,  0,  1, -1, -4],  # K
        [ -1, -1, -2, -3, -1,  0, -2, -3, -2,  1,  2, -1,  5,  0, -2, -1, -1, -1, -1,  1, -3, -1, -1, -4],  # M
        [ -2, -3, -3, -3, -2, -3, -3, -3, -1,  0,  0, -3,  0,  6, -4, -2, -2,  1,  3, -1, -3, -3, -1, -4],  # F
        [ -1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4,  7, -1, -1, -4, -3, -2, -2, -1, -2, -4],  # P
        [  1, -1,  1,  0, -1,  0,  0,  0, -1, -2, -2,  0, -1, -2, -1,  4,  1, -3, -2, -2,  0,  0,  0, -4],  # S
        [  0, -1,  0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1,  1,  5, -2, -2,  0, -1, -1,  0, -4],  # T
        [ -3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1,  1, -4, -3, -2, 11,  2, -3, -4, -3, -2, -4],  # W
        [ -2, -2, -2, -3, -2, -1, -2, -3,  2, -1, -1, -2, -1,  3, -3, -2, -2,  2,  7, -1, -3, -2, -1, -4],  # Y
        [  0, -3, -3, -3, -1, -2, -2, -3, -3,  3,  1, -2,  1, -1, -2, -2,  0, -3, -1,  4, -3, -2, -1, -4],  # V
        [ -2, -1,  3,  4, -3,  0,  1, -1,  0, -3, -4,  0, -3, -3, -2,  0, -1, -4, -3, -3,  4,  1, -1, -4],  # B
        [ -1,  0,  0,  1, -3,  3,  4, -2,  0, -3, -3,  1, -1, -3, -1,  0, -1, -3, -2, -2,  1,  4, -1, -4],  # Z
        [  0, -1, -1, -1, -2, -1, -1, -1, -1, -1, -1, -1, -1, -1, -2,  0,  0, -2, -1, -1, -1, -1, -1, -4],  # X
        [ -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4,  1],  # *
    ],
    dtype=np.int32,
)
assert BLOSUM62.shape == (PROTEIN_SIZE, PROTEIN_SIZE)
assert (BLOSUM62 == BLOSUM62.T).all(), "BLOSUM62 must be symmetric"


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScoringParams:
    """Scoring configuration.

    Scalar match/mismatch when ``matrix is None``, else substitution-matrix
    lookup.

    ``gap_open`` (o <= 0) + ``gap_extend`` (e < 0): first gap column costs
    ``o + e``; each extension costs ``e``.  Linear gap == ``gap_open == 0``.
    """

    match: int = 2
    mismatch: int = -3
    gap_open: int = 0
    gap_extend: int = -2
    matrix: Optional[np.ndarray] = None  # (A, A) int32; None -> match/mismatch

    def __post_init__(self):
        if self.gap_open > 0 or self.gap_extend >= 0:
            raise ValueError("gap_open must be <= 0 and gap_extend < 0")
        if self.matrix is not None:
            m = np.asarray(self.matrix, dtype=np.int32)
            if m.ndim != 2 or m.shape[0] != m.shape[1]:
                raise ValueError("substitution matrix must be square")
            object.__setattr__(self, "matrix", m)

    # -- helpers ----------------------------------------------------------
    @property
    def is_affine(self) -> bool:
        return self.gap_open != 0

    @property
    def alphabet_size(self) -> int:
        return DNA_SIZE if self.matrix is None else self.matrix.shape[0]

    def substitution(self, a: int, b: int) -> int:
        """Score of aligning codes a and b (oracle-side scalar lookup)."""
        if self.matrix is None:
            return self.match if a == b else self.mismatch
        return int(self.matrix[a, b])

    def substitution_matrix(self, size: Optional[int] = None) -> np.ndarray:
        """Dense (A, A) int32 substitution matrix (materialized for kernels)."""
        if self.matrix is not None:
            m = self.matrix
        else:
            a = DNA_SIZE
            m = np.full((a, a), self.mismatch, dtype=np.int32)
            np.fill_diagonal(m, self.match)
        if size is not None and size > m.shape[0]:
            out = np.full((size, size), NEG_INF // 2, dtype=np.int32)
            out[: m.shape[0], : m.shape[1]] = m
            return out
        return m

    # -- constructors -------------------------------------------------------
    @staticmethod
    def linear(match: int = 2, mismatch: int = -3, gap: int = -2) -> "ScoringParams":
        return ScoringParams(match=match, mismatch=mismatch, gap_open=0, gap_extend=gap)

    @staticmethod
    def affine(
        match: int = 2, mismatch: int = -3, gap_open: int = -4, gap_extend: int = -1
    ) -> "ScoringParams":
        return ScoringParams(
            match=match, mismatch=mismatch, gap_open=gap_open, gap_extend=gap_extend
        )

    @staticmethod
    def blosum62(gap_open: int = -10, gap_extend: int = -1) -> "ScoringParams":
        return ScoringParams(gap_open=gap_open, gap_extend=gap_extend, matrix=BLOSUM62)


# ---------------------------------------------------------------------------
# Alignment configuration & results
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """What kind of alignment to run.

    mode: "global" (Needleman-Wunsch) or "local" (Smith-Waterman).
    band: None for full DP; else half-width w of the banded DP
          (cells with j - i outside [min(0, m-n) - w, max(0, m-n) + w]
          are -inf; global mode only).
    traceback: if False, only scores (+ coords for local) are computed.
    backend: "oracle" (NumPy contract), the strip route ("strip" here,
             "pallas" in the JAX package) or the full-matrix wavefront
             route ("xla", as in the JAX package).
    """

    mode: str = "global"
    band: Optional[int] = None
    traceback: bool = True
    backend: str = "pallas"

    def __post_init__(self):
        if self.mode not in ("global", "local"):
            raise ValueError(f"mode must be global|local, got {self.mode!r}")
        if self.band is not None:
            if self.mode != "global":
                raise ValueError("banded alignment is global-mode only")
            if self.band < 1:
                raise ValueError("band half-width must be >= 1")
        if self.backend not in ("oracle", "xla", "pallas", "strip"):
            raise ValueError(f"unknown backend {self.backend!r}")


@dataclasses.dataclass(frozen=True)
class AlignResult:
    """One pairwise alignment result.

    Coordinates are 0-based, end-exclusive.  Global mode spans the full
    sequences.  Local mode reports the maximal-scoring segment; an empty
    local alignment (all-negative scores) has score 0 and empty cigar.
    """

    score: int
    query_start: int
    query_end: int
    target_start: int
    target_end: int
    cigar: str

    def __str__(self):
        return (
            f"score={self.score} q[{self.query_start}:{self.query_end}] "
            f"t[{self.target_start}:{self.target_end}] {self.cigar}"
        )


# Pointer codes shared by the oracle and every kernel backend.  The canonical
# tie-break is DIAG > UP > LEFT; UP consumes the query
# (CIGAR I), LEFT consumes the target (CIGAR D).
PTR_STOP = 0
PTR_DIAG = 1
PTR_UP = 2  # from (i-1, j): consumes q[i-1] -> CIGAR 'I'
PTR_LEFT = 3  # from (i, j-1): consumes t[j-1] -> CIGAR 'D'
