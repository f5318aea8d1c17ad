"""Port parity: ``seqalib_tpu_torch.ops.sp_tile`` (plain version on the CPU)
against the JAX tile bodies on the same boundaries and letters:

* ``"global"`` against the Pallas ``sp_tile`` in interpret mode (as
  ``tests/test_band_pipeline.py`` runs it), with several strips
  (``SUB=1``, R = 384), two-sublane strips (``SUB=2``), scalar scoring
  and BLOSUM62 (the packed-nibble profile route): every real output, the
  bottom H/F rows at columns 1..C, the right H/E columns, the capture;
* ``"local"`` and ``"ptr"`` against the XLA body ``_tile_scan(local=True)``
  and ``_tile_scan(want_ptr=True)``: every output, and every pointer byte
  of the tile's cells; and ``"global"`` with a table outside the
  packed-nibble range against ``_tile_scan``, which the Pallas tile refuses;
* a run of three tiles (``sp_tile_run``, global and local) against three
  chained JAX tiles (``_tile_scan``, and the Pallas tile for global), the
  capture cell inside the last tile short of its right column, R not a
  multiple of the kernel's strip; and a batch of pointer tiles
  (``sp_tile_ptr``) cut to the rows a walk can reach, against the same rows
  of ``_tile_scan(want_ptr=True)`` for each tile.

Exact equality: the work is integer DP.  The boundaries are random, and
the capture cell (n, m) lies inside the tile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqalib_tpu.ops.sp_tile_pallas import sp_tile as jax_sp_tile
from seqalib_tpu.ops.strip_pallas import _build_profile_packed
from seqalib_tpu.parallel.band_pipeline import _tile_scan
from seqalib_tpu.types import BLOSUM62
from seqalib_tpu_torch.ops import launches
from seqalib_tpu_torch.ops.sp_tile import NEG, ptr_index, sp_tile, sp_tile_ptr, sp_tile_run

O, E = -5, -2
MATCH, MISMATCH = 2, -3
WIDE = np.where(np.eye(4, dtype=bool), 40, -40).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them fast when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.int32)


def _tile_inputs(seed, R, C, alpha, i0=256, j0=64):
    """Letters and boundaries of one tile: the block's query letters, the
    padded target (t_pad[x] = letter of column x), H/F of the row above
    (corner first), H/E of the column to the left; (n, m) inside the tile."""
    rng = np.random.default_rng(seed)
    qb = rng.integers(0, alpha, R).astype(np.int32)
    t_pad = rng.integers(0, alpha, j0 + R + C + 2).astype(np.int32)
    t_pad[j0 + 1: j0 + 1 + C // 2] = qb[: C // 2]  # a shared stretch
    htop = rng.integers(-60, 40, C + 1).astype(np.int32)
    ftop = (htop[1:] - rng.integers(0, 9, C)).astype(np.int32)
    hcol = rng.integers(-60, 40, R).astype(np.int32)
    ecol = (hcol - rng.integers(0, 9, R)).astype(np.int32)
    n, m = i0 + R - 3, j0 + C - 5
    return dict(qb=qb, t_pad=t_pad, htop=htop, ftop=ftop, hcol=hcol, ecol=ecol,
                i0=i0, j0=j0, n=n, m=m, R=R, C=C)


def _port(c, mode, table=None, cap=NEG):
    j0, C = c["j0"], c["C"]
    out = sp_tile(_t(c["qb"]), _t(c["t_pad"][j0: j0 + C + 1]), _t(c["htop"]),
                  _t(c["ftop"]), _t(c["hcol"]), _t(c["ecol"]), _t([cap]),
                  None if table is None else _t(table), i0=c["i0"], j0=j0, n=c["n"],
                  m=c["m"], C=C, match=MATCH, mismatch=MISMATCH, gap_open=O,
                  gap_extend=E, mode=mode)
    return {k: v.numpy() for k, v in out.items()}


# (R, C, SUB, scoring): R = SUB * 128 * strips
PALLAS_CASES = {
    "dna_sub1_3strips": (384, 64, 1, "dna"),
    "dna_sub2_2strips": (512, 96, 2, "dna"),
    "blosum62_sub1_2strips": (256, 64, 1, "blosum62"),
}


@pytest.fixture(scope="module", params=sorted(PALLAS_CASES))
def pallas_case(request):
    R, C, SUB, scoring = PALLAS_CASES[request.param]
    table = BLOSUM62 if scoring == "blosum62" else None
    c = _tile_inputs(len(request.param), R, C, 20 if table is not None else 4)
    Ct = -(-(C + 1) // 128) * 128
    htop = np.zeros((1, Ct), np.int32)
    htop[0, : C + 1] = c["htop"]
    ftop = np.zeros((1, Ct), np.int32)
    ftop[0, 1: C + 1] = c["ftop"]
    tk = c["t_pad"][c["j0"]: c["j0"] + Ct][None, :]
    if table is not None:
        qk = _build_profile_packed(jnp.asarray(c["qb"])[None, :],
                                   jnp.asarray(table))[0].reshape(4, R // 128, 128)
    else:
        qk = jnp.asarray(c["qb"].reshape(R // 128, 128))
    meta = np.zeros((1, 128), np.int32)
    meta[0, :5] = [c["i0"], c["j0"], c["n"], c["m"], NEG]
    hbot, fbot, hco, eco, cap = jax_sp_tile(
        qk, jnp.asarray(tk), jnp.asarray(htop), jnp.asarray(ftop),
        jnp.asarray(c["hcol"].reshape(R // 128, 128)),
        jnp.asarray(c["ecol"].reshape(R // 128, 128)), jnp.asarray(meta), SUB=SUB,
        C=C, match=MATCH, mismatch=MISMATCH, gap_open=O, gap_extend=E,
        interpret=True, profile=table is not None)
    want = {"hbot": np.asarray(hbot)[0, 1: C + 1], "fbot": np.asarray(fbot)[0, 1: C + 1],
            "hcol": np.asarray(hco).reshape(R), "ecol": np.asarray(eco).reshape(R),
            "cap": np.asarray(cap)[0, :1]}
    return c, table, want


def test_global_tile_matches_the_pallas_tile(pallas_case):
    c, table, want = pallas_case
    before = dict(launches)
    got = _port(c, "global", table)
    assert launches == before  # the CPU path runs the plain version
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["cap"][0] > NEG  # the capture cell lies in the tile


def _xla(c, table, **kw):
    out = _tile_scan(
        jnp.asarray(c["qb"]), jnp.asarray(c["t_pad"]), c["j0"], jnp.asarray(c["htop"]),
        jnp.asarray(c["ftop"]), jnp.asarray(c["hcol"]), jnp.asarray(c["ecol"]),
        jnp.int32(NEG), C=c["C"], i0=c["i0"], n=c["n"], m=c["m"], match=MATCH,
        mismatch=MISMATCH, o=O, e=E, table=None if table is None else jnp.asarray(table),
        **kw)
    return [np.asarray(x) for x in out]


SCAN_CASES = {  # (R, C, scoring)
    "dna": (150, 40, None),
    "blosum62": (97, 53, BLOSUM62),
    "wide": (120, 33, WIDE),
}


@pytest.mark.parametrize("scoring", sorted(SCAN_CASES))
@pytest.mark.parametrize("mode", ["global", "local", "ptr"])
def test_tile_matches_the_xla_tile_body(mode, scoring):
    R, C, table = SCAN_CASES[scoring]
    c = _tile_inputs(R + C, R, C, 4 if table is WIDE or table is None else 20)
    if mode == "local":  # an SW tile: boundaries >= 0
        for k in ("htop", "hcol"):
            c[k] = np.abs(c[k])
    want = _xla(c, table, local=mode == "local", want_ptr=mode == "ptr")
    got = _port(c, mode, table)
    for k, w in zip(("hbot", "fbot", "hcol", "ecol"), want):
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert got["cap"][0] == want[4]
    if mode == "ptr":
        # cell (i0 + p + 1, j0 + c) at ptr_index(p, c) here, at
        # [c + p - 1, p] in the scan (whose slots outside the tile are junk)
        p, col = np.meshgrid(np.arange(R), np.arange(1, C + 1), indexing="ij")
        assert got["ptr"].shape == (C, R)
        np.testing.assert_array_equal(got["ptr"][ptr_index(p, col, C)],
                                      want[5][col + p - 1, p])
        assert len(np.unique(got["ptr"] & 3)) == 3  # diag, up and left


def test_sp_tile_rejects_bad_arguments():
    c = _tile_inputs(0, 64, 16, 4)
    with pytest.raises(ValueError, match="mode"):
        _port(c, "emode")
    with pytest.raises(ValueError, match="htop"):
        sp_tile(_t(c["qb"]), _t(c["t_pad"][:17]), _t(c["htop"][:5]), _t(c["ftop"]),
                _t(c["hcol"]), _t(c["ecol"]), _t([NEG]), None, i0=0, j0=0, n=1, m=1,
                C=16, match=MATCH, mismatch=MISMATCH, gap_open=O, gap_extend=E,
                mode="global")
    with pytest.raises(ValueError, match="strip"):
        sp_tile(_t(c["qb"]), _t(c["t_pad"][:17]), _t(c["htop"][:17]), _t(c["ftop"][:16]),
                _t(c["hcol"]), _t(c["ecol"]), _t([NEG]), None, i0=0, j0=0, n=1, m=1,
                C=16, match=MATCH, mismatch=MISMATCH, gap_open=O, gap_extend=E,
                mode="global", strip=48)


def _chained_xla(c, table, T, local):
    """T JAX tiles, each from the one before: the bottom rows, every
    tile's right column and the capture."""
    C = c["C"]
    hcol, ecol, cap = jnp.asarray(c["hcol"]), jnp.asarray(c["ecol"]), jnp.int32(NEG)
    hbot, fbot, hcols, ecols = [], [], [], []
    for t in range(T):
        x = t * C
        out = _tile_scan(
            jnp.asarray(c["qb"]), jnp.asarray(c["t_pad"]), c["j0"] + x,
            jnp.asarray(c["htop"][x: x + C + 1]), jnp.asarray(c["ftop"][x: x + C]), hcol,
            ecol, cap, C=C, i0=c["i0"], n=c["n"], m=c["m"], match=MATCH, mismatch=MISMATCH,
            o=O, e=E, table=None if table is None else jnp.asarray(table), local=local)
        hb, fb, hcol, ecol, cap = out
        hbot.append(np.asarray(hb))
        fbot.append(np.asarray(fb))
        hcols.append(np.asarray(hcol))
        ecols.append(np.asarray(ecol))
    return {"hbot": np.concatenate(hbot), "fbot": np.concatenate(fbot),
            "hcol": hcols[-1], "ecol": ecols[-1], "cap": np.asarray(cap).reshape(1),
            "hcols": np.stack(hcols), "ecols": np.stack(ecols)}


def _run_inputs(seed, R, C, T, alpha, local):
    c = _tile_inputs(seed, R, T * C, alpha)
    c["C"] = C
    c["m"] = c["j0"] + T * C - C // 3  # inside the last tile, short of its right column
    if local:  # an SW run: boundaries >= 0
        for k in ("htop", "hcol"):
            c[k] = np.abs(c[k])
    return c


def _port_run(c, mode, table, T, **kw):
    j0, C = c["j0"], c["C"]
    out = sp_tile_run(_t(c["qb"]), _t(c["t_pad"][j0: j0 + T * C + 1]), _t(c["htop"]),
                      _t(c["ftop"]), _t(c["hcol"]), _t(c["ecol"]), _t([NEG]),
                      None if table is None else _t(table), i0=c["i0"], j0=j0, n=c["n"],
                      m=c["m"], C=C, match=MATCH, mismatch=MISMATCH, gap_open=O,
                      gap_extend=E, mode=mode, **kw)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("scoring", ["dna", "blosum62"])
@pytest.mark.parametrize("mode", ["global", "local"])
def test_run_of_three_tiles_matches_three_chained_jax_tiles(mode, scoring):
    table = BLOSUM62 if scoring == "blosum62" else None
    c = _run_inputs(7, 150, 40, 3, 20 if table is not None else 4, mode == "local")
    want = _chained_xla(c, table, 3, mode == "local")
    before = dict(launches)
    got = _port_run(c, mode, table, 3, strip=64, want_cols=True)  # 150 rows: ragged strips
    assert launches == before  # the CPU path runs the plain version
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["cap"][0] > NEG
    short = _port_run(c, mode, table, 3)  # score-only: no per-tile columns
    assert sorted(short) == ["cap", "ecol", "fbot", "hbot", "hcol"]
    for k in short:
        np.testing.assert_array_equal(short[k], want[k], err_msg=k)


def test_global_run_matches_three_chained_pallas_tiles():
    R, C, T = 256, 64, 3
    c = _run_inputs(3, R, C, T, 4, False)
    Ct = -(-(C + 1) // 128) * 128
    hcol = jnp.asarray(c["hcol"].reshape(R // 128, 128))
    ecol = jnp.asarray(c["ecol"].reshape(R // 128, 128))
    cap = NEG
    hbot, hcols = [], []
    for t in range(T):
        x = t * C
        htop = np.zeros((1, Ct), np.int32)
        htop[0, : C + 1] = c["htop"][x: x + C + 1]
        ftop = np.zeros((1, Ct), np.int32)
        ftop[0, 1: C + 1] = c["ftop"][x: x + C]
        j0 = c["j0"] + x
        meta = np.zeros((1, 128), np.int32)
        meta[0, :5] = [c["i0"], j0, c["n"], c["m"], cap]
        hb, fb, hcol, ecol, capo = jax_sp_tile(
            jnp.asarray(c["qb"].reshape(R // 128, 128)),
            jnp.asarray(c["t_pad"][j0: j0 + Ct][None, :]), jnp.asarray(htop),
            jnp.asarray(ftop), hcol, ecol, jnp.asarray(meta), SUB=1, C=C, match=MATCH,
            mismatch=MISMATCH, gap_open=O, gap_extend=E, interpret=True, profile=False)
        cap = int(np.asarray(capo)[0, 0])
        hbot.append(np.asarray(hb)[0, 1: C + 1])
        hcols.append(np.asarray(hcol).reshape(R))
    got = _port_run(c, "global", None, T, strip=96, want_cols=True)  # 256 = 2 x 96 + 64
    np.testing.assert_array_equal(got["hbot"], np.concatenate(hbot))
    np.testing.assert_array_equal(got["hcols"], np.stack(hcols))
    assert got["cap"][0] == cap > NEG


@pytest.mark.parametrize("scoring", ["dna", "blosum62"])
def test_pointer_batch_matches_jax_tiles_on_the_reachable_rows(scoring):
    """Three tiles of one block, (d, tt), (d, tt - 1), (d, tt - 2), each from
    its own boundaries, recomputed on their first 100 of 150 rows."""
    table = BLOSUM62 if scoring == "blosum62" else None
    R, C, K, rows = 150, 40, 3, 100
    tiles = [_tile_inputs(30 + g, R, C, 20 if table is not None else 4, j0=200 - g * C)
             for g in range(K)]
    t_pad = tiles[0]["t_pad"]  # one target for the block: every tile reads it
    j0 = tiles[0]["j0"]
    lo = j0 - (K - 1) * C
    stack = lambda k, cut=None: _t(np.stack([c[k][:cut] for c in tiles]))  # noqa: E731
    got = sp_tile_ptr(_t(tiles[0]["qb"][:rows]), _t(t_pad[lo: j0 + C + 1]), stack("htop"),
                      stack("ftop"), stack("hcol", rows), stack("ecol", rows), _t([NEG]),
                      None if table is None else _t(table), i0=256, j0=j0, n=0, m=0, C=C,
                      match=MATCH, mismatch=MISMATCH, gap_open=O, gap_extend=E)
    assert got["ptr"].shape == (K, C, rows)
    p, col = np.meshgrid(np.arange(rows), np.arange(1, C + 1), indexing="ij")
    for g, c in enumerate(tiles):
        c = dict(c, qb=tiles[0]["qb"], t_pad=t_pad, i0=256, n=0, m=0)
        want = _xla(c, table, want_ptr=True)[5]
        np.testing.assert_array_equal(got["ptr"][g].numpy()[ptr_index(p, col, C)],
                                      want[col + p - 1, p], err_msg=f"tile {g}")
