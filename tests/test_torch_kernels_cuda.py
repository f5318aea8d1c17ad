"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
device.  These tests skip without one (``chip_smoke.py`` checks the
kernels on the card at the main path's shapes).  On a machine with a card:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Exact equality: the kernels do integer DP."""

import re

import numpy as np
import pytest
import torch

from seqalib_tpu import oracle_fast
from seqalib_tpu.types import BLOSUM62, PTR_DIAG, PTR_LEFT, PTR_UP, ScoringParams
from seqalib_tpu_torch import align_batch
from seqalib_tpu_torch._build import CSRC
from seqalib_tpu_torch.models.banded import _geometry, _pad_letters
from seqalib_tpu_torch.ops import launches
from seqalib_tpu_torch.ops.band_fill import band_fill, band_fill_ref, band_table
from seqalib_tpu_torch.ops.band_walk import band_walk, band_walk_ref
from seqalib_tpu_torch.ops import strip_fill as sf_mod
from seqalib_tpu_torch.ops import wavefront as wf_mod
from seqalib_tpu_torch.ops.row_window import (NO_ERROR, error_words, raise_on_error,
                                              row_window, row_window_ref)
from seqalib_tpu_torch.ops.sp_tile import NEG as SP_NEG
from seqalib_tpu_torch.ops.sp_tile import (sp_tile, sp_tile_ptr, sp_tile_ptr_ref,
                                           sp_tile_ref, sp_tile_run, sp_tile_run_ref)
from seqalib_tpu_torch.ops.strip import prep_strip
from seqalib_tpu_torch.ops.strip_fill import strip_fill, strip_fill_ref
from seqalib_tpu_torch.ops import strip_walk as sw_mod
from seqalib_tpu_torch.ops.strip_walk import strip_walk, strip_walk_ref
from seqalib_tpu_torch.ops.wavefront import (wavefront_fill, wavefront_fill_ref,
                                             wavefront_inputs)
from seqalib_tpu_torch.ops.wavefront_walk import wavefront_walk, wavefront_walk_ref
from seqalib_tpu_torch.scoring import scoring_params, tables_from_params
from seqalib_tpu_torch.types import NEG_INF

pytestmark = pytest.mark.cuda

SCORINGS = {
    "dna_linear": (ScoringParams.linear(), 4),
    "dna_affine": (ScoringParams.affine(), 4),
    "blosum62_affine": (ScoringParams.blosum62(gap_open=-10, gap_extend=-1), 20),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; kernels are checked by chip_smoke.py")
    return torch.device("cuda")


def _batch(alpha, dev, B=37, n=150, m=170, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, alpha, size=(B, n))
    t = rng.integers(0, alpha, size=(B, m))
    t[:, 20:90] = q[:, 30:100]
    qlen = rng.integers(0, n + 1, size=B)
    tlen = rng.integers(0, m + 1, size=B)
    qlen[0], tlen[0] = n, m
    qpad, t2 = prep_strip(q, t, qlen, tlen, alpha + 1, dev)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)
    return qpad, t2, as_t(qlen), as_t(tlen), m


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
@pytest.mark.parametrize("mode,want_ptr", [("local", False), ("local", True),
                                           ("emode", False), ("gmode", True)])
def test_strip_fill_kernel_matches_plain_version(dev, scoring, mode, want_ptr):
    sp, alpha = SCORINGS[scoring]
    tables = tables_from_params(sp, dev)
    qpad, t2, ql, tl, m = _batch(alpha, dev)
    before = launches[f"strip_fill/{mode}"]
    got = strip_fill(qpad, t2, ql, tl, tables, mq=m, mode=mode, want_ptr=want_ptr)
    torch.cuda.synchronize()
    assert launches[f"strip_fill/{mode}"] == before + 1
    want = strip_fill_ref(qpad, t2, ql, tl, tables, mq=m, mode=mode, want_ptr=want_ptr)
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def _same_walk(got, want):
    """Two ``strip_walk`` results agree: nchar, the final states, and each
    row's last nchar text bytes (the bytes before them are undefined)."""
    (gt, gn, gs), (wt, wn, ws) = got, want
    assert torch.equal(gn, wn) and torch.equal(gs, ws)
    W = gt.shape[1]
    keep = torch.arange(W, device=gt.device)[None, :] >= W - gn.long()[:, None]
    assert torch.equal(torch.where(keep, gt, 0), torch.where(keep, wt, 0))


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_strip_walk_kernel_matches_plain_version(dev, scoring):
    sp, alpha = SCORINGS[scoring]
    tables = tables_from_params(sp, dev)
    qpad, t2, ql, tl, m = _batch(alpha, dev, seed=1)
    P = strip_fill(qpad, t2, ql, tl, tables, mq=m, mode="gmode", want_ptr=True)["P"]
    args = (P, ql, tl, torch.zeros_like(ql), ((ql == 0) | (tl == 0)).int())
    before = launches["strip_walk"]
    got = strip_walk(*args, affine=tables.affine)
    torch.cuda.synchronize()
    assert launches["strip_walk"] == before + 1
    _same_walk(got, strip_walk_ref(*args, affine=tables.affine))


WALK_FILLS = {"up": PTR_UP, "left": PTR_LEFT, "diagonal": PTR_DIAG}
# the kernel's staged block: the steps between two copies
WALK_TILE = int(re.search(r"constexpr int kTile = (\d+);",
                          (CSRC / "strip_walk.cu").read_text()).group(1))


@pytest.mark.parametrize("C", [197, 198])
@pytest.mark.parametrize("direction", sorted(WALK_FILLS))
def test_strip_walk_kernel_on_straight_walks_across_the_staged_blocks(dev, direction, C):
    """Walks straight up, left or down the diagonal of T - 1 .. 3T + 1
    steps (T the kernel's tile), so that they end on either side of a
    staged block's edge, from start columns near 0 and near the row's end,
    on odd and even strides."""
    tile = WALK_TILE
    R = 197
    steps = [tile - 1, tile, tile + 1, 2 * tile - 1, 2 * tile, 2 * tile + 1, 3 * tile + 1]
    starts = []
    for n in steps:
        for far in (n, C):  # the walk ends at column 0, or far from it
            if direction == "up":
                starts.append((min(n, R), max(1, far - n // 2)))
            elif direction == "left":
                starts.append((max(1, min(R, far) - 3), min(n, C)))
            else:
                starts.append((min(n, R), min(far, C)))
    P = torch.full((len(starts), R, C), WALK_FILLS[direction], dtype=torch.uint8,
                   device=dev)
    i = torch.tensor([s[0] for s in starts], dtype=torch.int32, device=dev)
    j = torch.tensor([s[1] for s in starts], dtype=torch.int32, device=dev)
    z = torch.zeros_like(i)
    got = strip_walk(P, i, j, z, z, affine=False)
    _same_walk(got, strip_walk_ref(P, i, j, z, z, affine=False))


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("B,R,C", [(1, 700, 901), (512, 300, 255), (37, 64, 64)])
def test_strip_walk_kernel_on_random_pointer_bytes(dev, B, R, C, affine):
    """Random pointer bytes (STOP pointers, E and F states) and start
    states; a tenth of the pairs done at the start, one pair starting at
    (R, C).  A run of one op each way; long runs come from a band of
    diagonal bytes around the main diagonal."""
    rng = np.random.default_rng(B + R + C + affine)
    Pn = rng.integers(1, 16, size=(B, R, C)).astype(np.uint8)
    Pn[rng.random(Pn.shape) < 0.002] &= 12  # a few STOP pointers
    diag = np.abs(np.arange(R)[:, None] - np.arange(C)[None, :]) < 3
    Pn[: B // 2, diag] = (Pn[: B // 2, diag] & 12) | PTR_DIAG
    P = torch.as_tensor(Pn, device=dev)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)  # noqa: E731
    i = rng.integers(0, R + 1, size=B)
    j = rng.integers(0, C + 1, size=B)
    i[0], j[0] = R, C
    st = rng.integers(0, 3 if affine else 1, size=B)
    done = rng.random(B) < 0.1
    done[0] = False
    args = (P, as_t(i), as_t(j), as_t(st), as_t(done))
    got = strip_walk(*args, affine=affine)
    _same_walk(got, strip_walk_ref(*args, affine=affine))


def test_strip_walk_makes_one_launch_and_no_sync(dev):
    """Under the sync debug mode a device-to-host transfer raises; the
    profiler sees one kernel per call and nothing else on the device."""
    P = torch.full((64, 300, 301), PTR_DIAG, dtype=torch.uint8, device=dev)
    i = torch.full((64,), 300, dtype=torch.int32, device=dev)
    z = torch.zeros_like(i)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = strip_walk(P, i, i, z, z, affine=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _same_walk(got, strip_walk_ref(P, i, i, z, z, affine=True))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        strip_walk(P, i, i, z, z, affine=True)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "strip_walk_kernel" in kernels[0], kernels


def test_strip_walk_refuses_an_unaligned_pointer_array(dev):
    """The kernel copies 16-byte segments of P: a P that does not start on
    one raises at once (the wrapper makes no copy of P)."""
    flat = torch.full((1 + 2 * 40 * 41,), PTR_DIAG, dtype=torch.uint8, device=dev)
    P = flat[1:].view(2, 40, 41)
    i = torch.full((2,), 40, dtype=torch.int32, device=dev)
    z = torch.zeros_like(i)
    with pytest.raises(ValueError, match="16-byte aligned"):
        strip_walk(P, i, i, z, z, affine=False)


def test_strip_walk_defers_its_range_check_to_the_host_copy(dev, monkeypatch):
    """A start cell outside P walks nothing on the card (nchar -1, its state
    kept); ``strip_bucket`` raises the ValueError when it decodes its copy."""
    P = torch.full((3, 40, 41), PTR_DIAG, dtype=torch.uint8, device=dev)
    i = torch.tensor([40, 41, 7], dtype=torch.int32, device=dev)
    j = torch.tensor([41, 5, 42], dtype=torch.int32, device=dev)
    z = torch.zeros_like(i)
    text, nchar, state = strip_walk(P, i, j, z, z, affine=False)
    assert nchar.tolist() == [len("1D40M"), sw_mod.BAD_START, sw_mod.BAD_START]
    assert state[:2, 1:].tolist() == [[41, 7], [5, 42]]
    with pytest.raises(ValueError, match="pair 1's start cell lies outside P"):
        sw_mod.cigars_from_text(text, nchar)
    from seqalib_tpu_torch.ops import strip as strip_mod

    real = strip_mod.strip_walk

    def shifted(P, i, j, st, done, **kw):
        return real(P, i + P.shape[1] * (torch.arange(len(i), device=i.device) == 1), j,
                    st, done, **kw)

    monkeypatch.setattr(strip_mod, "strip_walk", shifted)
    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, size=(2, 40))
    tables = tables_from_params(scoring_params(2, -3, -5, -2, None), dev)
    for mode in ("local", "global"):
        with pytest.raises(ValueError, match="start cell lies outside P"):
            strip_mod.strip_bucket(q, q.copy(), np.array([40, 31]), np.array([40, 35]),
                                   tables, mode=mode, want_tb=True)


def _window_args(dev, seed, N=40):
    rng = np.random.default_rng(seed)
    src = torch.as_tensor(rng.integers(0, 30, size=(N, 300)), dtype=torch.int32, device=dev)
    starts = torch.as_tensor(rng.integers(0, 200, size=N), dtype=torch.int32, device=dev)
    hi = torch.as_tensor(rng.integers(0, 100, size=N), dtype=torch.int32, device=dev)
    return src, starts, hi


@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lo", [0, 1])
def test_row_window_kernel_matches_plain_version(dev, lo, reverse, deferred):
    src, starts, hi = _window_args(dev, lo)
    err = error_words(1, dev) if deferred else None
    before = launches["row_window"]
    got = row_window(src, starts, hi, L=128, lo=lo, fill=-1, reverse=reverse, err=err)
    torch.cuda.synchronize()
    assert launches["row_window"] == before + 1
    assert torch.equal(got, row_window_ref(src, starts, hi, L=128, lo=lo, fill=-1,
                                           reverse=reverse))
    if deferred:
        assert int(err) == NO_ERROR


def test_row_window_with_an_error_word_does_not_sync(dev):
    """The deferred range check records the first bad row on the card; the
    call itself makes no device-to-host transfer."""
    src, starts, hi = _window_args(dev, 2)
    starts[[7, 3, 30]] = torch.tensor([290, -4, 299], dtype=torch.int32, device=dev)
    hi[[7, 3, 30]] = 50
    err = error_words(1, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = row_window(src, starts, hi, L=128, lo=0, fill=-1, reverse=True, err=err)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, row_window_ref(src, starts, hi, L=128, lo=0, fill=-1,
                                           reverse=True))
    assert int(err) == 3  # the first of the rows that overrun
    with pytest.raises(ValueError, match="outside a source"):
        raise_on_error(err.cpu(), [300])


def test_strip_bucket_on_cuda_refuses_an_overrun(dev, monkeypatch):
    """A window start pushed out of its source inside ``strip_bucket``
    raises the ValueError at the host copy."""
    from seqalib_tpu_torch.ops import strip as strip_mod

    real = strip_mod.row_window
    calls = []

    def shifted(src, starts, hi, **kw):
        calls.append(kw.get("err") is not None)
        return real(src, starts + src.shape[1], hi, **kw)

    monkeypatch.setattr(strip_mod, "row_window", shifted)
    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, size=(2, 40))
    tables = tables_from_params(scoring_params(2, -3, -5, -2, None), dev)
    with pytest.raises(ValueError, match="outside a source"):
        strip_mod.strip_bucket(q, q.copy(), np.array([40, 31]), np.array([40, 35]), tables,
                               mode="local", want_tb=True)
    assert calls == [True] * 4  # every window ran, deferred


@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_align_batch_on_cuda_matches_oracle(dev, mode, scoring):
    sp, alpha = SCORINGS[scoring]
    rng = np.random.default_rng(7)
    qs = [rng.integers(0, alpha, size=rng.integers(0, 300)).astype(np.uint8) for _ in range(24)]
    ts = [rng.integers(0, alpha, size=rng.integers(0, 300)).astype(np.uint8) for _ in range(24)]
    ts[3] = qs[3].copy()
    got = align_batch(qs, ts, scoring=sp, mode=mode, device=dev)
    for q, t, r in zip(qs, ts, got):
        assert str(r) == str(oracle_fast.align_oracle(q, t, sp, mode=mode))


# slot widths: the callers' (multiples of 128; 1152 holds 4 slots a
# thread), one with idle threads (100) and one whose last thread holds a
# slot and an idle one (1001)
WPS = [128, 256, 384, 1152, 1001, 100]


def _band_bucket(dev, scoring, B=21, band=9, CK=32, seed=2, Wp=None, qmax=300):
    """A mixed-delta bucket laid out as ``banded_align_batch`` lays it out,
    filled by the plain version with checkpoints; ``Wp`` widens the slot
    rows past the geometry's (the extra slots are junk, held all the
    same)."""
    sp, alpha = SCORINGS[scoring]
    rng = np.random.default_rng(seed)
    qlen = rng.integers(0, qmax, size=B)
    tlen = np.clip(qlen + rng.integers(-20, 21, size=B), 0, None)
    n, m = int(qlen.max()), int(tlen.max())
    qs = rng.integers(0, alpha, size=(B, n))
    ts = rng.integers(0, alpha, size=(B, m))
    ts[:, 10:qmax * 2 // 3] = qs[:, 14:qmax * 2 // 3 + 4]
    deltas = tlen - qlen
    dlo_p, dhi_p = np.minimum(0, deltas) - band, np.maximum(0, deltas) + band
    dlo, dhi = int(dlo_p.min()), int(dhi_p.max())
    Wg, K = _geometry(dlo, dhi, n, m)
    Wp = Wp or Wg
    assert Wp >= (dhi - dlo + 1) // 2 + 2
    Kp = -(-K // CK) * CK
    table = sp.substitution_matrix()
    A = table.shape[0]
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    args = [as_t(_pad_letters(qs, n + 1, A, qlen)), as_t(_pad_letters(ts, m + 1, A + 1, tlen))]
    args += [as_t(v) for v in (qlen, tlen, dlo_p, dhi_p)]
    state = torch.full((4, B, Wp), NEG_INF, dtype=torch.int32, device=dev)
    score = torch.full((B, Wp), NEG_INF, dtype=torch.int32, device=dev)
    tab = as_t(band_table(table, -4 if sp.matrix is not None else sp.mismatch))
    kw = dict(K=K, dlo=dlo, dhi=dhi, gap_open=sp.gap_open, gap_extend=sp.gap_extend)
    ck = band_fill_ref(*args, state, score, tab, k0=0, k1=Kp, mode="fill", CK=CK, **kw)
    return dict(args=args, state=state, score=score, tab=tab, kw=kw, Kp=Kp, CK=CK,
                ckpt=ck["ckpt"], qlen=qlen, tlen=tlen, dhi=dhi)


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("Wp", WPS)
@pytest.mark.parametrize("scoring", sorted(SCORINGS))
@pytest.mark.parametrize("mode", ["fill", "ptr"])
def test_band_fill_kernel_matches_plain_version(dev, scoring, mode, Wp):
    c = _band_bucket(dev, scoring, Wp=Wp)
    if mode == "fill":
        call = dict(k0=0, k1=c["Kp"], mode="fill", CK=c["CK"])
        state = c["state"]
    else:
        cg = c["ckpt"].shape[0] // 2
        call = dict(k0=cg * c["CK"], k1=c["Kp"], mode="ptr")
        state = c["ckpt"][cg]
    before = launches[f"band_fill/{mode}"]
    got = band_fill(*c["args"], state, c["score"], c["tab"], **call, **c["kw"])
    torch.cuda.synchronize()
    assert launches[f"band_fill/{mode}"] == before + 1
    _same(got, band_fill_ref(*c["args"], state, c["score"], c["tab"], **call, **c["kw"]))


@pytest.mark.parametrize("Wp", WPS)
@pytest.mark.parametrize("tie_safe", [False, True])
@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_band_fill_emode_kernel_matches_plain_version(dev, scoring, tie_safe, Wp):
    c = _band_bucket(dev, scoring, band=64, Wp=Wp)
    B, Wp = c["score"].shape
    state = torch.cat([c["state"], c["score"][None],
                       torch.zeros((1, B, Wp), dtype=torch.int32, device=dev)])
    call = dict(k0=0, k1=c["Kp"], mode="emode", tie_safe=tie_safe, smax=11, **c["kw"])
    before = launches["band_fill/emode"]
    got = band_fill(*c["args"], state, c["score"], c["tab"], **call)
    torch.cuda.synchronize()
    assert launches["band_fill/emode"] == before + 1
    _same(got, band_fill_ref(*c["args"], state, c["score"], c["tab"], **call))


# fault 8 (ROADMAP Queue 3): short local pairs under DNA affine scoring times
# 2^k near int32's range; the banded pass 2 wrapped int32 past the pair
FAULT_8 = [(np.array([3], np.uint8), np.array([3, 3], np.uint8), 25),
           (np.array([2, 2, 3, 0, 3, 2, 0], np.uint8), np.array([3, 0, 1, 0, 3], np.uint8), 23),
           (np.array([0] * 15, np.uint8), np.array([0, 1] * 8, np.uint8), 23)]


@pytest.mark.parametrize("traceback", [True, False])
@pytest.mark.parametrize("case", range(len(FAULT_8)))
def test_fault_8_pass2_near_int32_range_on_the_card(dev, case, traceback):
    """Each emode call of the pair's pass 2 equals its plain version, and
    the result the oracle's (the kernel wrapped below -2^31 before EMODE_FLOOR:
    pass 3's row window then raised)."""
    from seqalib_tpu_torch.ops import strip as strip_mod

    q, t, shift = FAULT_8[case]
    s = 1 << shift
    sp = ScoringParams(match=2 * s, mismatch=-3 * s, gap_open=-5 * s, gap_extend=-2 * s)
    calls = []

    def spy(*a, **kw):
        calls.append((a, kw))
        return band_fill(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(strip_mod, "band_fill", spy)
        got = align_batch([q], [t], scoring=scoring_params(sp.match, sp.mismatch, sp.gap_open,
                                                          sp.gap_extend, None),
                          mode="local", traceback=traceback, device=dev)[0]
    assert calls
    for a, kw in calls:
        _same(band_fill(*a, **kw), band_fill_ref(*a, **kw))
    want = oracle_fast.align_oracle(q, t, sp, mode="local")
    assert (str(got) == str(want) if traceback else
            got.score == want.score and (got.query_start, got.query_end) ==
            (want.query_start, want.query_end))


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_band_walk_kernel_matches_plain_version(dev, scoring):
    c = _band_bucket(dev, scoring, seed=3)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    state = [as_t(c["qlen"]), as_t(c["tlen"]), as_t(np.zeros(len(c["qlen"]))),
             as_t(np.zeros(len(c["qlen"])))]
    NC = c["ckpt"].shape[0]
    for cg in (NC - 2, NC - 4):  # two super-blocks of two chunks, high k first
        ptr = band_fill_ref(*c["args"], c["ckpt"][cg], c["score"], c["tab"],
                            k0=cg * c["CK"], k1=(cg + 2) * c["CK"], mode="ptr",
                            **c["kw"])["ptr"]
        before = launches["band_walk"]
        got = band_walk(ptr, *state, k0=cg * c["CK"], dhi=c["dhi"])
        torch.cuda.synchronize()
        assert launches["band_walk"] == before + 1
        want = band_walk_ref(ptr, *state, k0=cg * c["CK"], dhi=c["dhi"])
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)
        state = list(got[1:])


@pytest.mark.parametrize("Wp", WPS)
@pytest.mark.parametrize("Wb", [384, 7])  # 7 < dhi: the stream index clamps
@pytest.mark.parametrize("scoring", sorted(SCORINGS))
@pytest.mark.parametrize("mode", ["fill", "ptr"])
def test_band_fill_relay_kernel_matches_plain_version(dev, scoring, mode, Wb, Wp):
    """A block resumed from a boundary row (bh/bf) with the capture of row
    60: real, 0 (no slot holds the row) and NEG_INF capture columns."""
    c = _band_bucket(dev, scoring, seed=4, Wp=Wp)
    B = c["score"].shape[0]
    rng = np.random.default_rng(Wb)
    bh = torch.as_tensor(-5 - 2 * np.arange(Wb) + rng.integers(-6, 7, size=(B, Wb)),
                         dtype=torch.int32, device=dev)
    bh[:, 20:] = NEG_INF
    bf = (bh - 3).clamp(min=NEG_INF)
    call = dict(k0=0, k1=c["Kp"], mode=mode, bh=bh, bf=bf, want_bout=True, bout_row=60,
                **c["kw"])
    key = "band_fill/relay" if mode == "fill" else "band_fill/relay_ptr"
    before = launches[key]
    got = band_fill(*c["args"], c["state"], c["score"], c["tab"], **call)
    torch.cuda.synchronize()
    assert launches[key] == before + 1
    want = band_fill_ref(*c["args"], c["state"], c["score"], c["tab"], **call)
    _same(got, want)
    bout = want["bout"]
    assert (bout == 0).any() and (bout == NEG_INF).any() and (bout > NEG_INF // 2).any()


@pytest.mark.parametrize("i_floor", [0, 40])
@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_band_walk_floor_kernel_matches_plain_version(dev, scoring, i_floor):
    c = _band_bucket(dev, scoring, seed=3)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    state = [as_t(c["qlen"]), as_t(c["tlen"]), as_t(np.zeros(len(c["qlen"]))),
             as_t(np.zeros(len(c["qlen"])))]
    NC = c["ckpt"].shape[0]
    for cg in range((NC - 1) // 2 * 2, -1, -2):  # super-blocks of two chunks, high k first
        ptr = band_fill_ref(*c["args"], c["ckpt"][cg], c["score"], c["tab"],
                            k0=cg * c["CK"], k1=min(cg + 2, NC) * c["CK"], mode="ptr",
                            **c["kw"])["ptr"]
        before = launches["band_walk/floor"]
        got = band_walk(ptr, *state, k0=cg * c["CK"], dhi=c["dhi"], i_floor=i_floor)
        torch.cuda.synchronize()
        assert launches["band_walk/floor"] == before + 1
        want = band_walk_ref(ptr, *state, k0=cg * c["CK"], dhi=c["dhi"], i_floor=i_floor)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)
        state = list(got[1:])
    live = torch.as_tensor(c["qlen"] > i_floor, device=dev)
    assert bool((state[0][live] == i_floor).all())  # every walker stopped on the floor


@pytest.mark.parametrize("scoring", ["dna_affine", "blosum62_affine"])
def test_banded_sp_on_cuda_matches_oracle(dev, scoring):
    """align_banded_sp / align_score_banded_sp on meshes of 1 and 3
    entries naming the card, against the banded oracle."""
    from seqalib_tpu.oracle import nw_affine
    from seqalib_tpu_torch import align_banded_sp, align_score_banded_sp

    sp, alpha = SCORINGS[scoring]
    psp = scoring_params(sp.match, sp.mismatch, sp.gap_open, sp.gap_extend, sp.matrix)
    rng = np.random.default_rng(13)
    qs = [rng.integers(0, alpha, size=L).astype(np.int32) for L in (700, 520, 0, 611)]
    ts = [np.concatenate([q[6:], rng.integers(0, alpha, size=9)]).astype(np.int32)
          for q in qs]
    want = [nw_affine(q, t, sp, band=24) for q, t in zip(qs, ts)]
    for D in (1, 3):
        got = align_banded_sp(qs, ts, psp, 24, (dev,) * D, CK=128)
        assert [str(r) for r in got] == [str(w) for w in want]
        scores = align_score_banded_sp(qs, ts, psp, 24, (dev,) * D)
        assert scores == [w.score for w in want]


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_banded_align_batch_on_cuda_matches_oracle(dev, scoring):
    sp, alpha = SCORINGS[scoring]
    psp = scoring_params(sp.match, sp.mismatch, sp.gap_open, sp.gap_extend, sp.matrix)
    rng = np.random.default_rng(11)
    qs = [rng.integers(0, alpha, size=rng.integers(0, 400)).astype(np.uint8)
          for _ in range(16)]
    ts = [np.concatenate([q[5:], rng.integers(0, alpha, size=rng.integers(0, 30))])
          .astype(np.uint8) for q in qs]
    got = align_batch(qs, ts, scoring=psp, mode="global", band=16, device=dev)
    for q, t, r in zip(qs, ts, got):
        assert str(r) == str(oracle_fast.align_oracle(q, t, sp, mode="global", band=16))


def _tile_args(dev, scoring, R=400, C=96, seed=4):
    """One SP tile's letters and random boundaries; (n, m) inside it."""
    sp, alpha = SCORINGS[scoring]
    rng = np.random.default_rng(seed)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    qb = rng.integers(0, alpha, R)
    tk = rng.integers(0, alpha, C + 1)
    tk[1: C // 2] = qb[5: 4 + C // 2]
    htop = np.abs(rng.integers(-60, 40, C + 1))
    hcol = np.abs(rng.integers(-60, 40, R))
    args = [as_t(qb), as_t(tk), as_t(htop), as_t(htop[1:] - 3), as_t(hcol),
            as_t(hcol - 5), as_t([SP_NEG]),
            as_t(sp.substitution_matrix()) if sp.matrix is not None else None]
    kw = dict(i0=300, j0=64, n=300 + R - 7, m=64 + C - 2, C=C, match=sp.match,
              mismatch=sp.mismatch, gap_open=sp.gap_open, gap_extend=sp.gap_extend)
    return args, kw


@pytest.mark.parametrize("C", [96, 53])
@pytest.mark.parametrize("strip", [0, 128, 256])
@pytest.mark.parametrize("scoring", ["dna_affine", "blosum62_affine"])
@pytest.mark.parametrize("mode", ["global", "local", "ptr"])
def test_sp_tile_kernel_matches_plain_version(dev, mode, scoring, strip, C):
    # strips of 128 rows: three full strips and a ragged one of 16 rows;
    # C = 53: the pointer tile's rows fold modulo a C that divides no strip
    args, kw = _tile_args(dev, scoring, C=C)
    before = launches[f"sp_tile/{mode}"]
    got = sp_tile(*args, mode=mode, strip=strip, **kw)
    torch.cuda.synchronize()
    assert launches[f"sp_tile/{mode}"] == before + 1
    _same(got, sp_tile_ref(*args, mode=mode, **kw))


def _wavefront_args(dev, scoring, B=9, seed=5):
    sp = scoring_params(0, 0, -20, -2, 2 * BLOSUM62) if scoring == "profile" else \
        scoring_params(0, 0, -5, -2, np.where(np.eye(4, dtype=bool), 20, -20))
    alpha = 20 if scoring == "profile" else 4
    rng = np.random.default_rng(seed)
    qlen = rng.integers(0, 300, size=B)
    tlen = np.clip(qlen + rng.integers(-9, 10, size=B), 0, None)
    q = rng.integers(0, alpha, size=(B, 320))
    t = rng.integers(0, alpha, size=(B, 320))
    t[:, 10:200] = q[:, 12:202]
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, sp)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    args = [as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab)]
    return args, dict(K=tk.shape[1], band=12, gap_open=sp.gap_open,
                      gap_extend=sp.gap_extend)


@pytest.mark.parametrize("rows_in", ["shared", "global"])
@pytest.mark.parametrize("scoring", ["profile", "scalar"])
@pytest.mark.parametrize("want_ptr", [True, False])
def test_wavefront_fill_kernel_matches_plain_version(dev, want_ptr, scoring, rows_in,
                                                     monkeypatch):
    if rows_in == "global":  # the window's ring in the global scratch buffer
        monkeypatch.setattr(wf_mod, "SMEM_BYTES", 0)
    args, kw = _wavefront_args(dev, scoring)
    key = "wavefront_fill/" + ("ptr" if want_ptr else "score")
    before = launches[key]
    got = wavefront_fill(*args, want_ptr=want_ptr, **kw)
    torch.cuda.synchronize()
    assert launches[key] == before + 1
    _same(got, wavefront_fill_ref(*args, want_ptr=want_ptr, **kw))


WF_EDGES = {  # name -> (B, n, band, delta): pairs of n letters, tlen = qlen + delta
    "delta_above_band": (5, 200, 4, 37),
    "delta_below_band": (5, 200, 4, -37),
    "band_0": (6, 150, 0, 3),
    "band_over_slots": (3, 120, 500, 9),
    "slots_over_1024": (2, 1100, 40, 60),
    "one_pair": (1, 300, 12, -5),
}


@pytest.mark.parametrize("rows_in", ["shared", "global"])
@pytest.mark.parametrize("want_ptr", [True, False])
@pytest.mark.parametrize("case", sorted(WF_EDGES))
def test_wavefront_fill_kernel_matches_plain_version_at_the_edges(dev, case, want_ptr,
                                                                   rows_in, monkeypatch):
    B, n, band, delta = WF_EDGES[case]
    if rows_in == "global":
        monkeypatch.setattr(wf_mod, "SMEM_BYTES", 0)
    sp = scoring_params(0, 0, -20, -2, 2 * BLOSUM62)
    rng = np.random.default_rng(len(case))
    qlen = rng.integers(n // 2, n + 1, size=B)
    qlen[0] = n if delta < 0 else n - delta
    tlen = np.clip(qlen + delta + rng.integers(-2, 3, size=B), 0, n)
    q = rng.integers(0, 20, size=(B, n))
    t = rng.integers(0, 20, size=(B, n))
    t[:, 10: n // 2] = q[:, 12: n // 2 + 2]
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, sp)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    args = [as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab)]
    kw = dict(K=tk.shape[1], band=band, gap_open=sp.gap_open, gap_extend=sp.gap_extend,
              want_ptr=want_ptr)
    if case == "band_over_slots":
        assert band >= qpad.shape[1]
    if case == "slots_over_1024":
        assert qpad.shape[1] > 1024
    got = wavefront_fill(*args, **kw)
    torch.cuda.synchronize()
    _same(got, wavefront_fill_ref(*args, **kw))


def _walkable_stream(rng, n, m, B, Np, fill=None):
    """A (K, B, Np) pointer stream every affine walk from a cell of the
    (n + 1) x (m + 1) matrix leaves at (0, 0): row 0 points left, column 0
    up, (0, 0) is STOP, the E bit cleared in column 1 and the F bit in row
    1; the interior random bytes, or ``fill``'s pointer with random extend
    bits (a straight walk across the staged tiles)."""
    K = n + m + 1
    P = rng.integers(0, 16, size=(K, B, Np))
    # an interior STOP ends a walk: keep 1 in 100 so that walks are long
    P = np.where((P & 3 == 0) & (rng.random(P.shape) > 0.04), P | PTR_DIAG, P)
    if fill is not None:
        P = (P & 12) | fill
    k = np.arange(K)[:, None, None]
    i = np.arange(Np)[None, None, :]
    j = k - i
    ph = np.where(i == 0, PTR_LEFT, np.where(j == 0, PTR_UP, P & 3))
    ph = np.where((i == 0) & (j == 0), 0, ph)
    ext = P & 12
    ext = np.where(j == 1, ext & ~4, ext)
    ext = np.where(i == 1, ext & ~8, ext)
    return (ph | ext).astype(np.uint8)


def _same_walk_text(got, want):
    torch.cuda.synchronize()
    text, nchar, state = got
    assert torch.equal(nchar, want[1]) and torch.equal(state, want[2])
    assert sw_mod.cigars_from_text(text, nchar.cpu()) == sw_mod.cigars_from_text(
        want[0], want[1].cpu())


WALK_STREAMS = {  # name -> (n, m, B, Np, interior pointer or None)
    "random": (300, 320, 37, 304, None),
    "random_wide_slots": (90, 700, 9, 512, None),
    "diagonal": (400, 410, 5, 416, PTR_DIAG),
    "up": (250, 30, 5, 256, PTR_UP),
    "left": (30, 600, 5, 32, PTR_LEFT),
}


@pytest.mark.parametrize("name", sorted(WALK_STREAMS))
def test_wavefront_walk_kernel_matches_plain_version(dev, name):
    n, m, B, Np, fill = WALK_STREAMS[name]
    rng = np.random.default_rng(len(name))
    P = torch.as_tensor(_walkable_stream(rng, n, m, B, Np, fill), device=dev)
    i = rng.integers(0, n + 1, size=B)
    j = rng.integers(0, m + 1, size=B)
    i[0], j[0] = n, m
    i[1], j[1] = 0, m  # row 0 alone
    i[2], j[2] = n, 0  # column 0 alone
    if B > 3:
        i[3], j[3] = 0, 0
    args = (P, torch.as_tensor(i, dtype=torch.int32, device=dev),
            torch.as_tensor(j, dtype=torch.int32, device=dev))
    before = launches["wavefront_walk"]
    got = wavefront_walk(*args)
    assert launches["wavefront_walk"] == before + 1
    _same_walk_text(got, wavefront_walk_ref(*args))


def _wide_stream(dev, B, n, band, lens, seed=7):
    """The fill's pointer stream on the card for B protein pairs of up to
    n letters (2 x BLOSUM62, o=-20, e=-2), the targets the queries with
    substitutions and a 3-letter deletion, and the lengths."""
    sp = scoring_params(0, 0, -20, -2, 2 * BLOSUM62)
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, size=(B, n))
    t = np.concatenate([np.delete(q, [40, 41, 42], axis=1), rng.integers(0, 20, (B, 3))], 1)
    t[:, ::19] = rng.integers(0, 20, size=t[:, ::19].shape)
    qlen, tlen = lens
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, sp)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    ptr = wavefront_fill(as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab),
                         K=tk.shape[1], band=band, gap_open=-20, gap_extend=-2,
                         want_ptr=True)["ptr"]
    return ptr, as_t(qlen), as_t(tlen)


@pytest.mark.parametrize("case", ["phase7_cut", "edges"])
def test_wavefront_walk_kernel_on_the_fills_streams(dev, case):
    """Phase 7's shapes cut in batch (8 pairs of 1 000 letters, band 64),
    and the edges: qlen 0, tlen 0, both, and a query whose last letter
    sits in the stream's last slot (n = 127, Np = 128)."""
    if case == "phase7_cut":
        B, n, band = 8, 1000, 64
        lens = (np.full(B, n), np.full(B, n))
    else:
        B, n, band = 5, 127, 8
        lens = (np.array([127, 0, 60, 0, 127]), np.array([127, 50, 0, 0, 120]))
    ptr, ql, tl = _wide_stream(dev, B, n, band, lens)
    if case == "edges":
        assert ptr.shape[2] == 128
    before = launches["wavefront_walk"]
    got = wavefront_walk(ptr, ql, tl)
    assert launches["wavefront_walk"] == before + 1
    want = wavefront_walk_ref(ptr, ql, tl)
    _same_walk_text(got, want)
    assert (want[2][3] == 1).all()  # every walk reached (0, 0)


def test_wavefront_walk_makes_one_launch_and_no_sync(dev):
    """Under the sync debug mode a device-to-host transfer raises; a call
    counts one launch.  (The device-side count of kernels is
    ``chip_smoke.py``'s profile of the walk: a second ``torch.profiler``
    session in one test process has shown no device events.)"""
    rng = np.random.default_rng(9)
    P = torch.as_tensor(_walkable_stream(rng, 200, 200, 16, 208), device=dev)
    i = torch.full((16,), 200, dtype=torch.int32, device=dev)
    before = launches["wavefront_walk"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = wavefront_walk(P, i, i)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert launches["wavefront_walk"] == before + 1
    _same_walk_text(got, wavefront_walk_ref(P, i, i))


def test_wavefront_walk_defers_its_range_check_and_refuses_unaligned_streams(dev):
    rng = np.random.default_rng(10)
    P = torch.as_tensor(_walkable_stream(rng, 40, 40, 3, 48), device=dev)
    K, _, Np = P.shape
    i = torch.tensor([40, Np, 3], dtype=torch.int32, device=dev)
    j = torch.tensor([40, 0, K - 3], dtype=torch.int32, device=dev)
    got = wavefront_walk(P, i, j)
    want = wavefront_walk_ref(P, i, j)
    assert got[1].tolist() == want[1].tolist() and got[1][1] == sw_mod.BAD_START
    assert torch.equal(got[2], want[2])
    with pytest.raises(ValueError, match="pair 1's start cell lies outside P"):
        sw_mod.cigars_from_text(got[0], got[1].cpu())
    with pytest.raises(ValueError, match="16-byte aligned"):
        wavefront_walk(P[:, :, :40], i * 0, j * 0)


def _wide_bucket(rng, B=13, n=300):
    sp = scoring_params(0, 0, -20, -2, 2 * BLOSUM62)
    q = rng.integers(0, 20, size=(B, n)).astype(np.int32)
    t = np.concatenate([q[:, 2:], rng.integers(0, 20, size=(B, 9))], 1).astype(np.int32)
    t[:, ::13] = rng.integers(0, 20, size=t[:, ::13].shape)
    qlen = rng.integers(0, n + 1, size=B)
    tlen = np.clip(qlen + rng.integers(-20, 21, size=B), 0, t.shape[1])
    return q, t, qlen, tlen, sp


@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("traceback", [True, False])
def test_wavefront_launch_makes_no_sync(dev, traceback, mesh):
    """The wide-table route's launch half (``run_bucket(band=,
    launch_only=True)``: the letters' one copy, the fill, the walk and the
    results' host copy), alone or as 4 shards on a mesh naming the card,
    makes no device-to-host sync; the finalize equals the CPU's, and the
    walk launched once per bucket or shard."""
    from seqalib_tpu_torch.parallel import dispatch

    q, t, qlen, tlen, sp = _wide_bucket(np.random.default_rng(44))
    args = (q, t, qlen, tlen, sp, "global", 24, traceback)
    want = dispatch.run_bucket(*args, torch.device("cpu"))
    dispatch.run_bucket(*args, dev)  # the build and the allocators' first blocks
    kw = dict(mesh=[dev] * 4) if mesh else {}
    before = launches["wavefront_walk"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finish = dispatch.run_bucket(*args, None if mesh else dev, launch_only=True, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = finish()
    assert launches["wavefront_walk"] - before == (4 if mesh else 1) * traceback
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "cigars":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_wide_table_route_on_a_mesh_of_4_equals_mesh_none(dev):
    """``align_batch`` on the wide-table route, sharded over a mesh of 4
    entries naming the card (``dist.wavefront_sharded``), equals
    ``mesh=None`` and, for a sample, the oracle."""
    q, t, qlen, tlen, sp = _wide_bucket(np.random.default_rng(45), B=11)
    qs = [q[b, : qlen[b]].astype(np.uint8) for b in range(len(qlen))]
    ts = [t[b, : tlen[b]].astype(np.uint8) for b in range(len(tlen))]
    jsp = ScoringParams(gap_open=-20, gap_extend=-2, matrix=2 * BLOSUM62)
    for tb in (False, True):
        want = align_batch(qs, ts, scoring=sp, mode="global", band=24, traceback=tb,
                           device=dev)
        got = align_batch(qs, ts, scoring=sp, mode="global", band=24, traceback=tb,
                          mesh=[dev] * 4)
        assert [str(r) for r in got] == [str(r) for r in want]
    for b in range(3):
        assert str(got[b]) == str(oracle_fast.align_oracle(qs[b], ts[b], jsp, mode="global",
                                                           band=24))


STRIP_QLENS = (1, 31, 32, 33, 255, 257, 1029)
STRIP_TLENS = (0, 5, 31, 300)


@pytest.mark.parametrize("B", [1, 7, 64])
@pytest.mark.parametrize("scoring", ["dna_linear", "blosum62_affine"])
@pytest.mark.parametrize("mode,want_ptr", [("local", False), ("local", True),
                                           ("emode", False), ("gmode", False),
                                           ("gmode", True)])
def test_strip_fill_kernel_matches_plain_version_at_ragged_lengths(dev, scoring, mode,
                                                                   want_ptr, B, monkeypatch):
    """Query lengths around the 32-row strips and the warps' rounds, short
    and empty targets, every warp count the kernel takes (``strip_warps``
    patched: the wrapper picks 8 at these widths)."""
    sp, alpha = SCORINGS[scoring]
    tables = tables_from_params(sp, dev)
    rng = np.random.default_rng(B)
    n, m = max(STRIP_QLENS), max(STRIP_TLENS)
    q = rng.integers(0, alpha, size=(B, n))
    t = rng.integers(0, alpha, size=(B, m))
    t[:, 20:200] = q[:, 30:210]
    qlen = np.array([STRIP_QLENS[b % 7] for b in range(B)])
    tlen = np.array([STRIP_TLENS[b % 4] for b in range(B)])
    if B == 1:
        qlen[0], tlen[0] = n, m
    qpad, t2 = prep_strip(q, t, qlen, tlen, alpha + 1, dev)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)
    ql, tl = as_t(qlen), as_t(tlen)
    want = strip_fill_ref(qpad, t2, ql, tl, tables, mq=m, mode=mode, want_ptr=want_ptr)
    for warps in range(1, sf_mod.MAX_WARPS + 1):
        monkeypatch.setattr(sf_mod, "strip_warps", lambda nq, w=warps: w)
        got = strip_fill(qpad, t2, ql, tl, tables, mq=m, mode=mode, want_ptr=want_ptr)
        torch.cuda.synchronize()
        for k in want:
            assert torch.equal(got[k], want[k]), (warps, k)


def test_strip_fill_kernel_with_global_letters_and_row(dev, monkeypatch):
    """Targets too wide for the shared-memory budget: the letters and the
    wrap row in global memory."""
    monkeypatch.setattr(sf_mod, "SMEM_BUDGET", 0)
    sp, alpha = SCORINGS["blosum62_affine"]
    tables = tables_from_params(sp, dev)
    qpad, t2, ql, tl, m = _batch(alpha, dev, B=9, n=300, m=600, seed=4)
    for mode, want_ptr in (("local", True), ("emode", False), ("gmode", True)):
        want = strip_fill_ref(qpad, t2, ql, tl, tables, mq=m, mode=mode, want_ptr=want_ptr)
        for warps in (1, 3, 8):
            monkeypatch.setattr(sf_mod, "strip_warps", lambda nq, w=warps: w)
            got = strip_fill(qpad, t2, ql, tl, tables, mq=m, mode=mode,
                             want_ptr=want_ptr)
            torch.cuda.synchronize()
            _same(got, want)


@pytest.mark.parametrize("D", [1, 3])
def test_sp_paths_on_cuda_match_oracle(dev, D):
    from seqalib_tpu.oracle import nw_affine, sw_affine

    sp, _ = SCORINGS["dna_affine"]
    psp = scoring_params(sp.match, sp.mismatch, sp.gap_open, sp.gap_extend, sp.matrix)
    rng = np.random.default_rng(D)
    q = rng.integers(0, 4, 700).astype(np.int32)
    t = np.delete(q, np.arange(100, 140))
    t[::37] = (t[::37] + 1) % 4
    mesh = (dev,) * D
    from seqalib_tpu_torch import align_score_sp, align_sp

    assert str(align_sp(q, t, psp, mesh, C=128)) == str(nw_affine(q, t, sp))
    assert align_score_sp(q, t, psp, mesh, C=96, sp_sub=1) == nw_affine(q, t, sp).score
    assert align_score_sp(q, t, psp, mesh, mode="local") == sw_affine(q, t, sp).score


def test_wide_table_align_batch_on_cuda_matches_oracle(dev):
    wide = np.where(np.eye(4, dtype=bool), 20, -20).astype(np.int32)
    sp = ScoringParams(gap_open=-5, gap_extend=-2, matrix=wide)
    psp = scoring_params(0, 0, -5, -2, wide)
    rng = np.random.default_rng(12)
    qs = [rng.integers(0, 4, size=rng.integers(0, 400)).astype(np.uint8) for _ in range(12)]
    ts = [np.concatenate([q[4:], rng.integers(0, 4, size=rng.integers(0, 20))])
          .astype(np.uint8) for q in qs]
    got = align_batch(qs, ts, scoring=psp, mode="global", band=24, device=dev)
    for q, t, r in zip(qs, ts, got):
        assert str(r) == str(oracle_fast.align_oracle(q, t, sp, mode="global", band=24))


# the wide variant of band_fill (Wp > 8192): slot rows past the geometry's
# (junk slots, held all the same), and a band that fills them
WIDE_WPS = [8320, 16384]


@pytest.mark.parametrize("Wp", WIDE_WPS + [None])
@pytest.mark.parametrize("scoring", ["dna_affine", "blosum62_affine"])
@pytest.mark.parametrize("mode", ["fill", "ptr", "emode", "relay", "relay_ptr"])
def test_band_fill_wide_kernel_matches_plain_version(dev, scoring, mode, Wp):
    """Every mode of the wide variant; Wp None: a band of 8 300 (Wp 8 448
    from the geometry) over pairs of up to 600 letters."""
    c = _band_bucket(dev, scoring, B=9, band=8300 if Wp is None else 64, Wp=Wp, qmax=600)
    B, Wp = c["score"].shape
    assert Wp > 8192
    kw = dict(c["kw"])
    state = c["state"]
    if mode == "fill":
        call = dict(k0=0, k1=c["Kp"], mode="fill", CK=c["CK"])
    elif mode == "ptr":
        cg = c["ckpt"].shape[0] // 2
        call = dict(k0=cg * c["CK"], k1=c["Kp"], mode="ptr")
        state = c["ckpt"][cg]
    elif mode == "emode":
        state = torch.cat([state, c["score"][None],
                           torch.zeros((1, B, Wp), dtype=torch.int32, device=dev)])
        call = dict(k0=0, k1=c["Kp"], mode="emode", tie_safe=True, smax=11)
    else:
        rng = np.random.default_rng(Wp)
        bh = torch.as_tensor(-5 - 2 * np.arange(384) + rng.integers(-6, 7, size=(B, 384)),
                             dtype=torch.int32, device=dev)
        call = dict(k0=0, k1=c["Kp"], mode="fill" if mode == "relay" else "ptr", bh=bh,
                    bf=bh - 3, want_bout=True, bout_row=60)
    key = "band_fill/wide" + {"fill": "", "relay": "", "emode": "_emode"}.get(mode, "_ptr")
    before = launches[key]
    got = band_fill(*c["args"], state, c["score"], c["tab"], **call, **kw)
    torch.cuda.synchronize()
    assert launches[key] == before + 1
    _same(got, band_fill_ref(*c["args"], state, c["score"], c["tab"], **call, **kw))


def test_config4_pair_with_a_delta_of_17000_aligns_on_cuda(dev):
    """A 10 kb read against a 27 kb window at band 128: Wp 8 704, the wide
    variant in fill and pointer modes; the CIGAR consumes the pair,
    re-scores to the score, which the SP fill gives as well."""
    from seqalib_tpu_torch import align_score_sp

    sp = scoring_params(2, -3, -5, -2, None)
    rng = np.random.default_rng(17)
    t = rng.integers(0, 4, 27_000).astype(np.uint8)
    q = t[8_000:18_000].copy()
    idx = rng.choice(len(q), 200, replace=False)
    q[idx] = (q[idx] + 1) % 4
    before = launches["band_fill/wide"], launches["band_fill/wide_ptr"]
    r = align_batch([q], [t], scoring=sp, mode="global", band=128, device=dev)[0]
    assert launches["band_fill/wide"] > before[0]
    assert launches["band_fill/wide_ptr"] > before[1]
    i = j = score = 0
    for n, op in _runs(r.cigar):
        if op == "M":
            score += int(np.where(q[i: i + n] == t[j: j + n], 2, -3).sum())
            i, j = i + n, j + n
        else:
            score += -5 - 2 * n
            i, j = (i + n, j) if op == "I" else (i, j + n)
    assert (i, j) == (len(q), len(t)) and score == r.score
    assert r.score == align_score_sp(q.astype(np.int32), t.astype(np.int32), sp, (dev,),
                                     C=256)


def _runs(cigar):
    import re

    return [(int(n), op) for n, op in re.findall(r"(\d+)([MID])", cigar)]


def _run_args(dev, scoring, R, W, C, seed=6):
    """A run's (or a pointer batch's) letters and random boundaries."""
    sp, alpha = SCORINGS[scoring]
    rng = np.random.default_rng(seed)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    qb = rng.integers(0, alpha, R)
    tk = rng.integers(0, alpha, W + 1)
    n = min(W, R) // 2
    tk[1: n] = qb[3: n + 2]
    htop = np.abs(rng.integers(-60, 40, W + 1))
    hcol = np.abs(rng.integers(-60, 40, R))
    tab = as_t(sp.substitution_matrix()) if sp.matrix is not None else None
    kw = dict(match=sp.match, mismatch=sp.mismatch, gap_open=sp.gap_open,
              gap_extend=sp.gap_extend)
    return qb, tk, htop, hcol, tab, kw, as_t


# (R, T, C, strip): ragged last strips, R under one strip, one tile
RUN_SHAPES = [(400, 3, 96, 0), (400, 3, 53, 128), (1000, 5, 64, 256), (37, 2, 40, 0),
              (300, 1, 96, 64), (2100, 4, 128, 32)]


@pytest.mark.parametrize("shape", RUN_SHAPES)
@pytest.mark.parametrize("scoring", ["dna_affine", "blosum62_affine"])
@pytest.mark.parametrize("mode", ["global", "local"])
def test_sp_tile_run_kernel_matches_plain_version(dev, mode, scoring, shape):
    R, T, C, strip = shape
    W = T * C
    qb, tk, htop, hcol, tab, kw, as_t = _run_args(dev, scoring, R, W, C)
    args = [as_t(qb), as_t(tk), as_t(htop), as_t(htop[1:] - 3), as_t(hcol),
            as_t(hcol - 5), as_t([SP_NEG]), tab]
    # (n, m) inside the last tile, short of its right column: a ragged tile
    kw.update(i0=300, j0=64, n=300 + R - 7, m=64 + W - C // 3, C=C, mode=mode)
    key = f"sp_tile/{mode}" if T == 1 else f"sp_tile/run_{mode}"
    for want_cols in (True, False):
        before = launches[key]
        got = sp_tile_run(*args, strip=strip, want_cols=want_cols, **kw)
        torch.cuda.synchronize()
        assert launches[key] == before + 1
        _same(got, sp_tile_run_ref(*args, want_cols=want_cols, **kw))


# (rows, K, C, strip)
PTR_SHAPES = [(400, 3, 96, 0), (250, 4, 53, 64), (1000, 2, 128, 256), (33, 1, 40, 0),
              (700, 6, 64, 32)]


@pytest.mark.parametrize("shape", PTR_SHAPES)
@pytest.mark.parametrize("scoring", ["dna_affine", "blosum62_affine"])
def test_sp_tile_ptr_kernel_matches_plain_version(dev, scoring, shape):
    rows, K, C, strip = shape
    qb, tk, _, _, tab, kw, as_t = _run_args(dev, scoring, rows, K * C, C, seed=8)
    rng = np.random.default_rng(K)
    htop = np.abs(rng.integers(-60, 40, (K, C + 1)))
    hcol = np.abs(rng.integers(-60, 40, (K, rows)))
    args = [as_t(qb), as_t(tk), as_t(htop), as_t(htop[:, 1:] - 3), as_t(hcol),
            as_t(hcol - 5), as_t([SP_NEG]), tab]
    kw.update(i0=300, j0=64 + (K - 1) * C, n=0, m=0, C=C)
    key = "sp_tile/ptr" if K == 1 else "sp_tile/ptr_batch"
    before = launches[key]
    got = sp_tile_ptr(*args, strip=strip, **kw)
    torch.cuda.synchronize()
    assert launches[key] == before + 1
    want = sp_tile_ptr_ref(*args, **kw)
    _same(got, want)
    assert len(np.unique(want["ptr"].cpu().numpy() & 3)) == 3  # diag, up and left


@pytest.mark.parametrize("band", [9, 600])  # Wp 128 and 640: the walk's staged window moves
@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_band_walk_kernel_matches_plain_version_across_windows(dev, scoring, band):
    c = _band_bucket(dev, scoring, seed=5, band=band, qmax=900, CK=64)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    state = [as_t(c["qlen"]), as_t(c["tlen"]), as_t(np.zeros(len(c["qlen"]))),
             as_t(np.zeros(len(c["qlen"])))]
    NC = c["ckpt"].shape[0]
    for cg in range((NC - 1) // 3 * 3, -1, -3):  # super-blocks of three chunks
        ptr = band_fill_ref(*c["args"], c["ckpt"][cg], c["score"], c["tab"],
                            k0=cg * c["CK"], k1=min(cg + 3, NC) * c["CK"], mode="ptr",
                            **c["kw"])["ptr"]
        got = band_walk(ptr, *state, k0=cg * c["CK"], dhi=c["dhi"])
        want = band_walk_ref(ptr, *state, k0=cg * c["CK"], dhi=c["dhi"])
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)
        state = list(got[1:])
    assert bool((state[0] == 0).all() and (state[1] == 0).all())  # every walk ends at (0, 0)


@pytest.mark.parametrize("i_floor", [-1, 0, 150])
def test_band_walk_with_one_live_pair_of_eight(dev, i_floor):
    """Banded SP's relay group: one pair walks, seven are done; the done
    ones keep their state and get no op."""
    c = _band_bucket(dev, "dna_affine", B=8, seed=9, band=40, qmax=600, CK=64)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    live = int(np.argmax(c["qlen"]))
    done = np.ones(8)
    done[live] = 0
    state = [as_t(c["qlen"]), as_t(c["tlen"]), as_t(np.zeros(8)), as_t(done)]
    NC = c["ckpt"].shape[0]
    for cg in range((NC - 1) // 2 * 2, -1, -2):
        ptr = band_fill_ref(*c["args"], c["ckpt"][cg], c["score"], c["tab"],
                            k0=cg * c["CK"], k1=min(cg + 2, NC) * c["CK"], mode="ptr",
                            **c["kw"])["ptr"]
        before = launches["band_walk/floor" if i_floor >= 0 else "band_walk"]
        got = band_walk(ptr, *state, k0=cg * c["CK"], dhi=c["dhi"], i_floor=i_floor)
        torch.cuda.synchronize()
        assert launches["band_walk/floor" if i_floor >= 0 else "band_walk"] == before + 1
        want = band_walk_ref(ptr, *state, k0=cg * c["CK"], dhi=c["dhi"], i_floor=i_floor)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)
        assert bool((got[0][torch.arange(8, device=dev) != live] == 255).all())
        state = list(got[1:])
    assert int(state[0][live]) == max(i_floor, 0)


def test_kernels_launch_on_their_tensors_device():
    """With cuda:0 current, every path on cuda:1 launches there (each
    wrapper makes its tensors' device current for the launch) and leaves
    cuda:0 current."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a launch for cuda:1 while cuda:0 is current")
    from seqalib_tpu.oracle import nw_affine
    from seqalib_tpu_torch import align_score_banded_sp, align_score_sp, align_sp

    one = torch.device("cuda:1")
    torch.cuda.set_device(0)
    sp, alpha = SCORINGS["blosum62_affine"]
    rng = np.random.default_rng(21)
    qs = [rng.integers(0, alpha, size=rng.integers(1, 300)).astype(np.uint8)
          for _ in range(12)]
    ts = [np.concatenate([q[3:], rng.integers(0, alpha, size=7)]).astype(np.uint8)
          for q in qs]
    for mode, band in (("local", None), ("global", None), ("global", 16)):
        got = align_batch(qs, ts, scoring=sp, mode=mode, band=band, device=one)
        for q, t, r in zip(qs, ts, got):
            assert str(r) == str(oracle_fast.align_oracle(q, t, sp, mode=mode, band=band))
    dna, _ = SCORINGS["dna_affine"]
    psp = scoring_params(dna.match, dna.mismatch, dna.gap_open, dna.gap_extend, None)
    q = rng.integers(0, 4, 600).astype(np.int32)
    t = np.delete(q, np.arange(50, 70))
    assert str(align_sp(q, t, psp, (one, one), C=128)) == str(nw_affine(q, t, dna))
    assert align_score_sp(q, t, psp, (one,)) == nw_affine(q, t, dna).score
    assert align_score_banded_sp([q], [t], psp, 40, (one,) * 2) == [
        nw_affine(q, t, dna, band=40).score]
    assert torch.cuda.current_device() == 0


def test_all_vs_all_on_cuda_equals_the_cpu(dev):
    """The chunked product on the card, several bucket pairs and tail
    chunks, equals the same call on the CPU (the plain versions)."""
    from seqalib_tpu_torch import align_all_vs_all

    rng = np.random.default_rng(31)
    reads = [rng.integers(0, 4, rng.integers(40, 200)).astype(np.uint8) for _ in range(24)]
    refs = [rng.integers(0, 4, rng.integers(100, 400)).astype(np.uint8) for _ in range(5)]
    sp = scoring_params(2, -3, 0, -2, None)
    want = align_all_vs_all(reads, refs, scoring=sp, chunk_pairs=40, device="cpu")
    got = align_all_vs_all(reads, refs, scoring=sp, chunk_pairs=40, device=dev)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("mode,traceback,pass2", [
    ("local", False, "banded"), ("local", False, "strip"), ("local", True, "banded"),
    ("global", True, "banded"), ("global", False, "banded")])
def test_strip_launch_makes_no_sync(dev, mode, traceback, pass2, monkeypatch):
    """The launch half of a bucket (``run_bucket(launch_only=True)``:
    letters, tables, every kernel and the results' host copy) enqueues all
    its work with no device-to-host sync; its finalize equals the CPU's."""
    from seqalib_tpu_torch.parallel.dispatch import run_bucket

    monkeypatch.setenv("SEQALIB_FUSED_PASS2", pass2)
    rng = np.random.default_rng(32)
    B = 64
    q = rng.integers(0, 4, size=(B, 256)).astype(np.int32)
    t = rng.integers(0, 4, size=(B, 1024)).astype(np.int32)
    t[:, 300:500] = q[:, 20:220]
    qlen, tlen = rng.integers(0, 257, size=B), rng.integers(0, 1025, size=B)
    args = (q, t, qlen, tlen, scoring_params(2, -3, -5, -2, None), mode, None, traceback)
    want = run_bucket(*args, torch.device("cpu"))
    run_bucket(*args, dev)  # the build and the allocators' first blocks
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finish = run_bucket(*args, dev, launch_only=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = finish()
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "cigars":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_strip_fill_defers_its_length_check(dev):
    """With ``err`` the fill records the first bad pair in the word and
    launches with the lengths clamped (no sync); the word raises later."""
    sp, alpha = SCORINGS["dna_affine"]
    tables = tables_from_params(sp, dev)
    q = torch.zeros((3, 40), dtype=torch.int32, device=dev)
    t2 = torch.zeros((3, 41), dtype=torch.int32, device=dev)
    qlen = torch.tensor([40, 41, 3], dtype=torch.int32, device=dev)
    tlen = torch.tensor([40, 5, 41], dtype=torch.int32, device=dev)
    err = error_words(1, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        strip_fill(q, t2, qlen, tlen, tables, mq=40, mode="local", err=err)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(err) == 1
    with pytest.raises(ValueError, match="a length exceeds its letter array"):
        sf_mod.raise_on_bad_length(err.cpu()[0])
    with pytest.raises(ValueError, match="a length exceeds its letter array"):
        strip_fill(q, t2, qlen, tlen, tables, mq=40, mode="local")


@pytest.mark.parametrize("mode,traceback", [("local", True), ("local", False),
                                            ("global", True)])
def test_sharded_launch_makes_no_sync(dev, mode, traceback):
    """Every shard of a bucket on a mesh of 4 entries naming the card is
    launched with no device-to-host sync (``dist.strip_sharded``); the
    finalize equals the unsharded bucket and the CPU's plain versions."""
    from seqalib_tpu_torch.parallel import dispatch

    sp, alpha = SCORINGS["blosum62_affine"]
    psp = scoring_params(sp.match, sp.mismatch, sp.gap_open, sp.gap_extend, sp.matrix)
    rng = np.random.default_rng(41)
    q = rng.integers(0, alpha, size=(13, 200)).astype(np.int32)
    t = rng.integers(0, alpha, size=(13, 230)).astype(np.int32)
    qlen, tlen = rng.integers(1, 201, 13), rng.integers(1, 231, 13)
    args = (q, t, qlen, tlen, psp, mode, None, traceback)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finish = dispatch.run_bucket(*args, None, launch_only=True, mesh=[dev] * 4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = finish()
    for want in (dispatch.run_bucket(*args, dev), dispatch.run_bucket(*args, "cpu")):
        for k in ("score", "qs", "qe", "ts", "te") + (("cigars",) if traceback else ()):
            if k == "cigars":
                assert got[k] == want[k]
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pair_mesh_over_two_cards():
    """A pair mesh over two cards: each shard on its own card, every result
    equal to the oracle, cuda:0 left current."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a pair mesh over distinct cards")
    from seqalib_tpu_torch import make_pair_mesh

    sp, alpha = SCORINGS["blosum62_affine"]
    rng = np.random.default_rng(43)
    qs = [rng.integers(0, alpha, size=rng.integers(1, 300)).astype(np.uint8)
          for _ in range(9)]
    ts = [np.concatenate([q[2:], rng.integers(0, alpha, size=5)]).astype(np.uint8)
          for q in qs]
    torch.cuda.set_device(0)
    mesh = make_pair_mesh(["cuda:0", "cuda:1"])
    for mode, band in (("local", None), ("global", None), ("global", 16)):
        got = align_batch(qs, ts, scoring=sp, mode=mode, band=band, mesh=mesh)
        for q, t, r in zip(qs, ts, got):
            assert str(r) == str(oracle_fast.align_oracle(q, t, sp, mode=mode, band=band))
    assert torch.cuda.current_device() == 0


# every mode of kernel 7: (mode, affine, want_ptr, band); band None is unbanded
WF_MODES = [(mode, affine, ptr, band) for mode in ("global", "local")
            for affine in (True, False) for ptr in (True, False) for band in (None, 12)]


def _mode_id(m):
    mode, affine, ptr, band = m
    return f"{mode}-{'affine' if affine else 'linear'}-{'ptr' if ptr else 'score'}-" \
           f"{'band' if band is not None else 'full'}"


@pytest.mark.parametrize("rows_in", ["shared", "global"])
@pytest.mark.parametrize("scoring", ["profile", "scalar"])
@pytest.mark.parametrize("wf_mode", WF_MODES, ids=_mode_id)
def test_wavefront_fill_every_mode_matches_plain_version(dev, wf_mode, scoring, rows_in,
                                                         monkeypatch):
    """Each mode of ``wavefront_fill`` (global or local, affine or linear,
    pointers or score-only, band or none) against its plain version, every
    output exactly, with the window's ring in shared and in global memory."""
    mode, affine, want_ptr, band = wf_mode
    if rows_in == "global":
        monkeypatch.setattr(wf_mod, "SMEM_BYTES", 0)
    args, kw = _wavefront_args(dev, scoring)
    kw.update(band=band, mode=mode, affine=affine, want_ptr=want_ptr, stride=321)
    key = wf_mod.launch_key(mode, affine, want_ptr)
    before = launches[key]
    got = wavefront_fill(*args, **kw)
    torch.cuda.synchronize()
    assert launches[key] == before + 1
    _same(got, wavefront_fill_ref(*args, **kw))


@pytest.mark.parametrize("wf_mode", [m for m in WF_MODES if m[3] is None], ids=_mode_id)
def test_wavefront_fill_unbanded_past_1024_slots_matches_plain_version(dev, wf_mode):
    """Unbanded fills over Np = 1 152 slots (config 3's bucket of 1 024
    letters): the window kernel's threads loop past 1 024 slots."""
    mode, affine, want_ptr, _ = wf_mode
    sp = ScoringParams.blosum62(gap_open=-10, gap_extend=-1)
    rng = np.random.default_rng(12)
    B, n = 3, 1024
    qlen = np.array([n, 700, 1000])
    tlen = np.array([n, 1024, 3])
    q = rng.integers(0, 20, size=(B, n))
    t = rng.integers(0, 20, size=(B, n))
    t[:, 100:500] = q[:, 90:490]
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, sp)
    assert qpad.shape[1] == 1152
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    args = [as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab)]
    kw = dict(K=tk.shape[1], band=None, gap_open=sp.gap_open, gap_extend=sp.gap_extend,
              want_ptr=want_ptr, mode=mode, affine=affine, stride=n + 1)
    got = wavefront_fill(*args, **kw)
    torch.cuda.synchronize()
    _same(got, wavefront_fill_ref(*args, **kw))


@pytest.mark.parametrize("scoring", ["dna_linear", "blosum62_affine"])
def test_wavefront_walk_linear_kernel_matches_plain_version(dev, scoring):
    """The linear walk (``affine=False``) on the streams of the linear
    global fill, and on random bytes whose extend bits it must ignore."""
    sp, alpha = SCORINGS[scoring]
    sp = scoring_params(sp.match, sp.mismatch, 0, -2, sp.matrix)
    rng = np.random.default_rng(31)
    B, n = 17, 200
    qlen = rng.integers(0, n + 1, size=B)
    tlen = rng.integers(0, n + 1, size=B)
    q = rng.integers(0, alpha, size=(B, n))
    t = rng.integers(0, alpha, size=(B, n))
    t[:, 5:150] = q[:, 8:153]
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, sp)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    ql, tl = as_t(qlen), as_t(tlen)
    ptr = wavefront_fill(as_t(qpad), as_t(tk), ql, tl, as_t(tab), K=tk.shape[1], band=None,
                         gap_open=0, gap_extend=-2, want_ptr=True, affine=False)["ptr"]
    noisy = ptr | torch.randint_like(ptr, 0, 4) << 2  # extend bits the walk ignores
    for P in (ptr, noisy):
        before = launches["wavefront_walk/linear"]
        got = wavefront_walk(P, ql, tl, affine=False)
        assert launches["wavefront_walk/linear"] == before + 1
        _same_walk_text(got, wavefront_walk_ref(P, ql, tl, affine=False))
    # the linear walk of the clean stream is the oracle's CIGAR
    text, nchar, _ = wavefront_walk(ptr, ql, tl, affine=False)
    cig = sw_mod.cigars_from_text(text, nchar)
    for b in range(4):
        want = oracle_fast.align_oracle(q[b, : qlen[b]].astype(np.uint8),
                                        t[b, : tlen[b]].astype(np.uint8),
                                        _jax_sp(sp), mode="global")
        assert cig[b] == want.cigar


def _jax_sp(sp):
    return ScoringParams(match=sp.match, mismatch=sp.mismatch, gap_open=sp.gap_open,
                         gap_extend=sp.gap_extend, matrix=sp.matrix)


@pytest.mark.parametrize("traceback", [True, False])
@pytest.mark.parametrize("mode", ["global", "local"])
@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_xla_route_on_cuda_matches_the_cpu_and_the_oracle(dev, scoring, mode, traceback):
    """``align_batch(backend="xla")`` on the card equals the CPU (the plain
    versions), and for traceback the oracle, an empty pair included."""
    sp, alpha = SCORINGS[scoring]
    rng = np.random.default_rng(8)
    qs = [rng.integers(0, alpha, int(L)).astype(np.uint8) for L in (90, 150, 0, 300, 31)]
    ts = [np.concatenate([rng.integers(0, alpha, 7), q[5:], rng.integers(0, alpha, 3)])
          .astype(np.uint8) for q in qs]
    kw = dict(scoring=sp, mode=mode, traceback=traceback, backend="xla")
    got = align_batch(qs, ts, device=dev, **kw)
    assert [str(r) for r in got] == [str(r) for r in align_batch(qs, ts, device="cpu", **kw)]
    if traceback:
        jsp = _jax_sp(sp)
        for q, t, g in zip(qs, ts, got):
            assert str(g) == str(oracle_fast.align_oracle(q, t, jsp, mode=mode))


@pytest.mark.parametrize("traceback", [True, False])
@pytest.mark.parametrize("mode", ["global", "local"])
def test_xla_route_launch_half_makes_no_sync(dev, mode, traceback):
    """The ``"xla"`` route's launch half (``run_bucket(backend="xla",
    launch_only=True)``) makes no device-to-host sync: the global fill and
    walk, or the local pass (a); the finalize equals the CPU's."""
    from seqalib_tpu_torch.parallel import dispatch

    q, t, qlen, tlen, _ = _wide_bucket(np.random.default_rng(46))
    sp = ScoringParams.blosum62(gap_open=-10, gap_extend=-1)
    args = (q, t, qlen, tlen, sp, mode, None, traceback)
    want = dispatch.run_bucket(*args, torch.device("cpu"), backend="xla")
    dispatch.run_bucket(*args, dev, backend="xla")  # the build, the allocators' blocks
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finish = dispatch.run_bucket(*args, dev, launch_only=True, backend="xla")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = finish()
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "cigars":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# the strip kernel (unbanded score-only fills): its four instances, as
# (mode, affine)
STRIP_INSTANCES = [("local", True), ("local", False), ("global", True), ("global", False)]
# name -> (query lengths, target lengths, letters' width n x m, K less than
# n + m + 1 by, warps forced or None, scoring): each case is one edge of
# the kernel's geometry
STRIP_CASES = {
    "lengths_0_and_1": ([0, 1, 1, 0, 40, 1, 0], [0, 1, 0, 1, 1, 37, 50], 40, 50, 0, None,
                        "blosum62"),
    "rows_past_the_last_strip": ([70, 69], [90, 33], 90, 90, 0, None, "blosum62"),
    "ragged": ([300, 31, 33, 257, 64, 200, 7], [290, 299, 17, 300, 64, 5, 250], 300, 300, 0,
               None, "blosum62"),
    "rounds_over_1024_slots": ([1100, 1000, 1037], [1100, 1093, 3], 1100, 1100, 0, None,
                               "blosum62"),
    "k_below_n_plus_m_plus_1": ([200, 150, 90], [180, 200, 60], 200, 200, 137, None,
                                "blosum62"),
    "one_warp": ([200, 97], [180, 120], 200, 200, 0, 1, "blosum62"),
    "sixteen_warps": ([700, 520], [640, 700], 700, 700, 0, 16, "blosum62"),
    "every_cell_at_most_0": ([150, 90], [140, 120], 150, 150, 0, None, "negative"),
    "equal_maxima": ([120, 77, 50], [140, 91, 33], 120, 140, 0, None, "repeat"),
}


def _strip_scoring(name, affine):
    """(scoring, alphabet): BLOSUM62 o=-10 e=-1; DNA with every cell <= 0;
    a DNA match of 2 against repeats (equal maxima along a row and across
    rows); linear gaps (o = 0) unless ``affine``."""
    go = -10 if name == "blosum62" else -5
    if name == "blosum62":
        sp = scoring_params(0, 0, go if affine else 0, -1, BLOSUM62)
        return sp, 20
    match = -1 if name == "negative" else 2
    return scoring_params(match, -3, go if affine else 0, -2, None), 4


def _strip_args(dev, case, affine, seed=3):
    ql, tl, n, m, cut, _, scoring = STRIP_CASES[case]
    sp, alpha = _strip_scoring(scoring, affine)
    rng = np.random.default_rng(seed)
    qlen, tlen = np.array(ql), np.array(tl)
    q = rng.integers(0, alpha, size=(len(ql), n))
    t = rng.integers(0, alpha, size=(len(ql), m))
    L = min(n, m) // 2
    t[:, 3: 3 + L] = q[:, 1: 1 + L]
    if scoring == "repeat":
        q = np.tile([0, 1], (len(ql), n // 2))
        t = np.tile([0, 1], (len(ql), m // 2))
        q[1], t[1] = 2, 2
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, sp)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    args = [as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab)]
    return args, dict(K=tk.shape[1] - cut, band=None, gap_open=sp.gap_open,
                      gap_extend=sp.gap_extend, want_ptr=False, stride=m + 1)


@pytest.mark.parametrize("memory", ["shared", "global"])
@pytest.mark.parametrize("instance", STRIP_INSTANCES, ids=lambda x: f"{x[0]}-{x[1]}")
@pytest.mark.parametrize("case", sorted(STRIP_CASES))
def test_wavefront_strip_kernel_matches_plain_version(dev, case, instance, memory,
                                                      monkeypatch):
    """Each instance of the strip kernel against ``wavefront_fill_ref``,
    every output exactly (the per-row bests, their first k and start, or
    H(qlen, tlen)), with the letters and the wrap row in shared memory and
    forced to global memory, and its key's launch count."""
    mode, affine = instance
    warps = STRIP_CASES[case][5]
    if warps is not None:
        monkeypatch.setattr(wf_mod, "wavefront_strip_warps", lambda Np, w=warps: w)
    if memory == "global":
        monkeypatch.setattr(wf_mod, "STRIP_SMEM_BUDGET", 0)
    args, kw = _strip_args(dev, case, affine)
    kw.update(mode=mode, affine=affine)
    Np = args[0].shape[1]
    if case == "rounds_over_1024_slots":
        assert Np > 1024 and -(-1100 // 32) > wf_mod.wavefront_strip_warps(Np)
    # shared: the columns cut to the lengths' span, as the routes pass it
    span = None if memory == "global" else int((args[3] - args[2]).abs().max())
    if memory == "global":
        cols = wf_mod.strip_columns(kw["K"], Np, span)
        assert wf_mod.wavefront_strip_geometry(Np, args[4].shape[0], cols, mode,
                                               affine)[2:] == (False, False)
    key = wf_mod.launch_key(mode, affine, False)
    before = launches[key]
    got = wavefront_fill(*args, span=span, **kw)
    torch.cuda.synchronize()
    assert launches[key] == before + 1
    _same(got, wavefront_fill_ref(*args, **kw))
    if mode == "local" and STRIP_CASES[case][6] == "negative":
        assert not got["bv"].any()


@pytest.mark.parametrize("span", [None, 0, 40])
def test_wavefront_strip_kernel_on_a_long_global_affine_pair_with_large_scores(dev, span):
    """Global affine score-only on pairs of 3 000 letters with a table of
    BLOSUM62 x 90 000 (H(qlen, tlen) about 1.54e9 of int32's 2.1e9, against
    the TPU kernel's -2^30 for -inf): equal to the plain version, whose
    slots with j < 0 stay below the boundary values here; ``span`` cuts the
    target columns the kernel keeps (``strip_columns``)."""
    sp = scoring_params(0, 0, -20_000, -3_000, BLOSUM62.astype(np.int64) * 90_000)
    rng = np.random.default_rng(17)
    n = 3000
    q = rng.integers(0, 20, size=(2, n))
    t = q.copy()
    t[:, 500:510] = rng.integers(0, 20, size=(2, 10))
    qlen, tlen = np.array([n, n - 11]), np.array([n, n - 40])
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, sp)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    args = [as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab)]
    kw = dict(K=tk.shape[1], band=None, gap_open=sp.gap_open, gap_extend=sp.gap_extend,
              want_ptr=False)
    got = wavefront_fill(*args, span=span, **kw)
    want = wavefront_fill_ref(*args, **kw)
    _same(got, want)
    assert int(want["score"].min()) > 1.5e9


# the pointer strip kernel (unbanded global fills with pointers): name ->
# (query lengths, target lengths, slots kept (None: wavefront_inputs'),
# diagonals cut, warps forced (None: the default), scoring)
PTR_CASES = {
    "ragged_rounds": ([0, 31, 32, 33, 255, 256, 257, 300, 5], [40, 0, 300, 17, 290, 64, 20, 3, 0],
                      None, 0, None, "blosum62"),
    "slots_not_a_multiple_of_32": ([60, 69, 10, 0], [5, 0, 70, 33], 70, 0, None, "blosum62"),
    "fewer_slots_than_a_strip": ([19, 5, 0], [60, 10, 7], 20, 0, None, "dna"),
    "k_below_the_slots": ([300, 150, 290], [20, 300, 5], 330, 400, None, "dna"),
    "k_cut": ([200, 150, 90], [180, 200, 60], None, 137, None, "blosum62"),
    "one_warp": ([200, 97], [180, 120], None, 0, 1, "dna"),
    "three_warps": ([500, 320, 7], [480, 500, 9], None, 0, 3, "blosum62"),
    "long_target": ([300, 60], [6000, 5900], None, 0, None, "dna"),
}


def _ptr_args(dev, case, affine, seed=4):
    """Inputs of ``PTR_CASES[case]``: BLOSUM62 o=-10 e=-1 or DNA 2/-3 with
    o=0 e=-2 (every extend bit set), linear gaps (o = 0) unless ``affine``;
    the sentinel letters past each pair's lengths."""
    ql, tl, keep, cut, _, scoring = PTR_CASES[case]
    if scoring == "blosum62":
        sp, alpha = scoring_params(0, 0, -10 if affine else 0, -1, BLOSUM62), 20
    else:
        sp, alpha = scoring_params(2, -3, 0, -2, None), 4
    rng = np.random.default_rng(seed)
    qlen, tlen = np.array(ql), np.array(tl)
    n, m = int(qlen.max()), int(tlen.max())
    q = rng.integers(0, alpha, size=(len(ql), n))
    t = rng.integers(0, alpha, size=(len(ql), m))
    L = min(n, m) // 2
    t[:, 3: 3 + L] = q[:, 1: 1 + L]
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, sp)
    if keep is not None:
        qpad = np.ascontiguousarray(qpad[:, :keep])
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    args = [as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab)]
    return args, dict(K=tk.shape[1] - cut, band=None, gap_open=sp.gap_open,
                      gap_extend=sp.gap_extend, want_ptr=True, affine=affine)


@pytest.mark.parametrize("memory", ["shared", "global"])
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "linear"])
@pytest.mark.parametrize("case", sorted(PTR_CASES))
def test_wavefront_strip_ptr_kernel_matches_plain_version(dev, case, affine, memory,
                                                          monkeypatch):
    """The pointer strip kernel against ``wavefront_fill_ref``: every byte
    of the (K, B, Np) stream, the slots with j < 0, i > qlen and j > tlen
    included, and the score, with the letters and the wrap rows in shared
    memory and forced to global memory, and its key's launch count."""
    warps = PTR_CASES[case][4]
    if warps is not None:
        monkeypatch.setattr(wf_mod, "wavefront_strip_ptr_warps", lambda Np, w=warps: w)
    if memory == "global":
        monkeypatch.setattr(wf_mod, "STRIP_SMEM_BUDGET", 0)
    args, kw = _ptr_args(dev, case, affine)
    Np, K = args[0].shape[1], kw["K"]
    assert wf_mod.fill_kernel(None, True) == "strip_ptr"
    geometry = wf_mod.wavefront_strip_ptr_geometry(Np, args[4].shape[0], K, affine)
    if memory == "global":
        assert geometry[2:] == (False, False)
    if case == "slots_not_a_multiple_of_32":
        assert Np % 32
    if case == "k_below_the_slots":
        assert K < Np
    if case == "long_target" and memory == "shared":  # the wrap rows past the budget
        assert geometry[2:] == (True, False)
    key = wf_mod.launch_key("global", affine, True)
    before = launches[key]
    got = wavefront_fill(*args, **kw)
    torch.cuda.synchronize()
    assert launches[key] == before + 1
    _same(got, wavefront_fill_ref(*args, **kw))


@pytest.mark.parametrize("shape", ["config3_pass_c", "config1"])
def test_wavefront_strip_ptr_kernel_at_the_paths_shapes(dev, shape):
    """Config 3's pass-(c) shape (B 512, K 891, Np 512, BLOSUM62 o=-10
    e=-1, affine) and config 1's (B 512 DNA pairs of 256 x 256, linear
    gaps: K 513, Np 384), every byte and score equal to the plain
    version."""
    rng = np.random.default_rng(21)
    B = 512
    if shape == "config3_pass_c":
        n, alpha, sp, affine = 445, 20, scoring_params(0, 0, -10, -1, BLOSUM62), True
        qlen = rng.integers(1, n + 1, size=B)
        tlen = np.clip(qlen + rng.integers(-40, 41, size=B), 0, n)
        qlen[0] = tlen[0] = n
    else:
        n, alpha, sp, affine = 256, 4, scoring_params(1, -1, 0, -1, None), False
        qlen = tlen = np.full(B, n)
    q = rng.integers(0, alpha, size=(B, n))
    t = rng.integers(0, alpha, size=(B, n))
    t[:, 30:230] = q[:, 25:225]
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, sp)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    args = [as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab)]
    kw = dict(K=tk.shape[1], band=None, gap_open=sp.gap_open, gap_extend=sp.gap_extend,
              want_ptr=True, affine=affine)
    assert (kw["K"], qpad.shape[1]) == ((891, 512) if affine else (513, 384))
    got = wavefront_fill(*args, **kw)
    _same(got, wavefront_fill_ref(*args, **kw))


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "linear"])
def test_wavefront_strip_ptr_kernel_on_a_stream_cut_into_parts(dev, affine, monkeypatch):
    """A bucket whose stream exceeds ``ptr_cap_bytes()`` is launched in
    parts (``wavefront_launch``): each part's call to the pointer strip
    kernel equals its plain version, and the results equal the uncut
    bucket's and the oracle's."""
    sp = scoring_params(0, 0, -10 if affine else 0, -1, BLOSUM62)
    rng = np.random.default_rng(6)
    qs = [rng.integers(0, 20, int(L)).astype(np.uint8) for L in rng.integers(40, 61, size=7)]
    ts = [np.concatenate([q[2:], rng.integers(0, 20, 3)]).astype(np.uint8) for q in qs]
    kw = dict(scoring=sp, mode="global", backend="xla", device=dev)
    want = [str(r) for r in align_batch(qs, ts, **kw)]
    calls = []
    real = wf_mod.wavefront_fill

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append((a, k, dict(out)))  # the caller pops the stream off the dict
        return out

    monkeypatch.setattr(wf_mod, "wavefront_fill", spy)
    # three pairs' streams of the 64 x 64 bucket: (64 + 64 + 1) x 128 bytes each
    monkeypatch.setenv("SEQALIB_PTR_HBM_CAP", str(3 * 129 * 128))
    got = [str(r) for r in align_batch(qs, ts, **kw)]
    assert got == want
    assert [len(c[0][2]) for c in calls] == [3, 3, 1]
    for a, k, out in calls:
        assert wf_mod.fill_kernel(k["band"], k["want_ptr"]) == "strip_ptr"
        _same(out, wavefront_fill_ref(*a, **{x: v for x, v in k.items() if x != "span"}))
    oracle = [str(oracle_fast.align_oracle(q, t, sp, mode="global")) for q, t in zip(qs, ts)]
    assert got == oracle


# one call of each flag set under one torch.profiler session, in a process
# of its own: after a first session in a test process a second has shown
# no device events
_KERNELS_LAUNCHED = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from seqalib_tpu_torch import BLOSUM62
from seqalib_tpu_torch.ops.wavefront import wavefront_fill, wavefront_inputs
from seqalib_tpu_torch.scoring import scoring_params
sp = scoring_params(0, 0, -20, -2, 2 * BLOSUM62)
rng = np.random.default_rng(5)
qlen = rng.integers(0, 300, size=9)
tlen = np.clip(qlen + rng.integers(-9, 10, size=9), 0, None)
q, t = rng.integers(0, 20, size=(9, 320)), rng.integers(0, 20, size=(9, 320))
qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, sp)
args = [torch.as_tensor(np.asarray(x), dtype=torch.int32, device="cuda")
        for x in (qpad, tk, qlen, tlen, tab)]
calls = [dict(K=tk.shape[1], band=band, gap_open=-20, gap_extend=-2, want_ptr=ptr, mode=mode,
              affine=affine, stride=321) for mode, affine, ptr, band in json.loads(sys.argv[2])]
for kw in calls:  # the build, the allocator's blocks
    wavefront_fill(*args, **kw)
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    for kw in calls:
        wavefront_fill(*args, **kw)
        torch.cuda.synchronize()
ev = sorted((e.time_range.start, e.name) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and "wf_" in e.name)
print(json.dumps([n for _, n in ev]))
"""


def test_wavefront_fill_launches_the_strip_kernel_for_unbanded_score_only(dev):
    """Under ``torch.profiler``, one call of each flag set in turn: an
    unbanded score-only call launches ``wf_strip_kernel`` alone, an
    unbanded global call with pointers ``wf_strip_ptr_kernel`` alone, a
    banded global affine call ``wf_band_kernel``, every other call the
    window kernel (after the far pass when banded with pointers)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _KERNELS_LAUNCHED, str(root),
                          json.dumps(WF_MODES)], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    short = [next(k for k in ("wf_strip_kernel", "wf_strip_ptr_kernel", "wf_band_kernel",
                              "wf_window_kernel", "wf_far_kernel") if k in n) for n in names]
    want = []
    for mode, affine, want_ptr, band in WF_MODES:
        strip = band is None and not want_ptr
        strip_ptr = band is None and want_ptr and mode == "global"
        assert (wf_mod.fill_kernel(band, want_ptr, mode) == "strip") == strip
        assert (wf_mod.fill_kernel(band, want_ptr, mode) == "strip_ptr") == strip_ptr
        banded_global_affine = mode == "global" and affine and band is not None
        want += (["wf_far_kernel"] if want_ptr and band is not None else []) + [
            "wf_strip_kernel" if strip else "wf_strip_ptr_kernel" if strip_ptr else
            "wf_band_kernel" if banded_global_affine else "wf_window_kernel"]
    assert short == want
