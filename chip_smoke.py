#!/usr/bin/env python3
"""Smoke run of seqalib_tpu_torch, the PyTorch + CUDA port, on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. build the CUDA kernels from ``seqalib_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel) and print the card's name and power limit;
2. kernel phase: record the calls the paths below make, then hold each
   kernel against its plain PyTorch version on the card, exactly, and time
   both, with each kernel's bound (the least time the card could take for
   the same work) and, where one PyTorch call computes the same function,
   that call's time:
   - config 3 (B=512 BLOSUM62 pairs of 1024 x 1024): the strip fill in
     its three modes, the row window, the strip walk, and the banded fill
     in ``emode`` (pass 2, all of its diagonals);
   - config 1 (B=512 DNA pairs of 256 x 256): the strip walk again.  Each
     walk is held on its CIGAR text, lengths and final states, with its
     kernel's own time under ``torch.profiler`` and the ns per op of its
     longest walk;
   - config 4 (B=64 DNA pairs of 10 kb, band 128): the banded fill and
     its pointer mode on 2048 diagonals resumed from the fill's own
     checkpoints (each whole call timed as well), and the walk over one
     recomputed super-block;
   every ``band_fill`` key also prints its slot width Wp and its time per
   anti-diagonal;
3. config 3, the main path: ``align_batch`` local, BLOSUM62 o=-10 e=-1,
   full CIGAR, pass 2 on the default banded engine; warm wall time,
   pairs/s, GCUPS; 32 pairs checked against the oracle.  Then the same
   path with pass 2 on the strip engine (``SEQALIB_FUSED_PASS2=strip``);
4. config 1: global linear-gap DNA, B=512 pairs of 256 x 256;
5. config 4: ``align_batch(band=128, mode="global")`` on B=64 DNA pairs of
   10 kb (the target is the query with 2% substitutions; match 2,
   mismatch -3, o=-5, e=-2): warm wall time, pairs/s and GCUPS(n*w);
   every CIGAR consumes its pair and re-scores to the reported score; 8
   pairs cut to 1024 x 1088 equal the banded oracle; then a band sweep
   (64, 256) and B=8 pairs of 100 kb at band 64, re-scored; then one 10 kb
   read against a 27 kb window (a length delta of 17 000, slot width Wp
   8 704: the wide variant of the banded fill, a thread block cluster a
   pair), its CIGAR re-scored and its score equal to ``align_score_sp``'s;
   then the wide variants' other instances through the entry points, each
   result equal to the oracle: local pass 2 under SEQALIB_FUSED_BW=16 384
   (the cluster's emode, Wp 16 512) on 8 of config 3's pairs and under
   131 100 (the global-scratch variant's emode, Wp 131 200) on them cut to
   100 letters, and ``band=131 100`` on 2 DNA pairs of 100 letters (the
   scratch variant's fill and pointer modes);
6. the full-matrix sequence-parallel path on a mesh of one device:
   ``align_sp`` on a 10 240 x 8 192 DNA pair (the target is the query's
   first 8 192 letters with 150 substitutions; match 2, mismatch -3, o=-5,
   e=-2; tiles of 256 columns), ``align_score_sp`` global and local on a
   16 384 x 16 384 pair (2% substitutions and a few indels); warm wall time
   and GCUPS; every score equals the port's strip-engine ``align_batch``
   score for the same pair, the CIGAR consumes the pair and re-scores to
   its score, and ``align_sp`` on a mesh of four entries naming the one
   card gives the same result; ``align_sp`` on a 1 536-letter pair equals
   the oracle (``str(AlignResult)``) on meshes of 1 and 4, and with tiles of
   2 048 columns (one tile: a run of one, a pointer batch of one) on a mesh
   of 1, its local score equal to the strip engine's; ``align_score_sp``
   makes one tile launch per call, ``align_sp`` fewer pointer launches than
   the tiles its walk enters, and one walk (``sp_walk``) a pointer batch;
7. the banded route for tables outside [-4, 11] (the full-matrix
   wavefront): B=64 protein pairs of 1 000 letters (the target is the
   query with 5% substitutions and a few indels), band 64, 2 x BLOSUM62
   with o=-20, e=-2, full CIGAR, then score-only; every result equals the
   BLOSUM62 o=-10, e=-1 banded route's (``band_fill``) with the score
   doubled, 8 pairs equal the banded oracle; warm wall, pairs/s,
   GCUPS(n*w) (the walk runs on the card: ``wavefront_walk``); the
   bucket's launch half, with and without CIGARs, makes no device-to-host
   sync and its finalize equals ``align_batch``'s, and no ``.cpu()`` of a
   call with CIGARs copies as much as the (K, B, Np) pointer stream;
8. banded sequence parallelism on meshes naming the one card: B=16 DNA
   pairs of 100 kb (config 4's generator and scoring), band 256,
   ``align_score_banded_sp`` on a mesh of 4 (R = 25 000, two relay groups,
   5 super-steps), every score equal to ``align_batch(band=256,
   traceback=False)``; ``align_banded_sp`` on one of them over meshes of 4
   and 1, the CIGAR re-scored and ``str`` equal on both and to
   ``align_batch(band=256)``'s; 10 DNA pairs of 600-1000 letters (one
   empty) at band 32 and one BLOSUM62 protein pair of 800 letters equal to
   the banded oracle on meshes of 1 and 4;
9. the CLI and all-vs-all, in process: ``python -m seqalib_tpu_torch bench
   all --pairs 512 --reads 10000 --refs 100 --parity-check`` (configs 1-5,
   one JSON line each, every one through its oracle parity gate; config 5
   is the all-vs-all product of 10 000 reads of 128-256 letters against 100
   references of 512-1 024, a tenth of the contract's 1 000 references);
   256 sampled pairs of that product equal ``align_batch(mode="local",
   traceback=False)``; a 500 x 20 product in chunks of 1 024 resumed from its
   shards with ``run_bucket`` made to raise equals the first run; the launch
   half of one 8 192-pair config-5 chunk (reads of the 256 bucket against
   references of the 1 024 bucket, gathered as the product gathers a chunk)
   makes no device-to-host sync (``torch.cuda.set_sync_debug_mode("error")``)
   and its finalize equals the product; every kernel call of that chunk and
   of config 2's fullest bucket (the linear-gap ``strip_fill/local``, both
   ``row_window`` calls, ``band_fill/emode``, and ``strip_fill/emode`` where a
   pair escalates) is held exactly against its plain version on the same
   device inputs, and timed, with its bound; the launch counts of configs 2
   and 5 include every kernel of the slice's path;
   the product's ``bench 5`` line reports ``"devices"``: the visible cards
   of ``make_pair_mesh()``;
10. the pair mesh (``mesh=``), every result held exactly against
   ``mesh=None``: config 3 through ``align_batch`` on ``make_pair_mesh()``
   (the one card) and on a mesh of 4 entries naming it (warm walls of both
   and of ``mesh=None``, timed in turns with the order rotated each round,
   printed; on the mesh of 4 every kernel of the path
   launched 4 times as often as without, its launch half made no
   device-to-host sync, and the first shard's kernel calls are held
   against their plain versions and timed at the shard's shape), config 1,
   config 4 (timed in turns with ``mesh=None``), phase 7's wide-table batch
   (timed in turns with ``mesh=None``; one fill and one walk per shard, every
   shard launched before any is finalized) and 3 pairs of config 3 (one
   shard empty) on the mesh of 4;
   2 000 reads x 100
   references of config 5's product through ``align_all_vs_all`` on the
   mesh of 4 (timed in turns with ``mesh=None``), equal element by element,
   and resumed on that mesh from the
   shards written without one; two processes of the package's worker
   (``python -m seqalib_tpu_torch.parallel.dist_check``, gloo through a
   ``FileStore``, both on the card, a shard each) on config 3's pairs, each
   rank's results hashing to one process's; ``backend="xla"`` on the mesh
   of 4 (its full-matrix wavefront sharded, as in the JAX package): config
   3 (timed in turns with ``mesh=None``; passes (a) and (c) launched once a
   shard) and phase 7's batch under BLOSUM62 o=-10 e=-1 at band 64;
   ``dryrun_multichip(4, device="cuda")``, and ``dryrun_multichip(n + 1)``
   raising on n cards;
11. ``backend="xla"``, the JAX package's default backend (its full-matrix
   anti-diagonal wavefront: kernel 7's unbanded global and local modes,
   linear and affine, and its banded global mode; the walk, linear and
   affine) at full width: config 1 (with CIGARs, then score-only), config 3,
   config 2's 512 pairs (``bench 2``'s, score-only) and phase 7's batch with
   BLOSUM62 o=-10 e=-1 at band 64 (``band_fill`` under ``"pallas"``, kernel
   7 under ``"xla"``): warm wall, pairs/s and GCUPS, the launch counts of
   each run, every result equal to ``backend="pallas"``'s, 32 sampled
   pairs equal to the oracle;
12. every kernel was launched by its path: the launch counts are set to 0
   just before each path's runs (1 warm-up + 3 timed calls; for the CLI's
   configs, each config's run) and read just after;
13. the seeded differential sweep (``seqalib_tpu_torch/sweep.py``, seed
   ``SEED``): ``SWEEP_DRAWS`` pairs of 1-400 letters (the edge lengths
   around 32, 64, 128, 256 and 384, pairs of 1 against 400, local pairs of
   score 0), six scorings (DNA linear and affine, BLOSUM62, 2 x BLOSUM62,
   BLOSUM62 with gap_open 0, DNA affine scaled near int32's range), both
   modes, through every route of ``sweep.ROUTES`` on the card
   (``align_batch`` on the strip route under both pass-2 engines with and
   without traceback and on ``"xla"``, ``band=`` 1, 3, 16, 800 and 8 300,
   ``align``, ``align_all_vs_all``, both SP and both banded-SP entry points
   on a mesh of 2 naming the card), the launch counts set to 0 just before
   and read just after (every key but ``band_fill/wide_emode`` and the
   scratch variant's launched); every result equal to ``oracle_fast``, the first call of each
   kernel key the routes launched equal to its plain version, every
   identity of ``tests/test_torch_properties.py`` (``sweep.identity_checks``)
   and fault 7's pair on both SP entry points equal to the oracle.

The kernel phase also holds every kernel call of phase 11's buckets
(``run_bucket(backend="xla")`` on config 1's, with CIGARs and
score-only, config 3's and config 2's fullest) against its plain version
and times it: the keys ``wavefront_fill/lin_ptr``, ``lin_score``,
``local``, ``local_lin`` and ``wavefront_walk/linear``, and config 3's
pointer strip kernel's fill and the walk of pass (c), each unbanded fill's
time (score-only, and the pointer fills ``lin_ptr`` and unbanded ``ptr``,
the latter listed as ``wavefront_fill/ptr (unbanded)``) printed beside the
window kernel's earlier figure; the edge checks hold
the modes no path launches (local with pointers, local with a band,
linear with a band; timed, with their bounds), the unbanded global affine
score-only fill at config 3's pairs (timed, with its bound), the four
unbanded score-only instances on a ragged batch (``WF_STRIP_QLENS``) and
the pointer strip kernel's two instances on another (``WF_PTR_QLENS``:
slots no multiple of 32, 8 warps' rounds, empty queries and targets, the
wrap rows in global memory, K cut below the slots), every byte and score.
It prints the warps per pair of each ``strip_fill`` key, the
window's ring of each ``wavefront_fill`` key and, under ``torch.profiler``,
the device time of the two kernels a ``wavefront_fill/ptr`` call launches
(the far pass, then the window), and holds, on shapes no
path reaches, ``strip_fill/local`` on a ragged batch of 7 pairs (query
lengths 1 to 1 029, a target of 17 letters) and ``wavefront_fill/ptr``
with a band wider than the slots and with deltas of +-41 past a band of 8
against their plain versions, every output exactly.  It also holds the
sequence-parallel tile kernel (``sp_tile``:
the runs of a block's tiles in global and local mode and the pointer
batch, on their first 2048 rows and first 4 tiles (3 of a batch), with the
whole call's time printed beside, and the one-tile launches of the
2 048-column tiles whole), the walk through a batch of pointer tiles
(``sp_walk``: every batch one ``align_sp`` call walks at the benchmark cell
``long_pair_sp.cigar``'s shape, 16 569 x ~16 566 in tiles of 128 columns,
each on its header and ops, with the kernel's own time under
``torch.profiler``, the ns per op walked, and a bound of one 32-byte sector
per op walked plus the ops written), the banded traceback's CIGAR text
(``band_cigar``: the joined op blocks of one ``banded_align_batch`` at the
benchmark cell ``long_read_banded.100kb``'s shape, 132 reads of ~119 kb with
its error mix in a band of 128, on the text and its lengths, with the
kernel's own time under ``torch.profiler`` and a bound of the op bytes read
once plus the text written), the wide banded fill (fill and pointer modes on
2048 diagonals of the 17 000-delta pair, and of pairs whose deltas give Wp
8 320, 16 384 and 32 768, each with its cluster geometry; the scratch
variant's fill and pointer calls and both variants' pass-2 emode calls
whole), the
wavefront fill (pointer and score-only modes, at the wide-table phase's
shapes), the wavefront walk (at the same phase's stream, on its CIGAR
text, lengths and final states, with its kernel's own time under
``torch.profiler``, the ns per op of its longest walk, and a bound of one
32-byte sector per op walked plus the text) and phase 8's kernels against
their plain versions: the resumed block fill of a block d >= 1 on a mesh
of 4, in the score relay of phase 8's 100 kb pairs (``band_fill/relay``, 8 live pairs) and in the
align of the first of them (``band_fill/relay_ptr``), on diagonals
[0, 2048) (the boundary injection) and [2R - 1024, 2R + 1024) resumed
from the kernel's own state (the capture of row R), with the whole
block's time beside, and the walk with the row-0 floor
(``band_walk/floor``) on the block's lowest 4096 diagonals, entered with
the states of the kernel's walk of those above.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  The script imports only the
port, NumPy and PyTorch, never JAX or the JAX package: the oracle it
checks against is the port's ``backend="oracle"``.
"""

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

SEED = 0
B3 = 512
B4, L4, BAND4 = 64, 10_000, 128
REPS = 3
SHORT_REPS = 100  # timed calls of a kernel or library call that takes under 0.1 ms
N_ORACLE = 32
N_ORACLE4 = 8
CMP_DIAGONALS = 2048  # config-4 fill and ptr: diagonals held against the plain version
# bounds: HBM3 at 3.35 TB/s (H100 SXM data sheet); int32 ALU ops at
# 132 SMs x 64 INT32 lanes per SM per clock (Hopper white paper) x the
# 1.98 GHz boost clock = 16.7 Tops/s: the DP fills run no tensor-core work
HBM_BYTES_PER_S = 3.35e12
SECTOR_BYTES = 32  # the least a DRAM read moves: a walk step's byte costs a sector
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per cell, the least the recurrence needs: E and F take
# two adds and a max each, the diagonal one add, H two maxes (9, affine);
# local adds its zero clamp and the best-cell compare, emode the compare
# (and a subtract and a max for the tie_safe bound), pointer emission two
# compares for the move and two for the extend bits
OPS_PER_CELL = {"strip_fill/local": 11, "strip_fill/emode": 10, "strip_fill/gmode": 13,
                "band_fill/fill": 9, "band_fill/ptr": 13, "band_fill/emode": 10,
                "band_fill/relay": 9, "band_fill/relay_ptr": 13,
                "band_fill/wide": 9, "band_fill/wide_ptr": 13, "band_fill/wide_emode": 10,
                "band_fill/wide_scratch": 9, "band_fill/wide_scratch_ptr": 13,
                "band_fill/wide_scratch_emode": 10,
                "sp_tile/global": 9, "sp_tile/local": 11, "sp_tile/ptr": 13,
                "sp_tile/run_global": 9, "sp_tile/run_local": 11, "sp_tile/ptr_batch": 13,
                "wavefront_fill/score": 9, "wavefront_fill/ptr": 13,
                # linear gaps: three adds and two maxes, two compares for the
                # move; local start propagation a select per start row (H, and
                # affine E and F)
                "wavefront_fill/lin_score": 5, "wavefront_fill/lin_ptr": 7,
                "wavefront_fill/local": 14, "wavefront_fill/local_lin": 8,
                # local with pointers: the zero clamp and the best compare
                # beside the pointer's compares (no start propagation)
                "wavefront_fill/local_ptr": 15, "wavefront_fill/local_lin_ptr": 9}
# the SP phase (6) and the wide-table phase (7)
SP_N, SP_M, SP_SUBS, SP_C, SP_LONG, SP_CUT_ROWS = 10_240, 8_192, 150, 256, 16_384, 2048
SP_ORACLE_N = 1536  # align_sp held to the oracle, str(AlignResult), on meshes of 1 and 4
SP_ONE_C = 2048  # tiles as wide as the SP_ORACLE_N pair: one tile per block
SP_CUT_TILES, SP_CUT_BATCH = 4, 3  # tiles of a run and of a pointer batch held to plain
SP_CELL_N, SP_CELL_C = 16_569, 128  # the benchmark cell long_pair_sp.cigar's pair and tiles
# the benchmark cell long_read_banded.100kb's batch: reads of ~119 kb against
# their windows in a band of 128, 4% substitutions and 2.5% indels of 1-3
# letters (40% insertions)
LR_CELL_B, LR_CELL_L, LR_CELL_BAND = 132, 119_000, 128
# config 4 with a long window: a 10 kb read against L4 + delta letters; the
# deltas give the wide fill (a thread block cluster a pair) Wp 8 704 (the
# path), 8 320, 16 384 and 32 768
WIDE_DELTA, WIDE_DELTAS_HELD = 17_000, (16_300, 32_400, 65_100)
# the scratch variant (Wp > 131 072): a band of 131 100 on SCRATCH_PAIRS DNA
# pairs of SCRATCH_LEN letters (Wp 131 200, few diagonals); pass 2 reaches
# the wide emode under SEQALIB_FUSED_BW=PASS2_WIDE_BW (Wp 16 512) on
# PASS2_PAIRS of config 3's pairs, the scratch emode under PASS2_SCRATCH_BW
# (Wp 131 200) on them cut to SCRATCH_LEN letters
SCRATCH_BAND, SCRATCH_PAIRS, SCRATCH_LEN = 131_100, 2, 100
PASS2_WIDE_BW, PASS2_SCRATCH_BW, PASS2_PAIRS = 16_384, 131_100, 8
B7, L7, BAND7 = 64, 1000, 64
# the banded-SP phase (8): long reads, the relay's mesh, the kernel cuts
BSP, LSP, BANDSP, DSP = 16, 100_000, 256, 4
RELAY_CUT, WALK_CUT = 2048, 4096
BSP_ORACLE_N, BSP_ORACLE_BAND, BSP_PROTEIN_N = 10, 32, 800
# the CLI phase (9): bench all at the geometry of BASELINE.json:7-11, config 5
# with a tenth of its references; the all-vs-all checks
BENCH_PAIRS = 512
BENCH_ARGS = ["bench", "all", "--pairs", str(BENCH_PAIRS), "--reads", "10000", "--refs", "100",
              "--parity-check"]
AVALL_SAMPLE, AVALL_CHUNK = 256, 8192
RESUME_READS, RESUME_REFS, RESUME_CHUNK = 500, 20, 1024
SLICE_KERNELS = ("strip_fill/local", "row_window", "band_fill/emode")
# the pair-mesh phase (10): config 5's product cut to 2 000 reads; the
# workers' time limit
AVALL_MESH_READS = 2000
TWO_PROCESS_TIMEOUT = 300
# the sweep phase (13): its draws (sweep.draws), the oracle's worker processes
SWEEP_DRAWS, SWEEP_PROCESSES = 600, 6
# the edge checks of the redesigned fills: a ragged strip batch, and
# wavefront fills of 300-letter pairs with a band over the slots (Np 384)
# and with deltas past the band
STRIP_EDGE_QLENS = (1, 31, 33, 257, 1000, 1029, 700)
STRIP_EDGE_TLENS = (900, 1029, 1000, 17, 1029, 640, 20)
WAVEFRONT_EDGES = (("band over the slots", 400, 7), ("delta past the band", 8, 41),
                   ("delta past the band, negative", 8, -41))
# the strip kernel (kernel 7's unbanded score-only fills) on a ragged batch:
# query lengths around the strips (32 rows) and the 8 warps' rounds (256
# rows), targets up to 6 000 letters (the wrap row past the shared budget)
WF_STRIP_QLENS = (1, 31, 32, 33, 255, 256, 257, 289, 700, 1029, 600)
WF_STRIP_TLENS = (900, 1029, 6000, 17, 1029, 640, 20, 3, 1500, 1029, 0)
# the times of the unbanded fills under the window kernel they ran on before
# the strip kernels (a thread per slot, every slot), on an H100 80GB HBM3 at
# 700 W, printed beside this run's times: the score-only fills', and the
# global fills with pointers (config 3's pass (c), config 1 with CIGARs)
WINDOW_KERNEL_MS = {"wavefront_fill/local": 14.1766, "wavefront_fill/local_lin": 1.1307,
                    "wavefront_fill/lin_score": 0.4460, "wavefront_fill/ptr": 1.374,
                    "wavefront_fill/lin_ptr": 0.5341}
# the pointer strip kernel (kernel 7's unbanded global fills with pointers)
# on a ragged batch: query lengths around the strips and the 8 warps'
# rounds, an empty query and an empty target, the slots cut to a width
# that is no multiple of 32, targets up to 6 000 letters (the wrap rows
# past the shared budget), and K cut below the slots
WF_PTR_QLENS = (0, 31, 32, 33, 255, 256, 257, 300, 700, 1029, 600, 5)
WF_PTR_TLENS = (900, 0, 6000, 17, 1029, 640, 20, 3, 1500, 1029, 0, 40)
WF_PTR_NP, WF_PTR_K_CUT = 1050, 700
# kernel 7's modes no path launches, held in the edge checks: (mode, affine,
# pointers, band)
UNREACHED_MODES = (("local", True, True, None), ("local", False, True, None),
                   ("local", True, False, 8), ("local", False, True, 8),
                   ("global", False, True, 8), ("global", False, False, 8))
STRIP = "seqalib_tpu/ops/strip_pallas.py"
BANDED = "seqalib_tpu/ops/banded_pallas.py"
SPTILE = "seqalib_tpu/ops/sp_tile_pallas.py"
WAVEFRONT = "seqalib_tpu/ops/wavefront_pallas.py"
KERNELS = {  # name -> (CUDA source, replaced Pallas kernel, path[, launch-counter key])
    "row_window": ("row_window.cu", f"{STRIP}:157", "config3"),
    "strip_fill/local": ("strip_fill.cu", f"{STRIP}:230", "config3"),
    "strip_fill/emode": ("strip_fill.cu", f"{STRIP}:230", "config3_strip"),
    "strip_fill/gmode": ("strip_fill.cu", f"{STRIP}:230", "config3"),
    "strip_walk": ("strip_walk.cu", f"{STRIP}:2022", "config3"),
    "band_fill/emode": ("band_fill.cu", f"{BANDED}:90", "config3"),
    "band_fill/fill": ("band_fill.cu", f"{BANDED}:90", "config4"),
    "band_fill/ptr": ("band_fill.cu", f"{BANDED}:90", "config4"),
    # the wide variants: a thread block cluster a pair (8192 < Wp <= 131072),
    # the global scratch past it
    "band_fill/wide": ("band_fill.cu", f"{BANDED}:90", "config4_wide"),
    "band_fill/wide_ptr": ("band_fill.cu", f"{BANDED}:90", "config4_wide"),
    "band_fill/wide_emode": ("band_fill.cu", f"{BANDED}:90", "pass2_wide"),
    "band_fill/wide_scratch": ("band_fill.cu", f"{BANDED}:90", "config4_scratch"),
    "band_fill/wide_scratch_ptr": ("band_fill.cu", f"{BANDED}:90", "config4_scratch"),
    "band_fill/wide_scratch_emode": ("band_fill.cu", f"{BANDED}:90", "pass2_scratch"),
    "band_walk": ("band_walk.cu", f"{BANDED}:890", "config4"),
    "sp_tile/global": ("sp_tile.cu", f"{SPTILE}:52", "sp_one_tile"),
    "sp_tile/ptr": ("sp_tile.cu", f"{SPTILE}:52", "sp_one_tile"),
    "sp_tile/local": ("sp_tile.cu", f"{SPTILE}:52", "sp_one_tile"),
    "sp_tile/run_global": ("sp_tile.cu", f"{SPTILE}:52", "sp_align"),
    "sp_tile/ptr_batch": ("sp_tile.cu", f"{SPTILE}:52", "sp_align"),
    "sp_tile/run_local": ("sp_tile.cu", f"{SPTILE}:52", "sp_local"),
    # a kernel of the port alone: it replaces the JAX package's host walk of
    # the SP path (nw_affine_align_sp)
    "sp_walk": ("sp_walk.cu", "seqalib_tpu/parallel/band_pipeline.py:562", "sp_align"),
    # a kernel of the port alone: it replaces the JAX banded route's host
    # loop that run-length encodes each op row (and the op matrix's copy)
    "band_cigar": ("band_cigar.cu", "seqalib_tpu/models/banded.py:543", "config4"),
    "wavefront_fill/ptr": ("wavefront_fill.cu", f"{WAVEFRONT}:96", "wide"),
    # the unbanded global fill with pointers (the pointer strip kernel),
    # counted under the same key on the "xla" route's config 3 (pass c)
    "wavefront_fill/ptr (unbanded)": ("wavefront_fill.cu", f"{WAVEFRONT}:96", "xla_config3",
                                      "wavefront_fill/ptr"),
    "wavefront_fill/score": ("wavefront_fill.cu", f"{WAVEFRONT}:96", "wide_score"),
    # a kernel of the port alone: it replaces the host walk of the JAX
    # route (native.walk_to_cigars, then _host_traceback_affine)
    "wavefront_walk": ("wavefront_walk.cu", f"{WAVEFRONT}:707", "wide"),
    # the "xla" route's modes of kernel 7, and the linear walk
    # (_host_traceback_linear)
    "wavefront_fill/lin_ptr": ("wavefront_fill.cu", f"{WAVEFRONT}:96", "xla_config1"),
    "wavefront_fill/lin_score": ("wavefront_fill.cu", f"{WAVEFRONT}:96", "xla_config1_score"),
    "wavefront_fill/local": ("wavefront_fill.cu", f"{WAVEFRONT}:96", "xla_config3"),
    "wavefront_fill/local_lin": ("wavefront_fill.cu", f"{WAVEFRONT}:96", "xla_config2"),
    "wavefront_walk/linear": ("wavefront_walk.cu", f"{WAVEFRONT}:520", "xla_config1"),
    "band_fill/relay": ("band_fill.cu", f"{BANDED}:90", "banded_sp_score"),
    "band_fill/relay_ptr": ("band_fill.cu", f"{BANDED}:90", "banded_sp_align"),
    "band_walk/floor": ("band_walk.cu", f"{BANDED}:890", "banded_sp_align"),
}


def say(*args):
    print(*args, flush=True)


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def max_abs_err(a, b) -> int:
    err = 0
    ta, tb = _tensors(a), _tensors(b)
    if len(ta) != len(tb):
        raise AssertionError(f"{len(ta)} outputs != {len(tb)}")
    for x, y in zip(ta, tb):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def time_ms(fn, reps, warm=True):
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---- bounds ---------------------------------------------------------------


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _band_cells(qlen, tlen, dlo_p, dhi_p, k0, k1):
    """(cells, letters, pairs): the valid in-band cells (i, j) with
    k0 <= i + j < k1, the query rows plus the target columns they span, and
    the pairs that have such cells, summed over pairs."""
    cells = letters = pairs = 0
    for n, m, lo, hi in zip(qlen, tlen, dlo_p, dhi_p):
        i = np.arange(n + 1)
        jlo = np.maximum.reduce([np.zeros_like(i), i + lo, k0 - i])
        jhi = np.minimum.reduce([np.full_like(i, m), i + hi, k1 - 1 - i])
        has = jhi >= jlo
        if has.any():
            cells += int((jhi - jlo + 1)[has].sum())
            letters += int(has.sum()) + int(jhi[has].max() - jlo[has].min() + 1)
            pairs += 1
    return cells, letters, pairs


def bound(key, args, kw, out):
    """(bound_ms, bound_by) of one call: the larger of its bytes (each
    input read once, each output written once; for a kernel that reads a
    few entries of a large input, only those) over HBM_BYTES_PER_S and its
    int32 operations over INT32_OPS_PER_S."""
    name = key.split("/")[0]
    cells = 0
    if name == "row_window":
        src, starts, hi = args
        N, L = out.shape
        nbytes = 2 * _nbytes(out) + _nbytes((starts, hi))  # the window read, then written
    elif name == "strip_walk":  # a pointer byte read per op walked; the text written
        _, nchar, state = out
        steps = int(walked_ops(out).sum())
        nbytes = steps + _nbytes(args[1:]) + _nbytes((nchar, state)) + int(nchar.sum())
    elif name == "wavefront_walk":  # a 32-byte sector per op walked; the text written
        _, nchar, state = out
        steps = int(wavefront_walked_ops(out).sum())
        nbytes = (SECTOR_BYTES * steps + _nbytes(args[1:]) + _nbytes((nchar, state))
                  + int(nchar.sum()))
    elif name == "band_cigar":  # every op byte read once; nchar and the text written
        nbytes = _nbytes(args) + _nbytes(out[1]) + int(out[1].sum())
    elif name == "band_walk":
        steps = int((out[0] != 255).sum())
        nbytes = _nbytes(out) + _nbytes(args[1:]) + steps
    elif name == "strip_fill":
        q, t2, qlen, tlen = args[:4]
        cells = int((qlen.long() * tlen.long()).sum())
        nbytes = _nbytes(args[:4]) + _nbytes(args[4].table) + _nbytes(out)
    elif name == "sp_tile":  # every cell of R rows x the tiles' columns; ptr: a byte each
        cells = args[0].shape[0] * args[3].numel()
        nbytes = _nbytes(args) + _nbytes(out)
    elif name == "wavefront_fill":  # the (in-band) cells of each pair's matrix
        qlen, tlen = (v.cpu().numpy().astype(np.int64) for v in args[2:4])
        d = tlen - qlen
        if kw["band"] is None:
            cells = int((qlen * tlen).sum())
        else:
            cells, _, _ = _band_cells(qlen, tlen, np.minimum(0, d) - kw["band"],
                                      np.maximum(0, d) + kw["band"], 0, kw["K"])
        # every byte of the (K, B, Np) pointer stream is the function's output
        nbytes = _nbytes(args) + _nbytes(out)
    elif kw["mode"] == "emode":  # band_fill, pass 2: every slot of every diagonal
        score = args[7]
        cells = score.shape[0] * score.shape[1] * (kw["k1"] - kw["k0"])
        nbytes = _nbytes(args) + _nbytes(out)
    else:  # band_fill, fill and ptr modes: the in-band cells of [k0, k1)
        qk, tk, qlen, tlen, dlo_p, dhi_p, state, score, tab = args
        cells, letters, pairs = _band_cells(*(v.cpu().numpy().astype(np.int64)
                                              for v in (qlen, tlen, dlo_p, dhi_p)),
                                            kw["k0"], kw["k1"])
        # the letters those cells read, not the letter windows; a byte per
        # in-band cell of the pointer output, as for sp_tile and wavefront_fill
        nbytes = (4 * letters + _nbytes(args[2:]) + _nbytes(out) - _nbytes(out.get("ptr"))
                  + cells * ("ptr" in out))
        if kw.get("bh") is not None:  # a resumed block: H and F of row 0, k <= dhi
            nbytes += 2 * 4 * pairs * max(0, min(kw["k1"], kw["dhi"] + 1) - kw["k0"])
    ops = cells * (OPS_PER_CELL.get(key, 0) + 2 * bool(kw.get("tie_safe")))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_window_library_ms(args, kw):
    """One ``torch.gather`` plus a mask computing ``row_window`` on the
    same inputs (the index and mask built beforehand; a reversed read
    gathers at the mirrored index)."""
    import torch

    src, starts, hi = args
    W = src.shape[1]
    x = torch.arange(kw["L"], device=src.device)[None, :]
    idx = (starts.long()[:, None] + x).clamp(0, W - 1)
    if kw.get("reverse"):
        idx = W - 1 - idx
    keep = (x >= kw["lo"]) & (x < hi.long()[:, None])
    fill = torch.tensor(kw["fill"], dtype=src.dtype, device=src.device)
    return time_ms(lambda: torch.where(keep, torch.gather(src, 1, idx), fill), SHORT_REPS)


def strip_walk_mod():
    from seqalib_tpu_torch.ops import strip_walk

    return strip_walk


def walked_ops(out):
    """Ops each pair's ``strip_walk`` walked: the ops of its CIGAR less its
    boundary run (i' ops, or j' when i' = 0)."""
    from seqalib_tpu_torch.utils.cigar import cigars_from_text

    text, nchar, state = out
    cig = cigars_from_text(text, nchar)
    i, j = state[0].cpu().numpy(), state[1].cpu().numpy()
    head = np.where(i > 0, i, np.maximum(j, 0))
    total = np.array([sum(int(n) for n in re.findall(r"(\d+)[MID]", c)) for c in cig],
                     np.int64)
    return total - head


def wavefront_walked_ops(out):
    """Ops each pair's ``wavefront_walk`` walked: every op of its CIGAR (the
    walk reaches (0, 0) through the stream's row 0 and column 0)."""
    from seqalib_tpu_torch.utils.cigar import cigars_from_text

    text, nchar, _ = out
    cig = cigars_from_text(text, nchar)
    return np.array([sum(int(n) for n in re.findall(r"(\d+)[MID]", c)) for c in cig],
                    np.int64)


def walk_report(call, out, key="strip_walk"):
    """The shape of a ``strip_walk`` or ``wavefront_walk`` call, its ops
    walked, and the kernel's own time under ``torch.profiler`` per call and
    per op of the longest walk."""
    steps = (wavefront_walked_ops(out) if key.startswith("wavefront_walk")
             else walked_ops(out))
    name = key.split("/")[0] + "_kernel"
    alone = kernel_split(call, (name,))[name]
    text = (f"B {len(steps)}, text {tuple(out[0].shape)}; ops walked: longest "
            f"{steps.max()}, mean {steps.mean():.1f}; kernel alone ")
    if alone is None:
        return text + "not measured"
    per_op = alone * 1e6 / max(1, steps.max())
    return text + f"{alone:.4f} ms, {per_op:.1f} ns per op of the longest walk"


def text_view(out):
    """``(text, nchar)`` with each text row's undefined bytes (those before
    its last nchar) set to 0."""
    import torch

    text, nchar = out
    W = text.shape[1]
    keep = torch.arange(W, device=text.device)[None, :] >= W - nchar.long()[:, None]
    return torch.where(keep, text, 0), nchar


def walk_view(out):
    """``strip_walk``'s outputs with each text row's undefined bytes set to
    0."""
    return (*text_view(out[:2]), out[2])


# ---- kernel phase -------------------------------------------------------


def check_kernel(key, kernel, plain, view=lambda out: out):
    """Kernel and plain version on the same inputs: exact equality of
    ``view`` of their outputs, then both timed per call (wrapper included;
    the plain version on the one call compared, or on a second call when
    that one was short)."""
    import torch

    got = kernel()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain()
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = max_abs_err(view(got), view(want))
    if err != 0:
        raise AssertionError(f"{key}: kernel differs from its plain version by {err}")
    if plain_ms < 100:  # first-use loading of PyTorch's kernels dominates a short call
        plain_ms = time_ms(plain, 1, warm=False)
    ms = time_ms(kernel, 5)
    if ms < 0.1:  # a call bound by its host time: average over more calls
        ms = time_ms(kernel, SHORT_REPS)
    say(f"[kernel] {key}: equal to plain version; {ms:.4f} ms vs plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}, got


def _key(name, args, kw):
    """The ``launches`` key a wrapper's call counts under."""
    from seqalib_tpu_torch.ops.band_fill import launch_key

    if name == "wavefront_fill":
        from seqalib_tpu_torch.ops.wavefront import launch_key as wf_key

        return wf_key(kw.get("mode", "global"), kw.get("affine", True), kw["want_ptr"])
    if name == "wavefront_walk" and not kw.get("affine", True):
        return "wavefront_walk/linear"
    if name == "band_fill":
        return launch_key(kw["mode"], kw.get("bh") is not None, args[6].shape[2])
    if name == "band_walk" and kw.get("i_floor", -1) >= 0:
        return "band_walk/floor"
    if name == "sp_tile_run":  # a run of T tiles: ftop holds T * C columns
        one = args[3].shape[0] == kw["C"]
        return f"sp_tile/{kw['mode']}" if one else f"sp_tile/run_{kw['mode']}"
    if name == "sp_tile_ptr":  # K tiles: htop is (K, C + 1)
        return "sp_tile/ptr" if args[2].shape[0] == 1 else "sp_tile/ptr_batch"
    return f"{name}/{kw['mode']}" if name == "strip_fill" else name


def record(run, targets, keep=lambda args, kw: True, every=False):
    """Run ``run()`` with each wrapper ``(module, name, plain)`` of
    ``targets`` patched to keep its first call per key whose arguments
    ``keep`` accepts: (kernel, plain, args, kwargs, result).  With
    ``every``, each call is kept, the n-th of a key under ``"key #n"``."""
    calls = {}

    def recording(name, fn, plain):
        def wrapped(*args, **kw):
            res = fn(*args, **kw)
            if keep(args, kw):
                key = _key(name, args, kw)
                if every:
                    key += f" #{sum(k.split(' #')[0] == key for k in calls) + 1}"
                calls.setdefault(key, (fn, plain, args, kw, res))
            return res
        return wrapped

    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    for (mod, name, fn), (_, _, plain) in zip(saved, targets):
        setattr(mod, name, recording(name, fn, plain))
    try:
        out = run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return calls, out


def per_diagonal(kw, ms):
    """µs per anti-diagonal of a ``band_fill`` call over [k0, k1)."""
    return ms * 1e3 / max(1, kw["k1"] - kw["k0"])


def kernel_entry(key, fn, plain, args, kw, label=""):
    # the plain version has no deferred range check: it checks at once; a
    # fill's span sizes the kernel's ring alone
    pkw = {k: v for k, v in kw.items() if k not in ("err", "span")}
    walks = ("strip_walk", "wavefront_walk", "wavefront_walk/linear")
    view = (walk_view if key in walks else text_view if key == "band_cigar"
            else (lambda out: out))
    stats, out = check_kernel(key + label, lambda: fn(*args, **kw),
                              lambda: plain(*args, **pkw), view)
    b_ms, b_by = bound(key, args, kw, out)
    lib_ms = row_window_library_ms(args, kw) if key == "row_window" else None
    say(f"[bound] {key}{label}: {b_ms:.4f} ms by {b_by}"
        + (f"; library call {lib_ms:.4f} ms" if lib_ms is not None else ""))
    if key.startswith("band_fill/"):
        say(f"[kernel] {key}: Wp {args[6].shape[2]}, B {args[6].shape[1]}, "
            f"{kw['k1'] - kw['k0']} diagonals: {per_diagonal(kw, stats['ms']):.4f} µs "
            f"per anti-diagonal")
    if key.startswith(("strip_fill/", "wavefront_fill/")):
        say(f"[kernel] {key}: {layout(key, args, kw)}")
    if key in walks:
        say(f"[kernel] {key}{label}: {walk_report(lambda: fn(*args, **kw), out, key)}; "
            f"wrapper {stats['ms']:.4f} ms")
    if key == "wavefront_fill/ptr" and kw["band"] is not None:
        split = kernel_split(lambda: fn(*args, **kw), ("wf_far_kernel", "wf_band_kernel"))
        say(f"[kernel] {key}: 2 kernels per call, the far pass then the window: "
            + ", ".join(f"{k} {'not measured' if v is None else f'{v:.4f} ms'}"
                        for k, v in split.items()))
    return dict(stats, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def kernel_split(fn, names, calls=5):
    """Device ms per call of each kernel in ``names`` that one call of
    ``fn`` launches, under ``torch.profiler`` (None where the trace shows
    no device time for it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if n in e.name:
                us[n] += e.time_range.end - e.time_range.start
    return {n: (v / calls / 1e3 if v else None) for n, v in us.items()}


def layout(key, args, kw):
    """The launch shape the wrapper picks for a ``strip_fill`` or
    ``wavefront_fill`` call: warps per pair, or the window's ring."""
    if key.startswith("strip_fill/"):
        from seqalib_tpu_torch.ops.strip_fill import strip_smem, strip_warps

        q, t2, tables = args[0], args[1], args[4]
        W = strip_warps(q.shape[1])
        nbytes, letters, row = strip_smem(tables.A1, t2.shape[1], W)
        return (f"B {q.shape[0]}, Nq {q.shape[1]}, {W} warps per pair, {nbytes} B shared "
                f"(letters {'shared' if letters else 'global'}, wrap row "
                f"{'shared' if row else 'global'})")
    from seqalib_tpu_torch.ops.wavefront import (fill_kernel, strip_columns, window_ring,
                                                 window_rows, window_width,
                                                 wavefront_strip_geometry,
                                                 wavefront_strip_ptr_geometry)

    qpad, tk, qlen, tlen, tab = args
    kernel = fill_kernel(kw["band"], kw["want_ptr"], kw.get("mode", "global"))
    if kernel == "strip_ptr":
        W, nbytes, letters, rows = wavefront_strip_ptr_geometry(
            qpad.shape[1], tab.shape[0], kw["K"], kw.get("affine", True))
        return (f"B {qpad.shape[0]}, Np {qpad.shape[1]}, K {kw['K']}: pointer strip kernel, "
                f"{W} warps per pair, {nbytes} B shared (letters "
                f"{'shared' if letters else 'global'}, wrap rows "
                f"{'shared' if rows else 'global'})")
    if kernel == "strip":
        cols = strip_columns(kw["K"], qpad.shape[1], kw.get("span"))
        W, nbytes, letters, row = wavefront_strip_geometry(
            qpad.shape[1], tab.shape[0], cols, kw.get("mode", "global"), kw.get("affine", True))
        return (f"B {qpad.shape[0]}, Np {qpad.shape[1]}, K {kw['K']}: strip kernel, {W} warps "
                f"per pair, {cols} target columns, {nbytes} B shared (letters "
                f"{'shared' if letters else 'global'}, wrap row "
                f"{'shared' if row else 'global'})")
    span = int((tlen.long() - qlen.long()).abs().max())
    width = window_width(span, kw["band"], qpad.shape[1])
    rows = window_rows(kw.get("mode", "global"), kw.get("affine", True), kw["want_ptr"])
    R, rows_in_smem = window_ring(width, tab.shape[0], rows)
    threads = min(1024, -(-min(R, qpad.shape[1]) // 32) * 32)
    return (f"B {qpad.shape[0]}, Np {qpad.shape[1]}, K {kw['K']}, band {kw['band']}, "
            f"max |delta| {span}: window {width} slots, {threads} threads per pair, "
            f"ring R={R} x {rows} rows ({'shared' if rows_in_smem else 'global'})")


def edge_checks(q3, t3, sp3, sp7, dev):
    """The redesigned fills on shapes the paths do not reach, held exactly
    against their plain versions: ``strip_fill/local`` on a ragged batch
    (query lengths around the strips and the warps' rounds, a target shorter
    than a strip), ``wavefront_fill/ptr`` with a band wider than the slots
    and with deltas past the band, the unbanded global affine score-only
    fill at config 3's pairs (timed, with its bound), and the strip
    kernel's four instances on a ragged batch (``WF_STRIP_QLENS``)."""
    import torch
    from seqalib_tpu_torch import ScoringParams
    from seqalib_tpu_torch.ops.strip import prep_strip
    from seqalib_tpu_torch.ops.strip_fill import strip_fill, strip_fill_ref
    from seqalib_tpu_torch.ops.wavefront import (wavefront_fill, wavefront_fill_ref,
                                                 wavefront_inputs)
    from seqalib_tpu_torch.scoring import tables_from_params

    rng = np.random.default_rng(SEED + 7)
    qlen = np.array(STRIP_EDGE_QLENS)
    tlen = np.array(STRIP_EDGE_TLENS)
    n, m = int(qlen.max()), int(tlen.max())
    q = rng.integers(0, 20, size=(len(qlen), n))
    t = rng.integers(0, 20, size=(len(qlen), m))
    t[:, 100:600] = q[:, 90:590]
    qpad, t2 = prep_strip(q, t, qlen, tlen, 21, dev)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)  # noqa: E731
    tables = tables_from_params(sp3, dev)
    args = (qpad, t2, as_t(qlen), as_t(tlen), tables)
    kw = dict(mq=m, mode="local", want_ptr=False)
    got = strip_fill(*args, **kw)
    err = max_abs_err(got, strip_fill_ref(*args, **kw))
    if err:
        raise AssertionError(f"strip_fill/local, ragged batch: differs by {err}")
    say(f"[edge] strip_fill/local on query lengths {qlen.tolist()}, target lengths "
        f"{tlen.tolist()}: equal to the plain version; {layout('strip_fill/local', args, kw)}")
    for name, band, delta in WAVEFRONT_EDGES:
        qlen = rng.integers(200, 301, size=4)
        qlen[0] = 300 - max(delta, 0)
        tlen = np.clip(qlen + delta, 0, 300)
        q = rng.integers(0, 20, size=(4, 300))
        t = rng.integers(0, 20, size=(4, 300))
        t[:, 10:150] = q[:, 12:152]
        qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, sp7)
        args = (as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab))
        kw = dict(K=tk.shape[1], band=band, gap_open=sp7.gap_open,
                  gap_extend=sp7.gap_extend, want_ptr=True)
        got = wavefront_fill(*args, **kw)
        err = max_abs_err(got, wavefront_fill_ref(*args, **kw))
        if err:
            raise AssertionError(f"wavefront_fill/ptr, {name}: differs by {err}")
        say(f"[edge] wavefront_fill/ptr, {name}: every byte equal to the plain version; "
            f"{layout('wavefront_fill/ptr', args, kw)}")
    # the unbanded global affine score-only fill (the strip kernel) at
    # config 3's pairs in global mode, as the "xla" route launches it
    qpad, tk, tab = wavefront_inputs(q3, t3, np.full(len(q3), q3.shape[1]),
                                     np.full(len(t3), t3.shape[1]), sp3)
    args = (as_t(qpad), as_t(tk), as_t(np.full(len(q3), q3.shape[1])),
            as_t(np.full(len(t3), t3.shape[1])), as_t(tab))
    kw = dict(K=tk.shape[1], band=None, gap_open=sp3.gap_open, gap_extend=sp3.gap_extend,
              want_ptr=False, span=0)
    entry = kernel_entry("wavefront_fill/score", wavefront_fill, wavefront_fill_ref, args, kw,
                         label=" (unbanded, config 3's pairs in global mode)")
    say(f"[edge] wavefront_fill/score unbanded: {entry['ms']:.4f} ms, bound "
        f"{entry['bound_ms']:.4f} ms by {entry['bound_by']} (not measured before)")
    # the strip kernel's four instances on a ragged batch
    qlen, tlen = np.array(WF_STRIP_QLENS), np.array(WF_STRIP_TLENS)
    q = rng.integers(0, 20, size=(len(qlen), int(qlen.max())))
    t = rng.integers(0, 20, size=(len(qlen), int(tlen.max())))
    t[:, 100:900] = q[:, 95:895]
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, sp3)
    args = (as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab))
    for mode, affine in (("local", True), ("local", False), ("global", True),
                         ("global", False)):
        sp = sp3 if affine else ScoringParams(gap_open=0, gap_extend=-1, matrix=sp3.matrix)
        kw = dict(K=tk.shape[1], band=None, gap_open=sp.gap_open, gap_extend=sp.gap_extend,
                  want_ptr=False, mode=mode, affine=affine, stride=t.shape[1] + 1,
                  span=int(np.abs(tlen - qlen).max()))
        key = _key("wavefront_fill", args, kw)
        got = wavefront_fill(*args, **kw)
        err = max_abs_err(got, wavefront_fill_ref(*args, **{k: v for k, v in kw.items()
                                                              if k != "span"}))
        if err:
            raise AssertionError(f"{key}, ragged strip batch: differs by {err}")
        say(f"[edge] {key} on query lengths {qlen.tolist()}, target lengths {tlen.tolist()}: "
            f"every output equal to the plain version; {layout(key, args, kw)}")
    # the pointer strip kernel's two instances on a ragged batch: its slots
    # cut to WF_PTR_NP (no multiple of 32), every K and K cut below Np
    qlen, tlen = np.array(WF_PTR_QLENS), np.array(WF_PTR_TLENS)
    q = rng.integers(0, 20, size=(len(qlen), int(qlen.max())))
    t = rng.integers(0, 20, size=(len(qlen), int(tlen.max())))
    t[:, 100:900] = q[:, 95:895]
    for affine in (True, False):
        sp = sp3 if affine else ScoringParams(gap_open=0, gap_extend=-1, matrix=sp3.matrix)
        qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, sp)
        args = (as_t(qpad[:, :WF_PTR_NP]), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab))
        for K in (tk.shape[1], WF_PTR_K_CUT):
            kw = dict(K=K, band=None, gap_open=sp.gap_open, gap_extend=sp.gap_extend,
                      want_ptr=True, affine=affine)
            key = _key("wavefront_fill", args, kw)
            got = wavefront_fill(*args, **kw)
            err = max_abs_err(got, wavefront_fill_ref(*args, **kw))
            if err:
                raise AssertionError(f"{key}, ragged pointer strip batch, K {K}: differs by "
                                     f"{err}")
            say(f"[edge] {key} on query lengths {qlen.tolist()}, target lengths "
                f"{tlen.tolist()}, K {K}: every byte and score equal to the plain version; "
                f"{layout(key, args, kw)}")
    # the modes of kernel 7 that no path launches: local with pointers,
    # local with a band, linear with a band
    qlen = rng.integers(200, 301, size=4)
    tlen = np.clip(qlen + rng.integers(-30, 31, size=4), 0, 300)
    q = rng.integers(0, 20, size=(4, 300))
    t = rng.integers(0, 20, size=(4, 300))
    t[:, 10:150] = q[:, 12:152]
    qpad, tk, tab = wavefront_inputs(q, t, qlen, tlen, sp3)
    args = (as_t(qpad), as_t(tk), as_t(qlen), as_t(tlen), as_t(tab))
    for mode, affine, want_ptr, band in UNREACHED_MODES:
        kw = dict(K=tk.shape[1], band=band, gap_open=sp3.gap_open, gap_extend=sp3.gap_extend,
                  want_ptr=want_ptr, mode=mode, affine=affine, stride=301)
        key = _key("wavefront_fill", args, kw)
        got = wavefront_fill(*args, **kw)
        err = max_abs_err(got, wavefront_fill_ref(*args, **kw))
        if err:
            raise AssertionError(f"{key}, band {band}: differs by {err}")
        b_ms, b_by = bound(key, args, kw, got)
        ms = time_ms(lambda: wavefront_fill(*args, **kw), 5)
        say(f"[edge] {key} (affine {affine}), band {band}: every output equal to the plain "
            f"version; {ms:.4f} ms, bound {b_ms:.6f} ms by {b_by}; {layout(key, args, kw)}")


def kernel_phase3(q, t, sp, dev):
    """Config 3's calls on (q, t), on both pass-2 engines."""
    from seqalib_tpu_torch.ops import band_fill as bf_mod
    from seqalib_tpu_torch.ops import row_window as rw_mod
    from seqalib_tpu_torch.ops import strip as strip_mod
    from seqalib_tpu_torch.ops import strip_fill as sf_mod
    from seqalib_tpu_torch.ops import strip_walk as sw_mod
    from seqalib_tpu_torch.scoring import tables_from_params

    targets = [(strip_mod, "row_window", rw_mod.row_window_ref),
               (strip_mod, "strip_fill", sf_mod.strip_fill_ref),
               (strip_mod, "strip_walk", sw_mod.strip_walk_ref),
               (strip_mod, "band_fill", bf_mod.band_fill_ref)]
    n = np.full(len(q), q.shape[1])
    m = np.full(len(t), t.shape[1])
    tables = tables_from_params(sp, dev)
    calls, out = record(lambda: strip_mod.strip_bucket(q, t, n, m, tables, mode="local",
                                                       want_tb=True), targets)
    calls_s, _ = record(lambda: strip_mod.strip_bucket(q, t, n, m, tables, mode="local",
                                                       want_tb=False, pass2="strip"),
                        targets)
    calls["strip_fill/emode"] = calls_s["strip_fill/emode"]
    per_kernel = {key: kernel_entry(key, fn, plain, args, kw, label=" (config 3)"
                                    if key == "strip_walk" else "")
                  for key, (fn, plain, args, kw, _) in calls.items()}
    return per_kernel, int(out["escalated"].sum())


def kernel_phase_bucket(q, t, qlen, tlen, sp, dev, label):
    """Every kernel call of one local score-only bucket, made as the CLI's
    configs 2 and 5 make it (``run_bucket``), held against its plain
    version on the same device inputs."""
    from seqalib_tpu_torch.ops import band_fill as bf_mod
    from seqalib_tpu_torch.ops import row_window as rw_mod
    from seqalib_tpu_torch.ops import strip as strip_mod
    from seqalib_tpu_torch.ops import strip_fill as sf_mod
    from seqalib_tpu_torch.parallel import dispatch

    targets = [(strip_mod, "row_window", rw_mod.row_window_ref),
               (strip_mod, "strip_fill", sf_mod.strip_fill_ref),
               (strip_mod, "band_fill", bf_mod.band_fill_ref)]
    calls, _ = record(lambda: dispatch.run_bucket(q, t, qlen, tlen, sp, "local", None, False,
                                                  dev), targets, every=True)
    keys = [k.split(" #") for k in calls]
    missing = [k for k in SLICE_KERNELS if [k, "1"] not in keys]
    if missing:
        raise AssertionError(f"{label}: no call of {missing}")
    for (key, n), (fn, plain, args, kw, _) in zip(keys, calls.values()):
        kernel_entry(key, fn, plain, args, kw, label=f" ({label}, call {n})")
    say(f"[kernel] {label}: B {len(q)}, {q.shape[1]} x {t.shape[1]}: all {len(calls)} kernel "
        f"calls equal to their plain versions")


def product_chunk(reads, refs, n):
    """The first ``n`` pairs of the product's block of the longest read
    bucket against the longest reference bucket, gathered and padded as
    ``align_all_vs_all`` gathers a chunk: (q, t, qlen, tlen, ii, jj)."""
    from seqalib_tpu_torch.parallel.dispatch import _pad_stack, bucket_len

    Lq = max(bucket_len(len(x)) for x in reads)
    Lt = max(bucket_len(len(x)) for x in refs)
    qi = np.array([i for i, x in enumerate(reads) if bucket_len(len(x)) == Lq])
    rj = np.array([j for j, x in enumerate(refs) if bucket_len(len(x)) == Lt])
    flat = np.arange(min(n, len(qi) * len(rj)))
    ii, jj = qi[flat // len(rj)], rj[flat % len(rj)]
    q = _pad_stack([reads[i] for i in ii], Lq)
    t = _pad_stack([refs[j] for j in jj], Lt)
    qlen = np.array([len(reads[i]) for i in ii], np.int32)
    tlen = np.array([len(refs[j]) for j in jj], np.int32)
    return q, t, qlen, tlen, ii, jj


def config2_bucket(dev):
    """The CLI's config-2 pairs (``bench 2 --pairs BENCH_PAIRS``, seed 0) of
    its fullest length bucket, padded as ``dispatch_batch`` pads them."""
    from seqalib_tpu_torch import cli
    from seqalib_tpu_torch.parallel.dispatch import _pad_stack, bucket_len

    args = argparse.Namespace(pairs=BENCH_PAIRS, backend="strip", device=dev)
    sp, qs, ts = cli._bench_setup(args, 2, np.random.default_rng(0))[:3]
    buckets = {}
    for i, (q, t) in enumerate(zip(qs, ts)):
        buckets.setdefault((bucket_len(len(q)), bucket_len(len(t))), []).append(i)
    (Lq, Lt), idx = max(buckets.items(), key=lambda kv: (len(kv[1]), kv[0]))
    return (_pad_stack([qs[i] for i in idx], Lq), _pad_stack([ts[i] for i in idx], Lt),
            np.array([len(qs[i]) for i in idx], np.int32),
            np.array([len(ts[i]) for i in idx], np.int32), sp)


def kernel_phase1(q, t, sp, dev):
    """Config 1's ``strip_walk`` call, held against its plain version."""
    from seqalib_tpu_torch.ops import strip as strip_mod
    from seqalib_tpu_torch.scoring import tables_from_params

    n = np.full(len(q), q.shape[1])
    m = np.full(len(t), t.shape[1])
    tables = tables_from_params(sp, dev)
    calls, _ = record(lambda: strip_mod.strip_bucket(q, t, n, m, tables, mode="global",
                                                     want_tb=True),
                      [(strip_mod, "strip_walk", strip_walk_mod().strip_walk_ref)])
    fn, plain, args, kw, _ = calls["strip_walk"]
    kernel_entry("strip_walk", fn, plain, args, kw, label=" (config 1)")


def kernel_phase4(qs, ts, sp, dev):
    """Config 4's calls: the fill and its pointer mode held against the
    plain version on CMP_DIAGONALS diagonals from a checkpoint, the walk
    on the first super-block it walks."""
    from seqalib_tpu_torch.models import banded as banded_mod
    from seqalib_tpu_torch.ops import band_fill as bf_mod
    from seqalib_tpu_torch.ops import band_walk as bw_mod

    targets = [(banded_mod, "band_fill", bf_mod.band_fill_ref),
               (banded_mod, "band_walk", bw_mod.band_walk_ref)]
    qlen = np.array([len(x) for x in qs])
    tlen = np.array([len(x) for x in ts])
    calls, _ = record(lambda: banded_mod.banded_align_batch(
        np.stack(qs), np.stack(ts), qlen, tlen, sp, BAND4, device=dev), targets)
    per_kernel = {}
    for key in ("band_fill/fill", "band_fill/ptr"):
        fn, _, args, kw, _ = calls[key]
        whole = time_ms(lambda: fn(*args, **kw), 3)
        say(f"[kernel] {key}: whole call, diagonals [{kw['k0']}, {kw['k1']}): "
            f"{whole:.3f} ms, {per_diagonal(kw, whole):.4f} µs per anti-diagonal")
    fn, plain, args, kw, full = calls["band_fill/fill"]
    CK = kw["CK"]
    cg = full["ckpt"].shape[0] // 2
    k0 = cg * CK
    cut = dict(kw, k0=k0, k1=k0 + CMP_DIAGONALS)
    args_cut = args[:6] + (full["ckpt"][cg],) + args[7:]
    per_kernel["band_fill/fill"] = kernel_entry("band_fill/fill", fn, plain, args_cut, cut)
    # resuming from a checkpoint reproduces the whole fill's later ones
    again = fn(*args_cut, **cut)["ckpt"]
    if not bool((again == full["ckpt"][cg: cg + again.shape[0]]).all()):
        raise AssertionError("band_fill/fill: a resumed fill differs from the whole fill")
    fn, plain, args, kw, _ = calls["band_fill/ptr"]
    cut = dict(kw, k1=kw["k0"] + CMP_DIAGONALS)
    per_kernel["band_fill/ptr"] = kernel_entry("band_fill/ptr", fn, plain, args, cut)
    fn, plain, args, kw, _ = calls["band_walk"]
    per_kernel["band_walk"] = kernel_entry("band_walk", fn, plain, args, kw)
    return per_kernel


def kernel_phase_sp(q, t, q16, t16, qo, to, sp, dev):
    """The SP path's tile launches on a mesh of one card: the runs of
    ``align_sp`` on (q, t) (global, the block's 32 tiles) and of the local
    score on (q16, t16) (64 tiles), and the first pointer batch of the
    walk, each held against the plain version on its first SP_CUT_ROWS
    rows and SP_CUT_TILES tiles (SP_CUT_BATCH of the batch: the plain
    version takes one Python step per substep of every tile) and timed
    whole as well; and the one-tile launches of (qo, to) with tiles of
    SP_ONE_C columns, held whole."""
    from seqalib_tpu_torch.ops import sp_tile as tile_mod
    from seqalib_tpu_torch.parallel import band_pipeline as bp_mod

    targets = [(bp_mod, "sp_tile_run", tile_mod.sp_tile_run_ref),
               (bp_mod, "sp_tile_ptr", tile_mod.sp_tile_ptr_ref)]
    mesh = (dev,)
    calls = {}
    for run in (lambda: bp_mod.nw_affine_align_sp(q, t, sp, mesh, C=SP_C),
                lambda: bp_mod.sw_affine_score_sp(q16, t16, sp, mesh, C=SP_C),
                lambda: bp_mod.nw_affine_align_sp(qo, to, sp, mesh, C=SP_ONE_C),
                lambda: bp_mod.sw_affine_score_sp(qo, to, sp, mesh, C=SP_ONE_C)):
        more, _ = record(run, targets)
        calls.update({k: v for k, v in more.items() if k not in calls})
    per_kernel = {}
    Rc = SP_CUT_ROWS
    for key in ("sp_tile/run_global", "sp_tile/run_local", "sp_tile/ptr_batch"):
        fn, plain, args, kw, _ = calls[key]
        whole = time_ms(lambda: fn(*args, **kw), 3)
        qb, tk, htop, ftop, hcol, ecol, cap, tab = args
        C = kw["C"]
        if key == "sp_tile/ptr_batch":  # tiles 0 .. SP_CUT_BATCH - 1: the rightmost
            K = htop.shape[0]
            Kc = min(K, SP_CUT_BATCH)
            cut = (qb[:Rc], tk[(K - Kc) * C:], htop[:Kc], ftop[:Kc], hcol[:Kc, :Rc],
                   ecol[:Kc, :Rc], cap, tab)
            shape = f"{K} tiles x {qb.shape[0]} rows x {C}"
        else:
            W = SP_CUT_TILES * C
            cut = (qb[:Rc], tk[:W + 1], htop[:W + 1], ftop[:W], hcol[:Rc], ecol[:Rc], cap,
                   tab)
            shape = f"{qb.shape[0]} rows x {ftop.shape[0] // C} tiles of {C}"
        per_kernel[key] = kernel_entry(key, fn, plain, cut, kw)
        say(f"[kernel] {key}: whole call ({shape}, i0={kw['i0']}, j0={kw['j0']}): "
            f"{whole:.3f} ms; held on {Rc} rows")
    for key in ("sp_tile/global", "sp_tile/local", "sp_tile/ptr"):
        fn, plain, args, kw, _ = calls[key]
        per_kernel[key] = kernel_entry(key, fn, plain, args, kw)
        say(f"[kernel] {key}: one tile of {args[0].shape[0]} rows x {kw['C']}")
    return per_kernel


def sp_cell_pair():
    """A pair at the benchmark cell ``long_pair_sp.cigar``'s shape: SP_CELL_N
    random letters against a copy with 2% substitutions, then a 7-letter
    deletion, a 5-letter insertion and a 1-letter deletion at drawn places
    (a generator of its own, so the other phases' pairs stay as they were)."""
    rng = np.random.default_rng(SEED + 1)
    q = rng.integers(0, 4, SP_CELL_N).astype(np.int32)
    t = q.copy()
    idx = rng.choice(SP_CELL_N, SP_CELL_N // 50, replace=False)
    t[idx] = (t[idx] + 1 + rng.integers(0, 3, len(idx))) % 4
    for op, k in (("delete", 7), ("insert", 5), ("delete", 1)):
        at = int(rng.integers(0, len(t) - k))
        t = (np.delete(t, np.arange(at, at + k)) if op == "delete"
             else np.insert(t, at, rng.integers(0, 4, k)))
    return q, t.astype(np.int32)


def sp_walk_view(out):
    """``sp_walk``'s output without its undefined tail: the header and the
    ops walked."""
    import torch
    from seqalib_tpu_torch.ops.sp_walk import HEADER_BYTES

    return out[:HEADER_BYTES + int(out[:HEADER_BYTES].view(torch.int32)[3])]


def kernel_phase_sp_walk(sp, dev):
    """``sp_walk`` at the benchmark cell's shape: each batch one ``align_sp``
    call of ``sp_cell_pair()`` walks (a mesh of one card, tiles of SP_CELL_C
    columns), held against its plain version (which copies the batch to the
    host and walks it there) and timed: the wrapper by CUDA events, the
    kernel alone under ``torch.profiler``, per op walked; the bound, one
    32-byte sector per op walked plus the header and ops written.  The entry
    sums the call's batches."""
    from seqalib_tpu_torch.ops import sp_walk as walk_mod
    from seqalib_tpu_torch.parallel import band_pipeline as bp_mod

    q, t = sp_cell_pair()
    calls, res = record(lambda: bp_mod.nw_affine_align_sp(q, t, sp, (dev,), C=SP_CELL_C),
                        [(bp_mod, "sp_walk", walk_mod.sp_walk_ref)], every=True)
    total = dict(max_abs_err=0, ms=0.0, plain_ms=0.0, bound_ms=0.0, alone_ms=0.0, ops=0)
    for key in sorted(calls, key=lambda k: int(k.split("#")[1])):
        fn, plain, args, kw, _ = calls[key]
        stats, out = check_kernel(f"{key} ({len(q)} x {len(t)})", lambda: fn(*args, **kw),
                                  lambda: plain(*args, **kw), sp_walk_view)
        n = sp_walk_view(out).numel() - walk_mod.HEADER_BYTES
        nbytes = SECTOR_BYTES * n + walk_mod.HEADER_BYTES + n
        alone = kernel_split(lambda: fn(*args, **kw), ("sp_walk_kernel",))["sp_walk_kernel"]
        K, C, rows = args[0].shape
        say(f"[kernel] {key}: batch of {K} tiles x {C} x {rows} rows from ({args[1]}, "
            f"{args[2]}); {n} ops walked; kernel alone "
            + ("not measured" if alone is None else
               f"{alone:.4f} ms, {alone * 1e6 / max(1, n):.1f} ns per op")
            + f"; wrapper {stats['ms']:.4f} ms; bound {nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms")
        for k in ("ms", "plain_ms"):
            total[k] += stats[k]
        total["bound_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
        total["alone_ms"] += alone or 0.0
        total["ops"] += n
    say(f"[kernel] sp_walk: a call of {len(calls)} walks, {total['ops']} ops: wrapper "
        f"{total['ms']:.4f} ms, kernel alone {total['alone_ms']:.4f} ms "
        f"({total['alone_ms'] * 1e6 / max(1, total['ops']):.1f} ns per op), plain "
        f"{total['plain_ms']:.3f} ms, bound {total['bound_ms']:.6f} ms (bytes); "
        f"score {res.score}")
    return {"sp_walk": dict(total, bound_by="bytes", library_ms=None)}


def ont_reads(rng, B, L):
    """B reads against windows of L letters with the long-read cell's errors:
    4% substitutions, then 2.5% indels of 1-3 letters, 40% of them
    insertions.  (read, window) pairs, padded into (B, *) arrays, and their
    lengths."""
    qs, ts = [], []
    for _ in range(B):
        t = rng.integers(0, 4, L).astype(np.uint8)
        q = t.copy()
        idx = rng.choice(L, L // 25, replace=False)
        q[idx] = (q[idx] + 1 + rng.integers(0, 3, len(idx))) % 4
        pos = np.sort(rng.choice(L - 3, L // 40, replace=False))
        k = rng.integers(1, 4, len(pos))
        ins = rng.random(len(pos)) < 0.4
        keep = np.ones(L, bool)
        for p, n in zip(pos[~ins], k[~ins]):
            keep[p: p + n] = False
        at = np.repeat(pos[ins], k[ins])
        q = np.insert(q, at, rng.integers(0, 4, len(at)).astype(np.uint8))
        qs.append(q[np.insert(keep, at, True)])
        ts.append(t)
    qlen = np.array([len(x) for x in qs])
    tlen = np.array([len(x) for x in ts])
    qa = np.zeros((B, qlen.max()), np.int32)
    ta = np.zeros((B, tlen.max()), np.int32)
    for b in range(B):
        qa[b, : qlen[b]] = qs[b]
        ta[b, : tlen[b]] = ts[b]
    return qa, ta, qlen, tlen


def kernel_phase_band_cigar(sp, dev):
    """``band_cigar`` at the benchmark cell long_read_banded.100kb's shape:
    the joined op blocks of one ``banded_align_batch`` traceback of
    LR_CELL_B reads of ~LR_CELL_L letters, held against its plain version
    (``op_rows_to_cigars`` on the host copy) and timed: the wrapper by CUDA
    events, the kernel alone under ``torch.profiler``; the bound, the op
    bytes read once and nchar and the text written once."""
    from seqalib_tpu_torch.models import banded as banded_mod
    from seqalib_tpu_torch.ops import band_cigar as bc_mod

    qa, ta, qlen, tlen = ont_reads(np.random.default_rng(SEED + 22), LR_CELL_B, LR_CELL_L)
    calls, _ = record(lambda: banded_mod.banded_align_batch(qa, ta, qlen, tlen, sp,
                                                            LR_CELL_BAND, device=dev),
                      [(banded_mod, "band_cigar", bc_mod.band_cigar_ref)])
    fn, plain, args, kw, out = calls["band_cigar"]
    entry = kernel_entry("band_cigar", fn, plain, args, kw)
    ops, nchar = args[0], out[1]
    alone = kernel_split(lambda: fn(*args, **kw), ("band_cigar_kernel",))["band_cigar_kernel"]
    say(f"[kernel] band_cigar: B {ops.shape[0]}, KW {ops.shape[1]}, "
        f"{int((ops != 255).sum())} ops, text {int(nchar.sum())} bytes (longest "
        f"{int(nchar.max())}); kernel alone "
        + ("not measured" if alone is None else f"{alone:.4f} ms")
        + f"; wrapper {entry['ms']:.4f} ms")
    return {"band_cigar": dict(entry, alone_ms=alone)}


def kernel_phase_wide4(q, t, sp, q3, t3, sp3, dev):
    """The wide banded fills: config 4's path on one read against windows
    WIDE_DELTA and WIDE_DELTAS_HELD letters longer (the cluster variant),
    its fill and pointer calls held against the plain version on
    CMP_DIAGONALS diagonals (the fill from its middle checkpoint, the
    pointer recompute from its first diagonal), the whole calls timed; the
    key takes the WIDE_DELTA pair.  Then the scratch variant's fill and
    pointer calls on short pairs at a band of SCRATCH_BAND, and pass 2's
    emode on both variants (``pass2_runs``' calls), each whole call held."""
    from seqalib_tpu_torch.models import banded as banded_mod
    from seqalib_tpu_torch.ops import band_fill as bf_mod
    from seqalib_tpu_torch.ops import strip as strip_mod

    targets = [(banded_mod, "band_fill", bf_mod.band_fill_ref)]
    per_kernel = {}
    tail = np.random.default_rng(SEED + 2).integers(0, 4, max(WIDE_DELTAS_HELD), np.uint8)
    t = np.concatenate([t, tail])  # windows past the pair's own target
    for delta in (WIDE_DELTA, *WIDE_DELTAS_HELD):
        tw = t[: len(q) + delta]
        calls, _ = record(lambda: banded_mod.banded_align_batch(
            q[None], tw[None], np.array([len(q)]), np.array([len(tw)]), sp, BAND4,
            device=dev), targets)
        for key in ("band_fill/wide", "band_fill/wide_ptr"):
            fn, plain, args, kw, full = calls[key]
            whole = time_ms(lambda: fn(*args, **kw), 1)
            if key == "band_fill/wide":
                cg = full["ckpt"].shape[0] // 2
                k0 = cg * kw["CK"]
                args = args[:6] + (full["ckpt"][cg],) + args[7:]
                kw = dict(kw, k0=k0, k1=k0 + CMP_DIAGONALS)
            else:
                kw = dict(kw, k1=kw["k0"] + CMP_DIAGONALS)
            entry = kernel_entry(key, fn, plain, args, kw)
            if delta == WIDE_DELTA:
                per_kernel[key] = entry
            say(f"[kernel] {key}: delta {delta}, Wp {args[6].shape[2]}, geometry (C, S, "
                f"threads) {bf_mod.fill_geometry(args[6].shape[2])}: whole call "
                f"{whole:.3f} ms over {calls[key][3]['k1'] - calls[key][3]['k0']} diagonals")
    qs, ts = scratch_pairs()
    calls, _ = record(lambda: banded_mod.banded_align_batch(
        qs, ts, np.full(len(qs), SCRATCH_LEN), np.full(len(ts), SCRATCH_LEN), sp,
        SCRATCH_BAND, device=dev), targets)
    for key in ("band_fill/wide_scratch", "band_fill/wide_scratch_ptr"):
        per_kernel[key] = kernel_entry(key, *calls[key][:4])
    for bw, key in ((PASS2_WIDE_BW, "band_fill/wide_emode"),
                    (PASS2_SCRATCH_BW, "band_fill/wide_scratch_emode")):
        calls, _ = record(lambda: pass2_run(q3, t3, sp3, bw, dev),
                          [(strip_mod, "band_fill", bf_mod.band_fill_ref)])
        per_kernel[key] = kernel_entry(key, *calls[key][:4])
    return per_kernel


def scratch_pairs():
    """SCRATCH_PAIRS DNA pairs of SCRATCH_LEN letters (the target the query
    with 4% substitutions): at a band of SCRATCH_BAND, Wp 131 200."""
    rng = np.random.default_rng(SEED + 3)
    qs = rng.integers(0, 4, (SCRATCH_PAIRS, SCRATCH_LEN)).astype(np.uint8)
    ts = qs.copy()
    ts[:, ::25] = (ts[:, ::25] + 1) % 4
    return qs, ts


def pass2_inputs(q3, t3, bw):
    """Config 3's first PASS2_PAIRS pairs, cut to SCRATCH_LEN letters for
    the scratch variant's band."""
    cut = SCRATCH_LEN if bw > PASS2_WIDE_BW else None
    return [q[:cut] for q in q3[:PASS2_PAIRS]], [t[:cut] for t in t3[:PASS2_PAIRS]]


@contextlib.contextmanager
def env_set(name, value):
    """The environment variable ``name`` set to ``value``, and put back as
    it was (or unset) after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def pass2_run(q3, t3, sp3, bw, dev):
    """Local ``align_batch`` with CIGARs on ``pass2_inputs`` under
    SEQALIB_FUSED_BW=bw: pass 2's banded engine over Wp = ceil128(bw + 2)."""
    import seqalib_tpu_torch as st

    qs, ts = pass2_inputs(q3, t3, bw)
    with env_set("SEQALIB_FUSED_BW", str(bw)):
        return st.align_batch(qs, ts, scoring=sp3, mode="local", device=dev)


def wide_variant_runs(q3, t3, sp3, sp4, dev, counts):
    """The entry points through the wide variants' other instances, each
    counted as a path: pass 2 under a band of PASS2_WIDE_BW (the cluster
    emode) and PASS2_SCRATCH_BW (the scratch emode), and config 4's route
    at a band of SCRATCH_BAND (the scratch fill and pointer modes); every
    result equal to the oracle's."""
    import seqalib_tpu_torch as st
    from seqalib_tpu_torch.ops import launches, reset_launches

    for bw, path in ((PASS2_WIDE_BW, "pass2_wide"), (PASS2_SCRATCH_BW, "pass2_scratch")):
        reset_launches()
        got = pass2_run(q3, t3, sp3, bw, dev)
        counts[path] = dict(launches)
        qs, ts = pass2_inputs(q3, t3, bw)
        want = st.align_batch(qs, ts, scoring=sp3, mode="local", backend="oracle")
        for b, (g, w) in enumerate(zip(got, want)):
            if str(g) != str(w):
                raise AssertionError(f"{path} pair {b}: {g} != oracle {w}")
        say(f"[{path}] SEQALIB_FUSED_BW={bw}: {len(qs)}/{len(qs)} local pairs equal to the "
            "oracle")
    qs, ts = scratch_pairs()
    reset_launches()
    got = st.align_batch(list(qs), list(ts), scoring=sp4, mode="global", band=SCRATCH_BAND,
                         device=dev)
    counts["config4_scratch"] = dict(launches)
    want = st.align_batch(list(qs), list(ts), scoring=sp4, mode="global", band=SCRATCH_BAND,
                          backend="oracle")
    for b, (g, w) in enumerate(zip(got, want)):
        if str(g) != str(w):
            raise AssertionError(f"config4_scratch pair {b}: {g} != oracle {w}")
    say(f"[config4_scratch] band {SCRATCH_BAND}: {len(qs)}/{len(qs)} pairs equal to the "
        "banded oracle")


def kernel_phase_wide(qs, ts, sp, dev):
    """The wide-table route's fills, pointer and score-only, and its walk
    at the phase's shapes."""
    import seqalib_tpu_torch as st
    from seqalib_tpu_torch.ops import wavefront as wf_mod
    from seqalib_tpu_torch.ops.wavefront_walk import wavefront_walk_ref

    targets = [(wf_mod, "wavefront_fill", wf_mod.wavefront_fill_ref),
               (wf_mod, "wavefront_walk", wavefront_walk_ref)]
    per_kernel = {}
    for tb in (True, False):
        calls, _ = record(lambda: st.align_batch(qs, ts, scoring=sp, mode="global",
                                                 band=BAND7, traceback=tb, device=dev),
                          targets)
        for key, (fn, plain, args, kw, _) in calls.items():
            per_kernel[key] = kernel_entry(key, fn, plain, args, kw)
    return per_kernel


def kernel_phase_xla(q1, t1, sp1, q3, t3, sp3, dev):
    """The ``"xla"`` route's kernel calls at its shapes, each held against
    its plain version and timed: config 1's bucket (global linear, with
    CIGARs and score-only), config 3's (local affine: pass (a), then the
    window fill and walk of pass (c)) and config 2's fullest bucket (local
    linear, score-only), made as ``align_batch`` makes them
    (``run_bucket(backend="xla")``)."""
    from seqalib_tpu_torch.ops import wavefront as wf_mod
    from seqalib_tpu_torch.ops import wavefront_xla as xla_mod
    from seqalib_tpu_torch.ops.wavefront_walk import wavefront_walk_ref
    from seqalib_tpu_torch.parallel import dispatch

    targets = [(wf_mod, "wavefront_fill", wf_mod.wavefront_fill_ref),
               (xla_mod, "wavefront_fill", wf_mod.wavefront_fill_ref),
               (wf_mod, "wavefront_walk", wavefront_walk_ref)]
    q2, t2, qlen2, tlen2, sp2 = config2_bucket(dev)
    full = lambda x: np.full(len(x), x.shape[1])  # noqa: E731
    buckets = (("config 1", (q1, t1, full(q1), full(t1), sp1, "global", None, True)),
               ("config 1, score-only", (q1, t1, full(q1), full(t1), sp1, "global", None,
                                         False)),
               ("config 3", (q3, t3, full(q3), full(t3), sp3, "local", None, True)),
               ("config 2 bucket", (q2, t2, qlen2, tlen2, sp2, "local", None, False)))
    per_kernel = {}
    for label, args in buckets:
        calls, _ = record(lambda: dispatch.run_bucket(*args, dev, backend="xla"), targets)
        for key, (fn, plain, a, kw, _) in calls.items():
            entry = kernel_entry(key, fn, plain, a, kw, label=f" (xla, {label})")
            if key == "wavefront_fill/ptr":  # unbanded: the pointer strip kernel
                per_kernel.setdefault("wavefront_fill/ptr (unbanded)", entry)
            elif KERNELS.get(key, ("", "", ""))[2].startswith("xla"):
                per_kernel.setdefault(key, entry)
            if key in WINDOW_KERNEL_MS:
                say(f"[kernel] {key} (xla, {label}): strip kernel {entry['ms']:.4f} ms against "
                    f"the window kernel's {WINDOW_KERNEL_MS[key]:.4f} ms before, bound "
                    f"{entry['bound_ms']:.4f} ms by {entry['bound_by']}")
    return per_kernel


def kernel_phase_banded_sp(qs, ts, sp, dev):
    """Phase 8's kernels over a mesh of DSP entries naming the card: the
    first resumed fill of a block d >= 1 (its local rows end before the
    pairs') of the score relay on (qs, ts), a group of GB live pairs; the
    first pointer recompute and the first walk (block d_start) of
    ``align_banded_sp`` on (qs[0], ts[0])."""
    from seqalib_tpu_torch.ops import band_fill as bf_mod
    from seqalib_tpu_torch.ops import band_walk as bw_mod
    from seqalib_tpu_torch.parallel import banded_sp as bsp_mod

    targets = [(bsp_mod, "band_fill", bf_mod.band_fill_ref),
               (bsp_mod, "band_walk", bw_mod.band_walk_ref)]
    n = min(len(q) for q in qs)
    lower = lambda args, kw: "bh" not in kw or int(args[2].max()) < n  # noqa: E731
    relay, _ = record(lambda: bsp_mod.banded_nw_affine_score_sp(
        qs, ts, sp, BANDSP, (dev,) * DSP), targets, lower)
    calls, _ = record(lambda: bsp_mod.banded_nw_affine_align_sp(
        qs[0], ts[0], sp, BANDSP, (dev,) * DSP), targets, lower)
    calls["band_fill/relay"] = relay["band_fill/relay"]
    live = int((calls["band_fill/relay"][2][2] > 0).sum())
    if live != bsp_mod.GB:
        raise AssertionError(f"band_fill/relay: {live} live pairs of {bsp_mod.GB}")
    per_kernel = {}
    for key in ("band_fill/relay", "band_fill/relay_ptr"):
        fn, plain, args, kw, _ = calls[key]
        whole = time_ms(lambda: fn(*args, **kw), 3)
        k2 = 2 * kw["bout_row"] - RELAY_CUT // 2  # the capture of row R starts at 2R
        # the kernel's own state entering diagonal k2
        state = fn(*args, **dict(kw, k1=k2, want_bout=False))["state"]
        cuts = [(args, dict(kw, k1=RELAY_CUT)),
                (args[:6] + (state,) + args[7:], dict(kw, k0=k2, k1=k2 + RELAY_CUT))]
        for n_cut, (a, k) in enumerate(cuts):
            entry = kernel_entry(key, fn, plain, a, k)
            if n_cut == 0:
                per_kernel[key] = entry
            else:  # the key keeps the injection cut's numbers; both are printed
                if entry["max_abs_err"] != 0:
                    raise AssertionError(f"{key}: the capture cut differs")
            say(f"[kernel] {key}: diagonals [{k['k0']}, {k['k1']}) of block "
                f"({kw['K']} diagonals, Wp {args[6].shape[2]}); whole block {whole:.3f} ms, "
                f"{per_diagonal(kw, whole):.4f} µs per anti-diagonal")
    fn, plain, args, kw, _ = calls["band_walk/floor"]
    whole = time_ms(lambda: fn(*args, **kw), 3)
    ptr = args[0]
    top = fn(ptr[WALK_CUT // 2:], *args[1:], **dict(kw, k0=WALK_CUT))
    cut = (ptr[: WALK_CUT // 2], *top[1:])
    per_kernel["band_walk/floor"] = kernel_entry("band_walk/floor", fn, plain, cut, kw)
    say(f"[kernel] band_walk/floor: the lowest {WALK_CUT} of {2 * ptr.shape[0]} diagonals; "
        f"whole block {whole:.3f} ms")
    return per_kernel


# ---- end-to-end runs ------------------------------------------------------


def timed_runs(run, reps=REPS):
    """One warm-up call, then ``reps`` timed calls; (results, walls)."""
    import torch

    run()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return res, walls


def runs_in_turns(runs, reps=REPS):
    """One warm-up call of each of ``runs`` (name -> 0-arg call), then
    ``reps`` rounds of one timed call each, the order rotated every round so
    that no run always goes first; {name: (results, walls)}."""
    import torch

    names = list(runs)
    res = {k: runs[k]() for k in names}
    walls = {k: [] for k in names}
    for r in range(reps):
        for k in names[r % len(names):] + names[: r % len(names)]:
            t0 = time.perf_counter()
            res[k] = runs[k]()
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
    return {k: (res[k], walls[k]) for k in names}


def config_run(name, qs, ts, sp, mode, dev, want=None):
    """Warm ``align_batch`` runs: times, rates and an oracle check of
    N_ORACLE sampled pairs (``want``: their oracle results, if known)."""
    import seqalib_tpu_torch as st

    res, walls = timed_runs(lambda: st.align_batch(qs, ts, scoring=sp, mode=mode,
                                                   traceback=True, device=dev))
    wall = statistics.median(walls)
    cells = sum(len(a) * len(b) for a, b in zip(qs, ts))
    say(f"[{name}] B={len(qs)} {mode} wall {wall:.4f} s (reps {walls}); "
        f"{len(qs) / wall:.1f} pairs/s; {cells / wall / 1e9:.3f} GCUPS")
    picks = np.random.default_rng(SEED + 1).choice(len(qs), N_ORACLE, replace=False)
    if want is None:
        want = st.align_batch([qs[b] for b in picks], [ts[b] for b in picks], scoring=sp,
                              mode=mode, backend="oracle")
    for b, w in zip(picks, want):
        if str(res[b]) != str(w):
            raise AssertionError(f"{name} pair {b}: {res[b]} != oracle {w}")
    say(f"[{name}] {N_ORACLE}/{N_ORACLE} pairs equal to the oracle")
    return want


def rescore(q, t, cigar, table, go, ge):
    """Score of ``cigar`` aligning q to t under affine gaps, and the
    lengths it consumes."""
    i = j = score = 0
    for n, op in re.findall(r"(\d+)([MID])", cigar):
        n = int(n)
        if op == "M":
            score += int(table[q[i: i + n], t[j: j + n]].sum())
            i += n
            j += n
        else:
            score += go + n * ge
            i += n if op == "I" else 0
            j += n if op == "D" else 0
    return score, i, j


def check_cigars(name, qs, ts, res, sp):
    table = sp.substitution_matrix().astype(np.int64)
    for b, (q, t, r) in enumerate(zip(qs, ts, res)):
        score, i, j = rescore(q, t, r.cigar, table, sp.gap_open, sp.gap_extend)
        if (i, j) != (len(q), len(t)) or score != r.score:
            raise AssertionError(f"{name} pair {b}: CIGAR consumes ({i}, {j}) of "
                                 f"({len(q)}, {len(t)}) and scores {score} != {r.score}")


def long_reads(rng, B, L):
    """Config 4's pairs: t is q with L // 50 substitutions."""
    qs, ts = [], []
    for _ in range(B):
        q = rng.integers(0, 4, L).astype(np.uint8)
        t = q.copy()
        idx = rng.choice(L, L // 50, replace=False)
        t[idx] = (t[idx] + 1 + rng.integers(0, 3, len(idx))) % 4
        qs.append(q)
        ts.append(t.astype(np.uint8))
    return qs, ts


def banded_run(name, qs, ts, sp, band, dev, reps):
    import seqalib_tpu_torch as st

    res, walls = timed_runs(lambda: st.align_batch(qs, ts, scoring=sp, mode="global",
                                                   band=band, traceback=True, device=dev),
                            reps)
    wall = statistics.median(walls)
    cells = sum(len(q) * 2 * band for q in qs)
    say(f"[{name}] B={len(qs)} L={len(qs[0])} band={band} wall {wall:.4f} s "
        f"(reps {walls}); {len(qs) / wall:.2f} pairs/s; {cells / wall / 1e9:.3f} "
        f"GCUPS(n*w)")
    check_cigars(name, qs, ts, res, sp)
    say(f"[{name}] {len(qs)}/{len(qs)} CIGARs consume their pair and re-score to the score")
    return res


def config4_oracle(qs, ts, sp, band, dev):
    import seqalib_tpu_torch as st

    qc = [q[:1024] for q in qs[:N_ORACLE4]]
    tc = [t[: 1024 + band // 2] for t in ts[:N_ORACLE4]]
    got = st.align_batch(qc, tc, scoring=sp, mode="global", band=band, device=dev)
    want = st.align_batch(qc, tc, scoring=sp, mode="global", band=band, backend="oracle")
    for b, (g, w) in enumerate(zip(got, want)):
        if str(g) != str(w):
            raise AssertionError(f"config4 cut pair {b}: {g} != oracle {w}")
    say(f"[config4] {N_ORACLE4}/{N_ORACLE4} pairs cut to 1024 x {1024 + band // 2} "
        f"equal to the banded oracle")


def sp_pairs(rng):
    """Phase 6's pairs: (q, t) of 10 240 x 8 192 (t is q's first 8 192
    letters with 150 substitutions), a 16 384 x 16 384 pair (2%
    substitutions, three indels) and a SP_ORACLE_N pair (2% substitutions,
    a 12-letter deletion, a 9-letter insertion)."""
    q = rng.integers(0, 4, SP_N).astype(np.int32)
    t = q[:SP_M].copy()
    idx = rng.choice(SP_M, SP_SUBS, replace=False)
    t[idx] = (t[idx] + 1 + rng.integers(0, 3, SP_SUBS)) % 4
    q16 = rng.integers(0, 4, SP_LONG).astype(np.int32)
    t16 = q16.copy()
    idx = rng.choice(SP_LONG, SP_LONG // 50, replace=False)
    t16[idx] = (t16[idx] + 1 + rng.integers(0, 3, len(idx))) % 4
    a, b, c = SP_LONG // 4, SP_LONG * 9 // 16, SP_LONG * 13 // 16
    t16 = np.insert(np.delete(t16, np.arange(a, a + 7)), b, rng.integers(0, 4, 5))
    t16 = np.delete(t16, [c]).astype(np.int32)
    qo = rng.integers(0, 4, SP_ORACLE_N).astype(np.int32)
    to = qo.copy()
    idx = rng.choice(SP_ORACLE_N, SP_ORACLE_N // 50, replace=False)
    to[idx] = (to[idx] + 1 + rng.integers(0, 3, len(idx))) % 4
    a, b = SP_ORACLE_N // 3, SP_ORACLE_N * 2 // 3
    to = np.insert(np.delete(to, np.arange(a, a + 12)), b, rng.integers(0, 4, 9))
    return q, t, q16, t16, qo, to.astype(np.int32)


def wide_pair(rng):
    """A read of L4 letters and a window L4 + 32 400 letters long that holds
    it from letter 8 000 on (2% substitutions): its first L4 + delta letters
    are config 4's long-window pairs."""
    t = rng.integers(0, 4, L4 + WIDE_DELTAS_HELD[-1]).astype(np.uint8)
    q = t[8_000: 8_000 + L4].copy()
    idx = rng.choice(L4, L4 // 50, replace=False)
    q[idx] = (q[idx] + 1 + rng.integers(0, 3, len(idx))) % 4
    return q, t


def walked_tiles(cigar, R, C):
    """The (block, tile) pairs a global walk enters: those of every cell
    (i, j), i, j >= 1, on the CIGAR's path."""
    i = j = 0
    tiles = set()
    for n, op in re.findall(r"(\d+)([MID])", cigar):
        for _ in range(int(n)):
            i += op != "D"
            j += op != "I"
            if i and j:
                tiles.add(((i - 1) // R, (j - 1) // C))
    return tiles


def strip_score(q, t, sp, mode, dev):
    """The strip engine's score for one pair (an independent kernel)."""
    import seqalib_tpu_torch as st

    return st.align_batch([q.astype(np.uint8)], [t.astype(np.uint8)], scoring=sp,
                          mode=mode, traceback=False, device=dev)[0].score


def sp_runs(q, t, q16, t16, qo, to, sp, dev, counts):
    """Phase 6: ``align_sp`` and ``align_score_sp`` on a mesh of one card."""
    import seqalib_tpu_torch as st
    from seqalib_tpu_torch.ops import reset_launches, launches

    mesh = st.make_band_mesh([dev])
    reset_launches()
    res, walls = timed_runs(lambda: st.align_sp(q, t, sp, mesh, C=SP_C))
    counts["sp_align"] = dict(launches)
    wall = statistics.median(walls)
    say(f"[sp] align_sp {len(q)} x {len(t)} C={SP_C} wall {wall:.4f} s (reps {walls}); "
        f"{len(q) * len(t) / wall / 1e9:.3f} GCUPS")
    want = strip_score(q, t, sp, "global", dev)
    check_cigars("sp", [q], [t], [res], sp)
    if res.score != want:
        raise AssertionError(f"align_sp score {res.score} != strip engine {want}")
    walked = len(walked_tiles(res.cigar, len(q), SP_C))
    ptr_launches = counts["sp_align"]["sp_tile/ptr_batch"] / (REPS + 1)
    say(f"[sp] align_sp: {ptr_launches} pointer launches per call for {walked} tiles walked; "
        f"{counts['sp_align']['sp_tile/run_global'] / (REPS + 1)} fill launches per call")
    if not ptr_launches < walked or counts["sp_align"]["sp_tile/ptr"]:
        raise AssertionError("align_sp: the pointer recompute is not batched")
    if counts["sp_align"]["sp_walk"] != counts["sp_align"]["sp_tile/ptr_batch"]:
        raise AssertionError("align_sp: not one walk on the card a pointer batch")
    four = st.align_sp(q, t, sp, st.make_band_mesh([dev] * 4), C=SP_C)
    if str(four) != str(res):
        raise AssertionError(f"align_sp on a mesh of 4: {four} != {res}")
    say(f"[sp] align_sp score {res.score} == strip engine; the CIGAR consumes the pair "
        f"and re-scores to it; a mesh of 4 gives the same result")
    want = st.align(qo, to, scoring=sp, mode="global", backend="oracle")
    for D in (1, 4):
        got = st.align_sp(qo, to, sp, st.make_band_mesh([dev] * D), C=SP_C)
        if str(got) != str(want):
            raise AssertionError(f"align_sp on a mesh of {D}: {got} != oracle {want}")
    say(f"[sp] align_sp {len(qo)} x {len(to)} equals the oracle on meshes of 1 and 4")
    reset_launches()
    got, _ = timed_runs(lambda: st.align_sp(qo, to, sp, mesh, C=SP_ONE_C))
    local, _ = timed_runs(lambda: st.align_score_sp(qo, to, sp, mesh, mode="local",
                                                    C=SP_ONE_C))
    counts["sp_one_tile"] = dict(launches)
    wantl = strip_score(qo, to, sp, "local", dev)
    if str(got) != str(want) or local != wantl:
        raise AssertionError(f"align_sp with one tile: {got} / local {local} != oracle "
                             f"{want} / strip engine {wantl}")
    say(f"[sp] one tile of {SP_ONE_C} columns: align_sp equals the oracle, the local "
        f"score {local} the strip engine's")
    for mode, path in (("global", "sp_score"), ("local", "sp_local")):
        reset_launches()
        got, walls = timed_runs(lambda: st.align_score_sp(q16, t16, sp, mesh, mode=mode,
                                                          C=SP_C))
        counts[path] = dict(launches)
        if sum(v for k, v in launches.items() if k.startswith("sp_tile/")) != REPS + 1:
            raise AssertionError(f"align_score_sp {mode}: not one tile launch per call")
        wall = statistics.median(walls)
        say(f"[sp] align_score_sp {mode} {len(q16)} x {len(t16)} wall {wall:.4f} s "
            f"(reps {walls}); {len(q16) * len(t16) / wall / 1e9:.3f} GCUPS")
        t0 = time.perf_counter()
        want = strip_score(q16, t16, sp, mode, dev)
        if got != want:
            raise AssertionError(f"align_score_sp {mode} {got} != strip engine {want}")
        say(f"[sp] {mode} score {got} == strip engine ({time.perf_counter() - t0:.1f} s)")


def wide_pairs(rng):
    """Phase 7's pairs: proteins of L7 letters, the target the query with
    5% substitutions, a 3-letter deletion and a 2-letter insertion."""
    qs, ts = [], []
    for _ in range(B7):
        q = rng.integers(0, 20, L7).astype(np.uint8)
        t = q.copy()
        idx = rng.choice(L7, L7 // 20, replace=False)
        t[idx] = (t[idx] + 1 + rng.integers(0, 19, len(idx))) % 20
        a, b = sorted(rng.choice(np.arange(50, L7 - 50), 2, replace=False))
        t = np.insert(np.delete(t, [a, a + 1, a + 2]), b, rng.integers(0, 20, 2))
        qs.append(q)
        ts.append(t.astype(np.uint8))
    return qs, ts


def wide_runs(qs, ts, sp2, sp1, dev, counts):
    """Phase 7: the wide-table banded route, full CIGAR then score-only."""
    import seqalib_tpu_torch as st
    from seqalib_tpu_torch.ops import reset_launches, launches

    cells = sum(len(q) * 2 * BAND7 for q in qs)
    out = {}
    for tb, path in ((True, "wide"), (False, "wide_score")):
        reset_launches()
        res, walls = timed_runs(lambda: st.align_batch(qs, ts, scoring=sp2, mode="global",
                                                       band=BAND7, traceback=tb, device=dev))
        counts[path] = dict(launches)
        wall = statistics.median(walls)
        say(f"[{path}] B={len(qs)} L={L7} band={BAND7} traceback={tb} wall {wall:.4f} s "
            f"(reps {walls}); {len(qs) / wall:.2f} pairs/s; {cells / wall / 1e9:.3f} "
            f"GCUPS(n*w)")
        out[tb] = res
    if [r.score for r in out[False]] != [r.score for r in out[True]]:
        raise AssertionError("wide: score-only scores differ from the full run's")
    check_cigars("wide", qs, ts, out[True], sp2)
    ref = st.align_batch(qs, ts, scoring=sp1, mode="global", band=BAND7, device=dev)
    for b, (x, y) in enumerate(zip(ref, out[True])):
        if (2 * x.score, str(x).split(" ", 1)[1]) != (y.score, str(y).split(" ", 1)[1]):
            raise AssertionError(f"wide pair {b}: {y} is not 2 x the banded route's {x}")
    say(f"[wide] {len(qs)}/{len(qs)} results equal the BLOSUM62 banded route's "
        f"(band_fill) with the score doubled; every CIGAR re-scores to its score")
    want = st.align_batch(qs[:N_ORACLE4], ts[:N_ORACLE4], scoring=sp2, mode="global",
                          band=BAND7, backend="oracle")
    for b, (g, w) in enumerate(zip(out[True], want)):
        if str(g) != str(w):
            raise AssertionError(f"wide pair {b}: {g} != oracle {w}")
    say(f"[wide] {N_ORACLE4}/{N_ORACLE4} pairs equal to the banded oracle")
    wide_launch_checks(qs, ts, sp2, dev, out)


def wide_launch_checks(qs, ts, sp, dev, out):
    """Phase 7's bucket: its launch half (``run_bucket(launch_only=True)``,
    with and without CIGARs) makes no device-to-host sync and its finalize
    equals ``out`` (the phase's results); no ``.cpu()`` of a call with
    CIGARs copies as much as the pointer stream."""
    import torch

    import seqalib_tpu_torch as st
    from seqalib_tpu_torch.parallel import dispatch

    Lq = max(dispatch.bucket_len(len(x)) for x in qs)
    Lt = max(dispatch.bucket_len(len(x)) for x in ts)
    q, t = dispatch._pad_stack(qs, Lq), dispatch._pad_stack(ts, Lt)
    qlen = np.array([len(x) for x in qs])
    tlen = np.array([len(x) for x in ts])
    for tb in (True, False):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            finish = dispatch.run_bucket(q, t, qlen, tlen, sp, "global", BAND7, tb, dev,
                                         launch_only=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        res = finish()
        got = [f"score={res['score'][b]} q[{res['qs'][b]}:{res['qe'][b]}] "
               f"t[{res['ts'][b]}:{res['te'][b]}] {res['cigars'][b] if tb else ''}"
               for b in range(len(qs))]
        if got != [str(r) for r in out[tb]]:
            raise AssertionError(f"wide: the sync-free launch (traceback={tb}) differs")
    say("[wide] the launch half of the bucket, with and without CIGARs, made no "
        "device-to-host sync; its finalize equals align_batch's")
    copied = []
    real_cpu = torch.Tensor.cpu

    def counted_cpu(self, *a, **k):
        copied.append(self.numel() * self.element_size() if self.is_cuda else 0)
        return real_cpu(self, *a, **k)

    torch.Tensor.cpu = counted_cpu
    try:
        st.align_batch(qs, ts, scoring=sp, mode="global", band=BAND7, device=dev)
    finally:
        torch.Tensor.cpu = real_cpu
    stream = (Lq + Lt + 1) * len(qs) * (-(-(Lq + 1) // 128) * 128)
    if max(copied, default=0) >= stream:
        raise AssertionError(f"wide: a .cpu() copied {max(copied)} bytes, the stream's size")
    say(f"[wide] one call with CIGARs: {len(copied)} .cpu() copies of device tensors, the "
        f"largest {max(copied, default=0)} bytes (the pointer stream: {stream} bytes, "
        f"walked on the card)")


def xla_runs(dev, card, counts, cfg1, cfg3, wide, want1, want3):
    """Phase 11: ``backend="xla"`` (the full-matrix wavefront route) at full
    width: config 1 with CIGARs and score-only, config 3, config 2's pairs
    (score-only) and phase 7's batch with BLOSUM62 o=-10 e=-1 at band 64
    (``band_fill`` under ``"pallas"``, kernel 7 under ``"xla"``).  Each run
    timed (1 warm-up + REPS), its launch counts read, every result equal to
    ``backend="pallas"``'s and N_ORACLE sampled pairs to the oracle."""
    import seqalib_tpu_torch as st
    from seqalib_tpu_torch import cli
    from seqalib_tpu_torch.ops import launches, reset_launches

    (q1, t1, sp1), (q3, t3, sp3), (qs7, ts7) = cfg1, cfg3, wide
    args = argparse.Namespace(pairs=BENCH_PAIRS, backend="xla", device=dev)
    sp2, qs2, ts2 = cli._bench_setup(args, 2, np.random.default_rng(0))[:3]
    runs = (  # path, pairs, scoring, mode, band, traceback, the picks' oracle results
        ("xla_config1", list(q1), list(t1), sp1, "global", None, True, want1),
        ("xla_config1_score", list(q1), list(t1), sp1, "global", None, False, want1),
        ("xla_config3", list(q3), list(t3), sp3, "local", None, True, want3),
        ("xla_config2", qs2, ts2, sp2, "local", None, False, None),
        ("xla_banded", qs7, ts7, sp3, "global", BAND7, True, None))
    fields = lambda r: (r.score, r.query_start, r.query_end, r.target_start,  # noqa: E731
                        r.target_end)
    for path, qs, ts, sp, mode, band, tb, want in runs:
        kw = dict(scoring=sp, mode=mode, band=band, traceback=tb)
        reset_launches()
        res, walls = timed_runs(lambda: st.align_batch(qs, ts, backend="xla", device=dev,
                                                       **kw))
        counts[path] = dict(launches)
        wall = statistics.median(walls)
        cells = sum(len(q) * (2 * band if band else len(t)) for q, t in zip(qs, ts))
        say(f"[{path}] B={len(qs)} {mode} band={band} traceback={tb} wall {wall!r} s (reps "
            f"{walls}); {len(qs) / wall:.1f} pairs/s; {cells / wall / 1e9:.3f} "
            f"GCUPS{'(n*w)' if band else ''} ({card})")
        say(f"[launches] {path} (1 warm-up + {REPS} timed calls): "
            f"{ {k: v for k, v in counts[path].items() if v} }")
        pallas = st.align_batch(qs, ts, backend="pallas", device=dev, **kw)
        bad = [b for b, (g, w) in enumerate(zip(res, pallas)) if str(g) != str(w)]
        if len(res) != len(pallas) or bad:
            raise AssertionError(f"{path}: pairs {bad[:5]} differ from backend='pallas'")
        picks = np.random.default_rng(SEED + 1).choice(len(qs), N_ORACLE, replace=False)
        if want is None:
            want = st.align_batch([qs[b] for b in picks], [ts[b] for b in picks],
                                  scoring=sp, mode=mode, band=band, backend="oracle")
        for b, w in zip(picks, want):
            if (str(res[b]) != str(w)) if tb else (fields(res[b]) != fields(w)):
                raise AssertionError(f"{path} pair {b}: {res[b]} != oracle {w}")
        say(f"[{path}] {len(res)}/{len(res)} results equal backend='pallas' results; "
            f"{N_ORACLE}/{N_ORACLE} sampled pairs equal the oracle"
            + ("" if tb else " (score and coordinates)"))


def banded_sp_pairs():
    """Phase 8's pairs, from their own generator: BSP long reads of LSP
    letters (config 4's), BSP_ORACLE_N DNA pairs of 600-1000 letters with
    2% substitutions and an indel run of up to 20 letters (the first pair
    empty), and a protein pair of BSP_PROTEIN_N letters (5% substitutions,
    a 4-letter deletion)."""
    rng = np.random.default_rng(SEED + 8)
    qs, ts = long_reads(rng, BSP, LSP)
    qo, to = [np.zeros(0, np.uint8)], [rng.integers(0, 4, 5).astype(np.uint8)]
    for _ in range(BSP_ORACLE_N - 1):
        L = int(rng.integers(600, 1001))
        q = rng.integers(0, 4, L).astype(np.uint8)
        t = q.copy()
        idx = rng.choice(L, L // 50, replace=False)
        t[idx] = (t[idx] + 1 + rng.integers(0, 3, len(idx))) % 4
        a, g = int(rng.integers(100, L - 100)), int(rng.integers(-20, 21))
        t = (np.delete(t, np.arange(a, a - g)) if g < 0
             else np.insert(t, a, rng.integers(0, 4, g))).astype(np.uint8)
        qo.append(q)
        to.append(t)
    qp = rng.integers(0, 20, BSP_PROTEIN_N).astype(np.uint8)
    tp = qp.copy()
    idx = rng.choice(BSP_PROTEIN_N, BSP_PROTEIN_N // 20, replace=False)
    tp[idx] = (tp[idx] + 1 + rng.integers(0, 19, len(idx))) % 20
    a = BSP_PROTEIN_N // 2
    tp = np.delete(tp, np.arange(a, a + 4)).astype(np.uint8)
    return qs, ts, qo, to, qp, tp


def banded_sp_runs(qs, ts, qo, to, qp, tp, sp, spp, dev, counts):
    """Phase 8: the banded-SP score relay and align on meshes naming the
    card, against the single-device banded route and the oracle."""
    import seqalib_tpu_torch as st
    from seqalib_tpu_torch.ops import reset_launches, launches
    from seqalib_tpu_torch.parallel import banded_sp as bsp_mod

    mesh4 = st.make_band_mesh([dev] * DSP)
    geom, _ = bsp_mod._sp_setup(qs, ts, sp, BANDSP, mesh4, 512)
    say(f"[banded_sp] geometry: R {geom['R']}, Dband {geom['Dband']}, Wp {geom['Wp']}, "
        f"Kloc {geom['Kloc']}, {geom['NG']} relay groups, "
        f"{geom['NG'] + DSP - 1} super-steps")
    cells = sum(len(q) * 2 * BANDSP for q in qs)
    reset_launches()
    got, walls = timed_runs(lambda: st.align_score_banded_sp(qs, ts, sp, BANDSP, mesh4))
    counts["banded_sp_score"] = dict(launches)
    wall = statistics.median(walls)
    say(f"[banded_sp] align_score_banded_sp B={len(qs)} L={LSP} band={BANDSP} mesh of "
        f"{DSP}: wall {wall:.4f} s (reps {walls}); {len(qs) / wall:.2f} pairs/s; "
        f"{cells / wall / 1e9:.3f} GCUPS(n*w)")
    want = st.align_batch(qs, ts, scoring=sp, mode="global", band=BANDSP, traceback=False,
                          device=dev)
    if got != [r.score for r in want]:
        raise AssertionError(f"banded SP scores {got} != align_batch(band=) "
                             f"{[r.score for r in want]}")
    say(f"[banded_sp] {len(qs)}/{len(qs)} scores equal align_batch(band={BANDSP})")
    res = {}
    for D in (DSP, 1):
        reset_launches()
        res[D], walls = timed_runs(lambda: st.align_banded_sp(
            qs[0], ts[0], sp, BANDSP, st.make_band_mesh([dev] * D)))
        if D == DSP:
            counts["banded_sp_align"] = dict(launches)
        wall = statistics.median(walls)
        say(f"[banded_sp] align_banded_sp L={LSP} band={BANDSP} mesh of {D}: wall "
            f"{wall:.4f} s (reps {walls}); {len(qs[0]) * 2 * BANDSP / wall / 1e9:.3f} "
            f"GCUPS(n*w)")
    check_cigars("banded_sp", qs[:1], ts[:1], [res[DSP]], sp)
    ref = st.align_batch(qs[:1], ts[:1], scoring=sp, mode="global", band=BANDSP,
                         device=dev)[0]
    if not str(res[DSP]) == str(res[1]) == str(ref):
        raise AssertionError(f"align_banded_sp: mesh of {DSP} {res[DSP]}, mesh of 1 "
                             f"{res[1]}, align_batch(band=) {ref}")
    say(f"[banded_sp] align_banded_sp: the CIGAR re-scores to {res[DSP].score}; meshes "
        f"of {DSP} and 1 and align_batch(band={BANDSP}) give the same result")
    want = st.align_batch(qo, to, scoring=sp, mode="global", band=BSP_ORACLE_BAND,
                          backend="oracle")
    wantp = st.align(qp, tp, scoring=spp, mode="global", band=BSP_ORACLE_BAND,
                     backend="oracle")
    for D in (1, DSP):
        mesh = st.make_band_mesh([dev] * D)
        got = st.align_banded_sp(qo, to, sp, BSP_ORACLE_BAND, mesh)
        for b, (g, w) in enumerate(zip(got, want)):
            if str(g) != str(w):
                raise AssertionError(f"align_banded_sp pair {b}, mesh of {D}: {g} != "
                                     f"oracle {w}")
        gotp = st.align_banded_sp(qp, tp, spp, BSP_ORACLE_BAND, mesh)
        scorep = st.align_score_banded_sp(qp, tp, spp, BSP_ORACLE_BAND, mesh)
        if str(gotp) != str(wantp) or scorep != wantp.score:
            raise AssertionError(f"BLOSUM62 pair, mesh of {D}: {gotp} / {scorep} != "
                                 f"oracle {wantp}")
    say(f"[banded_sp] {len(qo)} DNA pairs (one empty) and a BLOSUM62 pair of "
        f"{len(qp)} letters, band {BSP_ORACLE_BAND}, equal the oracle on meshes of 1 "
        f"and {DSP}")


def cli_runs(dev, card, counts):
    """Phase 9: ``bench all`` through the CLI, then the all-vs-all checks."""
    import torch

    import seqalib_tpu_torch as st
    from seqalib_tpu_torch import api, cli
    from seqalib_tpu_torch.ops import launches, reset_launches
    from seqalib_tpu_torch.parallel import dispatch

    say("[cli] config 5 cut: 10 000 reads x 100 references (BASELINE.json:11 has 10 000 x "
        "1 000: the references cut to a tenth)")
    products = []
    real_ava, real_one = api.align_all_vs_all, cli._bench_one

    def keep(queries, references, **kw):  # the product's result, for the checks below
        out = real_ava(queries, references, **kw)
        products.append((queries, references, kw, out))
        return out

    def counted(args, cfg):
        reset_launches()
        out = real_one(args, cfg)
        counts[f"bench{cfg}"] = dict(launches)
        return out

    api.align_all_vs_all, cli._bench_one = keep, counted
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(BENCH_ARGS)
    finally:
        api.align_all_vs_all, cli._bench_one = real_ava, real_one
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    for line in lines:
        say(json.dumps(line))
        say(f"[cli] config {line['config']}: {line['pairs']} pairs, wall {line['wall_s']} s, "
            f"{line['pairs_per_sec']} pairs/s, {line['gcups_end_to_end']} GCUPS end to end "
            f"({card})")
    if rc != 0 or [x["config"] for x in lines] != [1, 2, 3, 4, 5] or not all(
            x.get("parity_ok") is True for x in lines):
        raise AssertionError(f"bench all: rc {rc}, lines {lines}")
    say("[cli] bench all: rc 0, every config's parity gate passed")
    if lines[-1]["devices"] != torch.cuda.device_count():
        raise AssertionError(f"bench 5 ran on {lines[-1]['devices']} devices, not on "
                             f"make_pair_mesh()'s {torch.cuda.device_count()}")
    say(f"[cli] bench 5 ran on make_pair_mesh(): \"devices\": {lines[-1]['devices']}")
    for cfg in (2, 5):
        c = counts[f"bench{cfg}"]
        say(f"[launches] bench config {cfg} (warm-up, timed run, parity): "
            f"{ {k: v for k, v in c.items() if v} }")
        missing = [k for k in SLICE_KERNELS if c.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"bench config {cfg} never launched {missing}")

    reads, refs, kw, out = products[-1]
    sp = kw["scoring"]
    rng = np.random.default_rng(SEED + 2)
    ii = rng.integers(len(reads), size=AVALL_SAMPLE)
    jj = rng.integers(len(refs), size=AVALL_SAMPLE)
    want = st.api.align_batch([reads[i] for i in ii], [refs[j] for j in jj], scoring=sp,
                              mode="local", traceback=False, device=dev)
    for i, j, w in zip(ii, jj, want):
        got = tuple(int(out[f][i, j]) for f in ("score", "qs", "qe", "ts", "te"))
        if got != (w.score, w.query_start, w.query_end, w.target_start, w.target_end):
            raise AssertionError(f"config 5 pair ({i}, {j}): {got} != align_batch {w}")
    say(f"[avall] {AVALL_SAMPLE} sampled pairs of the {len(reads)} x {len(refs)} product "
        f"equal align_batch(mode='local', traceback=False)")

    sub_r, sub_f = reads[:RESUME_READS], refs[:RESUME_REFS]
    rkw = dict(scoring=sp, chunk_pairs=RESUME_CHUNK, device=dev)
    base = st.align_all_vs_all(sub_r, sub_f, **rkw)
    tmp = tempfile.mkdtemp(prefix="avall_resume_")
    real_run = dispatch.run_bucket
    try:
        first = st.align_all_vs_all(sub_r, sub_f, resume_dir=tmp, **rkw)
        shards = len(os.listdir(tmp))

        def refuse(*a, **k):
            raise AssertionError("a resumed product realigned a finished chunk")

        dispatch.run_bucket = refuse
        try:
            second = st.align_all_vs_all(sub_r, sub_f, resume_dir=tmp, **rkw)
        finally:
            dispatch.run_bucket = real_run
    finally:
        shutil.rmtree(tmp)
    for f in base:
        if not (np.array_equal(base[f], first[f]) and np.array_equal(base[f], second[f])):
            raise AssertionError(f"resume changed {f}")
    say(f"[avall] resume: a {RESUME_READS} x {RESUME_REFS} product in {shards} shards of "
        f"<= {RESUME_CHUNK} pairs reloaded with run_bucket refusing; equal to the first run")

    q, t, qlen, tlen, ci, cj = product_chunk(reads, refs, AVALL_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finish = dispatch.run_bucket(q, t, qlen, tlen, sp, "local", None, False, dev,
                                     launch_only=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    res = finish()
    for f in ("score", "qs", "qe", "ts", "te"):
        if not np.array_equal(res[f], out[f][ci, cj]):
            raise AssertionError(f"the sync-free chunk's {f} differs from the product's")
    say(f"[avall] the launch half of a {len(q)}-pair chunk ({q.shape[1]} x "
        f"{t.shape[1]}) made no device-to-host sync; its result equals the product's")
    kernel_phase_bucket(q, t, qlen, tlen, sp, dev, "config 5 chunk")
    q2, t2, qlen2, tlen2, sp2 = config2_bucket(dev)
    kernel_phase_bucket(q2, t2, qlen2, tlen2, sp2, dev, "config 2 bucket")
    return reads, refs, sp


def kernel_phase_shard(q, t, sp, mesh):
    """The kernel calls of the first shard of config 3 on ``mesh``
    (``dist.strip_sharded``), each held against its plain version on the
    same device inputs and timed at the shard's shape."""
    from seqalib_tpu_torch.ops import band_fill as bf_mod
    from seqalib_tpu_torch.ops import row_window as rw_mod
    from seqalib_tpu_torch.ops import strip as strip_mod
    from seqalib_tpu_torch.ops import strip_fill as sf_mod
    from seqalib_tpu_torch.ops import strip_walk as sw_mod
    from seqalib_tpu_torch.parallel import dist

    targets = [(strip_mod, "row_window", rw_mod.row_window_ref),
               (strip_mod, "strip_fill", sf_mod.strip_fill_ref),
               (strip_mod, "strip_walk", sw_mod.strip_walk_ref),
               (strip_mod, "band_fill", bf_mod.band_fill_ref)]
    n, m = np.full(len(q), q.shape[1]), np.full(len(t), t.shape[1])
    calls, _ = record(lambda: dist.strip_sharded(mesh, q, t, n, m, sp, mode="local",
                                                 want_tb=True), targets)
    label = f" (config 3, a shard of {dist.shard_bounds(len(q), len(mesh))[0][1]})"
    for key, (fn, plain, args, kw, _) in calls.items():
        kernel_entry(key, fn, plain, args, kw, label=label)
    say(f"[kernel] config 3 on a mesh of {len(mesh)}: the first shard's {len(calls)} kernels "
        f"equal to their plain versions")


def mesh_equal(name, got, want):
    """``got`` and ``want`` (lists of AlignResult) equal at the ``str`` level."""
    bad = [b for b, (g, w) in enumerate(zip(got, want)) if str(g) != str(w)]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{name}: {len(got)} results, pairs {bad[:5]} differ from "
                             f"mesh=None")
    say(f"[pairmesh] {name}: {len(got)}/{len(want)} results str-equal to mesh=None")


def result_hash(res) -> str:
    import hashlib

    return hashlib.blake2b("\n".join(map(str, res)).encode(), digest_size=16).hexdigest()


def two_process_run(q, t, sp, dev, card, want_hash, tmp):
    """Two ranks of the package's worker on the one card (gloo, a FileStore),
    each with a mesh of one entry, on config 3's pairs given as a file: each
    rank's results hash to ``want_hash``.  Returns the ranks' median walls."""
    path = os.path.join(tmp, "config3.npz")
    B = len(q)
    np.savez(path, q=q, t=t, qlen=np.full(B, q.shape[1]), tlen=np.full(B, t.shape[1]),
             match=sp.match, mismatch=sp.mismatch, gap_open=sp.gap_open,
             gap_extend=sp.gap_extend, matrix=sp.matrix, mode="local")
    store = os.path.join(tmp, "store")
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "seqalib_tpu_torch.parallel.dist_check", "--rank", str(r),
         "--world", "2", "--store", store, "--device", str(dev), "--mesh", "1",
         "--inputs", path, "--reps", str(REPS)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TWO_PROCESS_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    walls = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith("PAIRMESH"):
                say(f"[pairmesh] rank {r}: {line}")
        if p.returncode != 0 or f"PAIRMESH-OK r{r}" not in out:
            raise AssertionError(f"rank {r} exit {p.returncode}:\n{out[-3000:]}")
        if f"PAIRMESH-HASH r{r} {want_hash}" not in out:
            raise AssertionError(f"rank {r}'s results differ from one process's")
        wall = [x for x in out.splitlines() if x.startswith(f"PAIRMESH-WALL r{r} ")]
        walls.append(float(wall[0].split()[2]))
    say(f"[pairmesh] two processes on the one card (gloo, a shard each): both ranks "
        f"returned all {len(q)} results, equal to one process's; median walls "
        f"{walls} s ({card})")
    return walls


def pair_mesh_runs(dev, card, counts, cfg3, cfg1, cfg4, wide, product):
    """Phase 10: the pair mesh, held exactly against ``mesh=None``."""
    import torch

    import seqalib_tpu_torch as st
    from seqalib_tpu_torch.ops import launches, reset_launches
    from seqalib_tpu_torch.parallel import dispatch
    from seqalib_tpu_torch.parallel.dist import dryrun_multichip

    one = st.make_pair_mesh()
    four = st.make_pair_mesh([dev] * 4)
    q3, t3, sp3 = cfg3
    qs3, ts3 = list(q3), list(t3)

    def run3(mesh):
        return lambda: st.align_batch(qs3, ts3, scoring=sp3, mode="local", traceback=True,
                                      mesh=mesh, device=dev)

    sharded = Counter()

    def run_four():
        # the counts of the mesh of 4's calls alone, in a phase that runs
        # the three meshes in turns
        reset_launches()
        res = run3(four)()
        sharded.update(launches)
        return res

    turns = runs_in_turns({"mesh=None": run3(None), "make_pair_mesh()": run3(one),
                           "a mesh of 4 entries": run_four})
    base, walls = turns["mesh=None"]
    say(f"[pairmesh] config 3 mesh=None: wall {statistics.median(walls)!r} s "
        f"(reps {walls}) ({card})")
    for name, mesh in (("make_pair_mesh()", one), ("a mesh of 4 entries", four)):
        got, walls = turns[name]
        say(f"[pairmesh] config 3 on {name} ({len(mesh)}): wall "
            f"{statistics.median(walls)!r} s (reps {walls}; in turns with mesh=None, the "
            f"order rotated each round) ({card})")
        mesh_equal(f"config 3 on {name}", got, base)
    counts["pairmesh3"] = dict(sharded)
    per_call = {k: v for k, v in counts["config3"].items() if v}
    sharded = {k: v for k, v in counts["pairmesh3"].items() if v}
    say(f"[launches] config 3 on a mesh of 4 (1 warm-up + {REPS} timed calls): {sharded}")
    if sharded != {k: 4 * v for k, v in per_call.items()}:
        raise AssertionError(f"a mesh of 4 launched {sharded}, not 4 x {per_call}")
    say("[pairmesh] every kernel of config 3 launched 4 times as often on the mesh of 4")
    kernel_phase_shard(q3, t3, sp3, four)
    B3_, L3 = q3.shape
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finish = dispatch.run_bucket(q3, t3, np.full(B3_, L3), np.full(B3_, t3.shape[1]), sp3,
                                     "local", None, True, None, launch_only=True, mesh=four)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    res = finish()
    got = [f"score={res['score'][b]} q[{res['qs'][b]}:{res['qe'][b]}] "
           f"t[{res['ts'][b]}:{res['te'][b]}] {res['cigars'][b]}" for b in range(B3_)]
    if got != [str(r) for r in base]:
        raise AssertionError("the sync-free sharded launch of config 3 differs from mesh=None")
    say("[pairmesh] the launch half of config 3's bucket on the mesh of 4 (4 shards) made no "
        "device-to-host sync; its finalize equals mesh=None")

    q1, t1, sp1 = cfg1
    want = st.align_batch(list(q1), list(t1), scoring=sp1, mode="global", device=dev)
    mesh_equal("config 1 on the mesh of 4",
               st.align_batch(list(q1), list(t1), scoring=sp1, mode="global", mesh=four),
               want)
    qs4, ts4, sp4 = cfg4
    kw4 = dict(scoring=sp4, mode="global", band=BAND4)
    turns = runs_in_turns({"mesh=None": lambda: st.align_batch(qs4, ts4, device=dev, **kw4),
                           "four": lambda: st.align_batch(qs4, ts4, mesh=four, **kw4)})
    mesh_equal("config 4 on the mesh of 4", turns["four"][0], turns["mesh=None"][0])
    say(f"[pairmesh] config 4 (the banded route, its parts run one after another) walls in "
        f"turns: mesh=None {statistics.median(turns['mesh=None'][1])!r} s (reps "
        f"{turns['mesh=None'][1]}), the mesh of 4 {statistics.median(turns['four'][1])!r} s "
        f"(reps {turns['four'][1]}) ({card})")
    qs7, ts7, sp7 = wide
    kw7 = dict(scoring=sp7, mode="global", band=BAND7)
    reset_launches()
    st.align_batch(qs7, ts7, mesh=four, **kw7)
    walks = launches["wavefront_walk"], launches["wavefront_fill/ptr"]
    if walks != (4, 4):
        raise AssertionError(f"the wide route on the mesh of 4 launched (walk, fill) {walks}")
    turns = runs_in_turns({"mesh=None": lambda: st.align_batch(qs7, ts7, device=dev, **kw7),
                           "four": lambda: st.align_batch(qs7, ts7, mesh=four, **kw7)})
    mesh_equal("the wide-table route on the mesh of 4", turns["four"][0],
               turns["mesh=None"][0])
    say(f"[pairmesh] the wide-table route (phase 7's batch, every shard launched before any "
        f"is finalized; one fill and one walk a shard) walls in turns: mesh=None "
        f"{statistics.median(turns['mesh=None'][1])!r} s (reps {turns['mesh=None'][1]}), the "
        f"mesh of 4 {statistics.median(turns['four'][1])!r} s (reps {turns['four'][1]}) "
        f"({card})")
    mesh_equal("3 config-3 pairs on the mesh of 4 (one shard empty)",
               st.align_batch(qs3[:3], ts3[:3], scoring=sp3, mode="local", mesh=four),
               base[:3])
    xla_mesh_runs(dev, card, four, cfg3, wide)

    reads, refs, sp5 = product
    reads = reads[:AVALL_MESH_READS]
    kw5 = dict(scoring=sp5, mode="local", chunk_pairs=AVALL_CHUNK)
    tmp = tempfile.mkdtemp(prefix="pairmesh_")
    real_run = dispatch.run_bucket
    try:
        written = st.align_all_vs_all(reads, refs, resume_dir=tmp, device=dev, **kw5)
        turns = runs_in_turns(
            {"mesh=None": lambda: st.align_all_vs_all(reads, refs, device=dev, **kw5),
             "four": lambda: st.align_all_vs_all(reads, refs, mesh=four, **kw5)}, reps=2)
        (plain, w_plain), (meshed, w_mesh) = turns["mesh=None"], turns["four"]

        def refuse(*a, **k):
            raise AssertionError("a resumed product realigned a finished chunk")

        dispatch.run_bucket = refuse
        try:
            resumed = st.align_all_vs_all(reads, refs, resume_dir=tmp, mesh=four, **kw5)
        finally:
            dispatch.run_bucket = real_run
        for f in plain:
            if not all(np.array_equal(plain[f], x[f]) for x in (written, meshed, resumed)):
                raise AssertionError(f"config 5 on the mesh of 4: {f} differs")
        say(f"[pairmesh] config 5, {len(reads)} x {len(refs)}: the mesh of 4 equal to "
            f"mesh=None element by element (walls in turns {w_mesh!r} / {w_plain!r} s, "
            f"{card}); "
            f"resumed on the mesh of 4 from {len(os.listdir(tmp))} shards written without "
            f"a mesh, run_bucket refusing: equal")
        two_process_run(q3, t3, sp3, dev, card, result_hash(base), tmp)
    finally:
        shutil.rmtree(tmp)

    dryrun_multichip(4, device=dev)
    say(f"[pairmesh] dryrun_multichip(4, device={str(dev)!r}) passed")
    n = torch.cuda.device_count()
    try:
        dryrun_multichip(n + 1)
    except RuntimeError as e:
        say(f"[pairmesh] dryrun_multichip({n + 1}) raises on {n} card(s): {e}")
    else:
        raise AssertionError(f"dryrun_multichip({n + 1}) ran on {n} card(s)")


def xla_mesh_runs(dev, card, four, cfg3, wide):
    """``backend="xla"`` on the mesh of 4 naming the card: config 3 (timed in
    turns with ``mesh=None``; every shard's passes launched) and phase 7's
    batch under BLOSUM62 o=-10 e=-1 at band 64 (the full-matrix wavefront
    sharded, where ``"pallas"`` takes the banded route), each result equal
    to ``mesh=None``'s."""
    import seqalib_tpu_torch as st
    from seqalib_tpu_torch.ops import launches, reset_launches

    q3, t3, sp3 = cfg3
    qs3, ts3 = list(q3), list(t3)
    kw3 = dict(scoring=sp3, mode="local", traceback=True, backend="xla")
    reset_launches()
    st.align_batch(qs3, ts3, mesh=four, **kw3)
    fills = launches["wavefront_fill/local"], launches["wavefront_fill/ptr"]
    if fills != (4, 4):
        raise AssertionError(f"xla config 3 on the mesh of 4 launched (pass a, pass c) {fills}")
    turns = runs_in_turns({"mesh=None": lambda: st.align_batch(qs3, ts3, device=dev, **kw3),
                           "four": lambda: st.align_batch(qs3, ts3, mesh=four, **kw3)})
    mesh_equal("xla config 3 on the mesh of 4", turns["four"][0], turns["mesh=None"][0])
    say(f"[pairmesh] backend='xla' config 3 (4 shards, each pass (a) launched before any "
        f"finalize; (a), (c) a launch a shard) walls in turns: mesh=None "
        f"{statistics.median(turns['mesh=None'][1])!r} s (reps {turns['mesh=None'][1]}), the "
        f"mesh of 4 {statistics.median(turns['four'][1])!r} s (reps {turns['four'][1]}) "
        f"({card})")
    qs7, ts7, _ = wide
    kw7 = dict(scoring=sp3, mode="global", band=BAND7, traceback=True, backend="xla")
    mesh_equal("xla, phase 7's batch at band 64 under BLOSUM62, on the mesh of 4",
               st.align_batch(qs7, ts7, mesh=four, **kw7),
               st.align_batch(qs7, ts7, device=dev, **kw7))


# ---- the sweep phase (13) ----------------------------------------------


def sweep_targets():
    """Every kernel wrapper at each call site the public entry points reach,
    with its plain version: ``record``'s targets."""
    from seqalib_tpu_torch.models import banded as banded_mod
    from seqalib_tpu_torch.ops import band_fill as bf_mod
    from seqalib_tpu_torch.ops import band_walk as bw_mod
    from seqalib_tpu_torch.ops import row_window as rw_mod
    from seqalib_tpu_torch.ops import sp_tile as tile_mod
    from seqalib_tpu_torch.ops import strip as strip_mod
    from seqalib_tpu_torch.ops import strip_fill as sf_mod
    from seqalib_tpu_torch.ops import wavefront as wf_mod
    from seqalib_tpu_torch.ops import wavefront_walk as ww_mod
    from seqalib_tpu_torch.ops import wavefront_xla as xla_mod
    from seqalib_tpu_torch.parallel import band_pipeline as bp_mod
    from seqalib_tpu_torch.parallel import banded_sp as bsp_mod

    return [(strip_mod, "row_window", rw_mod.row_window_ref),
            (strip_mod, "strip_fill", sf_mod.strip_fill_ref),
            (strip_mod, "strip_walk", strip_walk_mod().strip_walk_ref),
            (strip_mod, "band_fill", bf_mod.band_fill_ref),
            (banded_mod, "band_fill", bf_mod.band_fill_ref),
            (banded_mod, "band_walk", bw_mod.band_walk_ref),
            (wf_mod, "wavefront_fill", wf_mod.wavefront_fill_ref),
            (wf_mod, "wavefront_walk", ww_mod.wavefront_walk_ref),
            (xla_mod, "wavefront_fill", wf_mod.wavefront_fill_ref),
            (bp_mod, "sp_tile_run", tile_mod.sp_tile_run_ref),
            (bp_mod, "sp_tile_ptr", tile_mod.sp_tile_ptr_ref),
            (bsp_mod, "band_fill", bf_mod.band_fill_ref),
            (bsp_mod, "band_walk", bw_mod.band_walk_ref)]


def sweep_runs(dev):
    """The seeded differential sweep on the card (``seqalib_tpu_torch/sweep.py``):
    SWEEP_DRAWS pairs of 1-400 letters, six scorings (one near int32's
    range), both modes, through every route of ``sweep.ROUTES`` (the
    launch counts set to 0 just before, read just after), every result
    equal to ``oracle_fast``; the first call of each kernel key the routes
    launched held exactly to its plain version (``check_kernel``); every
    identity of ``tests/test_torch_properties.py``; fault 7's pair on both
    SP entry points."""
    import torch

    import seqalib_tpu_torch as st
    from seqalib_tpu_torch import sweep
    from seqalib_tpu_torch.ops import launches, reset_launches

    t0 = time.perf_counter()
    ds = sweep.draws(SEED, SWEEP_DRAWS)
    api = sweep.PortAPI(dev)
    reset_launches()
    calls, results = record(lambda: [r for name in sweep.ROUTES
                                     for r in sweep.run_route(api, name, ds)],
                            sweep_targets())
    torch.cuda.synchronize()
    counts = dict(launches)  # the phase's own: its one run of every route
    t1 = time.perf_counter()
    oracle = sweep.oracle_results(results, processes=SWEEP_PROCESSES)
    bad = sweep.check(results, oracle)
    if bad:
        raise AssertionError(f"[sweep] {len(bad)} of {len(results)} results differ from the "
                             "oracle:\n" + "\n".join(bad[:40]))
    by_route = Counter(r.route for r in results)
    say(f"[sweep] {len(ds)} draws, {len(results)} results over {len(by_route)} routes, "
        f"every one equal to the oracle (routes {t1 - t0:.1f} s, oracle "
        f"{time.perf_counter() - t1:.1f} s): {dict(by_route)}")
    walks = ("strip_walk", "wavefront_walk", "wavefront_walk/linear")
    for key, (fn, plain, args, kw, _) in calls.items():
        pkw = {k: v for k, v in kw.items() if k not in ("err", "span")}
        stats, _ = check_kernel(f"{key} (sweep)", lambda: fn(*args, **kw),
                                lambda: plain(*args, **pkw),
                                walk_view if key in walks else (lambda out: out))
        if stats["max_abs_err"] != 0:
            raise AssertionError(f"[sweep] {key}: max_abs_err {stats['max_abs_err']}")
    say(f"[sweep] the first call of each of {len(calls)} kernel keys equal to its plain "
        f"version: {sorted(calls)}")
    say(f"[launches] sweep (one run of every route): "
        f"{ {k: v for k, v in counts.items() if v} }")
    missing = [k for k, (_, _, _, *key) in KERNELS.items()
               if counts.get((key or [k])[0], 0) <= 0
               and k not in ("band_fill/wide_emode", "band_fill/wide_scratch",
                             "band_fill/wide_scratch_ptr", "band_fill/wide_scratch_emode")]
    if missing:
        raise AssertionError(f"[sweep] the routes never launched: {missing}")
    n = sweep.identity_checks(dev)
    say(f"[sweep] {n} identities hold on the card")
    q, t = np.zeros(100, np.int32), np.ones(90, np.int32)
    s = 1 << 20
    sp = st.ScoringParams(match=2 * s, mismatch=-3 * s, gap_open=-5 * s, gap_extend=-2 * s)
    mesh = st.make_band_mesh([dev] * 2)
    want = st.align(q.astype(np.uint8), t.astype(np.uint8), sp, backend="oracle")
    got = (st.align_score_sp(q, t, sp, mesh, C=128), str(st.align_sp(q, t, sp, mesh, C=128)))
    if got != (want.score, str(want)):
        raise AssertionError(f"[sweep] fault 7's pair: {got} != the oracle's {want}")
    say(f"[sweep] fault 7's pair on both SP entry points: {got[0]}, {got[1]} (the oracle's)")
    say(f"[time] sweep phase {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import seqalib_tpu_torch as st
    from seqalib_tpu_torch import BLOSUM62, ScoringParams, _build
    from seqalib_tpu_torch.ops import launches, reset_launches

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    say(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    out = _build.build(ptxas_verbose=True)
    say(f"[build] {time.perf_counter() - t0:.2f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("[build]", line.strip())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    say(card)

    rng = np.random.default_rng(SEED)
    sp3 = ScoringParams.blosum62(gap_open=-10, gap_extend=-1)
    q3 = rng.integers(0, 20, size=(B3, 1024)).astype(np.uint8)
    t3 = rng.integers(0, 20, size=(B3, 1024)).astype(np.uint8)
    sp1 = ScoringParams.linear()
    q1 = rng.integers(0, 4, size=(B3, 256)).astype(np.uint8)
    t1 = rng.integers(0, 4, size=(B3, 256)).astype(np.uint8)
    sp4 = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
    qs4, ts4 = long_reads(rng, B4, L4)
    qsp, tsp, q16, t16, qo, to = sp_pairs(rng)
    sp7 = ScoringParams(gap_open=-20, gap_extend=-2, matrix=2 * BLOSUM62)
    qs7, ts7 = wide_pairs(rng)
    qsb, tsb, qob, tob, qpb, tpb = banded_sp_pairs()
    qw, tw = wide_pair(rng)

    per_kernel, escalated = kernel_phase3(q3, t3, sp3, dev)
    say(f"[config3] escalated pairs: {escalated}/{B3}")
    kernel_phase1(q1, t1, sp1, dev)
    per_kernel.update(kernel_phase4(qs4, ts4, sp4, dev))
    per_kernel.update(kernel_phase_wide4(qw, tw, sp4, q3, t3, sp3, dev))
    per_kernel.update(kernel_phase_sp(qsp, tsp, q16, t16, qo, to, sp4, dev))
    per_kernel.update(kernel_phase_sp_walk(sp4, dev))
    per_kernel.update(kernel_phase_band_cigar(
        ScoringParams(match=2, mismatch=-4, gap_open=-4, gap_extend=-2), dev))
    per_kernel.update(kernel_phase_wide(qs7, ts7, sp7, dev))
    per_kernel.update(kernel_phase_xla(q1, t1, sp1, q3, t3, sp3, dev))
    per_kernel.update(kernel_phase_banded_sp(qsb, tsb, sp4, dev))
    edge_checks(q3, t3, sp3, sp7, dev)
    n_checks = 100_000
    t0 = time.perf_counter()
    for _ in range(n_checks):
        torch.cuda.current_device()
    rw = per_kernel["row_window"]
    say(f"[guard] the launch guard's device check: "
        f"{(time.perf_counter() - t0) / n_checks * 1e6:.3f} µs per launch; row_window "
        f"{rw['ms']:.4f} ms per call against the library call's {rw['library_ms']:.4f} ms")
    say(f"[time] kernel phase done at {time.perf_counter() - t_start:.1f} s")

    counts = {}
    qs3, ts3 = list(q3), list(t3)
    reset_launches()
    want3 = config_run("config3", qs3, ts3, sp3, "local", dev)
    counts["config3"] = dict(launches)
    with env_set("SEQALIB_FUSED_PASS2", "strip"):
        reset_launches()
        config_run("config3_strip", qs3, ts3, sp3, "local", dev, want=want3)
        counts["config3_strip"] = dict(launches)

    reset_launches()
    want1 = config_run("config1", list(q1), list(t1), sp1, "global", dev)
    counts["config1"] = dict(launches)

    reset_launches()
    banded_run("config4", qs4, ts4, sp4, BAND4, dev, REPS)
    counts["config4"] = dict(launches)
    config4_oracle(qs4, ts4, sp4, BAND4, dev)
    for band in (64, 256):
        banded_run(f"config4_band{band}", qs4, ts4, sp4, band, dev, 1)
    q100, t100 = long_reads(rng, 8, 100_000)
    banded_run("config4_100kb", q100, t100, sp4, 64, dev, 1)
    reset_launches()
    res = banded_run("config4_wide", [qw], [tw[: L4 + WIDE_DELTA]], sp4, BAND4, dev, REPS)
    counts["config4_wide"] = dict(launches)
    want = st.align_score_sp(qw.astype(np.int32), tw[: L4 + WIDE_DELTA].astype(np.int32),
                             sp4, st.make_band_mesh([dev]), C=SP_C)
    if res[0].score != want:
        raise AssertionError(f"config4_wide score {res[0].score} != align_score_sp {want}")
    say(f"[config4_wide] delta {WIDE_DELTA}: score {want} == align_score_sp")
    wide_variant_runs(q3, t3, sp3, sp4, dev, counts)
    say(f"[time] configs done at {time.perf_counter() - t_start:.1f} s")
    sp_runs(qsp, tsp, q16, t16, qo, to, sp4, dev, counts)
    say(f"[time] SP phase done at {time.perf_counter() - t_start:.1f} s")
    wide_runs(qs7, ts7, sp7, sp3, dev, counts)
    say(f"[time] wide-table phase done at {time.perf_counter() - t_start:.1f} s")
    banded_sp_runs(qsb, tsb, qob, tob, qpb, tpb, sp4, sp3, dev, counts)
    say(f"[time] banded-SP phase done at {time.perf_counter() - t_start:.1f} s")
    product = cli_runs(dev, card, counts)
    say(f"[time] CLI phase done at {time.perf_counter() - t_start:.1f} s")
    pair_mesh_runs(dev, card, counts, (q3, t3, sp3), (q1, t1, sp1), (qs4, ts4, sp4),
                   (qs7, ts7, sp7), product)
    say(f"[time] pair-mesh phase done at {time.perf_counter() - t_start:.1f} s")
    xla_runs(dev, card, counts, (q1, t1, sp1), (q3, t3, sp3), (qs7, ts7), want1, want3)
    say(f"[time] paths done at {time.perf_counter() - t_start:.1f} s")
    sweep_runs(dev)

    for path, c in counts.items():
        say(f"[launches] {path} (1 warm-up + {REPS} timed calls, or the CLI's run): "
            f"{ {k: v for k, v in c.items() if v} }")
    missing = [k for k, (_, _, path, *key) in KERNELS.items()
               if counts[path].get((key or [k])[0], 0) <= 0]
    if missing:
        raise AssertionError(f"a path never launched: {missing}")
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "seqalib_tpu"))
    if bad:
        raise AssertionError(f"JAX or the JAX package was imported: {bad[:5]}")

    kernels = [
        {"name": k, "route": "cuda", "source": f"seqalib_tpu_torch/csrc/{src}",
         "replaces": rep, "launches": counts[path][(key or [k])[0]], **per_kernel[k]}
        for k, (src, rep, path, *key) in KERNELS.items()
    ]
    say(f"[time] total {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
