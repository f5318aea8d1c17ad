"""Helpers shared by the kernel sweeps (``tools/band_fill_ablation.py``,
``tools/sp_tile_sweep.py``, ``tools/strip_fill_sweep.py``): the card's
name line, CUDA-event timing, and building variants of a kernel source.

A variant is a set of ``csrc/`` files (a kernel source edited, or another
file with the same C interface), built by its own ``nvcc`` with
``row_window.cu`` (for the error strings) into a library whose entry
points are bound as the port's own; ``_build._lib`` set to it makes the
port's wrappers launch the variant.  Needs a CUDA card and the toolkit.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

if str(Path(__file__).resolve().parents[1]) not in sys.path:  # a caller may put another tree first
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from seqalib_tpu_torch import _build  # noqa: E402


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip()


def time_ms(fn, calls):
    """ms per call of ``fn`` over ``calls`` calls after one warm-up (CUDA
    events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def build_variants(variants, out_dir):
    """{name: library} of ``variants`` ({name: {file name: source text}}),
    one nvcc per variant, all started together, under ``out_dir/name``."""
    procs = []
    for name, files in variants.items():
        d = Path(out_dir) / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in ("common.cuh", "row_window.cu"):
            shutil.copy(_build.CSRC / f, d / f)
        for f, text in files.items():
            (d / f).write_text(text)
        srcs = sorted({*files, "row_window.cu"} - {"common.cuh"})
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               *(str(d / f) for f in srcs)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    _build._run(procs)
    libs = {}
    for name in variants:
        lib = ctypes.CDLL(str(Path(out_dir) / name / "lib.so"))
        for entry, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        lib.seqalib_error_string.argtypes = [ctypes.c_int]
        lib.seqalib_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs
