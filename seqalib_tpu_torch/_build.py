"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  No
PyTorch headers are involved, so a build takes seconds.  The build
happens at first use (never on import) and again whenever a hash of the
sources changes; the library lives in ``seqalib_tpu_torch/_build/``.

Every C entry point launches on the stream it is given, allocates
nothing and returns ``cudaGetLastError()`` after its launch; every
wrapper calls it through ``launch``, which makes the tensors' device
current for the call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libseqalib_kernels.so"
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every entry point: without them ctypes passes a pointer as
# a 32-bit int and cuts it
_SIGNATURES = {
    "seqalib_row_window": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "seqalib_strip_fill": [
        _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _P, _P, _P, _P, _P,
    ],
    "seqalib_strip_walk": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _P],
    "seqalib_band_fill": [
        _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _I, _I, _I, _P,
    ],
    "seqalib_band_walk": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "seqalib_band_cigar": [_P, _I, _I, _P, _I, _P, _P],
    "seqalib_sp_run": [_P] * 7 + [_I] * 16 + [_P] * 4 + [_I] + [_P] * 6,
    "seqalib_sp_walk": [_P] + [_I] * 8 + [_P, _P],
    "seqalib_wavefront_fill": [_P, _I, _P, _I, _P, _P, _P] + [_I] * 10 + [_P] * 5 + [_I]
    + [_P] + [_I] * 4 + [_P],
    "seqalib_wavefront_walk": [_P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P],
}

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _run(procs) -> str:
    """Wait for every (cmd, process), then raise if any failed."""
    texts = ["".join(proc.communicate()) for _, proc in procs]
    for (cmd, proc), text in zip(procs, texts):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
    return "".join(texts)


def build(ptxas_verbose: bool = False) -> str:
    """Compile the kernels unless a library built from the same sources
    exists.  Returns the compiler's output ("" when nothing was built).
    ``ptxas_verbose`` adds ``-Xptxas -v`` (registers, shared memory and
    spills of each kernel)."""
    digest = _source_hash()
    so = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha")
    if so.exists() and stamp.exists() and stamp.read_text() == digest:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if ptxas_verbose else [])
    tag = f"{os.getpid()}.tmp"
    objs, procs = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *flags, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    try:
        out = _run(procs)
        tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        out += _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, so)
    stamp.write_text(digest)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        loaded = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        loaded.seqalib_error_string.argtypes = [ctypes.c_int]
        loaded.seqalib_error_string.restype = ctypes.c_char_p
        _lib = loaded
    return _lib


def current_stream(device) -> int:
    """The handle of PyTorch's current stream on a CUDA tensor's ``device``, read
    without building a ``torch.cuda.Stream`` (a few µs per call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(name: str, rc: int) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib().seqalib_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def launch(name: str, device, entry: str, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and the current stream
    of the CUDA ``device`` (a tensor's device, whose index is set), then
    raise on its error code.  Every wrapper launches through here: the
    call runs with ``device`` current, since a kernel launch goes to the
    current device whatever stream it is given.  The device is switched
    (and restored) only when another one is current."""
    fn = getattr(lib(), entry)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, current_stream(device))
    else:
        with torch.cuda.device(device.index):
            rc = fn(*args, current_stream(device))
    check(name, rc)
