"""The port's telemetry: named spans on ``torch.profiler``'s clock and
always-on counters.

``span(name)`` marks a phase of a call.  While no ``torch.profiler``
records, it returns one shared null context: an attribute read, nothing
built.  While a profiler records (``torch.profiler.profile``, the CLI's
``--trace``), it opens a profiler range named ``name``, which the trace
holds as a host op (a ``cpu_op`` event, with the ATen ops and the CUDA
runtime calls it encloses, on the host clock the device ops are placed
against).  Every name starts with ``seqalib.``; the layers and phases are:

* entry: one span per public call, ``seqalib.align``, ``seqalib.align_batch``,
  ``seqalib.align_all_vs_all``, ``seqalib.align_sp``, ``seqalib.align_score_sp``,
  ``seqalib.align_banded_sp``, ``seqalib.align_score_banded_sp``;
* the long pair (``parallel/band_pipeline.py``): ``seqalib.sp.stage`` (the
  letters, boundaries and first row staged before the first fill launch),
  ``seqalib.sp.fill``, ``seqalib.sp.checkpoint`` (the tiles' boundaries kept
  for the walk), ``seqalib.sp.score_wait`` (the host waits for the score),
  ``seqalib.sp.walk`` and in it one ``seqalib.sp.ptr_batch`` a batch of
  pointer tiles, holding ``seqalib.sp.ptr_launch`` (the recompute and the
  walk through it launched on the card) and ``seqalib.sp.ptr_copy`` (the
  wait for both, and the copy of the walk's ops and end to the host), then
  ``seqalib.sp.rescore`` (the re-score, the CIGAR text, the result);
* batches (``parallel/dispatch.py``, ``models/banded.py``):
  ``seqalib.bucket.launch`` and ``seqalib.bucket.finalize`` a length bucket,
  ``seqalib.banded.group`` a batch of the banded route (the delta groups
  that ``dispatch.banded_batches`` joins, or its part on one entry of a
  mesh), and in ``banded_align_batch``
  ``seqalib.banded.stage``, ``seqalib.banded.fill``, ``seqalib.banded.block``
  (a super-block's recompute and walk), ``seqalib.banded.ops_copy`` and
  ``seqalib.banded.cigar``.

Counters count whether or not a profiler records, one integer add where
the work is made:

* ``launches``: per kernel, the launches each wrapper made on a CUDA tensor
  (a call on a CPU tensor runs the plain PyTorch version and counts
  nothing).  ``strip_fill``, ``band_fill``, ``sp_tile`` and
  ``wavefront_fill`` (``ops.wavefront.launch_key``) count each mode under
  its own key, ``wavefront_walk`` its linear variant, ``band_walk`` its
  ``i_floor`` handoff; ``band_fill``'s wide variant (a thread block cluster
  a pair, 8192 < Wp <= 131072) counts under ``band_fill/wide*`` and its
  scratch variant (Wp > 131072) under ``band_fill/wide_scratch*``, and
  ``sp_tile`` counts a run of several tiles under ``sp_tile/run_*`` and a
  batch of several pointer tiles under ``sp_tile/ptr_batch``; ``sp_walk``
  counts the walk through one such batch, ``band_cigar`` the CIGAR text of
  a ``banded_align_batch`` traceback.
* ``d2h_bytes``: the bytes the port copies from a CUDA tensor to the host:
  scores, op rows and the long pair's walked ops, CIGAR text, walk ends and
  the buffers of ``transfer.to_host`` (``count_d2h`` where each copy is
  made; the plain versions of the kernels count nothing).
* ``banded_batches``: the ``banded_align_batch`` calls on a card, and
  ``band_slots``: the slots their fill and recompute launches compute, B
  pairs x ``Wp`` slots x the diagonals ``k1 - k0`` of each launch
  (``count_band``).  Over the cells the pairs' own bands hold, they give
  the share of the computed slots that some pair needs.

``snapshot()`` reads them all at once; the difference of two snapshots is
what the calls between them did.
"""

from __future__ import annotations

import functools
from contextlib import nullcontext

import torch
from torch.autograd import profiler as _profiler

# a range the trace holds as a host op (``torch.profiler.record_function``
# makes a user annotation, and costs ~10x more to open)
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)
_OFF = nullcontext()

launches: dict[str, int] = {
    "row_window": 0,
    "strip_fill/local": 0,
    "strip_fill/emode": 0,
    "strip_fill/gmode": 0,
    "strip_walk": 0,
    "band_fill/fill": 0,
    "band_fill/ptr": 0,
    "band_fill/emode": 0,
    "band_fill/relay": 0,
    "band_fill/relay_ptr": 0,
    "band_fill/wide": 0,
    "band_fill/wide_ptr": 0,
    "band_fill/wide_emode": 0,
    "band_fill/wide_scratch": 0,
    "band_fill/wide_scratch_ptr": 0,
    "band_fill/wide_scratch_emode": 0,
    "band_walk": 0,
    "band_walk/floor": 0,
    "band_cigar": 0,
    "sp_tile/global": 0,
    "sp_tile/local": 0,
    "sp_tile/ptr": 0,
    "sp_tile/run_global": 0,
    "sp_tile/run_local": 0,
    "sp_tile/ptr_batch": 0,
    "sp_walk": 0,
    "wavefront_fill/ptr": 0,
    "wavefront_fill/score": 0,
    "wavefront_fill/lin_ptr": 0,
    "wavefront_fill/lin_score": 0,
    "wavefront_fill/local": 0,
    "wavefront_fill/local_lin": 0,
    "wavefront_fill/local_ptr": 0,
    "wavefront_fill/local_lin_ptr": 0,
    "wavefront_walk": 0,
    "wavefront_walk/linear": 0,
}
d2h_bytes = 0
banded_batches = 0
band_slots = 0


def span(name: str):
    """A context manager marking the phase ``name`` (``seqalib.*``) while a
    profiler records; the shared null context otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Range(name)


def traced(name: str):
    """Decorate a function so that each call of it is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return call
    return wrap


def count_d2h(*tensors: torch.Tensor) -> None:
    """Count the bytes of the CUDA tensors among ``tensors``, copied to the
    host by the caller."""
    global d2h_bytes
    d2h_bytes += sum(t.numel() * t.element_size() for t in tensors if t.is_cuda)


def count_band(t: torch.Tensor, batches: int = 0, slots: int = 0) -> None:
    """Count ``banded_align_batch`` calls and the slots of its launches,
    when ``t``, one of its inputs, is on a card."""
    global banded_batches, band_slots
    if t.is_cuda:
        banded_batches += batches
        band_slots += slots


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def snapshot() -> dict:
    """The counters now: every kernel launch counted, ``d2h_bytes``,
    ``banded_batches`` and ``band_slots``."""
    return {"launches": sum(launches.values()), "d2h_bytes": d2h_bytes,
            "banded_batches": banded_batches, "band_slots": band_slots}
