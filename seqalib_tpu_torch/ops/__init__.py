"""Kernel wrappers of the port and the strip engine's host side.

``launches`` counts, per kernel, the launches each wrapper made on a CUDA
tensor (a call on a CPU tensor runs the plain PyTorch version and counts
nothing).  ``strip_fill``, ``band_fill``, ``sp_tile`` and ``wavefront_fill``
(``ops.wavefront.launch_key``) count each mode under its own key,
``wavefront_walk`` its linear variant, ``band_walk`` its ``i_floor`` handoff;
``band_fill``'s wide variant (a thread block cluster a pair, 8192 < Wp <=
131072) counts under ``band_fill/wide*`` and its scratch variant (Wp >
131072) under ``band_fill/wide_scratch*``, and ``sp_tile`` counts a run of
several tiles under ``sp_tile/run_*`` and a batch of several pointer tiles
under ``sp_tile/ptr_batch``.
"""

from __future__ import annotations

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
    "sp_tile/global": 0,
    "sp_tile/local": 0,
    "sp_tile/ptr": 0,
    "sp_tile/run_global": 0,
    "sp_tile/run_local": 0,
    "sp_tile/ptr_batch": 0,
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


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
