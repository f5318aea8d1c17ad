"""Kernel wrappers of the port and the strip engine's host side.

``launches`` counts, per kernel, the launches each wrapper made on a CUDA
tensor; it lives with the port's other counters in ``telemetry``, which
says what each key counts.
"""

from __future__ import annotations

from ..telemetry import launches, reset_launches  # noqa: F401
