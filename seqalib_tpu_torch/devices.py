"""Devices and meshes (a mesh: a tuple of ``torch.device``, which may name
one device several times).  A leaf: it imports nothing of the package."""

from __future__ import annotations

from typing import Tuple

import torch

Mesh = Tuple[torch.device, ...]
H100_SMS = 132


def as_device(device) -> torch.device:
    """``device`` as a ``torch.device``: the CPU, or CUDA with a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def device_mesh(devices=None, who: str = "make_band_mesh") -> Mesh:
    """A mesh: the given devices in order, or every visible CUDA device
    (raises when there is none).  ``who`` names the caller in errors."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: no CUDA device; pass devices=")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(as_device(d) for d in devices)
    if not mesh:
        raise ValueError(f"{who}: a mesh needs at least one device")
    return mesh


def one_device(mesh: Mesh) -> bool:
    """Whether every entry of the mesh names the same device."""
    return len(set(mesh)) == 1


def sm_count(device) -> int:
    """SMs of ``device`` on a card; off a card an H100's, so that a run on
    the CPU batches as the card would."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return H100_SMS
