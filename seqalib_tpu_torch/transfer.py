"""Host <-> device copies that make no device-to-host sync on a CUDA device.

``host_buffer`` gives an int32 buffer to fill on the host, pinned for a
CUDA device, and ``upload`` copies it with ``non_blocking=True``: the
strip engine stages its letters and lengths so, in one buffer.  PyTorch's
caching host allocator records the copy's event on the pinned block when
the copy is enqueued and does not hand the block out again before that
event has fired, so a staging buffer is never reused while its copy is in
flight.  ``to_device`` copies a small NumPy array (a score table, a start
state) from pageable memory with ``non_blocking=True``: CUDA stages
the bytes before the call returns, and PyTorch makes no sync for it.

``to_host`` enqueues the copy of a few small device tensors into one
pinned buffer, records a CUDA event after it, and returns a callable that
waits on that event only: work enqueued after the copy (the next bucket's
kernels) does not delay it.

On the CPU all of them are plain conversions.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .telemetry import count_d2h


def host_buffer(n: int, device) -> torch.Tensor:
    """An int32 host buffer of ``n`` elements, pinned when ``device`` is a
    CUDA device."""
    return torch.empty(n, dtype=torch.int32, pin_memory=torch.device(device).type == "cuda")


def upload(buf: torch.Tensor, device) -> torch.Tensor:
    """``buf`` (from ``host_buffer``) on ``device``: the buffer itself on the
    CPU, else a copy enqueued with no sync."""
    device = torch.device(device)
    return buf if device.type != "cuda" else buf.to(device, non_blocking=True)


def to_device(a, device) -> torch.Tensor:
    """``a``, a small array, as an int32 tensor on ``device`` (a copy)."""
    return torch.from_numpy(np.array(a, dtype=np.int32, order="C")).to(device,
                                                                       non_blocking=True)


def to_host(tensors: Dict[str, torch.Tensor]) -> Callable[[], Dict[str, np.ndarray]]:
    """Start copying the int32 ``tensors`` (all on one device) to the host;
    the returned callable waits for the copy and gives NumPy arrays of the
    same names and shapes."""
    names = list(tensors)
    shapes = [tuple(tensors[k].shape) for k in names]
    dev = tensors[names[0]].device
    if dev.type != "cuda":
        out = {k: tensors[k].numpy() for k in names}
        return lambda: out
    flat = torch.cat([tensors[k].reshape(-1).to(torch.int32) for k in names])
    host = torch.empty(flat.shape, dtype=torch.int32, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    count_d2h(flat)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))

    def wait() -> Dict[str, np.ndarray]:
        done.synchronize()
        arr = host.numpy().copy()  # the pinned block goes back to the cache
        out, at = {}, 0
        for k, shape in zip(names, shapes):
            n = int(np.prod(shape, dtype=np.int64))
            out[k] = arr[at: at + n].reshape(shape)
            at += n
        return out

    return wait
