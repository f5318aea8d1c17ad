"""The port's launch guard (``seqalib_tpu_torch._build.launch``): a kernel
launch goes to the current CUDA device whatever stream it is given, so
every wrapper calls its C entry point through ``launch``, which makes the
tensors' device current for the call when another one is.  Checked here
without a card, with the library, the stream lookup and the device
switch replaced by recorders; ``tests/test_torch_kernels_cuda.py`` runs
the paths on a second card where one exists."""

import importlib
import inspect

import pytest
import torch

from seqalib_tpu_torch import _build

WRAPPERS = ["row_window", "strip_fill", "strip_walk", "band_fill", "band_walk",
            "sp_tile", "sp_walk", "wavefront"]


class _Lib:
    def __init__(self, rc=0):
        self.calls = []
        self.rc = rc

    def seqalib_demo(self, *args):
        self.calls.append((args, torch.cuda.current_device()))
        return self.rc

    def seqalib_error_string(self, rc):
        return b"demo error"


@pytest.fixture
def fake_card(monkeypatch):
    """Two devices, 0 current; the guard's switches recorded."""
    state = {"current": 0, "entered": []}

    class _Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            state["entered"].append(self.index)
            self.prev, state["current"] = state["current"], self.index

        def __exit__(self, *exc):
            state["current"] = self.prev
            return False

    lib = _Lib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "current_stream", lambda dev: 1000 + dev.index)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["current"])
    monkeypatch.setattr(torch.cuda, "device", _Device)
    return lib, state


@pytest.mark.parametrize("index", [0, 1])
def test_launch_runs_on_the_tensors_device(fake_card, index):
    lib, state = fake_card
    _build.launch("demo", torch.device("cuda", index), "seqalib_demo", 7, None)
    # the stream of the tensor's device, passed last; that device current
    assert lib.calls == [((7, None, 1000 + index), index)]
    assert state["entered"] == ([] if index == 0 else [1])  # no switch when current
    assert state["current"] == 0  # restored


def test_launch_raises_on_an_error_code(fake_card, monkeypatch):
    lib, state = fake_card
    lib.rc = 9
    with pytest.raises(RuntimeError, match="demo: CUDA error 9 \\(demo error\\)"):
        _build.launch("demo", torch.device("cuda", 1), "seqalib_demo")
    assert state["current"] == 0


@pytest.mark.parametrize("module", WRAPPERS)
def test_every_wrapper_launches_through_the_guard(module):
    src = inspect.getsource(importlib.import_module(f"seqalib_tpu_torch.ops.{module}"))
    assert "launch(" in src and '"seqalib_' in src
    assert "lib()" not in src and "current_stream" not in src
