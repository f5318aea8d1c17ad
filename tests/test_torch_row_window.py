"""Port parity: ``seqalib_tpu_torch.ops.row_window`` (plain version on the
CPU) against the JAX ``_row_window`` Pallas kernel in interpret mode.
Exact equality: the function moves int32 words."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqalib_tpu.ops.strip_pallas import _row_window
from seqalib_tpu_torch.ops import launches
from seqalib_tpu_torch.ops.row_window import row_window

N, W, L = 16, 512, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread keeps
    them fast when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 30, size=(N, W)).astype(np.int32)
    # the JAX kernel needs starts + L + 128 <= W: rows 0-3 sit at that edge
    starts = rng.integers(0, W - L - 128 + 1, size=N).astype(np.int32)
    starts[:4] = W - L - 128
    hi = rng.integers(0, L + 40, size=N).astype(np.int32)
    hi[4] = 0
    hi[5] = 1
    hi[6] = L
    return src, starts, hi


@pytest.mark.parametrize("lo", [0, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_row_window_matches_jax(lo, seed):
    src, starts, hi = _case(seed)
    want = np.asarray(
        _row_window(jnp.asarray(src), jnp.asarray(starts), jnp.asarray(hi),
                    L=L, lo=lo, fill=-7, interpret=True)
    )
    before = dict(launches)
    got = row_window(torch.from_numpy(src), torch.from_numpy(starts),
                     torch.from_numpy(hi), L=L, lo=lo, fill=-7)
    np.testing.assert_array_equal(got.numpy(), want)
    assert launches == before  # a CPU tensor runs the plain version


@pytest.mark.parametrize("lo", [0, 1])
def test_row_window_reversed_matches_jax_on_the_flipped_source(lo):
    src, starts, hi = _case(2)
    flipped = np.ascontiguousarray(src[:, ::-1])
    want = np.asarray(
        _row_window(jnp.asarray(flipped), jnp.asarray(starts), jnp.asarray(hi),
                    L=L, lo=lo, fill=-7, interpret=True)
    )
    got = row_window(torch.from_numpy(src), torch.from_numpy(starts),
                     torch.from_numpy(hi), L=L, lo=lo, fill=-7, reverse=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_window_reads_up_to_the_right_edge():
    # no superset-load rule in the port: a window may end exactly at W
    src = torch.arange(2 * 10, dtype=torch.int32).reshape(2, 10)
    out = row_window(src, torch.tensor([6, 0], dtype=torch.int32),
                     torch.tensor([4, 10], dtype=torch.int32), L=6, lo=0, fill=-1)
    assert out.tolist() == [[6, 7, 8, 9, -1, -1], [10, 11, 12, 13, 14, 15]]


@pytest.mark.parametrize("start,hi,lo", [(7, 4, 0), (-1, 3, 0), (-2, 3, 1)])
def test_row_window_refuses_an_overrun(start, hi, lo):
    src = torch.zeros((1, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside a source"):
        row_window(src, torch.tensor([start], dtype=torch.int32),
                   torch.tensor([hi], dtype=torch.int32), L=6, lo=lo, fill=0)


def test_row_window_unused_rows_may_start_anywhere():
    # rows whose range [lo, hi) is empty read nothing and are not checked
    src = torch.ones((2, 4), dtype=torch.int32)
    out = row_window(src, torch.tensor([99, -5], dtype=torch.int32),
                     torch.tensor([0, 1], dtype=torch.int32), L=3, lo=1, fill=5)
    assert out.tolist() == [[5, 5, 5], [5, 5, 5]]


def test_strip_bucket_refuses_an_overrun(monkeypatch):
    """A window start pushed out of its source inside ``strip_bucket``
    raises (on the CPU at once; on the card at the host copy, see
    test_torch_kernels_cuda.py)."""
    from seqalib_tpu_torch.ops import strip as strip_mod
    from seqalib_tpu_torch.scoring import scoring_params, tables_from_params

    real = strip_mod.row_window

    def shifted(src, starts, hi, **kw):
        return real(src, starts + src.shape[1], hi, **kw)

    monkeypatch.setattr(strip_mod, "row_window", shifted)
    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, size=(2, 12))
    tables = tables_from_params(scoring_params(2, -3, -5, -2, None), torch.device("cpu"))
    with pytest.raises(ValueError, match="outside a source"):
        strip_mod.strip_bucket(q, q.copy(), np.array([12, 9]), np.array([12, 10]), tables,
                               mode="local")
