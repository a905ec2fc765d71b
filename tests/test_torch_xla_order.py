"""The port's reductions in XLA's CPU order (``utils/xla_order.py``)
against JAX's jitted ``jnp.sum`` and ``jnp.dot`` on the CPU, bit for bit,
in float32 and float64 at every length the windows and tiles treat apart
and at the dual solvers' sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysparselp_tpu_torch.utils import xla_order

# lengths below, at and past one window of 32 and one GEMV tile of 8, two
# and three window levels, and the Potts grids' sizes
LENGTHS = (0, 1, 2, 3, 7, 8, 9, 31, 32, 33, 63, 100, 1023, 1024, 1025,
           5000, 33_000, 359_996)


def _vectors(n, dtype, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(n) * 10.0 ** rs.uniform(-3, 3, n)).astype(dtype)
    return x, rs.randn(n).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", LENGTHS)
def test_sum_and_dot_match_xla(n, dtype):
    x, y = _vectors(n, dtype, n)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got_sum = xla_order.xla_sum(tx)
    got_dot = xla_order.xla_dot(tx, ty)
    assert got_sum.dtype == got_dot.dtype == tx.dtype
    np.testing.assert_array_equal(got_sum.numpy(), jax.jit(jnp.sum)(x))
    np.testing.assert_array_equal(got_dot.numpy(), jax.jit(jnp.dot)(x, y))


def test_signed_zero_and_nan():
    """A sum of negative zeros is +0 (each reduction starts from +0), and
    a NaN entry gives NaN, as in XLA."""
    z = np.full(40, -0.0, np.float32)
    got = xla_order.xla_sum(torch.from_numpy(z)).numpy()
    want = np.asarray(jax.jit(jnp.sum)(z))
    assert got.tobytes() == want.tobytes()
    v = np.arange(50, dtype=np.float32)
    v[17] = np.nan
    assert np.isnan(xla_order.xla_sum(torch.from_numpy(v)).item())


def test_total_and_dot_dispatch_on_the_device():
    """CPU tensors take XLA's order; the helpers refuse other dtypes."""
    x, y = _vectors(100, np.float32, 3)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert xla_order.total(tx).item() == xla_order.xla_sum(tx).item()
    assert xla_order.dot(tx, ty).item() == xla_order.xla_dot(tx, ty).item()
    with pytest.raises(TypeError):
        xla_order.xla_dot(tx.double(), ty)


def test_failed_build_raises(monkeypatch, tmp_path):
    """Without a compiled chain the dot raises; nothing computes it
    another way."""
    import subprocess

    from pysparselp_tpu_torch.ops import _build

    def refuse(cmd, **kwargs):
        return subprocess.CompletedProcess(cmd, 1, "", "no compiler")

    monkeypatch.setattr(xla_order, "_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(xla_order.subprocess, "run", refuse)
    x, y = _vectors(10, np.float32, 4)
    with pytest.raises(RuntimeError, match="no compiler"):
        xla_order.xla_dot(torch.from_numpy(x), torch.from_numpy(y))
