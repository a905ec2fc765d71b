"""The port's exact dual line search (``ops/linesearch.py``) against the
JAX package's (``pysparselp_tpu/ops/linesearch.py``) on the CPU: random
data, integer data full of ties, ±inf bounds, zero entries of ``da``, a
padded row along which the dual rises without bound, the XLA order of its
scans, and a batch of rows searched at once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysparselp_tpu.ops.linesearch import \
    exact_dual_line_search as jax_search
from pysparselp_tpu_torch.ops.linesearch import (exact_dual_line_search,
                                                 xla_cumsum)

torch.set_num_threads(1)
DTYPES = {"float64": (np.float64, torch.float64),
          "float32": (np.float32, torch.float32)}
_jax_search = jax.jit(jax_search)


def _case(kind, n, seed):
    rng = np.random.RandomState(seed)
    if kind == "random":
        da = rng.randn(n)
        c_bar = rng.randn(n)
        lb, ub = np.zeros(n), rng.rand(n) * 3
        db = rng.randn()
    elif kind == "integer":
        da = rng.randint(-2, 3, n).astype(float)
        c_bar = rng.randint(-3, 4, n).astype(float)
        lb, ub = np.zeros(n), np.ones(n)
        db = float(rng.randint(-3, 4))
    elif kind == "infinite":
        da = rng.randn(n) * (rng.rand(n) < 0.7)
        c_bar = rng.randn(n)
        lb = np.where(rng.rand(n) < 0.3, -np.inf, 0.0)
        ub = np.where(rng.rand(n) < 0.3, np.inf, 2.0)
        db = rng.randn()
    else:  # "padded": rows shorter than the width, the dual unbounded
        da = np.zeros(n)
        da[: n // 2] = 1.0
        c_bar = rng.rand(n)
        lb, ub = np.zeros(n), np.ones(n)
        db = -10.0
    return da, db, c_bar, ub, lb, rng.rand()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["random", "integer", "infinite", "padded"])
@pytest.mark.parametrize("n", [3, 17, 300])
def test_matches_jax(kind, n, dtype):
    npdt, tdt = DTYPES[dtype]
    for seed in range(8):
        da, db, c_bar, ub, lb, t = _case(kind, n, seed)
        t = npdt(t)
        want = np.asarray(_jax_search(
            *(jnp.asarray(v, npdt) for v in (da, db, c_bar, ub, lb)),
            jnp.asarray(t, npdt)))
        got = exact_dual_line_search(
            *(torch.as_tensor(np.asarray(v, npdt)) for v in (da, db, c_bar,
                                                            ub, lb)),
            float(t))
        np.testing.assert_array_equal(got.numpy(), want)


def test_padded_row_unbounded_is_inf():
    """A row of 2 real entries padded to 6: no real interval has derivative
    <= 0, so the search lands in the padding and returns +inf (the caller's
    ``isfinite`` guard then makes the step 0); an unpadded search would
    return the largest real breakpoint."""
    da = torch.tensor([1.0, 1.0, 0, 0, 0, 0], dtype=torch.float64)
    c_bar = torch.tensor([-0.5, -0.25, 0, 0, 0, 0], dtype=torch.float64)
    ones, zeros = torch.ones(6, dtype=torch.float64), torch.zeros(
        6, dtype=torch.float64)
    got = exact_dual_line_search(da, -5.0, c_bar, ones, zeros, 0.5)
    want = _jax_search(*(jnp.asarray(v.numpy()) for v in (
        da, torch.tensor(-5.0), c_bar, ones, zeros)), 0.5)
    assert float(want) == np.inf and float(got) == np.inf
    short = exact_dual_line_search(da[:2], -5.0, c_bar[:2], ones[:2],
                                   zeros[:2], 0.5)
    assert float(short) == 0.5


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_scan_rounds_like_xla(dtype):
    npdt, tdt = DTYPES[dtype]
    fwd = jax.jit(jnp.cumsum)
    rev = jax.jit(lambda h: jnp.cumsum(h[::-1])[::-1])
    for n in (1, 5, 16, 17, 33, 100, 257, 1160, 4500):
        x = np.random.RandomState(n).randn(n).astype(npdt)
        t = torch.as_tensor(x)
        np.testing.assert_array_equal(xla_cumsum(t).numpy(),
                                      np.asarray(fwd(x)))
        np.testing.assert_array_equal(xla_cumsum(t.flip(0)).flip(0).numpy(),
                                      np.asarray(rev(x)))


def test_batched_rows_match_row_by_row():
    """A (rows, K) batch gives each row's 1-D search (the colour step's
    use), and JAX's vmap of the same search."""
    rng = np.random.RandomState(3)
    rows, k = 40, 20
    da = rng.randint(-2, 3, (rows, k)).astype(float)
    c_bar = rng.randint(-3, 4, (rows, k)).astype(float)
    ub, lb = np.ones((rows, k)), np.zeros((rows, k))
    db = rng.randint(-3, 4, rows).astype(float)
    t = rng.rand(rows)
    got = exact_dual_line_search(*(torch.as_tensor(v) for v in (
        da, db, c_bar, ub, lb, t)))
    want = jax.jit(jax.vmap(jax_search))(*(jnp.asarray(v) for v in (
        da, db, c_bar, ub, lb, t)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for r in range(rows):
        one = exact_dual_line_search(*(torch.as_tensor(v[r]) for v in (
            da, db, c_bar, ub, lb)), float(t[r]))
        assert float(one) == float(got[r]) or (np.isnan(float(one))
                                               and np.isnan(float(got[r])))
