"""H-CSR (``pysparselp_tpu_torch.ops.csr_spmv``) against scipy (float64)
and against the JAX package's routed gather kernels K7
(``_routed_spmv_call``, one table) and K8 (``_routed_tiled_spmv_call``,
tiled table) run in interpret mode (float32), through ``CsrMatrix``.

JAX is imported inside the parity tests: the card machine, which runs this
file's ``cuda`` cases (``python -m pytest --noconftest -m cuda``), has none."""

import numpy as np
import pytest
import scipy.sparse
import torch

from pysparselp_tpu_torch.ops import csr_spmv as ops
from pysparselp_tpu_torch.problem import CsrMatrix
from torch_port_helpers import cuda_or_skip

torch.set_num_threads(1)


def _rand(m, n, density, seed):
    rng = np.random.RandomState(seed)
    return scipy.sparse.random(m, n, density=density, random_state=rng,
                               format="csr")


def _hot_column():
    """Every row references column 7 (``tests/test_ell_routed.py:43-55``)."""
    m, n = 300, 200
    a = scipy.sparse.csr_matrix((np.ones(m), (np.arange(m), np.full(m, 7))),
                                shape=(m, n))
    return (a + _rand(m, n, 0.02, seed=3)).tocsr()


def _empty_and_dense_rows():
    """Empty rows beside one full row (``tests/test_ell_routed.py:57-68``)."""
    a = scipy.sparse.lil_matrix((64, 256))
    a[10] = 1.0
    a[20, 5] = 3.0
    return a.tocsr()


def _long_rows():
    """Rows far past the sub-warp limit (the k-medians ``used[c]`` shape):
    a few 5,000-entry rows among 2-entry rows, and empty rows."""
    rng = np.random.RandomState(6)
    m, n = 400, 6000
    rows = [np.repeat(np.arange(0, m, 2), 2)]
    cols = [rng.randint(0, n, rows[0].size)]
    for r in (3, 101, 257):
        rows.append(np.full(5000, r))
        cols.append(rng.choice(n, 5000, replace=False))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return scipy.sparse.csr_matrix((rng.randn(rows.size), (rows, cols)),
                                   shape=(m, n))


MATRICES = {
    "rand_200x200": lambda: _rand(200, 200, 0.03, 403),
    "rand_500x120": lambda: _rand(500, 120, 0.05, 623),
    "rand_90x700": lambda: _rand(90, 700, 0.02, 793),
    "hot_column": _hot_column,
    "empty_and_dense_rows": _empty_and_dense_rows,
    "long_rows": _long_rows,
}


def _vectors(a, seed, dtype=np.float64):
    rng = np.random.RandomState(seed)
    return (rng.randn(a.shape[1]).astype(dtype),
            rng.randn(a.shape[0]).astype(dtype))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_twin_matches_scipy_f64(name):
    a = MATRICES[name]()
    x, y = _vectors(a, 0)
    op = CsrMatrix.from_scipy(a, torch.float64, "cpu")
    np.testing.assert_allclose(op.matvec(torch.as_tensor(x)).numpy(), a @ x,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op.rmatvec(torch.as_tensor(y)).numpy(),
                               a.T @ y, rtol=1e-12, atol=1e-12)
    for p in (0.0, 1.0, 2.0):
        ap = abs(a)
        ap.data = np.where(ap.data > 0, ap.data ** p, 0.0)
        np.testing.assert_allclose(op.abs_power_rowsum(p).numpy(),
                                   ap @ np.ones(a.shape[1]), rtol=1e-12)
        np.testing.assert_allclose(op.abs_power_colsum(p).numpy(),
                                   ap.T @ np.ones(a.shape[0]), rtol=1e-12)
    assert op.shape == a.shape and op.nnz_padded == a.nnz


ROUTED = [("k7", "rand_200x200"), ("k7", "hot_column"),
          ("k7", "empty_and_dense_rows"), ("k8", "tiled_800x500")]


@pytest.mark.parametrize("kernel,name", ROUTED)
def test_twin_matches_routed_kernels_f32(kernel, name):
    """f32: the twin against the routed Pallas kernels in interpret mode,
    both orientations; atol/rtol 2e-5 as ``tests/test_ell_routed.py``."""
    import jax.numpy as jnp

    from pysparselp_tpu.ops.ell_routed import RoutedEllMatrix

    if kernel == "k8":
        a = _rand(800, 500, 0.015, seed=33)
        jop = RoutedEllMatrix.from_scipy(a, dtype=jnp.float32, qt=2)
        assert jop.tiles > 1 and jop.tiles_t > 1
    else:
        a = MATRICES[name]()
        jop = RoutedEllMatrix.from_scipy(a, dtype=jnp.float32)
        assert jop.tiles == 1
    x, y = _vectors(a, 1, np.float32)
    op = CsrMatrix.from_scipy(a, torch.float32, "cpu")
    np.testing.assert_allclose(op.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(jop.matvec(jnp.asarray(x))),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(op.rmatvec(torch.as_tensor(y)).numpy(),
                               np.asarray(jop.rmatvec(jnp.asarray(y))),
                               rtol=2e-5, atol=2e-5)


def test_launch_plan():
    """Lanes per row follow the mean row length; rows past 32 strides of
    them go to the block-per-row launch."""
    assert [ops.vector_width(nnz, 10) for nnz in (0, 20, 21, 130, 10_000)] \
        == [2, 2, 4, 16, 32]
    a = _long_rows()
    width = ops.vector_width(a.nnz, a.shape[0])
    np.testing.assert_array_equal(ops.long_rows(a.indptr, width),
                                  [3, 101, 257])
    op = CsrMatrix.from_scipy(a, torch.float64, "cpu")
    assert op.long.tolist() == [3, 101, 257] and op.long.dtype == torch.int32
    assert op.long_t.numel() == 0


def test_wrapper_takes_only_cpu_or_cuda():
    a = _rand(20, 30, 0.2, 1)
    op = CsrMatrix.from_scipy(a, torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.csr_spmv(op.indptr, op.indices, op.vals,
                     torch.zeros(30, device="meta"), 20)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_twin_on_cuda(dtype):
    """The kernel against its twin, both orientations, on every fixture;
    x given as a view at a storage offset.  The twin adds in another
    order, so the limit scales with the row's absolute product."""
    dev = cuda_or_skip()
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    for name, make in sorted(MATRICES.items()):
        a = make()
        op = CsrMatrix.from_scipy(a, dtype, dev)
        x, y = _vectors(a, 2)
        for idx, ptr, vals, long, v, n_out, absa in (
                (op.indices, op.indptr, op.vals, op.long, x, op.nrows, abs(a)),
                (op.indices_t, op.indptr_t, op.vals_t, op.long_t, y,
                 op.ncols, abs(a).T)):
            buf = torch.as_tensor(np.concatenate([[7.0], v]), dtype=dtype,
                                  device=dev)
            xv = buf[1:]
            launches = ops.csr_spmv.launches
            got = ops.csr_spmv(ptr, idx, vals, xv, n_out, long)
            assert ops.csr_spmv.launches == launches + 1
            want = ops.csr_spmv_reference(ptr, idx, vals, xv, n_out)
            scale = torch.as_tensor(absa @ np.abs(v), dtype=dtype,
                                    device=dev)
            err = (got - want).abs()
            assert bool((err <= rtol * scale).all()), (name, float(err.max()))
