"""H-BSR (``pysparselp_tpu_torch.ops.bsr_spmv``) and the port's block-sparse
operator: the plain twin against the JAX package's ``BsrMatrix`` (its
einsum path in float64, 1e-12; its Pallas kernel K6 in interpret mode in
float32, 2e-5, as ``tests/test_bsr.py`` runs them), the tile builder
against the JAX one, the verbatim copies (``bsr_padded_entries``,
``rcm_permutation``, ``apply_rcm_permutation``), and, on a card, the
kernel against its twin.

JAX is imported inside the parity tests: the card machine, which runs this
file's ``cuda`` cases (``python -m pytest --noconftest -m cuda``), has none."""

import inspect

import numpy as np
import pytest
import scipy.sparse
import torch

from pysparselp_tpu_torch import problem as ppr
from pysparselp_tpu_torch.ops import bsr_spmv as ops
from pysparselp_tpu_torch.problem import BsrMatrix
from torch_port_helpers import cuda_or_skip

torch.set_num_threads(1)


def _random_sparse(m, n, density, seed, clustered=False):
    """``tests/test_bsr.py:17-29``: uniform random, or a band of three
    entries per row."""
    rng = np.random.RandomState(seed)
    if clustered:
        rows = np.arange(m).repeat(3)
        cols = np.clip(rows // 3 * n // m + rng.randint(-2, 3, rows.size), 0,
                       n - 1)
        return scipy.sparse.coo_matrix((rng.randn(rows.size), (rows, cols)),
                                       shape=(m, n)).tocsr()
    return scipy.sparse.random(m, n, density=density, random_state=rng,
                               format="csr")


SHAPES = [(5, 7), (128, 128), (130, 260), (300, 50), (1, 1)]


def _vectors(a, seed, dtype=np.float64):
    rng = np.random.RandomState(seed)
    return (rng.randn(a.shape[1]).astype(dtype),
            rng.randn(a.shape[0]).astype(dtype))


@pytest.mark.parametrize("shape", SHAPES)
def test_twin_matches_jax_einsum_f64(shape):
    """16×16 tiles, float64: the twin against the JAX ``BsrMatrix`` (its
    einsum path) and scipy, both orientations, 1e-12."""
    import jax.numpy as jnp

    from pysparselp_tpu.ops.bsr_pallas import BsrMatrix as JaxBsr

    m, n = shape
    a = _random_sparse(m, n, 0.1, seed=m + n)
    jop = JaxBsr.from_scipy(a, dtype=jnp.float64, tm=16, tn=16)
    op = BsrMatrix.from_scipy(a, torch.float64, "cpu", tm=16, tn=16)
    x, y = _vectors(a, 0)
    got_x = op.matvec(torch.as_tensor(x)).numpy()
    got_y = op.rmatvec(torch.as_tensor(y)).numpy()
    for got, want in ((got_x, jop.matvec(jnp.asarray(x))),
                      (got_y, jop.rmatvec(jnp.asarray(y))),
                      (got_x, a @ x), (got_y, a.T @ y)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12,
                                   atol=1e-12)
    assert op.shape == a.shape and got_x.shape == (m,)


@pytest.mark.parametrize("shape", [(128, 128), (200, 300)])
def test_twin_matches_pallas_interpret_f32(shape, monkeypatch):
    """64×64 tiles, float32: the twin against K6 itself, run in interpret
    mode (``tests/test_bsr.py:49-62``), both orientations, 2e-5."""
    import jax.numpy as jnp

    from pysparselp_tpu.ops import bsr_pallas

    monkeypatch.setattr(bsr_pallas, "_FORCE_INTERPRET", True)
    m, n = shape
    a = _random_sparse(m, n, 0.05, seed=3)
    jop = bsr_pallas.BsrMatrix.from_scipy(a, dtype=jnp.float32, tm=64, tn=64,
                                          allow_bf16=False)
    assert bsr_pallas._use_pallas(jop.tiles, jnp.zeros((n // 64 + 1, 64)))
    op = BsrMatrix.from_scipy(a, torch.float32, "cpu", tm=64, tn=64)
    x, y = _vectors(a, 1, np.float32)
    np.testing.assert_allclose(op.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(jop.matvec(jnp.asarray(x))),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(op.rmatvec(torch.as_tensor(y)).numpy(),
                               np.asarray(jop.rmatvec(jnp.asarray(y))),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,tm,tn", [((130, 260), 16, 16),
                                         ((300, 50), 32, 16),
                                         ((1000, 900), 128, 128)])
def test_tile_builder_matches_jax(shape, tm, tn):
    """The port's tiles and tile ids are the JAX ones with the ROW_GROUP
    padding tile-rows (zero tiles at tile-column 0) stripped."""
    import jax.numpy as jnp

    from pysparselp_tpu.ops.bsr_pallas import _build_tile_ell

    a = _random_sparse(*shape, 0.02, seed=7, clustered=shape[0] == 1000)
    jt, jc, jrows, jcols, jn = _build_tile_ell(a, tm, tn, jnp.float64)
    tiles, cols, t_rows, t_cols, n_tiles = ops.build_tile_ell(a, tm, tn)
    assert (t_cols, n_tiles) == (jcols, jn) and t_rows == -(-shape[0] // tm)
    jt, jc = np.asarray(jt), np.asarray(jc)
    np.testing.assert_array_equal(tiles, jt[:t_rows])
    np.testing.assert_array_equal(cols, jc[:t_rows])
    assert not jt[t_rows:].any() and not jc[t_rows:].any()
    assert tiles.dtype == np.float64 and cols.dtype == np.int32


@pytest.mark.parametrize("module,name", [
    ("ops", "bsr_padded_entries"), ("problem", "rcm_permutation"),
    ("problem", "apply_rcm_permutation")])
def test_verbatim_copies(module, name):
    from pysparselp_tpu import problem as jpr
    from pysparselp_tpu.ops import bsr_pallas

    port, jax_mod = {"ops": (ops, bsr_pallas), "problem": (ppr, jpr)}[module]
    assert inspect.getsource(getattr(port, name)) == \
        inspect.getsource(getattr(jax_mod, name))
    assert ppr.BSR_AUTO_MAX_ENTRIES == jpr.BSR_AUTO_MAX_ENTRIES
    assert (ops.DEFAULT_TM, ops.DEFAULT_TN) == (bsr_pallas.DEFAULT_TM,
                                                bsr_pallas.DEFAULT_TN)


def test_reductions_count_padding_as_zero():
    """``abs_power_rowsum``/``colsum`` over the tiles (``0**0 == 0``) equal
    the dense sums, p = 0, 1.5 and 0.5, on 32×16 tiles."""
    a = _random_sparse(90, 70, 0.08, seed=5)
    op = BsrMatrix.from_scipy(a, torch.float64, "cpu", tm=32, tn=16)
    ad = np.abs(a.toarray())
    for p in (0.0, 1.5, 0.5):
        want = np.where(ad > 0, ad ** p, 0.0)
        np.testing.assert_allclose(op.abs_power_rowsum(p).numpy(),
                                   want.sum(1), rtol=1e-12)
        np.testing.assert_allclose(op.abs_power_colsum(p).numpy(),
                                   want.sum(0), rtol=1e-12)
    assert op.nnz_padded == op.tiles.numel() + op.tiles_t.numel()
    assert op.nnz_padded == ops.bsr_padded_entries(a, 32, 16)


def test_wrapper_takes_only_cpu_or_cuda():
    a = _random_sparse(20, 30, 0.2, 1)
    op = BsrMatrix.from_scipy(a, torch.float32, "cpu", tm=16, tn=16)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.bsr_spmv(op.tiles, op.cols, torch.zeros(30, device="meta"), 30,
                     20)


CUDA_CASES = [("rand_130x260", (130, 260), 16, 16, False),
              ("rand_300x50", (300, 50), 32, 64, False),
              ("band_1000x900", (1000, 900), 128, 128, True),
              ("band_3000x2000", (3000, 2000), 64, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_twin_on_cuda(dtype):
    """The kernel against its twin, both orientations, 16- to 128-wide
    tiles (the last tile-column partial); x given as a view at a storage
    offset.  The twin sums in another order, so the limit scales with the
    row's absolute product."""
    dev = cuda_or_skip()
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    for name, shape, tm, tn, band in CUDA_CASES:
        a = _random_sparse(*shape, 0.05, seed=shape[0], clustered=band)
        op = BsrMatrix.from_scipy(a, dtype, dev, tm=tm, tn=tn)
        x, y = _vectors(a, 2)
        for tiles, cols, v, n_in, n_out in (
                (op.tiles, op.cols, x, op.ncols, op.nrows),
                (op.tiles_t, op.cols_t, y, op.nrows, op.ncols)):
            buf = torch.as_tensor(np.concatenate([[7.0], v]), dtype=dtype,
                                  device=dev)
            xv = buf[1:]
            launches = ops.bsr_spmv.launches
            got = ops.bsr_spmv(tiles, cols, xv, n_in, n_out)
            assert ops.bsr_spmv.launches == launches + 1
            want = ops.bsr_spmv_reference(tiles, cols, xv, n_in, n_out)
            scale = ops.bsr_spmv_reference(tiles.abs(), cols, xv.abs(), n_in,
                                           n_out)
            err = (got - want).abs()
            assert got.shape == (n_out,)
            assert bool((err <= rtol * scale).all()), (name, float(err.max()))
