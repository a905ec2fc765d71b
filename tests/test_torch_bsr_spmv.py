"""H-BSR (``pysparselp_tpu_torch.ops.bsr_spmv``) and the port's block-sparse
operator: the plain twin against the JAX package's ``BsrMatrix`` (its
einsum path in float64, 1e-12; its Pallas kernel K6 in interpret mode in
float32, 2e-5, as ``tests/test_bsr.py`` runs them; each package builds its
own tiles from the same matrix), the tile builder (only nonzero tiles, the
matrix rebuilt exactly, the tile-column index), the verbatim copies
(``rcm_permutation``, ``apply_rcm_permutation``), and, on a card, the
kernel against its twin at every tile size.

JAX is imported inside the parity tests: the card machine, which runs this
file's ``cuda`` cases (``python -m pytest --noconftest -m cuda``), has none."""

import functools
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


@pytest.mark.parametrize("tile", ops.TILES)
@pytest.mark.parametrize("shape", SHAPES)
def test_twin_matches_jax_einsum_f64(shape, tile):
    """float64: the twin at ``tile``×``tile`` against the JAX ``BsrMatrix``
    at 16×16 (its einsum path) and scipy, both orientations, 1e-12."""
    import jax.numpy as jnp

    from pysparselp_tpu.ops.bsr_pallas import BsrMatrix as JaxBsr

    m, n = shape
    a = _random_sparse(m, n, 0.1, seed=m + n)
    jop = JaxBsr.from_scipy(a, dtype=jnp.float64, tm=16, tn=16)
    op = BsrMatrix.from_scipy(a, torch.float64, "cpu", tile=tile)
    x, y = _vectors(a, 0)
    got_x = op.matvec(torch.as_tensor(x)).numpy()
    got_y = op.rmatvec(torch.as_tensor(y)).numpy()
    for got, want in ((got_x, jop.matvec(jnp.asarray(x))),
                      (got_y, jop.rmatvec(jnp.asarray(y))),
                      (got_x, a @ x), (got_y, a.T @ y)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12,
                                   atol=1e-12)
    assert op.shape == a.shape and got_x.shape == (m,)
    assert op.tile == tile


@functools.lru_cache(maxsize=None)
def _pallas_interpret_f32(shape):
    """K6 in interpret mode on the matrix of ``shape`` (64×64 tiles, no
    bf16): the matrix, x, y, and JAX's A x and Aᵀ y."""
    import jax.numpy as jnp

    from pysparselp_tpu.ops import bsr_pallas

    m, n = shape
    a = _random_sparse(m, n, 0.05, seed=3)
    saved = bsr_pallas._FORCE_INTERPRET
    bsr_pallas._FORCE_INTERPRET = True
    try:
        jop = bsr_pallas.BsrMatrix.from_scipy(a, dtype=jnp.float32, tm=64,
                                              tn=64, allow_bf16=False)
        assert bsr_pallas._use_pallas(jop.tiles, jnp.zeros((n // 64 + 1, 64)))
        x, y = _vectors(a, 1, np.float32)
        return (a, x, y, np.asarray(jop.matvec(jnp.asarray(x))),
                np.asarray(jop.rmatvec(jnp.asarray(y))))
    finally:
        bsr_pallas._FORCE_INTERPRET = saved


@pytest.mark.parametrize("tile", ops.TILES)
@pytest.mark.parametrize("shape", [(128, 128), (200, 300)])
def test_twin_matches_pallas_interpret_f32(shape, tile):
    """float32: the twin at ``tile``×``tile`` against K6 itself at 64×64,
    run in interpret mode (``tests/test_bsr.py:49-62``), both orientations,
    2e-5."""
    a, x, y, want_x, want_y = _pallas_interpret_f32(shape)
    op = BsrMatrix.from_scipy(a, torch.float32, "cpu", tile=tile)
    np.testing.assert_allclose(op.matvec(torch.as_tensor(x)).numpy(),
                               want_x, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(op.rmatvec(torch.as_tensor(y)).numpy(),
                               want_y, rtol=2e-5, atol=2e-5)


def _ragged(shape, tile, seed):
    """A random matrix of ``shape`` with tile-row 1 and tile-column 1
    empty (where the shape has them), every tenth entry repeated (the
    repeats are summed), and two entries that cancel each other in the
    first position of tile-row 1 (an empty tile once summed)."""
    m, n = shape
    a = _random_sparse(m, n, 0.1, seed=seed).tocoo()
    keep = ((a.row // tile != 1) | (m <= tile)) & \
        ((a.col // tile != 1) | (n <= tile))
    rows, cols, vals = a.row[keep], a.col[keep], a.data[keep]
    rep = np.arange(0, rows.size, 10)
    cancel_row = min(tile, m - 1)
    return scipy.sparse.coo_matrix(
        (np.concatenate([vals, 0.5 * vals[rep], [0.75, -0.75]]),
         (np.concatenate([rows, rows[rep], [cancel_row] * 2]),
          np.concatenate([cols, cols[rep], [0, 0]]))), shape=shape)


@pytest.mark.parametrize("tile", ops.TILES)
@pytest.mark.parametrize("shape", SHAPES)
def test_tile_builder_stores_only_nonzero_tiles(shape, tile):
    """The builder stores exactly the tiles that hold an entry, in
    tile-row order (tile-columns ascending within a row), and the tiles
    rebuild the matrix exactly: no padding slot, stored entries = nonzero
    tiles × T², as the chooser counts them without building tiles."""
    a = _ragged(shape, tile, seed=sum(shape) + tile)
    dense = a.toarray()
    tiles, row_ptr, tile_col, col_ptr, tile_of, tile_row = \
        ops.build_tile_csr(a, tile)
    t_rows, t_cols = -(-shape[0] // tile), -(-shape[1] // tile)
    padded = np.zeros((t_rows * tile, t_cols * tile))
    padded[:shape[0], :shape[1]] = dense
    blocks = padded.reshape(t_rows, tile, t_cols, tile).swapaxes(1, 2)
    nonzero = np.argwhere(blocks.any(axis=(2, 3)))   # row-major order
    assert tiles.shape == (len(nonzero), tile, tile)
    assert all(t.any() for t in tiles)
    rows = np.repeat(np.arange(t_rows), np.diff(row_ptr))
    np.testing.assert_array_equal(
        np.column_stack([rows, tile_col]).reshape(-1, 2), nonzero)
    np.testing.assert_array_equal(tiles, blocks[rows, tile_col])
    rebuilt = np.zeros_like(padded)
    for t, r, c in zip(tiles, rows, tile_col):
        rebuilt[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = t
    np.testing.assert_array_equal(rebuilt[:shape[0], :shape[1]], dense)
    assert not rebuilt[shape[0]:].any() and not rebuilt[:, shape[1]:].any()
    if shape[0] > tile:
        assert row_ptr[1] == row_ptr[2]          # the empty tile-row
    if shape[1] > tile:
        assert col_ptr[1] == col_ptr[2]          # the empty tile-column
    rows_t = np.repeat(np.arange(t_cols), np.diff(col_ptr))
    assert ops.tile_counts(a, tile) == (
        len(nonzero), max(np.bincount(rows, minlength=1)),
        max(np.bincount(rows_t, minlength=1)))
    assert tiles.size == len(nonzero) * tile * tile
    for v in (row_ptr, tile_col, col_ptr, tile_of, tile_row):
        assert v.dtype == np.int32
    op = ops.BsrOperand.from_scipy(a, torch.float64, "cpu", tile)
    assert op.stored_entries == tiles.size and op.n_tiles == len(nonzero)


@pytest.mark.parametrize("tile", ops.TILES)
def test_transpose_index_visits_every_tile_once(tile):
    """``tile_of`` is a permutation of the stored tiles, ordered by
    tile-column and, within one, by tile-row; ``tile_row`` and ``col_ptr``
    name each tile's tile-row and tile-column."""
    a = _ragged((300, 260), tile, seed=tile)
    _tiles, row_ptr, tile_col, col_ptr, tile_of, tile_row = \
        ops.build_tile_csr(a, tile)
    n_tiles = tile_col.size
    np.testing.assert_array_equal(np.sort(tile_of), np.arange(n_tiles))
    rows = np.repeat(np.arange(row_ptr.size - 1), np.diff(row_ptr))
    cols = np.repeat(np.arange(col_ptr.size - 1), np.diff(col_ptr))
    np.testing.assert_array_equal(tile_col[tile_of], cols)
    np.testing.assert_array_equal(rows[tile_of], tile_row)
    order = np.lexsort((tile_row, cols))
    np.testing.assert_array_equal(order, np.arange(n_tiles))


@pytest.mark.parametrize("module,name", [
    ("problem", "rcm_permutation"), ("problem", "apply_rcm_permutation")])
def test_verbatim_copies(module, name):
    from pysparselp_tpu import problem as jpr

    port, jax_mod = {"problem": (ppr, jpr)}[module]
    assert inspect.getsource(getattr(port, name)) == \
        inspect.getsource(getattr(jax_mod, name))
    assert ppr.BSR_AUTO_MAX_ENTRIES == jpr.BSR_AUTO_MAX_ENTRIES


@pytest.mark.parametrize("tile", ops.TILES)
def test_reductions_count_padding_as_zero(tile):
    """``abs_power_rowsum``/``colsum`` over the tiles (``0**0 == 0``) equal
    the dense sums, p = 0, 1.5 and 0.5; the stored entries are the
    nonzero tiles × T²."""
    a = _random_sparse(90, 70, 0.08, seed=5)
    op = BsrMatrix.from_scipy(a, torch.float64, "cpu", tile=tile)
    ad = np.abs(a.toarray())
    for p in (0.0, 1.5, 0.5):
        want = np.where(ad > 0, ad ** p, 0.0)
        np.testing.assert_allclose(op.abs_power_rowsum(p).numpy(),
                                   want.sum(1), rtol=1e-12)
        np.testing.assert_allclose(op.abs_power_colsum(p).numpy(),
                                   want.sum(0), rtol=1e-12)
    assert op.nnz_padded == op.op.tiles.numel() == ops.tile_counts(
        a, tile)[0] * tile * tile
    assert op.op.longest_lines == ops.tile_counts(a, tile)[1:]


def test_wrapper_takes_only_cpu_or_cuda():
    a = _random_sparse(20, 30, 0.2, 1)
    op = BsrMatrix.from_scipy(a, torch.float32, "cpu", tile=16)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.bsr_spmv(op.op, torch.zeros(30, device="meta"))


def test_operand_checks_its_arrays():
    """A tile size the kernel is not built for, or index arrays of the
    wrong type or length, are refused when the operand is built."""
    a = _random_sparse(40, 30, 0.2, 2)
    tiles, *index = ops.build_tile_csr(a, 16)
    t = [torch.as_tensor(v) for v in (tiles, *index)]
    ops.BsrOperand(*t, 40, 30)
    with pytest.raises(ValueError, match="T in"):
        ops.BsrOperand(torch.zeros(t[0].shape[0], 12, 12), *t[1:], 40, 30)
    with pytest.raises(ValueError, match="int32"):
        ops.BsrOperand(t[0], t[1].long(), *t[2:], 40, 30)
    with pytest.raises(ValueError, match="int32"):
        ops.BsrOperand(*t, 60, 30)


CUDA_CASES = [("rand_130x260", (130, 260), False),
              ("rand_300x50", (300, 50), False),
              ("band_1000x900", (1000, 900), True),
              ("band_3000x2000", (3000, 2000), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_twin_on_cuda(dtype):
    """The kernel against its twin, both orientations from one tile set,
    8×8 to 32×32 tiles (the last tile-row and tile-column partial); x
    given as a view at a storage offset.  The twin sums in another order,
    so the limit scales with the row's absolute product."""
    dev = cuda_or_skip()
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    for name, shape, band in CUDA_CASES:
        a = _random_sparse(*shape, 0.05, seed=shape[0], clustered=band)
        x, y = _vectors(a, 2)
        for tile in ops.TILES:
            op = BsrMatrix.from_scipy(a, dtype, dev, tile=tile).op
            for v, transpose in ((x, False), (y, True)):
                buf = torch.as_tensor(np.concatenate([[7.0], v]),
                                      dtype=dtype, device=dev)
                xv = buf[1:]
                launches = ops.bsr_spmv.launches
                got = ops.bsr_spmv(op, xv, transpose)
                assert ops.bsr_spmv.launches == launches + 1
                again = ops.bsr_spmv(op, xv, transpose)
                want = ops.bsr_spmv_reference(op, xv, transpose)
                scale = ops.bsr_spmv_reference(op.abs(), xv.abs(), transpose)
                err = (got - want).abs()
                assert got.shape == want.shape
                assert torch.equal(got, again), (name, tile, transpose)
                assert bool((err <= rtol * scale).all()), (
                    name, tile, transpose, float(err.max()))
