# Verbatim copy of pysparselp_tpu/sparse_host.py (tests/test_torch_slice.py holds the two equal).
"""Host-side blocked sparse-matrix containers used by the modeling layer.

The reference library models constraint matrices as scipy CSR matrices mutated
in place with a bolted-on ``blocks`` attribute (reference:
``pysparselp/SparseLP.py:75-112``).  Here the same capability is provided by a
small immutable-ish container, :class:`BlockedCSR`, that records every appended
batch of rows as a *block*.  Blocks are the structural metadata consumed by the
block-decomposition ADMM solver and by the TPU lowering (each block becomes a
shardable unit of rows).

Nothing in this module touches JAX: it is the pure-numpy host layer, designed
so that incremental model construction (dynamic shapes) stays on the host and
the device only ever sees one statically-shaped lowered problem.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse


class BlockedCSR:
    """A CSR matrix built by appending row batches, with per-batch block ranges.

    Equivalent capability to the reference's CSR + ``blocks`` hack
    (``pysparselp/SparseLP.py:75-104``) but append is amortized O(nnz) via
    chunk lists instead of ``np.append`` reallocation per call.

    ``blocks`` is a list of ``(row_start, row_end)`` half-open ranges, one per
    appended batch.  (The reference stores inclusive ends; we use half-open
    ranges internally and convert at the few places parity requires.)
    """

    def __init__(self, ncols: int = 0):
        self._data_chunks: list[np.ndarray] = []
        self._indices_chunks: list[np.ndarray] = []
        self._row_nnz_chunks: list[np.ndarray] = []
        self.nrows = 0
        self.ncols = ncols
        self.blocks: list[tuple[int, int]] = []
        self._csr_cache: scipy.sparse.csr_matrix | None = None

    # -- construction -----------------------------------------------------

    def copy(self) -> "BlockedCSR":
        out = BlockedCSR(self.ncols)
        out._data_chunks = list(self._data_chunks)
        out._indices_chunks = list(self._indices_chunks)
        out._row_nnz_chunks = list(self._row_nnz_chunks)
        out.nrows = self.nrows
        out.blocks = list(self.blocks)
        out._csr_cache = self._csr_cache
        return out

    def set_ncols(self, ncols: int) -> None:
        """Grow the column dimension (new variables added to the model)."""
        if ncols < self.ncols:
            raise ValueError("cannot shrink the number of columns")
        if ncols != self.ncols:
            self.ncols = ncols
            if self._csr_cache is not None:
                self._csr_cache = scipy.sparse.csr_matrix(
                    (
                        self._csr_cache.data,
                        self._csr_cache.indices,
                        self._csr_cache.indptr,
                    ),
                    shape=(self.nrows, ncols),
                )

    def append_rows(
        self, data: np.ndarray, indices: np.ndarray, row_nnz: np.ndarray
    ) -> None:
        """Append ``len(row_nnz)`` rows given flat data/col-index arrays."""
        data = np.asarray(data, dtype=np.float64).ravel()
        indices = np.asarray(indices, dtype=np.int64).ravel()
        row_nnz = np.asarray(row_nnz, dtype=np.int64).ravel()
        if data.size != indices.size or int(row_nnz.sum()) != data.size:
            raise ValueError("inconsistent CSR chunk")
        if indices.size and int(indices.max()) >= self.ncols:
            raise ValueError("column index out of range")
        self._data_chunks.append(data)
        self._indices_chunks.append(indices)
        self._row_nnz_chunks.append(row_nnz)
        n_new = int(row_nnz.size)
        self.blocks.append((self.nrows, self.nrows + n_new))
        self.nrows += n_new
        self._csr_cache = None

    def append_scipy(self, a) -> None:
        """Append all rows of a scipy sparse matrix as one block.

        Mirrors ``csr_matrix_append_rows`` (``pysparselp/SparseLP.py:93``).
        """
        a = scipy.sparse.csr_matrix(a)
        if a.shape[1] > self.ncols:
            self.set_ncols(a.shape[1])
        self.append_rows(a.data, a.indices, np.diff(a.indptr))

    def check(self) -> bool:
        """Validate internal consistency (equivalent of the reference's
        ``check_csr_matrix``, ``SparseLP.py:86-91``): per-row nnz counts
        match the stored data, column indices are in range, and the blocks
        metadata exactly tiles the appended rows."""
        total = 0
        for data, idx, cnt in zip(self._data_chunks, self._indices_chunks,
                                  self._row_nnz_chunks):
            assert data.size == idx.size == int(cnt.sum()), (
                "chunk nnz bookkeeping is inconsistent"
            )
            if idx.size:
                assert idx.min() >= 0 and idx.max() < self.ncols, (
                    "column index out of range"
                )
            total += int(cnt.size)
        assert total == self.nrows, "row count mismatch"
        prev_end = 0
        for start, end in self.blocks:
            assert start == prev_end and end >= start, (
                f"blocks must tile the rows contiguously, got {self.blocks}"
            )
            prev_end = end
        assert prev_end == self.nrows, "blocks do not cover all rows"
        return True

    # -- views ------------------------------------------------------------

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def nnz(self) -> int:
        return sum(c.size for c in self._data_chunks)

    def tocsr(self) -> scipy.sparse.csr_matrix:
        if self._csr_cache is None:
            if self.nrows == 0:
                self._csr_cache = scipy.sparse.csr_matrix((0, self.ncols))
            else:
                data = (
                    np.concatenate(self._data_chunks)
                    if self._data_chunks
                    else np.zeros(0)
                )
                indices = (
                    np.concatenate(self._indices_chunks)
                    if self._indices_chunks
                    else np.zeros(0, np.int64)
                )
                row_nnz = np.concatenate(self._row_nnz_chunks)
                indptr = np.zeros(self.nrows + 1, dtype=np.int64)
                np.cumsum(row_nnz, out=indptr[1:])
                self._csr_cache = scipy.sparse.csr_matrix(
                    (data, indices.astype(np.int32), indptr),
                    shape=(self.nrows, self.ncols),
                )
        return self._csr_cache

    @classmethod
    def from_scipy(cls, a, blocks: list[tuple[int, int]] | None = None) -> "BlockedCSR":
        a = scipy.sparse.csr_matrix(a)
        out = cls(a.shape[1])
        if a.shape[0]:
            out.append_rows(a.data, a.indices, np.diff(a.indptr))
        if blocks is not None:
            out.blocks = list(blocks)
        elif a.shape[0]:
            out.blocks = [(0, a.shape[0])]
        else:
            out.blocks = []
        return out

    def matvec(self, x: np.ndarray) -> np.ndarray:
        return self.tocsr() @ x

    def rmatvec(self, y: np.ndarray) -> np.ndarray:
        return self.tocsr().T @ y

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"BlockedCSR(shape={self.shape}, nnz={self.nnz}, "
            f"nblocks={len(self.blocks)})"
        )


def crd_matrix(cols, vals, broadcast: bool = True) -> scipy.sparse.csr_matrix:
    """Build a CSR matrix with constant nnz per row: ``m[i, cols[i, j]] = vals[i, j]``.

    Port of the reference's row-constant-nnz builder incl. broadcasting,
    duplicate-column validation, and zero-value dropping
    (``pysparselp/SparseLP.py:127-159``).
    """
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if cols.ndim != 2 or vals.ndim != 2:
        raise ValueError("cols and vals must be 2-D arrays")

    sorted_cols = np.sort(cols, axis=1)
    dup_rows = np.nonzero(np.any(np.diff(sorted_cols, axis=1) == 0, axis=1))[0]
    if dup_rows.size:
        raise ValueError(
            f"you have twice the same variable in {dup_rows.size} constraint"
            + ("s" if dup_rows.size > 1 else "")
            + f":\n{dup_rows}"
        )

    if broadcast:
        cols, vals = np.broadcast_arrays(cols, vals)
    if cols.shape != vals.shape:
        raise ValueError("cols and vals must have the same shape")

    keep = vals != 0
    vals_flat = vals[keep].astype(np.float64)
    cols_flat = cols[keep].astype(np.int64)
    indptr = np.concatenate(([0], np.cumsum(keep.sum(axis=1))))
    ncols = int(cols.max()) + 1 if cols.size else 0
    return scipy.sparse.csr_matrix(
        (vals_flat, cols_flat, indptr), shape=(cols.shape[0], ncols)
    )


def unique_rows(data: np.ndarray, prec: int = 5):
    """Unique rows of a 2-D float array at fixed precision.

    Parity helper for ``pysparselp/SparseLP.py:115-124``.
    """
    d_r = np.fix(data * 10**prec) / 10**prec + 0.0
    b = np.ascontiguousarray(d_r).view(
        np.dtype((np.void, d_r.dtype.itemsize * d_r.shape[1]))
    )
    _, ia = np.unique(b, return_index=True)
    _, ic = np.unique(b, return_inverse=True)
    return np.unique(b).view(d_r.dtype).reshape(-1, d_r.shape[1]), ia, ic
