"""H-BSR: the block-sparse matrix-vector product over a CSR of small dense
tiles, ``y = A x`` and ``y = Aᵀ x`` from one tile set (kernel source:
``csrc/bsr_spmv.cu``).

Replaces ``pysparselp_tpu/ops/bsr_pallas.py::_pallas_spmv`` (K6; body
``_make_spmv_kernel``, entry ``_tiled_apply``), which streams a 128×128
block-ELL (every tile-row padded to the longest) and keeps a second tile set
for ``Aᵀ``.  Here ``A`` is cut into ``T×T`` tiles (``T`` in :data:`TILES`)
and only the tiles that hold an entry are stored, contiguous in tile-row
order, row-major inside: ``tiles[k][i][j] = A[r·T+i, c·T+j]`` for the
``k``-th stored tile, at tile-row ``r`` and tile-column ``c = tile_col[k]``
(``k`` in ``row_ptr[r] .. row_ptr[r+1]-1``).  ``Aᵀ`` reads the same tiles
through a tile-column index: ``col_ptr``, ``tile_of`` (the tiles'
positions, tile-column by tile-column, tile-rows ascending within one) and
``tile_row`` (the tile-row of each, in that order).  The last tile-row and
tile-column are zero-padded inside their tiles.  :func:`bsr_spmv` launches
the kernel for CUDA tensors and runs :func:`bsr_spmv_reference`, its plain
PyTorch twin, for CPU tensors; it never falls back from one to the other.

Tiles are float32 or float64.  The JAX package's bf16 tile storage (and the
hi/lo split of ``x`` it needs on the TPU's matrix unit) is not ported: on
Hopper the product runs in float32 FMAs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import scipy.sparse
import torch

from . import _build

TILES = (8, 16, 32)      # the tile sizes the kernel is built for
DEFAULT_TILE = 16        # the fastest on the CLIME matrix (PERF.md, K6 row)
LANE_VALUES = 32         # tile values a lane loads per batch (kLaneValues)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P)


def _nonzero_coo(a):
    """``a`` as COO with duplicates summed and zeros dropped (a copy)."""
    csr = scipy.sparse.csr_matrix(a, dtype=np.float64, copy=True)
    csr.sum_duplicates()
    csr.eliminate_zeros()
    return csr.tocoo()


def _tile_grid(shape, tile):
    m, n = shape
    return -(-m // tile), -(-n // tile)


def _tile_ids(coo, tile):
    """The tile id ``r·T_cols + c`` of each entry of ``coo``."""
    t_cols = _tile_grid(coo.shape, tile)[1]
    return (coo.row // tile).astype(np.int64) * t_cols + coo.col // tile


def tile_counts(a, tile: int = DEFAULT_TILE):
    """``(n_tiles, longest tile-row, longest tile-column)`` of the tile set
    of ``a`` (the tiles :func:`build_tile_csr` stores), counted from the
    tile ids alone: no tile is built (the chooser's price)."""
    coo = _nonzero_coo(a)
    uniq = np.unique(_tile_ids(coo, tile))
    if not uniq.size:
        return 0, 0, 0
    t_cols = _tile_grid(coo.shape, tile)[1]
    return (int(uniq.size), int(np.bincount(uniq // t_cols).max()),
            int(np.bincount(uniq % t_cols).max()))


def build_tile_csr(a, tile: int = DEFAULT_TILE, dtype=np.float64):
    """Lower a scipy matrix to the host arrays of its tile set:
    ``(tiles, row_ptr, tile_col, col_ptr, tile_of, tile_row)``, the index
    arrays int32, ``tiles`` (n_tiles, T, T) of ``dtype``.  One pass over
    the entries' tile ids (``np.unique``) and one scatter; duplicates are
    summed and stored zeros dropped, so every stored tile holds an entry."""
    coo = _nonzero_coo(a)
    t_rows, t_cols = _tile_grid(coo.shape, tile)
    uniq, pos = np.unique(_tile_ids(coo, tile), return_inverse=True)
    rows = uniq // t_cols
    cols = uniq % t_cols
    tiles = np.zeros((uniq.size, tile, tile), dtype=dtype)
    tiles[pos, coo.row % tile, coo.col % tile] = coo.data

    def ptr(counts):
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    tile_of = np.argsort(cols, kind="stable")
    return (tiles, ptr(np.bincount(rows, minlength=t_rows)),
            cols.astype(np.int32), ptr(np.bincount(cols, minlength=t_cols)),
            tile_of.astype(np.int32), rows[tile_of].astype(np.int32))


class BsrOperand:
    """A matrix as its tile set on its device, ready to launch in both
    directions: ``tiles`` (n_tiles, T, T), ``row_ptr``/``tile_col`` for
    ``A x``, ``col_ptr``/``tile_of``/``tile_row`` for ``Aᵀ x`` (int32), the
    shape, and the kernel's two bound C entries.  Checked once here;
    :func:`bsr_spmv` checks only ``x``."""

    __slots__ = ("tiles", "row_ptr", "tile_col", "col_ptr", "tile_of",
                 "tile_row", "nrows", "ncols", "tile", "device", "dtype",
                 "device_index", "entries")

    def __init__(self, tiles, row_ptr, tile_col, col_ptr, tile_of, tile_row,
                 nrows, ncols):
        n_tiles, tile = tiles.shape[0], tiles.shape[-1]
        t_rows, t_cols = _tile_grid((nrows, ncols), tile)
        if tiles.shape != (n_tiles, tile, tile) or tile not in TILES:
            raise ValueError(f"bsr_spmv: tiles (n_tiles, T, T) with T in "
                             f"{TILES}, got {tuple(tiles.shape)}")
        index = (row_ptr, tile_col, col_ptr, tile_of, tile_row)
        if any(t.dtype != torch.int32 for t in index) or (
                row_ptr.shape, col_ptr.shape, tile_col.shape, tile_of.shape,
                tile_row.shape) != ((t_rows + 1,), (t_cols + 1,),
                                    *[(n_tiles,)] * 3):
            raise ValueError("bsr_spmv: row_ptr (T_rows + 1,), col_ptr "
                             "(T_cols + 1,) and tile_col, tile_of, tile_row "
                             "(n_tiles,) must be int32")
        if tiles.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"bsr_spmv takes float32 or float64, got "
                            f"{tiles.dtype}")
        dev = tiles.device
        for t in (tiles, *index):
            if t.device != dev or (dev.type == "cuda"
                                   and not t.is_contiguous()):
                raise ValueError("bsr_spmv: the tile set must be contiguous, "
                                 "on one device")
        if dev.type == "cuda" and tiles.data_ptr() % 16:
            raise ValueError("bsr_spmv: tiles must be 16-byte aligned")
        self.tiles, self.row_ptr, self.tile_col = tiles, row_ptr, tile_col
        self.col_ptr, self.tile_of, self.tile_row = col_ptr, tile_of, tile_row
        self.nrows, self.ncols, self.tile = int(nrows), int(ncols), tile
        self.device, self.dtype = dev, tiles.dtype
        self.device_index = self.entries = None
        if dev.type == "cuda":
            self.device_index = _build.device_index(dev)
            name = f"pslp_bsr_spmv_{_build.suffix(tiles.dtype)}"
            self.entries = (
                _build.Entry(name, _ARGTYPES, tiles, row_ptr, tile_col, None,
                             t_rows, tile, 0, self.ncols, self.nrows),
                _build.Entry(name, _ARGTYPES, tiles, col_ptr, tile_row,
                             tile_of, t_cols, tile, 1, self.nrows,
                             self.ncols))

    @property
    def n_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def stored_entries(self) -> int:
        return self.tiles.numel()

    @staticmethod
    def warp_batch_bytes(itemsize: int) -> int:
        """Bytes of tile values one warp keeps in flight: a batch of
        ``LANE_VALUES`` per lane, loaded before any of it is used."""
        return 32 * LANE_VALUES * itemsize

    @property
    def longest_lines(self):
        """Tiles of the longest tile-row and of the longest tile-column
        (what one warp streams in each direction)."""
        return tuple(int(p.diff().max()) if p.numel() > 1 else 0
                     for p in (self.row_ptr, self.col_ptr))

    def line_sum(self, parts, transpose: bool = False):
        """The outputs of per-tile partial results ``parts`` (n_tiles, T):
        summed per tile-row into the ``nrows`` outputs (rows of ``parts``
        in tile-row order), or with ``transpose`` per tile-column into the
        ``ncols`` outputs (rows of ``parts`` in ``tile_of`` order)."""
        ptr, n = ((self.col_ptr, self.ncols) if transpose
                  else (self.row_ptr, self.nrows))
        lines = ptr.numel() - 1
        dst = torch.repeat_interleave(
            torch.arange(lines, device=parts.device), ptr.diff().long())
        out = torch.zeros(lines, self.tile, dtype=parts.dtype,
                          device=parts.device)
        return out.index_add_(0, dst, parts).reshape(-1)[:n]

    def abs(self) -> "BsrOperand":
        """The operand of ``|A|`` (the same index arrays)."""
        return self._with_tiles(self.tiles.abs())

    def squared(self) -> "BsrOperand":
        """The operand of ``A∘A``, entries squared (the same index
        arrays)."""
        return self._with_tiles(self.tiles * self.tiles)

    def _with_tiles(self, tiles) -> "BsrOperand":
        return BsrOperand(tiles, self.row_ptr, self.tile_col, self.col_ptr,
                          self.tile_of, self.tile_row, self.nrows,
                          self.ncols)

    @staticmethod
    def from_scipy(a, dtype, device, tile: int = DEFAULT_TILE):
        """The operand of a scipy matrix (:func:`build_tile_csr`)."""
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        tiles, *index = build_tile_csr(a, tile, np_dtype)
        return BsrOperand(torch.as_tensor(tiles, device=device),
                          *(torch.as_tensor(v, device=device) for v in index),
                          *a.shape)


def bsr_spmv_reference(op: BsrOperand, x, transpose: bool = False):
    """Plain twin: the slices of ``x`` gathered by tile, one ``einsum`` per
    tile and a :meth:`BsrOperand.line_sum` per tile-row (``A x``, through
    ``tile_col``) or per tile-column (``Aᵀ x``, through
    ``tile_of``/``tile_row``)."""
    tile = op.tile
    n_in = op.nrows if transpose else op.ncols
    lines_in = -(-n_in // tile)
    xf = torch.zeros(lines_in * tile, dtype=x.dtype, device=x.device)
    xf[:n_in] = x
    xf = xf.reshape(lines_in, tile)
    if transpose:
        parts = torch.einsum("kij,ki->kj", op.tiles[op.tile_of.long()],
                             xf[op.tile_row.long()])
    else:
        parts = torch.einsum("kij,kj->ki", op.tiles, xf[op.tile_col.long()])
    return op.line_sum(parts, transpose)


def bsr_spmv(op: BsrOperand, x, transpose: bool = False):
    """``y = A x`` (or ``Aᵀ x`` with ``transpose``) for the tile set
    ``op``; ``x`` may be a contiguous view at any storage offset."""
    if x.device.type == "cpu":
        return bsr_spmv_reference(op, x, transpose)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmv runs on CUDA or the CPU, not {x.device}")
    n_in, n_out = (op.nrows, op.ncols) if transpose else (op.ncols,
                                                          op.nrows)
    if (x.device != op.device or x.dtype != op.dtype
            or x.shape != (n_in,) or not x.is_contiguous()):
        raise ValueError(
            f"bsr_spmv: x must be a contiguous ({n_in},) {op.dtype} tensor "
            f"on {op.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    y = torch.empty(n_out, dtype=op.dtype, device=op.device)
    if n_out:
        op.entries[bool(transpose)](x.data_ptr(), y.data_ptr(),
                                    _build.stream(op.device_index))
        bsr_spmv.launches += 1
    return y


bsr_spmv.launches = 0
