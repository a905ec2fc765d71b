"""H-BSR: the block-ELL sparse matrix-vector product
``y[r·TM+m] = Σ_k Σ_t tiles[r,k,t,m] · x[cols[r,k]·TN+t]`` (kernel source:
``csrc/bsr_spmv.cu``).

Replaces ``pysparselp_tpu/ops/bsr_pallas.py::_pallas_spmv`` (K6; body
``_make_spmv_kernel``, entry ``_tiled_apply``).  The matrix is cut into
dense ``TM×TN`` tiles and only the nonzero tiles are kept, padded per
tile-row to a fixed count ``K`` (an ELL of tiles); padding slots hold a
zero tile at tile-column 0.  Tiles are stored pre-transposed,
``tiles[r,k][t,m] = A[r·TM+m, cols[r,k]·TN+t]``, as in the JAX package.
``Aᵀ`` gets its own tile set, built the same way, so both directions are
scatter-free.  :func:`bsr_spmv` launches the kernel for CUDA tensors and
runs :func:`bsr_spmv_reference`, its plain PyTorch twin, for CPU tensors;
it never falls back from one to the other.

Tiles are float32 or float64.  The JAX package's bf16 tile storage (and the
hi/lo split of ``x`` it needs on the TPU's matrix unit) is not ported: on
Hopper the product runs in float32 FMAs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import scipy.sparse
import torch
import torch.nn.functional as F

from . import _build

DEFAULT_TM = 128
DEFAULT_TN = 128
MAX_TM = 1024                # one thread per tile row, one block per tile-row
MAX_SHARED_BYTES = 48 * 1024  # the x slice of one tile in shared memory

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)


def build_tile_ell(a, tm: int, tn: int, dtype=np.float64):
    """Lower a scipy matrix to ``(tiles, cols, t_rows, t_cols, n_tiles)``
    block-ELL host arrays.

    tiles: (T_rows, K, tn, tm) with tiles[r,k][t,m] = A[r*tm+m, cols[r,k]*tn+t]
    cols:  (T_rows, K) int32 tile-column ids (padding entries: col 0, zero tile)

    Edited copy of ``pysparselp_tpu/ops/bsr_pallas.py:50-94``
    (``_build_tile_ell``): ``T_rows`` is ``ceil(m / tm)`` (the TPU grid's
    ``ROW_GROUP`` padding is dropped), the tiles are numpy arrays of
    ``dtype`` (no bf16 storage)."""
    coo = scipy.sparse.coo_matrix(a)
    m, n = coo.shape
    t_rows = max(-(-m // tm), 1)
    t_cols = max(-(-n // tn), 1)
    tile_r = coo.row // tm
    tile_c = coo.col // tn
    # unique nonzero tiles, grouped by tile row
    tile_id = tile_r.astype(np.int64) * t_cols + tile_c
    uniq = np.unique(tile_id)
    ur = (uniq // t_cols).astype(np.int32)
    per_row = np.bincount(ur, minlength=t_rows)
    k = max(int(per_row.max()) if per_row.size else 0, 1)
    tiles = np.zeros((t_rows, k, tn, tm), dtype=dtype)
    cols = np.zeros((t_rows, k), dtype=np.int32)
    # slot of each unique tile within its row
    slot_of = np.zeros(uniq.size, np.int64)
    if uniq.size:
        starts = np.concatenate([[0], np.cumsum(per_row)])[ur]
        slot_of = np.arange(uniq.size) - starts
        cols[ur, slot_of] = (uniq % t_cols).astype(np.int32)
    # scatter nnz into their tiles
    pos = np.searchsorted(uniq, tile_id)
    tiles[tile_r, slot_of[pos], coo.col % tn, coo.row % tm] = coo.data
    return tiles, cols, t_rows, t_cols, int(uniq.size)


# bsr_padded_entries: verbatim copy of pysparselp_tpu/ops/bsr_pallas.py:349-368
def bsr_padded_entries(a, tm: int = DEFAULT_TM, tn: int = DEFAULT_TN) -> int:
    """Padded tile storage (entries) the BSR lowering would use — the
    auto-selection cost model in :func:`~pysparselp_tpu.problem.ell_from_scipy`.
    Cheap: only counts unique nonzero tiles, no tile materialization."""
    coo = scipy.sparse.coo_matrix(a)
    m, n = coo.shape
    t_cols = max(-(-n // tn), 1)
    t_rows = max(-(-m // tm), 1)
    tile_id = (coo.row // tm).astype(np.int64) * t_cols + coo.col // tn
    uniq = np.unique(tile_id)
    per_row = np.bincount((uniq // t_cols).astype(np.int64),
                          minlength=t_rows)
    k = max(int(per_row.max()) if per_row.size else 0, 1)
    # both orientations are stored
    tile_id_t = (coo.col // tn).astype(np.int64) * t_rows + coo.row // tm
    uniq_t = np.unique(tile_id_t)
    per_row_t = np.bincount((uniq_t // t_rows).astype(np.int64),
                            minlength=t_cols)
    k_t = max(int(per_row_t.max()) if per_row_t.size else 0, 1)
    return (t_rows * k + t_cols * k_t) * tm * tn


def bsr_spmv_reference(tiles, cols, x, n_in, n_out):
    """Plain twin: the x slices gathered by ``cols`` and one
    ``einsum("rktm,rkt->rm")`` (as the JAX package's ``_einsum_spmv``)."""
    tn = tiles.shape[2]
    t_cols = -(-n_in // tn)
    xf = F.pad(x, (0, t_cols * tn - n_in)).reshape(t_cols, tn)
    y = torch.einsum("rktm,rkt->rm", tiles, xf[cols.long()])
    return y.reshape(-1)[:n_out]


def bsr_spmv(tiles, cols, x, n_in, n_out):
    """``y = A x`` for a block-ELL ``A``: ``tiles`` (T_rows, K, TN, TM),
    ``cols`` int32 (T_rows, K) tile-column ids (every id below
    ``ceil(n_in / TN)``), ``x`` (n_in,), which may be a contiguous view at
    a storage offset; ``T_rows · TM >= n_out``."""
    if x.device.type == "cpu":
        return bsr_spmv_reference(tiles, cols, x, n_in, n_out)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmv runs on CUDA or the CPU, not {x.device}")
    t_rows, k, tn, tm = tiles.shape
    if cols.dtype != torch.int32 or cols.shape != (t_rows, k):
        raise ValueError("bsr_spmv: cols must be int32 (T_rows, K)")
    if x.shape != (n_in,) or t_rows * tm < n_out:
        raise ValueError(f"bsr_spmv: x of {tuple(x.shape)} for n_in={n_in}, "
                         f"{t_rows} tile-rows of {tm} for n_out={n_out}")
    if not 0 < tm <= MAX_TM or tn * x.element_size() > MAX_SHARED_BYTES:
        raise ValueError(f"bsr_spmv: {tn}x{tm} tiles (TM <= {MAX_TM}, "
                         f"TN x itemsize <= {MAX_SHARED_BYTES} bytes)")
    _build.check_cuda(tiles, cols, x, dtype=x.dtype, device=x.device)
    y = torch.empty(n_out, dtype=x.dtype, device=x.device)
    _build.entry(f"pslp_bsr_spmv_{_build.suffix(x.dtype)}", _ARGTYPES)(
        tiles.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
        t_rows, k, tn, tm, n_in, n_out,
        _build.stream(_build.device_index(x.device)))
    bsr_spmv.launches += 1
    return y


bsr_spmv.launches = 0
