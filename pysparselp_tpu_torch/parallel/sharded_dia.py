"""Row-sharded DIA operators for the mesh-parallel CP solver (mirrors
``pysparselp_tpu/parallel/sharded_dia.py``).

An anchor-aligned system is cut into contiguous blocks of rows, one per
rank, and both SpMV directions of a shard run H-DIA
(:func:`~pysparselp_tpu_torch.ops.dia_spmv.dia_apply`), the kernel that
computes what ``pysparselp_tpu/ops/dia_pallas.py::_dia_matvec_pallas_dyn``
(K5) computes: a DIA product whose offsets are an int32 device tensor, so
one compiled kernel serves every shard.

* forward (``A_d x``): rank ``d`` owns rows ``[lo, hi)``; its values are
  ``vals[:, lo:hi]`` and its offsets ``offsets + lo`` (x is replicated, so
  the reads are absolute).
* transpose (``A_dᵀ y_d``): the shard's rows touch only the column window
  ``[wlo, wlo + w)``; the shard stores that slice of the transposed planes,
  zeroed where the entry's row belongs to another shard, with offsets
  ``wlo - lo - offsets`` into its own ``y_d``, and adds the window's
  product into the n-vector that the iteration then all-reduces.

The TPU layout is not ported: no kernel-layout padding of the values and
no rounding of the shard height or the window to 128 lanes (H-DIA bounds
checks every read, so an offset whose diagonal misses the shard entirely
reads zeros where K5 clamps it).  The shard height is ``ceil(m / ndev)``
and the window ``rows_loc + spread + 1`` columns, clipped to ``n``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse

from ..ops.dia_spmv import dia_apply


def _cdiv(a, b):
    return -(-a // b)


def sharded_dia_eligible(mats, ndev: int, dtype) -> bool:
    """Whether every system can run the per-shard DIA kernel: always, here.

    The JAX gate (``sharded_dia.py:45-76``) keeps the dynamic-offset TPU
    kernel to float32 and to a replicated x that fits its VMEM buffer.
    H-DIA runs float32 and float64 and reads x from global memory, so no
    system is refused; the function stays for the solver's call."""
    del mats, ndev, dtype
    return True


def dia_planes(a):
    """``(offsets, vals)`` of a scipy matrix: the sorted distinct
    ``col - row`` offsets and ``vals[d, r] = A[r, r + offsets[d]]``
    (``(ndiag, m)``; one zero diagonal when ``A`` has no entries)."""
    coo = scipy.sparse.coo_matrix(a)
    m = coo.shape[0]
    off_all = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    offsets = np.unique(off_all) if coo.nnz else np.zeros(1, np.int64)
    vals = np.zeros((offsets.size, m))
    np.add.at(vals, (np.searchsorted(offsets, off_all), coo.row), coo.data)
    return offsets, vals


def shard_planes(offsets, vals, b, n: int, ndev: int, rank: int):
    """Rank ``rank``'s shard of the DIA planes ``(offsets, vals)`` of an
    ``m x n`` system (``m = vals.shape[1]``) with right-hand side ``b``.

    Returns ``(data, rows_loc, m_pad)``: ``data`` holds host arrays, the
    forward ``dia_vals`` (ndiag, rows_loc) and int32 ``dia_offs``, the
    window ``dia_vals_t`` (ndiag, w) and int32 ``dia_offs_t``, the window
    start ``dia_wlo`` (an int), the shard's ``b`` and its ``row_mask`` (1
    on real rows, 0 on the padding past ``m``)."""
    offsets = np.asarray(offsets, np.int64)
    m = vals.shape[1]
    rows_loc = _cdiv(m, ndev) if m else 1
    m_pad = rows_loc * ndev
    lo, hi = rank * rows_loc, (rank + 1) * rows_loc
    real = max(0, min(hi, m) - lo)
    min_off, max_off = int(offsets.min()), int(offsets.max())

    fwd = np.zeros((offsets.size, rows_loc))
    fwd[:, :real] = vals[:, lo:lo + real]
    w = min(rows_loc + (max_off - min_off) + 1, n)
    wlo = int(np.clip(lo + min_off, 0, max(n - w, 0)))
    # vals_t[d, c] = A[c - offsets[d], c]: keep the entries whose row lies
    # in this shard's real rows
    cols = wlo + np.arange(w)
    rows = cols[None, :] - offsets[:, None]
    ok = (rows >= lo) & (rows < lo + real)
    d_idx = np.broadcast_to(np.arange(offsets.size)[:, None], rows.shape)
    vt = np.zeros((offsets.size, w))
    vt[ok] = vals[d_idx[ok], rows[ok]]

    b_loc = np.zeros(rows_loc)
    if b is not None:
        b_loc[:real] = np.asarray(b, np.float64)[lo:lo + real]
    row_mask = (np.arange(rows_loc) < real).astype(np.float64)
    data = dict(
        dia_vals=fwd,
        dia_offs=(offsets + lo).astype(np.int32),
        dia_vals_t=vt,
        # out j of the window reads y_glob[wlo + j - off], which is the
        # shard's y[wlo + j - off - lo]
        dia_offs_t=(wlo - lo - offsets).astype(np.int32),
        dia_wlo=wlo,
        b=b_loc,
        row_mask=row_mask,
    )
    return data, rows_loc, m_pad


def build_system_dia(a, b, ndev: int, rank: int):
    """Rank ``rank``'s DIA shard of the (aligned) system ``A x (=|<=) b``:
    ``(data, rows_loc, m_pad)`` as :func:`shard_planes` returns them."""
    a = scipy.sparse.csr_matrix(a)
    offsets, vals = dia_planes(a)
    return shard_planes(offsets, vals, b, a.shape[1], ndev, rank)


def local_matvec_dia(sys_l, x, n=None):
    """Shard-local ``A_d @ x`` (x replicated, absolute offsets), through
    the shard's prepared forward operand ``dia_fwd``."""
    del n
    return dia_apply(sys_l["dia_fwd"], x)


def local_rmatvec_dia(sys_l, y, n, out=None):
    """Shard-local ``A_dᵀ @ y_d`` added into the n-vector ``out`` (a new
    zero vector when None) at the window; the caller all-reduces it."""
    win = sys_l["dia_win"]
    yw = dia_apply(win, y)
    if out is None:
        out = y.new_zeros(n)
    out.narrow(0, sys_l["dia_wlo"], win.n_out).add_(yw)
    return out
