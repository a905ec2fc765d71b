"""H-DCA: a dual coordinate ascent sweep over the constraint rows of one
system (kernel source: ``csrc/dca_sweep.cu``).

No ``pallas_call`` stands behind it: it computes what the JAX package's
compiled loops compute, ``_dca_sweep_eq`` / ``_dca_sweep_ineq``
(``pysparselp_tpu/solvers/dual_ascent.py:323`` and ``:342``, one
``fori_loop`` over every row in order) and one colour group of
``_dca_color_sweep`` (``:285``).  PyTorch has no device loop: written as
plain tensor operations a row step is some 20 launches, and a sweep of
Potts-300's 358,800 rows millions of them.

Each row ``i`` of the padded row view (:class:`EllRows`: width ``K`` = the
longest row, padding slots hold value 0 at column 0, as the JAX
``EllMatrix``) takes the exact coordinate step of
:func:`~pysparselp_tpu_torch.ops.linesearch.exact_dual_line_search` over
its ``K`` slots, with ``tie_t`` drawn from the key chain
(:mod:`~pysparselp_tpu_torch.utils.jax_prng`), guarded by ``active[i] &
isfinite``, projected to ``y >= 0`` for inequality rows, and adds the step
times the row into ``c̄``.

* :func:`dca_sweep` runs the sequential sweep: one launch for the whole
  system, the key split once per row, active or not, as in JAX; it returns
  ``(y, c̄, key)`` with the key after the last row.
* :func:`dca_color_step` runs one colour group (rows with pairwise
  disjoint columns), its ``(rows,)`` ties drawn from the group's sub key.

On CUDA tensors both launch the kernel (``launches`` counts them) or raise;
on CPU tensors they run :func:`dca_sweep_reference` /
:func:`dca_color_step_reference`, the JAX loop body in PyTorch.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import scipy.sparse
import torch

from ..utils.jax_prng import split, uniform, uniform_scalar
from . import _build
from .linesearch import exact_dual_line_search

# the longest row H-DCA takes (kMaxRow in csrc/dca_sweep.cu)
MAX_ROW = 1024
# the sequential sweep's shared memory (csrc/dca_sweep.cu): the draws' ring
# (kRing), one row's scratch of 7 K + 1 + kScanTmp entries, then c̄ where
# the whole fits a block's 232,448 bytes (kSmemLimit)
_RING, _SCAN_TMP, _SMEM_LIMIT = 256, 128, 232448

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
# vals, cols, b, active, y, c_bar, lb, ub, m, K, n, k1, k2, key_out,
# project, stream
_ARGTYPES_SWEEP = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _U, _P,
                   _I, _P)
# vals, cols, b, active, y, c_bar, lb, ub, rows, n_rows, K, k1, k2, project,
# stream
_ARGTYPES_COLOR = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _U, _U, _I,
                   _P)


@dataclasses.dataclass(frozen=True)
class EllRows:
    """The padded row view of a constraint matrix that the sweep walks:
    ``vals`` (m, K) and ``cols`` (m, K) int32, row ``i``'s entries first in
    column order, then zeros at column 0 (``EllMatrix.from_scipy``'s row
    form, width ``K`` = the longest row, at least 1)."""

    vals: torch.Tensor
    cols: torch.Tensor
    ncols: int

    @staticmethod
    def from_scipy(a, dtype, device) -> "EllRows":
        csr = scipy.sparse.csr_matrix(a)
        m, n = csr.shape
        cnt = np.diff(csr.indptr)
        k = max(int(cnt.max()) if cnt.size else 0, 1)
        vals = np.zeros((m, k))
        cols = np.zeros((m, k), np.int32)
        if csr.nnz:
            row_of = np.repeat(np.arange(m), cnt)
            pos = np.arange(csr.nnz) - csr.indptr[row_of]
            vals[row_of, pos] = csr.data
            cols[row_of, pos] = csr.indices
        return EllRows(
            vals=torch.as_tensor(vals, dtype=dtype, device=device),
            cols=torch.as_tensor(cols, device=device), ncols=n)


def cbar_in_smem(width, n, itemsize) -> bool:
    """Whether the sequential sweep keeps c̄ (``n`` entries) in shared
    memory beside the scratch of rows ``width`` slots wide."""
    base = (_RING + 7 * width + 1 + _SCAN_TMP) * itemsize
    return base + n * itemsize <= _SMEM_LIMIT


def _row_step(vals, cols, b_i, active_i, y_i, c_bar, lb, ub, tie_t, project):
    """One row's (or a batch of rows') step: ``(y_new, diff)``."""
    alpha = exact_dual_line_search(vals, b_i, c_bar[cols], ub[cols],
                                   lb[cols], tie_t)
    alpha = torch.where(active_i & torch.isfinite(alpha), alpha, 0.0)
    if project:
        y_new = torch.clamp_min(y_i + alpha, 0.0)
        return y_new, y_new - y_i
    return y_i + alpha, alpha


def dca_sweep_reference(ell, b, active, y, c_bar, lb, ub, key, project):
    """Plain twin of :func:`dca_sweep`: the rows in order, one split of the
    key and one draw per row, ``c̄`` updated slot by slot (padding slots
    add 0 at column 0, as the JAX scatter does)."""
    y, c_bar = y.clone(), c_bar.clone()
    cols = ell.cols.long()
    for i in range(ell.vals.shape[0]):
        key, sub = split(key)
        t = uniform_scalar(sub, c_bar.dtype)
        y_new, diff = _row_step(ell.vals[i], cols[i], b[i], active[i], y[i],
                                c_bar, lb, ub, t, project)
        y[i] = y_new
        c_bar.index_add_(0, cols[i], diff * ell.vals[i])
    return y, c_bar, key


def dca_color_step_reference(ell, b, active, y, c_bar, lb, ub, rows, sub,
                             project):
    """Plain twin of :func:`dca_color_step`: the group's rows searched as
    one batch, their ties ``uniform(sub, (rows,))``."""
    rows = rows.long()
    tie = uniform(sub, rows.shape, c_bar.dtype, c_bar.device)
    v, cl = ell.vals[rows], ell.cols[rows].long()
    y_new, diff = _row_step(v, cl, b[rows], active[rows], y[rows], c_bar, lb,
                            ub, tie, project)
    y, c_bar = y.clone(), c_bar.clone()
    y[rows] = y_new
    c_bar.index_add_(0, cl.reshape(-1), (diff[:, None] * v).reshape(-1))
    return y, c_bar


def _check(ell, tensors, what):
    if ell.vals.shape[1] > MAX_ROW:
        raise ValueError(
            f"{what}: a row of {ell.vals.shape[1]} slots is past H-DCA's "
            f"limit of {MAX_ROW} (MAX_ROW)")
    dev, dtype = ell.vals.device, ell.vals.dtype
    for t in tensors:
        if t.device != dev or not t.is_contiguous() or (
                t.is_floating_point() and t.dtype != dtype):
            raise ValueError(f"{what}: every tensor must be a contiguous "
                             f"{dtype} (or int/bool) tensor on {dev}")


def dca_sweep(ell: EllRows, b, active, y, c_bar, lb, ub, key, project):
    """The sequential sweep over every row of ``ell``: returns new ``(y,
    c̄, key)`` (the inputs are not modified).  ``active`` is a bool tensor
    per row, ``key`` the port's key pair, ``project`` clamps ``y >= 0``."""
    dev = ell.vals.device
    if dev.type == "cpu":
        return dca_sweep_reference(ell, b, active, y, c_bar, lb, ub, key,
                                   project)
    if dev.type != "cuda":
        raise ValueError(f"dca_sweep runs on CUDA or the CPU, not {dev}")
    m, k = ell.vals.shape
    n = c_bar.shape[0]
    active = active.to(torch.uint8)
    _check(ell, (ell.cols, b, active, y, c_bar, lb, ub), "dca_sweep")
    y, c_bar = y.clone(), c_bar.clone()
    key_out = torch.empty(2, dtype=torch.int64, device=dev)
    if m:
        fn = _build.entry(f"pslp_dca_sweep_{_build.suffix(ell.vals.dtype)}",
                          _ARGTYPES_SWEEP)
        fn(ell.vals.data_ptr(), ell.cols.data_ptr(), b.data_ptr(),
           active.data_ptr(), y.data_ptr(), c_bar.data_ptr(), lb.data_ptr(),
           ub.data_ptr(), m, k, n, key[0], key[1], key_out.data_ptr(),
           int(project), _build.stream(_build.device_index(dev)))
        dca_sweep.launches += 1
        k1, k2 = key_out.tolist()
        key = (k1, k2)
    return y, c_bar, key


dca_sweep.launches = 0


def dca_color_step(ell: EllRows, b, active, y, c_bar, lb, ub, rows, sub,
                   project):
    """One colour group ``rows`` (int32, pairwise disjoint columns) of the
    blocked sweep, its ties drawn from the sub key ``sub``: returns new
    ``(y, c̄)``."""
    dev = ell.vals.device
    if dev.type == "cpu":
        return dca_color_step_reference(ell, b, active, y, c_bar, lb, ub,
                                        rows, sub, project)
    if dev.type != "cuda":
        raise ValueError(f"dca_color_step runs on CUDA or the CPU, not {dev}")
    k = ell.vals.shape[1]
    active = active.to(torch.uint8)
    rows = rows.to(torch.int32)
    _check(ell, (ell.cols, b, active, y, c_bar, lb, ub, rows),
           "dca_color_step")
    y, c_bar = y.clone(), c_bar.clone()
    if rows.numel():
        fn = _build.entry(f"pslp_dca_color_step_{_build.suffix(ell.vals.dtype)}",
                          _ARGTYPES_COLOR)
        fn(ell.vals.data_ptr(), ell.cols.data_ptr(), b.data_ptr(),
           active.data_ptr(), y.data_ptr(), c_bar.data_ptr(), lb.data_ptr(),
           ub.data_ptr(), rows.data_ptr(), rows.numel(), k, sub[0], sub[1],
           int(project), _build.stream(_build.device_index(dev)))
        dca_color_step.launches += 1
    return y, c_bar


dca_color_step.launches = 0
