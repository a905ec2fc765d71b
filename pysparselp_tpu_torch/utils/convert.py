"""Carry a lowered problem and solver state from the JAX package to the port.

:func:`problem_from_jax_arrays` rebuilds the port's
:class:`~pysparselp_tpu_torch.problem.LPProblem` from a JAX ``LPProblem``
(read through ``numpy.asarray`` and matched by class name; this module
imports no jax): a JAX ``DiaMatrix`` is stripped of its Pallas
kernel-layout padding to ``vals[:ndiag, :nrows]`` (``vals_t`` likewise), the
batched solver's unpadded ``XlaDiaMatrix`` (``pysparselp_tpu/batch.py``)
comes across as a ``DiaMatrix`` plane for plane, a ``DenseMatrix`` whole, a ``PartitionMatrix`` as the port's
``PartitionMatrix``, a ``BsrMatrix`` as the port's ``BsrMatrix`` rebuilt
from the entries of its block-ELL tiles (bf16 tiles widened, which is
exact; the padding slots and the TPU grid's padding tile-rows hold zeros
and are dropped), a ``ColBlockMatrix`` block by
block, and the gather layouts (``EllMatrix``, ``SegmentedEllMatrix``,
``RoutedEllMatrix``) through their entries as a ``CsrMatrix``.
:func:`state_from_numpy` carries the ``(x, x3, y_eq, y_ineq)`` state and the
restart controller's ``rstate``; :func:`state_to_numpy` goes back.  Together
they let both packages run on the same lowered problem.
:func:`sharded_from_jax` carries one rank's shard of the JAX row-sharded
solver's data and state (its per-shard DIA layout) to the port's.
:func:`key_from_jax` / :func:`key_to_jax` carry a ``jax.random`` key (its
two uint32 words, as numpy) to the port's key pair and back, and
:func:`ell_rows_from_jax` a JAX ``EllMatrix``'s padded rows to the
:class:`~pysparselp_tpu_torch.ops.dca_sweep.EllRows` the coordinate sweep
walks.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import torch

from ..problem import (BsrMatrix, ColBlockMatrix, CsrMatrix, DenseMatrix,
                       DiaMatrix, LPProblem, PartitionMatrix, resolve_device,
                       resolve_dtype)


def _np(a):
    return np.asarray(a).astype(np.float64)


def _ell_entries(vals, cols):
    """``(rows, cols, vals)`` of an ELL table: row ``r`` holds
    ``vals[r, k]`` at column ``cols[r, k]`` (padding slots hold zeros)."""
    vals, cols = _np(vals), np.asarray(cols, np.int64)
    rows = np.broadcast_to(np.arange(vals.shape[0])[:, None], vals.shape)
    return rows.ravel(), cols.ravel(), vals.ravel()


def _csr(rows, cols, vals, shape):
    """The CSR of the given entries with the zero slots dropped."""
    csr = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=shape)
    csr.eliminate_zeros()
    return csr


def _bsr_entries(op):
    """The CSR of a JAX block-ELL ``BsrMatrix`` from its ``A`` tiles:
    ``tiles[r, k][t, m] = A[r·tm + m, cols[r, k]·tn + t]``."""
    tiles = _np(op.tiles)
    tn, tm = tiles.shape[2:]
    flat = np.flatnonzero(tiles)
    r, k, t, m = np.unravel_index(flat, tiles.shape)
    cols = np.asarray(op.cols, np.int64)[r, k] * tn + t
    return _csr(r * tm + m, cols, tiles.ravel()[flat], (op.nrows, op.ncols))


def operator_from_jax(op, dtype, device):
    """The port's operator for a JAX operator (``None`` stays ``None``)."""
    if op is None:
        return None
    kind = type(op).__name__
    shape = (op.nrows, op.ncols)
    if kind in ("DiaMatrix", "XlaDiaMatrix"):
        nd, ndt = len(op.offsets), len(op.offsets_t)
        return DiaMatrix.from_planes(
            _np(op.vals)[:nd, :op.nrows], op.offsets,
            _np(op.vals_t)[:ndt, :op.ncols], op.offsets_t,
            op.nrows, op.ncols, dtype, device)
    if kind == "DenseMatrix":
        return DenseMatrix(a=torch.as_tensor(_np(op.a), dtype=dtype,
                                             device=device),
                           nrows=op.nrows, ncols=op.ncols)
    if kind == "PartitionMatrix":
        return PartitionMatrix(
            vals=torch.as_tensor(_np(op.vals), dtype=dtype, device=device),
            col0=op.col0, stride=op.stride, width=op.width, nrows=op.nrows,
            ncols=op.ncols)
    if kind == "BsrMatrix":
        return BsrMatrix.from_scipy(_bsr_entries(op), dtype, device)
    if kind == "ColBlockMatrix":
        return ColBlockMatrix(
            blocks=tuple(operator_from_jax(b, dtype, device)
                         for b in op.blocks),
            col_starts=tuple(op.col_starts), nrows=op.nrows, ncols=op.ncols)
    if kind == "EllMatrix":
        csr = _csr(*_ell_entries(op.vals, op.cols), shape)
    elif kind == "SegmentedEllMatrix":
        # the segments hold the rows in width order; row_inv maps each
        # original row to its position in their concatenation
        pos = np.argsort(np.asarray(op.row_inv))
        rows, cols, vals, base = [], [], [], 0
        for seg_vals, seg_cols in op.segs:
            r, c, v = _ell_entries(seg_vals, seg_cols)
            rows.append(pos[base + r])
            cols.append(c)
            vals.append(v)
            base += seg_vals.shape[0]
        csr = _csr(np.concatenate(rows), np.concatenate(cols),
                   np.concatenate(vals), shape)
    elif kind == "RoutedEllMatrix":
        csr = op.to_scipy()
    else:
        raise TypeError(f"no port counterpart for a JAX {kind}")
    return CsrMatrix.from_scipy(csr, dtype, device)


def problem_from_jax_arrays(jprob, dtype=None, device="cpu") -> LPProblem:
    """The port's LPProblem with the JAX problem's arrays and operators."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)

    def vec(v):
        return None if v is None else torch.as_tensor(_np(v), dtype=dt,
                                                      device=dev)

    return LPProblem(
        c=vec(jprob.c), lb=vec(jprob.lb), ub=vec(jprob.ub),
        a_eq=operator_from_jax(jprob.a_eq, dt, dev), b_eq=vec(jprob.b_eq),
        a_ineq=operator_from_jax(jprob.a_ineq, dt, dev),
        b_lower=vec(jprob.b_lower), b_upper=vec(jprob.b_upper),
        n=int(jprob.n), m_eq=int(jprob.m_eq), m_ineq=int(jprob.m_ineq))


def _to_tensors(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_tensors(v, dtype, device) for v in tree)
    return torch.as_tensor(_np(tree), dtype=dtype, device=device)


def state_from_numpy(state, rstate=None, dtype=None, device="cpu"):
    """``(x, x3, y_eq, y_ineq)`` (and, if given, the restart controller's
    ``rstate`` dict: ``state``, ``omega``, ``mu_restart``, ``mu_last``,
    ``zx``, ``zeq``, ``zineq``) as tensors.  Returns the state tuple, or
    ``(state, rstate)`` when ``rstate`` is given."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)
    st = _to_tensors(tuple(state), dt, dev)
    if rstate is None:
        return st
    return st, _to_tensors(dict(rstate), dt, dev)


def state_to_numpy(tree):
    """float64 numpy copy of a state tuple / rstate dict of tensors."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(state_to_numpy(v) for v in tree)
    return tree.detach().to(device="cpu", dtype=torch.float64).numpy()


def sharded_from_jax(data, state, ndev, rank, dtype=None, device="cpu"):
    """Rank ``rank`` of an ``ndev``-rank mesh: the port's ``(data, state)``
    (as ``parallel.sharded_cp.build_sharded_cp_data`` returns them) for
    the JAX package's ``build_sharded_cp_data(..., operator="dia")`` data
    and its (possibly advanced) state, both read as numpy arrays with the
    JAX mesh axis first.

    The JAX shard height is rounded up to 128 rows and its values padded
    to the TPU kernel's layout; the port's shard height is ``ceil(m /
    ndev)``.  So each system's padding is stripped, its shards joined and
    its rows split again, and so are its ``sigma`` and the sharded duals
    ``y_eq``/``y_ineq``: a JAX sharded state resumes in the port."""
    from ..parallel.sharded_cp import local_rows, place_shard
    from ..parallel.sharded_dia import shard_planes

    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)
    n = np.asarray(data["c"]).size
    systems, ys = {}, {}
    for name in ("eq", "ineq"):
        if name not in data:
            continue
        sys_j = data[name]
        if "dia_vals" not in sys_j:
            raise TypeError("sharded_from_jax carries the per-shard DIA "
                            "layout (operator='dia') only")
        m = int(data[name + "_m"])
        ndev_j, rows_j = np.asarray(sys_j["b"]).shape
        offs_j = np.asarray(sys_j["dia_offs"], np.int64)
        ndiag = offs_j.shape[1]
        vals = np.concatenate(
            [_np(sys_j["dia_vals"][d])[:ndiag, :rows_j]
             for d in range(ndev_j)], axis=1)[:, :m]
        # shard 0 starts at row 0, so its offsets are the global ones
        sys_, rows_loc, m_pad = shard_planes(
            offs_j[0], vals, _np(sys_j["b"]).reshape(-1)[:m], n, ndev, rank)
        sys_ = dict(sys_, m=m, m_pad=m_pad, rows_loc=rows_loc)
        systems[name] = dict(sys_, sigma=local_rows(
            _np(sys_j["sigma"]).reshape(-1)[:m], sys_, rank))
        ys[name] = local_rows(_np(state["y_" + name]).reshape(-1)[:m], sys_,
                              rank)
    return place_shard(data["c"], data["lb"], data["ub"], data["diag_t"],
                       data["theta"], systems, _np(state["x"]),
                       _np(state["x3"]), ys, dt, dev)


def key_from_jax(key):
    """The port's key pair ``(k1, k2)`` from a raw JAX PRNG key (any array
    of its two uint32 words)."""
    k1, k2 = (int(v) & 0xFFFFFFFF for v in np.asarray(key).reshape(-1))
    return (k1, k2)


def key_to_jax(key):
    """The port's key pair as the raw JAX key's uint32 words (numpy; pass
    it to ``jnp.asarray``)."""
    return np.asarray(key, dtype=np.uint32)


def ell_rows_from_jax(ell, dtype=None, device="cpu"):
    """The padded row view of a JAX ``EllMatrix`` (its ``vals`` / ``cols``
    tables, padding slots included), as the coordinate sweep walks it."""
    from ..ops.dca_sweep import EllRows

    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)
    return EllRows.from_tables(_np(ell.vals), np.asarray(ell.cols),
                               ell.ncols, dt, dev)
