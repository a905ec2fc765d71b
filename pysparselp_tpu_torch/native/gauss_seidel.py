# Copy of pysparselp_tpu/native/gauss_seidel.py; only _load_native differs: it
# builds _gauss_seidel_<sha16>.so into build/pysparselp_tpu_torch/, not beside the source.
"""Sequential SOR / bounded Gauss-Seidel (native C++ with numpy fallback).

Framework counterpart of the reference's first native kernel
(``pysparselp/gaussSiedel.pyx:21-153``): an in-place SOR sweep over CSR rows
with an optional visit order, and a bounded variant clamping each variable
to its box inside the sweep (the reference's default ADMM inner solver).

These run on the **host**: a sequential sweep cannot use the TPU.  The TPU
ADMM path uses the damped projected Jacobi analogue
(:mod:`pysparselp_tpu.solvers.admm`); this module exists for algorithmic
parity (``lp_admm(..., inner="gauss_seidel")`` host mode) and as a strong
smoother for host-side experimentation.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np
import scipy.sparse

_LIB = None
_LIB_TRIED = False


def _load_native():
    """Compile (once, cached under the repository's
    ``build/pysparselp_tpu_torch/`` by a hash of the source) and load the
    C++ sweeps."""
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    import hashlib

    from ..ops._build import BUILD_DIR

    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "_gauss_seidel.cpp")
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            build_dir = str(BUILD_DIR)
        except OSError:
            build_dir = tempfile.mkdtemp()
        lib_path = os.path.join(build_dir, f"_gauss_seidel_{digest}.so")
        if not os.path.isfile(lib_path):
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 "-o", tmp, src],
                check=True, capture_output=True,
            )
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.gauss_seidel.restype = ctypes.c_int
        lib.bounded_gauss_seidel.restype = ctypes.c_int
        _LIB = lib
    except Exception:  # pragma: no cover - toolchain missing
        _LIB = None
    return _LIB


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def _csr_arrays(m):
    m = scipy.sparse.csr_matrix(m)
    return (
        np.ascontiguousarray(m.data, np.float64),
        np.ascontiguousarray(m.indices, np.int32),
        np.ascontiguousarray(m.indptr, np.int32),
        m.shape[0],
    )


def _py_sweep(data, indices, indptr, x, b, lb, ub, order, w, maxiter):
    for _ in range(maxiter):
        for r in order:
            p0, p1 = indptr[r], indptr[r + 1]
            cols = indices[p0:p1]
            vals = data[p0:p1]
            is_diag = cols == r
            diag = vals[is_diag].sum()
            if diag == 0.0:
                continue
            acc = b[r] - vals[~is_diag] @ x[cols[~is_diag]]
            xi = (1.0 - w) * x[r] + w * acc / diag
            if lb is not None:
                xi = min(max(xi, lb[r]), ub[r])
            x[r] = xi


def gauss_seidel(m, x, b, w=1.0, maxiter=1, order=None):
    """``maxiter`` in-place SOR sweeps on ``M x = b``; returns ``x``."""
    data, indices, indptr, nrows = _csr_arrays(m)
    x = np.ascontiguousarray(np.asarray(x, np.float64))
    b = np.ascontiguousarray(np.asarray(b, np.float64))
    order_arr = (
        None if order is None
        else np.ascontiguousarray(np.asarray(order, np.int32))
    )
    lib = _load_native()
    if lib is not None:
        lib.gauss_seidel(
            _ptr(data, ctypes.c_double), _ptr(indices, ctypes.c_int32),
            _ptr(indptr, ctypes.c_int32), ctypes.c_int32(nrows),
            _ptr(x, ctypes.c_double), _ptr(b, ctypes.c_double),
            None if order_arr is None else _ptr(order_arr, ctypes.c_int32),
            ctypes.c_int32(0 if order_arr is None else order_arr.size),
            ctypes.c_double(w), ctypes.c_int32(maxiter),
        )
    else:  # pragma: no cover - toolchain missing
        _py_sweep(data, indices, indptr, x, b, None, None,
                  order if order is not None else range(nrows), w, maxiter)
    return x


class BoundedGaussSeidel:
    """Bounded Gauss-Seidel solver bound to one CSR matrix.

    ``solve(y, lb, ub, x, maxiter)`` runs in-place clamped sweeps on
    ``M x = y`` — behavioral equivalent of the reference's
    ``boundedGaussSeidelClass`` (``gaussSiedel.pyx:83-153``).
    """

    def __init__(self, m, w=1.0):
        self.data, self.indices, self.indptr, self.nrows = _csr_arrays(m)
        self.w = float(w)

    def solve(self, y, lb, ub, x, maxiter=1, order=None):
        x = np.ascontiguousarray(np.asarray(x, np.float64))
        y = np.ascontiguousarray(np.asarray(y, np.float64))
        lb = np.ascontiguousarray(np.asarray(lb, np.float64))
        ub = np.ascontiguousarray(np.asarray(ub, np.float64))
        order_arr = (
            None if order is None
            else np.ascontiguousarray(np.asarray(order, np.int32))
        )
        lib = _load_native()
        if lib is not None:
            lib.bounded_gauss_seidel(
                _ptr(self.data, ctypes.c_double),
                _ptr(self.indices, ctypes.c_int32),
                _ptr(self.indptr, ctypes.c_int32),
                ctypes.c_int32(self.nrows),
                _ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double),
                _ptr(lb, ctypes.c_double), _ptr(ub, ctypes.c_double),
                None if order_arr is None else _ptr(order_arr,
                                                    ctypes.c_int32),
                ctypes.c_int32(0 if order_arr is None else order_arr.size),
                ctypes.c_double(self.w), ctypes.c_int32(maxiter),
            )
        else:  # pragma: no cover - toolchain missing
            _py_sweep(self.data, self.indices, self.indptr, x, y, lb, ub,
                      order if order is not None else range(self.nrows),
                      self.w, maxiter)
        return x
