# Copy of pysparselp_tpu/integer/propagation.py; only _load_native differs: it builds
# _propagate.so into build/pysparselp_tpu_torch/, not beside the source.
"""Interval constraint propagation (bound tightening) with backtrack logging.

Host-side native component: the worklist algorithm is irreducibly
sequential-sparse, so it runs as a C++ kernel (``_propagate.cpp``, compiled on
first use with g++ and loaded through ctypes — this image has no pybind11),
with a pure-Python fallback mirroring the reference's
(``pysparselp/constraintPropagation.py:75-172`` /
``propagateConstraints.pyx:46-167``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_LIB = None
_LIB_TRIED = False


def _load_native():
    """Compile (once, cached under the repository's
    ``build/pysparselp_tpu_torch/`` by a hash of the source) and load the
    C++ kernel."""
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    import hashlib

    from ..ops._build import BUILD_DIR

    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "_propagate.cpp")
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            build_dir = str(BUILD_DIR)
        except OSError:
            build_dir = tempfile.mkdtemp()
        lib_path = os.path.join(build_dir, f"_propagate_{digest}.so")
        if not os.path.isfile(lib_path):
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 "-o", tmp, src],
                check=True, capture_output=True,
            )
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.propagate_constraints.restype = ctypes.c_int
        _LIB = lib
    except Exception:  # pragma: no cover - toolchain missing
        _LIB = None
    return _LIB


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def propagate_constraints(
    list_changed_var,
    x_l,
    x_u,
    a_csr,
    a_csc,
    b_lower,
    b_upper,
    back_ops,
    nb_iter=1000,
    use_native=True,
):
    """Tighten ``[x_l, x_u]`` under ``b_lower <= A x <= b_upper``.

    Mutates ``x_l``/``x_u`` in place and appends ``(type, i, old_value)``
    undo records to ``back_ops``.  Returns ``(1, None)`` if consistent or
    ``(0, violated_row)`` — the reference's contract
    (``constraintPropagation.py:75-172``).
    """
    changed = np.asarray(list(list_changed_var), dtype=np.int32)
    lib = _load_native() if use_native else None
    if lib is not None:
        cap = max(4096, 8 * (a_csr.nnz + changed.size))
        while True:
            bt = np.empty(cap, np.int32)
            bi = np.empty(cap, np.int32)
            bv = np.empty(cap, np.float64)
            blen = ctypes.c_int(0)
            vrow = np.zeros(1, np.int32)
            xl_snap = x_l.copy()
            xu_snap = x_u.copy()
            status = lib.propagate_constraints(
                _ptr(changed, ctypes.c_int32), changed.size,
                _ptr(x_l, ctypes.c_double), _ptr(x_u, ctypes.c_double),
                _ptr(a_csr.indices.astype(np.int32, copy=False), ctypes.c_int32),
                _ptr(a_csr.indptr.astype(np.int32, copy=False), ctypes.c_int32),
                _ptr(a_csr.data.astype(np.float64, copy=False), ctypes.c_double),
                _ptr(a_csc.indices.astype(np.int32, copy=False), ctypes.c_int32),
                _ptr(a_csc.indptr.astype(np.int32, copy=False), ctypes.c_int32),
                _ptr(np.asarray(b_lower, np.float64), ctypes.c_double),
                _ptr(np.asarray(b_upper, np.float64), ctypes.c_double),
                a_csr.shape[0], a_csr.shape[1],
                int(nb_iter),
                _ptr(bt, ctypes.c_int32), _ptr(bi, ctypes.c_int32),
                _ptr(bv, ctypes.c_double),
                cap, ctypes.byref(blen),
                _ptr(vrow, ctypes.c_int32),
            )
            if status == -1:  # log overflow: restore and retry bigger
                x_l[:] = xl_snap
                x_u[:] = xu_snap
                cap *= 4
                continue
            back_ops.extend(
                zip(bt[: blen.value].tolist(), bi[: blen.value].tolist(),
                    bv[: blen.value].tolist())
            )
            if status == 0:
                return 0, int(vrow[0])
            return 1, None

    return _propagate_python(
        changed, x_l, x_u, a_csr, a_csc, b_lower, b_upper, back_ops, nb_iter
    )


def _propagate_python(changed, x_l, x_u, a_csr, a_csc, b_lower, b_upper,
                      back_ops, nb_iter):
    """Pure-Python fallback (``constraintPropagation.py:75-172``)."""
    tol = 1e-5
    worklist = list(changed)
    for _ in range(nb_iter):
        if not worklist:
            break
        to_check = set()
        for i in worklist:
            to_check.update(
                a_csc.indices[a_csc.indptr[i]: a_csc.indptr[i + 1]].tolist()
            )
        worklist = []
        for j in sorted(to_check):
            idx = a_csr.indices[a_csr.indptr[j]: a_csr.indptr[j + 1]]
            dat = a_csr.data[a_csr.indptr[j]: a_csr.indptr[j + 1]]
            pos = dat > 0
            hi = float(dat[pos] @ x_u[idx[pos]] + dat[~pos] @ x_l[idx[~pos]])
            lo = float(dat[pos] @ x_l[idx[pos]] + dat[~pos] @ x_u[idx[~pos]])
            if hi < b_lower[j] or lo > b_upper[j]:
                return 0, int(j)
            for i, v in zip(idx, dat):
                if v > 0:
                    n_u = np.floor(tol + (b_upper[j] - lo + v * x_l[i]) / v)
                    n_l = np.ceil(-tol + (b_lower[j] - hi + v * x_u[i]) / v)
                else:
                    n_u = np.floor(tol + (b_lower[j] - hi + v * x_l[i]) / v)
                    n_l = np.ceil(-tol + (b_upper[j] - lo + v * x_u[i]) / v)
                has_changed = False
                if n_u < x_u[i]:
                    back_ops.append((1, int(i), float(x_u[i])))
                    x_u[i] = n_u
                    has_changed = True
                if n_l > x_l[i]:
                    back_ops.append((0, int(i), float(x_l[i])))
                    x_l[i] = n_l
                    has_changed = True
                if has_changed:
                    worklist.append(int(i))
    return 1, None


def revert(back_ops, x_l, x_u):
    """Undo a backtrack log in reverse (``constraintPropagation.py:175-180``)."""
    for t, i, v in reversed(back_ops):
        if t == 0:
            x_l[i] = v
        else:
            x_u[i] = v
