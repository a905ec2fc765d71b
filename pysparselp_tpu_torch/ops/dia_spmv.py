"""H-DIA: the DIA sparse matrix-vector product, ``y[r] = Σ_d vals[d, r] ·
x[r + offs[d]]`` (kernel source: ``csrc/dia_spmv.cu``).

Replaces ``pysparselp_tpu/ops/dia_pallas.py::_dia_matvec_pallas`` (K4) and
computes ``_dia_matvec_pallas_dyn``'s function (K5): the offsets are an
int32 device tensor.  :func:`dia_spmv` launches the kernel for CUDA tensors
and runs :func:`dia_spmv_reference`, its plain PyTorch twin, for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)


def dia_spmv_reference(vals, offs, x, n_out):
    """Plain twin: diagonals in ascending-offset order, reads outside ``x``
    contribute zero."""
    offsets = [int(o) for o in offs.tolist()]
    y = torch.zeros(n_out, dtype=vals.dtype, device=vals.device)
    if not offsets:
        return y
    n_in = x.shape[0]
    left = max(0, -min(offsets))
    right = max(0, max(offsets) + n_out - n_in)
    xp = F.pad(x, (left, right))
    for d, off in enumerate(offsets):
        y = y + vals[d, :n_out] * xp[left + off:left + off + n_out]
    return y


def dia_spmv(vals, offs, x, n_out):
    """``y = A x`` for a DIA operator: ``vals`` (ndiag, n_out), ``offs``
    int32 (ndiag,), ``x`` (n_in,)."""
    if x.device.type == "cpu":
        return dia_spmv_reference(vals, offs, x, n_out)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv runs on CUDA or the CPU, not {x.device}")
    _build.check_cuda(vals, offs, x, dtype=x.dtype, device=x.device)
    if offs.dtype != torch.int32 or vals.shape != (offs.shape[0], n_out):
        raise ValueError("dia_spmv: vals must be (ndiag, n_out), offs int32")
    y = torch.empty(n_out, dtype=x.dtype, device=x.device)
    fn = _build.function(f"pslp_dia_spmv_{_build.suffix(x.dtype)}", _ARGTYPES)
    rc = fn(_build.ptr(vals), _build.ptr(offs), offs.shape[0], _build.ptr(x),
            x.shape[0], _build.ptr(y), n_out, _build.stream_ptr(x.device))
    _build.check(rc, "dia_spmv")
    dia_spmv.launches += 1
    return y


dia_spmv.launches = 0
