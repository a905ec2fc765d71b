"""H-CSR: the CSR sparse matrix-vector product, ``y[r] = Σ_{k=indptr[r]}^
{indptr[r+1]-1} vals[k] · x[indices[k]]`` (kernel source:
``csrc/csr_spmv.cu``).

Replaces ``pysparselp_tpu/ops/ell_routed.py::_routed_spmv_call`` (K7) and
``_routed_tiled_spmv_call`` (K8): what their host-built routes compute, an
unstructured ``y = A x``, in either orientation (the caller passes the CSR
of ``A`` or of ``Aᵀ``).  :func:`csr_spmv` launches the kernel for CUDA
tensors and runs :func:`csr_spmv_reference`, its plain PyTorch twin, for
CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _P, _I, _P)
# a row longer than LONG_STRIDES * width entries gets a thread block of its
# own (kLongStrides in csrc/csr_spmv.cu)
LONG_STRIDES = 32
MAX_NNZ = 2**31 - 1


def vector_width(nnz, n_out) -> int:
    """Lanes per row: the power of two in 2..32 at or above the mean row
    length."""
    mean = nnz / max(n_out, 1)
    width = 2
    while width < 32 and width < mean:
        width *= 2
    return width


def long_rows(indptr, width):
    """int32 indices of the rows the sub-warp launch leaves to the
    block-per-row launch (``indptr`` a numpy array or a tensor)."""
    lengths = np.diff(np.asarray(indptr.cpu() if torch.is_tensor(indptr)
                                 else indptr, np.int64))
    return np.nonzero(lengths > LONG_STRIDES * width)[0].astype(np.int32)


def csr_spmv_reference(indptr, indices, vals, x, n_out):
    """Plain twin: a gather of ``x`` and an ``index_add_`` into the rows
    (on the CPU it adds in entry order)."""
    rows = torch.repeat_interleave(
        torch.arange(n_out, device=vals.device), indptr.diff().long())
    y = torch.zeros(n_out, dtype=vals.dtype, device=vals.device)
    return y.index_add_(0, rows, vals * x[indices.long()])


def csr_spmv(indptr, indices, vals, x, n_out, long=None):
    """``y = A x`` for a CSR ``A``: ``indptr`` int32 (n_out + 1,),
    ``indices`` int32 (nnz,), ``vals`` (nnz,), ``x`` (n_in,), which may be
    a contiguous view at a storage offset.  ``long`` is :func:`long_rows`
    of this matrix as an int32 device tensor (computed here when None)."""
    if x.device.type == "cpu":
        return csr_spmv_reference(indptr, indices, vals, x, n_out)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmv runs on CUDA or the CPU, not {x.device}")
    nnz = vals.shape[0]
    if nnz > MAX_NNZ:
        raise ValueError(f"csr_spmv: {nnz} entries do not fit int32 indices")
    if (indptr.dtype != torch.int32 or indices.dtype != torch.int32
            or indptr.shape != (n_out + 1,) or indices.shape != (nnz,)):
        raise ValueError("csr_spmv: indptr (n_out + 1,) and indices (nnz,) "
                         "must be int32")
    width = vector_width(nnz, n_out)
    if long is None:
        long = torch.as_tensor(long_rows(indptr, width), device=x.device)
    _build.check_cuda(indptr, indices, vals, x, long, dtype=x.dtype,
                      device=x.device)
    y = torch.empty(n_out, dtype=x.dtype, device=x.device)
    fn = _build.function(f"pslp_csr_spmv_{_build.suffix(x.dtype)}",
                         _ARGTYPES)
    rc = fn(_build.ptr(indptr), _build.ptr(indices), _build.ptr(vals),
            _build.ptr(x), _build.ptr(y), n_out, width, _build.ptr(long),
            long.shape[0], _build.stream_ptr(x.device))
    _build.check(rc, "csr_spmv")
    csr_spmv.launches += 1
    return y


csr_spmv.launches = 0
