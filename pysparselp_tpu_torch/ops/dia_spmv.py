"""H-DIA: the DIA sparse matrix-vector product, ``y[r] = Σ_d vals[d, r] ·
x[r + offs[d]]`` (kernel source: ``csrc/dia_spmv.cu``).

Replaces ``pysparselp_tpu/ops/dia_pallas.py::_dia_matvec_pallas`` (K4) and
computes ``_dia_matvec_pallas_dyn``'s function (K5): the offsets are an
int32 device tensor.  :func:`dia_apply` (on a :class:`DiaOperand`, checked once) and
:func:`dia_spmv` launch the kernel for CUDA tensors and run
:func:`dia_spmv_reference`, its plain PyTorch twin, for CPU tensors; they
never fall back from one to the other.

H-DIA-B, the batched product ``Y[r, b] = Σ_d vals[d, r] · X[r + offs[d],
b]`` over ``X`` of shape ``(n_in, B)`` (batch-last, contiguous), is the
same module's second kernel entry: :func:`dia_spmm` (on the same
:class:`DiaOperand`) launches it for CUDA tensors and runs
:func:`dia_spmm_reference` for CPU tensors.  Column ``b`` of its result
equals :func:`dia_apply` of ``X[:, b]`` bit for bit on both sides.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
_ARGTYPES_B = _ARGTYPES[:-1] + (ctypes.c_int, ctypes.c_void_p)


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


def dia_spmm_reference(vals, offs, x, n_out):
    """Plain twin of H-DIA-B: :func:`dia_spmv_reference`'s shift loop with
    a trailing batch axis, ``x`` (n_in, B) -> (n_out, B)."""
    offsets = [int(o) for o in offs.tolist()]
    y = torch.zeros((n_out, x.shape[1]), dtype=vals.dtype, device=vals.device)
    if not offsets:
        return y
    n_in = x.shape[0]
    left = max(0, -min(offsets))
    right = max(0, max(offsets) + n_out - n_in)
    xp = F.pad(x, (0, 0, left, right))
    for d, off in enumerate(offsets):
        y = y + vals[d, :n_out, None] * xp[left + off:left + off + n_out]
    return y


class DiaOperand:
    """One orientation of a DIA operator on its device, ready to launch:
    ``vals`` (ndiag, n_out), ``offs`` int32 (ndiag,) and the kernel's bound
    C entry.  Checked once here; :func:`dia_apply` checks only ``x``."""

    __slots__ = ("vals", "offs", "n_out", "device", "dtype", "device_index",
                 "entry", "entry_b")

    def __init__(self, vals, offs, n_out):
        dev = vals.device
        if offs.dtype != torch.int32 or vals.shape != (offs.shape[0], n_out):
            raise ValueError("dia_spmv: vals must be (ndiag, n_out), offs "
                             "int32")
        if vals.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"kernels take float32 or float64, got "
                            f"{vals.dtype}")
        for t in (vals, offs):
            if t.device != dev:
                raise ValueError(f"tensor on {t.device}, expected {dev}")
            if dev.type == "cuda" and not t.is_contiguous():
                raise ValueError("kernel arguments must be contiguous")
        self.vals, self.offs, self.n_out = vals, offs, int(n_out)
        self.device, self.dtype = dev, vals.dtype
        self.device_index = self.entry = self.entry_b = None
        if dev.type == "cuda":
            self.device_index = _build.device_index(dev)
            sfx = _build.suffix(vals.dtype)
            self.entry = _build.Entry(f"pslp_dia_spmv_{sfx}", _ARGTYPES,
                                      vals, offs, offs.shape[0])
            self.entry_b = _build.Entry(f"pslp_dia_spmm_{sfx}", _ARGTYPES_B,
                                        vals, offs, offs.shape[0])


def dia_apply(op: DiaOperand, x):
    """``y = A x`` for the DIA operand ``op``, ``x`` (n_in,)."""
    if x.device.type == "cpu":
        return dia_spmv_reference(op.vals, op.offs, x, op.n_out)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv runs on CUDA or the CPU, not {x.device}")
    if (x.device != op.device or x.dtype != op.dtype or x.dim() != 1
            or not x.is_contiguous()):
        raise ValueError(f"dia_spmv: x must be a contiguous 1-D {op.dtype} "
                         f"tensor on {op.device}, got {x.dtype} on "
                         f"{x.device}")
    y = torch.empty(op.n_out, dtype=op.dtype, device=op.device)
    op.entry(x.data_ptr(), x.shape[0], y.data_ptr(), op.n_out,
             _build.stream(op.device_index))
    dia_spmv.launches += 1
    return y


def dia_spmm(op: DiaOperand, x):
    """``Y = A X`` for the DIA operand ``op``, ``x`` (n_in, B) batch-last
    (H-DIA-B)."""
    if x.device.type == "cpu":
        return dia_spmm_reference(op.vals, op.offs, x, op.n_out)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmm runs on CUDA or the CPU, not {x.device}")
    if (x.device != op.device or x.dtype != op.dtype or x.dim() != 2
            or not x.is_contiguous()):
        raise ValueError(f"dia_spmm: x must be a contiguous (n_in, B) "
                         f"{op.dtype} tensor on {op.device}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    nb = x.shape[1]
    y = torch.empty((op.n_out, nb), dtype=op.dtype, device=op.device)
    if op.n_out and nb:
        op.entry_b(x.data_ptr(), x.shape[0], y.data_ptr(), op.n_out, nb,
                   _build.stream(op.device_index))
        dia_spmm.launches += 1
    return y


dia_spmm.launches = 0


def dia_spmv(vals, offs, x, n_out):
    """``y = A x`` for a DIA operator: ``vals`` (ndiag, n_out), ``offs``
    int32 (ndiag,), ``x`` (n_in,); every argument checked on each call
    (operators that are applied many times keep a :class:`DiaOperand`)."""
    if x.device.type == "cpu":
        return dia_spmv_reference(vals, offs, x, n_out)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv runs on CUDA or the CPU, not {x.device}")
    return dia_apply(DiaOperand(vals, offs, n_out), x)


dia_spmv.launches = 0
