"""H-CPDIA: ``nsteps`` whole Chambolle-Pock iterations on DIA operators,
equality and inequality systems alike (kernel source: ``csrc/cp_dia.cu``).

Replaces ``pysparselp_tpu/ops/cp_fused.py::_cp_fused_call`` (K2) and
``pysparselp_tpu/ops/cp_windowed.py::build_windowed_call`` (K3), with the
call contract of ``cp_windowed._cp_windowed_call_full``:
``(x, x3, y_eq, y[, sum_x, sum_y_eq, sum_y])``.  :func:`cp_dia_chunk`
launches the kernel for CUDA tensors and runs
:func:`cp_dia_chunk_reference`, its plain PyTorch twin, for CPU tensors.
Inputs are never modified.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dia_spmv import dia_spmv_reference

_P, _I = ctypes.c_void_p, ctypes.c_int


def cp_dia_eligible(prob) -> bool:
    """Every present constraint system is a DiaMatrix."""
    from ..problem import DiaMatrix

    ops = [op for op in (prob.a_eq, prob.a_ineq) if op is not None]
    return bool(ops) and all(isinstance(op, DiaMatrix) for op in ops)


def _empty(x):
    return torch.zeros(0, dtype=x.dtype, device=x.device)


def cp_dia_chunk_reference(prob, pre, x, y_eq, y, nsteps, theta,
                           with_sums=False):
    """Plain twin of :func:`cp_dia_chunk`, in the kernel's operation order."""
    ae, ai = prob.a_eq, prob.a_ineq
    n = prob.n
    x3 = x
    ye = y_eq if ae is not None else _empty(x)
    yi = y if ai is not None else _empty(x)
    sx, se, si = torch.zeros_like(x), torch.zeros_like(ye), torch.zeros_like(yi)
    for _ in range(nsteps):
        d = prob.c
        if ae is not None:
            d = d + dia_spmv_reference(ae.vals_t, ae.offs_t, ye, n)
        if ai is not None:
            d = d + dia_spmv_reference(ai.vals_t, ai.offs_t, yi, n)
        x2 = torch.clamp(x - pre["diag_t"] * d, prob.lb, prob.ub)
        x3 = (1.0 + theta) * x2 - theta * x
        x = x2
        if ae is not None:
            r = dia_spmv_reference(ae.vals, ae.offs, x3, prob.m_eq) - prob.b_eq
            ye = ye + pre["sigma_eq"] * r
        if ai is not None:
            r = (dia_spmv_reference(ai.vals, ai.offs, x3, prob.m_ineq)
                 - prob.b_upper)
            yi = torch.clamp_min(yi + pre["sigma_ineq"] * r, 0.0)
        if with_sums:
            sx, se, si = sx + x, se + ye, si + yi
    out = (x, x3, ye, yi)
    return out + (sx, se, si) if with_sums else out


def cp_dia_chunk(prob, pre, x, y_eq, y, nsteps, theta, with_sums=False):
    """Run ``nsteps`` CP iterations; returns ``(x, x3, y_eq, y[, sx, se,
    sy])`` (the eq outputs are empty when ``prob.a_eq`` is None)."""
    if x.device.type == "cpu":
        return cp_dia_chunk_reference(prob, pre, x, y_eq, y, nsteps, theta,
                                      with_sums)
    if x.device.type != "cuda":
        raise ValueError(f"cp_dia_chunk runs on CUDA or the CPU, not {x.device}")
    ae, ai = prob.a_eq, prob.a_ineq
    dt, dev = x.dtype, x.device
    x = x.clone()
    x3 = x.clone()
    ye = y_eq.clone() if ae is not None else _empty(x)
    yi = y.clone() if ai is not None else _empty(x)
    sums = (tuple(torch.zeros_like(v) for v in (x, ye, yi)) if with_sums
            else (None, None, None))
    args = [prob.c, pre["diag_t"], prob.lb, prob.ub]
    if ai is not None:
        args += [ai.vals_t, ai.offs_t, ai.vals, ai.offs, prob.b_upper,
                 pre["sigma_ineq"]]
    if ae is not None:
        args += [ae.vals_t, ae.offs_t, ae.vals, ae.offs, prob.b_eq,
                 pre["sigma_eq"]]
    _build.check_cuda(*args, x, ye, yi, dtype=dt, device=dev)

    def sys_args(op, b, sigma):
        if op is None:
            return [None, None, 0, None, None, 0, None, None]
        return [op.vals_t, op.offs_t, len(op.offsets_t), op.vals, op.offs,
                len(op.offsets), b, sigma]

    a_in = sys_args(ai, prob.b_upper, pre.get("sigma_ineq"))
    a_eq = sys_args(ae, prob.b_eq, pre.get("sigma_eq"))
    m = prob.m_ineq if ai is not None else 0
    me = prob.m_eq if ae is not None else 0
    vec = [prob.c, pre["diag_t"], prob.lb, prob.ub]
    raw = ([prob.n, m, me] + vec + a_in + a_eq
           + [x, x3, yi, ye, sums[0], sums[2], sums[1]])
    cargs = [v if isinstance(v, int) else None if v is None
             else v.data_ptr() for v in raw]
    argtypes = ([_I] * 3 + [_P] * 4 + [_P, _P, _I, _P, _P, _I, _P, _P] * 2
                + [_P] * 7 + [_build.scalar(dt), _I, _I, _P])
    _build.entry(f"pslp_cp_dia_chunk_{_build.suffix(dt)}", argtypes)(
        *cargs, theta, int(nsteps), int(bool(with_sums)),
        _build.stream(_build.device_index(dev)))
    cp_dia_chunk.launches += 1
    out = (x, x3, ye, yi)
    return out + sums if with_sums else out


cp_dia_chunk.launches = 0
