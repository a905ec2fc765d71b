"""H-CPDENSE: ``nsteps`` whole Chambolle-Pock iterations on dense operators
in one persistent thread block (kernel source: ``csrc/cp_dense.cu``).

Replaces ``pysparselp_tpu/ops/cp_fused.py::_cp_dense_fused_call`` (K1), with
its call contract ``(x, x3, y_eq, y_ineq[, sum_x, sum_y_eq, sum_y_ineq])``.
:func:`cp_dense_chunk` launches the kernel for CUDA tensors and runs
:func:`cp_dense_chunk_reference`, its plain PyTorch twin, for CPU tensors.
Inputs are never modified.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
LANE = 128
# K1's eligibility budget: both systems padded to 128-multiples in float32
DENSE_FUSED_BUDGET = 4 * 1024 * 1024


def _pad128(v):
    return -(-max(v, 1) // LANE) * LANE


def cp_dense_eligible(prob) -> bool:
    """Every present system is a DenseMatrix, within K1's 4 MB budget."""
    from ..problem import DenseMatrix

    ops = [op for op in (prob.a_eq, prob.a_ineq) if op is not None]
    if not ops or not all(isinstance(op, DenseMatrix) for op in ops):
        return False
    total = sum(_pad128(op.nrows) * _pad128(op.ncols) * 4 for op in ops)
    return total <= DENSE_FUSED_BUDGET


def _empty(x):
    return torch.zeros(0, dtype=x.dtype, device=x.device)


def cp_dense_chunk_reference(prob, pre, x, y_eq, y_ineq, nsteps, theta,
                             with_sums=False):
    """Plain twin of :func:`cp_dense_chunk` (``matmul`` products)."""
    ae, ai = prob.a_eq, prob.a_ineq
    x3 = x
    ye = y_eq if ae is not None else _empty(x)
    yi = y_ineq if ai is not None else _empty(x)
    sx, se, si = torch.zeros_like(x), torch.zeros_like(ye), torch.zeros_like(yi)
    for _ in range(nsteps):
        d = prob.c
        if ae is not None:
            d = d + ye @ ae.a
        if ai is not None:
            d = d + yi @ ai.a
        x2 = torch.clamp(x - pre["diag_t"] * d, prob.lb, prob.ub)
        x3 = (1.0 + theta) * x2 - theta * x
        x = x2
        if ae is not None:
            ye = ye + pre["sigma_eq"] * (ae.a @ x3 - prob.b_eq)
        if ai is not None:
            yi = torch.clamp_min(
                yi + pre["sigma_ineq"] * (ai.a @ x3 - prob.b_upper), 0.0)
        if with_sums:
            sx, se, si = sx + x, se + ye, si + yi
    out = (x, x3, ye, yi)
    return out + (sx, se, si) if with_sums else out


def cp_dense_chunk(prob, pre, x, y_eq, y_ineq, nsteps, theta,
                   with_sums=False):
    """Run ``nsteps`` CP iterations; returns ``(x, x3, y_eq, y_ineq[, sx,
    se, si])`` (absent systems give empty outputs)."""
    if x.device.type == "cpu":
        return cp_dense_chunk_reference(prob, pre, x, y_eq, y_ineq, nsteps,
                                        theta, with_sums)
    if x.device.type != "cuda":
        raise ValueError(
            f"cp_dense_chunk runs on CUDA or the CPU, not {x.device}")
    ae, ai = prob.a_eq, prob.a_ineq
    dt, dev = x.dtype, x.device
    x = x.clone()
    x3 = x.clone()
    ye = y_eq.clone() if ae is not None else _empty(x)
    yi = y_ineq.clone() if ai is not None else _empty(x)
    sums = (tuple(torch.zeros_like(v) for v in (x, ye, yi)) if with_sums
            else (None, None, None))

    def sys_args(op, b, sigma):
        return [None, None, None] if op is None else [op.a, b, sigma]

    raw = ([prob.c, pre["diag_t"], prob.lb, prob.ub]
           + sys_args(ae, prob.b_eq, pre.get("sigma_eq"))
           + sys_args(ai, prob.b_upper, pre.get("sigma_ineq"))
           + [x, x3, ye, yi, *sums])
    _build.check_cuda(*raw, dtype=dt, device=dev)
    me = prob.m_eq if ae is not None else 0
    mi = prob.m_ineq if ai is not None else 0
    scalar = _build.scalar(dt)
    argtypes = [_I] * 3 + [_P] * 17 + [scalar, _I, _I, _P]
    fn = _build.function(f"pslp_cp_dense_chunk_{_build.suffix(dt)}", argtypes)
    rc = fn(prob.n, me, mi, *(_build.ptr(v) for v in raw), scalar(theta),
            int(nsteps), int(bool(with_sums)), _build.stream_ptr(dev))
    _build.check(rc, "cp_dense_chunk")
    cp_dense_chunk.launches += 1
    out = (x, x3, ye, yi)
    return out + sums if with_sums else out


cp_dense_chunk.launches = 0
