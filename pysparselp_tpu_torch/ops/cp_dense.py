"""H-CPDENSE: ``nsteps`` whole Chambolle-Pock iterations on dense operators
in one persistent thread block, the chunk's state and (when they fit) both
``A`` and ``Aᵀ`` held in shared memory (kernel source:
``csrc/cp_dense.cu``; :func:`dense_layout` picks the size tier).

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
THREADS = 1024            # the kernel's largest block (kMaxThreads)
SMEM_LIMIT = 232_448      # dynamic shared memory one block may opt into


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


# vector steps (16 bytes each) a lane takes per output by default
LANE_STEPS = 4


def _group_width(outputs, length, vec, lanes=None) -> int:
    """Lanes per output (a power of two <= 32): ``lanes`` when given (a
    group may then take several outputs in turn), else the fewest that
    leave each lane at most ``LANE_STEPS`` vector steps of a
    ``length``-entry dot product, and at most as many as still give each
    of ``outputs`` outputs its own group of the block's threads."""
    if lanes is not None:
        return lanes
    w = 1
    while w < 32 and w * LANE_STEPS * vec < length:
        w *= 2
    while w > 1 and THREADS // w < outputs:
        w //= 2
    return w


def _round_up(v, to) -> int:
    return -(-v // to) * to


def dense_layout(n, me, mi, itemsize, lanes=None) -> dict:
    """Where the kernel keeps a chunk of an ``(me + mi) x n`` system (the
    size tier of ``csrc/cp_dense.cu``, whose kernel computes the same
    layout): the lanes per column (``w1``; a lane runs the column's
    equality and inequality parts as two chains) and per row (``w2``; two
    chains over its even and odd steps), ``lanes`` for both when given;
    the block's ``threads`` (every column's and every row's group, in
    whole warps); a row of ``A`` padded to ``ld_a`` and a column (a row of
    ``Aᵀ``) to ``ld_t``, its equality and inequality parts each to a
    multiple of the 16-byte vectors a group reads per step; the state's
    entries (x and x3 of ``ld_a``, y of ``ld_t``, five n-vectors and three
    m-vectors, each rounded up to whole vectors); whether the state and the
    operators sit in shared memory, the dynamic shared memory bytes and the
    entries of the global scratch buffer ``[state | A | Aᵀ]`` (0 when
    shared memory holds everything)."""
    m = me + mi
    vec = 16 // itemsize
    w1 = _group_width(n, max(me, mi), vec, lanes)
    w2 = _group_width(m, -(-n // 2), vec, lanes)
    threads = min(THREADS, _round_up(max(n * w1, m * w2, 1), 32))
    ld_t = _round_up(me, vec * w1) + _round_up(mi, vec * w1)
    ld_a = _round_up(n, vec * w2)
    state = 2 * ld_a + ld_t + 5 * _round_up(n, vec) + 3 * _round_up(m, vec)
    total = state + m * ld_a + n * ld_t
    ops_smem = total * itemsize <= SMEM_LIMIT
    state_smem = state * itemsize <= SMEM_LIMIT
    smem = total if ops_smem else state if state_smem else 0
    return dict(w1=w1, w2=w2, threads=threads, ld_a=ld_a, ld_t=ld_t,
                state=state, state_smem=state_smem, ops_smem=ops_smem,
                smem_bytes=smem * itemsize, scratch=0 if ops_smem else total)


def cp_dense_chunk(prob, pre, x, y_eq, y_ineq, nsteps, theta,
                   with_sums=False, lanes=None):
    """Run ``nsteps`` CP iterations; returns ``(x, x3, y_eq, y_ineq[, sx,
    se, si])`` (absent systems give empty outputs).  ``lanes`` overrides
    the lanes per output of :func:`dense_layout` (the plain twin ignores
    it)."""
    if x.device.type == "cpu":
        return cp_dense_chunk_reference(prob, pre, x, y_eq, y_ineq, nsteps,
                                        theta, with_sums)
    if x.device.type != "cuda":
        raise ValueError(
            f"cp_dense_chunk runs on CUDA or the CPU, not {x.device}")
    ae, ai = prob.a_eq, prob.a_ineq
    dt, dev = x.dtype, x.device
    me = prob.m_eq if ae is not None else 0
    mi = prob.m_ineq if ai is not None else 0

    def sys_args(op, b, sigma):
        return [None, None, None] if op is None else [op.a, b, sigma]

    ins = ([prob.c, pre["diag_t"], prob.lb, prob.ub]
           + sys_args(ae, prob.b_eq, pre.get("sigma_eq"))
           + sys_args(ai, prob.b_upper, pre.get("sigma_ineq"))
           + [x, y_eq if ae is not None else None,
              y_ineq if ai is not None else None])
    _build.check_cuda(*ins, dtype=dt, device=dev)
    lay = dense_layout(prob.n, me, mi, x.element_size(), lanes)
    outs = [torch.empty_like(x), torch.empty_like(x),
            torch.empty(me, dtype=dt, device=dev),
            torch.empty(mi, dtype=dt, device=dev)]
    sums = ([torch.empty_like(outs[k]) for k in (0, 2, 3)] if with_sums
            else [None, None, None])
    scratch = (torch.empty(lay["scratch"], dtype=dt, device=dev)
               if lay["scratch"] else None)
    ptrs = [None if v is None else v.data_ptr()
            for v in ins + outs + sums + [scratch]]
    argtypes = [_I] * 3 + [_P] * 21 + [_build.scalar(dt)] + [_I] * 8 + [_P]
    _build.entry(f"pslp_cp_dense_chunk_{_build.suffix(dt)}", argtypes)(
        prob.n, me, mi, *ptrs, theta, int(nsteps), int(bool(with_sums)),
               lay["w1"], lay["w2"], lay["threads"], int(lay["state_smem"]),
               int(lay["ops_smem"]),
               lay["smem_bytes"], _build.stream(_build.device_index(dev)))
    cp_dense_chunk.launches += 1
    return tuple(outs) + (tuple(sums) if with_sums else ())


cp_dense_chunk.launches = 0
