"""Batched LP serving: many variants of ONE constraint matrix per solve
(the PyTorch port of ``pysparselp_tpu/batch.py``).

A common production pattern is a stream of LPs that share their constraint
matrix and differ only in the cost vector, right-hand sides or variable
bounds (per-frame segmentation energies, per-request resource allocations,
scenario sweeps).  :func:`solve_cp_batch` advances the whole batch in
lock-step CP-PPD iterations: the operators and the diagonal
preconditioners, which depend only on the matrix, are built once, and every
per-problem vector carries a trailing batch axis (batch-last, ``(n, B)``),
which takes the place of the JAX package's ``jax.vmap``.

The JAX package lowers the batch to vmappable XLA operators because its
Pallas kernels do not vmap (``batch.py:14-21``).  Here the batch axis goes
inside the hand-written kernels instead: :func:`_lower_batch` follows
``_lower_xla``'s rule and order, and its DIA and CSR operators run H-DIA-B
and H-CSR-B (``csrc/dia_spmv.cu``, ``csrc/csr_spmv.cu``) on CUDA, one launch
per product for the whole batch; dense systems run one ``matmul`` for the
batch, partition and column-block operators plain torch with the trailing
axis.  One chunk runs per checkpoint, and each checkpoint copies its four
stacked ``(B,)`` metrics to the host once.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse
import torch

from .problem import (DENSE_AUTO_MAX_ENTRIES, DIA_AUTO_MAX_OFFSETS,
                      ColBlockMatrix, CsrMatrix, DenseMatrix, DiaMatrix,
                      LPProblem, PartitionMatrix, _diagonal_count,
                      col_split_plan, partition_geometry, resolve_device,
                      resolve_dtype)
from .solvers import _csr
from .solvers.base import to_np
from .solvers.chambolle_pock import _fold_one_sided, host_preconditioners
from .utils.debug import check_iterate
from .utils.instrumentation import span

CURVES = ("energy1", "energy2", "max_violated_equality",
          "max_violated_inequality")


def _lower_batch(a, dtype, device, _split=True):
    """Lower ``a`` for the batched iteration, by ``_lower_xla``'s rule in
    its order (``pysparselp_tpu/batch.py:114-147``): dense when ``m·n ≤
    DENSE_AUTO_MAX_ENTRIES`` (one ``matmul`` for the batch); the partition
    operator for assignment/simplex row patterns; DIA (H-DIA-B) for at most
    ``DIA_AUTO_MAX_OFFSETS`` diagonals, the port's limit; a column-split
    composite of blocks lowered by this same rule for ``[structured |
    hot-columns]`` shapes; else CSR (H-CSR-B), where the JAX package takes
    gather-ELL."""
    csr = scipy.sparse.csr_matrix(a)
    m, n = csr.shape
    if m * n <= DENSE_AUTO_MAX_ENTRIES:
        return DenseMatrix.from_scipy(csr, dtype, device)
    if partition_geometry(csr) is not None:
        return PartitionMatrix.from_scipy(csr, dtype, device)
    if _diagonal_count(csr) <= DIA_AUTO_MAX_OFFSETS:
        # the planes in the solve dtype, as JAX's batch._dia_planes stores
        # them: H-DIA-B reads them so
        return DiaMatrix.from_scipy(csr, dtype, device, allow_bf16=False)
    if _split:
        _, cuts = col_split_plan(csr)
        if cuts:
            csc = csr.tocsc()
            starts = (0,) + tuple(cuts) + (n,)
            blocks = tuple(
                _lower_batch(csc[:, starts[b]:starts[b + 1]].tocsr(), dtype,
                             device, _split=False)
                for b in range(len(starts) - 1))
            return ColBlockMatrix(blocks=blocks, col_starts=starts,
                                  nrows=m, ncols=n)
    return CsrMatrix.from_scipy(csr, dtype, device)


def _batched_chunk(prob, pre, state, nsteps):
    """``nsteps`` batched CP-PPD iterations, then the chunk's four curves,
    each ``(B,)``.  ``prob`` and ``state`` are batch-last: ``c``, ``lb``,
    ``ub`` are ``(n, B)`` or, when shared, ``(n, 1)``; ``b_eq`` and
    ``b_upper`` likewise over rows; ``pre``'s vectors are ``(·, 1)``.  The
    order of operations is ``solvers.chambolle_pock.cp_chunk_impl``'s, so
    each column follows a 1-D run on the same operators; a dot product is a
    sum over the rows of a column."""
    theta = pre["theta"]
    x, x3, y_eq, y_ineq = state
    for _ in range(nsteps):
        d = prob.c
        if prob.a_eq is not None:
            d = d + prob.a_eq.rmatvec(y_eq)
        if prob.a_ineq is not None:
            d = d + prob.a_ineq.rmatvec(y_ineq)
        x2 = torch.clamp(x - pre["diag_t"] * d, prob.lb, prob.ub)
        x3 = (1.0 + theta) * x2 - theta * x
        x = x2
        if prob.a_eq is not None:
            r_eq = prob.a_eq.matvec(x3) - prob.b_eq
            y_eq = y_eq + pre["sigma_eq"] * r_eq
        if prob.a_ineq is not None:
            r_ineq = prob.a_ineq.matvec(x3) - prob.b_upper
            y_ineq = torch.clamp_min(y_ineq + pre["sigma_ineq"] * r_ineq,
                                     0.0)

    d = prob.c
    if prob.a_eq is not None:
        d = d + prob.a_eq.rmatvec(y_eq)
    if prob.a_ineq is not None:
        d = d + prob.a_ineq.rmatvec(y_ineq)
    # dual-feasible primal minimizer for the lower bound (energy2)
    x4 = torch.where(d < 0, prob.ub, prob.lb)
    energy1 = torch.sum(prob.c * x, dim=0)
    energy2 = torch.sum(prob.c * x4, dim=0)
    zero = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    max_v_eq = max_v_ineq = zero
    if prob.a_eq is not None:
        r_eq = prob.a_eq.matvec(x) - prob.b_eq
        energy1 = energy1 + torch.sum(y_eq * r_eq, dim=0)
        energy2 = energy2 + torch.sum(
            y_eq * (prob.a_eq.matvec(x4) - prob.b_eq), dim=0)
        max_v_eq = torch.amax(torch.abs(r_eq), dim=0)
    if prob.a_ineq is not None:
        r_ineq = prob.a_ineq.matvec(x) - prob.b_upper
        energy1 = energy1 + torch.sum(y_ineq * r_ineq, dim=0)
        energy2 = energy2 + torch.sum(
            y_ineq * (prob.a_ineq.matvec(x4) - prob.b_upper), dim=0)
        max_v_ineq = torch.amax(r_ineq, dim=0)
    metrics = dict(energy1=energy1, energy2=energy2,
                   max_violated_equality=max_v_eq,
                   max_violated_inequality=max_v_ineq)
    return (x, x3, y_eq, y_ineq), metrics


def _batch_problem(lp, costs, b_eq, b_lower, b_upper, lb, ub, dtype, alpha,
                   theta, x0, device):
    """Everything :func:`solve_cp_batch` does before its loop: the batched
    inputs checked and laid out batch-last, the shared matrix lowered
    (:func:`_lower_batch`), its preconditioners and the initial state.
    Returns ``(prob, pre, state, backend)``."""
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype, dev)
    a_eq = _csr(lp.a_equalities)
    a_ineq_raw = _csr(lp.a_inequalities)
    a_one, b_one = _fold_one_sided(a_ineq_raw, lp.b_lower, lp.b_upper)
    if a_one is not None and a_one.shape[0] == 0:
        a_one, b_one = None, None
    if a_eq is None and a_one is None:
        raise ValueError("solve_cp_batch needs at least one constraint "
                         "system")

    n = lp.nb_variables
    batched = [np.asarray(v) for v in
               (costs, b_eq, b_lower, b_upper, lb, ub) if v is not None]
    if not batched:
        raise ValueError("pass at least one batched input (costs, b_eq, "
                         "b_lower, b_upper, lb or ub)")
    bs = {v.shape[0] for v in batched if v.ndim == 2}
    if len(bs) > 1:
        raise ValueError(f"inconsistent batch sizes: {sorted(bs)}")
    bsz = bs.pop() if bs else 1

    def pick(v, template, size, name):
        """Batched (B, size) array from the override or the template."""
        if v is None:
            base = np.zeros(size) if template is None else np.asarray(
                template, np.float64)
            return np.broadcast_to(base, (bsz, size)), False
        v = np.asarray(v, np.float64)
        if v.ndim == 1:
            v = np.broadcast_to(v, (bsz, size))
        if v.shape != (bsz, size):
            raise ValueError(f"{name} batch must be (B, {size}), got "
                             f"{v.shape}")
        return v, True

    c_b, c_v = pick(costs, lp.costsvector, n, "costs")
    lb_b, lb_v = pick(lb, lp.lower_bounds, n, "lb")
    ub_b, ub_v = pick(ub, lp.upper_bounds, n, "ub")
    beq_b = beq_v = None
    if a_eq is not None:
        beq_b, beq_v = pick(b_eq, lp.b_equalities, a_eq.shape[0], "b_eq")
    elif b_eq is not None:
        raise ValueError("b_eq batch given but the LP has no equalities")
    bineq_b = bineq_v = None
    if a_one is not None:
        # the one-sided fold keeps b' = [bu[keep_u]; -bl[keep_l]] — apply
        # the same static row selection to the batched sides
        if b_lower is not None or b_upper is not None:
            bl_t = lp.b_lower
            bu_t = lp.b_upper
            bl_b, _ = pick(b_lower, bl_t, a_ineq_raw.shape[0],
                           "b_lower")
            bu_b, _ = pick(b_upper, bu_t, a_ineq_raw.shape[0],
                           "b_upper")
            if bl_t is None:
                bineq_b = bu_b
            else:
                keep_u = np.nonzero(bu_t != np.inf)[0]
                keep_l = np.nonzero(bl_t != -np.inf)[0]
                bineq_b = np.concatenate(
                    (bu_b[:, keep_u], -bl_b[:, keep_l]), axis=1)
            bineq_v = True
        else:
            bineq_b = np.broadcast_to(np.asarray(b_one, np.float64),
                                      (bsz, b_one.size))
            bineq_v = False
    elif b_lower is not None or b_upper is not None:
        raise ValueError("b_lower/b_upper batch given but the LP has no "
                         "inequalities")

    eq_m = _lower_batch(a_eq, dtype, dev) if a_eq is not None else None
    in_m = _lower_batch(a_one, dtype, dev) if a_one is not None else None
    backend = {
        "eq": type(eq_m).__name__ if eq_m is not None else None,
        "ineq": type(in_m).__name__ if in_m is not None else None,
    }

    def col(v, is_batched):
        """``(size, B)`` for a batch, ``(size, 1)`` for a shared vector."""
        v = np.array((v if is_batched else v[:1]).T, np.float64, order="C")
        return torch.as_tensor(v, dtype=dtype, device=dev)

    # diagonal preconditioners from the SHARED matrix
    diag_t, sig_eq, sig_in = host_preconditioners(a_eq, a_one, alpha)
    pre = {"theta": torch.tensor(theta, dtype=dtype, device=dev),
           "diag_t": col(diag_t[None, :], False)}
    if sig_eq is not None:
        pre["sigma_eq"] = col(sig_eq[None, :], False)
    if sig_in is not None:
        pre["sigma_ineq"] = col(sig_in[None, :], False)

    m_eq = eq_m.nrows if eq_m is not None else 0
    m_in = in_m.nrows if in_m is not None else 0
    prob = LPProblem(
        c=col(c_b, c_v), lb=col(lb_b, lb_v), ub=col(ub_b, ub_v),
        a_eq=eq_m,
        b_eq=col(beq_b, beq_v) if a_eq is not None else None,
        a_ineq=in_m, b_lower=None,
        b_upper=col(bineq_b, bineq_v) if a_one is not None else None,
        n=n, m_eq=m_eq, m_ineq=m_in)

    if x0 is None:
        x_b = np.zeros((bsz, n))
    else:
        x_b = np.broadcast_to(np.asarray(x0, np.float64), (bsz, n))
    x = col(x_b, True)
    state = (x, x, torch.zeros((m_eq, bsz), dtype=dtype, device=dev),
             torch.zeros((m_in, bsz), dtype=dtype, device=dev))
    return prob, pre, state, backend


def solve_cp_batch(lp, costs=None, b_eq=None, b_lower=None, b_upper=None,
                   lb=None, ub=None, nb_iter=1000, nb_iter_plot=None,
                   dtype=None, alpha=1.0, theta=1.0, x0=None, device="cuda"):
    """Solve ``B`` variants of ``lp`` that share its constraint MATRIX.

    Any of ``costs``/``b_eq``/``b_lower``/``b_upper``/``lb``/``ub`` may be
    a ``(B, ...)`` batch (the others default to the template values from
    ``lp``); all provided batches must agree on ``B``.  Preconditioners
    and operator lowering are computed once from the matrix; the batch
    advances in lock-step CP-PPD iterations (each element's trajectory
    follows the single-problem per-operator solver's on the same
    operators).  Reference iteration being batched:
    ``pysparselp/ChambollePockPPD.py:199-240``.  ``device`` names the torch
    device (``"cuda"`` by default); ``dtype=None`` means float32 on CUDA and
    float64 on the CPU.

    Returns ``(X, info)``: ``X`` is the ``(B, n)`` solution array and
    ``info`` a dict with the operator ``backend`` and per-checkpoint
    batched curves (``itrn`` ``(P,)``; ``energy1``, ``energy2``,
    ``max_violated_equality``, ``max_violated_inequality`` all ``(P, B)``),
    and, beyond the JAX package's, ``opttime`` ``(P,)``: host seconds from
    the call's start to each checkpoint's copy (lowering included).
    """
    start = time.perf_counter()
    with span("batch"):
        with span("batch.lower"):
            prob, pre, state, backend = _batch_problem(
                lp, costs, b_eq, b_lower, b_upper, lb, ub, dtype, alpha,
                theta, x0, device)
        nb_iter_plot = nb_iter_plot or nb_iter
        curves = {k: [] for k in CURVES}
        itrn, opttime = [], []
        done = 0
        while done < nb_iter:
            nsteps = min(nb_iter_plot, nb_iter - done)
            with span("batch.chunk"):
                state, metrics = _batched_chunk(prob, pre, state, nsteps)
            done += nsteps
            with span("batch.checkpoint"):
                itrn.append(done)
                # ONE device-to-host copy per checkpoint: the four (B,) curves
                stacked = to_np(torch.stack([metrics[k] for k in CURVES]))
                opttime.append(time.perf_counter() - start)
                for i, k in enumerate(CURVES):
                    curves[k].append(stacked[i])
                check_iterate("solve_cp_batch", done, x=state[0],
                              **dict(zip(CURVES, stacked)))
        with span("postsolve"):
            info = {"backend": backend, "itrn": np.asarray(itrn),
                    "opttime": np.asarray(opttime)}
            info.update({k: np.stack(v) for k, v in curves.items()})
            x_out = to_np(state[0])
            return np.ascontiguousarray(x_out.T), info
