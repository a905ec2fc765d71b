"""ADMM LP solvers, PyTorch port of ``pysparselp_tpu/solvers/admm.py``.

* ``lp_admm`` — penalized-equality ADMM (reference ``pysparselp/ADMM.py:47-269``):
  the x-subproblem ``min ½xᵀMx − yᵀx`` with ``M = γₑAᵀA + γᵢI`` under box
  constraints, solved by ``nb_inner`` damped projected Jacobi sweeps per
  iteration, matrix-free (``Mx = γₑAᵀ(Ax) + γᵢx``: two products of the
  lowered operator, H-DIA, H-CSR or H-BSR on the card; ``diag(M)`` from the
  squared column sums).  The JAX package runs a chunk as one compiled
  ``fori_loop``; here it is a Python loop of ``2·(nb_inner + 1)`` products
  and the elementwise passes per iteration, launched without a host
  synchronisation until the chunk's metrics are read.
* ``lp_admm2`` — ADMM with the equalities enforced exactly in the
  subproblem (reference ``ADMM.py:272-474``): the KKT solve reduces to the
  SPD Schur complement ``(A Aᵀ) ν = A y − γ b``, factored once as a dense
  Cholesky (``m ≤ dense_threshold``) and solved by two triangular solves
  per iteration, or solved by Jacobi-preconditioned CG on the operator.

``lp_admm(inner="gauss_seidel")`` is the JAX package's host mode: the
native bounded Gauss-Seidel sweep (:mod:`pysparselp_tpu_torch.native`) on
the host, whatever ``device`` says (and, as in the JAX package, whatever
``mesh`` says).  ``mesh=`` (a
:class:`~pysparselp_tpu_torch.parallel.mesh.Mesh`) row-shards the standard
form over a ``torch.distributed`` group
(:mod:`pysparselp_tpu_torch.parallel.sharded_admm`); the mesh decides the
device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import torch

from ..ops.cg import conjgrad
from ..ops.linear_solve import cholesky_solve, cholesky_upper
from ..preconditioning import (
    convert_to_standard_form_with_bounds,
    precondition_constraints,
)
from ..problem import ell_from_scipy, resolve_device, resolve_dtype
from .base import (HostLoop, ToleranceStop, chunk_schedule, emit_callback,
                   to_np)


def _device(mesh, device):
    """The solve's device: the mesh's, or ``device`` resolved."""
    if mesh is not None:
        from ..parallel.mesh import check_mesh

        return check_mesh(mesh).device
    return resolve_device(device)


# ----------------------------------------------------------------------
# lp_admm: penalized equalities + projected Jacobi inner solver
# ----------------------------------------------------------------------


def _admm_chunk(data, state, nsteps: int, nb_inner: int):
    a, b = data["a"], data["b"]
    c, lb, ub = data["c"], data["lb"], data["ub"]
    gamma_eq, gamma_ineq = data["gamma_eq"], data["gamma_ineq"]
    inv_diag, omega = data["inv_diag"], data["omega"]
    atb = data["atb"]

    def m_apply(v):
        return gamma_eq * a.rmatvec(a.matvec(v)) + gamma_ineq * v

    x, xp, lam_eq = state
    for _ in range(nsteps):
        y = -c + gamma_eq * atb + gamma_ineq * xp - a.rmatvec(lam_eq)
        for _ in range(nb_inner):
            # damped projected Jacobi: parallel analogue of the reference's
            # bounded Gauss-Seidel sweep (gaussSiedel.pyx:131-152)
            x = x + omega * (y - m_apply(x)) * inv_diag
            x = torch.clamp(x, lb, ub)
        xp = x
        lam_eq = lam_eq + gamma_eq * (a.matvec(x) - b)
    state = (x, xp, lam_eq)

    r = a.matvec(x) - b
    energy1 = (
        torch.dot(c, x)
        + 0.5 * gamma_eq * torch.sum(r**2)
        + torch.dot(lam_eq, r)
    )
    metrics = dict(
        energy1=energy1,
        max_violated_equality=torch.max(torch.abs(r)),
        max_violated_inequality=torch.maximum(
            torch.max(lb - x), torch.max(x - ub)
        ),
    )
    return state, metrics


def admm_system(c, a_eq, beq, a_ineq, b_lower, b_upper, lb, ub, x0=None,
                use_preconditioning=True):
    """The host standard form ``lp_admm`` solves: rows normalized, then
    bounded slacks for the inequalities, then (``use_preconditioning``)
    rows normalized again; ``(c2, a, b, lb2, ub2, x02)``."""
    c = np.asarray(c, np.float64)
    if x0 is None:
        x0 = np.zeros(c.size)
    # row-normalize before adding slacks (ADMM.py:76-83)
    if a_eq is not None and a_eq.shape[0]:
        a_eq, beq = precondition_constraints(a_eq, beq, alpha=2)
    else:
        a_eq, beq = None, None
    if a_ineq is not None and a_ineq.shape[0]:
        a_ineq, b_lower, b_upper = precondition_constraints(
            a_ineq, b_lower, b_upper, alpha=2
        )
    else:
        a_ineq = None
    c2, a, b, lb2, ub2, x02 = convert_to_standard_form_with_bounds(
        c, a_eq, beq, a_ineq, b_lower, b_upper, np.asarray(lb, float),
        np.asarray(ub, float), x0,
    )
    if use_preconditioning:
        a, b = precondition_constraints(a, b, alpha=2)
    return c2, a, b, lb2, ub2, x02


def lp_admm(
    c,
    a_eq,
    beq,
    a_ineq,
    b_lower,
    b_upper,
    lb,
    ub,
    x0=None,
    gamma_eq=2,
    gamma_ineq=3,
    nb_iter=100,
    callback_func=None,
    max_time=None,
    use_preconditioning=True,
    nb_iter_plot=10,
    nb_inner=2,
    omega=1.0,
    dtype=None,
    start_time=None,
    inner="jacobi",
    stop_tol=None,
    mesh=None,
    light_metrics=False,
    device="cuda",
):
    """Penalized-equality ADMM; signature parity with ``ADMM.py:47`` (plus
    ``device``).

    ``inner`` selects the x-subproblem solver: ``"jacobi"`` (the default)
    is the damped projected Jacobi loop on ``device``; ``"gauss_seidel"``
    is the sequential bounded Gauss-Seidel host mode (native C++ sweeps,
    :mod:`pysparselp_tpu_torch.native.gauss_seidel`), the algorithmic twin
    of the reference's default inner solver.  As in the JAX package it runs
    on the host in float64 whatever ``device``, ``dtype`` and ``mesh``
    say: a sequential sweep cannot use the card.  ``device`` is still
    resolved, so ``"cuda"`` without a card raises as everywhere else.
    ``mesh`` row-shards the constraint system: the Jacobi sweeps run with
    one ``psum`` each (:mod:`~pysparselp_tpu_torch.parallel.sharded_admm`)."""
    dev = resolve_device(device) if inner == "gauss_seidel" else _device(
        mesh, device)
    dtype = resolve_dtype(dtype, dev)
    n = np.asarray(c).size
    c2, a, b, lb2, ub2, x02 = admm_system(
        c, a_eq, beq, a_ineq, b_lower, b_upper, lb, ub, x0,
        use_preconditioning)
    if inner == "gauss_seidel":
        return _lp_admm_host_gs(
            c2, a, b, lb2, ub2, x02, n, gamma_eq, gamma_ineq, nb_iter,
            nb_iter_plot, nb_inner, callback_func, start_time, max_time,
            stop_tol, light_metrics,
        )
    a = scipy.sparse.csr_matrix(a)
    sq = a.copy()
    sq.data = sq.data**2
    diag_m = gamma_eq * np.asarray(sq.sum(axis=0)).ravel() + gamma_ineq

    # damped projected Jacobi converges iff omega < 2/rho(D^-1 M); estimate
    # the spectral radius once by host power iteration and clamp
    inv_diag_np = 1.0 / diag_m
    rng = np.random.RandomState(0)
    v = rng.randn(a.shape[1])
    v /= np.linalg.norm(v)
    rho = 1.0
    at = a.T.tocsr()
    for _ in range(30):
        w = inv_diag_np * (gamma_eq * (at @ (a @ v)) + gamma_ineq * v)
        nrm = np.linalg.norm(w)
        if nrm == 0:
            break
        rho = nrm
        v = w / nrm
    omega = min(float(omega), 1.8 / max(rho, 1e-12))

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=dev)

    data = dict(
        c=vec(c2), lb=vec(lb2), ub=vec(ub2),
        gamma_eq=vec(gamma_eq), gamma_ineq=vec(gamma_ineq),
        inv_diag=vec(1.0 / diag_m), omega=vec(omega), atb=vec(at @ b),
    )
    x = vec(x02)
    xp = torch.clamp(x, data["lb"], data["ub"])
    if mesh is not None:
        from ..parallel.sharded_admm import (admm_chunk_sharded,
                                             build_sharded_system)

        data["sys"], rows_loc, _m_pad, _op = build_sharded_system(
            a, b, mesh, dtype)
        state = (x, xp, torch.zeros(rows_loc, dtype=dtype, device=dev))

        def run_chunk(state, nsteps):
            return admm_chunk_sharded(data, state, mesh, nsteps, nb_inner)
    else:
        data.update(a=ell_from_scipy(a, dtype, dev), b=vec(b))
        state = (x, xp, torch.zeros(a.shape[0], dtype=dtype, device=dev))

        def run_chunk(state, nsteps):
            return _admm_chunk(data, state, nsteps, nb_inner)

    loop = HostLoop(start_time=start_time, max_time=max_time)
    tstop = ToleranceStop(stop_tol)
    niter = 0
    for nsteps in chunk_schedule(nb_iter, nb_iter_plot):
        state, metrics = run_chunk(state, nsteps)
        niter += nsteps
        emit_callback(
            callback_func, niter, state[0][:n],
            metrics["energy1"], metrics["energy1"], lambda: loop.elapsed,
            metrics["max_violated_equality"], metrics["max_violated_inequality"],
            light=light_metrics,
        )
        if loop.timed_out or tstop.check(
            metrics["energy1"], metrics["max_violated_equality"],
            metrics["max_violated_inequality"],
        ):
            break
    return to_np(state[0][:n])


def _lp_admm_host_gs(c, a, b, lb, ub, x0, n, gamma_eq, gamma_ineq, nb_iter,
                     nb_iter_plot, nb_inner, callback_func, start_time,
                     max_time, stop_tol=None, light_metrics=False):
    """Host-mode ADMM iterate with the native bounded Gauss-Seidel inner
    solve — the sequential twin of the reference's default path
    (``ADMM.py:143-268`` with ``gaussSiedel.pyx:95`` inside)."""
    from ..native.gauss_seidel import BoundedGaussSeidel

    a = scipy.sparse.csr_matrix(a)
    m_mat = (
        gamma_eq * (a.T @ a) + gamma_ineq * scipy.sparse.eye(a.shape[1])
    ).tocsr()
    bs = BoundedGaussSeidel(m_mat)
    at = a.T.tocsr()
    atb = at @ b
    x = np.asarray(x0, np.float64).copy()
    xp = np.clip(x, lb, ub)
    lam = np.zeros(a.shape[0])
    loop = HostLoop(start_time=start_time, max_time=max_time)
    tstop = ToleranceStop(stop_tol)
    for i in range(1, nb_iter + 1):
        y = -c + gamma_eq * atb + gamma_ineq * xp - at @ lam
        x = bs.solve(y, lb, ub, x, maxiter=max(nb_inner, 1))
        xp = x
        r = a @ x - b
        lam += gamma_eq * r
        if i % nb_iter_plot == 0 or i == nb_iter:
            energy = float(
                c @ x + 0.5 * gamma_eq * (r @ r) + lam @ r
            )
            emit_callback(
                callback_func, i, x[:n], energy, energy, lambda: loop.elapsed,
                float(np.abs(r).max(initial=0.0)),
                float(max(np.max(lb - x, initial=0.0),
                          np.max(x - ub, initial=0.0))),
                light=light_metrics,
            )
            if loop.timed_out or tstop.check(
                energy, np.abs(r).max(initial=0.0),
                max(np.max(lb - x, initial=0.0),
                    np.max(x - ub, initial=0.0)),
            ):
                break
    return x[:n]


# ----------------------------------------------------------------------
# lp_admm2: exact equality subproblem via the Schur complement
# ----------------------------------------------------------------------

data_static_cg_iters = 100  # CG cap for the matrix-free Schur path


def _admm2_chunk(data, state, nsteps: int, use_dense: bool):
    a = data["a"]
    b, c = data["b"], data["c"]
    lb, ub = data["lb"], data["ub"]
    gamma, alpha = data["gamma"], data["alpha"]

    if use_dense:
        chol = data["chol"]

        def schur_solve(rhs):
            return cholesky_solve(chol, rhs)
    else:
        jac = data["schur_inv_diag"]

        def schur_solve(rhs):
            return conjgrad(
                lambda v: a.matvec(a.rmatvec(v)) + data["ridge"] * v,
                rhs,
                maxiter=data_static_cg_iters,
                precond=lambda v: jac * v,
            )

    x, xp, lam = state
    xp_prev = xp
    for _ in range(nsteps):
        xp_prev = xp
        y1 = -c + gamma * xp - lam
        nu = schur_solve(a.matvec(y1) - gamma * b)
        x = (y1 - a.rmatvec(nu)) / gamma
        x = alpha * x + (1.0 - alpha) * xp
        xp = torch.clamp(x + lam / gamma, lb, ub)
        lam = lam + gamma * (x - xp)
    state = (x, xp, lam)
    energy1 = (
        torch.dot(c, x)
        + 0.5 * gamma * torch.sum((x - xp) ** 2)
        + torch.dot(lam, x - xp)
    )
    metrics = dict(
        energy1=energy1,
        max_violated_equality=torch.max(torch.abs(a.matvec(xp) - b)),
        max_violated_inequality=torch.zeros((), dtype=x.dtype,
                                            device=x.device),
        # Boyd §3.4.1 residuals for adaptive-penalty balancing
        r_primal=torch.linalg.norm(x - xp),
        r_dual=gamma * torch.linalg.norm(xp - xp_prev),
    )
    return state, metrics


def admm2_system(c, a_eq, beq, a_ineq, b_lower, b_upper, lb, ub, x0=None,
                 use_preconditioning=False):
    """The host standard form ``lp_admm2`` solves: (``use_preconditioning``)
    rows normalized, then bounded slacks for the inequalities;
    ``(c2, a, b, lb2, ub2, x02)``."""
    c = np.asarray(c, np.float64)
    if x0 is None:
        x0 = np.zeros(c.size)
    if use_preconditioning:
        if a_eq is not None and a_eq.shape[0]:
            a_eq, beq = precondition_constraints(a_eq, beq, alpha=2)
        if a_ineq is not None and a_ineq.shape[0]:
            a_ineq, b_lower, b_upper = precondition_constraints(
                a_ineq, b_lower, b_upper, alpha=2
            )
    if a_eq is not None and a_eq.shape[0] == 0:
        a_eq, beq = None, None
    if a_ineq is not None and a_ineq.shape[0] == 0:
        a_ineq = None
    return convert_to_standard_form_with_bounds(
        c, a_eq, beq, a_ineq, b_lower, b_upper, np.asarray(lb, float),
        np.asarray(ub, float), x0,
    )


def lp_admm2(
    c,
    a_eq,
    beq,
    a_ineq,
    b_lower,
    b_upper,
    lb,
    ub,
    x0=None,
    gamma_ineq=0.7,
    nb_iter=100,
    callback_func=None,
    max_time=None,
    use_preconditioning=False,
    nb_iter_plot=10,
    alpha=1.95,
    dense_threshold=4096,
    dtype=None,
    start_time=None,
    stop_tol=None,
    adaptive_rho=False,
    mesh=None,
    light_metrics=False,
    device="cuda",
):
    """ADMM with exact equality subproblem; signature parity with
    ``ADMM.py:272`` (plus ``device``).  ``adaptive_rho=True`` doubles the
    penalty when the primal residual dominates the dual one by 10x and
    halves it in the opposite case, checked once per chunk.  ``mesh``
    row-shards the constraint system: the Schur solve runs sharded CG (one
    ``psum`` of an n-vector per CG step) or, in the dense regime, gathers
    the sharded rhs once per iteration
    (:mod:`~pysparselp_tpu_torch.parallel.sharded_admm`)."""
    dev = _device(mesh, device)
    dtype = resolve_dtype(dtype, dev)
    n = np.asarray(c).size
    c2, a, b, lb2, ub2, x02 = admm2_system(
        c, a_eq, beq, a_ineq, b_lower, b_upper, lb, ub, x0,
        use_preconditioning)

    m = a.shape[0]
    use_dense = m <= dense_threshold
    ridge = 1e-10 * max(1.0, float(abs(a).sum() / max(m, 1)))

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=dev)

    data = dict(
        c=vec(c2), lb=vec(lb2), ub=vec(ub2), gamma=vec(gamma_ineq),
        alpha=vec(alpha), ridge=vec(ridge),
    )
    if mesh is not None:
        from ..parallel.sharded_admm import (admm2_chunk_sharded,
                                             build_sharded_system, schur_data)

        data["sys"], _rows_loc, m_pad, _op = build_sharded_system(
            a, b, mesh, dtype)
        data.update(schur_data(a, ridge, m_pad, use_dense, dtype, dev))

        def run_chunk(data, state, nsteps):
            return admm2_chunk_sharded(data, state, mesh, nsteps, use_dense,
                                       data_static_cg_iters)
    else:
        data.update(a=ell_from_scipy(a, dtype, dev), b=vec(b))
        if use_dense:
            # Schur complement S = A Aᵀ (+ridge), factored once (the
            # analogue of the reference's one-time splu of the KKT system,
            # ADMM.py:342)
            s = (a @ a.T).toarray() + ridge * np.eye(m)
            data["chol"] = cholesky_upper(vec(s))[0]
        else:
            diag_s = np.asarray((a.multiply(a)).sum(axis=1)).ravel() + ridge
            data["schur_inv_diag"] = vec(1.0 / diag_s)

        def run_chunk(data, state, nsteps):
            return _admm2_chunk(data, state, nsteps, use_dense)
    x = vec(x02)
    xp = torch.clamp(x, data["lb"], data["ub"])
    state = (x, xp, torch.zeros(x.shape, dtype=dtype, device=dev))

    loop = HostLoop(start_time=start_time, max_time=max_time)
    tstop = ToleranceStop(stop_tol)
    gamma = float(gamma_ineq)
    niter = 0
    for nsteps in chunk_schedule(nb_iter, nb_iter_plot):
        state, metrics = run_chunk(data, state, nsteps)
        niter += nsteps
        if adaptive_rho:
            rp, rd = float(metrics["r_primal"]), float(metrics["r_dual"])
            if rp > 10.0 * rd and rd > 0:
                gamma *= 2.0
                data = dict(data, gamma=vec(gamma))
            elif rd > 10.0 * rp and rp > 0:
                gamma *= 0.5
                data = dict(data, gamma=vec(gamma))
        emit_callback(
            callback_func, niter, state[0][:n],
            metrics["energy1"], metrics["energy1"], lambda: loop.elapsed,
            metrics["max_violated_equality"], metrics["max_violated_inequality"],
            light=light_metrics,
        )
        if loop.timed_out or tstop.check(
            metrics["energy1"], metrics["max_violated_equality"],
            metrics["max_violated_inequality"],
        ):
            break
    return to_np(state[0][:n])
