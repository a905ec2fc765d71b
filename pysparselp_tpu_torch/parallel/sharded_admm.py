"""Row-sharded ADMM chunks over a :class:`~.mesh.Mesh` (mirrors
``pysparselp_tpu/parallel/sharded_admm.py``).

The two ADMM solvers of :mod:`pysparselp_tpu_torch.solvers.admm` with
their standard-form system partitioned by rows over the ranks:

* ``lp_admm`` (penalized equalities, damped projected Jacobi inner solve):
  ``A v`` is local (x replicated), ``Aᵀ(·)`` is one ``psum`` of an
  n-vector, once per Jacobi sweep and once for ``Aᵀλ`` per iteration;
* ``lp_admm2`` (the Schur complement ``A Aᵀ``): the matrix-free regime
  runs the port's :func:`~pysparselp_tpu_torch.ops.cg.conjgrad` on
  row-sharded vectors, one ``psum`` of an n-vector per CG step (``Aᵀp``)
  beside the psums of its dot products; the dense regime factors the
  padded ``A Aᵀ`` replicated once and gathers the rhs with one
  ``all_gather`` per iteration.

Each rank's rows are the row-sharded CP solver's shard
(:func:`~.sharded_cp._host_system`): the CSR of its rows on H-CSR in both
orientations (the JAX package's 128×128 block-ELL tiles, K6, answer the
TPU's matrix unit), or its DIA planes on H-DIA with shard offsets where
the port's layout chooser lowers the whole system to DIA on one device
(:func:`shard_operator`).  The shard height is ``ceil(m / ndev)``; the
padding rows carry zero coefficients, right-hand side and dual.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import torch

from ..ops.cg import conjgrad
from ..ops.linear_solve import cholesky_solve, cholesky_upper
from .mesh import check_mesh
from .sharded_cp import (_host_system, _local_matvec, _local_rmatvec,
                         place_system)


def shard_operator(a, operator="auto"):
    """The per-shard layout of ``a``: ``"dia"`` where the layout chooser
    lowers the whole system to DIA (``problem.choose_layout``), else
    ``"tiles"`` (the CSR of each rank's rows); ``"dia"`` / ``"tiles"``
    force one."""
    if operator != "auto":
        if operator not in ("dia", "tiles"):
            raise ValueError(f"operator={operator!r}: use 'auto', 'dia' or "
                             "'tiles'")
        return operator
    from ..problem import choose_layout

    return "dia" if choose_layout(scipy.sparse.csr_matrix(a))[0] == "dia" \
        else "tiles"


def build_sharded_system(a, b, mesh, dtype, operator="auto"):
    """This rank's rows of ``A x = b`` on ``mesh.device``: ``(sys_l,
    rows_loc, m_pad, operator)``; ``sys_l`` holds the shard's operator,
    ``b`` and ``row_mask``."""
    mesh = check_mesh(mesh)
    operator = shard_operator(a, operator)
    sys_ = _host_system(a, b, operator, mesh.size, mesh.rank)
    return (place_system(sys_, dtype, mesh.device, keys=("b", "row_mask")),
            sys_["rows_loc"], sys_["m_pad"], operator)


def _rmv(mesh, sys_l, y, n):
    """``Σ_d A_dᵀ y_d``: the shard's product, one psum."""
    return mesh.psum(_local_rmatvec(sys_l, y, n, y.new_zeros(n)))


def admm_chunk_sharded(data, state, mesh, nsteps: int, nb_inner: int):
    """Row-sharded twin of ``solvers.admm._admm_chunk`` (damped projected
    Jacobi inner solve): ``state`` is ``(x, xp, lam)`` with x, xp
    replicated and lam this rank's rows.  ``nb_inner + 1`` n-vector psums
    an iteration; the metrics add one psum and one pmax of a scalar."""
    mesh = check_mesh(mesh)
    loc = data["sys"]
    c, lb, ub = data["c"], data["lb"], data["ub"]
    gamma_eq, gamma_ineq = data["gamma_eq"], data["gamma_ineq"]
    inv_diag, omega, atb = data["inv_diag"], data["omega"], data["atb"]
    n = c.shape[0]

    def m_apply(v):
        return (gamma_eq * _rmv(mesh, loc, _local_matvec(loc, v, n), n)
                + gamma_ineq * v)

    x, xp, lam = state
    for _ in range(nsteps):
        y = -c + gamma_eq * atb + gamma_ineq * xp - _rmv(mesh, loc, lam, n)
        for _ in range(nb_inner):
            x = x + omega * (y - m_apply(x)) * inv_diag
            x = torch.clamp(x, lb, ub)
        xp = x
        lam = lam + gamma_eq * (_local_matvec(loc, x, n) - loc["b"])

    r = (_local_matvec(loc, x, n) - loc["b"]) * loc["row_mask"]
    energy1 = torch.dot(c, x) + mesh.psum(
        0.5 * gamma_eq * torch.sum(r**2) + torch.dot(lam * loc["row_mask"], r))
    metrics = dict(
        energy1=energy1,
        max_violated_equality=mesh.pmax(torch.max(torch.abs(r))),
        max_violated_inequality=torch.maximum(torch.max(lb - x),
                                              torch.max(x - ub)),
    )
    return (x, xp, lam), metrics


def admm2_chunk_sharded(data, state, mesh, nsteps: int, use_dense: bool,
                        cg_iters: int = 100):
    """Row-sharded twin of ``solvers.admm._admm2_chunk``: the Schur solve
    ``(A Aᵀ + ridge) ν = A y₁ − γ b`` runs ``conjgrad`` on this rank's rows
    (its dot products psum-reduced; ``Aᵀp`` one n-vector psum a step) or
    the replicated dense factor on the gathered rhs.  ``state`` is ``(x,
    xp, lam)``, all replicated."""
    mesh = check_mesh(mesh)
    loc = data["sys"]
    c, lb, ub = data["c"], data["lb"], data["ub"]
    gamma, alpha, ridge = data["gamma"], data["alpha"], data["ridge"]
    n = c.shape[0]
    m_loc = loc["b"].shape[0]
    lo = mesh.rank * m_loc

    if use_dense:
        chol = data["chol"]

        def schur_solve(rhs_l):
            nu = cholesky_solve(chol, mesh.all_gather(rhs_l))
            return nu[lo:lo + m_loc]
    else:
        jac_l = data["schur_inv_diag"][lo:lo + m_loc]

        def schur_solve(rhs_l):
            # (A Aᵀ + ridge) v with v row-sharded: one psum (Aᵀv)
            return conjgrad(
                lambda v: (_local_matvec(loc, _rmv(mesh, loc, v, n), n)
                           + ridge * v),
                rhs_l, maxiter=cg_iters, precond=lambda v: jac_l * v,
                dot=lambda u, v: mesh.psum(torch.dot(u, v)))

    x, xp, lam = state
    xp_prev = xp
    for _ in range(nsteps):
        xp_prev = xp
        y1 = -c + gamma * xp - lam
        nu_l = schur_solve(_local_matvec(loc, y1, n) - gamma * loc["b"])
        x = (y1 - _rmv(mesh, loc, nu_l, n)) / gamma
        x = alpha * x + (1.0 - alpha) * xp
        xp = torch.clamp(x + lam / gamma, lb, ub)
        lam = lam + gamma * (x - xp)

    r = (_local_matvec(loc, xp, n) - loc["b"]) * loc["row_mask"]
    energy1 = (torch.dot(c, x) + 0.5 * gamma * torch.sum((x - xp) ** 2)
               + torch.dot(lam, x - xp))
    metrics = dict(
        energy1=energy1,
        max_violated_equality=mesh.pmax(torch.max(torch.abs(r))),
        max_violated_inequality=torch.zeros((), dtype=x.dtype,
                                            device=x.device),
        r_primal=torch.linalg.norm(x - xp),
        r_dual=gamma * torch.linalg.norm(xp - xp_prev),
    )
    return (x, xp, lam), metrics


def schur_data(a, ridge, m_pad, use_dense, dtype, device):
    """The Schur complement's replicated data: the upper factor ``chol`` of
    the row-padded ``A Aᵀ + ridge I`` (dense regime) or its inverse
    diagonal ``schur_inv_diag`` (m_pad entries)."""
    a = scipy.sparse.csr_matrix(a)
    m = a.shape[0]
    if m_pad != m:
        a = scipy.sparse.vstack(
            [a, scipy.sparse.csr_matrix((m_pad - m, a.shape[1]))]).tocsr()

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)

    if use_dense:
        s = (a @ a.T).toarray() + ridge * np.eye(m_pad)
        return dict(chol=cholesky_upper(vec(s))[0])
    diag_s = np.asarray((a.multiply(a)).sum(axis=1)).ravel() + ridge
    return dict(schur_inv_diag=vec(1.0 / diag_s))
