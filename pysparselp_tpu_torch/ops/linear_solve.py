"""Factor-once linear-system solvers for SPD systems, PyTorch port of
``pysparselp_tpu/ops/linear_solve.py``.

* :class:`DenseCholesky` — densify (small/medium systems), one dense
  Cholesky (``torch.linalg.cholesky_ex``, cuSOLVER on the card); every
  ``solve`` is two triangular solves (``torch.cholesky_solve``).
* :class:`CgSolver` — matrix-free (Jacobi-)preconditioned conjugate
  gradient (:func:`~pysparselp_tpu_torch.ops.cg.conjgrad`) for systems too
  large to densify.

``make_spd_solver`` picks between them by size, as in the JAX package.

A failed factorization does not raise: the JAX ``cho_factor`` returns NaN
for a matrix that is not positive definite, so :func:`cholesky_upper`
returns a NaN factor where ``cholesky_ex`` reports ``info != 0`` (without a
host synchronisation), and every solve with it comes out NaN, as in JAX.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import torch

from .cg import conjgrad

DENSE_MAX_DIM = 4096


def cholesky_upper(m):
    """``(u, ok)``: the upper Cholesky factor of the SPD ``m`` (``uᵀu =
    m``; a batch ``(..., k, k)`` factors each matrix) and a bool per
    matrix, False where the factorization failed; that factor is then all
    NaN (the JAX ``cho_factor``'s result)."""
    u, info = torch.linalg.cholesky_ex(m, upper=True, check_errors=False)
    ok = info == 0
    return torch.where(ok[..., None, None], u,
                       torch.full_like(u, float("nan"))), ok


def cholesky_solve(u, b):
    """``m⁻¹ b`` from the upper factor ``u`` of ``m``, ``b`` 1-D."""
    return torch.cholesky_solve(b[:, None], u, upper=True)[:, 0]


def _tensor(v, dtype, device):
    return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                           device=device)


class DenseCholesky:
    """Factor an SPD operator once (dense, on device); solve many times."""

    def __init__(self, m, dtype=torch.float64, ridge=0.0, device="cuda"):
        if scipy.sparse.issparse(m):
            m = m.toarray()
        m = _tensor(m, dtype, device)
        if ridge:
            m = m + ridge * torch.eye(m.shape[0], dtype=m.dtype,
                                      device=m.device)
        self.chol, self.ok = cholesky_upper(m)

    def solve(self, b):
        u = self.chol
        return cholesky_solve(u, torch.as_tensor(b, dtype=u.dtype,
                                                 device=u.device))


class CgSolver:
    """Matrix-free CG with optional diagonal preconditioner."""

    def __init__(self, matvec, diag=None, maxiter=200, tol=1e-10):
        self.matvec = matvec
        self.maxiter = maxiter
        self.tol = tol
        self.precond = None
        if diag is not None:
            if not isinstance(diag, torch.Tensor):
                diag = torch.tensor(np.asarray(diag, np.float64))
            inv = 1.0 / torch.where(diag == 0, torch.ones_like(diag), diag)
            self.precond = lambda r: inv * r

    def solve(self, b, x0=None):
        return conjgrad(self.matvec, b, x0=x0, maxiter=self.maxiter,
                        tol=self.tol, precond=self.precond)


def make_spd_solver(m=None, matvec=None, diag=None, dtype=torch.float64,
                    dense_max_dim=DENSE_MAX_DIM, maxiter=200, ridge=0.0,
                    device="cuda"):
    """Return a factor-once solver for an SPD system.

    Pass the explicit matrix ``m`` (dense Cholesky when ``dim ≤
    dense_max_dim``) and/or a ``matvec`` closure (CG fallback).  ``dtype``
    and ``device`` place what this function builds.
    """
    if m is not None and m.shape[0] <= dense_max_dim:
        return DenseCholesky(m, dtype=dtype, ridge=ridge, device=device)
    if matvec is None:
        if m is None:
            raise ValueError("need m or matvec")
        from ..problem import ell_from_scipy

        mm = scipy.sparse.csr_matrix(m)
        op = ell_from_scipy(mm, dtype, device)
        matvec = op.matvec
        if diag is None:
            diag = _tensor(mm.diagonal(), dtype, device)
    return CgSolver(matvec, diag=diag, maxiter=maxiter)
