"""Mehrotra predictor-corrector primal-dual interior point method, PyTorch
port of ``pysparselp_tpu/solvers/mehrotra.py``.

Standard form ``min cᵀx, A x = b, x ≥ 0`` (the reference's
``pysparselp/MehrotraPDIP.py:18-215``).  Each Newton KKT system is reduced
to the SPD normal equations

    (A D Aᵀ) dy = -r_b - A(D r_c) + A(r_xs / s),      D = diag(x/s)

which are solved, as in the JAX package, either by one dense Cholesky per
outer iteration (``m ≤ dense_threshold`` rows and ``m·n ≤ 64M``: the normal
matrix by ``torch.matmul``, the factor by ``torch.linalg.cholesky_ex``,
shared by predictor and corrector) or matrix-free by Jacobi-preconditioned
CG (:func:`~pysparselp_tpu_torch.ops.cg.conjgrad`), whose products are the
lowered operator's (H-DIA, H-CSR or H-BSR on the card) and whose
preconditioner is ``diag(A D Aᵀ)`` from the operator's
``sq_rowsum_weighted``.

A failed Cholesky does not raise: its factor is NaN (the JAX
``cho_factor``'s result), the step comes out non-finite and ``mpc_sol``
retries the iteration with a larger ridge, as in the JAX package.  The host
reads back two scalars per outer iteration (the ``finite`` flag and the
residual), as the JAX loop does.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import scipy.sparse
import torch

from ..ops.cg import conjgrad
from ..ops.linear_solve import cholesky_solve, cholesky_upper
from ..problem import ell_from_scipy, resolve_device, resolve_dtype
from ..utils.debug import check_iterate
from .base import to_np


def _ratio_test(v, dv, eta):
    """Largest step alpha ≤ 1 with v + alpha·dv ≥ 0, scaled by eta
    (``MehrotraPDIP.py:102-107``)."""
    neg = dv < 0
    ratios = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                         torch.full_like(v, float("inf")))
    return torch.clamp(eta * torch.min(ratios), 0.0, 1.0)


def _products(data, use_dense):
    """``(matvec, rmatvec)`` of A: the dense matrix or the operator."""
    if use_dense:
        a_dense = data["a_dense"]
        return (lambda v: a_dense @ v), (lambda v: a_dense.T @ v)
    ell = data["ell"]
    return ell.matvec, ell.rmatvec


def _ipm_iteration(data, x, y, s, theta, ridge_boost, use_dense: bool):
    """One predictor-corrector step; returns ``(x, y, s, metrics)`` with
    the iterate kept where the step is not finite."""
    ell = data.get("ell")
    b, c, tiny = data["b"], data["c"], data["tiny"]
    n = x.shape[0]
    matvec, rmatvec = _products(data, use_dense)

    r_b = matvec(x) - b
    r_c = rmatvec(y) + s - c
    r_xs0 = x * s
    mu = torch.mean(r_xs0)

    d = torch.clamp(x / torch.maximum(s, tiny), 1e-12, 1e12)

    if use_dense:
        a_dense = data["a_dense"]
        m = (a_dense * d[None, :]) @ a_dense.T
        # ridge scaled with the diagonal keeps the Cholesky stable as
        # complementarity drives cond(A D Aᵀ) → ∞ near convergence; the host
        # raises ridge_boost and retries when a step still comes out non-finite
        ridge = (data["ridge"] + 1e-14 * torch.max(torch.diagonal(m))) \
            * ridge_boost
        m = m + ridge * torch.eye(m.shape[0], dtype=m.dtype, device=m.device)
        chol, factored = cholesky_upper(m)

        def solve_normal(rhs):
            # one step of iterative refinement recovers accuracy lost to the
            # ridge and to the ill-conditioned terminal Cholesky
            dy = cholesky_solve(chol, rhs)
            return dy + cholesky_solve(chol, rhs - m @ dy)
    else:
        factored = None
        ridge = data["ridge"] * ridge_boost
        jac_diag = ell.sq_rowsum_weighted(d) + ridge

        def solve_normal(rhs):
            return conjgrad(
                lambda v: ell.matvec(d * ell.rmatvec(v)) + ridge * v,
                rhs, maxiter=200, tol=1e-12,
                precond=lambda v: v / jac_diag)

    def newton_raw(rb, rc, r_xs):
        rhs = -rb - matvec(d * rc) + matvec(r_xs / torch.maximum(s, tiny))
        dy = solve_normal(rhs)
        dx = d * (rmatvec(dy) + rc) - r_xs / torch.maximum(s, tiny)
        ds = -(r_xs + s * dx) / torch.maximum(x, tiny)
        return dx, dy, ds

    def newton(r_xs):
        dx, dy, ds = newton_raw(r_b, r_c, r_xs)
        # KKT-level iterative refinement (same factorization): recovers the
        # primal-feasibility digits the normal-equations reduction loses
        e1 = r_b + matvec(dx)                    # want A dx = -r_b
        e2 = r_c + rmatvec(dy) + ds              # want Aᵀdy + ds = -r_c
        e3 = r_xs + s * dx + x * ds              # want s dx + x ds = -r_xs
        cx, cy, cs = newton_raw(e1, e2, e3)
        return dx + cx, dy + cy, ds + cs

    # predictor (affine scaling)
    dx_aff, dy_aff, ds_aff = newton(r_xs0)
    ax_aff = _ratio_test(x, dx_aff, 1.0)
    as_aff = _ratio_test(s, ds_aff, 1.0)
    mu_aff = torch.dot(x + ax_aff * dx_aff, s + as_aff * ds_aff) / n
    sigma = (mu_aff / torch.maximum(mu, tiny)) ** 3

    # corrector (same factorization)
    r_xs = r_xs0 + dx_aff * ds_aff - sigma * mu
    dx_cc, dy_cc, ds_cc = newton(r_xs)

    dx = dx_aff + dx_cc
    dy = dy_aff + dy_cc
    ds = ds_aff + ds_cc
    alpha_x = _ratio_test(x, dx, theta)
    alpha_s = _ratio_test(s, ds, theta)

    x_new = x + alpha_x * dx
    y_new = y + alpha_s * dy
    s_new = s + alpha_s * ds
    finite = (torch.isfinite(x_new).all() & torch.isfinite(y_new).all()
              & torch.isfinite(s_new).all())
    if factored is not None:
        finite = finite & factored
    # the step before rejection, for debug_mode (references, no device work)
    step = dict(step_x=x_new, step_y=y_new, step_s=s_new)
    # reject non-finite steps (ill-conditioned normal matrix at convergence):
    # keep the previous iterate; the host loop stops on the `finite` flag
    x_new = torch.where(finite, x_new, x)
    y_new = torch.where(finite, y_new, y)
    s_new = torch.where(finite, s_new, s)

    residual = torch.linalg.norm(torch.cat((r_b, r_c, r_xs0))) / data["bc"]
    return x_new, y_new, s_new, dict(
        residual=residual, mu=mu, f=torch.dot(c, x_new),
        alpha_x=alpha_x, alpha_s=alpha_s, finite=finite, step=step,
    )


def _initial_point(data, use_dense: bool):
    """Least-squares initial point (``MehrotraPDIP.py:18-53``)."""
    b, c, tiny = data["b"], data["c"], data["tiny"]
    n = c.shape[0]
    matvec, rmatvec = _products(data, use_dense)

    if use_dense:
        a_dense = data["a_dense"]
        aat = a_dense @ a_dense.T
        aat = aat + data["ridge"] * torch.eye(aat.shape[0], dtype=aat.dtype,
                                              device=aat.device)
        chol, _ = cholesky_upper(aat)

        def solve(rhs):
            return cholesky_solve(chol, rhs)
    else:
        ell = data["ell"]

        def solve(rhs):
            return conjgrad(
                lambda v: ell.matvec(ell.rmatvec(v)) + data["ridge"] * v,
                rhs, maxiter=200, tol=1e-12)

    y = solve(matvec(c))
    s = c - rmatvec(y)
    x = rmatvec(solve(b))

    delta_x = torch.clamp_min(-1.5 * torch.min(x), 0.0)
    delta_s = torch.clamp_min(-1.5 * torch.min(s), 0.0)
    pdct = 0.5 * torch.dot(x + delta_x, s + delta_s)
    delta_x_c = delta_x + pdct / torch.maximum(torch.sum(s) + n * delta_s,
                                               tiny)
    delta_s_c = delta_s + pdct / torch.maximum(torch.sum(x) + n * delta_x,
                                               tiny)
    return x + delta_x_c, y, s + delta_s_c


def setup(a, b, c, dtype, device, dense_threshold=4096):
    """``(data, use_dense)``: the device data of ``mpc_sol`` for the
    standard-form system (the dense matrix, or the operator
    ``ell_from_scipy`` lowers ``a`` to)."""
    a = scipy.sparse.csr_matrix(a)
    b = np.squeeze(np.asarray(b, np.float64))
    c = np.squeeze(np.asarray(c, np.float64))
    m, n = a.shape
    use_dense = m <= dense_threshold and m * n <= 64_000_000
    scale = max(1.0, float(abs(a).max()))

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)

    data = dict(
        b=vec(b), c=vec(c),
        bc=vec(1.0 + max(np.linalg.norm(b), np.linalg.norm(c))),
        ridge=vec(1e-12 * scale * scale * max(m, 1)),
        # the JAX loop's floor jnp.maximum(v, 1e-300): 0 in float32
        tiny=vec(1e-300),
    )
    if use_dense:
        if torch.device(device).type == "cuda":
            # full-precision products (TF32 keeps ~3 decimal digits)
            torch.backends.cuda.matmul.allow_tf32 = False
        data["a_dense"] = vec(a.toarray())
    else:
        data["ell"] = ell_from_scipy(a, dtype, device)
    return data, use_dense


def mpc_sol(
    a,
    b,
    c,
    max_iter=100,
    eps=1e-9,
    theta=0.9995,
    verbose=0,
    error_check=False,
    callback=None,
    dtype=None,
    dense_threshold=4096,
    start_time=None,
    max_time=None,
    device="cuda",
):
    """Mehrotra predictor-corrector on ``min cᵀx, Ax=b, x>=0``.

    Returns ``(f, x, y, s, niter)`` — signature parity with
    ``pysparselp/MehrotraPDIP.py:110`` (plus ``device``).
    """
    del error_check
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype, dev)
    if dtype.itemsize < 8:
        warnings.warn(
            "mehrotra (interior point) needs float64 arithmetic to drive "
            "the barrier parameter below ~1e-8; running in "
            f"{str(dtype).split('.')[1]} (the default on CUDA) will stall at "
            "a coarse tolerance. Pass dtype=np.float64, or use a first-order "
            "method in float32.",
            stacklevel=2,
        )
    start = time.perf_counter() if start_time is None else start_time
    data, use_dense = setup(a, b, c, dtype, dev, dense_threshold)

    x, y, s = _initial_point(data, use_dense)
    theta_dev = torch.as_tensor(theta, dtype=dtype, device=dev)

    if verbose > 1:
        print(
            "\n%3s %6s %9s %11s %9s %9s"
            % ("ITER", "COST", "MU", "RESIDUAL", "ALPHAX", "ALPHAS")
        )

    niter_done = 0
    for niter in range(max_iter):
        ridge_boost = 1.0
        x_new, y_new, s_new, metrics = _ipm_iteration(
            data, x, y, s, theta_dev, ridge_boost, use_dense)
        # debug_mode: trap a NaN (or, with infs=True, infinite) iterate or
        # step here, before such a step is rejected and retried
        check_iterate("mehrotra", niter, x=x, y=y, s=s,
                      residual=metrics["residual"], **metrics["step"])
        # non-finite step: raise the regularization and retry this iteration
        retries = 0
        while not bool(metrics["finite"]) and retries < 4:
            ridge_boost *= 100.0
            retries += 1
            x_new, y_new, s_new, metrics = _ipm_iteration(
                data, x, y, s, theta_dev, ridge_boost, use_dense)
        residual = float(metrics["residual"])
        if verbose > 1:
            print(
                "%3d %9.2e %9.2e %9.2e %9.4g %9.4g"
                % (
                    niter, float(metrics["f"]), float(metrics["mu"]),
                    residual, float(metrics["alpha_x"]),
                    float(metrics["alpha_s"]),
                )
            )
        if callback is not None:
            callback(to_np(x), niter, elapsed=time.perf_counter() - start)
        if residual < eps:
            niter_done = niter
            break
        if not bool(metrics["finite"]):
            # normal matrix became numerically singular; the previous iterate
            # is the best answer available
            niter_done = niter
            break
        x, y, s = x_new, y_new, s_new
        niter_done = niter
        if max_time is not None and time.perf_counter() - start > max_time:
            break

    f = float(torch.dot(data["c"], x))
    return f, to_np(x), to_np(y), to_np(s), niter_done
