"""Column-sharded Mehrotra predictor-corrector IPM over a
:class:`~.mesh.Mesh` (mirrors ``pysparselp_tpu/parallel/sharded_mehrotra.py``).

Standard form ``min cᵀx, A x = b, x ≥ 0`` (the interior point of
:mod:`pysparselp_tpu_torch.solvers.mehrotra`).  The columns (the variables)
are partitioned over the ranks, ``A = [A_1 | … | A_D]``:

* ``x, s, c`` live with their columns; ``y, b`` (row space) are replicated;
* ``A x = Σ_d A_d x_d`` is one ``psum`` of an m-vector; ``Aᵀ y`` is local;
* dense regime (``m ≤ dense_threshold`` and ``m·n_pad ≤ 64M``): the normal
  matrix ``A D Aᵀ = Σ_d A_d D_d A_dᵀ`` is one ``psum`` of each rank's
  ``(m × n_loc)(n_loc × m)`` product (``torch.matmul``), factored
  replicated by the one-device Cholesky (identical inputs on every rank);
* sparse regime: each rank's columns are a
  :class:`~pysparselp_tpu_torch.problem.CsrMatrix` (H-CSR on the card, both
  orientations), and the normal equations run the port's
  :func:`~pysparselp_tpu_torch.ops.cg.conjgrad` on replicated m-vectors,
  one ``psum`` per CG step (inside ``A D Aᵀ v``), the Jacobi
  preconditioner ``diag(A D Aᵀ)`` one more;
* the ratio tests reduce with ``pmin`` and the residual and complementarity
  sums with ``psum``, each pair of scalars packed into one collective.

Columns are padded to a multiple of the rank count; the padding is masked
out of every reduction (``col_mask``).  Every rank returns the whole x
(one ``all_gather`` of its columns).
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import scipy.sparse
import torch

from ..ops.cg import conjgrad
from ..ops.linear_solve import cholesky_solve, cholesky_upper
from ..problem import CsrMatrix, resolve_dtype
from ..utils.debug import check_iterate
from ..solvers.base import to_np
from .mesh import check_mesh

# what the last mpc_sol_sharded call on this process ran: regime, column
# block width, rank count, iterations computed and the host seconds of the
# set-up
last_run_info: dict | None = None


def build_sharded_ipm_data(a, b, c, mesh, dtype, dense_threshold):
    """This rank's column block of the standard-form system on
    ``mesh.device``: ``(data, n_loc, use_dense)``
    (:func:`build_ipm_shard`)."""
    mesh = check_mesh(mesh)
    return build_ipm_shard(a, b, c, mesh.size, mesh.rank, dtype,
                           mesh.device, dense_threshold)


def build_ipm_shard(a, b, c, ndev, rank, dtype, device, dense_threshold):
    """Rank ``rank``'s column block of ``ndev`` on ``device``: ``(data,
    n_loc, use_dense)``.  ``data`` holds the replicated ``b``, ``bc``,
    ``ridge``, ``tiny`` and the block's ``c``, ``col_mask`` and columns of
    A: dense ``a`` (m, n_loc) or the :class:`CsrMatrix` ``csr``."""
    dev = torch.device(device)
    a = scipy.sparse.csr_matrix(a)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    m, n = a.shape
    n_loc = -(-n // ndev)
    n_pad = n_loc * ndev
    use_dense = m <= dense_threshold and m * n_pad <= 64_000_000
    lo = rank * n_loc
    hi = max(min(lo + n_loc, n), lo)  # all-padding shards: empty

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=dev)

    c_loc = np.zeros(n_loc)
    c_loc[:hi - lo] = c[lo:hi]
    data = dict(
        b=vec(b), c=vec(c_loc),
        col_mask=vec(np.arange(n_loc) < hi - lo),
        bc=vec(1.0 + max(np.linalg.norm(b), np.linalg.norm(c))),
        ridge=vec(1e-12 * max(1.0, float(abs(a).max())) ** 2 * max(m, 1)),
        # the JAX loop's floor jnp.maximum(v, 1e-300): 0 in float32
        tiny=vec(1e-300),
    )
    sub = a.tocsc()[:, lo:hi]
    if sub.shape[1] < n_loc:
        sub = scipy.sparse.hstack(
            [sub, scipy.sparse.csc_matrix((m, n_loc - sub.shape[1]))])
    if use_dense:
        if dev.type == "cuda":
            # full-precision products (TF32 keeps ~3 decimal digits)
            torch.backends.cuda.matmul.allow_tf32 = False
        data["a"] = vec(sub.toarray())
    else:
        data["csr"] = CsrMatrix.from_scipy(sub.tocsr(), dtype, dev)
    return data, n_loc, use_dense


def _local_ops(data, use_dense, mesh):
    """``(matvec, rmatvec, wrowsum)`` over this rank's column block:
    ``A x`` (one psum), ``A_dᵀ y`` (local) and ``diag(A diag(w) Aᵀ)`` (one
    psum)."""
    if use_dense:
        a = data["a"]
        return ((lambda v: mesh.psum(a @ v)), (lambda y: a.T @ y),
                (lambda w: mesh.psum((a * a) @ w)))
    csr = data["csr"]
    return ((lambda v: mesh.psum(csr.matvec(v))), csr.rmatvec,
            (lambda w: mesh.psum(csr.sq_rowsum_weighted(w))))


def _ratio_tests(mesh, cm, *pairs):
    """For each ``(v, dv, eta)`` the largest step ``alpha ≤ 1`` with ``v +
    alpha·dv ≥ 0`` on the real columns, scaled by ``eta``: the minima
    reduce over the ranks in one pmin."""
    mins = []
    for v, dv, _eta in pairs:
        neg = (dv < 0) & (cm > 0)
        ratios = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(
            dv)), torch.full_like(v, float("inf")))
        mins.append(torch.min(ratios))
    mins = mesh.pmin(torch.stack(mins))
    return [torch.clamp(eta * r, 0.0, 1.0)
            for (_v, _dv, eta), r in zip(pairs, mins)]


def _ipm_iteration_sharded(data, x, y, s, theta, ridge_boost, use_dense,
                           n_true, mesh):
    """One sharded predictor-corrector iteration (the one-device
    ``solvers.mehrotra._ipm_iteration`` with the padding masked out of
    every reduction); returns ``(x, y, s, metrics)`` with the iterate kept
    where the step is not finite on some rank."""
    matvec, rmatvec, wrowsum = _local_ops(data, use_dense, mesh)
    cm, c, b, tiny = data["col_mask"], data["c"], data["b"], data["tiny"]

    r_b = matvec(x) - b
    r_c = (rmatvec(y) + s - c) * cm
    r_xs0 = x * s * cm
    sums = mesh.psum(torch.stack([torch.sum(r_xs0),
                                  torch.sum(r_c * r_c)
                                  + torch.sum(r_xs0 * r_xs0)]))
    mu = sums[0] / n_true

    d = torch.clamp(x / torch.maximum(s, tiny), 1e-12, 1e12) * cm

    factored = None
    if use_dense:
        a = data["a"]
        m_mat = mesh.psum((a * d[None, :]) @ a.T)
        ridge = (data["ridge"] + 1e-14 * torch.max(torch.diagonal(m_mat))) \
            * ridge_boost
        m_mat = m_mat + ridge * torch.eye(m_mat.shape[0], dtype=m_mat.dtype,
                                          device=m_mat.device)
        chol, factored = cholesky_upper(m_mat)

        def solve_normal(rhs):
            dy = cholesky_solve(chol, rhs)
            return dy + cholesky_solve(chol, rhs - m_mat @ dy)
    else:
        ridge = data["ridge"] * ridge_boost
        jac_diag = wrowsum(d) + ridge

        def solve_normal(rhs):
            # one psum per CG step (inside matvec)
            return conjgrad(lambda v: matvec(d * rmatvec(v)) + ridge * v,
                            rhs, maxiter=200, tol=1e-12,
                            precond=lambda v: v / jac_diag)

    def newton_raw(rb, rc, r_xs):
        rhs = -rb - matvec(d * rc) + matvec(r_xs / torch.maximum(s, tiny))
        dy = solve_normal(rhs)
        dx = d * (rmatvec(dy) + rc) - r_xs / torch.maximum(s, tiny)
        ds = -(r_xs + s * dx) / torch.maximum(x, tiny)
        return dx * cm, dy, ds * cm

    def newton(r_xs):
        dx, dy, ds = newton_raw(r_b, r_c, r_xs)
        e1 = r_b + matvec(dx)
        e2 = (r_c + rmatvec(dy) + ds) * cm
        e3 = (r_xs + s * dx + x * ds) * cm
        cx, cy, cs = newton_raw(e1, e2, e3)
        return dx + cx, dy + cy, ds + cs

    dx_aff, dy_aff, ds_aff = newton(r_xs0)
    ax_aff, as_aff = _ratio_tests(mesh, cm, (x, dx_aff, 1.0),
                                  (s, ds_aff, 1.0))
    mu_aff = mesh.psum(torch.dot((x + ax_aff * dx_aff) * cm,
                                 s + as_aff * ds_aff)) / n_true
    sigma = (mu_aff / torch.maximum(mu, tiny)) ** 3

    r_xs = r_xs0 + (dx_aff * ds_aff - sigma * mu) * cm
    dx_cc, dy_cc, ds_cc = newton(r_xs)

    dx = dx_aff + dx_cc
    dy = dy_aff + dy_cc
    ds = ds_aff + ds_cc
    alpha_x, alpha_s = _ratio_tests(mesh, cm, (x, dx, theta), (s, ds, theta))

    x_new = x + alpha_x * dx
    y_new = y + alpha_s * dy
    s_new = s + alpha_s * ds
    bad_loc = (~(torch.isfinite(x_new).all()
                 & torch.isfinite(s_new).all())).to(x.dtype)
    tail = mesh.psum(torch.stack([bad_loc, torch.dot(c, x_new * cm)]))
    finite = (tail[0] == 0) & torch.isfinite(y_new).all()
    if factored is not None:
        finite = finite & factored
    step = dict(step_x=x_new, step_y=y_new, step_s=s_new)
    x_new = torch.where(finite, x_new, x)
    y_new = torch.where(finite, y_new, y)
    s_new = torch.where(finite, s_new, s)

    residual = torch.sqrt(sums[1] + torch.sum(r_b * r_b)) / data["bc"]
    return x_new, y_new, s_new, dict(
        residual=residual, mu=mu, f=tail[1], alpha_x=alpha_x,
        alpha_s=alpha_s, finite=finite, step=step)


def _initial_point_sharded(data, use_dense, n_true, mesh):
    """Sharded least-squares initial point (the one-device
    ``solvers.mehrotra._initial_point`` over the column blocks)."""
    matvec, rmatvec, _wrowsum = _local_ops(data, use_dense, mesh)
    cm, c, b, tiny = data["col_mask"], data["c"], data["b"], data["tiny"]

    if use_dense:
        a = data["a"]
        aat = mesh.psum(a @ a.T)
        aat = aat + data["ridge"] * torch.eye(aat.shape[0], dtype=aat.dtype,
                                              device=aat.device)
        chol, _ = cholesky_upper(aat)

        def solve(rhs):
            return cholesky_solve(chol, rhs)
    else:
        def solve(rhs):
            return conjgrad(lambda v: matvec(rmatvec(v)) + data["ridge"] * v,
                            rhs, maxiter=200, tol=1e-12)

    y = solve(matvec(c))
    s = (c - rmatvec(y)) * cm
    x = rmatvec(solve(b)) * cm

    inf = torch.full_like(x, float("inf"))
    mins = mesh.pmin(torch.stack([torch.min(torch.where(cm > 0, x, inf)),
                                  torch.min(torch.where(cm > 0, s, inf))]))
    delta_x = torch.clamp_min(-1.5 * mins[0], 0.0)
    delta_s = torch.clamp_min(-1.5 * mins[1], 0.0)
    pdct, sum_s, sum_x = mesh.psum(torch.stack([
        0.5 * torch.dot((x + delta_x) * cm, s + delta_s),
        torch.dot(s, cm), torch.dot(x, cm)]))
    delta_x_c = delta_x + pdct / torch.maximum(sum_s + n_true * delta_s, tiny)
    delta_s_c = delta_s + pdct / torch.maximum(sum_x + n_true * delta_x, tiny)
    return x + delta_x_c * cm, y, s + delta_s_c * cm


def mpc_sol_sharded(
    a,
    b,
    c,
    mesh,
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
):
    """Mesh-parallel Mehrotra predictor-corrector on ``min cᵀx, Ax=b,
    x ≥ 0``; returns ``(f, x, y, s, niter)`` on every rank (the one-device
    ``mpc_sol``'s contract).  ``mesh`` decides the device; ``dtype=None``
    is float32 on CUDA and float64 on the CPU."""
    global last_run_info
    del error_check
    mesh = check_mesh(mesh)
    dtype = resolve_dtype(dtype, mesh.device)
    if dtype.itemsize < 8:
        warnings.warn(
            "mehrotra (interior point) needs float64 arithmetic to drive "
            "the barrier parameter below ~1e-8; running in "
            f"{str(dtype).split('.')[1]} will stall at a coarse tolerance. "
            "Pass dtype=np.float64.", stacklevel=2)
    a = scipy.sparse.csr_matrix(a)
    b = np.squeeze(np.asarray(b, np.float64))
    c = np.squeeze(np.asarray(c, np.float64))
    n = c.size
    start = time.perf_counter() if start_time is None else start_time

    t0 = time.perf_counter()
    data, n_loc, use_dense = build_sharded_ipm_data(a, b, c, mesh, dtype,
                                                    dense_threshold)
    # evaluations: the iterations computed, the retries with a larger
    # ridge included
    last_run_info = dict(regime="dense" if use_dense else "cg",
                         n_loc=n_loc, ranks=mesh.size, evaluations=0,
                         build_s=time.perf_counter() - t0)
    x, y, s = _initial_point_sharded(data, use_dense, n, mesh)
    theta_dev = torch.as_tensor(theta, dtype=dtype, device=mesh.device)

    def x_host(v):
        return to_np(mesh.all_gather(v))[:n]

    niter_done = 0
    for niter in range(max_iter):
        ridge_boost = 1.0
        last_run_info["evaluations"] += 1
        x_new, y_new, s_new, metrics = _ipm_iteration_sharded(
            data, x, y, s, theta_dev, ridge_boost, use_dense, n, mesh)
        check_iterate("mehrotra", niter, x=x, y=y, s=s,
                      residual=metrics["residual"], **metrics["step"])
        retries = 0
        while not bool(metrics["finite"]) and retries < 4:
            ridge_boost *= 100.0
            retries += 1
            last_run_info["evaluations"] += 1
            x_new, y_new, s_new, metrics = _ipm_iteration_sharded(
                data, x, y, s, theta_dev, ridge_boost, use_dense, n, mesh)
        residual = float(metrics["residual"])
        if verbose > 1:
            print("%3d %9.2e %9.2e %9.2e" % (niter, float(metrics["f"]),
                                             float(metrics["mu"]), residual))
        if callback is not None:
            callback(x_host(x), niter, elapsed=time.perf_counter() - start)
        if residual < eps:
            niter_done = niter
            break
        if not bool(metrics["finite"]):
            niter_done = niter
            break
        x, y, s = x_new, y_new, s_new
        niter_done = niter
        if max_time is not None and time.perf_counter() - start > max_time:
            break

    xh = x_host(x)
    f = float(np.dot(c, xh))
    return f, xh, to_np(y), x_host(s), niter_done
