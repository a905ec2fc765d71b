"""Solver dispatch (mirrors ``pysparselp_tpu/solvers/__init__.py``).

Ported so far, each on one device or, with ``mesh=`` (a
:class:`~pysparselp_tpu_torch.parallel.mesh.Mesh`), over a
``torch.distributed`` group whose device the mesh decides:

* ``chambolle_pock_ppd`` (position-sharded for float32 aligned DIA
  systems, ``parallel.sharded_cp_windowed``, else row-sharded,
  ``parallel.sharded_cp``);
* ``mehrotra`` (:mod:`.mehrotra`, the interior point on the normal
  equations: dense Cholesky or device CG; column-sharded:
  ``parallel.sharded_mehrotra``);
* ``admm`` and ``admm2`` (:mod:`.admm`; row-sharded:
  ``parallel.sharded_admm``) and ``admm_blocks`` (:mod:`.admm_blocks`,
  consensus ADMM over the model's blocks; the block batch sharded);
* ``dual_gradient_ascent`` and ``dual_coordinate_ascent`` (both modes;
  :mod:`.dual_ascent`; row-sharded DGA, ``parallel.sharded_dga``, and
  blocked DCA with its colour groups split, ``parallel.sharded_dca``);
* the host bridges ``scipy_simplex`` / ``scipy_interior_point`` (HiGHS
  through scipy, :mod:`.scipy_bridge`) and, where their packages are
  installed, ``osqp`` (:mod:`.osqp_bridge`) and ``ECOS`` / ``SCS`` /
  ``CVXOPT`` (cvxpy, :mod:`.cvxpy_bridge`), which run on the host whatever
  ``device`` says.

``dispatch`` performs the same per-method host-side conversions as the JAX
package's: CP-PPD removes fixed variables (warm starts mapped into the
reduced space), Mehrotra removes fixed variables and converts to slack
form, DCA removes fixed variables, and every solution and callback
iterate is mapped back with ``x_original = m_change @ x_new + shift``;
ADMM, dual gradient ascent and the bridges take the full LP.  With
``mesh=``, a ``device`` that disagrees with ``mesh.device`` raises; DCA
runs the blocked mode whatever ``mode`` says, and ADMM's host mode
(``inner="gauss_seidel"``) ignores the mesh, as in the JAX package.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..utils.instrumentation import span
from .base import mirror_callback_attrs, to_np


def _same_option(a, b) -> bool:
    """Equality that tolerates arrays (identity) for option values."""
    if a is b:
        return True
    if isinstance(a, (int, float, str, bool, type(None))) and isinstance(
        b, (int, float, str, bool, type(None))
    ):
        return a == b
    return False


def _check_mesh_device(mesh, device):
    """The mesh decides the device: a ``device`` that disagrees with
    ``mesh.device`` raises."""
    from ..parallel.mesh import check_mesh

    check_mesh(mesh)
    want = torch.device(device)
    if want.type != mesh.device.type or (
            want.index is not None and want != mesh.device):
        raise ValueError(
            f"device={device!r} disagrees with mesh.device="
            f"{mesh.device}; the mesh decides the device, pass "
            f"device={str(mesh.device)!r} or leave them equal")


def _csr(blocked):
    """BlockedCSR -> scipy csr, or None when it has no rows."""
    if blocked is None or blocked.shape[0] == 0:
        return None
    return blocked.tocsr()


def dispatch(
    lp,
    method,
    x0,
    nb_iter,
    max_time,
    callback_func,
    nb_iter_plot,
    start_time,
    force_integer=False,
    dtype=None,
    device="cuda",
    **solver_kwargs,
):
    from ..config import resolve_config
    from ..modeling import solving_methods

    if method not in solving_methods:
        raise ValueError(
            f"method {method!r} not valid; available methods are {solving_methods}"
        )

    # typed per-solver config gate: unknown/typo'd options raise here with
    # the valid field list instead of deep inside the solver
    cfg = resolve_config(method, solver_kwargs)
    if cfg is not None:
        solver_kwargs = cfg.solver_kwargs()
        # drop untouched optionals so the solver keeps its own defaults
        defaults = type(cfg)()
        solver_kwargs = {
            k: v
            for k, v in solver_kwargs.items()
            if not _same_option(v, getattr(defaults, k))
        }
    if method in ("scipy_simplex", "scipy_interior_point"):
        from .scipy_bridge import solve_scipy

        return solve_scipy(
            lp, method, nb_iter=nb_iter, callback_func=callback_func,
            start_time=start_time, nb_iter_plot=nb_iter_plot,
        )

    if method == "osqp":  # pragma: no cover - optional dependency
        from .osqp_bridge import solve_osqp

        return solve_osqp(lp, nb_iter=nb_iter, callback_func=callback_func,
                          start_time=start_time)

    if method in ("ECOS", "SCS", "CVXOPT"):  # pragma: no cover - optional
        from .cvxpy_bridge import solve_cvxpy

        return solve_cvxpy(lp, method, nb_iter=nb_iter,
                           callback_func=callback_func, start_time=start_time)

    mesh = solver_kwargs.get("mesh")
    if mesh is not None and not (method == "admm" and solver_kwargs.get(
            "inner") == "gauss_seidel"):
        _check_mesh_device(mesh, device)

    if method in ("admm", "admm2", "admm_blocks"):
        from .admm import lp_admm, lp_admm2
        from .admm_blocks import lp_admm_block_decomposition

        a_ineq = _csr(lp.a_inequalities)
        a_eq = _csr(lp.a_equalities)
        # admm_blocks splits the systems by the model's row blocks
        for a, blocked in ((a_ineq, lp.a_inequalities),
                           (a_eq, lp.a_equalities)):
            if a is not None:
                a.blocks = list(blocked.blocks)
        return {"admm": lp_admm, "admm2": lp_admm2,
                "admm_blocks": lp_admm_block_decomposition}[method](
            lp.costsvector, a_eq,
            lp.b_equalities if a_eq is not None else None, a_ineq,
            lp.b_lower if a_ineq is not None else None,
            lp.b_upper if a_ineq is not None else None,
            lp.lower_bounds, lp.upper_bounds,
            nb_iter=nb_iter, x0=x0, callback_func=callback_func,
            max_time=max_time, nb_iter_plot=nb_iter_plot, dtype=dtype,
            start_time=start_time, device=device, **solver_kwargs,
        )

    mesh = solver_kwargs.pop("mesh", None)
    if method == "mehrotra":
        from .mehrotra import mpc_sol

        lp_slack = copy.deepcopy(lp)
        m_change1, shift1 = lp_slack.remove_fixed_variables()
        m_change2, shift2 = lp_slack.convert_to_slack_form()

        def mehrotra_cb(solution, niter, **kw):
            x = m_change1 @ (m_change2 @ solution + shift2) + shift1
            callback_func(niter, x, float(lp.costsvector.dot(x)), 0.0,
                          kw.get("elapsed", 0.0), 0.0, 0.0)

        if mesh is not None:
            # column-shard the standard-form system over the mesh
            from ..parallel.sharded_mehrotra import mpc_sol_sharded

            solve, where = mpc_sol_sharded, dict(mesh=mesh)
        else:
            solve, where = mpc_sol, dict(device=device)
        _f, x, _y, _s, _n = solve(
            lp_slack.a_equalities.tocsr(),
            lp_slack.b_equalities,
            lp_slack.costsvector,
            max_iter=nb_iter,
            callback=mehrotra_cb,
            dtype=dtype,
            start_time=start_time,
            max_time=max_time,
            **where,
            **solver_kwargs,
        )
        return m_change1 @ (m_change2 @ x + shift2) + shift1

    if method in ("dual_gradient_ascent", "dual_coordinate_ascent"):
        return _dual_ascent(lp, method, x0, nb_iter, max_time,
                            callback_func, nb_iter_plot, start_time, dtype,
                            device, dict(solver_kwargs, mesh=mesh))

    # method == "chambolle_pock_ppd"
    from .chambolle_pock import chambolle_pock_ppd

    with span("presolve.reduce"):
        lp_reduced = copy.deepcopy(lp)
        m_change, shift = lp_reduced.remove_fixed_variables()
        # warm start: map into the reduced space (inverse of
        # ``x = m_change @ x_r + shift``; m_change columns are unit vectors)
        x0_r = None if x0 is None else m_change.T @ (np.asarray(x0) - shift)
        x30 = solver_kwargs.pop("x30", None)
        if x30 is not None:
            solver_kwargs["x30"] = m_change.T @ (np.asarray(x30) - shift)
        a_ineq_r = _csr(lp_reduced.a_inequalities)
        a_eq_r = _csr(lp_reduced.a_equalities)

    def back(niter, sol, e1, e2, dur, mveq, mvineq, state=None):
        if state is not None:
            state = dict(
                state,
                x=m_change @ state["x"] + shift,
                x3=m_change @ state["x3"] + shift,
            )
        if not back.wants_solution:
            # light-metrics contract: a solution-less callback must not
            # trigger the device fetch the untransform would cost
            xb = sol
        else:
            xb = m_change @ to_np(sol) + shift
        callback_func(
            niter, xb, e1, e2, dur, mveq, mvineq,
            **(
                {"state": state}
                if getattr(callback_func, "wants_state", False)
                else {}
            ),
        )

    mirror_callback_attrs(back, callback_func)

    if mesh is not None:
        # multi-device path: row-shard the constraint systems over the mesh
        from ..parallel.sharded_cp import chambolle_pock_ppd_sharded

        x = chambolle_pock_ppd_sharded(
            lp_reduced.costsvector, a_eq_r,
            lp_reduced.b_equalities if a_eq_r is not None else None,
            a_ineq_r,
            lp_reduced.b_lower if a_ineq_r is not None else None,
            lp_reduced.b_upper if a_ineq_r is not None else None,
            lp_reduced.lower_bounds, lp_reduced.upper_bounds, mesh,
            nb_max_iter=nb_iter, nb_iter_plot=nb_iter_plot,
            callback_func=back, max_time=max_time, x0=x0_r,
            start_time=start_time, force_integer=force_integer, dtype=dtype,
            **solver_kwargs,
        )
        if force_integer:
            x, _best = x
            if _best is not None:
                x = _best
        return m_change @ x + shift
    x, _best = chambolle_pock_ppd(
        lp_reduced.costsvector,
        a_eq_r,
        lp_reduced.b_equalities if a_eq_r is not None else None,
        a_ineq_r,
        lp_reduced.b_lower if a_ineq_r is not None else None,
        lp_reduced.b_upper if a_ineq_r is not None else None,
        lp_reduced.lower_bounds,
        lp_reduced.upper_bounds,
        x0=x0_r,
        alpha=solver_kwargs.pop("alpha", 1.0),
        theta=solver_kwargs.pop("theta", 1.0),
        nb_max_iter=nb_iter,
        callback_func=back,
        max_time=max_time,
        force_integer=force_integer,
        nb_iter_plot=nb_iter_plot,
        dtype=dtype,
        start_time=start_time,
        device=device,
        **solver_kwargs,
    )
    if force_integer and _best is not None:
        # return the best feasible integer-rounded iterate the solver
        # tracked (``ChambollePockPPD.py:274-291``)
        x = _best
    with span("postsolve"):
        return m_change @ x + shift


def _dual_ascent(lp, method, x0, nb_iter, max_time, callback_func,
                 nb_iter_plot, start_time, dtype, device, solver_kwargs):
    """The dual ascent branches of :func:`dispatch` (JAX's
    ``solvers/__init__.py:270-310``): DGA on the full LP, DCA on the LP
    with its fixed variables removed, its solution and callback iterates
    mapped back.  With ``mesh=`` DCA runs the blocked mode (``mode`` is
    dropped, as in the JAX package)."""
    from .dual_ascent import dual_coordinate_ascent, dual_gradient_ascent

    y_eq = solver_kwargs.pop("y_eq", None)
    y_ineq = solver_kwargs.pop("y_ineq", None)
    if method == "dual_gradient_ascent":
        x, _y_eq, _y_ineq = dual_gradient_ascent(
            x=x0, lp=lp, nb_max_iter=nb_iter, callback_func=callback_func,
            y_eq=y_eq, y_ineq=y_ineq, max_time=max_time,
            nb_iter_plot=nb_iter_plot, dtype=dtype, start_time=start_time,
            device=device, **solver_kwargs,
        )
        return x

    lp_reduced = copy.deepcopy(lp)
    m_change, shift = lp_reduced.remove_fixed_variables()
    x0_r = None if x0 is None else m_change.T @ (np.asarray(x0) - shift)

    def back(niter, sol, e1, e2, dur, mveq, mvineq):
        callback_func(niter, m_change @ sol + shift, e1, e2, dur, mveq, mvineq)

    if solver_kwargs.get("mesh") is not None:
        # mesh= implies the blocked (graph-colored) mode: the sequential
        # sweep is one chain through c̄
        solver_kwargs.pop("mode", None)

    x, _y_eq, _y_ineq = dual_coordinate_ascent(
        x=x0_r, lp=lp_reduced, nb_max_iter=nb_iter, callback_func=back,
        y_eq=y_eq, y_ineq=y_ineq, max_time=max_time,
        nb_iter_plot=nb_iter_plot, dtype=dtype, start_time=start_time,
        device=device, **solver_kwargs,
    )
    return m_change @ x + shift
