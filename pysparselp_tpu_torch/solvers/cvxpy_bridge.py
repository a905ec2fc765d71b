# Verbatim copy of pysparselp_tpu/solvers/cvxpy_bridge.py
"""Bridge to CVXPY backends ECOS / SCS / CVXOPT (reference
``SparseLP.py:930-988`` ``convert_to_cvxpy`` + dispatch ``:1161-1191``).

Builds the cvxpy problem from the LP's canonical pieces (costs, box bounds,
two-sided inequalities, equalities) and hands it to the requested conic
solver.  Mixed finite/infinite bounds inside one array raise, matching the
reference's "not coded yet" guards.

``cvxpy`` is imported lazily so this module always imports; the dispatch
layer only routes here when cvxpy was importable at modeling time.

EXPERIMENTAL: cvxpy and its conic backends are not installed in the
development image, so this bridge has never executed against the live
libraries — the conversion half is tested (``tests/test_config.py`` fake
backend), the ``cvxpy.Problem`` call surface is unverified.
"""

from __future__ import annotations

import time

import numpy as np


def convert_to_cvxpy(lp):
    """Return ``(cvxpy.Problem, x_variable)`` for ``lp``."""
    import cvxpy  # deferred: optional dependency

    a_ineq = None
    if lp.a_inequalities is not None and lp.a_inequalities.shape[0] > 0:
        a_ineq = lp.a_inequalities.tocsr()
    a_eq = b_eq = None
    if lp.a_equalities.shape[0] > 0:
        a_eq = lp.a_equalities.tocsr()
        b_eq = lp.b_equalities

    x = cvxpy.Variable(lp.nb_variables)
    objective = cvxpy.Minimize(lp.costsvector @ x)
    constraints = []

    def _add_bound(values, build):
        isinf = np.isinf(values)
        if np.all(isinf):
            return
        if np.any(isinf):
            raise NotImplementedError(
                "mixed finite/infinite bounds are not supported by the "
                "cvxpy bridge (reference SparseLP.py:954-965)"
            )
        constraints.append(build(values))

    _add_bound(lp.lower_bounds, lambda v: v <= x)
    _add_bound(lp.upper_bounds, lambda v: x <= v)
    if a_ineq is not None:
        if lp.b_upper is not None:
            _add_bound(lp.b_upper, lambda v: a_ineq @ x <= v)
        if lp.b_lower is not None:
            _add_bound(lp.b_lower, lambda v: v <= a_ineq @ x)
    if a_eq is not None:
        constraints.append(a_eq @ x == b_eq)
    return cvxpy.Problem(objective, constraints), x


def solve_cvxpy(lp, method, nb_iter=10000, callback_func=None, start_time=None):
    """Solve ``lp`` via cvxpy with the ``method`` backend; returns x."""
    import cvxpy  # deferred: optional dependency

    start = time.perf_counter() if start_time is None else start_time
    prob, x_var = convert_to_cvxpy(lp)
    if method == "SCS":
        prob.solve(verbose=False, solver=cvxpy.SCS, max_iters=int(nb_iter),
                   eps=1e-5)
    elif method == "ECOS":
        prob.solve(verbose=False, solver=cvxpy.ECOS)
    elif method == "CVXOPT":
        prob.solve(verbose=False, solver=cvxpy.CVXOPT)
    else:
        raise ValueError(f"unknown cvxpy backend {method!r}")
    x = np.asarray(x_var.value, dtype=np.float64).ravel()
    if callback_func is not None:
        callback_func(
            int(prob.solver_stats.num_iters or 0)
            if prob.solver_stats is not None else 0,
            x,
            float(lp.costsvector.dot(x)),
            float(lp.costsvector.dot(x)),
            time.perf_counter() - start,
            0.0,
            0.0,
        )
    return x
