# Verbatim copy of pysparselp_tpu/solvers/scipy_bridge.py
"""Bridge to scipy's LP solvers (reference ``SparseLP.py:1101-1132``).

The reference used scipy's (long removed) ``simplex`` / ``interior-point``
methods with per-iteration callbacks.  Modern scipy only ships HiGHS; the
wrapper (``scipy.optimize.linprog``) has no callback and returns ``x = None``
at iteration limits.  To restore the reference's convergence-curve contract
this bridge drives the HiGHS object scipy vendors DIRECTLY
(:mod:`~pysparselp_tpu.solvers.highs_bridge`): warm-started
iteration-limited chunks emit one true curve point (iterations, objective,
violations) per ``nb_iter_plot`` iterations.  ``scipy_simplex`` maps to the
HiGHS simplex, ``scipy_interior_point`` to the HiGHS IPM.

If the vendored module is unavailable, falls back to the wrapper
(``highs-ds`` / ``highs-ipm``) and emits a single post-hoc metrics point
(the reference's behavior for OSQP, ``SparseLP.py:1372-1373``).
"""

from __future__ import annotations

import time

import numpy as np
import scipy.optimize

_METHOD_MAP = {
    "scipy_simplex": "highs-ds",
    "scipy_interior_point": "highs-ipm",
}


def solve_scipy(lp, method, nb_iter=10000, callback_func=None,
                start_time=None, nb_iter_plot=10):
    if lp.b_lower is not None and lp.a_inequalities.shape[0] > 0 and not np.all(
        np.isinf(lp.b_lower) & (lp.b_lower < 0)
    ):
        raise ValueError(
            "you need to convert your lp to a one sided inequality system "
            "using convert_to_one_sided_inequality_system"
        )
    start = time.perf_counter() if start_time is None else start_time
    # the semantics guard can fire AFTER chunk checkpoints were emitted;
    # track the last emitted iteration so the fallback's single point
    # continues a monotone curve instead of restarting the count
    last_emitted = 0
    if callback_func is not None:
        user_cb = callback_func

        def callback_func(niter, *rest):
            nonlocal last_emitted
            last_emitted = max(last_emitted, int(niter))
            user_cb(niter, *rest)

    try:
        from .highs_bridge import HighsSemanticsError, solve_highs_curves

        return solve_highs_curves(
            lp, method, nb_iter=nb_iter, callback_func=callback_func,
            start_time=start, nb_iter_plot=nb_iter_plot,
        )
    except ImportError:  # pragma: no cover - vendored highspy missing
        pass
    except HighsSemanticsError:  # pragma: no cover - scipy upgrade changed
        pass  # counter semantics: single-point wrapper path below
    a_ineq = lp.a_inequalities.tocsr() if lp.a_inequalities.shape[0] else None
    a_eq = lp.a_equalities.tocsr() if lp.a_equalities.shape[0] else None
    sol = scipy.optimize.linprog(
        lp.costsvector,
        A_ub=a_ineq,
        b_ub=lp.b_upper if a_ineq is not None else None,
        A_eq=a_eq,
        b_eq=lp.b_equalities if a_eq is not None else None,
        bounds=np.column_stack((lp.lower_bounds, lp.upper_bounds)),
        method=_METHOD_MAP[method],
        options={"maxiter": int(nb_iter)},
    )
    x = np.asarray(sol.x, dtype=np.float64)
    if callback_func is not None:
        callback_func(
            last_emitted + int(getattr(sol, "nit", 0)),
            x,
            float(lp.costsvector.dot(x)),
            float(lp.costsvector.dot(x)),
            time.perf_counter() - start,
            0.0,
            0.0,
        )
    return x
