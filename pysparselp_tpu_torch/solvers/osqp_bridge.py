# Verbatim copy of pysparselp_tpu/solvers/osqp_bridge.py
"""Bridge to the OSQP solver (reference ``SparseLP.py:1340-1373``).

OSQP solves ``min 1/2 x'Px + q'x  s.t.  l <= Ax <= u``; an LP is the P=0
case.  Like the reference we convert the problem to the
all-inequalities-without-bounds form (box bounds become explicit rows),
clamp infinite right-hand sides to +/-1000 (the reference's pragmatic guard
against OSQP's dislike of infs), run OSQP with its high-accuracy settings,
and emit a single metrics point (OSQP exposes no per-iteration callback).

The ``osqp`` package is imported lazily so this module always imports; the
dispatch layer only routes here when ``osqp`` was importable at modeling
time (``modeling.py`` optional-method probe).

EXPERIMENTAL: osqp is not installed in the development image, so this
bridge has never executed against the live library — the conversion half
is tested (``tests/test_config.py`` fake backend), the ``osqp.OSQP()``
call surface is written to the documented 0.6+ API but unverified.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import scipy.sparse


def solve_osqp(lp, nb_iter=10000, callback_func=None, start_time=None):
    """Solve ``lp`` with OSQP; returns the primal solution as float64."""
    import osqp  # deferred: optional dependency

    start = time.perf_counter() if start_time is None else start_time

    lp_form = copy.deepcopy(lp)
    lp_form.convert_to_all_inequalities_without_bounds()
    b_lower = np.maximum(-1000, np.asarray(lp_form.b_lower, dtype=np.float64))
    b_upper = np.minimum(1000, np.asarray(lp_form.b_upper, dtype=np.float64))
    p = scipy.sparse.csc_matrix((lp.nb_variables, lp.nb_variables))

    opts = {
        "verbose": False,
        "eps_abs": 1e-09,
        "eps_rel": 1e-09,
        "max_iter": int(nb_iter),
        "rho": 0.1,
        "adaptive_rho": False,
        "polish": True,
        "check_termination": 1,
        "warm_start": False,
    }
    model = osqp.OSQP()
    model.setup(
        p,
        np.asarray(lp_form.costsvector, dtype=np.float64),
        lp_form.a_inequalities.tocsr().tocsc(),
        b_lower,
        b_upper,
        **opts,
    )
    res = model.solve()
    x = np.asarray(res.x, dtype=np.float64)
    if callback_func is not None:
        callback_func(
            int(res.info.iter),
            x,
            float(lp.costsvector.dot(x)),
            float(lp.costsvector.dot(x)),
            time.perf_counter() - start,
            0.0,
            0.0,
        )
    return x
