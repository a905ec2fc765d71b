# Verbatim copy of pysparselp_tpu/solvers/highs_bridge.py
"""Direct HiGHS driver with per-iteration convergence curves.

The reference harvested real iteration curves from scipy's (long-removed)
``simplex``/``interior-point`` callbacks (``pysparselp/SparseLP.py:1101-1132``).
Modern ``scipy.optimize.linprog`` only ships HiGHS, whose scipy wrapper has
no callback and returns ``x = None`` at iteration limits — so a wrapper-level
bridge can only emit a single post-hoc point.

This module restores the reference's curve contract by driving the HiGHS
solver object that scipy VENDORS (``scipy.optimize._highspy._core._Highs``)
directly: the model is passed once, then solved in iteration-limited chunks.
``getSolution()`` on the native object returns the CURRENT iterate even at an
iteration limit, and consecutive ``run()`` calls WARM-START (simplex resumes
from its basis; iteration counts accumulate), so the whole curve costs about
one solve.  Each chunk boundary emits one callback point with the true
iteration count, objective, and constraint violations at that iterate.

Used by :mod:`~pysparselp_tpu.solvers.scipy_bridge` when the vendored module
is importable; the wrapper-level single-point path remains as the fallback.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse


def _core():
    from scipy.optimize._highspy import _core as core

    return core


class HighsSemanticsError(RuntimeError):
    """The vendored HiGHS iteration-count semantics differ from the ones this
    bridge was verified against (simplex: per-run counts + warm-started
    chunks; IPM: cumulative counts + growing limit).  Raised so the caller
    can fall back to the single-point wrapper path instead of silently
    emitting wrong or non-monotone iteration curves."""


_SOLVER_MAP = {
    "scipy_simplex": "simplex",
    "scipy_interior_point": "ipm",
}


def build_highs_model(lp):
    """Build a native HighsLp from a (one-sided) SparseLP model."""
    core = _core()
    n = int(lp.nb_variables)
    rows = []
    row_lower = []
    row_upper = []
    if lp.a_equalities is not None and lp.a_equalities.shape[0]:
        a_eq = lp.a_equalities.tocsr()
        rows.append(a_eq)
        row_lower.append(np.asarray(lp.b_equalities, np.float64))
        row_upper.append(np.asarray(lp.b_equalities, np.float64))
    if lp.a_inequalities is not None and lp.a_inequalities.shape[0]:
        a_in = lp.a_inequalities.tocsr()
        rows.append(a_in)
        m_in = a_in.shape[0]
        bl = (np.full(m_in, -np.inf) if lp.b_lower is None
              else np.asarray(lp.b_lower, np.float64))
        bu = (np.full(m_in, np.inf) if lp.b_upper is None
              else np.asarray(lp.b_upper, np.float64))
        row_lower.append(np.where(np.isfinite(bl), bl, -core.kHighsInf))
        row_upper.append(np.where(np.isfinite(bu), bu, core.kHighsInf))
    a = (scipy.sparse.vstack(rows).tocsc() if rows
         else scipy.sparse.csc_matrix((0, n)))

    model = core.HighsLp()
    model.num_col_ = n
    model.num_row_ = a.shape[0]
    model.col_cost_ = np.asarray(lp.costsvector, np.float64)
    cl = np.asarray(lp.lower_bounds, np.float64)
    cu = np.asarray(lp.upper_bounds, np.float64)
    model.col_lower_ = np.where(np.isfinite(cl), cl, -core.kHighsInf)
    model.col_upper_ = np.where(np.isfinite(cu), cu, core.kHighsInf)
    model.row_lower_ = (np.concatenate(row_lower) if row_lower
                        else np.zeros(0))
    model.row_upper_ = (np.concatenate(row_upper) if row_upper
                        else np.zeros(0))
    model.a_matrix_.format_ = core.MatrixFormat.kColwise
    model.a_matrix_.start_ = a.indptr
    model.a_matrix_.index_ = a.indices
    model.a_matrix_.value_ = a.data
    return model


def _violations(lp, x):
    veq = vineq = 0.0
    if lp.a_equalities is not None and lp.a_equalities.shape[0]:
        veq = float(np.max(np.abs(
            lp.a_equalities.tocsr() @ x - lp.b_equalities), initial=0.0))
    if lp.a_inequalities is not None and lp.a_inequalities.shape[0]:
        r = lp.a_inequalities.tocsr() @ x
        if lp.b_upper is not None:
            vineq = max(vineq, float(np.max(r - lp.b_upper, initial=0.0)))
        if lp.b_lower is not None:
            bl = np.asarray(lp.b_lower, np.float64)
            finite = np.isfinite(bl)
            if finite.any():
                vineq = max(vineq, float(np.max(
                    bl[finite] - r[finite], initial=0.0)))
    return veq, vineq


def solve_highs_curves(lp, method, nb_iter=10000, callback_func=None,
                       start_time=None, nb_iter_plot=10):
    """Solve via the vendored HiGHS object, emitting one callback point per
    ``nb_iter_plot`` solver iterations (iteration-limited warm-started
    chunks); returns the final x.  Raises ImportError when the vendored
    module is unavailable (caller falls back to the wrapper path)."""
    core = _core()
    start = time.perf_counter() if start_time is None else start_time
    solver = _SOLVER_MAP[method]

    h = core._Highs()
    h.setOptionValue("output_flag", False)
    # presolve off: iteration-limited chunks must expose the running
    # iterate (presolve+postsolve only materializes x at optimality)
    h.setOptionValue("presolve", "off")
    h.setOptionValue("solver", solver)
    if h.passModel(build_highs_model(lp)) != core.HighsStatus.kOk:
        raise RuntimeError("HiGHS rejected the model")

    limit_opt = ("simplex_iteration_limit" if solver == "simplex"
                 else "ipm_iteration_limit")
    # iteration-limit semantics differ per solver: simplex WARM-STARTS
    # across run() calls (per-run limit and count — iterations resume from
    # the held basis), while IPM restarts from scratch (the limit must grow
    # and the per-run count IS the cumulative count)
    warm = solver == "simplex"

    def nit_done():
        info = h.getInfo()
        return int(info.simplex_iteration_count if solver == "simplex"
                   else info.ipm_iteration_count)

    def emit(niter):
        x = np.asarray(h.getSolution().col_value, np.float64)
        if x.size != lp.nb_variables or not np.all(np.isfinite(x)):
            return None
        if callback_func is not None:
            obj = float(np.dot(lp.costsvector, x))
            veq, vineq = _violations(lp, x)
            callback_func(niter, x, obj, obj,
                          time.perf_counter() - start, veq, vineq)
        return x

    x = None
    total = 0
    while total < nb_iter:
        if warm:
            limit = min(int(nb_iter_plot), int(nb_iter) - total)
        else:
            limit = min(total + int(nb_iter_plot), int(nb_iter))
        h.setOptionValue(limit_opt, limit)
        h.run()
        status = h.getModelStatus()
        per_run = nit_done()
        # Runtime guard on the vendored counter semantics this loop relies
        # on (verified empirically; a scipy upgrade could flip either):
        # simplex counts must be per-run (a fresh run respects the per-run
        # limit), and the emitted cumulative count must strictly increase
        # while the solver still reports an iteration limit.
        if warm and per_run > limit:
            raise HighsSemanticsError(
                f"simplex_iteration_count {per_run} exceeds the per-run "
                f"limit {limit}: counter semantics flipped to cumulative")
        prev_total = total
        total = total + per_run if warm else max(per_run, total)
        if (status == core.HighsModelStatus.kIterationLimit
                and total <= prev_total and per_run > 0):
            raise HighsSemanticsError(
                "iteration count did not advance across an "
                "iteration-limited run(): counter semantics changed")
        x = emit(total) if callback_func is not None else x
        if status != core.HighsModelStatus.kIterationLimit or per_run == 0:
            break
    if x is None or callback_func is None:
        x = np.asarray(h.getSolution().col_value, np.float64)
    if x.size != lp.nb_variables:
        raise RuntimeError(
            f"HiGHS returned no solution (status {h.getModelStatus()})")
    return x
