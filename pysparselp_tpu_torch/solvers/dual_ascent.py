"""Dual gradient ascent and dual coordinate ascent, PyTorch port of
``pysparselp_tpu/solvers/dual_ascent.py``.

* ``dual_gradient_ascent`` — full-gradient ascent on the LP dual with exact
  line search along the gradient (reference
  ``pysparselp/DualGradientAscent.py:68-245``).  An iteration is the
  products of the lowered operators (H-DIA, H-CSR or H-BSR on the card,
  whichever ``problem.ell_from_scipy`` picks; on the CPU a
  :class:`~pysparselp_tpu_torch.problem.CsrMatrix` rounded as the JAX
  package's products round there) and two exact line searches
  over all n reduced costs (``ops/linesearch.py``), launched without a host
  synchronisation until the chunk's metrics are read.

* ``dual_coordinate_ascent`` — exact per-constraint coordinate maximization
  (reference ``pysparselp/DualCoordinateAscent.py:39-367``).  A sweep over a
  system's rows is one H-DCA sweep (``ops/dca_sweep.py``: the key chain,
  the draws, then the rows level by level on the level schedule built once
  with the row view at set-up), in the sequential mode, or one H-DCA-C
  launch for every colour group (on a colour plan built at set-up) in the
  blocked mode; the
  metrics use the :class:`~pysparselp_tpu_torch.problem.CsrMatrix` products
  (H-CSR; on the CPU their twin rounds each row as a fused multiply-add
  chain, as the JAX package's products round there), and the sweeps walk
  the padded row view
  (:class:`~pysparselp_tpu_torch.ops.dca_sweep.EllRows`) kept beside them.
  Greedy integer rounding hooks in on the host between sweeps, exactly
  where the reference calls it (``DualCoordinateAscent.py:287-294``).

The random draws are ``jax.random``'s, bit for bit
(:mod:`~pysparselp_tpu_torch.utils.jax_prng`): the key chain runs on the
host, a draw of n ties on the device, and the sequential sweep's per-row
draws inside H-DCA, which hands the key back.  ``mesh=`` (a
:class:`~pysparselp_tpu_torch.parallel.mesh.Mesh`) runs DGA row-sharded
(:mod:`~pysparselp_tpu_torch.parallel.sharded_dga`) and DCA in the blocked
mode with each colour group split over the ranks
(:mod:`~pysparselp_tpu_torch.parallel.sharded_dca`); the mesh decides the
device.
"""

from __future__ import annotations

import copy

import numpy as np
import scipy.sparse
import torch

from ..ops.dca_sweep import ColorPlan, EllRows, dca_color_sweep, dca_sweep
from ..ops.linesearch import exact_dual_line_search
from ..problem import (CsrMatrix, ell_from_scipy, resolve_device,
                       resolve_dtype)
from ..utils.jax_prng import prng_key, split, uniform, uniform_scalar
from ..utils.xla_order import dot, total
from .base import HostLoop, ToleranceStop, chunk_schedule, emit_callback, to_np

# ----------------------------------------------------------------------
# shared dual-LP pieces
# ----------------------------------------------------------------------


def _optim_x(c_bar, lb, ub, tie_mid):
    """Primal minimizer of the Lagrangian at fixed duals
    (``DualGradientAscent.py:106-119``): lb where c̄>0, ub where c̄<0,
    ``tie_mid`` where c̄==0."""
    return torch.where(c_bar > 0, lb, torch.where(c_bar < 0, ub, tie_mid))


def _safe_mid(lb, ub):
    """0.5(lb+ub) with inf-aware fallbacks (``DualCoordinateAscent.py:104-117``)."""
    mid = 0.5 * (lb + ub)
    inf_l, inf_u = torch.isinf(lb), torch.isinf(ub)
    mid = torch.where(inf_l & ~inf_u, ub, mid)
    mid = torch.where(~inf_l & inf_u, lb, mid)
    return torch.where(inf_l & inf_u, torch.zeros_like(mid), mid)


def _dual_energy(c_bar, lb, ub, lin_term):
    """Dual objective: Σ_k min(c̄_k l_k, c̄_k u_k) − yᵀb  (``DualGradientAscent.py:121-133``)."""
    contrib = torch.where(c_bar > 0, c_bar * lb,
                          torch.where(c_bar < 0, c_bar * ub, 0.0))
    return total(contrib) + lin_term


def _vec(v, dtype, device):
    return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                           device=device)


# ----------------------------------------------------------------------
# dual gradient ascent
# ----------------------------------------------------------------------


def _dga_ties(key, nsteps, has_ineq, has_eq, dtype):
    """The chunk's tie draws, per iteration ``(ineq, eq)`` (None where the
    system is absent), and the key after them: the JAX loop's split and
    scalar draw per line search, on the host."""
    ties = []
    for _ in range(nsteps):
        t_in = t_eq = None
        if has_ineq:
            key, sub = split(key)
            t_in = uniform_scalar(sub, dtype)
        if has_eq:
            key, sub = split(key)
            t_eq = uniform_scalar(sub, dtype)
        ties.append((t_in, t_eq))
    return key, ties


def _reduced_costs(data, y_eq, y_ineq):
    c_bar = data["c"]
    if data.get("a_eq") is not None:
        c_bar = c_bar + data["a_eq"].rmatvec(y_eq)
    if data.get("a_ineq") is not None:
        c_bar = c_bar + data["a_ineq"].rmatvec(y_ineq)
    return c_bar


def _dga_operator(a, dtype, device):
    """The chooser's operator on the card (H-DIA, H-CSR or H-BSR); on the
    CPU a :class:`CsrMatrix` whose twin rounds its rows as the JAX
    package's products do on the CPU (fused multiply-add chains), so that
    the exact comparisons of the reduced costs (``c̄ > 0``, ``c̄ == 0``)
    decide as in JAX."""
    if device.type == "cpu":
        return CsrMatrix.from_scipy(a, dtype, device, fused=True)
    return ell_from_scipy(a, dtype, device)


def _dga_chunk(data, state, ties):
    c, lb, ub, mid = data["c"], data["lb"], data["ub"], data["mid"]
    a_eq, b_eq = data.get("a_eq"), data.get("b_eq")
    a_in, b_in = data.get("a_ineq"), data.get("b_upper")

    y_eq, y_ineq = state
    for t_in, t_eq in ties:
        c_bar = _reduced_costs(data, y_eq, y_ineq)
        x = _optim_x(c_bar, lb, ub, mid)

        if a_in is not None:
            g = a_in.matvec(x) - b_in
            g = torch.where(y_ineq <= 0, torch.clamp_min(g, 0.0), g)
            has_neg = torch.any(g < 0)
            coef = exact_dual_line_search(
                a_in.rmatvec(g), torch.dot(g, b_in), c_bar, ub, lb, t_in)
            maxstep = torch.min(torch.where(
                g < 0, y_ineq / torch.clamp_min(-g, 1e-300), torch.inf))
            coef = torch.minimum(torch.clamp_min(coef, 0.0), maxstep)
            # y + coef g as one fused multiply-add on the CPU, as XLA
            # contracts it there
            y_ineq = torch.where(
                has_neg, torch.clamp_min(torch.addcmul(y_ineq, coef, g), 0.0),
                y_ineq)
            # refresh reduced costs after the inequality step
            c_bar = c + a_in.rmatvec(y_ineq)
            if a_eq is not None:
                c_bar = c_bar + a_eq.rmatvec(y_eq)
            x = _optim_x(c_bar, lb, ub, mid)

        if a_eq is not None:
            g_eq = a_eq.matvec(x) - b_eq
            any_g = torch.any(g_eq != 0)
            coef_eq = exact_dual_line_search(
                a_eq.rmatvec(g_eq), torch.dot(g_eq, b_eq), c_bar, ub, lb,
                t_eq)
            coef_eq = torch.where(torch.isfinite(coef_eq), coef_eq, 0.0)
            y_eq = torch.where(
                any_g, torch.addcmul(y_eq, torch.clamp_min(coef_eq, 0.0),
                                     g_eq), y_eq)

    state = (y_eq, y_ineq)
    c_bar = c
    lin = torch.zeros((), dtype=c.dtype, device=c.device)
    if a_eq is not None:
        c_bar = c_bar + a_eq.rmatvec(y_eq)
        lin = lin - dot(y_eq, b_eq)
    if a_in is not None:
        c_bar = c_bar + a_in.rmatvec(y_ineq)
        lin = lin - dot(y_ineq, b_in)
    x = _optim_x(c_bar, lb, ub, mid)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    metrics = dict(
        x=x,
        energy=_dual_energy(c_bar, lb, ub, lin),
        primal=dot(c, x),
        max_violated_equality=(torch.max(torch.abs(a_eq.matvec(x) - b_eq))
                               if a_eq is not None else zero),
        max_violated_inequality=(torch.max(a_in.matvec(x) - b_in)
                                 if a_in is not None else zero),
    )
    return state, metrics


def dual_gradient_ascent(
    x,
    lp,
    nb_max_iter=1000,
    callback_func=None,
    y_eq=None,
    y_ineq=None,
    max_time=None,
    nb_iter_plot=1,
    dtype=None,
    start_time=None,
    seed=0,
    stop_tol=None,
    mesh=None,
    device="cuda",
):
    """Gradient ascent in the dual with exact line search; returns ``(x,
    y_eq, y_ineq)``.  Signature parity with ``DualGradientAscent.py:68``
    (plus ``device``); ``mesh`` runs it row-sharded
    (:func:`~pysparselp_tpu_torch.parallel.sharded_dga.
    dual_gradient_ascent_sharded`, on the mesh's device)."""
    if mesh is not None:
        from ..parallel.sharded_dga import dual_gradient_ascent_sharded

        return dual_gradient_ascent_sharded(
            x, lp, mesh, nb_max_iter=nb_max_iter,
            callback_func=callback_func, y_eq=y_eq, y_ineq=y_ineq,
            max_time=max_time, nb_iter_plot=nb_iter_plot, dtype=dtype,
            start_time=start_time, seed=seed, stop_tol=stop_tol)
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype, dev)
    if lp.b_lower is not None and np.asarray(lp.b_lower).size:
        assert np.max(lp.b_lower) == -np.inf, (
            "dual_gradient_ascent needs a one-sided inequality system"
        )

    data = dict(c=_vec(lp.costsvector, dtype, dev),
                lb=_vec(lp.lower_bounds, dtype, dev),
                ub=_vec(lp.upper_bounds, dtype, dev))
    data["mid"] = _safe_mid(data["lb"], data["ub"])
    rng = np.random.RandomState(seed)
    m_eq = lp.a_equalities.shape[0] if lp.a_equalities is not None else 0
    m_in = lp.a_inequalities.shape[0] if lp.a_inequalities is not None else 0
    if m_eq:
        data["a_eq"] = _dga_operator(lp.a_equalities.tocsr(), dtype, dev)
        data["b_eq"] = _vec(lp.b_equalities, dtype, dev)
    if m_in:
        data["a_ineq"] = _dga_operator(lp.a_inequalities.tocsr(), dtype, dev)
        data["b_upper"] = _vec(lp.b_upper, dtype, dev)

    # random dual init, matching the reference's choice (DualGradientAscent.py:92-101)
    y_eq0 = _vec(-rng.rand(m_eq) if y_eq is None else y_eq, dtype, dev)
    y_in0 = _vec(np.abs(rng.rand(m_in)) if y_ineq is None else y_ineq, dtype,
                 dev)
    state = (y_eq0, y_in0)
    key = prng_key(seed)

    loop = HostLoop(start_time=start_time, max_time=max_time)
    tstop = ToleranceStop(stop_tol)
    niter = 0
    x_out = np.zeros(lp.nb_variables)
    for nsteps in chunk_schedule(nb_max_iter, nb_iter_plot):
        key, ties = _dga_ties(key, nsteps, bool(m_in), bool(m_eq), dtype)
        state, metrics = _dga_chunk(data, state, ties)
        niter += nsteps
        x_out = metrics["x"]
        emit_callback(
            callback_func, niter, x_out,
            metrics["primal"], metrics["energy"], lambda: loop.elapsed,
            metrics["max_violated_equality"], metrics["max_violated_inequality"],
        )
        if loop.timed_out or tstop.check(
            metrics["energy"], metrics["max_violated_equality"],
            metrics["max_violated_inequality"],
        ):
            break
    return to_np(x_out), to_np(state[0]), to_np(state[1])


# ----------------------------------------------------------------------
# dual coordinate ascent
# ----------------------------------------------------------------------


def _color_rows(csr):
    """Greedy graph coloring of constraint rows by shared columns.

    Rows with pairwise-disjoint column support get the same color and can
    take their exact coordinate steps simultaneously (the step of row i only
    reads/writes c̄ on i's own columns).  Returns a list of row-index arrays,
    one per color.  Colors ≈ max column degree, so on large structured LPs
    a sweep shrinks from m sequential steps to a handful of batched ones.
    """
    csr = scipy.sparse.csr_matrix(csr)
    m, n = csr.shape
    indptr, indices = csr.indptr, csr.indices
    cnt = np.diff(indptr)
    row_of = np.repeat(np.arange(m), cnt)
    # vectorized maximal-independent-set coloring (O(colors * nnz) numpy;
    # a per-row python loop here cost minutes at the million-row scales
    # this mode exists for).  Per color: every column is claimed by the
    # smallest candidate row touching it, rows winning ALL their columns
    # join the color (pairwise disjoint by construction), and the inner
    # loop repeats on the still-compatible rows until the color is a
    # MAXIMAL independent set — without the saturation pass the group
    # count balloons ~6x (Potts-30: 62 colors instead of 10).
    remaining = np.ones(m, bool)
    groups = []
    while remaining.any():
        col_taken = np.zeros(n, bool)
        in_color = np.zeros(m, bool)
        cand = remaining.copy()
        while cand.any():
            keep = cand[row_of]
            claim = np.full(n, m, np.int64)
            np.minimum.at(claim, indices[keep], row_of[keep])
            wins = np.ones(m, bool)
            np.logical_and.at(wins, row_of[keep],
                              claim[indices[keep]] == row_of[keep])
            sel = cand & wins
            if not sel.any():
                break
            in_color |= sel
            col_taken[indices[sel[row_of]]] = True
            blocked = np.zeros(m, bool)
            np.logical_or.at(blocked, row_of, col_taken[indices])
            cand = remaining & ~in_color & ~blocked
        groups.append(np.nonzero(in_color)[0])
        remaining &= ~in_color
    return groups


def _dca_color_sweep(ell, b, active, y, c_bar, lb, ub, key, plan, project):
    """Blocked sweep: every colour group of ``plan`` (a
    :class:`~pysparselp_tpu_torch.ops.dca_sweep.ColorPlan`) in one H-DCA-C
    launch, each group with its own split of the key; groups chain through
    c̄ like the sequential sweep chains through rows."""
    return dca_color_sweep(ell, plan, b, active, y, c_bar, lb, ub, key,
                           project)


def _sweep(data, which, active, y, c_bar, key):
    ell, b = data[f"ell_{which}"], data[f"b_{which}"]
    lb, ub, project = data["lb"], data["ub"], which == "ineq"
    groups = data.get(f"{which}_groups")
    if groups is not None:
        from ..parallel.sharded_dca import sharded_color_sweep

        return sharded_color_sweep(ell, b, active, y, c_bar, lb, ub, key,
                                   groups, project, data["mesh"])
    plan = data.get(f"{which}_plan")
    if plan is not None:
        return _dca_color_sweep(ell, b, active, y, c_bar, lb, ub, key, plan,
                                project)
    return dca_sweep(ell, b, active, y, c_bar, lb, ub, key, project)


def _tie_point(data, key):
    """``lb + uniform(sub, (n,)) * clip(ub - lb, 0, 1e30)``: the random
    primal point where c̄ == 0, after one split of the key."""
    lb, ub = data["lb"], data["ub"]
    key, sub = split(key)
    tie = uniform(sub, lb.shape, lb.dtype, lb.device)
    return key, torch.addcmul(lb, tie, torch.clamp(ub - lb, 0, 1e30))


def _dca_reduced_costs(data, y_eq, y_ineq, ineq_first=False):
    """``c + A_eqᵀ y_eq + A_inᵀ y_in`` (the inequality term first when
    ``ineq_first``), each product added as the JAX package's products
    round on the CPU (``CsrMatrix.rmatvec_plus``)."""
    terms = [("a_eq", y_eq), ("a_ineq", y_ineq)]
    c_bar = data["c"]
    for name, y in (terms[::-1] if ineq_first else terms):
        if data.get(name) is not None:
            c_bar = data[name].rmatvec_plus(y, c_bar)
    return c_bar


def _dca_outer(data, y_eq, y_ineq, key):
    """One outer DCA iteration: the equality sweep then the inequality
    sweep."""
    c, lb, ub = data["c"], data["lb"], data["ub"]
    a_eq, b_eq = data.get("a_eq"), data.get("b_eq")
    a_in, b_in = data.get("a_ineq"), data.get("b_ineq")
    mid = data["mid"]

    c_bar = _dca_reduced_costs(data, y_eq, y_ineq)
    if a_eq is not None:
        key, tie_mid = _tie_point(data, key)
        x = _optim_x(c_bar, lb, ub, tie_mid)
        active = a_eq.matvec_plus(x, -b_eq) != 0
        y_eq, c_bar, key = _sweep(data, "eq", active, y_eq, c_bar, key)
        # rebuild c_bar exactly to avoid incremental drift
        c_bar = _dca_reduced_costs(data, y_eq, y_ineq)

    if a_in is not None:
        key, tie_mid = _tie_point(data, key)
        x = _optim_x(c_bar, lb, ub, tie_mid)
        g = a_in.matvec_plus(x, -b_in)
        g = torch.where(y_ineq <= 0, torch.clamp_min(g, 0.0), g)
        y_ineq, c_bar, key = _sweep(data, "ineq", g != 0, y_ineq, c_bar, key)
        c_bar = _dca_reduced_costs(data, y_eq, y_ineq, ineq_first=True)

    # final primal guess with centered ties + cost-sign nudge
    # (``DualCoordinateAscent.py:281-286``)
    x = _optim_x(c_bar, lb, ub, mid)
    x = torch.where(c_bar == 0, mid + 0.1 * torch.sign(c), x)
    lin = torch.zeros((), dtype=c.dtype, device=c.device)
    zero = lin
    if a_eq is not None:
        lin = lin - dot(y_eq, b_eq)
    if a_in is not None:
        lin = lin - dot(y_ineq, b_in)
    metrics = dict(
        x=x, c_bar=c_bar, energy=_dual_energy(c_bar, lb, ub, lin),
        primal=dot(c, x),
        max_violated_equality=(torch.max(torch.abs(a_eq.matvec_plus(
            x, -b_eq))) if a_eq is not None else zero),
        max_violated_inequality=(torch.max(a_in.matvec_plus(x, -b_in))
                                 if a_in is not None else zero),
    )
    return y_eq, y_ineq, key, metrics


def _done(metrics, prev_energy):
    """The reference's stop condition (``DualCoordinateAscent.py:318-330``)
    as a 0-d device flag: dual stalled AND primal feasible."""
    stalled = metrics["energy"] < prev_energy + 1e-10
    feas = (metrics["max_violated_inequality"] <= 0) & (
        metrics["max_violated_equality"] == 0)
    return stalled & feas


def _dca_chunk(data, y_eq, y_ineq, key, prev_energy, nsweeps: int):
    """Up to ``nsweeps`` outer iterations, leaving after the first one whose
    stop flag is set: the flag is computed on the device and read once a
    sweep (the sweep's key comes back to the host then anyway), so no sweep
    runs past the exit.  Used when ``use_greedy_round=False`` or there are
    no inequalities (no host hook between sweeps)."""
    i = 0
    while True:
        y_eq, y_ineq, key, metrics = _dca_outer(data, y_eq, y_ineq, key)
        i += 1
        done = bool(_done(metrics, prev_energy))
        prev_energy = metrics["energy"]
        if done or i >= nsweeps:
            return y_eq, y_ineq, key, i, done, metrics


def dca_setup(lp2, dtype, dev, mode, mesh=None):
    """The device data of the coordinate ascent on the one-sided LP
    ``lp2``: the costs, bounds and tie midpoints, and per present system
    its :class:`CsrMatrix` (``a_*``), its row view (``ell_*``), ``b_*`` and,
    in the blocked mode, its colour groups: on one device their
    :class:`~pysparselp_tpu_torch.ops.dca_sweep.ColorPlan` (``*_plan``),
    with ``mesh`` each group's split over the ranks (``*_groups``,
    :func:`~pysparselp_tpu_torch.parallel.sharded_dca.shard_groups`)."""
    data = dict(c=_vec(lp2.costsvector, dtype, dev),
                lb=_vec(lp2.lower_bounds, dtype, dev),
                ub=_vec(lp2.upper_bounds, dtype, dev))
    data["mid"] = _safe_mid(data["lb"], data["ub"])
    if mode not in ("sequential", "blocked"):
        raise ValueError(f"unknown DCA mode {mode!r}")
    if mesh is not None:
        from ..parallel.sharded_dca import shard_groups

        data["mesh"] = mesh
    for which, a, b in (("eq", lp2.a_equalities, lp2.b_equalities),
                        ("ineq", lp2.a_inequalities, lp2.b_upper)):
        if a is None or not a.shape[0]:
            continue
        a = a.tocsr()
        data[f"a_{which}"] = CsrMatrix.from_scipy(a, dtype, dev, fused=True)
        data[f"ell_{which}"] = EllRows.from_scipy(a, dtype, dev)
        data[f"b_{which}"] = _vec(b, dtype, dev)
        if mode == "blocked":
            groups = _color_rows(a)
            if mesh is not None:
                data[f"{which}_groups"] = shard_groups(groups, a, mesh)
            else:
                data[f"{which}_plan"] = ColorPlan.build(
                    data[f"ell_{which}"], groups, data[f"b_{which}"],
                    data["lb"], data["ub"])
    return data


def dca_run(data, lp2, nb_max_iter, callback_func, y_eq, y_ineq, max_time,
            nb_iter_plot, start_time, seed, use_greedy_round):
    """The outer loop of the coordinate ascent on :func:`dca_setup`'s
    ``data``; returns ``(x, y_eq, y_ineq)``."""
    dtype, dev = data["c"].dtype, data["c"].device
    m_eq = lp2.a_equalities.shape[0] if lp2.a_equalities is not None else 0
    m_in = lp2.a_inequalities.shape[0] if lp2.a_inequalities is not None else 0
    y_eq = torch.zeros(m_eq, dtype=dtype, device=dev) if y_eq is None \
        else _vec(y_eq, dtype, dev)
    y_ineq = torch.zeros(m_in, dtype=dtype, device=dev) if y_ineq is None \
        else _vec(y_ineq, dtype, dev)
    assert float(torch.min(y_ineq)) >= 0 if m_in else True
    key = prng_key(seed)

    loop = HostLoop(start_time=start_time, max_time=max_time)
    energy = -np.inf
    x_out = np.zeros(lp2.nb_variables)
    niter = 0
    if not (use_greedy_round and m_in):
        # no per-sweep host hook needed: whole callback periods run with
        # the stall/feasible stop tested on the device
        while niter < nb_max_iter:
            nsweeps = max(1, min(nb_iter_plot, nb_max_iter - niter))
            y_eq, y_ineq, key, did, done, metrics = _dca_chunk(
                data, y_eq, y_ineq, key,
                torch.tensor(energy, dtype=dtype, device=dev), nsweeps)
            niter += did
            energy = float(metrics["energy"])
            x_out = to_np(metrics["x"])
            emit_callback(
                callback_func, niter, x_out,
                float(lp2.costsvector @ x_out), energy,
                lambda: loop.elapsed,
                metrics["max_violated_equality"],
                metrics["max_violated_inequality"],
            )
            if done or loop.timed_out:
                break
        return x_out, to_np(y_eq), to_np(y_ineq)

    while niter < nb_max_iter:
        y_eq, y_ineq, key, metrics = _dca_outer(data, y_eq, y_ineq, key)
        niter += 1
        new_energy = float(metrics["energy"])
        x_out = to_np(metrics["x"])

        stalled = new_energy < energy + 1e-10
        if stalled and use_greedy_round and m_in:
            try:
                from ..integer.rounding import greedy_round

                c_bar = to_np(metrics["c_bar"])
                order = np.argsort(np.abs(x_out - 0.5))
                fixed = c_bar != 0
                xr, valid = greedy_round(
                    x_out, lp2, callback_func=None, maxiter=30,
                    order=order, fixed=fixed,
                )
                if valid:
                    x_out = xr
            except ImportError:
                pass

        if (niter % max(1, nb_iter_plot)) == 0 or niter >= nb_max_iter:
            emit_callback(
                callback_func, niter, x_out,
                float(lp2.costsvector @ x_out), new_energy, lambda: loop.elapsed,
                metrics["max_violated_equality"],
                metrics["max_violated_inequality"],
            )
        if loop.timed_out:
            break
        if stalled and float(metrics["max_violated_inequality"]) <= 0 and (
            float(metrics["max_violated_equality"]) == 0
        ):
            break  # primal feasible and dual stalled: done (DualCoordinateAscent.py:318-330)
        energy = new_energy

    return x_out, to_np(y_eq), to_np(y_ineq)


def dual_coordinate_ascent(
    x,
    lp,
    nb_max_iter=20,
    callback_func=None,
    y_eq=None,
    y_ineq=None,
    max_time=None,
    nb_iter_plot=1,
    dtype=None,
    start_time=None,
    seed=1,
    use_greedy_round=True,
    mode="sequential",
    mesh=None,
    device="cuda",
):
    """Coordinate ascent in the LP dual; returns ``(x, y_eq, y_ineq)``.

    Signature parity with ``DualCoordinateAscent.py:39`` (plus ``device``).
    On dual stall, attempts greedy integer rounding on the host like the
    reference (``DualCoordinateAscent.py:287-294``).  ``mode`` is
    ``"sequential"`` (one H-DCA sweep per system and outer iteration, on
    the row view's level schedule) or
    ``"blocked"`` (graph-coloured: one colour step per group of rows with
    disjoint columns).  ``mesh`` implies the blocked mode and splits each
    colour group over the ranks
    (:func:`~pysparselp_tpu_torch.parallel.sharded_dca.
    dual_coordinate_ascent_sharded`, on the mesh's device; ``mode`` is not
    read).
    """
    if mesh is not None:
        from ..parallel.sharded_dca import dual_coordinate_ascent_sharded

        return dual_coordinate_ascent_sharded(
            x, lp, mesh, nb_max_iter=nb_max_iter,
            callback_func=callback_func, y_eq=y_eq, y_ineq=y_ineq,
            max_time=max_time, nb_iter_plot=nb_iter_plot, dtype=dtype,
            start_time=start_time, seed=seed,
            use_greedy_round=use_greedy_round)
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype, dev)
    lp2 = copy.deepcopy(lp)
    lp2.convert_to_one_sided_inequality_system()
    data = dca_setup(lp2, dtype, dev, mode)
    return dca_run(data, lp2, nb_max_iter, callback_func, y_eq, y_ineq,
                   max_time, nb_iter_plot, start_time, seed,
                   use_greedy_round)
