"""Row-sharded dual gradient ascent over a :class:`~.mesh.Mesh` (mirrors
``pysparselp_tpu/parallel/sharded_dga.py``).

:func:`~pysparselp_tpu_torch.solvers.dual_ascent.dual_gradient_ascent` on
the row partition of the sharded CP solver
(:func:`~.sharded_cp.build_sharded_cp_data`): the duals and constraint
rows live with their ranks, the primal data is replicated.

* the reduced costs ``c̄ = c + Σ_d A_dᵀ y_d`` and the line-search
  direction ``gᵀA`` (with ``gᵀb`` packed beside it) are each one ``psum``
  of an n-vector;
* the dual gradients ``g = A x − b`` are local (x replicated);
* the exact breakpoint line search over the primal dimension runs
  replicated on every rank (identical inputs, identical step);
* the y ≥ 0 step clamp and the any-negative test reduce in one ``pmin``
  (the test as ``-max``), the equality's any-g test in one ``pmax``; the
  tie draws come from the host key chain, the same on every rank.

An iteration costs at most four n-vector psums (reduced costs and
direction, once per system).  The shards are the CSR of each rank's rows
(H-CSR) or, where the layout chooser lowers every system to DIA, its DIA
planes on H-DIA with shard offsets
(:func:`~.sharded_admm.shard_operator`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.linesearch import exact_dual_line_search
from ..problem import resolve_dtype
from ..solvers.dual_ascent import (_dga_ties, _dual_energy, _optim_x,
                                   _safe_mid)
from ..utils.xla_order import dot
from .mesh import check_mesh
from .sharded_admm import shard_operator
from .sharded_cp import (_local_matvec, _local_rmatvec,
                         build_sharded_cp_data)

# what the last dual_gradient_ascent_sharded call on this process ran
last_run_info: dict | None = None


def sharded_dga_chunk(data, state, mesh, ties):
    """The row-sharded iterations of one chunk, one per ``(t_in, t_eq)``
    of ``ties`` (the host's tie draws); ``state`` is this rank's ``(y_eq,
    y_ineq)``.  Returns ``(state, metrics)``, the metrics replicated."""
    mesh = check_mesh(mesh)
    c, lb, ub, mid = data["c"], data["lb"], data["ub"], data["mid"]
    eq_l, in_l = data.get("eq"), data.get("ineq")
    n = c.shape[0]

    def c_bar_of(y_eq, y_in):
        part = torch.zeros_like(c)
        if eq_l is not None:
            _local_rmatvec(eq_l, y_eq, n, part)
        if in_l is not None:
            _local_rmatvec(in_l, y_in, n, part)
        return c + mesh.psum(part)

    def direction(sys_l, g):
        """``(gᵀA, gᵀb)`` over the ranks, in one psum of n + 1 entries."""
        part = _local_rmatvec(sys_l, g, n, torch.zeros_like(c))
        both = mesh.psum(torch.cat([part, torch.dot(g, sys_l["b"])[None]]))
        return both[:n], both[n]

    y_eq, y_in = state
    for t_in, t_eq in ties:
        c_bar = c_bar_of(y_eq, y_in)
        x = _optim_x(c_bar, lb, ub, mid)

        if in_l is not None:
            g = _local_matvec(in_l, x, n) - in_l["b"]
            g = torch.where(y_in <= 0, torch.clamp_min(g, 0.0), g)
            maxstep = torch.min(torch.where(
                g < 0, y_in / torch.clamp_min(-g, 1e-300), torch.inf))
            neg = -torch.any(g < 0).to(c.dtype)
            maxstep, neg = mesh.pmin(torch.stack([maxstep, neg]))
            da, db = direction(in_l, g)
            coef = exact_dual_line_search(da, db, c_bar, ub, lb, t_in)
            coef = torch.minimum(torch.clamp_min(coef, 0.0), maxstep)
            y_in = torch.where(
                neg < 0, torch.clamp_min(torch.addcmul(y_in, coef, g), 0.0),
                y_in)
            c_bar = c_bar_of(y_eq, y_in)
            x = _optim_x(c_bar, lb, ub, mid)

        if eq_l is not None:
            g_eq = _local_matvec(eq_l, x, n) - eq_l["b"]
            any_g = mesh.pmax(torch.any(g_eq != 0).to(c.dtype)) > 0
            da, db = direction(eq_l, g_eq)
            coef_eq = exact_dual_line_search(da, db, c_bar, ub, lb, t_eq)
            coef_eq = torch.where(torch.isfinite(coef_eq), coef_eq, 0.0)
            y_eq = torch.where(
                any_g, torch.addcmul(y_eq, torch.clamp_min(coef_eq, 0.0),
                                     g_eq), y_eq)

    c_bar = c_bar_of(y_eq, y_in)
    x = _optim_x(c_bar, lb, ub, mid)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    lin, maxes = zero, []
    if eq_l is not None:
        lin = lin - torch.dot(y_eq, eq_l["b"])
        maxes.append(torch.max(torch.abs(_local_matvec(eq_l, x, n)
                                         - eq_l["b"]) * eq_l["row_mask"]))
    if in_l is not None:
        lin = lin - torch.dot(y_in, in_l["b"])
        r = _local_matvec(in_l, x, n) - in_l["b"]
        maxes.append(torch.max(torch.where(in_l["row_mask"] > 0, r,
                                           torch.full_like(r, -torch.inf))))
    lin = mesh.psum(lin)
    maxes = mesh.pmax(torch.stack(maxes))
    metrics = dict(
        x=x, energy=_dual_energy(c_bar, lb, ub, lin), primal=dot(c, x),
        max_violated_equality=maxes[0] if eq_l is not None else zero,
        max_violated_inequality=maxes[-1] if in_l is not None else zero)
    return (y_eq, y_in), metrics


def dual_gradient_ascent_sharded(
    x, lp, mesh, nb_max_iter=1000, callback_func=None, y_eq=None,
    y_ineq=None, max_time=None, nb_iter_plot=1, dtype=None,
    start_time=None, seed=0, stop_tol=None, operator="auto",
):
    """Mesh-parallel dual gradient ascent; the one-device solver's contract
    (returns ``(x, y_eq, y_ineq)`` on every rank).  ``mesh`` decides the
    device; ``operator`` the shard layout (``"auto"``: DIA where the
    chooser lowers every system to DIA, else CSR)."""
    global last_run_info
    from ..solvers.base import (HostLoop, ToleranceStop, chunk_schedule,
                                emit_callback, to_np)
    from ..utils.jax_prng import prng_key

    del x
    mesh = check_mesh(mesh)
    dtype = resolve_dtype(dtype, mesh.device)
    if lp.b_lower is not None and np.asarray(lp.b_lower).size:
        assert np.max(lp.b_lower) == -np.inf, (
            "dual_gradient_ascent needs a one-sided inequality system"
        )
    rng = np.random.RandomState(seed)
    a_eq = (lp.a_equalities.tocsr()
            if lp.a_equalities is not None and lp.a_equalities.shape[0]
            else None)
    a_in = (lp.a_inequalities.tocsr()
            if lp.a_inequalities is not None and lp.a_inequalities.shape[0]
            else None)
    m_eq = a_eq.shape[0] if a_eq is not None else 0
    m_in = a_in.shape[0] if a_in is not None else 0
    # random dual init matching the one-device solver's draw order
    y_eq0 = -rng.rand(m_eq) if y_eq is None else np.asarray(y_eq)
    y_in0 = np.abs(rng.rand(m_in)) if y_ineq is None else np.asarray(y_ineq)
    present = [a for a in (a_eq, a_in) if a is not None]
    ops = {shard_operator(a, operator) for a in present}
    op = "dia" if ops == {"dia"} else "tiles"

    data, cp_state = build_sharded_cp_data(
        np.asarray(lp.costsvector, np.float64), a_eq,
        lp.b_equalities if a_eq is not None else None, a_in,
        lp.b_upper if a_in is not None else None,
        np.asarray(lp.lower_bounds, np.float64),
        np.asarray(lp.upper_bounds, np.float64), mesh,
        dtype=dtype, y_eq0=y_eq0 if m_eq else None,
        y_ineq0=y_in0 if m_in else None, operator=op,
        fused=mesh.device.type == "cpu")
    data["mid"] = _safe_mid(data["lb"], data["ub"])
    empty = data["c"].new_zeros(0)
    state = (cp_state.get("y_eq", empty), cp_state.get("y_ineq", empty))
    last_run_info = dict(operator=op, ranks=mesh.size,
                         rows_loc={k: int(data[k]["b"].shape[0])
                                   for k in ("eq", "ineq") if k in data})
    key = prng_key(seed)

    loop = HostLoop(start_time=start_time, max_time=max_time)
    tstop = ToleranceStop(stop_tol)
    niter = 0
    x_out = np.zeros(lp.nb_variables)
    for nsteps in chunk_schedule(nb_max_iter, nb_iter_plot):
        key, ties = _dga_ties(key, nsteps, bool(m_in), bool(m_eq), dtype)
        state, metrics = sharded_dga_chunk(data, state, mesh, ties)
        niter += nsteps
        x_out = metrics["x"]
        emit_callback(
            callback_func, niter, x_out,
            metrics["primal"], metrics["energy"], lambda: loop.elapsed,
            metrics["max_violated_equality"],
            metrics["max_violated_inequality"],
        )
        if loop.timed_out or tstop.check(
            metrics["energy"], metrics["max_violated_equality"],
            metrics["max_violated_inequality"],
        ):
            break

    def y_host(y, m):
        return to_np(mesh.all_gather(y))[:m] if m else np.zeros(0)

    return to_np(x_out), y_host(state[0], m_eq), y_host(state[1], m_in)
