"""Diagonally-preconditioned Chambolle–Pock primal-dual LP solver, PyTorch
port of ``pysparselp_tpu/solvers/chambolle_pock.py``.

Same algorithm (Pock & Chambolle, ICCV'11; the reference's
``pysparselp/ChambollePockPPD.py:36-346``) and the same options: the opt-in
primal weight ``omega`` and the device-resident restart-to-average
controller (:func:`_cp_chunk_restart_device`), ``stop_tol``,
``force_integer``, warm starts and ``light_metrics``.  A chunk runs on one
of three paths, chosen from the lowered operators (not from the device):

* ``"dia"`` — every present system is a :class:`~..problem.DiaMatrix`:
  :func:`..ops.cp_dia.cp_dia_chunk`, eq+ineq included, which runs the
  tier :func:`..ops.cp_dia.cp_dia_plan` picks from the shapes (H-CPDIA-R,
  one launch a chunk, where the state fits one cluster's shared memory;
  else the two-launch H-CPDIA);
* ``"dense"`` — every present system is a dense operator within the dense
  kernel's budget: the H-CPDENSE kernel (:mod:`..ops.cp_dense`);
* otherwise the per-operator iteration :func:`_cp_iteration`, whose
  products go through each operator's ``matvec``/``rmatvec`` (H-CSR for
  CSR systems and blocks, H-BSR for block-sparse ones, H-DIA for DIA ones,
  plain torch for dense, partition and column-block composites).

On CUDA tensors each kernel wrapper launches its kernel; on CPU tensors it
runs its plain PyTorch twin, so the CPU tests exercise the same branches.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import torch

from ..ops.cp_dense import cp_dense_chunk, cp_dense_eligible
from ..ops.cp_dia import cp_dia_chunk, cp_dia_eligible
from ..problem import (LPProblem, aligned_offset_count, anchor_align,
                       apply_align_embedding, apply_rcm_permutation,
                       choose_layout, lower_systems, lowers_to_dia,
                       rcm_permutation, resolve_device, resolve_dtype)
from ..utils.instrumentation import span
from .base import HostLoop, chunk_schedule, emit_callback, fetch, to_np


def _fold_one_sided(a_ineq, b_lower, b_upper):
    """Fold ``bl <= Ax <= bu`` into ``A'x <= b'`` dropping infinite sides
    (mirrors ``ChambollePockPPD.py:74-88``)."""
    if a_ineq is None:
        return None, None
    a_ineq = scipy.sparse.csr_matrix(a_ineq)
    if b_lower is None:
        return a_ineq, np.asarray(b_upper, np.float64)
    keep_u = np.nonzero(b_upper != np.inf)[0]
    keep_l = np.nonzero(b_lower != -np.inf)[0]
    if keep_u.size and keep_l.size:
        a = scipy.sparse.vstack((a_ineq[keep_u, :], -a_ineq[keep_l, :])).tocsr()
    elif keep_l.size:
        a = (-a_ineq).tocsr()[keep_l, :]
    else:
        a = a_ineq[keep_u, :]
    b = np.concatenate((b_upper[keep_u], -b_lower[keep_l]))
    return a, b


def host_preconditioners(a_eq, a_ineq, alpha=1.0, omega=1.0):
    """Diagonal CP preconditioners from host scipy matrices (the driver's
    formulas, ``ChambollePockPPD.py:122-179``):
    ``T_jj = omega / sum_i |a_ij|^(2-alpha)``,
    ``Sigma_ii = 1 / (omega * sum_j |a_ij|^alpha)`` per system.
    Returns ``(diag_t, sigma_eq, sigma_ineq)`` numpy arrays (sigmas are
    ``None`` for absent systems); the solver computes the same quantities
    on the device with operator ops."""
    n = (a_eq if a_eq is not None else a_ineq).shape[1]
    col_sum = np.zeros(n)
    sigmas = []
    for a in (a_eq, a_ineq):
        if a is None:
            sigmas.append(None)
            continue
        aa = scipy.sparse.csr_matrix(a).copy()
        aa.data = np.abs(aa.data) ** (2.0 - alpha)
        col_sum += np.asarray(aa.sum(axis=0)).ravel()
        ab = scipy.sparse.csr_matrix(a).copy()
        ab.data = np.abs(ab.data) ** alpha
        rs = np.asarray(ab.sum(axis=1)).ravel()
        rs[rs == 0] = 1.0
        sigmas.append(1.0 / (rs * omega))
    col_sum[col_sum == 0] = 1.0
    return omega / col_sum, sigmas[0], sigmas[1]


def _cp_iteration(prob: LPProblem, pre, s):
    """One CP-PPD iteration (primal prox + over-relaxation + dual ascent)."""
    theta = pre["theta"]
    x, x3, y_eq, y_ineq = s
    d = prob.c
    if prob.a_eq is not None:
        d = d + prob.a_eq.rmatvec(y_eq)
    if prob.a_ineq is not None:
        d = d + prob.a_ineq.rmatvec(y_ineq)
    x2 = torch.clamp(x - pre["diag_t"] * d, prob.lb, prob.ub)
    x3 = (1.0 + theta) * x2 - theta * x
    x = x2
    if prob.a_eq is not None:
        r_eq = prob.a_eq.matvec(x3) - prob.b_eq
        y_eq = y_eq + pre["sigma_eq"] * r_eq
    if prob.a_ineq is not None:
        r_ineq = prob.a_ineq.matvec(x3) - prob.b_upper
        y_ineq = torch.clamp_min(y_ineq + pre["sigma_ineq"] * r_ineq, 0.0)
    return (x, x3, y_eq, y_ineq)


def cp_chunk_impl(prob: LPProblem, pre, state, nsteps: int):
    """Run ``nsteps`` per-operator CP-PPD iterations, then evaluate the
    chunk metrics on the device (``ChambollePockPPD.py:242-315``)."""
    for _ in range(nsteps):
        state = _cp_iteration(prob, pre, state)
    x, x3, y_eq, y_ineq = state

    d = prob.c
    if prob.a_eq is not None:
        d = d + prob.a_eq.rmatvec(y_eq)
    if prob.a_ineq is not None:
        d = d + prob.a_ineq.rmatvec(y_ineq)
    # dual-feasible primal minimizer for the lower bound (energy2)
    x4 = torch.where(d < 0, prob.ub, prob.lb)
    energy1 = torch.dot(prob.c, x)
    energy2 = torch.dot(prob.c, x4)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    max_v_eq = zero
    max_v_ineq = zero
    x_rounded = torch.round(x)
    energy_rounded = torch.dot(prob.c, x_rounded)
    rounded_feasible = torch.ones((), dtype=torch.bool, device=x.device)
    if prob.a_eq is not None:
        r_eq = prob.a_eq.matvec(x) - prob.b_eq
        energy1 = energy1 + torch.dot(y_eq, r_eq)
        energy2 = energy2 + torch.dot(y_eq, prob.a_eq.matvec(x4) - prob.b_eq)
        max_v_eq = torch.max(torch.abs(r_eq))
        rounded_feasible = rounded_feasible & (torch.max(
            torch.abs(prob.a_eq.matvec(x_rounded) - prob.b_eq)) == 0)
    if prob.a_ineq is not None:
        r_ineq = prob.a_ineq.matvec(x) - prob.b_upper
        energy1 = energy1 + torch.dot(y_ineq, r_ineq)
        energy2 = energy2 + torch.dot(
            y_ineq, prob.a_ineq.matvec(x4) - prob.b_upper)
        max_v_ineq = torch.max(r_ineq)
        rounded_feasible = rounded_feasible & (torch.max(
            prob.a_ineq.matvec(x_rounded) - prob.b_upper) <= 0)
    metrics = dict(
        energy1=energy1,
        energy2=energy2,
        max_violated_equality=max_v_eq,
        max_violated_inequality=max_v_ineq,
        energy_rounded=energy_rounded,
        rounded_feasible=rounded_feasible,
    )
    return state, metrics


def _tolerance_met(metrics, stop_tol) -> bool:
    """The stop test: the chunk metrics' worst violation and relative gap
    both below ``stop_tol``."""
    e1, e2 = fetch(metrics["energy1"]), fetch(metrics["energy2"])
    gap = abs(e1 - e2) / (1.0 + abs(e1) + abs(e2))
    feas = max(fetch(metrics["max_violated_equality"]),
               fetch(metrics["max_violated_inequality"]))
    return feas < stop_tol and gap < stop_tol


def _scale_pre(pre, omega):
    """Apply the primal weight to the diagonal step sizes (τσ invariant)."""
    out = dict(pre)
    out["diag_t"] = pre["diag_t"] * omega
    if "sigma_eq" in pre:
        out["sigma_eq"] = pre["sigma_eq"] / omega
    if "sigma_ineq" in pre:
        out["sigma_ineq"] = pre["sigma_ineq"] / omega
    return out


_CHUNK_KERNELS = {"dia": cp_dia_chunk, "dense": cp_dense_chunk}


def _fused_chunk(use_fused, prob, pre, state, nsteps, theta_f, with_sums):
    """``nsteps`` iterations through the chunk kernel ``use_fused``;
    returns the new state (and the running sums with ``with_sums``)."""
    x, _x3, y_eq, y_ineq = state
    out = _CHUNK_KERNELS[use_fused](prob, pre, x, y_eq, y_ineq, nsteps,
                                    theta_f, with_sums=with_sums)
    x_n, x3_n, ye_n, yi_n = out[:4]
    new = (x_n, x3_n,
           ye_n if prob.a_eq is not None else y_eq,
           yi_n if prob.a_ineq is not None else y_ineq)
    return (new, out[4:]) if with_sums else new


def pdlp_restart(rs, s_cur, s_avg, candidate):
    """The PDLP restart decision of every CP restart controller (one
    device, row-sharded, position-sharded), as 0-d device tensors: no
    host synchronization.

    ``rs`` holds the controller scalars ``omega`` (the primal weight),
    ``mu_restart`` (the score at the last restart) and ``mu_last`` (the
    last candidate's score); ``s_cur`` and ``s_avg`` are the KKT scores of
    the current point and of the running average.  ``candidate(use_avg)``
    returns ``(z, dx, dy)``: the restart candidate (the average where
    ``use_avg``, else the current point) and its primal and dual movement
    from the last restart point.  Returns ``(do, z, scalars)``, the
    decision, the candidate and the new ``omega``, ``mu_restart`` and
    ``mu_last``."""
    beta_suf, beta_nec = 0.2, 0.8
    mu_c = torch.minimum(s_cur, s_avg)
    do = (mu_c <= beta_suf * rs["mu_restart"]) | (
        (mu_c <= beta_nec * rs["mu_restart"]) & (mu_c > rs["mu_last"])
    )
    z, dx, dy = candidate(s_avg < s_cur)
    valid = (dx > 1e-30) & (dy > 1e-30)
    # ω here is the PRIMAL weight (diag_t scales with ω), so the PDLP
    # movement update uses Δx/Δy: when the primal iterate moves farther
    # than the dual, primal steps should grow
    omega = torch.where(
        do & valid,
        torch.exp(0.5 * torch.log(dx / torch.clamp_min(dy, 1e-30))
                  + 0.5 * torch.log(rs["omega"])),
        rs["omega"],
    )
    return do, z, dict(
        omega=omega,
        mu_restart=torch.where(do, mu_c, rs["mu_restart"]),
        mu_last=torch.where(do, torch.full_like(mu_c, float("inf")), mu_c),
    )


def _cp_chunk_restart_device(prob: LPProblem, pre_base, rstate, nsteps: int,
                             period: int, use_fused=None,
                             theta_f: float = 1.0):
    """Device-resident restart controller: runs ``nsteps`` iterations with a
    PDLP restart check every ``period`` iterations.  Every decision stays a
    0-d device tensor fed to ``torch.where`` — no host synchronization
    inside the chunk.  ``rstate`` carries the solver state plus the
    controller scalars (ω, score at last restart, last candidate score) and
    the last restart point (:func:`pdlp_restart` decides)."""
    nblocks = max(nsteps // period, 0)
    rem = nsteps - nblocks * period

    def run_block(rs):
        state = rs["state"]
        pre = _scale_pre(pre_base, rs["omega"])
        if use_fused is not None:
            state, (sx, se, si) = _fused_chunk(use_fused, prob, pre, state,
                                               period, theta_f, True)
            if prob.a_eq is None:
                se = torch.zeros_like(state[2])
        else:
            sx, se, si = (torch.zeros_like(state[0]),
                          torch.zeros_like(state[2]),
                          torch.zeros_like(state[3]))
            for _ in range(period):
                state = _cp_iteration(prob, pre, state)
                sx, se, si = sx + state[0], se + state[2], si + state[3]
        inv = 1.0 / period
        avg = (sx * inv, se * inv, si * inv)
        s_cur = _kkt_score(prob, state[0], state[2], state[3])
        s_avg = _kkt_score(prob, *avg)

        def candidate(use_avg):
            z = tuple(torch.where(use_avg, a, v)
                      for a, v in zip(avg, (state[0], state[2], state[3])))
            dx = torch.linalg.norm(z[0] - rs["zx"])
            dy = torch.sqrt(torch.sum((z[1] - rs["zeq"]) ** 2)
                            + torch.sum((z[2] - rs["zineq"]) ** 2))
            return z, dx, dy

        do, (zx, zeq, zineq), scalars = pdlp_restart(rs, s_cur, s_avg,
                                                     candidate)
        new_state = (
            torch.where(do, zx, state[0]),
            torch.where(do, zx, state[1]),
            torch.where(do, zeq, state[2]),
            torch.where(do, zineq, state[3]),
        )
        return {
            "state": new_state,
            **scalars,
            "zx": torch.where(do, zx, rs["zx"]),
            "zeq": torch.where(do, zeq, rs["zeq"]),
            "zineq": torch.where(do, zineq, rs["zineq"]),
        }

    for _ in range(nblocks):
        rstate = run_block(rstate)
    if rem:
        pre = _scale_pre(pre_base, rstate["omega"])
        if use_fused is not None:
            state = _fused_chunk(use_fused, prob, pre, rstate["state"], rem,
                                 theta_f, False)
        else:
            state = rstate["state"]
            for _ in range(rem):
                state = _cp_iteration(prob, pre, state)
        rstate = dict(rstate, state=state)
    _, metrics = cp_chunk_impl(prob, _scale_pre(pre_base, rstate["omega"]),
                               rstate["state"], 0)
    return rstate, metrics


def estimate_omega(c, beq=None, b_ineq=None):
    """Primal-weight estimate: ratio of the primal scale (finite nonzero rhs
    magnitudes) to the dual scale (nonzero cost magnitudes)."""
    prim = []
    if beq is not None:
        prim.append(np.abs(np.asarray(beq, np.float64)))
    if b_ineq is not None:
        b = np.asarray(b_ineq, np.float64)
        prim.append(np.abs(b[np.isfinite(b)]))
    prim = np.concatenate(prim) if prim else np.zeros(0)
    prim = prim[prim > 0]
    c = np.asarray(c, np.float64)
    dual = np.abs(c[c != 0])
    if prim.size and dual.size:
        return float(np.clip(np.median(prim) / np.median(dual), 1e-4, 1e4))
    return 1.0


def _kkt_score(prob: LPProblem, x, y_eq, y_ineq):
    """KKT progress metric for restart decisions (PDLP-style): l2 primal
    infeasibility plus the relative duality gap of the box-dual bound."""
    d = prob.c
    primal_obj = torch.dot(prob.c, x)
    dual_obj = torch.zeros((), dtype=x.dtype, device=x.device)
    pviol = torch.zeros((), dtype=x.dtype, device=x.device)
    if prob.a_eq is not None:
        d = d + prob.a_eq.rmatvec(y_eq)
        r = prob.a_eq.matvec(x) - prob.b_eq
        pviol = pviol + torch.sum(r * r)
        dual_obj = dual_obj - torch.dot(y_eq, prob.b_eq)
    if prob.a_ineq is not None:
        d = d + prob.a_ineq.rmatvec(y_ineq)
        r = torch.clamp_min(prob.a_ineq.matvec(x) - prob.b_upper, 0.0)
        pviol = pviol + torch.sum(r * r)
        dual_obj = dual_obj - torch.dot(y_ineq, prob.b_upper)
    # box dual: min over l<=z<=u of d·z (finite for box-bounded variables)
    dual_obj = dual_obj + torch.sum(
        torch.where(d < 0, d * prob.ub, d * prob.lb)
    )
    gap = torch.abs(primal_obj - dual_obj) / (
        1.0 + torch.abs(primal_obj) + torch.abs(dual_obj)
    )
    return torch.sqrt(pviol + gap * gap)


def _auto_layout(mats):
    """``"align"`` plan when the anchor-aligned embedding lowers every
    present system to a DiaMatrix (the grid-LP class; :func:`lowers_to_dia`
    prices each aligned system), else ``None``.

    Alignment exists to feed the DIA kernels; a system it leaves dense-sized
    (netlib SC105: 105 rows become 272) would only be padded."""
    try:
        counts, m_new, n_new, plan = aligned_offset_count(mats,
                                                          return_plan=True)
    except ValueError:
        return None
    if all(lowers_to_dia(mn, n_new, c_, m.nnz)
           for c_, mn, m in zip(counts, m_new, mats) if m is not None):
        return plan
    return None


def _choose_layout(mats, bsr_line_price=None):
    """The layout presolve's choice, ``(choice, align_plan, layouts)``:
    ``"align"`` (with its plan) when :func:`_auto_layout` lowers every
    aligned system to DIA; else ``"rcm"`` when the RCM-permuted systems'
    summed :func:`~..problem.choose_layout` bytes are below the unpermuted
    sum (reverse Cuthill-McKee clusters the nonzeros into dense tiles for
    the block-sparse backend); else ``None``.  ``layouts`` are the
    :func:`~..problem.choose_layout` results of the chosen systems (one per
    system, for :func:`~..problem.lower_systems`; ``None`` after
    ``"align"``).  The port's counterpart of
    ``pysparselp_tpu/solvers/chambolle_pock.py:366-423``, priced by the
    card's chooser (``bsr_line_price`` as
    :func:`~..problem.choose_layout`'s)."""
    plan = _auto_layout(mats)
    if plan is not None:
        return "align", plan, None

    def priced(parts):
        layouts = [(None, None, 0) if p is None
                   else choose_layout(p, bsr_line_price) for p in parts]
        return layouts, sum(lay[2] for lay in layouts)

    unpermuted, cost = priced(mats)
    live = [m for m in mats if m is not None]
    m_e = mats[0].shape[0] if mats[0] is not None else 0
    joint = live[0] if len(live) == 1 else scipy.sparse.vstack(live).tocsr()
    rows, cols = rcm_permutation(joint)
    permuted, cost_rcm = priced([
        None if mats[0] is None else mats[0][rows[rows < m_e], :][:, cols],
        None if mats[1] is None
        else mats[1][rows[rows >= m_e] - m_e, :][:, cols]])
    if cost_rcm < cost:
        return "rcm", None, permuted
    return None, None, unpermuted


def chambolle_pock_ppd(
    c,
    a_eq,
    beq,
    a_ineq,
    b_lower,
    b_upper,
    lb,
    ub,
    x0=None,
    alpha=1.0,
    theta=1.0,
    nb_max_iter=100,
    callback_func=None,
    max_time=None,
    save_problem=False,
    force_integer=False,
    nb_iter_plot=10,
    dtype=None,
    start_time=None,
    restart=None,
    omega=None,
    restart_period=None,
    stop_tol=None,
    permute="auto",
    y_eq0=None,
    y_ineq0=None,
    x30=None,
    light_metrics=False,
    device="cuda",
):
    """Solve the LP with preconditioned CP-PPD; returns ``(x, best_integer_solution)``.

    Signature-compatible with the JAX solver plus ``device``; see
    ``pysparselp_tpu/solvers/chambolle_pock.py::chambolle_pock_ppd`` for
    ``omega``, ``restart="average"`` and the full-state resume arguments.

    Layout presolve: ``permute="auto"`` on CUDA applies what
    :func:`_choose_layout` picks (the anchor-aligned embedding when it
    lowers every system to DIA, else the RCM permutation when it streams
    fewer bytes, else nothing), and nothing on the CPU (as the JAX package
    off-TPU); ``"align"`` and ``"rcm"`` (or ``True``) force one on any
    device.  Callbacks and the returned x are in the original order.
    """
    if restart is not None and omega is None:
        omega = "auto"
    del save_problem  # repro dumps are handled by utils.save_arguments
    with span("presolve.layout"):
        dev = resolve_device(device)
        dtype = resolve_dtype(dtype, dev)
        c = np.asarray(c, np.float64)
        n = c.size

        if a_eq is not None and a_eq.shape[0] == 0:
            a_eq, beq = None, None
        a_one, b_ineq = _fold_one_sided(a_ineq, b_lower, b_upper)
        if a_one is not None and a_one.shape[0] == 0:
            a_one, b_ineq = None, None

        lb = np.asarray(lb, np.float64)
        ub = np.asarray(ub, np.float64)

        # The primal-weight estimate uses the ORIGINAL rhs (the aligned
        # embedding pads b with a large sentinel that must not enter medians).
        if omega == "auto":
            omega = estimate_omega(c, beq if a_eq is not None else None,
                                   b_ineq if a_one is not None else None)
        if permute == "auto" and dev.type != "cuda":
            permute = False
        if permute is True:
            permute = "rcm"
        if permute not in (False, None, "auto", "align", "rcm"):
            raise ValueError(f"permute={permute!r}: use 'auto', 'align', "
                             "'rcm', True or False")
        inv_cols = None          # orig col -> solved position (gather for x)
        pos_eq = pos_in = None   # orig row -> solved position (per system)
        layouts = None           # the presolve's priced layouts, reused below
        if permute and (a_eq is not None or a_one is not None):
            mats = [a_eq, a_one]
            choice, plan, layouts = ((permute, None, None) if permute != "auto"
                                     else _choose_layout(mats))
            col_pos = None
            sys = dict(a_eq=a_eq, beq=beq, a_ineq=a_one, b_ineq=b_ineq,
                       c=c, lb=lb, ub=ub, x0=x0, x30=x30,
                       y_eq0=y_eq0, y_ineq0=y_ineq0)
            if choice == "align":
                sys, pos_eq, pos_in, col_pos = apply_align_embedding(
                    plan if plan is not None else anchor_align(mats), sys)
            elif choice == "rcm":
                sys, pos_eq, pos_in, col_pos = apply_rcm_permutation(sys)
            if col_pos is not None:
                a_eq, beq = sys["a_eq"], sys["beq"]
                a_one, b_ineq = sys["a_ineq"], sys["b_ineq"]
                c, lb, ub = sys["c"], sys["lb"], sys["ub"]
                x0, x30 = sys["x0"], sys["x30"]
                y_eq0, y_ineq0 = sys["y_eq0"], sys["y_ineq0"]
                # x_orig[j] = x_solved[col_pos[j]]
                inv_cols = col_pos
                n = c.size
                if callback_func is not None:
                    user_cb = callback_func

                    if getattr(user_cb, "wants_solution", True):
                        def callback_func(niter, xp, *rest, **kw):
                            user_cb(niter, to_np(xp)[inv_cols], *rest, **kw)
                    else:
                        # light-metrics recorder: never touches the
                        # solution — skip the per-checkpoint device fetch
                        # + unpermute
                        def callback_func(niter, xp, *rest, **kw):
                            user_cb(niter, xp, *rest, **kw)

                    callback_func.wants_state = getattr(user_cb, "wants_state",
                                                        False)
                    callback_func.wants_solution = getattr(
                        user_cb, "wants_solution", True)

    if a_eq is None and a_one is None:
        # unconstrained: minimize cᵀx over the box (``ChambollePockPPD.py:147-151``)
        x = np.zeros_like(lb)
        x[c > 0] = lb[c > 0]
        x[c < 0] = ub[c < 0]
        return x, None

    with span("presolve.lower"):
        def vec(v):
            return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                                   device=dev)

        eq_m, in_m = lower_systems([a_eq, a_one], dtype, dev, layouts=layouts)
        prob = LPProblem(
            c=vec(c),
            lb=vec(lb),
            ub=vec(ub),
            a_eq=eq_m,
            b_eq=vec(beq) if a_eq is not None else None,
            a_ineq=in_m,
            b_lower=None,
            b_upper=vec(b_ineq) if in_m is not None else None,
            n=n,
            m_eq=eq_m.nrows if eq_m is not None else 0,
            m_ineq=in_m.nrows if in_m is not None else 0,
        )

        # diagonal preconditioners (``ChambollePockPPD.py:122-179``):
        #   T_jj = 1 / sum_i |a_ij|^{2-alpha},
        #   Σ_ii = 1 / sum_j |a_ij|^{alpha}
        # (omega="auto" was resolved before the layout presolve)
        omega = float(omega) if omega is not None else 1.0

        col_sum = torch.zeros(n, dtype=dtype, device=dev)
        if eq_m is not None:
            col_sum = col_sum + eq_m.abs_power_colsum(2.0 - alpha)
        if in_m is not None:
            col_sum = col_sum + in_m.abs_power_colsum(2.0 - alpha)
        diag_t = 1.0 / torch.where(col_sum == 0, 1.0, col_sum)
        pre = dict(diag_t=diag_t,
                   theta=torch.tensor(theta, dtype=dtype, device=dev))
        if eq_m is not None:
            rs = eq_m.abs_power_rowsum(alpha)
            pre["sigma_eq"] = 1.0 / torch.where(rs == 0, 1.0, rs)
        if in_m is not None:
            rs = in_m.abs_power_rowsum(alpha)
            pre["sigma_ineq"] = 1.0 / torch.where(rs == 0, 1.0, rs)
        pre_eff = _scale_pre(pre, omega) if omega != 1.0 else pre

        x = vec(x0 if x0 is not None else np.zeros(n))
        ye0 = np.zeros(prob.m_eq) if y_eq0 is None else np.asarray(y_eq0)
        yi0 = np.zeros(prob.m_ineq) if y_ineq0 is None else np.asarray(y_ineq0)
        empty = torch.zeros(0, dtype=dtype, device=dev)
        state = (
            x,
            vec(x30) if x30 is not None else x,
            vec(ye0) if eq_m is not None else empty,
            vec(yi0) if in_m is not None else empty,
        )

        # device-resident PDLP restart controller state (restart="average"):
        # seeded with the KKT score of the initial point; checks run on device
        # every restart_period iterations with no host synchronization
        rstate = None
        if restart == "average":
            if restart_period is not None and restart_period > nb_iter_plot:
                import warnings

                warnings.warn(
                    f"restart_period={restart_period} exceeds the metrics "
                    f"chunk size nb_iter_plot={nb_iter_plot}; restart checks "
                    "run at chunk boundaries, so the effective period is "
                    "clamped to nb_iter_plot. Raise nb_iter_plot to check "
                    "less often.",
                    stacklevel=2,
                )
            period = int(min(restart_period or nb_iter_plot, nb_iter_plot))
            rstate = {
                "state": state,
                "omega": torch.tensor(omega, dtype=dtype, device=dev),
                "mu_restart": _kkt_score(prob, state[0], state[2], state[3]),
                "mu_last": torch.tensor(np.inf, dtype=dtype, device=dev),
                "zx": state[0],
                "zeq": state[2],
                "zineq": state[3],
            }

        # whole-iteration chunk kernels, chosen from the operators
        if cp_dia_eligible(prob):
            use_fused = "dia"
        elif cp_dense_eligible(prob):
            use_fused = "dense"
        else:
            use_fused = None

    def _callback_state():
        """Full solver state in original (un-permuted) coordinates."""
        sx, sx3, sye, syi = (to_np(v) for v in state)
        if inv_cols is not None:
            sx, sx3 = sx[inv_cols], sx3[inv_cols]
            if pos_eq is not None and sye.size:
                sye = sye[pos_eq]
            if pos_in is not None and syi.size:
                syi = syi[pos_in]
        return {"x": sx, "x3": sx3, "y_eq": sye, "y_ineq": syi}

    loop = HostLoop(start_time=start_time, max_time=max_time)
    best_integer_solution = None
    best_integer_energy = np.inf
    niter = 0
    for nsteps in chunk_schedule(nb_max_iter, nb_iter_plot):
        with span("cp.chunk"):
            if restart == "average":
                rstate, metrics = _cp_chunk_restart_device(
                    prob, pre, rstate, nsteps, period,
                    use_fused=use_fused, theta_f=float(theta),
                )
                state = rstate["state"]
            elif use_fused:
                state = _fused_chunk(use_fused, prob, pre_eff, state, nsteps,
                                     float(theta), False)
                _, metrics = cp_chunk_impl(prob, pre_eff, state, 0)
            else:
                state, metrics = cp_chunk_impl(prob, pre_eff, state, nsteps)
        niter += nsteps
        with span("cp.checkpoint"):
            if force_integer and fetch(metrics["rounded_feasible"], bool):
                er = fetch(metrics["energy_rounded"])
                if er < best_integer_energy:
                    best_integer_energy = er
                    best_integer_solution = np.round(to_np(state[0]))
            emit_callback(
                callback_func,
                niter,
                state[0],
                metrics["energy1"],
                metrics["energy2"],
                lambda: loop.elapsed,
                metrics["max_violated_equality"],
                metrics["max_violated_inequality"],
                state=(
                    _callback_state()
                    if getattr(callback_func, "wants_state", False)
                    else None
                ),
                light=light_metrics,
            )
            stop = loop.timed_out or (
                stop_tol is not None and _tolerance_met(metrics, stop_tol))
        if stop:
            break

    with span("postsolve"):
        x_final = to_np(state[0])
        if inv_cols is not None:
            x_final = x_final[inv_cols]
            if best_integer_solution is not None:
                best_integer_solution = best_integer_solution[inv_cols]
        return x_final, best_integer_solution
