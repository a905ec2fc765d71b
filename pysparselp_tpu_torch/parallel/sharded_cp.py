"""Row-sharded Chambolle–Pock LP solver over a :class:`~.mesh.Mesh` (mirrors
``pysparselp_tpu/parallel/sharded_cp.py``).

The constraint systems are partitioned by rows across the ranks, the
primal vector ``x`` is replicated, and the dual vectors live with their
rows:

* forward SpMV ``A x₃``: purely local (x replicated), no collective;
* transpose SpMV ``yᵀA``: each rank reduces its rows' contribution into an
  n-vector, then one ``psum`` (``dist.all_reduce``) merges them;
* the primal update runs replicated on every rank (identical inputs give
  identical outputs, no collective);
* the metrics' scalars reduce with ``psum``/``pmax``, packed into one
  all-reduce per operation at each evaluation.

One CP iteration therefore costs exactly one all-reduce of an n-vector.
Float32 solves of anchor-aligned DIA systems go instead to the
position-sharded regime (:mod:`.sharded_cp_windowed`), as in the JAX
package; float64 and every other system stay here.

Shard layouts (``operator``): ``"dia"`` (per-shard diagonal storage on
H-DIA, :mod:`.sharded_dia`; taken after the anchor-aligned embedding) and
the general layout ``"tiles"`` (the JAX name), where each shard is a :class:`~pysparselp_tpu_torch.problem.CsrMatrix` of
its rows, H-CSR in both orientations.  The JAX general layout's 128×128
block-ELL tiles (K6) and their ``ROW_GROUP·128`` row rounding answer the
TPU's matrix unit; on the H100 an H-CSR SpMV pair beats H-BSR's 128×128
tiles on the CLIME matrix 53.8 µs to 171.7 µs (PERF.md, the K6 row;
NVIDIA H100 80GB HBM3).  The shard
height is ``ceil(m / ndev)`` rows; the last shard's padding rows carry
zero coefficients, right-hand side, step and dual.

The sharded state: ``x``, ``x3`` replicated n-vectors; ``y_eq``,
``y_ineq`` this rank's ``rows_loc`` duals.  Callbacks fire on every rank
with identical values, and every rank returns the same x.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse
import torch

from ..ops.dia_spmv import DiaOperand
from ..problem import CsrMatrix, resolve_dtype
from .mesh import check_mesh
from .sharded_dia import (build_system_dia, local_matvec_dia,
                          local_rmatvec_dia)

# what the last chambolle_pock_ppd_sharded call on this process ran:
# regime, operator, rows per shard and its host seconds
last_run_info: dict | None = None

def _csr_shard(a, ndev, rank):
    """Rank ``rank``'s rows of ``a`` (scipy CSR) as a ``rows_loc x n`` CSR,
    zero rows past the end; returns ``(csr, rows_loc, m_pad, real)``."""
    m, n = a.shape
    rows_loc = max(-(-m // ndev), 1)
    lo = rank * rows_loc
    real = max(0, min(lo + rows_loc, m) - lo)
    part = a[lo:lo + real]
    indptr = np.concatenate([part.indptr,
                             np.full(rows_loc - real, part.indptr[-1])])
    csr = scipy.sparse.csr_matrix((part.data, part.indices, indptr),
                                  shape=(rows_loc, n))
    return csr, rows_loc, rows_loc * ndev, real


def _host_system(a, b, operator, ndev, rank):
    """Host arrays of rank ``rank``'s shard of ``A x (=|<=) b``, or None
    for an absent system."""
    if a is None or a.shape[0] == 0:
        return None
    a = scipy.sparse.csr_matrix(a)
    m = a.shape[0]
    if operator == "dia":
        sys_, rows_loc, m_pad = build_system_dia(a, b, ndev, rank)
    elif operator == "tiles":
        csr, rows_loc, m_pad, real = _csr_shard(a, ndev, rank)
        b_loc = np.zeros(rows_loc)
        b_loc[:real] = np.asarray(b, np.float64)[rank * rows_loc:][:real]
        sys_ = dict(csr=csr, b=b_loc,
                    row_mask=(np.arange(rows_loc) < real).astype(np.float64))
    else:
        raise ValueError(f"operator={operator!r}: use 'dia' or 'tiles'")
    return dict(sys_, m=m, m_pad=m_pad, rows_loc=rows_loc)


def local_rows(v, sys_, rank):
    """Rank ``rank``'s slice of a global per-row vector, zero-padded."""
    rows_loc = sys_["rows_loc"]
    out = np.zeros(rows_loc)
    if v is not None:
        part = np.asarray(v, np.float64)[rank * rows_loc:][:rows_loc]
        out[:part.size] = part
    return out


def place_system(sys_, dtype, device, keys=("b", "row_mask", "sigma"),
                 fused=False):
    """One rank's shard of a system (a host dict of :func:`_host_system`)
    on ``device``: its ``keys`` vectors and its operator, the CSR of its
    rows (``csr``; ``fused``: its CPU twin rounds as the dual solvers'
    products do, ``CsrMatrix.from_scipy``) or its DIA planes with their
    prepared forward and window products (``dia_fwd``, ``dia_win``)."""
    def vec(v):
        return torch.as_tensor(np.array(v, np.float64), dtype=dtype,
                               device=device)

    def i32(v):
        return torch.as_tensor(np.array(v, np.int32), device=device)

    placed = {k: vec(sys_[k]) for k in keys}
    if "csr" in sys_:
        placed["csr"] = CsrMatrix.from_scipy(sys_["csr"], dtype, device,
                                             fused=fused)
        return placed
    placed.update(dia_vals=vec(sys_["dia_vals"]),
                  dia_offs=i32(sys_["dia_offs"]),
                  dia_vals_t=vec(sys_["dia_vals_t"]),
                  dia_offs_t=i32(sys_["dia_offs_t"]),
                  dia_wlo=int(sys_["dia_wlo"]))
    # the shard's forward and window products, checked once
    placed.update(
        dia_fwd=DiaOperand(placed["dia_vals"], placed["dia_offs"],
                           sys_["rows_loc"]),
        dia_win=DiaOperand(placed["dia_vals_t"], placed["dia_offs_t"],
                           placed["dia_vals_t"].shape[1]))
    return placed


def place_shard(c, lb, ub, diag_t, theta, systems, x0, x30, ys, dtype,
                device, fused=False):
    """``(data, state)`` of one rank on ``device``: the replicated vectors,
    this rank's systems (``systems[name]``: host shard dicts as
    :func:`build_sharded_cp_data` makes them, with ``sigma``) and the
    state (``ys[name]``: this rank's duals)."""
    dev = device

    def vec(v):
        return torch.as_tensor(np.array(v, np.float64), dtype=dtype,
                               device=dev)

    data = dict(c=vec(c), lb=vec(lb), ub=vec(ub), diag_t=vec(diag_t),
                theta=vec(theta))
    n = data["c"].shape[0]
    state = dict(x=vec(np.zeros(n) if x0 is None else x0))
    state["x3"] = state["x"] if x30 is None else vec(x30)
    for name, sys_ in systems.items():
        if sys_ is None:
            continue
        data[name] = place_system(sys_, dtype, dev, fused=fused)
        data[name + "_m"] = sys_["m"]
        data[name + "_m_pad"] = sys_["m_pad"]
        state["y_" + name] = vec(ys[name])
    return data, state


def build_sharded_cp_data(c, a_eq, b_eq, a_ineq, b_ineq, lb, ub, mesh,
                          alpha=1.0, dtype=None, x0=None, theta=1.0,
                          y_eq0=None, y_ineq0=None, x30=None,
                          operator="tiles", fused=False):
    """Partition the (one-sided) LP by constraint rows over ``mesh`` and
    return this rank's ``(data, state)`` on ``mesh.device``.

    ``data`` holds the replicated ``c, lb, ub, diag_t, theta`` and, per
    present system (``"eq"``, ``"ineq"``), this rank's operator with its
    ``b``, ``row_mask`` and ``sigma``, beside the system's row count
    (``eq_m``) and padded row count (``eq_m_pad``).  ``state`` holds the
    replicated ``x``, ``x3`` and this rank's duals ``y_eq``/``y_ineq``
    (from the global ``y_eq0``/``y_ineq0`` when given).  The diagonal
    preconditioners are computed on the host over the whole system.
    ``fused`` goes to the CSR shards (:func:`place_system`)."""
    from ..solvers.chambolle_pock import host_preconditioners

    mesh = check_mesh(mesh)
    dt = resolve_dtype(dtype, mesh.device)
    ndev, rank = mesh.size, mesh.rank
    eq = _host_system(a_eq, b_eq, operator, ndev, rank)
    ineq = _host_system(a_ineq, b_ineq, operator, ndev, rank)
    diag_t, sig_eq, sig_in = host_preconditioners(
        a_eq if eq is not None else None,
        a_ineq if ineq is not None else None, alpha=alpha)
    systems, ys = {}, {}
    for name, sys_, sig, y0 in (("eq", eq, sig_eq, y_eq0),
                                ("ineq", ineq, sig_in, y_ineq0)):
        if sys_ is not None:
            systems[name] = dict(sys_, sigma=local_rows(sig, sys_, rank))
            ys[name] = local_rows(y0, sys_, rank)
    return place_shard(c, lb, ub, diag_t, theta, systems, x0, x30, ys, dt,
                       mesh.device, fused=fused)


def _local_matvec(sys_l, x, n):
    """A_local @ x for one shard's row block (DIA or CSR layout)."""
    if "csr" in sys_l:
        return sys_l["csr"].matvec(x)
    return local_matvec_dia(sys_l, x, n)


def _local_rmatvec(sys_l, y, n, out):
    """``out += A_localᵀ @ y`` for one shard's row block."""
    if "csr" in sys_l:
        return out.add_(sys_l["csr"].rmatvec(y))
    return local_rmatvec_dia(sys_l, y, n, out)


def _make_ctx(data, mesh):
    """This rank's view of the replicated problem data and its row blocks
    (shared by every loop body in this module)."""
    return dict(mesh=mesh, c=data["c"], lb=data["lb"], ub=data["ub"],
                diag_t=data["diag_t"], theta=data["theta"],
                eq_l=data.get("eq"), in_l=data.get("ineq"))


def _reduced_costs(ctx, y_eq, y_ineq):
    """``c + psum(A_dᵀ y_d)`` over every present system (one all-reduce
    of an n-vector)."""
    c = ctx["c"]
    n = c.shape[0]
    d_part = torch.zeros_like(c)
    if ctx["eq_l"] is not None:
        _local_rmatvec(ctx["eq_l"], y_eq, n, d_part)
    if ctx["in_l"] is not None:
        _local_rmatvec(ctx["in_l"], y_ineq, n, d_part)
    return c + ctx["mesh"].psum(d_part)


def _iter_local(ctx, carry, omega=None):
    """One row-sharded CP iteration (one psum).  ``omega`` scales the
    primal steps by ω and the dual steps by 1/ω (the restart controller's
    primal weight); None = steps as stored."""
    eq_l, in_l = ctx["eq_l"], ctx["in_l"]
    n = ctx["c"].shape[0]
    theta = ctx["theta"]
    x, x3, y_eq, y_ineq = carry
    dd = _reduced_costs(ctx, y_eq, y_ineq)
    diag_t = ctx["diag_t"] if omega is None else ctx["diag_t"] * omega
    x2 = torch.clamp(x - diag_t * dd, ctx["lb"], ctx["ub"])
    x3 = (1.0 + theta) * x2 - theta * x
    x = x2
    if eq_l is not None:
        r = _local_matvec(eq_l, x3, n) - eq_l["b"]
        sig = eq_l["sigma"] if omega is None else eq_l["sigma"] / omega
        y_eq = y_eq + sig * r
    if in_l is not None:
        r = _local_matvec(in_l, x3, n) - in_l["b"]
        sig = in_l["sigma"] if omega is None else in_l["sigma"] / omega
        y_ineq = torch.clamp_min(y_ineq + sig * r, 0.0)
    return (x, x3, y_eq, y_ineq)


def _kkt_local(ctx, x, y_eq, y_ineq):
    """KKT progress score (PDLP restart trigger), reduced over the mesh:
    the sharded twin of ``solvers.chambolle_pock._kkt_score``."""
    mesh, c = ctx["mesh"], ctx["c"]
    eq_l, in_l = ctx["eq_l"], ctx["in_l"]
    n = c.shape[0]
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    pviol, dual_loc = zero, zero
    if eq_l is not None:
        r = (_local_matvec(eq_l, x, n) - eq_l["b"]) * eq_l["row_mask"]
        pviol = pviol + torch.sum(r * r)
        dual_loc = dual_loc - torch.dot(y_eq, eq_l["b"])
    if in_l is not None:
        r = torch.clamp_min(_local_matvec(in_l, x, n) - in_l["b"],
                            0.0) * in_l["row_mask"]
        pviol = pviol + torch.sum(r * r)
        dual_loc = dual_loc - torch.dot(y_ineq, in_l["b"])
    dd = _reduced_costs(ctx, y_eq, y_ineq)
    pviol, dual = mesh.psum(torch.stack([pviol, dual_loc]))
    dual = dual + torch.sum(torch.where(dd < 0, dd * ctx["ub"],
                                        dd * ctx["lb"]))
    pobj = torch.dot(c, x)
    gap = torch.abs(pobj - dual) / (1.0 + torch.abs(pobj) + torch.abs(dual))
    return torch.sqrt(pviol + gap * gap)


def _metrics_local(ctx, x, y_eq, y_ineq):
    """Chunk metrics reduced over the mesh: the single-device chunk's
    quantities (``chambolle_pock.cp_chunk_impl``), the box-dual lower
    bound ``energy2`` and the rounded-iterate stats ``force_integer``
    uses.  Three all-reduces: the n-vector, the packed sums, the packed
    maxima.  The inequality maxima skip the padding rows, so
    ``max_violated_inequality`` equals the single-device value for every
    row count (the JAX package's zero padding floors it at 0)."""
    mesh, c = ctx["mesh"], ctx["c"]
    eq_l, in_l = ctx["eq_l"], ctx["in_l"]
    n = c.shape[0]
    energy1 = torch.dot(c, x)
    x_rounded = torch.round(x)
    energy_rounded = torch.dot(c, x_rounded)
    dd = _reduced_costs(
        ctx, y_eq * eq_l["row_mask"] if eq_l is not None else y_eq,
        y_ineq * in_l["row_mask"] if in_l is not None else y_ineq)
    x4 = torch.where(dd < 0, ctx["ub"], ctx["lb"])
    energy2 = torch.dot(c, x4)
    sums, maxes = [], []
    for sys_l, y, eq in ((eq_l, y_eq, True), (in_l, y_ineq, False)):
        if sys_l is None:
            continue
        rm = sys_l["row_mask"]
        r = (_local_matvec(sys_l, x, n) - sys_l["b"]) * rm
        r4 = (_local_matvec(sys_l, x4, n) - sys_l["b"]) * rm
        rr = (_local_matvec(sys_l, x_rounded, n) - sys_l["b"]) * rm
        sums += [torch.dot(y, r), torch.dot(y, r4)]
        if eq:
            maxes += [torch.max(torch.abs(r)), torch.max(torch.abs(rr))]
        else:
            pad = torch.full_like(r, -float("inf"))
            maxes += [torch.max(torch.where(rm > 0, r, pad)),
                      torch.max(torch.where(rm > 0, rr, pad))]
    sums = mesh.psum(torch.stack(sums))
    maxes = mesh.pmax(torch.stack(maxes))
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    max_v_eq = max_v_ineq = zero
    rounded_feasible = torch.ones((), dtype=torch.bool, device=c.device)
    k = 0
    if eq_l is not None:
        energy1 = energy1 + sums[0]
        energy2 = energy2 + sums[1]
        max_v_eq = maxes[0]
        rounded_feasible = rounded_feasible & (maxes[1] == 0)
        k = 2
    if in_l is not None:
        energy1 = energy1 + sums[k]
        energy2 = energy2 + sums[k + 1]
        max_v_ineq = maxes[k]
        rounded_feasible = rounded_feasible & (maxes[k + 1] <= 0)
    return {
        "energy1": energy1,
        "energy2": energy2,
        "max_violated_equality": max_v_eq,
        "max_violated_inequality": max_v_ineq,
        "energy_rounded": energy_rounded,
        "rounded_feasible": rounded_feasible,
    }


def _unpack_state(state):
    empty = state["x"].new_zeros(0)
    return (state["x"], state["x3"], state.get("y_eq", empty),
            state.get("y_ineq", empty))


def _pack_state(carry, data):
    x, x3, y_eq, y_ineq = carry
    out = {"x": x, "x3": x3}
    if "eq" in data:
        out["y_eq"] = y_eq
    if "ineq" in data:
        out["y_ineq"] = y_ineq
    return out


def sharded_cp_chunk(data, state, mesh, nsteps: int):
    """Run ``nsteps`` row-sharded CP-PPD iterations; returns
    ``(state, metrics)``."""
    ctx = _make_ctx(data, check_mesh(mesh))
    carry = _unpack_state(state)
    for _ in range(nsteps):
        carry = _iter_local(ctx, carry)
    metrics = _metrics_local(ctx, carry[0], carry[2], carry[3])
    return _pack_state(carry, data), metrics


def sharded_kkt_score(data, state, mesh):
    """KKT score of a sharded state (seeds the restart controller)."""
    ctx = _make_ctx(data, check_mesh(mesh))
    x, _x3, y_eq, y_ineq = _unpack_state(state)
    return _kkt_local(ctx, x, y_eq, y_ineq)


def sharded_cp_chunk_restart_device(data, rstate, mesh, nsteps: int,
                                    period: int):
    """Device-resident PDLP restart controller for the row-sharded solver:
    the sharded twin of ``solvers.chambolle_pock._cp_chunk_restart_device``.

    Runs ``nsteps`` iterations with a restart check every ``period``
    iterations.  The KKT scores reduce with psum, and the restart
    decision, the restart-to-average choice and the primal-weight (ω)
    update are replicated 0-d tensors fed to ``torch.where``: no host
    fetch inside the chunk.  ``rstate`` carries the solver ``state``, the
    controller scalars ``omega``, ``mu_restart``, ``mu_last`` and the last
    restart point (``zx`` replicated, ``zeq``/``zineq`` this rank's rows).
    Step sizes in ``data`` must be unscaled (ω is applied inside).
    Returns ``(rstate, metrics)``."""
    from ..solvers.chambolle_pock import pdlp_restart

    ctx = _make_ctx(data, check_mesh(mesh))
    c = ctx["c"]
    nblocks = max(nsteps // period, 0)
    rem = nsteps - nblocks * period
    carry = _unpack_state(rstate["state"])
    empty = c.new_zeros(0)
    rsl = {
        "state": carry,
        "omega": rstate["omega"],
        "mu_restart": rstate["mu_restart"],
        "mu_last": rstate["mu_last"],
        "zx": rstate["zx"],
        "zeq": rstate.get("zeq", empty),
        "zineq": rstate.get("zineq", empty),
    }

    def run_block(rsl):
        omega = rsl["omega"]
        s = rsl["state"]
        sx, se, si = (torch.zeros_like(c), torch.zeros_like(s[2]),
                      torch.zeros_like(s[3]))
        for _ in range(period):
            s = _iter_local(ctx, s, omega)
            sx, se, si = sx + s[0], se + s[2], si + s[3]
        inv = 1.0 / period
        ax, ae, ai = sx * inv, se * inv, si * inv
        s_cur = _kkt_local(ctx, s[0], s[2], s[3])
        s_avg = _kkt_local(ctx, ax, ae, ai)

        def candidate(use_avg):
            z = tuple(torch.where(use_avg, a, v)
                      for a, v in zip((ax, ae, ai), (s[0], s[2], s[3])))
            dx = torch.linalg.norm(z[0] - rsl["zx"])
            dy = torch.sqrt(ctx["mesh"].psum(
                torch.sum((z[1] - rsl["zeq"]) ** 2)
                + torch.sum((z[2] - rsl["zineq"]) ** 2)))
            return z, dx, dy

        do, (zx, zeq, zineq), scalars = pdlp_restart(rsl, s_cur, s_avg,
                                                     candidate)
        return {
            "state": (torch.where(do, zx, s[0]), torch.where(do, zx, s[1]),
                      torch.where(do, zeq, s[2]),
                      torch.where(do, zineq, s[3])),
            **scalars,
            "zx": torch.where(do, zx, rsl["zx"]),
            "zeq": torch.where(do, zeq, rsl["zeq"]),
            "zineq": torch.where(do, zineq, rsl["zineq"]),
        }

    for _ in range(nblocks):
        rsl = run_block(rsl)
    if rem:
        s = rsl["state"]
        for _ in range(rem):
            s = _iter_local(ctx, s, rsl["omega"])
        rsl = dict(rsl, state=s)
    x, _x3, y_eq, y_ineq = rsl["state"]
    metrics = _metrics_local(ctx, x, y_eq, y_ineq)
    out = {k: rsl[k] for k in ("omega", "mu_restart", "mu_last", "zx")}
    out["state"] = _pack_state(rsl["state"], data)
    if "eq" in data:
        out["zeq"] = rsl["zeq"]
    if "ineq" in data:
        out["zineq"] = rsl["zineq"]
    return out, metrics


def _rescale_steps(data, ratio):
    """``data`` with the primal steps times ``ratio`` and the dual steps
    over it."""
    data = dict(data)
    data["diag_t"] = data["diag_t"] * ratio
    for name in ("eq", "ineq"):
        if name in data:
            data[name] = dict(data[name], sigma=data[name]["sigma"] / ratio)
    return data


def chambolle_pock_ppd_sharded(
    c, a_eq, beq, a_ineq, b_lower, b_upper, lb, ub, mesh,
    nb_max_iter=1000, nb_iter_plot=100, callback_func=None, max_time=None,
    dtype=None, alpha=1.0, restart=None, omega=None, permute="auto",
    x0=None, theta=1.0, stop_tol=None, start_time=None, y_eq0=None,
    y_ineq0=None, x30=None, restart_period=None, save_problem=False,
    force_integer=False, light_metrics=False,
):
    """Mesh-parallel CP-PPD with the standard solver contract; returns x
    (or ``(x, best_integer_solution)`` when ``force_integer=True``) on
    every rank.

    ``mesh`` is a :class:`~.mesh.Mesh`; its device runs the solve and
    ``dtype=None`` means float32 on CUDA and float64 on the CPU.
    ``restart``/``omega`` mirror the single-device solver's PDLP-style
    acceleration, with the controller inside the sharded chunk
    (:func:`sharded_cp_chunk_restart_device`).  ``permute="auto"`` on
    CUDA applies the layout presolve's choice
    (``solvers.chambolle_pock._choose_layout``): ``"align"`` runs the
    per-shard DIA layout, ``"rcm"`` the permutation and then the general
    layout; on the CPU ``"auto"`` means ``False``.  ``"align"`` and
    ``"rcm"`` (or ``True``) force one on any device.  ``theta``,
    ``stop_tol``, ``x0``/``x30``/``y_eq0``/``y_ineq0`` (full-state resume)
    and ``force_integer`` (the best feasible rounded iterate: feasibility
    pmax-reduced, energy replicated) complete the parity with the
    single-device solver."""
    global last_run_info
    from ..problem import (anchor_align, apply_align_embedding,
                           apply_rcm_permutation)
    from ..solvers.base import (HostLoop, chunk_schedule, emit_callback,
                                mirror_callback_attrs, to_np)
    from ..solvers.chambolle_pock import (_choose_layout, _fold_one_sided,
                                          estimate_omega)

    del save_problem  # repro dumps are handled by utils.save_arguments
    mesh = check_mesh(mesh)
    loop = HostLoop(start_time=start_time, max_time=max_time)
    t0 = time.perf_counter()
    if restart is not None and omega is None:
        omega = "auto"
    if a_eq is not None and a_eq.shape[0] == 0:
        a_eq, beq = None, None
    a_one, b_ineq = _fold_one_sided(a_ineq, b_lower, b_upper)
    if a_one is not None and a_one.shape[0] == 0:
        a_one, b_ineq = None, None
    if omega == "auto":
        omega = estimate_omega(c, beq if a_eq is not None else None, b_ineq)
    omega = float(omega) if omega is not None else 1.0

    if permute == "auto" and mesh.device.type != "cuda":
        permute = False
    if permute is True:
        permute = "rcm"
    if permute not in (False, None, "auto", "align", "rcm"):
        raise ValueError(f"permute={permute!r}: use 'auto', 'align', 'rcm', "
                         "True or False")
    c = np.asarray(c, np.float64)
    lb = np.asarray(lb, np.float64)
    ub = np.asarray(ub, np.float64)
    if a_eq is None and a_one is None:
        # unconstrained: minimize cᵀx over the box
        x = np.where(c > 0, lb, np.where(c < 0, ub, 0.0))
        return (x, None) if force_integer else x
    inv_cols = None
    operator = "tiles"
    choice = None
    if permute:
        mats = [a_eq, a_one]
        choice, plan = ((permute, None) if permute != "auto"
                        else _choose_layout(mats)[:2])
        sys = dict(a_eq=a_eq, beq=beq, a_ineq=a_one, b_ineq=b_ineq,
                   c=c, lb=lb, ub=ub, x0=x0, x30=x30,
                   y_eq0=y_eq0, y_ineq0=y_ineq0)
        col_pos = None
        if choice == "align":
            sys, _pe, _pi, col_pos = apply_align_embedding(
                plan if plan is not None else anchor_align(mats), sys)
            from .sharded_dia import sharded_dia_eligible

            if sharded_dia_eligible([sys["a_eq"], sys["a_ineq"]], mesh.size,
                                    dtype):
                operator = "dia"
        elif choice == "rcm":
            sys, _pe, _pi, col_pos = apply_rcm_permutation(sys)
        if col_pos is not None:
            a_eq, beq = sys["a_eq"], sys["beq"]
            a_one, b_ineq = sys["a_ineq"], sys["b_ineq"]
            c, lb, ub = sys["c"], sys["lb"], sys["ub"]
            x0, x30 = sys["x0"], sys["x30"]
            y_eq0, y_ineq0 = sys["y_eq0"], sys["y_ineq0"]
            inv_cols = col_pos
        if inv_cols is not None and callback_func is not None:
            user_cb = callback_func

            if getattr(user_cb, "wants_solution", True):
                def callback_func(niter, xp, *rest):
                    user_cb(niter, to_np(xp)[inv_cols], *rest)
            else:
                def callback_func(niter, xp, *rest):
                    user_cb(niter, xp, *rest)
            mirror_callback_attrs(callback_func, user_cb)
    presolve_s = time.perf_counter() - t0
    # position-sharded regime: for aligned DIA systems in float32, H-CPDIA
    # runs per shard with a halo exchange (O(halo) entries an iteration
    # instead of the replicated primal's all-reduce), the PDLP restart
    # controller included (parallel/sharded_cp_windowed.py)
    if restart in (None, "average") and resolve_dtype(
            dtype, mesh.device) == torch.float32:
        from . import sharded_cp_windowed as scw

        info = scw.position_shard_plan(
            a_eq, a_one, c.size, a_eq.shape[0] if a_eq is not None else 0,
            a_one.shape[0] if a_one is not None else 0, mesh.size,
            torch.float32, device=mesh.device)
        if info is not None:
            sys_w = dict(a_eq=a_eq, beq=beq, a_ineq=a_one, b_ineq=b_ineq,
                         c=c, lb=lb, ub=ub, x0=x0, x30=x30,
                         y_eq0=y_eq0, y_ineq0=y_ineq0)
            x_final, best = scw.run_position_sharded(
                sys_w, mesh, info, nb_max_iter=nb_max_iter,
                nb_iter_plot=nb_iter_plot, callback_func=callback_func,
                max_time=max_time, start_time=loop.start,
                force_integer=force_integer, stop_tol=stop_tol,
                light_metrics=light_metrics, theta=theta, alpha=alpha,
                omega=omega, restart=restart,
                restart_period=restart_period)
            last_run_info = dict(scw.last_run_info,
                                 permutation=choice, presolve_s=presolve_s)
            if inv_cols is not None:
                x_final = x_final[inv_cols]
                if best is not None:
                    best = best[inv_cols]
            return (x_final, best) if force_integer else x_final
    t0 = time.perf_counter()
    data, state = build_sharded_cp_data(
        c, a_eq, beq, a_one, b_ineq, lb, ub, mesh,
        alpha=alpha, dtype=dtype, x0=x0, theta=theta,
        y_eq0=y_eq0, y_ineq0=y_ineq0, x30=x30, operator=operator,
    )
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    last_run_info = dict(
        regime="row-sharded-dia" if operator == "dia" else "row-sharded-csr",
        operator=operator, permutation=choice, ranks=mesh.size,
        rows_loc={k: int(data[k]["b"].shape[0]) for k in ("eq", "ineq")
                  if k in data},
        presolve_s=presolve_s, build_s=time.perf_counter() - t0)
    if omega != 1.0 and restart != "average":
        # without the restart controller the primal weight is a one-time
        # rescale of the stored step sizes; the controller instead keeps ω
        # on the device and applies it inside the chunk
        data = _rescale_steps(data, omega)

    # restart checks run on the device every ``period`` iterations (the
    # single-device solver's restart_period semantics: at most
    # nb_iter_plot)
    period = int(min(restart_period or nb_iter_plot, nb_iter_plot))
    rstate = None
    best_integer_solution = None
    best_integer_energy = np.inf
    niter = 0
    for nsteps in chunk_schedule(nb_max_iter, nb_iter_plot):
        if restart == "average":
            if rstate is None:
                # the controller starts from the KKT score of the initial
                # point (device computation, no host fetch)
                rstate = {
                    "state": state,
                    "omega": torch.tensor(omega, dtype=data["c"].dtype,
                                          device=mesh.device),
                    "mu_restart": sharded_kkt_score(data, state, mesh),
                    "mu_last": torch.tensor(np.inf, dtype=data["c"].dtype,
                                            device=mesh.device),
                    "zx": state["x"],
                }
                if "y_eq" in state:
                    rstate["zeq"] = state["y_eq"]
                if "y_ineq" in state:
                    rstate["zineq"] = state["y_ineq"]
            rstate, metrics = sharded_cp_chunk_restart_device(
                data, rstate, mesh, nsteps, period)
            state = rstate["state"]
        else:
            state, metrics = sharded_cp_chunk(data, state, mesh, nsteps)
        niter += nsteps
        if force_integer and bool(metrics["rounded_feasible"]):
            er = float(metrics["energy_rounded"])
            if er < best_integer_energy:
                best_integer_energy = er
                best_integer_solution = np.round(to_np(state["x"]))
        emit_callback(
            callback_func, niter, state["x"],
            metrics["energy1"], metrics["energy2"], lambda: loop.elapsed,
            metrics["max_violated_equality"],
            metrics["max_violated_inequality"],
            light=light_metrics,
        )
        if loop.timed_out:
            break
        if stop_tol is not None:
            # the single-device criterion: feasibility plus the relative
            # primal-dual gap of the chunk metrics
            e1, e2 = float(metrics["energy1"]), float(metrics["energy2"])
            gap = abs(e1 - e2) / (1.0 + abs(e1) + abs(e2))
            feas = max(float(metrics["max_violated_equality"]),
                       float(metrics["max_violated_inequality"]))
            if feas < stop_tol and gap < stop_tol:
                break
    x_final = to_np(state["x"])
    if inv_cols is not None:
        x_final = x_final[inv_cols]
        if best_integer_solution is not None:
            best_integer_solution = best_integer_solution[inv_cols]
    if force_integer:
        return x_final, best_integer_solution
    return x_final
