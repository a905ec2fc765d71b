"""Rank bodies for the mesh solvers' tests (``tests/test_torch_sharded.py``,
``tests/test_torch_sharded_solvers.py``,
``tests/test_torch_sharded_windowed.py``).

``pysparselp_tpu_torch.parallel.mesh.spawn`` runs these in fresh processes,
which import this module and never jax: every input arrives as numpy/scipy
arrays, and only rank 0's result returns.  :func:`run_cases` runs a list of
cases on one mesh, so each world size costs one spawn.
"""

import numpy as np
import scipy.sparse
import torch

from pysparselp_tpu_torch.modeling import SparseLP
from pysparselp_tpu_torch.parallel import sharded_cp
from pysparselp_tpu_torch.parallel.mesh import default_mesh
from pysparselp_tpu_torch.utils.convert import sharded_from_jax

CP = "chambolle_pock_ppd"


def port_lp(args):
    """A port SparseLP of the solver arguments ``(c, a_eq, beq, a_ineq,
    b_lower, b_upper, lb, ub)``."""
    c, a_eq, beq, a_ineq, b_lower, b_upper, lb, ub = args
    lp = SparseLP()
    lp.add_variables_array(len(c), lower_bounds=lb, upper_bounds=ub, costs=c)
    if a_eq is not None:
        lp.add_equality_constraints_sparse(a_eq, beq)
    if a_ineq is not None:
        lp.add_inequality_constraints_sparse(a_ineq, b_lower, b_upper)
    lp.convert_to_one_sided_inequality_system()
    return lp


def _solve(mesh, args, kwargs):
    """``chambolle_pock_ppd_sharded`` with every checkpoint recorded."""
    seen = []

    def record(niter, x, e1, e2, _dur, mveq, mvineq):
        seen.append((niter, e1, e2, mveq, mvineq))

    out = sharded_cp.chambolle_pock_ppd_sharded(
        *args, mesh, callback_func=record, **kwargs)
    x, best = out if kwargs.get("force_integer") else (out, None)
    return dict(x=x, best=best, checkpoints=seen,
                info=dict(sharded_cp.last_run_info))


def _dispatch(mesh, args, kwargs):
    """``SparseLP.solve(mesh=...)`` on the port model of ``args``."""
    lp = port_lp(args)
    x, _ = lp.solve(method=CP, mesh=mesh, device=mesh.device.type, **kwargs)
    return dict(x=x, itrn=list(lp.itrn_curve),
                pobj=[float(v) for v in lp.pobj_curve])


def _resume(mesh, data, state, nsteps):
    """``nsteps`` iterations from a JAX sharded state carried across."""
    d, s = sharded_from_jax(data, state, mesh.size, mesh.rank,
                            device=mesh.device)
    s, _metrics = sharded_cp.sharded_cp_chunk(d, s, mesh, nsteps)
    rows_loc = d["ineq"]["b"].shape[0]
    return dict(x=s["x"].numpy(), y_ineq=s["y_ineq"].numpy(),
                rows=(mesh.rank * rows_loc, (mesh.rank + 1) * rows_loc))


def _mesh_checks(mesh):
    """The collectives on 0-d and 1-D tensors, their counts, and the
    refusals: a CUDA mesh without CUDA, a device that disagrees with the
    mesh."""
    mesh.calls.clear()
    f64 = dict(dtype=torch.float64, device=mesh.device)
    one = torch.tensor(float(mesh.rank + 1), **f64)
    vec = torch.arange(3, **f64) * (mesh.rank + 1)
    out = dict(psum0=mesh.psum(one), pmax0=mesh.pmax(one),
               psum1=mesh.psum(vec), pmax1=mesh.pmax(-vec),
               shape0=tuple(mesh.psum(one).shape), unchanged=float(one))
    out = {k: v.cpu().numpy() if torch.is_tensor(v) else v
           for k, v in out.items()}
    out["calls"] = dict(mesh.calls)
    out["size"], out["backend"] = mesh.size, mesh.backend
    errors = {}
    if not torch.cuda.is_available():
        try:
            default_mesh("cuda")
        except RuntimeError as e:
            errors["cuda_mesh"] = str(e)
    args = (np.array([1.0, -1.0]), None, None,
            np.array([[1.0, 1.0]]), None, np.array([1.0]),
            np.zeros(2), np.ones(2))
    try:
        lp = port_lp(args[:3] + (scipy.sparse.csr_matrix(args[3]),)
                     + args[4:])
        lp.solve(method=CP, mesh=mesh, device="cuda:1", nb_iter=2)
    except ValueError as e:
        errors["device"] = str(e)
    out["errors"] = errors
    return out


def make_lp(spec):
    """The port LP of a spec: ``("random", kwargs)`` (the one-sided
    ``generate_random_lp``, the JAX package's verbatim), ``("assign", n,
    seed)`` (an n x n assignment with row sums 1), ``("blocky",)`` (the
    4-block LP of ``tests/test_admm.py``) or ``("args", args)``
    (:func:`port_lp`)."""
    import copy

    from pysparselp_tpu_torch.utils.random_lp import generate_random_lp

    if spec[0] == "random":
        lp, _ = generate_random_lp(**spec[1])
        lp = copy.deepcopy(lp)
        lp.convert_to_one_sided_inequality_system()
        return lp
    if spec[0] == "assign":
        _, n, seed = spec
        cost = np.random.RandomState(seed).rand(n, n)
        lp = SparseLP()
        x = lp.add_variables_array(cost.shape, 0, 1, costs=cost)
        lp.add_equality_constraints(x, np.ones_like(cost), b=np.ones(n))
        return lp
    if spec[0] == "blocky":
        np.random.seed(5)
        lp = SparseLP()
        lp.add_variables_array(40, 0, 1, costs=np.random.randn(40))
        for _k in range(4):
            cols = np.zeros((5, 3), dtype=int)
            for r in range(5):
                cols[r] = np.random.choice(40, 3, replace=False)
            lp.add_inequality_constraints(
                cols, np.ones((5, 3)), lower_bounds=None, upper_bounds=2.0)
        return lp
    return port_lp(spec[1])


def _lp_solve(mesh, spec, kwargs):
    """``SparseLP.solve(mesh=...)`` of the spec's LP: x, the curves and
    the collectives by ``(op, numel)``."""
    lp = make_lp(spec)
    mesh.calls.clear()
    x, _ = lp.solve(mesh=mesh, device=mesh.device.type, **kwargs)
    return dict(x=x, itrn=list(lp.itrn_curve),
                dobj=[float(v) for v in lp.dobj_curve],
                pobj=[float(v) for v in lp.pobj_curve],
                calls=dict(mesh.calls))


def _mpc(mesh, a, b, c, kwargs):
    """``mpc_sol_sharded`` on the standard form ``(a, b, c)``."""
    from pysparselp_tpu_torch.parallel import sharded_mehrotra

    f, x, y, s, niter = sharded_mehrotra.mpc_sol_sharded(a, b, c, mesh,
                                                         **kwargs)
    return dict(f=f, x=x, y=y, s=s, niter=niter,
                info=dict(sharded_mehrotra.last_run_info))


def _dga_dia(mesh, spec, kwargs):
    """``dual_gradient_ascent_sharded`` with each layout forced: the
    shards' DIA planes (H-DIA's twin with shard offsets) and their CSR."""
    from pysparselp_tpu_torch.parallel import sharded_dga

    out = {}
    for op in ("dia", "tiles"):
        x, y_eq, y_in = sharded_dga.dual_gradient_ascent_sharded(
            None, make_lp(spec), mesh, operator=op, **kwargs)
        out[op] = dict(x=x, y_eq=y_eq, y_ineq=y_in,
                       info=dict(sharded_dga.last_run_info))
    return out


def _admm_layouts(mesh, spec, nsteps):
    """The ADMM chunk on one standard form with the shards in each layout
    (DIA planes, CSR): x after ``nsteps`` iterations, and the duals of this
    rank's rows."""
    from pysparselp_tpu_torch.parallel import sharded_admm
    from pysparselp_tpu_torch.solvers.admm import admm_system

    lp = make_lp(spec)
    c2, a, b, lb, ub, x0 = admm_system(
        lp.costsvector, lp.a_equalities.tocsr(), lp.b_equalities,
        lp.a_inequalities.tocsr(), lp.b_lower, lp.b_upper, lp.lower_bounds,
        lp.upper_bounds)
    at = scipy.sparse.csr_matrix(a).T.tocsr()
    f64 = dict(dtype=torch.float64, device=mesh.device)

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), **f64)

    diag_m = 2.0 * np.asarray(scipy.sparse.csr_matrix(a).multiply(a).sum(
        axis=0)).ravel() + 3.0
    out = {}
    for op in ("dia", "tiles"):
        sys_l, rows_loc, _m_pad, got = sharded_admm.build_sharded_system(
            a, b, mesh, torch.float64, operator=op)
        data = dict(c=vec(c2), lb=vec(lb), ub=vec(ub), gamma_eq=vec(2.0),
                    gamma_ineq=vec(3.0), inv_diag=vec(1.0 / diag_m),
                    omega=vec(0.5), atb=vec(at @ b), sys=sys_l)
        x = torch.clamp(vec(x0), data["lb"], data["ub"])
        (x, _xp, lam), metrics = sharded_admm.admm_chunk_sharded(
            data, (x, x, torch.zeros(rows_loc, **f64)), mesh, nsteps, 2)
        out[op] = dict(x=x.numpy(), operator=got,
                       energy=float(metrics["energy1"]))
    return out


def _position_shard(mesh, jdata, jstate):
    """This rank's position-sharded ``(data, state)`` (float32) of a JAX
    ``build_position_sharded`` data and state (numpy); the plan's CPU
    gate opened as the JAX tests open ``_FORCE_INTERPRET``."""
    from pysparselp_tpu_torch.parallel import sharded_cp_windowed as scw

    scw._FORCE_CPU = mesh.device.type == "cpu"
    return sharded_from_jax(jdata, jstate, mesh.size, mesh.rank,
                            dtype=torch.float32, device=mesh.device,
                            layout="position")


def _pos_chunk(mesh, jdata, jstate, nsteps):
    """``sharded_windowed_chunk`` from a JAX state: the global state and
    the halo exchanges counted."""
    from pysparselp_tpu_torch.parallel import sharded_cp_windowed as scw

    data, state = _position_shard(mesh, jdata, jstate)
    mesh.calls.clear()
    state = scw.sharded_windowed_chunk(data, state, mesh, nsteps)
    calls = dict(mesh.calls)
    return dict(zip(("x", "x3", "y_eq", "y"),
                    scw.unshard_state(data, state, mesh)), calls=calls)


def _pos_counts(mesh, sys_d, nsteps):
    """``sharded_windowed_chunk`` of an aligned system (built here, the
    plan's CPU gate open): the global state and, an iteration, the halo
    all-gathers, the halo placements and the shard entry's calls."""
    from pysparselp_tpu_torch.parallel import mesh as pmesh
    from pysparselp_tpu_torch.parallel import sharded_cp_windowed as scw

    scw._FORCE_CPU = mesh.device.type == "cpu"
    data, state = scw.build_position_sharded(sys_d, mesh)
    stepper, calls = scw.cp_dia_shard_stepper, [0]

    def counting(*args, **kwargs):
        step = stepper(*args, **kwargs)

        def counted():
            calls[0] += 1
            step()
        return counted

    scw.cp_dia_shard_stepper = counting
    mesh.calls.clear()
    placed = pmesh.HaloRoute.launches
    try:
        state = scw.sharded_windowed_chunk(data, state, mesh, nsteps)
    finally:
        scw.cp_dia_shard_stepper = stepper
    halo = sum(v for (op, _k), v in mesh.calls.items() if op == "halo")
    return dict(state=[v for v in scw.unshard_state(data, state, mesh)
                       if v.size or data["has_eq"]],
                per_iteration=dict(
                    halo=halo / nsteps,
                    placements=(pmesh.HaloRoute.launches - placed) / nsteps,
                    entry_calls=calls[0] / nsteps))


def _pos_restart(mesh, jdata, jstate, mu0, nsteps, period):
    """``sharded_windowed_chunk_restart`` from a JAX state at ω = 1."""
    from pysparselp_tpu_torch.parallel import sharded_cp_windowed as scw

    data, st = _position_shard(mesh, jdata, jstate)
    f32 = dict(dtype=torch.float32, device=mesh.device)
    rs = dict(state=st, omega=torch.tensor(1.0, **f32),
              mu_restart=torch.tensor(mu0, **f32),
              mu_last=torch.tensor(np.inf, **f32), zx=st["x"],
              zeq=st.get("y_eq"), zineq=st["y_ineq"])
    seeded = float(scw.sharded_kkt_score(data, st, mesh))
    rs = scw.sharded_windowed_chunk_restart(data, rs, mesh, nsteps, period)
    return dict(zip(("x", "x3", "y_eq", "y"),
                    scw.unshard_state(data, rs["state"], mesh)),
                omega=float(rs["omega"]), mu_restart=float(rs["mu_restart"]),
                mu_last=float(rs["mu_last"]), kkt0=seeded)


def _pos_metrics(mesh, jdata, jstate):
    """``sharded_windowed_metrics`` of a JAX state."""
    from pysparselp_tpu_torch.parallel import sharded_cp_windowed as scw

    data, state = _position_shard(mesh, jdata, jstate)
    return {k: float(v) for k, v in
            scw.sharded_windowed_metrics(data, state, mesh).items()}


def _pos_solve(mesh, c, a, b, kwargs):
    """``SparseLP.solve(mesh=...)`` of ``min cx, A x <= b, 0 <= x <= 2``
    (the JAX tests' end-to-end LP) with the plan's CPU gate open: x, the
    curves, what ran and the collectives."""
    from pysparselp_tpu_torch.parallel import sharded_cp, sharded_cp_windowed

    sharded_cp_windowed._FORCE_CPU = mesh.device.type == "cpu"
    lp = SparseLP()
    lp.add_variables_array(len(c), lower_bounds=0, upper_bounds=2, costs=c)
    lp.add_inequality_constraints_sparse(a, None, b)
    mesh.calls.clear()
    x, _ = lp.solve(method=CP, mesh=mesh, device=mesh.device.type, **kwargs)
    return dict(x=x, itrn=list(lp.itrn_curve),
                curves={k: [float(v) for v in getattr(lp, k)]
                        for k in ("pobj_curve", "dobj_curve",
                                  "max_violated_inequality")},
                info=dict(sharded_cp.last_run_info), calls=dict(mesh.calls))


def _dca_merge(mesh, host, dtype, project, seed):
    """One blocked colour sweep with the groups split over the ranks
    (``sharded_dca.sharded_color_sweep``) from a given state: y, c̄, the
    key, the collectives and which groups share column 0."""
    from pysparselp_tpu_torch.ops.dca_sweep import EllRows
    from pysparselp_tpu_torch.parallel.sharded_dca import (
        shard_groups, sharded_color_sweep)
    from pysparselp_tpu_torch.solvers.dual_ascent import _color_rows
    from pysparselp_tpu_torch.utils.jax_prng import prng_key

    dt, dev = getattr(torch, dtype), mesh.device

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dt,
                               device=dev)

    mesh.calls.clear()
    a = host["a"]
    groups = shard_groups(_color_rows(a), a, mesh)
    y, c_bar, key = sharded_color_sweep(
        EllRows.from_scipy(a, dt, dev), t(host["b"]),
        torch.as_tensor(host["active"], device=dev), t(host["y"]),
        t(host["c_bar"]), t(host["lb"]), t(host["ub"]), prng_key(seed),
        groups, project, mesh)
    return dict(y=y.cpu().numpy(), c_bar=c_bar.cpu().numpy(), key=key,
                calls=dict(mesh.calls),
                shared=[g.get("col0_shared") for g in groups])


RUNNERS = {"solve": _solve, "dispatch": _dispatch, "resume": _resume,
           "mesh_checks": _mesh_checks, "lp_solve": _lp_solve, "mpc": _mpc,
           "dga_dia": _dga_dia, "admm_layouts": _admm_layouts,
           "pos_chunk": _pos_chunk, "pos_counts": _pos_counts,
           "pos_restart": _pos_restart,
           "pos_metrics": _pos_metrics, "pos_solve": _pos_solve,
           "dca_merge": _dca_merge}


def run_cases(mesh, cases):
    """``{name: result}`` of each ``(name, kind, args)`` case on ``mesh``
    (``RUNNERS[kind](mesh, *args)``)."""
    torch.set_num_threads(1)
    return {name: RUNNERS[kind](mesh, *args) for name, kind, args in cases}


def fail_on_rank_one(mesh):
    """Rank 1 raises; rank 0 waits in a collective it never completes."""
    if mesh.rank == 1:
        raise ValueError("rank one fails on purpose")
    mesh.psum(torch.zeros(1))
    return "unreachable"
