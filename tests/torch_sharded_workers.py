"""Rank bodies for the row-sharded solver's tests (``tests/test_torch_sharded.py``).

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


RUNNERS = {"solve": _solve, "dispatch": _dispatch, "resume": _resume,
           "mesh_checks": _mesh_checks}


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
