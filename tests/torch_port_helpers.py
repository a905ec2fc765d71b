"""Shared inputs for the PyTorch-port parity tests (``tests/test_torch_*.py``).

Host systems are built with numpy/scipy host code, so both packages receive
the same arrays: a JAX ``LPProblem`` is lowered from them and carried to the
port with ``pysparselp_tpu_torch.utils.convert``, or the port lowers them
itself.  This module imports no jax at import time: the ``cuda``-marked
tests run on a machine without JAX (``python -m pytest --noconftest -m
cuda`` over the three kernel test files), where only the port-side helpers
are used.
"""

import contextlib
import copy
import os
import tempfile

import numpy as np
import pytest
import torch

from pysparselp_tpu_torch import problem as ppr
from pysparselp_tpu_torch.solvers.chambolle_pock import (_fold_one_sided,
                                                         host_preconditioners)


def cuda_or_skip():
    """Skip the calling test when this machine has no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


class CudaLike:
    """A stand-in for a contiguous CUDA tensor (the CPU build of torch has
    none): its device says CUDA, its data is a CPU tensor's."""

    def __init__(self, t):
        self.t, self.shape, self.dtype = t, t.shape, t.dtype
        self.device = torch.device("cuda")

    def dim(self):
        return self.t.dim()

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.t.data_ptr()


def sc105_lp(port=False):
    """Netlib SC105 as the JAX tests build it (``tests/test_netlib.py``),
    as a JAX-package SparseLP or, with ``port=True``, a port SparseLP."""
    if port:
        from pysparselp_tpu_torch.io.netlib import get_problem
        from pysparselp_tpu_torch.modeling import SparseLP
    else:
        from pysparselp_tpu.io.netlib import get_problem
        from pysparselp_tpu.modeling import SparseLP
    d = get_problem("SC105")
    gt = d["solution"]
    lp = SparseLP()
    lp.add_variables_array(
        len(d["cost_vector"]), lower_bounds=d["lower_bounds"],
        upper_bounds=np.minimum(d["upper_bounds"], np.max(gt) * 2),
        costs=d["cost_vector"])
    lp.add_equality_constraints_sparse(d["a_eq"], d["b_eq"])
    lp.add_inequality_constraints_sparse(d["a_ineq"], d["b_lower"],
                                         d["b_upper"])
    lp2 = copy.deepcopy(lp)
    lp2.convert_to_one_sided_inequality_system()
    return lp2, gt


def host_system(lp, align=False):
    """The solver's host-side system for ``lp``: fixed variables removed,
    inequalities folded one-sided, optionally anchor-aligned.  Returns a
    dict with ``a_eq, beq, a_ineq, b_ineq, c, lb, ub`` (absent systems
    None)."""
    lp = copy.deepcopy(lp)
    lp.remove_fixed_variables()
    a_eq = lp.a_equalities.tocsr() if lp.a_equalities.shape[0] else None
    a_in = lp.a_inequalities.tocsr() if lp.a_inequalities.shape[0] else None
    a_one, b_one = _fold_one_sided(
        a_in, lp.b_lower if a_in is not None else None,
        lp.b_upper if a_in is not None else None)
    sys_ = dict(a_eq=a_eq, beq=lp.b_equalities if a_eq is not None else None,
                a_ineq=a_one, b_ineq=b_one, c=lp.costsvector,
                lb=lp.lower_bounds, ub=lp.upper_bounds)
    if align:
        plan = ppr.anchor_align([a_eq, a_one])
        sys_ = ppr.apply_align_embedding(plan, sys_)[0]
    return sys_


def _preconditioners(sys_):
    diag_t, s_eq, s_in = host_preconditioners(sys_["a_eq"], sys_["a_ineq"])
    pre = {"diag_t": diag_t}
    if s_eq is not None:
        pre["sigma_eq"] = s_eq
    if s_in is not None:
        pre["sigma_ineq"] = s_in
    return pre


def port_problem(sys_, backend, dtype, device="cpu"):
    """The port's ``LPProblem`` + preconditioners for a host system, every
    present system lowered to ``backend`` ("dia", "dense" or "csr")."""
    def op(a):
        return None if a is None else ppr.ell_from_scipy(a, dtype, device,
                                                         prefer=backend)

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)

    a_eq, a_in = op(sys_["a_eq"]), op(sys_["a_ineq"])
    prob = ppr.LPProblem(
        c=vec(sys_["c"]), lb=vec(sys_["lb"]), ub=vec(sys_["ub"]),
        a_eq=a_eq, b_eq=vec(sys_["beq"]) if a_eq is not None else None,
        a_ineq=a_in, b_lower=None,
        b_upper=vec(sys_["b_ineq"]) if a_in is not None else None,
        n=len(sys_["c"]),
        m_eq=a_eq.nrows if a_eq is not None else 0,
        m_ineq=a_in.nrows if a_in is not None else 0)
    return prob, torch_pre(_preconditioners(sys_), dtype, device)


def jax_problem(sys_, backend, dtype):
    """JAX ``LPProblem`` + preconditioner dict for a host system, every
    present system lowered to ``backend`` (a ``prefer`` of the JAX
    ``ell_from_scipy``: "dia", "dense", "ell", ...), or to the pair
    ``(eq backend, ineq backend)``."""
    import jax.numpy as jnp

    from pysparselp_tpu import problem as jpr

    def op(a, backend):
        if a is None:
            return None
        if backend == "dia":
            return jpr.DiaMatrix.from_scipy(a, dtype=dtype, allow_bf16=False)
        return jpr.ell_from_scipy(a, dtype=dtype, prefer=backend)

    def vec(v):
        return None if v is None else jnp.asarray(np.asarray(v, np.float64),
                                                  dtype)

    be_eq, be_in = backend if isinstance(backend, tuple) else (backend,) * 2
    a_eq, a_in = op(sys_["a_eq"], be_eq), op(sys_["a_ineq"], be_in)
    prob = jpr.LPProblem(
        c=vec(sys_["c"]), lb=vec(sys_["lb"]), ub=vec(sys_["ub"]),
        a_eq=a_eq, b_eq=vec(sys_["beq"]) if a_eq is not None else None,
        a_ineq=a_in, b_lower=None,
        b_upper=vec(sys_["b_ineq"]) if a_in is not None else None,
        n=len(sys_["c"]),
        m_eq=a_eq.nrows if a_eq is not None else 0,
        m_ineq=a_in.nrows if a_in is not None else 0)
    pre = {k: vec(v) for k, v in _preconditioners(sys_).items()}
    pre["theta"] = jnp.asarray(1.0, dtype)
    return prob, pre


def torch_pre(pre, dtype, device="cpu"):
    """The same preconditioner dict as torch tensors."""
    return {k: torch.as_tensor(np.array(v, np.float64), dtype=dtype,
                               device=device) for k, v in pre.items()}


def start_point(sys_, seed):
    """Seeded start ``(x, y_eq, y_ineq)`` for a host system, as numpy
    float64 arrays."""
    rng = np.random.RandomState(seed)
    x = np.clip(rng.rand(len(sys_["c"])), sys_["lb"], sys_["ub"])
    m_eq = sys_["a_eq"].shape[0] if sys_["a_eq"] is not None else 0
    m_in = sys_["a_ineq"].shape[0] if sys_["a_ineq"] is not None else 0
    return x, rng.rand(m_eq) * 0.1, rng.rand(m_in) * 0.1


def assert_close(got, want, rtol, atol=0.0, what=""):
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=rtol,
                                   atol=atol, err_msg=f"{what} output {i}")


def nan_signed_zero_case(sys_, seed):
    """``(sys_, (x, y_eq, y_ineq))``: a copy of a host system with one NaN
    cost, one NaN lower bound, and a run of costs, bounds, right-hand sides
    and start entries at -0.0 and +0.0, beside its start: the inputs on
    which a projection's handling of NaN and of signed zeros shows."""
    sys_ = dict(sys_)
    c = np.array(sys_["c"], np.float64)
    lb = np.array(sys_["lb"], np.float64)
    x, ye, yi = start_point(sys_, seed)
    c[0::5], c[1::5] = -0.0, 0.0
    lb[0::4], lb[2::4] = 0.0, -0.0
    x[0::3], x[1::3] = -0.0, 0.0
    c[3], lb[5] = np.nan, np.nan
    for name, y in (("beq", ye), ("b_ineq", yi)):
        if sys_[name] is not None:
            b = np.array(sys_[name], np.float64)
            b[0::3] = 0.0
            sys_[name] = b
            y[0::2], y[1::2] = -0.0, 0.0
    sys_.update(c=c, lb=lb)
    return sys_, (x, ye, yi)


def assert_same_bits(got, want, what=""):
    """Each output of ``got`` equals ``want``'s bit for bit: NaN at the same
    positions, every other entry with the same bits (signed zeros
    included).  Returns the NaN count and the -0.0 count of ``want``."""
    nans = negzeros = 0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().cpu(), w.detach().cpu()
        assert g.shape == w.shape and g.dtype == w.dtype, f"{what} output {i}"
        gn, wn = torch.isnan(g), torch.isnan(w)
        assert torch.equal(gn, wn), f"{what} output {i}: NaN positions differ"
        ints = {torch.float32: torch.int32, torch.float64: torch.int64}
        gb = g[~gn].contiguous().view(ints[g.dtype])
        wb = w[~wn].contiguous().view(ints[w.dtype])
        assert torch.equal(gb, wb), (
            f"{what} output {i}: {int((gb != wb).sum())} entries differ")
        nans += int(wn.sum())
        negzeros += int(((w == 0) & torch.signbit(w)).sum())
    return nans, negzeros


@contextlib.contextmanager
def one_rank_mesh():
    """A port :class:`~pysparselp_tpu_torch.parallel.mesh.Mesh` on the CPU
    over a one-rank gloo group in this process, the group destroyed on
    exit (so a later test of the same process finds none)."""
    import torch.distributed as dist

    from pysparselp_tpu_torch.parallel.mesh import Mesh

    with tempfile.TemporaryDirectory(prefix="pslp_mesh_") as tmp:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmp, "rendezvous"),
            world_size=1, rank=0)
        try:
            yield Mesh(device="cpu")
        finally:
            dist.destroy_process_group()
