"""The port's Mehrotra interior point (``solvers/mehrotra.py``) against the
JAX package's, on the CPU in float64: the SC105 golden curves, ``mpc_sol``
against JAX's ``mpc_sol`` on a random LP and on Potts-12 (dense Cholesky
and CG paths), the vendored netlib problems, the float64 warning, the
retry after a failed Cholesky, and what stays out of this slice."""

import copy
import json
import os
import warnings

import numpy as np
import pytest
import scipy.sparse
import torch

import chip_smoke
from pysparselp_tpu.solvers.mehrotra import mpc_sol as jax_mpc_sol
from pysparselp_tpu_torch.examples import sparse_inv_covariance as pclime
from pysparselp_tpu_torch.examples.potts import build_linear_program
from pysparselp_tpu_torch.solvers import mehrotra as pm
from pysparselp_tpu_torch.utils.random_lp import generate_random_lp
from torch_port_helpers import one_rank_mesh, sc105_lp

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _slack(lp):
    """The standard form ``dispatch`` hands ``mpc_sol``."""
    lp = copy.deepcopy(lp)
    lp.remove_fixed_variables()
    lp.convert_to_slack_form()
    return lp.a_equalities.tocsr(), lp.b_equalities, lp.costsvector


def _rel(got, want):
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def test_reproduces_sc105_golden():
    """``tests/goldens/sc105_curves.json["mehrotra"]`` as
    ``tests/test_golden_curves.py`` checks it: equal ``itrn``, curves
    within rtol 1e-7, atol 1e-9."""
    with open(os.path.join(REPO, "tests", "goldens",
                           "sc105_curves.json")) as f:
        ref = json.load(f)["mehrotra"]
    lp, _gt = sc105_lp(port=True)
    lp.solve(method="mehrotra", nb_iter=100, nb_iter_plot=1, device="cpu")
    assert [int(i) for i in lp.itrn_curve] == ref["itrn"]
    for key, attr in (("pobj", "pobj_curve"),
                      ("viol_eq", "max_violated_equality"),
                      ("viol_ineq", "max_violated_inequality")):
        np.testing.assert_allclose([float(v) for v in getattr(lp, attr)],
                                   ref[key], rtol=1e-7, atol=1e-9)


def _random():
    return generate_random_lp(nbvar=40, n_eq=10, n_ineq=30, sparsity=0.3,
                              seed=3)[0]


def _potts12():
    return build_linear_program(12, 0.5, 500)[0]


@pytest.mark.parametrize("case,make,kw", [
    ("random_dense", _random, {}),
    ("random_cg", _random, dict(dense_threshold=0)),
    ("potts12_dense", _potts12, {}),
])
def test_mpc_sol_matches_jax(case, make, kw):
    """``(f, x, y, s, niter)`` of the port's ``mpc_sol`` against JAX's on
    the same standard form: niter equal, the rest within 1e-8 relative
    (measured ≤ 4e-11)."""
    a, b, c = _slack(make())
    if not kw:
        assert a.shape[0] <= 4096     # the dense Cholesky path
    want = jax_mpc_sol(a, b, c, **kw)
    got = pm.mpc_sol(a, b, c, device="cpu", **kw)
    assert got[4] == want[4]
    assert abs(got[0] - want[0]) <= 1e-8 * max(1.0, abs(want[0]))
    for g, w in zip(got[1:4], want[1:4]):
        assert _rel(g, w) <= 1e-8


def test_mpc_sol_cg_path_matches_jax_on_potts12():
    """Potts-12 with ``dense_threshold=0`` (CG on the normal equations).
    The initial point and first IPM iteration agree within 1e-8 relative
    (measured 6e-15).  From the third iteration on each CG solve runs into
    its 200-step cap, and a truncated Krylov iterate moves with the
    summation order: the port's own run with the dense operator in place of
    CSR moves y and s by 1e-4.  So the whole solve is held where the LP
    fixes the answer: niter equal, f within 1e-8 relative, x within 1e-7
    (measured 1.3e-10 and 1.0e-9) and the dual objective bᵀy within 1e-8
    (measured 7e-13)."""
    a, b, c = _slack(_potts12())
    assert a.shape[0] <= 4096
    want = jax_mpc_sol(a, b, c, dense_threshold=0, max_iter=2)
    got = pm.mpc_sol(a, b, c, dense_threshold=0, max_iter=2, device="cpu")
    assert got[4] == want[4] == 1
    for g, w in zip(got[1:4], want[1:4]):
        assert _rel(g, w) <= 1e-8
    want = jax_mpc_sol(a, b, c, dense_threshold=0)
    got = pm.mpc_sol(a, b, c, dense_threshold=0, device="cpu")
    assert got[4] == want[4]
    assert abs(got[0] - want[0]) <= 1e-8 * max(1.0, abs(want[0]))
    assert _rel(got[1], want[1]) <= 1e-7
    assert abs(b @ got[2] - b @ want[2]) <= 1e-8 * abs(b @ want[2])


@pytest.mark.parametrize("name", ["AFIRO", "KB2", "SC50A", "SC50B"])
def test_netlib_problems_reach_their_optimum(name):
    """The other vendored netlib problems (built as SC105 is), float64,
    100 iterations: the objective within 1e-7 of the perPlex optimum's and
    x within 1e-8 of the JAX package's.  The perPlex point is reached
    (mean |x − x*| < 1e-5) where the optimum is a vertex alone; AFIRO's
    optimal face holds other points (both packages end 16.0 from x*) and
    KB2 ends 1.6e-5 from it in both."""
    import pysparselp_tpu.io.netlib as jnetlib
    from pysparselp_tpu.modeling import SparseLP as JaxLP

    lp, gt = chip_smoke.netlib_lp(name)
    x, _ = lp.solve(method="mehrotra", nb_iter=100, device="cpu")
    opt = lp.costsvector @ gt
    assert abs(lp.costsvector @ x - opt) <= 1e-7 * abs(opt)
    d = jnetlib.get_problem(name)
    jlp = JaxLP()
    jlp.add_variables_array(
        len(d["cost_vector"]), lower_bounds=d["lower_bounds"],
        upper_bounds=np.minimum(d["upper_bounds"], np.max(gt) * 2),
        costs=d["cost_vector"])
    jlp.add_equality_constraints_sparse(d["a_eq"], d["b_eq"])
    jlp.add_inequality_constraints_sparse(d["a_ineq"], d["b_lower"],
                                          d["b_upper"])
    jlp.convert_to_one_sided_inequality_system()
    xj, _ = jlp.solve(method="mehrotra", nb_iter=100)
    assert _rel(x, xj) <= 1e-8
    if name in ("SC50A", "SC50B"):
        assert np.mean(np.abs(x - gt)) < 1e-5


def test_mehrotra_warns_below_float64():
    """``tests/test_solvers_random.py::test_mehrotra_warns_below_float64``
    on the port."""
    a = scipy.sparse.eye(4, format="csr")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        pm.mpc_sol(a, np.ones(4), np.ones(4), max_iter=2, dtype=np.float32,
                   device="cpu")
    assert any("float64" in str(w.message) for w in rec)


def test_failed_cholesky_goes_to_the_retry(monkeypatch):
    """A rank-deficient A (duplicated rows) in float32, where the ridge is
    below the rounding: the Cholesky fails (``cholesky_ex`` reports it, the
    factor is NaN), and ``mpc_sol`` retries the iteration with the ridge
    ×100 four times, then stops, without raising; the JAX package ends the
    same way (f NaN, niter 0)."""
    rng = np.random.RandomState(0)
    a = rng.rand(8, 20) * (rng.rand(8, 20) < 0.5)
    a[4:] = a[:4]
    a = scipy.sparse.csr_matrix(a)
    b, c = a @ rng.rand(20), rng.rand(20)
    boosts, factored = [], []
    ipm, chol = pm._ipm_iteration, pm.cholesky_upper

    def spy_ipm(*args, **kw):
        boosts.append(args[5])
        return ipm(*args, **kw)

    def spy_chol(m):
        u, ok = chol(m)
        factored.append(bool(ok))
        return u, ok

    monkeypatch.setattr(pm, "_ipm_iteration", spy_ipm)
    monkeypatch.setattr(pm, "cholesky_upper", spy_chol)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = pm.mpc_sol(a, b, c, dtype=np.float32, device="cpu")
        want = jax_mpc_sol(a, b, c, dtype=np.float32)
    assert boosts == [1.0, 1e2, 1e4, 1e6, 1e8]
    assert not any(factored)
    assert got[4] == want[4] == 0
    assert np.isnan(got[0]) and np.isnan(want[0])


def test_mesh_names_its_roadmap_item():
    """``mesh=`` (ROADMAP M9, once refused here) runs the column-sharded
    interior point: SC105 on a one-rank gloo mesh against the JAX
    package's ``lp.solve(mesh=...)`` on the conftest's 8 CPU devices,
    float64, 30 IPM iterations: x within 1e-8 relative to its largest
    entry, the same IPM iterations."""
    from pysparselp_tpu.parallel.mesh import default_mesh

    lp, _ = sc105_lp(port=True)
    jlp, _ = sc105_lp()
    run = dict(method="mehrotra", nb_iter=30, nb_iter_plot=1,
               dtype=np.float64)
    with one_rank_mesh() as mesh:
        got, _ = lp.solve(device="cpu", mesh=mesh, **run)
    want, _ = jlp.solve(mesh=default_mesh(8), **run)
    np.testing.assert_allclose(got, want, atol=1e-8 * np.abs(want).max())
    assert lp.itrn_curve == jlp.itrn_curve


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device works")
    a = scipy.sparse.eye(4, format="csr")
    with pytest.raises(RuntimeError, match="cuda"):
        pm.mpc_sol(a, np.ones(4), np.ones(4), dtype=np.float64)


def test_clime_example_defaults_to_mehrotra():
    """The CLIME example's ``run`` defaults to ``method="mehrotra"``, as
    the JAX example's does."""
    import inspect

    import pysparselp_tpu.examples.sparse_inv_covariance as jclime

    for mod in (pclime, jclime):
        assert inspect.signature(mod.run).parameters["method"].default == \
            "mehrotra"
