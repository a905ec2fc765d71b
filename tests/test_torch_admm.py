"""The port's ADMM solvers (``solvers/admm.py``: ``admm`` and ``admm2``)
against the JAX package's, on the CPU in float64: the SC105 golden curves,
live solves on ``tests/test_admm.py``'s random LP (dense and CG Schur
paths, adaptive penalty, ``stop_tol``, ``light_metrics``, equality-only),
the reference's k-medians constant through the verbatim example, the
verbatim basis-pursuit example, and what stays out of this slice."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from pysparselp_tpu.utils.random_lp import generate_random_lp
from pysparselp_tpu_torch.examples import basis_pursuit_denoising as pbpdn
from pysparselp_tpu_torch.examples import kmedians as pkmedians
from pysparselp_tpu_torch.modeling import SparseLP as TorchLP
from pysparselp_tpu_torch.solvers.admm import lp_admm
from torch_port_helpers import one_rank_mesh, sc105_lp

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVES = ("itrn_curve", "pobj_curve", "max_violated_equality",
          "max_violated_inequality")


def _port_lp(jax_lp):
    """The same model as a port SparseLP (host state copied over)."""
    lp = TorchLP.__new__(TorchLP)
    lp.__dict__ = copy.deepcopy(jax_lp).__dict__
    return lp


def _curves(lp):
    return {k: [float(v) for v in getattr(lp, k)] for k in CURVES}


@pytest.mark.parametrize("method", ["admm", "admm2"])
def test_reproduces_sc105_golden(method):
    """``tests/goldens/sc105_curves.json`` (400 iterations, a checkpoint
    every 100) as ``tests/test_golden_curves.py`` checks it."""
    with open(os.path.join(REPO, "tests", "goldens",
                           "sc105_curves.json")) as f:
        ref = json.load(f)[method]
    lp, _gt = sc105_lp(port=True)
    lp.solve(method=method, nb_iter=400, nb_iter_plot=100, device="cpu")
    assert [int(i) for i in lp.itrn_curve] == ref["itrn"]
    for key, attr in (("pobj", "pobj_curve"),
                      ("viol_eq", "max_violated_equality"),
                      ("viol_ineq", "max_violated_inequality")):
        np.testing.assert_allclose([float(v) for v in getattr(lp, attr)],
                                   ref[key], rtol=1e-7, atol=1e-9)


def _random_ineq():
    """``tests/test_admm.py``'s ``random_problem``."""
    lp, _ = generate_random_lp(nbvar=30, n_eq=2, n_ineq=30, sparsity=0.2,
                               seed=10)
    lp2 = copy.deepcopy(lp)
    lp2.convert_to_one_sided_inequality_system()
    return lp2


def _random_eq():
    """``tests/test_admm.py::test_admm_equality_only``'s LP."""
    return generate_random_lp(nbvar=20, n_eq=8, n_ineq=0, sparsity=0.4,
                              seed=3)[0]


LIVE_CASES = {
    "admm": (_random_ineq, "admm", {}),
    "admm_stop_tol": (_random_ineq, "admm", dict(stop_tol=1e-2)),
    "admm_light_metrics": (_random_ineq, "admm", dict(light_metrics=True)),
    "admm_equality_only": (_random_eq, "admm", {}),
    "admm2_dense": (_random_ineq, "admm2", {}),
    # the CG Schur path runs up to 100 CG steps an iteration: 300 of them
    "admm2_cg": (_random_ineq, "admm2", dict(dense_threshold=0,
                                             nb_iter=300)),
    "admm2_adaptive_rho": (_random_ineq, "admm2", dict(adaptive_rho=True)),
    "admm2_stop_tol": (_random_ineq, "admm2", dict(stop_tol=1e-2)),
    "admm2_preconditioned": (_random_ineq, "admm2",
                             dict(use_preconditioning=True)),
    "admm2_equality_only": (_random_eq, "admm2", {}),
}


@pytest.mark.parametrize("case", sorted(LIVE_CASES))
def test_live_solve_matches_jax(case):
    """The same LP through both packages' ``SparseLP.solve``: equal
    checkpoints, curves and x within 1e-9."""
    make, method, kw = LIVE_CASES[case]
    jlp = make()
    plp = _port_lp(jlp)
    run = dict(dict(method=method, nb_iter=1500, nb_iter_plot=100), **kw)
    xj, _ = jlp.solve(**run)
    xp, _ = plp.solve(device="cpu", **run)
    got, want = _curves(plp), _curves(jlp)
    assert got["itrn_curve"] == want["itrn_curve"]
    if "stop_tol" in kw:
        assert len(want["itrn_curve"]) < 15      # the tolerance stopped it
    for k in CURVES[1:]:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(xp, xj, rtol=1e-9, atol=1e-9)


def test_kmedians_cost_matches_reference_constant(monkeypatch):
    """``tests/test_examples.py::test_kmedians_cost_matches_reference_
    constant`` through the port's verbatim example (which calls
    ``lp.solve`` without ``device=``: the test makes the CPU the default
    instead of editing it)."""
    solve = TorchLP.solve
    monkeypatch.setattr(TorchLP, "solve", lambda self, *a, **kw: solve(
        self, *a, **{"device": "cpu", **kw}))
    cost = pkmedians.run(method="admm", nb_iter=1000)
    assert abs(cost - 238.9849948936172) < 1e-6


def test_basis_pursuit_denoising_beats_generator(monkeypatch):
    """``tests/test_examples.py::test_basis_pursuit_denoising_beats_
    generator`` through the port's verbatim example (CP-PPD), and its
    costs against the JAX example's."""
    from pysparselp_tpu.examples.basis_pursuit_denoising import run

    solve = TorchLP.solve
    monkeypatch.setattr(TorchLP, "solve", lambda self, *a, **kw: solve(
        self, *a, **{"device": "cpu", **kw}))
    cost_gt, cost_opt = pbpdn.run(nb_iter=20000)
    assert cost_opt <= cost_gt + 1e-6
    want = run(nb_iter=20000)
    np.testing.assert_allclose((cost_gt, cost_opt), want, rtol=1e-9)


@pytest.mark.parametrize("method,kw,item", [
    # inner="gauss_seidel" is the host mode, which ignores mesh= as the JAX
    # package's does; the other two run row-sharded (sharded_admm.py)
    ("admm", dict(inner="gauss_seidel", mesh=True), "M9"),
    ("admm", dict(mesh=True), "M9"),
    ("admm2", dict(mesh=True), "M9"),
])
def test_unported_options_name_their_roadmap_item(method, kw, item):
    """``mesh=`` (ROADMAP ``item``, once refused here) runs: SC105 on a
    one-rank gloo mesh against the JAX package's ``lp.solve(mesh=...)`` on
    the conftest's 8 CPU devices, float64, 20 iterations: x within 1e-9."""
    from pysparselp_tpu.parallel.mesh import default_mesh

    assert item == "M9"
    lp, _ = sc105_lp(port=True)
    jlp, _ = sc105_lp()
    run = dict(method=method, nb_iter=20, nb_iter_plot=10, dtype=np.float64)
    with one_rank_mesh() as mesh:
        got, _ = lp.solve(device="cpu", **run, **dict(kw, mesh=mesh))
    want, _ = jlp.solve(**run, **dict(kw, mesh=default_mesh(8)))
    np.testing.assert_allclose(got, want, atol=1e-9)
    assert lp.itrn_curve == [10, 20]


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device works")
    lp = _random_eq()
    with pytest.raises(RuntimeError, match="cuda"):
        lp_admm(lp.costsvector, lp.a_equalities.tocsr(), lp.b_equalities,
                None, None, None, lp.lower_bounds, lp.upper_bounds,
                nb_iter=2)
