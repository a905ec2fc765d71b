"""The examples' contracts on the port: the counterparts of
``tests/test_examples.py`` (the reference's example tests) at the JAX
tests' bars, on the CPU in float64 (float32 where the JAX test asks for
it).  The verbatim examples call ``lp.solve`` without ``device=``, so the
tests make the CPU the default device instead of editing them.  The Potts
case goes through the port's ``examples/potts.py::run``; CLIME feeds the
JAX example's scikit-learn samples through the port's ``clime_lp`` (on the
port's own numpy data the interior point stalls, as in the JAX package)."""

import inspect

import numpy as np
import pytest
import torch

import pysparselp_tpu.examples.potts as jpotts
import pysparselp_tpu_torch.examples.potts as ppotts
from pysparselp_tpu_torch.modeling import SparseLP as TorchLP

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_default(monkeypatch):
    solve = TorchLP.solve
    monkeypatch.setattr(TorchLP, "solve", lambda self, *a, **kw: solve(
        self, *a, **{"device": "cpu", **kw}))


def test_kmedians_cost_matches_reference_constant():
    from pysparselp_tpu_torch.examples.kmedians import run

    cost = run(method="admm", nb_iter=1000)
    assert abs(cost - 238.9849948936172) < 1e-6


def test_l1_svm_accuracies():
    from pysparselp_tpu_torch.examples.l1_svm import run

    acc = run(nb_iter=2000)
    assert acc["chambolle_pock_ppd"] >= 99.3
    assert acc["admm"] >= 99.3
    assert acc["admm2"] >= 99.7
    assert acc["admm_blocks"] >= 99.7


def test_potts_graph_cut_oracle_is_lp_optimum():
    lp, gt, idx, _ = ppotts.build_linear_program(15, 0.5, 500)
    x_lp = lp.solve(method="scipy_simplex", get_timing=False)
    # binary Potts LP relaxation is tight: LP optimum == min-cut
    assert np.mean(np.abs(gt - x_lp[idx])) < 1e-9


def test_multilabel_potts_model():
    lp, idx = ppotts.build_multilabel_linear_program(12, n_labels=3, seed=1)
    ref = lp.solve(method="scipy_simplex", get_timing=False)
    sol, _ = lp.solve(method="chambolle_pock_ppd", nb_iter=6000,
                      nb_iter_plot=3000, dtype=np.float32)
    label_sums = sol[idx].sum(axis=2)
    np.testing.assert_allclose(label_sums, 1.0, atol=1e-3)
    assert lp.cost(sol) < lp.cost(ref) + 0.05 * abs(lp.cost(ref))
    assert lp.max_constraint_violation(sol) < 1e-3


def test_potts_solvers_converge_to_graph_cut():
    """Through the port's ``run``, a verbatim copy of the JAX example's."""
    assert inspect.getsource(ppotts.run) == inspect.getsource(jpotts.run)
    curves = ppotts.run(
        display=False, image_size=20, max_time=60,
        methods=["chambolle_pock_ppd", "mehrotra"],
        nb_iter=200000, nb_iter_plot=50000,
    )
    assert set(curves) == {"chambolle_pock_ppd", "mehrotra"}
    for method, curve in curves.items():
        assert curve[-1] < 0.05, (method, curve)


def test_sparse_inv_covariance_quality():
    """The JAX example's data (scikit-learn's sparse SPD precision, which
    the card's machine lacks) through the port's ``clime_lp`` and the
    port's interior point, post-processed as the example's ``run``."""
    from pysparselp_tpu.examples.sparse_inv_covariance import make_data
    from pysparselp_tpu_torch.examples.sparse_inv_covariance import clime_lp

    x, prec, _cov = make_data()
    lp, ids = clime_lp(x, 0.15)
    sol = lp.solve(method="mehrotra", nb_iter=6000, max_time=np.inf,
                   nb_iter_plot=1500)[0]
    lp_prec = sol[ids]
    lp_prec = 0.5 * (lp_prec + lp_prec.T)
    lp_prec = lp_prec * (np.abs(lp_prec) > 1e-8)
    sum_abs_diff = float(np.sum(np.abs(lp_prec - prec)))
    nb_zeros = int(np.sum(lp_prec == 0))
    assert sum_abs_diff < 14.02
    assert nb_zeros >= 216


def test_bipartite_matching_costs_agree():
    from pysparselp_tpu_torch.examples.bipartite_matching import run

    results = run(n=20, seed=2)
    ref = results["mehrotra"]
    assert abs(results["chambolle_pock_ppd"] - ref) < 1e-2 * abs(ref)


def test_basis_pursuit_denoising_beats_generator():
    from pysparselp_tpu_torch.examples.basis_pursuit_denoising import run

    cost_gt, cost_opt = run(nb_iter=20000)
    assert cost_opt <= cost_gt + 1e-6
