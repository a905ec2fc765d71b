"""The port's dual ascent solvers (``solvers/dual_ascent.py``:
``dual_gradient_ascent`` and ``dual_coordinate_ascent`` in both modes)
against the JAX package's, on the CPU in float64: the SC105 and Potts
golden curves at their tolerance, live JAX solves of the blocked mode,
of DCA without greedy rounding and of an equality-only LP within 1e-9,
the bipartite matching example's DCA cost, and the verbatim graph
colouring."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from pysparselp_tpu.modeling import SparseLP as JaxLP
from pysparselp_tpu.utils.random_lp import generate_random_lp
from pysparselp_tpu_torch.examples import bipartite_matching as pbip
from pysparselp_tpu_torch.examples.potts import build_linear_program
from pysparselp_tpu_torch.modeling import SparseLP as TorchLP
from torch_port_helpers import sc105_lp

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
CURVES = ("itrn_curve", "pobj_curve", "dobj_curve", "max_violated_equality",
          "max_violated_inequality")


def _port_lp(jax_lp):
    """The same model as a port SparseLP (host state copied over)."""
    lp = TorchLP.__new__(TorchLP)
    lp.__dict__ = copy.deepcopy(jax_lp).__dict__
    return lp


def _golden(name, method):
    with open(os.path.join(GOLDENS, f"{name}_curves.json")) as f:
        return json.load(f)[method]


@pytest.mark.parametrize("method,run", [
    ("dual_gradient_ascent", dict(nb_iter=400, nb_iter_plot=100)),
    ("dual_coordinate_ascent", dict(nb_iter=40, nb_iter_plot=10)),
])
def test_reproduces_sc105_golden(method, run):
    """``tests/goldens/sc105_curves.json`` as ``tests/test_golden_curves.py``
    checks it (DCA with greedy rounding, its default)."""
    ref = _golden("sc105", method)
    lp, _gt = sc105_lp(port=True)
    lp.solve(method=method, device="cpu", **run)
    assert [int(i) for i in lp.itrn_curve] == ref["itrn"]
    for key, attr in (("pobj", "pobj_curve"),
                      ("viol_eq", "max_violated_equality"),
                      ("viol_ineq", "max_violated_inequality")):
        np.testing.assert_allclose([float(v) for v in getattr(lp, attr)],
                                   ref[key], rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("size,method,run", [
    (20, "dual_gradient_ascent", dict(nb_iter=300, nb_iter_plot=100)),
    (20, "dual_coordinate_ascent", dict(nb_iter=9, nb_iter_plot=3)),
    (50, "dual_gradient_ascent", dict(nb_iter=150, nb_iter_plot=50)),
])
def test_reproduces_potts_golden(size, method, run):
    """``tests/goldens/potts{20,50}_curves.json`` as
    ``tests/test_golden_potts.py`` checks them."""
    ref = _golden(f"potts{size}", method)
    lp, gt, idx, _ = build_linear_program(size, 0.5, 500, seed=1)
    lp.solve(method=method, ground_truth=gt, ground_truth_indices=idx,
             device="cpu", **run)
    assert [int(i) for i in lp.itrn_curve] == ref["itrn"]
    np.testing.assert_allclose(lp.distance_to_ground_truth, ref["dist"],
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(lp.pobj_curve, ref["pobj"], rtol=1e-7,
                               atol=1e-9)


def _one_sided():
    """``tests/test_dual_ascent.py``'s ``one_sided_problem``."""
    lp, _ = generate_random_lp(nbvar=30, n_eq=2, n_ineq=30, sparsity=0.2,
                               seed=10)
    lp2 = copy.deepcopy(lp)
    lp2.convert_to_one_sided_inequality_system()
    return lp2


def _sc105_jax():
    return sc105_lp(port=False)[0]


def _equality_only():
    return generate_random_lp(nbvar=20, n_eq=8, n_ineq=0, sparsity=0.4,
                              seed=7)[0]


LIVE = {
    "dca_blocked": (_one_sided, "dual_coordinate_ascent",
                    dict(nb_iter=50, nb_iter_plot=5, mode="blocked")),
    "dca_blocked_sc105": (_sc105_jax, "dual_coordinate_ascent",
                          dict(nb_iter=30, nb_iter_plot=10, mode="blocked")),
    "dca_no_greedy_round": (_one_sided, "dual_coordinate_ascent",
                            dict(nb_iter=50, nb_iter_plot=5,
                                 use_greedy_round=False)),
    "dca_no_greedy_round_sc105": (_sc105_jax, "dual_coordinate_ascent",
                                  dict(nb_iter=30, nb_iter_plot=10,
                                       use_greedy_round=False)),
    "dca_seed": (_one_sided, "dual_coordinate_ascent",
                 dict(nb_iter=20, nb_iter_plot=4, seed=7)),
    "dga": (_one_sided, "dual_gradient_ascent",
            dict(nb_iter=500, nb_iter_plot=100)),
    "dga_equality_only": (_equality_only, "dual_gradient_ascent",
                          dict(nb_iter=200, nb_iter_plot=50)),
    "dga_stop_tol": (_one_sided, "dual_gradient_ascent",
                     dict(nb_iter=500, nb_iter_plot=50, stop_tol=1e-3)),
}


@pytest.mark.parametrize("case", sorted(LIVE))
def test_matches_live_jax_solve(case):
    make, method, run = LIVE[case]
    jlp = make()
    plp = _port_lp(jlp)
    xj, _ = jlp.solve(method=method, **run)
    xp, _ = plp.solve(method=method, device="cpu", **run)
    np.testing.assert_allclose(xp, xj, rtol=1e-9, atol=1e-9)
    for attr in CURVES:
        np.testing.assert_allclose(
            np.asarray(getattr(plp, attr), float),
            np.asarray(getattr(jlp, attr), float), rtol=1e-9, atol=1e-9,
            err_msg=f"{case}: {attr}")


def _matching(mod, lp_cls):
    """The LP of ``examples/bipartite_matching.py::run`` (n = 50, seed 2)."""
    np.random.seed(2)
    cost = -np.random.rand(50, 50)
    lp = lp_cls()
    mod.add_bipartite_constraint(
        lp, lp.add_variables_array(cost.shape, 0, 1, cost))
    return lp


def test_bipartite_example_dca_cost_equals_jax():
    """The example's DCA run (200 sweeps, greedy rounding) gives the JAX
    package's cost, through the verbatim example module."""
    from pysparselp_tpu.examples import bipartite_matching as jbip

    run = dict(method="dual_coordinate_ascent", nb_iter=200, nb_iter_plot=50,
               max_time=40)
    jlp = _matching(jbip, JaxLP)
    plp = _matching(pbip, TorchLP)
    xj, _ = jlp.solve(**run)
    xp, _ = plp.solve(device="cpu", **run)
    assert float(plp.costsvector @ xp) == float(jlp.costsvector @ xj)
    np.testing.assert_array_equal(xp, xj)


def test_color_rows_match_jax():
    from pysparselp_tpu.solvers.dual_ascent import _color_rows as jcolor
    from pysparselp_tpu_torch.solvers.dual_ascent import _color_rows

    lp = _port_lp(_sc105_jax())
    for a in (lp.a_inequalities.tocsr(), lp.a_equalities.tocsr(),
              build_linear_program(12, 0.5, 500)[0].a_inequalities.tocsr()):
        got, want = _color_rows(a), jcolor(a)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_dga_warm_start_duals_match_jax():
    """``y_eq`` / ``y_ineq`` given by the caller replace the seeded random
    start in both packages."""
    from pysparselp_tpu.solvers.dual_ascent import \
        dual_gradient_ascent as jdga
    from pysparselp_tpu_torch.solvers.dual_ascent import dual_gradient_ascent

    jlp = _one_sided()
    rng = np.random.RandomState(4)
    y_eq = -rng.rand(jlp.a_equalities.shape[0])
    y_in = rng.rand(jlp.a_inequalities.shape[0])
    want = jdga(None, jlp, nb_max_iter=60, nb_iter_plot=20, y_eq=y_eq,
                y_ineq=y_in)
    got = dual_gradient_ascent(None, _port_lp(jlp), nb_max_iter=60,
                               nb_iter_plot=20, y_eq=y_eq, y_ineq=y_in,
                               device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-9, atol=1e-12)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        _port_lp(_one_sided()).solve(method="dual_coordinate_ascent",
                                     nb_iter=1, mode="parallel",
                                     device="cpu")
