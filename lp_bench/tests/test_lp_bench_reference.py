"""The plain reference on tiny grids on the CPU: its LP is the modeling
API's, its optimum is the LP's, its iterations converge to it."""

import numpy as np
import pytest
import scipy.optimize
import torch

from lp_bench.lib import inputs
from lp_bench.reference import potts as ref

CFG = {"image_size": 7, "coef_mul": 500, "coef_potts": 0.5}


def _image(seed=3, count=1):
    return inputs.unary_images(CFG, seed, count)


def test_lp_is_the_modeling_apis():
    from pysparselp_tpu_torch.examples.potts import ImageLP
    from pysparselp_tpu_torch.solvers import _csr

    u = _image()[0]
    lp = ImageLP()
    idx = lp.add_variables_array(shape=u.shape + (1,), lower_bounds=0,
                                 upper_bounds=1, costs=u[:, :, None] / 500)
    lp.add_pott_model(idx[:, :, 0], 250 / 500)
    plp = ref.PottsLP(7, 7, 0.5, 500)
    assert abs(_csr(lp.a_inequalities) - plp.matrix).max() == 0
    np.testing.assert_array_equal(lp.costsvector, plp.costs(u))
    np.testing.assert_array_equal(lp.upper_bounds, plp.ub)
    np.testing.assert_array_equal(lp.b_upper, plp.b)
    assert ref.lp_dims(7, 7) == (plp.matrix.nnz, plp.n, plp.m)


@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 5])
def test_graph_cut_is_the_lp_optimum(seed):
    u = _image(seed)[0]
    plp = ref.PottsLP(7, 7, 0.5, 500)
    energy, labels = ref.graph_cut_energy(plp, u)
    res = scipy.optimize.linprog(plp.costs(u), A_ub=plp.matrix, b_ub=plp.b,
                                 bounds=list(zip(plp.lb, plp.ub)),
                                 method="highs")
    assert res.status == 0
    assert energy == pytest.approx(res.fun, abs=1e-9)
    assert ref.pixel_energy(plp, labels, u) == pytest.approx(energy)


def test_cp_converges_and_batches_column_by_column():
    u = _image(4, count=3)
    plp = ref.PottsLP(7, 7, 0.5, 500)
    xb, cb = ref.cp_run(plp, u, 20000, chunk=5000)
    for f in range(3):
        x1, c1 = ref.cp_run(plp, u[f:f + 1], 20000, chunk=5000)
        np.testing.assert_allclose(xb[f], x1[0], rtol=0, atol=1e-12)
        np.testing.assert_allclose(cb["energy1"][:, f], c1["energy1"][:, 0],
                                   rtol=1e-12)
        e_star, _ = ref.graph_cut_energy(plp, u[f])
        assert ref.pixel_energy(plp, xb[f, :plp.n_pix], u[f]) == \
            pytest.approx(e_star, abs=1e-4)
        cost, viol = plp.evaluate(xb[f], u[f])
        assert viol[0] < 1e-4


def test_stop_tol_freezes_converged_columns():
    u = _image(5, count=2)
    plp = ref.PottsLP(7, 7, 0.5, 500)
    _, c = ref.cp_run(plp, u, 20000, chunk=500, stop_tol=1e-4)
    assert c["itrn"][-1] < 20000


def test_bfloat16_runs():
    u = _image(6)
    plp = ref.PottsLP(7, 7, 0.5, 500)
    x, c = ref.cp_run(plp, u, 200, dtype=torch.bfloat16, chunk=100)
    assert x.dtype == np.float64 and np.isfinite(c["energy1"]).all()
