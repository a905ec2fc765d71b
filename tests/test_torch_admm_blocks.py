"""The port's consensus ADMM (``solvers/admm_blocks.py``) against the JAX
package's, on the CPU in float64: the SC105 golden curves, live solves on
``tests/test_admm.py``'s ``blocky_problem`` (with ``light_metrics``,
``stop_tol`` and ``max_time``), the L1-SVM example's accuracy bar, the
consensus map's sum against JAX's scatter-add, and the verbatim block
builder."""

import copy
import json
import os

import numpy as np
import pytest
import scipy.sparse
import torch

from pysparselp_tpu.modeling import SparseLP as JaxLP
from pysparselp_tpu_torch.modeling import SparseLP as TorchLP
from pysparselp_tpu_torch.solvers import admm_blocks as pblocks
from torch_port_helpers import one_rank_mesh, sc105_lp

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVES = ("itrn_curve", "pobj_curve", "dobj_curve", "max_violated_equality",
          "max_violated_inequality")


def _port_lp(jax_lp):
    lp = TorchLP.__new__(TorchLP)
    lp.__dict__ = copy.deepcopy(jax_lp).__dict__
    return lp


def _blocky():
    """``tests/test_admm.py``'s ``blocky_problem`` (4 row blocks)."""
    np.random.seed(5)
    lp = JaxLP()
    lp.add_variables_array(40, 0, 1, costs=np.random.randn(40))
    for _k in range(4):
        cols = np.zeros((5, 3), dtype=int)
        for r in range(5):
            cols[r] = np.random.choice(40, 3, replace=False)
        lp.add_inequality_constraints(
            cols, np.ones((5, 3)), lower_bounds=None, upper_bounds=2.0
        )
    return lp


def test_reproduces_sc105_golden():
    with open(os.path.join(REPO, "tests", "goldens",
                           "sc105_curves.json")) as f:
        ref = json.load(f)["admm_blocks"]
    lp, _gt = sc105_lp(port=True)
    lp.solve(method="admm_blocks", nb_iter=200, nb_iter_plot=50,
             device="cpu")
    assert [int(i) for i in lp.itrn_curve] == ref["itrn"]
    for key, attr in (("pobj", "pobj_curve"),
                      ("viol_eq", "max_violated_equality"),
                      ("viol_ineq", "max_violated_inequality")):
        np.testing.assert_allclose([float(v) for v in getattr(lp, attr)],
                                   ref[key], rtol=1e-7, atol=1e-9)


LIVE = {
    "plain": dict(nb_iter=2000, nb_iter_plot=500),
    "alpha_gamma": dict(nb_iter=1000, nb_iter_plot=250, alpha=1.5,
                        gamma_ineq=1.3),
    "stop_tol": dict(nb_iter=5000, nb_iter_plot=100, stop_tol=1e-4),
}


@pytest.mark.parametrize("case", sorted(LIVE))
def test_matches_live_jax_solve(case):
    run = dict(method="admm_blocks", **LIVE[case])
    jlp = _blocky()
    assert len(jlp.a_inequalities.blocks) == 4
    plp = _port_lp(jlp)
    xj, _ = jlp.solve(**run)
    xp, _ = plp.solve(device="cpu", **run)
    assert list(plp.itrn_curve) == list(jlp.itrn_curve)
    if "stop_tol" in run:
        assert plp.itrn_curve[-1] < run["nb_iter"]   # the tolerance stopped it
    for attr in CURVES[1:]:
        np.testing.assert_allclose(getattr(plp, attr), getattr(jlp, attr),
                                   rtol=1e-9, atol=1e-9, err_msg=attr)
    np.testing.assert_allclose(xp, xj, rtol=1e-9, atol=1e-9)


def test_light_metrics_passes_the_solution_unfetched():
    """``light_metrics``: the callback gets x as a tensor (one fetch a
    checkpoint), and the run equals the full-metrics one."""
    plp = _port_lp(_blocky())
    seen = []

    def cb(niter, x, e1, e2, dur, veq, vineq):
        seen.append((niter, x))

    cb.wants_solution = False
    plp.solve(method="admm_blocks", nb_iter=400, nb_iter_plot=100,
              device="cpu", light_metrics=True, callback_func=cb)
    assert [n for n, _ in seen] == [100, 200, 300, 400]
    assert all(isinstance(x, torch.Tensor) for _, x in seen)
    xj, _ = _blocky().solve(method="admm_blocks", nb_iter=400,
                            nb_iter_plot=100)
    np.testing.assert_allclose(seen[-1][1].numpy(), xj, rtol=1e-9,
                               atol=1e-9)


def test_max_time_stops_after_the_first_chunk():
    plp = _port_lp(_blocky())
    plp.solve(method="admm_blocks", nb_iter=1000, nb_iter_plot=100,
              max_time=0, device="cpu")
    assert list(plp.itrn_curve) == [100]


def test_l1_svm_accuracy(monkeypatch):
    """``tests/test_examples.py::test_l1_svm_accuracies``'s
    ``admm_blocks`` bar through the port's verbatim example (which calls
    ``lp.solve`` without ``device=``: the test makes the CPU the default
    instead of editing it)."""
    from pysparselp_tpu_torch.examples import l1_svm

    solve = TorchLP.solve
    monkeypatch.setattr(TorchLP, "solve", lambda self, *a, **kw: solve(
        self, *a, **{"device": "cpu", **kw}))
    acc = l1_svm.run(methods=["admm_blocks"], nb_iter=2000)
    assert acc["admm_blocks"] >= 99.7


def test_consensus_map_sums_like_jax_scatter():
    """``Sᵀ v`` through the map's CSR twin equals JAX's ``.at[ids].add``
    of the masked slots, bit for bit, and leaves the dummy slot at 0."""
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    n, nb, mc = 30, 4, 12
    ids = np.full((nb, mc), n, np.int32)
    mask = np.zeros((nb, mc))
    for b in range(nb):
        k = rng.randint(5, mc + 1)
        ids[b, :k] = rng.choice(n, k, replace=False)
        mask[b, :k] = 1
    v = rng.randn(nb, mc) * mask
    sel = pblocks.consensus_map(ids, mask, n, torch.float64, "cpu")
    got = sel.rmatvec(torch.as_tensor(v.reshape(-1))).numpy()
    want = np.asarray(jnp.zeros(n + 1).at[ids.reshape(-1)].add(
        jnp.asarray(v.reshape(-1))))
    np.testing.assert_array_equal(got, want)


def test_build_blocks_matches_jax():
    from pysparselp_tpu.solvers.admm_blocks import _build_blocks as jbuild

    a = scipy.sparse.random(30, 50, density=0.2, random_state=1,
                            format="csr")
    a.blocks = [(0, 10), (10, 22), (22, 30)]
    b = np.arange(30.0)
    got, want = pblocks._build_blocks(a, b), jbuild(a, b)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_mesh_raises_naming_m9():
    """``mesh=`` (ROADMAP M9, once refused here) shards the block batch:
    the 4-block LP on a one-rank gloo mesh equals the one-device port bit
    for bit and the JAX package's ``lp.solve(mesh=...)`` on 8 CPU devices
    (blocks padded to 8) within 1e-10, float64, 200 iterations."""
    from pysparselp_tpu.parallel.mesh import default_mesh

    jlp = _blocky()
    lp = _port_lp(jlp)
    run = dict(method="admm_blocks", nb_iter=200, nb_iter_plot=100,
               dtype=np.float64)
    one, _ = lp.solve(device="cpu", **run)
    with one_rank_mesh() as mesh:
        got, _ = lp.solve(device="cpu", mesh=mesh, **run)
    want, _ = jlp.solve(mesh=default_mesh(8), **run)
    np.testing.assert_array_equal(got, one)
    np.testing.assert_allclose(got, want, atol=1e-10)
