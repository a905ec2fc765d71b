"""Batched serving in the port (``pysparselp_tpu_torch.solve_cp_batch``)
against the JAX package's ``solve_cp_batch`` on the CPU in float64: the
trajectories of ``tests/test_batch.py``'s template and assignment LPs, the
backend each system lowers to, the validation errors and the batched Potts
demo.  Inputs come from numpy seeds and go to both packages.

"lowered" cases patch ``DENSE_AUTO_MAX_ENTRIES`` to 0 in both batch
modules, so the small systems reach the partition, DIA, column-block and
CSR operators (the batched twins of H-DIA-B and H-CSR-B) instead of
dense.

JAX is imported inside the parity tests: the card machine, which runs this
file's ``cuda`` case (``python -m pytest --noconftest -m cuda``), has
none."""

import numpy as np
import pytest
import scipy.sparse
import torch

import pysparselp_tpu_torch.batch as pbatch
from pysparselp_tpu_torch import SparseLP as PortLP
from pysparselp_tpu_torch import problem as ppr
from pysparselp_tpu_torch.utils.random_lp import (
    generate_random_lp as port_random_lp)
from torch_port_helpers import cuda_or_skip

torch.set_num_threads(1)
CURVES = pbatch.CURVES
# the JAX operator type each port operator type stands for
TYPE_MAP = {"DenseMatrix": "DenseMatrix", "PartitionMatrix": "PartitionMatrix",
            "DiaMatrix": "XlaDiaMatrix", "ColBlockMatrix": "ColBlockMatrix",
            "CsrMatrix": "EllMatrix"}


def _jax():
    """The JAX batch module and SparseLP (imported here, not on the
    card)."""
    import pysparselp_tpu.batch as jbatch
    from pysparselp_tpu import SparseLP

    return jbatch, SparseLP


def _template(make, seed=11):
    """``tests/test_batch.py::_template`` built by ``make``."""
    return make(nbvar=24, n_eq=4, n_ineq=18, sparsity=0.3, seed=seed)[0]


def _templates(seed=11):
    """The template in both packages."""
    from pysparselp_tpu.utils.random_lp import generate_random_lp

    return (_template(generate_random_lp, seed),
            _template(port_random_lp, seed))


def _assignment(SparseLP):
    """``tests/test_batch.py::test_batch_assignment_lp_serving``'s LP."""
    rng = np.random.RandomState(7)
    npts, nc = 50, 6
    dist = rng.rand(npts, nc)
    lp = SparseLP()
    lab = lp.add_variables_array((npts, nc), 0, 1, dist)
    used = lp.add_variables_array(nc, 0, 1, 0)
    lp.add_equality_constraints(lab, np.ones((npts, nc)), b=np.ones(npts))
    cols = np.column_stack(
        (lab.reshape(-1, 1),
         np.ones((npts, 1)).dot(used[None, :]).reshape(-1, 1))).astype(int)
    vals = np.column_stack((np.ones(lab.size), -np.ones(lab.size)))
    lp.add_inequality_constraints(cols, vals, lower_bounds=None,
                                  upper_bounds=0)
    return lp


def _two_sided(lp):
    """Give ``lp`` lower row bounds on half its inequality rows (the fold
    then keeps upper rows and lower rows)."""
    bl = lp.b_upper - 5.0
    bl[::2] = -np.inf
    lp.b_lower = bl
    return lp


def _inputs(case, lp):
    rng = np.random.RandomState({"costs": 0, "bounds": 2, "b_eq": 3,
                                 "two_sided": 4}[case])
    n, m_in = lp.nb_variables, lp.a_inequalities.shape[0]
    if case == "costs":
        return dict(costs=lp.costsvector[None, :]
                    * (1.0 + 0.3 * rng.rand(3, n)))
    if case == "bounds":
        ub = np.broadcast_to(lp.upper_bounds * 1.0, (3, n)).copy()
        ub[1] += 1.0
        return dict(b_upper=lp.b_upper[None, :] + 0.5 * rng.rand(3, m_in),
                    ub=ub)
    if case == "b_eq":
        m_eq = lp.a_equalities.shape[0]
        return dict(b_eq=lp.b_equalities[None, :]
                    + 0.1 * rng.randn(4, m_eq))
    return dict(b_lower=lp.b_lower[None, :] - rng.rand(2, m_in),
                b_upper=lp.b_upper[None, :] + rng.rand(2, m_in))


def _lowered(monkeypatch, lowered):
    if lowered:
        monkeypatch.setattr(_jax()[0], "DENSE_AUTO_MAX_ENTRIES", 0)
        monkeypatch.setattr(pbatch, "DENSE_AUTO_MAX_ENTRIES", 0)


def _both(lp_jax, lp_port, **kw):
    want = _jax()[0].solve_cp_batch(lp_jax, dtype=np.float64, **kw)
    got = pbatch.solve_cp_batch(lp_port, dtype=np.float64, device="cpu",
                                **kw)
    return got, want


def _assert_same_run(got, want, atol):
    (x, info), (jx, jinfo) = got, want
    assert x.shape == jx.shape
    np.testing.assert_allclose(x, jx, rtol=0, atol=atol)
    np.testing.assert_array_equal(info["itrn"], jinfo["itrn"])
    for k in CURVES:
        assert info[k].shape == jinfo[k].shape
        np.testing.assert_allclose(info[k], jinfo[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("lowered", [False, True], ids=["dense", "lowered"])
@pytest.mark.parametrize("case", ["costs", "bounds", "b_eq", "two_sided"])
def test_trajectory_matches_jax(case, lowered, monkeypatch):
    """40 iterations, a checkpoint every 20: X and the four ``(P, B)``
    curves within 1e-10 of the JAX batch path."""
    _lowered(monkeypatch, lowered)
    lp_jax, lp_port = _templates()
    if case == "two_sided":
        lp_jax, lp_port = _two_sided(lp_jax), _two_sided(lp_port)
    kw = _inputs(case, lp_jax)
    got, want = _both(lp_jax, lp_port, nb_iter=40, nb_iter_plot=20, **kw)
    _assert_same_run(got, want, 1e-10)
    assert got[1]["energy1"].shape == (2, next(iter(kw.values())).shape[0])
    kinds = {TYPE_MAP[k] for k in got[1]["backend"].values()}
    assert (kinds == {"DenseMatrix"}) != lowered


@pytest.mark.parametrize("lowered", [False, True], ids=["dense", "lowered"])
def test_assignment_batch_matches_jax(lowered, monkeypatch):
    """``tests/test_batch.py``'s assignment LP, 3,000 iterations: within
    1e-8 of the JAX batch path (lowered: partition equalities, the
    inequalities on H-CSR-B's twin where JAX takes its shift-loop DIA:
    the port's DIA limit is 32 diagonals)."""
    _lowered(monkeypatch, lowered)
    lp_jax, lp_port = _assignment(_jax()[1]), _assignment(PortLP)
    rng = np.random.RandomState(7)
    rng.rand(50, 6)
    costs = lp_jax.costsvector[None, :] * (1.0 + 0.2 * rng.rand(
        3, lp_jax.nb_variables))
    got, want = _both(lp_jax, lp_port, costs=costs, nb_iter=3000,
                      nb_iter_plot=1500)
    _assert_same_run(got, want, 1e-8)
    if lowered:
        assert got[1]["backend"] == {"eq": "PartitionMatrix",
                                     "ineq": "CsrMatrix"}


def test_columns_follow_the_single_problem_chunk():
    """Each batch column equals ``cp_chunk_impl`` run alone on the same
    operators and preconditioners (the 1-D per-operator path)."""
    from pysparselp_tpu_torch.solvers.chambolle_pock import (
        _fold_one_sided, cp_chunk_impl, host_preconditioners)

    lp = _template(port_random_lp)
    costs = _inputs("costs", lp)["costs"]
    x_b, info = pbatch.solve_cp_batch(lp, costs=costs, nb_iter=40,
                                      nb_iter_plot=40, device="cpu")
    a_one, b_one = _fold_one_sided(lp.a_inequalities.tocsr(), lp.b_lower,
                                   lp.b_upper)
    a_eq = lp.a_equalities.tocsr()
    eq_m = pbatch._lower_batch(a_eq, torch.float64, "cpu")
    in_m = pbatch._lower_batch(a_one, torch.float64, "cpu")
    diag_t, s_eq, s_in = host_preconditioners(a_eq, a_one)
    pre = {k: torch.as_tensor(v) for k, v in (
        ("diag_t", diag_t), ("sigma_eq", s_eq), ("sigma_ineq", s_in))}
    pre["theta"] = torch.tensor(1.0, dtype=torch.float64)

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64))

    n = lp.nb_variables
    for b in range(costs.shape[0]):
        prob = ppr.LPProblem(
            c=vec(costs[b]), lb=vec(lp.lower_bounds), ub=vec(lp.upper_bounds),
            a_eq=eq_m, b_eq=vec(lp.b_equalities), a_ineq=in_m, b_lower=None,
            b_upper=vec(b_one), n=n, m_eq=eq_m.nrows, m_ineq=in_m.nrows)
        st = (vec(np.zeros(n)), vec(np.zeros(n)), vec(np.zeros(eq_m.nrows)),
              vec(np.zeros(in_m.nrows)))
        st, metrics = cp_chunk_impl(prob, pre, st, 40)
        np.testing.assert_allclose(x_b[b], st[0].numpy(), rtol=0, atol=1e-12)
        for k in CURVES:
            np.testing.assert_allclose(info[k][-1][b], float(metrics[k]),
                                       rtol=0, atol=1e-12, err_msg=k)


def _simplex():
    m, w = 9000, 30
    rows = np.repeat(np.arange(m), w)
    cols = (np.arange(m)[:, None] * w + np.arange(w)[None, :]).reshape(-1)
    return scipy.sparse.csr_matrix((np.ones(m * w), (rows, cols)),
                                   shape=(m, m * w))


def _kmedians_ineq():
    npts, nc = 70000, 20
    r2 = np.arange(npts)
    labeling = scipy.sparse.csr_matrix(
        (np.ones(npts), (r2, r2)), shape=(npts, npts + nc))
    hot = scipy.sparse.csr_matrix(
        (-np.ones(npts * nc),
         (np.repeat(r2, nc), npts + np.tile(np.arange(nc), npts))),
        shape=(npts, npts + nc))
    return (labeling + hot).tocsr()


def _scattered(m, n, nnz):
    """Uniformly scattered entries at ``scipy.sparse.random``'s density of
    the "scattered" case, drawn with replacement."""
    rng = np.random.RandomState(0)
    a = scipy.sparse.coo_matrix(
        (rng.rand(nnz), (rng.randint(0, m, nnz), rng.randint(0, n, nnz))),
        shape=(m, n)).tocsr()
    a.sum_duplicates()
    return a


# the matrices of tests/test_batch.py's lowering tests
LOWERING = {
    "small": lambda: scipy.sparse.random(20, 30, density=0.2, random_state=0,
                                         format="csr"),
    "banded": lambda: scipy.sparse.diags(
        [np.ones(9_000_000), np.ones(9_000_000 - 3)], [0, -3]).tocsr(),
    "scattered": lambda: scipy.sparse.random(
        20000, 20000, density=5e-4, random_state=np.random.RandomState(0),
        format="csr"),
    "simplex": _simplex,
    "kmedians_ineq": _kmedians_ineq,
}


def _kinds(op):
    name = type(op).__name__
    if name == "ColBlockMatrix":
        return (name, tuple(op.col_starts),
                tuple(_kinds(b) for b in op.blocks))
    return name


def _mapped(kinds):
    if isinstance(kinds, tuple):
        return (kinds[0], kinds[1], tuple(_mapped(k) for k in kinds[2]))
    return TYPE_MAP[kinds]


@pytest.mark.parametrize("name", sorted(LOWERING))
def test_lower_batch_matches_lower_xla(name):
    """``_lower_batch`` picks the counterpart of ``_lower_xla``'s operator
    on each matrix (blocks and cuts of a column split included), and the
    port's operator computes the same product, batch-last."""
    import jax.numpy as jnp

    a = LOWERING[name]()
    jop = _jax()[0]._lower_xla(a, jnp.float64)
    op = pbatch._lower_batch(a, torch.float64, "cpu")
    assert _mapped(_kinds(op)) == _kinds(jop)
    x = np.random.RandomState(1).rand(a.shape[1], 2)
    np.testing.assert_allclose(op.matvec(torch.as_tensor(x)).numpy(), a @ x,
                               rtol=1e-12, atol=1e-12)


def test_column_split_is_priced_by_the_port_model():
    """Where the two cost models part: on this scattered matrix the JAX
    package's TPU model splits off the last 16 columns as a dense block
    (its gather-ELL is dear), the port's byte model keeps one CSR operator
    (H-CSR-B reads each gathered row of X once for all columns)."""
    import jax.numpy as jnp

    a = _scattered(20000, 20000, 200_000)
    jop = _jax()[0]._lower_xla(a, jnp.float64)
    op = pbatch._lower_batch(a, torch.float64, "cpu")
    assert _kinds(jop) == ("ColBlockMatrix", (0, 19984, 20000),
                           ("EllMatrix", "DenseMatrix"))
    assert isinstance(op, ppr.CsrMatrix)
    assert pbatch.col_split_plan(a)[1] == ()


def _validation_cases():
    JaxLP = _jax()[1]
    lp_jax, lp_port = _templates()
    n = lp_jax.nb_variables

    def eq_only(SparseLP):
        lp = SparseLP()
        lp.add_variables_array(4, 0, 1, costs=np.arange(4.0))
        return lp

    def ineq_only(SparseLP):
        lp = SparseLP()
        x = lp.add_variables_array(4, 0, 1, costs=np.arange(4.0))
        lp.add_inequality_constraints(x[None, :], np.ones((1, 4)),
                                      upper_bounds=np.array([2.0]))
        return lp

    return {
        "no_batch": (lp_jax, lp_port, {}, "at least one batched"),
        "sizes": (lp_jax, lp_port, dict(costs=np.zeros((2, n)),
                                        ub=np.ones((3, n))),
                  "inconsistent batch sizes"),
        "no_system": (eq_only(JaxLP), eq_only(PortLP),
                      dict(costs=np.zeros((2, 4))), "at least one constraint"),
        "shape": (lp_jax, lp_port, dict(costs=np.zeros((2, n + 1))),
                  "costs batch must be"),
        "b_eq_without_equalities": (ineq_only(JaxLP), ineq_only(PortLP),
                                    dict(b_eq=np.zeros((2, 1))),
                                    "no equalities"),
    }


@pytest.mark.parametrize("case", ["no_batch", "sizes", "no_system", "shape",
                                  "b_eq_without_equalities"])
def test_validation_errors_match_jax(case):
    lp_jax, lp_port, kw, match = _validation_cases()[case]
    with pytest.raises(ValueError, match=match) as want:
        _jax()[0].solve_cp_batch(lp_jax, **kw)
    with pytest.raises(ValueError, match=match) as got:
        pbatch.solve_cp_batch(lp_port, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_batch_segmentation_matches_graph_cut():
    """The batched Potts demo (B = 3, 12×12): each frame's thresholded
    relaxation agrees with its own graph-cut optimum on > 97% of pixels."""
    from pysparselp_tpu_torch.examples.potts import (graph_cut_segmentation,
                                                     solve_batch_segmentation)

    rng = np.random.RandomState(3)
    bsz, size, coef_mul = 3, 12, 500
    imgs = np.round(coef_mul * (rng.rand(bsz, size, size) * 2 - 1)) / coef_mul
    coef = round(0.5 * coef_mul) / coef_mul
    segs, info = solve_batch_segmentation(imgs, coef, nb_iter=30000,
                                          nb_iter_plot=30000,
                                          dtype=np.float64, device="cpu")
    assert segs.shape == (bsz, size, size)
    assert info["energy1"].shape == (1, bsz)
    for b in range(bsz):
        gt = graph_cut_segmentation(imgs[b] * coef_mul,
                                    round(coef * coef_mul))
        agree = np.mean((segs[b] > 0.5) == (gt > 0.5))
        assert agree > 0.97, (b, agree)


def test_default_device_is_cuda():
    lp = _template(port_random_lp)
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        pbatch.solve_cp_batch(lp, costs=lp.costsvector[None, :], nb_iter=1)


@pytest.mark.cuda
def test_batch_on_cuda_runs_the_batched_kernels():
    """On the card, the lowered template (DIA and column-split CSR
    systems) in float32 runs H-DIA-B and H-CSR-B and stays within 1e-4 of
    the float64 CPU run."""
    from pysparselp_tpu_torch.ops import csr_spmv, dia_spmv

    cuda_or_skip()
    lp = _template(port_random_lp)
    costs = _inputs("costs", lp)["costs"]
    kw = dict(costs=costs, nb_iter=200, nb_iter_plot=100)
    dense = pbatch.DENSE_AUTO_MAX_ENTRIES
    pbatch.DENSE_AUTO_MAX_ENTRIES = 0
    try:
        dia_spmv.dia_spmm.launches = csr_spmv.csr_spmm.launches = 0
        x, info = pbatch.solve_cp_batch(lp, dtype=np.float32, **kw)
        launches = (dia_spmv.dia_spmm.launches, csr_spmv.csr_spmm.launches)
        x64, info64 = pbatch.solve_cp_batch(lp, dtype=np.float64,
                                            device="cpu", **kw)
    finally:
        pbatch.DENSE_AUTO_MAX_ENTRIES = dense
    assert info["backend"] == info64["backend"]
    assert all(launches), (info["backend"], launches)
    np.testing.assert_allclose(x, x64, rtol=0, atol=1e-4)
    for k in CURVES:
        np.testing.assert_allclose(info[k], info64[k], rtol=1e-4, atol=1e-4)
