"""The ported slice as a whole, on the CPU in float64:
``pysparselp_tpu_torch.SparseLP.solve(method="chambolle_pock_ppd",
device="cpu")`` against the JAX package's goldens and live JAX solves (the
Potts grids, SC105, small cases of ``bench.py``'s four non-grid workloads,
and CLIME through the RCM presolve and the block-sparse operator), and the
port's host-layer copies against their originals."""

import copy
import functools
import json
import os

import numpy as np
import pytest
import scipy.sparse
import torch

import bench
import chip_smoke
import pysparselp_tpu.examples.potts as jpotts
import pysparselp_tpu.examples.sparse_inv_covariance as jclime
import pysparselp_tpu.io.netlib as jnetlib
import pysparselp_tpu.problem as jproblem
import pysparselp_tpu_torch.examples.potts as ppotts
import pysparselp_tpu_torch.examples.sparse_inv_covariance as pclime
import pysparselp_tpu_torch.io.netlib as pnetlib
import pysparselp_tpu_torch.ops.bsr_spmv as pbsr
import pysparselp_tpu_torch.problem as pproblem
import pysparselp_tpu_torch.solvers.chambolle_pock as pcp
from pysparselp_tpu.examples.l1_svm import L1SVM as JaxL1SVM
from pysparselp_tpu_torch.modeling import SparseLP as TorchLP
from pysparselp_tpu_torch.utils.convert import (problem_from_jax_arrays,
                                                state_from_numpy,
                                                state_to_numpy)
from torch_port_helpers import (host_system, jax_problem, sc105_lp,
                                start_point, torch_pre)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
CP = "chambolle_pock_ppd"


def _port_lp(jax_lp):
    """The same model as a port SparseLP (host state copied over)."""
    lp = TorchLP.__new__(TorchLP)
    lp.__dict__ = copy.deepcopy(jax_lp).__dict__
    return lp


@functools.lru_cache(maxsize=None)
def _potts(size):
    return ppotts.build_linear_program(size, 0.5, 500, seed=1)[:3]


def _curves(lp, keys):
    return {k: [float(v) for v in getattr(lp, k)] for k in keys}


# ----------------------------------------------------------------------
# the JAX package's golden curves (rtol 1e-7, atol 1e-9 as in
# tests/test_golden_curves.py and tests/test_golden_potts.py)
# ----------------------------------------------------------------------


def test_reproduces_sc105_golden():
    lp = _port_lp(sc105_lp()[0])
    lp.solve(method=CP, nb_iter=2000, nb_iter_plot=500, device="cpu")
    with open(os.path.join(GOLDEN_DIR, "sc105_curves.json")) as f:
        ref = json.load(f)[CP]
    assert [int(i) for i in lp.itrn_curve] == ref["itrn"]
    for key, attr in (("pobj", "pobj_curve"),
                      ("viol_eq", "max_violated_equality"),
                      ("viol_ineq", "max_violated_inequality")):
        np.testing.assert_allclose([float(v) for v in getattr(lp, attr)],
                                   ref[key], rtol=1e-7, atol=1e-9,
                                   err_msg=key)


@pytest.mark.parametrize("size", [20, 50])
def test_reproduces_potts_golden(size):
    lp, gt, idx = _potts(size)
    lp.solve(method=CP, nb_iter=3000, nb_iter_plot=1000, ground_truth=gt,
             ground_truth_indices=idx, device="cpu")
    with open(os.path.join(GOLDEN_DIR, f"potts{size}_curves.json")) as f:
        ref = json.load(f)[CP]
    assert [int(i) for i in lp.itrn_curve] == ref["itrn"]
    np.testing.assert_allclose(lp.distance_to_ground_truth, ref["dist"],
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(lp.pobj_curve, ref["pobj"], rtol=1e-7,
                               atol=1e-9)


# ----------------------------------------------------------------------
# live JAX solves, curve by curve (rtol 1e-9)
# ----------------------------------------------------------------------

KEYS = ("itrn_curve", "pobj_curve", "dobj_curve", "max_violated_equality",
        "max_violated_inequality", "max_violated_constraint")


def _sc105():
    return sc105_lp()[0], {}


def _potts20():
    lp, gt, idx, _ = jpotts.build_linear_program(20, 0.5, 500, seed=1)
    return lp, dict(ground_truth=gt, ground_truth_indices=idx)


def _multilabel():
    lp, _idx = jpotts.build_multilabel_linear_program(16, 3, seed=2)
    return lp, {}


def _potts8():
    lp, gt, idx, _ = jpotts.build_linear_program(8, 0.5, 500, seed=3)
    return lp, dict(ground_truth=gt, ground_truth_indices=idx)


LIVE = {
    "restart_sc105": (_sc105, dict(nb_iter=3000, nb_iter_plot=1000,
                                   restart="average", restart_period=250)),
    "restart_align_multilabel": (_multilabel, dict(
        nb_iter=600, nb_iter_plot=300, restart="average", restart_period=100,
        permute="align")),
    "align_potts20": (_potts20, dict(nb_iter=600, nb_iter_plot=200,
                                     permute="align")),
    "light_sc105": (_sc105, dict(nb_iter=1000, nb_iter_plot=250,
                                 light_metrics=True)),
    "force_integer_potts8": (_potts8, dict(nb_iter=1500, nb_iter_plot=100,
                                           force_integer=True)),
}


@pytest.mark.parametrize("case", sorted(LIVE))
def test_matches_live_jax_solve(case):
    make, kwargs = LIVE[case]
    jlp, extra = make()
    plp = _port_lp(jlp)
    x_j, _ = jlp.solve(method=CP, **kwargs, **extra)
    x_p, _ = plp.solve(method=CP, device="cpu", **kwargs, **extra)
    keys = KEYS + (("distance_to_ground_truth",) if extra else ())
    cj, cp_ = _curves(jlp, keys), _curves(plp, keys)
    assert cp_["itrn_curve"] == cj["itrn_curve"]
    for key in keys:
        np.testing.assert_allclose(cp_[key], cj[key], rtol=1e-9, atol=1e-12,
                                   err_msg=f"{case}:{key}")
    np.testing.assert_allclose(x_p, x_j, rtol=1e-9, atol=1e-9)


# ----------------------------------------------------------------------
# bench.py's four non-grid workloads, small: the port lowers them to CSR,
# partition and column blocks (the dense limit patched down), the JAX
# package to its CPU gather layouts; the curves agree through the math
# ----------------------------------------------------------------------


def _jax_l1svm(nb_examples, nf=30, nb_classes=3):
    """The JAX package's L1-SVM on ``bench.py::measure_l1svm``'s data."""
    rng = np.random.RandomState(1)
    x = rng.rand(nb_examples, nf)
    w = rng.randn(nb_classes, nf)
    w = w / np.sum(w**2, axis=1)[:, None]
    wh = np.hstack((w, -0.5 * np.sum(w, axis=1)[:, None]))
    xh = np.hstack((x, np.ones((nb_examples, 1))))
    classes = np.argmax((wh @ xh.T).T, axis=1)
    svm = JaxL1SVM()
    svm.set_data(x, classes, nb_classes)
    return svm


def _jax_unstructured(**kw):
    """``bench.py::measure_unstructured``'s LP (bench.py:457-461)."""
    from pysparselp_tpu import SparseLP

    a, b, c = bench._unstructured_matrix(**kw)
    lp = SparseLP()
    lp.add_variables_array(a.shape[1], lower_bounds=0, upper_bounds=1,
                           costs=c)
    lp.add_inequality_constraints_sparse(a, None, b)
    return lp


# name: (JAX builder, port builder, sizes, the port operators expected)
WORKLOADS = {
    "transport": (bench._transport_lp, chip_smoke.transport_lp,
                  dict(n_sources=300, n_sinks=300, n_arcs=4000),
                  ("CsrMatrix", "DenseMatrix")),
    "unstructured": (_jax_unstructured, chip_smoke.unstructured_lp,
                     dict(m=2000, n=1500, avg=13),
                     (None, "CsrMatrix")),
    "kmedians": (bench._kmedians_lp, chip_smoke.kmedians_lp,
                 dict(n_points=200, n_candidates=10),
                 ("PartitionMatrix", ["DiaMatrix", "DenseMatrix"])),
    "l1svm": (_jax_l1svm, chip_smoke.l1svm_lp, dict(nb_examples=300),
              (None, ["DenseMatrix", "CsrMatrix"])),
}


def _describe(op):
    if op is None:
        return None
    if isinstance(op, pproblem.ColBlockMatrix):
        return [_describe(b) for b in op.blocks]
    return type(op).__name__


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_builders_match_bench(name):
    """``chip_smoke.py``'s copies of the workload builders build the same
    LP as ``bench.py``'s."""
    make_j, make_p, kw, _ = WORKLOADS[name]
    _same_lp(make_j(**kw), make_p(**kw))


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_matches_live_jax_solve(name, monkeypatch):
    make_j, _, kw, want_ops = WORKLOADS[name]
    monkeypatch.setattr(pproblem, "DENSE_AUTO_MAX_ENTRIES", 100_000)
    lowered = []

    def recording(*args, **kwargs):
        lowered.extend(pproblem.lower_systems(*args, **kwargs))
        return lowered[-2:]

    monkeypatch.setattr(pcp, "lower_systems", recording)
    jlp = make_j(**kw)
    plp = _port_lp(jlp)
    run = dict(method=CP, nb_iter=300, nb_iter_plot=100)
    x_j, _ = jlp.solve(**run)
    x_p, _ = plp.solve(device="cpu", **run)
    assert [_describe(op) for op in lowered] == list(want_ops)
    cj, cp_ = _curves(jlp, KEYS), _curves(plp, KEYS)
    assert cp_["itrn_curve"] == cj["itrn_curve"]
    for key in KEYS:
        np.testing.assert_allclose(cp_[key], cj[key], rtol=1e-9, atol=1e-12,
                                   err_msg=f"{name}:{key}")
    np.testing.assert_allclose(x_p, x_j, rtol=1e-9, atol=1e-9)


# ----------------------------------------------------------------------
# CLIME (examples/sparse_inv_covariance.py) through the RCM presolve and
# the block-sparse operator
# ----------------------------------------------------------------------


def _jax_clime(x, lamb=0.15):
    """The LP of the JAX example's ``run`` (sparse_inv_covariance.py:
    59-73) on the samples ``x``."""
    from scipy import sparse

    n_features = x.shape[1]
    emp_cov = (x.T @ x) / x.shape[0]
    lp = jclime.SparseInvCov()
    ids = lp.add_variables_array(shape=emp_cov.shape, lower_bounds=None,
                                 upper_bounds=None)
    c = sparse.kron(sparse.csr_matrix(emp_cov), sparse.eye(n_features))
    lp.add_inequality_constraints_sparse(
        c, np.eye(emp_cov.shape[0]).flatten() - lamb,
        np.eye(emp_cov.shape[0]).flatten() + lamb)
    lp.add_abs_penalization(ids, 1)
    lp.convert_to_one_sided_inequality_system()
    return lp, ids


@functools.lru_cache(maxsize=None)
def _clime_samples(p):
    return pclime.make_data(n_samples=2 * p, n_features=p, seed=0)[0]


def test_clime_builder_matches_jax():
    """``SparseInvCov`` is the JAX class verbatim and ``clime_lp`` builds
    the JAX example's LP; the numpy precision is symmetric positive
    definite with the requested sparsity."""
    import inspect

    assert inspect.getsource(pclime.SparseInvCov) == \
        inspect.getsource(jclime.SparseInvCov)
    x = _clime_samples(10)
    lp_p, ids_p = pclime.clime_lp(x)
    lp_j, ids_j = _jax_clime(x)
    _same_lp(lp_j, lp_p)
    np.testing.assert_array_equal(ids_p, ids_j)
    _x, prec, cov = pclime.make_data(n_samples=30, n_features=40, seed=3)
    np.testing.assert_allclose(prec, prec.T)
    assert np.linalg.eigvalsh(prec).min() > 0
    np.testing.assert_allclose(np.diag(cov), 1.0)
    assert 0 < np.count_nonzero(prec) < 0.2 * prec.size


def test_clime_run_contract():
    """The example's ``run`` returns the JAX example's contract: the
    absolute error of the estimated precision and its count of zeros.  Its
    default method is the interior point, whose budget is IPM iterations:
    on this instance it stalls (residual 0.69, in the JAX package too), so
    20 dense iterations (~0.5 s each) give the contract's answer as 400
    would."""
    sum_abs_diff, nb_zeros = pclime.run(nb_iter=20, device="cpu")
    assert np.isfinite(sum_abs_diff) and sum_abs_diff > 0
    assert isinstance(nb_zeros, int) and 0 <= nb_zeros <= 400


def test_clime_rcm_bsr_matches_live_jax_solve(monkeypatch):
    """CLIME at p = 10, float64, ``permute="rcm"``, every system lowered
    to the block-sparse operator in both packages (the JAX package forced
    as ``tests/test_bsr.py:99-120`` forces it): x agrees within 1e-9 after
    2,000 iterations."""
    import pysparselp_tpu.solvers.chambolle_pock as jcp

    orig = jproblem.ell_from_scipy
    monkeypatch.setattr(jcp, "ell_from_scipy",
                        lambda a, **kw: orig(a, **{**kw, "prefer": "bsr"}))
    lowered = []

    def bsr_systems(mats, dtype, device, layouts=None):
        ops = [None if a is None else pproblem.ell_from_scipy(
            a, dtype, device, prefer="bsr") for a in mats]
        lowered.extend(ops)
        return ops

    monkeypatch.setattr(pcp, "lower_systems", bsr_systems)
    x = _clime_samples(10)
    jlp, plp = _jax_clime(x)[0], _port_lp(pclime.clime_lp(x)[0])
    run = dict(method=CP, nb_iter=2000, nb_iter_plot=500, permute="rcm")
    x_j, _ = jlp.solve(**run)
    x_p, _ = plp.solve(device="cpu", **run)
    assert lowered[0] is None and isinstance(lowered[1], pproblem.BsrMatrix)
    np.testing.assert_allclose(x_p, x_j, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(plp.pobj_curve, jlp.pobj_curve, rtol=1e-9)
    # the solution is in the original column order
    x_plain, _ = _port_lp(pclime.clime_lp(x)[0]).solve(
        device="cpu", **dict(run, permute=False))
    np.testing.assert_allclose(x_p, x_plain, rtol=1e-9, atol=1e-9)


def _bsr_dense(op):
    """The dense matrix of a port ``BsrMatrix``'s tile set."""
    o, t = op.op, op.tile
    rows = np.repeat(np.arange(o.row_ptr.numel() - 1),
                     np.diff(o.row_ptr.numpy()))
    out = np.zeros(((o.row_ptr.numel() - 1) * t, (o.col_ptr.numel() - 1) * t))
    for tile, r, c in zip(o.tiles.numpy(), rows, o.tile_col.numpy()):
        out[r * t:(r + 1) * t, c * t:(c + 1) * t] = tile
    return out[:op.nrows, :op.ncols]


def test_clime_jax_bsr_carries_across():
    """A JAX ``BsrMatrix`` (the RCM-permuted CLIME system at p = 10,
    ROW_GROUP-padded 128×128 block-ELL tiles) comes across as the port's
    ``BsrMatrix``, its tile set rebuilt from the JAX tiles' entries: the
    same entries, and a CP chunk on it equals JAX's."""
    import jax.numpy as jnp

    import pysparselp_tpu.solvers.chambolle_pock as jcp

    sys_ = host_system(pclime.clime_lp(_clime_samples(10))[0])
    sys_ = pproblem.apply_rcm_permutation(sys_)[0]
    jprob, jpre = jax_problem(sys_, "bsr", jnp.float64)
    prob = problem_from_jax_arrays(jprob, device="cpu")
    op, jop = prob.a_ineq, jprob.a_ineq
    assert isinstance(op, pproblem.BsrMatrix)
    assert np.asarray(jop.tiles).shape[0] * 128 > op.nrows   # ROW_GROUP rows
    np.testing.assert_array_equal(np.asarray(jop.to_dense()),
                                  _bsr_dense(op))
    np.testing.assert_array_equal(_bsr_dense(op),
                                  sys_["a_ineq"].toarray())
    assert op.tile == pbsr.DEFAULT_TILE and op.nnz_padded == \
        pbsr.tile_counts(sys_["a_ineq"])[0] * op.tile ** 2
    x, ye, yi = start_point(sys_, 4)
    st = (x, 0.5 * x, ye, yi)
    js, jm = jcp._cp_chunk(jprob, jpre, tuple(jnp.asarray(v) for v in st), 30)
    ps, pm = pcp.cp_chunk_impl(prob, torch_pre(jpre, torch.float64),
                               state_from_numpy(st), 30)
    for a, b in zip(state_to_numpy(ps), js):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(pm["energy1"]), float(jm["energy1"]),
                               rtol=1e-12)


def test_light_metrics_skips_solution_fetch():
    """light_metrics: the recorder never asks the solver for the solution,
    and the curves are floats after the solve."""
    lp = _port_lp(sc105_lp()[0])
    seen = []

    def cb(niter, x, *rest):
        seen.append(type(x))

    lp.solve(method=CP, nb_iter=400, nb_iter_plot=200, light_metrics=True,
             device="cpu")
    assert all(isinstance(v, float) for v in lp.pobj_curve)
    lp.solve(method=CP, nb_iter=400, nb_iter_plot=200, light_metrics=True,
             callback_func=cb, device="cpu")
    assert seen == [np.ndarray, np.ndarray]


def test_warm_start_resumes_exactly():
    """Full-state resume (x0 + x30 + duals) continues a run bit for bit."""
    lp = _port_lp(sc105_lp()[0])
    states = []

    def cb(niter, x, *rest, state=None):
        states.append(state)

    cb.wants_state = True
    x_full, _ = lp.solve(method=CP, nb_iter=600, nb_iter_plot=300,
                         device="cpu")
    lp.solve(method=CP, nb_iter=300, nb_iter_plot=300, callback_func=cb,
             device="cpu")
    s = states[-1]
    x_res, _ = lp.solve(method=CP, nb_iter=300, nb_iter_plot=300,
                        x0=s["x"], x30=s["x3"], y_eq0=s["y_eq"],
                        y_ineq0=s["y_ineq"], device="cpu")
    np.testing.assert_allclose(x_res, x_full, rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------------------
# host-layer copies
# ----------------------------------------------------------------------


@pytest.mark.parametrize("rel", ["sparse_host.py", "config.py",
                                 os.path.join("io", "mps.py"),
                                 os.path.join("examples", "l1_svm.py"),
                                 os.path.join("examples", "kmedians.py"),
                                 os.path.join("utils", "random_lp.py"),
                                 os.path.join("solvers", "scipy_bridge.py"),
                                 os.path.join("solvers", "highs_bridge.py"),
                                 "preconditioning.py",
                                 os.path.join("examples",
                                              "basis_pursuit_denoising.py"),
                                 os.path.join("examples",
                                              "bipartite_matching.py"),
                                 os.path.join("integer", "__init__.py"),
                                 os.path.join("integer", "rounding.py"),
                                 os.path.join("utils", "xorshift.py"),
                                 os.path.join("utils", "timers.py"),
                                 os.path.join("utils", "__init__.py"),
                                 os.path.join("io", "ian_yen.py"),
                                 os.path.join("solvers", "osqp_bridge.py"),
                                 os.path.join("solvers", "cvxpy_bridge.py"),
                                 "checkpoint.py", "benchmarks.py",
                                 os.path.join("native", "_gauss_seidel.cpp")])
def test_verbatim_host_copies(rel):
    """Copies kept verbatim: the port's file is the original plus one
    header line naming it (a C++ source, where a ``#`` line would be a
    directive, is the original byte for byte)."""
    with open(os.path.join(REPO, "pysparselp_tpu", rel)) as f:
        original = f.read()
    with open(os.path.join(REPO, "pysparselp_tpu_torch", rel)) as f:
        text = f.read()
    if rel.endswith(".cpp"):
        assert text == original
        return
    header, copy_ = text.split("\n", 1)
    assert header == f"# Verbatim copy of pysparselp_tpu/{rel}" or \
        header.startswith(f"# Verbatim copy of pysparselp_tpu/{rel} ")
    assert copy_ == original


@pytest.mark.parametrize("port,original,name", [
    ("parallel.mesh", "parallel.mesh", "pad_gather_width"),
    ("parallel.sharded_dca", "parallel.sharded_dca", "pad_groups"),
    ("solvers.admm_blocks", "solvers.admm_blocks", "_pad_blocks_to"),
])
def test_verbatim_function_copies(port, original, name):
    """Host helpers the mesh solvers keep verbatim: the port's function is
    the JAX package's, text for text."""
    import importlib
    import inspect

    got = getattr(importlib.import_module(f"pysparselp_tpu_torch.{port}"),
                  name)
    want = getattr(importlib.import_module(f"pysparselp_tpu.{original}"),
                   name)
    assert inspect.getsource(got) == inspect.getsource(want)


def test_propagation_copies():
    """``integer/_propagate.cpp`` is the original byte for byte;
    ``integer/propagation.py`` is the original with two header lines and
    another ``_load_native`` (it builds into the port's build directory)."""
    def text(pkg, name):
        with open(os.path.join(REPO, pkg, "integer", name)) as f:
            return f.read()

    assert text("pysparselp_tpu_torch", "_propagate.cpp") == text(
        "pysparselp_tpu", "_propagate.cpp")

    def without_loader(src):
        start = src.index("def _load_native():")
        return src[:start] + src[src.index("def _ptr("):]

    port = text("pysparselp_tpu_torch", "propagation.py").split("\n", 2)
    assert port[0].startswith("# Copy of pysparselp_tpu/integer/")
    assert without_loader(port[2]) == without_loader(
        text("pysparselp_tpu", "propagation.py"))


def test_propagation_native_matches_python():
    """The port's native propagation (built into its build directory)
    tightens bounds as the pure-Python path does."""
    from pysparselp_tpu_torch.integer import propagation

    rng = np.random.RandomState(3)
    a = scipy.sparse.random(40, 30, density=0.15, random_state=3,
                            format="csr")
    a.data = np.round(a.data * 4) + 1
    b_upper = np.asarray(a.sum(axis=1)).ravel() * 0.5
    b_lower = np.full(40, -np.inf)
    outs = []
    for native in (True, False):
        x_l, x_u, log = np.zeros(30), np.ones(30), []
        x_l[rng.choice(30, 3, replace=False)] = 1.0
        status = propagation.propagate_constraints(
            np.nonzero(x_l)[0], x_l, x_u, a, a.tocsc(), b_lower, b_upper,
            log, use_native=native)
        outs.append((status, x_l, x_u))
        rng = np.random.RandomState(3)
    assert propagation._LIB is not None
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    np.testing.assert_array_equal(outs[0][2], outs[1][2])


def _same_lp(a, b):
    for attr in ("costsvector", "lower_bounds", "upper_bounds", "b_lower",
                 "b_upper", "b_equalities", "is_integer"):
        np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
    for attr in ("a_inequalities", "a_equalities"):
        ma, mb = getattr(a, attr).tocsr(), getattr(b, attr).tocsr()
        assert ma.shape == mb.shape
        assert (ma != mb).nnz == 0
        assert getattr(a, attr).blocks == getattr(b, attr).blocks


def test_potts_builders_match():
    pj = jpotts.build_linear_program(12, 0.5, 500, seed=4)
    pp = ppotts.build_linear_program(12, 0.5, 500, seed=4)
    _same_lp(pj[0], pp[0])
    for a, b in zip(pj[1:], pp[1:]):
        np.testing.assert_array_equal(a, b)
    mj = jpotts.build_multilabel_linear_program(10, 3, seed=5)
    mp = ppotts.build_multilabel_linear_program(10, 3, seed=5)
    _same_lp(mj[0], mp[0])
    np.testing.assert_array_equal(mj[1], mp[1])


def test_sc105_parser_matches():
    dj, dp = jnetlib.get_problem("SC105"), pnetlib.get_problem("SC105")
    assert dj.keys() == dp.keys()
    for k in dj:
        if scipy.sparse.issparse(dj[k]):
            assert (dj[k] != dp[k]).nnz == 0
        elif isinstance(dj[k], np.ndarray):
            np.testing.assert_array_equal(dj[k], dp[k])
        else:
            assert dj[k] == dp[k], k


def test_modeling_conversions_match():
    lj = sc105_lp()[0]
    lp_ = _port_lp(lj)
    lj.upper_bounds[:3] = lj.lower_bounds[:3]   # some fixed variables
    lp_.upper_bounds[:3] = lp_.lower_bounds[:3]
    for a, b in zip(lj.remove_fixed_variables(), lp_.remove_fixed_variables()):
        assert (scipy.sparse.csr_matrix(a) != scipy.sparse.csr_matrix(b)).nnz == 0
    _same_lp(lj, lp_)
    for a, b in zip(lj.convert_to_slack_form(), lp_.convert_to_slack_form()):
        assert (scipy.sparse.csr_matrix(a) != scipy.sparse.csr_matrix(b)).nnz == 0
    _same_lp(lj, lp_)


@pytest.mark.parametrize("make", [_sc105, _potts20, _multilabel])
def test_layout_helpers_match(make):
    sys_ = host_system(make()[0])
    mats = [sys_["a_eq"], sys_["a_ineq"]]
    pj = jproblem.aligned_offset_count(mats, return_plan=True,
                                       return_spans=True)
    pp = pproblem.aligned_offset_count(mats, return_plan=True,
                                       return_spans=True)
    assert pj[:4] == pp[:4]
    (rj, cj, mj, nj), (rp, cp_, mp, np_) = pj[4], pp[4]
    np.testing.assert_array_equal(cj, cp_)
    assert (mj, nj) == (mp, np_)
    for a, b in zip(rj, rp):
        assert (a is None and b is None) or np.array_equal(a, b)
    ej = jproblem.apply_align_embedding(pj[4], sys_)
    ep = pproblem.apply_align_embedding(pp[4], sys_)
    for k in ej[0]:
        a, b = ej[0][k], ep[0][k]
        if scipy.sparse.issparse(a):
            assert (a != b).nnz == 0
            np.testing.assert_array_equal(jproblem.dia_offsets(a),
                                          pproblem.dia_offsets(b))
        elif a is not None:
            np.testing.assert_array_equal(a, b)
    assert pproblem.ALIGN_PAD_RHS == jproblem.ALIGN_PAD_RHS
