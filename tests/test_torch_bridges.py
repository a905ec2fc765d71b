"""The port's host bridges (``method="scipy_simplex"`` and
``"scipy_interior_point"``: HiGHS through scipy, verbatim copies of the
JAX package's ``solvers/scipy_bridge.py`` and ``highs_bridge.py``) give the
JAX package's solution and convergence curve, on netlib SC105 and on a
``generate_random_lp`` LP, whatever ``device`` says.  The optional bridges
(``osqp_bridge.py``, ``cvxpy_bridge.py``) and the LPsparse exporter
(``io/ian_yen.py``), verbatim copies too, are held to the JAX package's as
``tests/test_bridges_io.py`` holds those: a fake OSQP, the missing-cvxpy
error, the exporter's files byte for byte; and ``dispatch`` routes each
bridge's methods to it."""

import importlib
import pkgutil
import sys
import types

import numpy as np
import pytest
import scipy.sparse
import torch

import pysparselp_tpu_torch
import pysparselp_tpu_torch.modeling as pmodeling
from pysparselp_tpu.modeling import SparseLP as JaxLP
from pysparselp_tpu.utils.random_lp import generate_random_lp as jax_random
from pysparselp_tpu_torch.modeling import SparseLP as TorchLP
from pysparselp_tpu_torch.utils.random_lp import (
    generate_random_lp as port_random)
from torch_port_helpers import sc105_lp

torch.set_num_threads(1)
METHODS = ["scipy_simplex", "scipy_interior_point"]


def _pair(name):
    if name == "sc105":
        return sc105_lp()[0], sc105_lp(port=True)[0]
    kw = dict(nbvar=60, n_eq=10, n_ineq=40, sparsity=0.2, seed=17)
    return jax_random(**kw)[0], port_random(**kw)[0]


@pytest.mark.parametrize("name", ["sc105", "random"])
@pytest.mark.parametrize("method", METHODS)
def test_bridge_matches_jax(method, name):
    lp_jax, lp_port = _pair(name)
    run = dict(method=method, nb_iter=100_000, nb_iter_plot=20)
    want, _ = lp_jax.solve(**run)
    # the bridges run on the host: the default device="cuda" is not asked
    got, _ = lp_port.solve(**run)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert lp_port.itrn_curve == lp_jax.itrn_curve
    np.testing.assert_allclose(lp_port.pobj_curve, lp_jax.pobj_curve,
                               rtol=1e-12, atol=1e-12)
    assert lp_port.max_constraint_violation(got) < 1e-6


def _small_lp(cls=TorchLP, seed=4):
    """``tests/test_bridges_io.py::_small_lp`` in either package."""
    rng = np.random.RandomState(seed)
    cost = rng.rand(6, 6)
    lp = cls()
    x = lp.add_variables_array(cost.shape, 0, 1, costs=cost)
    lp.add_equality_constraints(x, np.ones_like(cost), b=np.ones(6))
    lp.add_inequality_constraints(x.T, np.ones_like(cost),
                                  upper_bounds=np.ones(6))
    return lp


def _fake_bridge(monkeypatch, module, name, calls):
    """Replace ``solvers.<module>.<name>`` with a recorder returning 0s."""
    mod = importlib.import_module(f"pysparselp_tpu_torch.solvers.{module}")

    def fake(lp, *args, **kw):
        calls.append((name,) + args + tuple(sorted(kw)))
        return np.zeros(lp.nb_variables)

    monkeypatch.setattr(mod, name, fake)


@pytest.mark.parametrize("method", METHODS)
def test_bridges_are_ported(method, monkeypatch):
    """The scipy bridges are valid methods and ``dispatch`` hands them to
    ``scipy_bridge.solve_scipy`` with the default device (never asked)."""
    assert method in pmodeling.solving_methods
    calls = []
    _fake_bridge(monkeypatch, "scipy_bridge", "solve_scipy", calls)
    _small_lp().solve(method=method, nb_iter=10)
    assert calls == [("solve_scipy", method, "callback_func", "nb_iter",
                      "nb_iter_plot", "start_time")]


@pytest.mark.parametrize("method,module,entry", [
    ("osqp", "osqp_bridge", "solve_osqp"),
    ("ECOS", "cvxpy_bridge", "solve_cvxpy"),
    ("SCS", "cvxpy_bridge", "solve_cvxpy"),
    ("CVXOPT", "cvxpy_bridge", "solve_cvxpy"),
])
def test_dispatch_routes_optional_bridges(method, module, entry,
                                          monkeypatch):
    """With its package installed (faked here: ``solving_methods`` gains
    the name, the bridge's entry point records its call) each optional
    method reaches its bridge as in the JAX dispatch
    (``pysparselp_tpu/solvers/__init__.py:314-324``), on the host whatever
    ``device`` says; without it the method is not valid."""
    lp = _small_lp()
    if method not in pmodeling.solving_methods:
        with pytest.raises(ValueError, match="available methods"):
            lp.solve(method=method, nb_iter=10, device="cpu")
    monkeypatch.setattr(pmodeling, "solving_methods",
                        pmodeling.solving_methods + (method,))
    calls = []
    _fake_bridge(monkeypatch, module, entry, calls)
    x, _ = lp.solve(method=method, nb_iter=10)
    want = (entry,) + ((method,) if module == "cvxpy_bridge" else ()) + (
        "callback_func", "nb_iter", "start_time")
    assert calls == [want]
    assert x.shape == (lp.nb_variables,)


def test_every_package_module_imports():
    """No module of the port raises on import (the JAX test's phantom-
    import guard), and none brings in jax."""
    failures = []
    for info in pkgutil.walk_packages(pysparselp_tpu_torch.__path__,
                                      prefix="pysparselp_tpu_torch."):
        try:
            importlib.import_module(info.name)
        except Exception as e:  # noqa: BLE001 - collect all failures
            failures.append((info.name, repr(e)))
    assert not failures, f"modules failed to import: {failures}"


def _coo(path):
    raw = np.loadtxt(path)
    m, n = int(raw[0, 0]), int(raw[0, 1])
    rows = raw[1:, 0].astype(int) - 1
    cols = raw[1:, 1].astype(int) - 1
    return scipy.sparse.coo_matrix((raw[1:, 2], (rows, cols)), (m, n))


IAN_YEN_FILES = ("a_eq", "beq", "c", "A", "b", "meta")


def test_save_ian_e_h_yen_roundtrip(tmp_path):
    lp = _small_lp()
    lp.save_ian_e_h_yen(str(tmp_path))
    for name in IAN_YEN_FILES:
        assert (tmp_path / name).exists(), name
    np.testing.assert_allclose(np.loadtxt(tmp_path / "c"), lp.costsvector,
                               atol=1e-6)
    np.testing.assert_allclose(
        _coo(tmp_path / "a_eq").toarray(),
        lp.a_equalities.tocsr().toarray(), atol=1e-6)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "beq"),
                               lp.b_equalities, atol=1e-6)
    # A holds the inequalities plus one row per finite upper bound
    a_ineq = _coo(tmp_path / "A")
    n_orig = lp.a_inequalities.shape[0]
    n_bounded = int(np.sum(~np.isinf(lp.upper_bounds)))
    assert a_ineq.shape == (n_orig + n_bounded, lp.nb_variables)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "b")[:n_orig],
                               lp.b_upper, atol=1e-6)
    meta = dict(line.split("\t")
                for line in (tmp_path / "meta").read_text().splitlines())
    assert int(meta["nb"]) == lp.nb_variables
    assert int(meta["mE"]) == lp.a_equalities.shape[0]
    assert int(meta["mI"]) == a_ineq.shape[0]


@pytest.mark.parametrize("seed", [4, 11])
def test_save_ian_e_h_yen_byte_equal_to_jax(tmp_path, seed):
    """The two packages write the same six files, byte for byte."""
    _small_lp(TorchLP, seed).save_ian_e_h_yen(str(tmp_path / "port"))
    _small_lp(JaxLP, seed).save_ian_e_h_yen(str(tmp_path / "jax"))
    for name in IAN_YEN_FILES:
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes(), name


def test_save_ian_e_h_yen_guards(tmp_path):
    lp = _small_lp()
    lp.lower_bounds[:] = -1.0
    with pytest.raises(ValueError, match="lower bound"):
        lp.save_ian_e_h_yen(str(tmp_path))
    lp = _small_lp()
    lp.b_lower = np.zeros(lp.a_inequalities.shape[0])
    with pytest.raises(ValueError, match="one_sided"):
        lp.save_ian_e_h_yen(str(tmp_path))


def test_osqp_bridge_with_fake_solver(monkeypatch):
    """The port's OSQP conversion under a fake osqp module, against the
    JAX package's under the same fake: the same arrays reach OSQP, the
    same solution and callback point come back."""
    from pysparselp_tpu.solvers.osqp_bridge import solve_osqp as jax_osqp
    from pysparselp_tpu_torch.solvers.osqp_bridge import solve_osqp

    lp = _small_lp()
    ref, _ = lp.solve(method="scipy_simplex")
    captured = []

    class FakeModel:
        def setup(self, p, q, a, lo, hi, **opts):
            captured.append(dict(p=p, q=q, a=a, lo=lo, hi=hi, opts=opts))

        def solve(self):
            # answer with the HiGHS optimum; the bridge only relays it
            info = types.SimpleNamespace(iter=7)
            return types.SimpleNamespace(x=ref, info=info)

    monkeypatch.setitem(sys.modules, "osqp",
                        types.SimpleNamespace(OSQP=FakeModel))
    points = []
    x = solve_osqp(lp, nb_iter=50, callback_func=lambda *a: points.append(a))
    np.testing.assert_allclose(x, ref)
    assert len(points) == 1 and points[0][0] == 7
    got = captured[-1]
    assert got["p"].nnz == 0
    assert got["a"].shape[1] == lp.nb_variables
    assert got["a"].shape[0] >= lp.a_inequalities.shape[0]
    assert np.all(got["lo"] >= -1000) and np.all(got["hi"] <= 1000)
    assert got["opts"]["max_iter"] == 50

    jpoints = []
    xj = jax_osqp(_small_lp(JaxLP), nb_iter=50,
                  callback_func=lambda *a: jpoints.append(a))
    want = captured[-1]
    np.testing.assert_array_equal(x, xj)
    assert points[0][:4] == jpoints[0][:4] and points[0][5:] == jpoints[0][5:]
    for key in ("q", "lo", "hi"):
        np.testing.assert_array_equal(got[key], want[key])
    assert (got["a"] != want["a"]).nnz == 0 and got["a"].shape == \
        want["a"].shape
    assert got["opts"] == want["opts"]


def test_cvxpy_bridge_requires_cvxpy():
    """Without cvxpy the bridge and ``SparseLP.convert_to_cvxpy`` raise
    ImportError when called, not when the package is imported."""
    if "cvxpy" in sys.modules:
        pytest.skip("cvxpy installed")
    from pysparselp_tpu_torch.solvers.cvxpy_bridge import solve_cvxpy

    with pytest.raises(ImportError):
        solve_cvxpy(_small_lp(), "ECOS")
    with pytest.raises(ImportError):
        _small_lp().convert_to_cvxpy()
