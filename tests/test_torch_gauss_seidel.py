"""The port's native bounded Gauss-Seidel sweeps (``native/``: the JAX
package's C++ source, built into the port's build directory) and the ADMM
host mode ``inner="gauss_seidel"``: the counterparts of
``tests/test_gauss_seidel.py``, the sweeps bit-equal to the JAX package's,
and the host-mode ADMM solve within 1e-12 of JAX's."""

import importlib
import os

import numpy as np
import pytest
import scipy.sparse
import torch

import pysparselp_tpu.native as jnative
import pysparselp_tpu_torch.native as pnative
from pysparselp_tpu.utils.random_lp import generate_random_lp as jax_random
from pysparselp_tpu_torch.native.gauss_seidel import (
    BoundedGaussSeidel,
    _load_native,
    gauss_seidel,
)
from pysparselp_tpu_torch.ops._build import BUILD_DIR
from pysparselp_tpu_torch.utils.random_lp import generate_random_lp

# the module, not the function the package re-exports under its name
jgs = importlib.import_module("pysparselp_tpu.native.gauss_seidel")
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVES = ("itrn_curve", "pobj_curve", "dobj_curve", "max_violated_equality",
          "max_violated_inequality", "max_violated_constraint")


def _spd(n, seed):
    rng = np.random.RandomState(seed)
    a = scipy.sparse.random(n, n, density=0.1, random_state=rng)
    m = (a @ a.T + n * scipy.sparse.eye(n)).tocsr()  # diagonally dominant
    return m


def test_native_kernel_compiles():
    lib = _load_native()
    assert lib is not None, "g++ kernel failed to build"
    # built into the port's build directory, keyed by the source's hash
    assert os.path.dirname(lib._name) == str(BUILD_DIR)
    assert os.path.basename(lib._name).startswith("_gauss_seidel_")


def test_gauss_seidel_converges():
    m = _spd(40, 0)
    b = np.random.RandomState(1).randn(40)
    x = gauss_seidel(m, np.zeros(40), b, maxiter=200)
    np.testing.assert_allclose(m @ x, b, atol=1e-8)


def test_gauss_seidel_sor_and_order():
    m = _spd(30, 2)
    b = np.random.RandomState(3).randn(30)
    x1 = gauss_seidel(m, np.zeros(30), b, w=1.3, maxiter=150)
    np.testing.assert_allclose(m @ x1, b, atol=1e-8)
    # reversed visit order changes the sweep but not the fixed point
    x2 = gauss_seidel(m, np.zeros(30), b, maxiter=200,
                      order=np.arange(29, -1, -1))
    np.testing.assert_allclose(m @ x2, b, atol=1e-8)


def test_bounded_gauss_seidel_respects_box():
    m = _spd(25, 4)
    b = np.random.RandomState(5).randn(25) * 10
    lb, ub = -0.1 * np.ones(25), 0.1 * np.ones(25)
    x = BoundedGaussSeidel(m).solve(b, lb, ub, np.zeros(25), maxiter=100)
    assert np.all(x >= lb - 1e-12) and np.all(x <= ub + 1e-12)
    # inactive coordinates solve their row exactly
    r = b - m @ x
    inactive = (x > lb + 1e-9) & (x < ub - 1e-9)
    assert np.allclose(r[inactive], 0.0, atol=1e-8)


def test_admm_gauss_seidel_host_mode_solves_lp():
    lp, _ = generate_random_lp(nbvar=25, n_eq=2, n_ineq=25, sparsity=0.25,
                               seed=6)
    ref, _ = lp.solve(method="scipy_simplex")
    x, _ = lp.solve(method="admm", nb_iter=3000, nb_iter_plot=500,
                    inner="gauss_seidel", nb_inner=1, device="cpu")
    assert abs(lp.cost(x) - lp.cost(ref)) < 0.3
    assert lp.max_constraint_violation(x) < 5e-2
    assert len(lp.itrn_curve) == 6  # curve contract in host mode too


def test_admm_inner_modes_agree():
    lp, _ = generate_random_lp(nbvar=20, n_eq=2, n_ineq=20, sparsity=0.3,
                               seed=7)
    x_j, _ = lp.solve(method="admm", nb_iter=4000, nb_iter_plot=4000,
                      device="cpu")
    x_gs, _ = lp.solve(method="admm", nb_iter=4000, nb_iter_plot=4000,
                       inner="gauss_seidel", device="cpu")
    np.testing.assert_allclose(x_j, x_gs, atol=5e-3)


@pytest.mark.parametrize("order", [None, "reversed", "shuffled"])
@pytest.mark.parametrize("w", [1.0, 1.3])
def test_sweeps_bit_equal_to_jax(order, w):
    """The same C++ source gives the same bits: both sweeps, the plain and
    the bounded, against the JAX package's on one matrix and visit order."""
    n = 40
    m = _spd(n, 8)
    rng = np.random.RandomState(9)
    b, x0 = rng.randn(n) * 5, rng.randn(n)
    lb, ub = -0.3 * np.ones(n), 0.2 * np.ones(n)
    if order == "reversed":
        order = np.arange(n - 1, -1, -1)
    elif order == "shuffled":
        order = rng.permutation(n)
    assert jgs._load_native() is not None and _load_native() is not None
    got = gauss_seidel(m, x0.copy(), b, w=w, maxiter=7, order=order)
    want = jgs.gauss_seidel(m, x0.copy(), b, w=w, maxiter=7, order=order)
    np.testing.assert_array_equal(got, want)
    got = BoundedGaussSeidel(m, w=w).solve(b, lb, ub, x0.copy(), maxiter=7,
                                          order=order)
    want = jgs.BoundedGaussSeidel(m, w=w).solve(b, lb, ub, x0.copy(),
                                                maxiter=7, order=order)
    np.testing.assert_array_equal(got, want)


def test_python_fallback_matches_native():
    """The numpy fallback (``_py_sweep``, kept for hosts without g++)
    computes what the native sweep does."""
    from pysparselp_tpu_torch.native.gauss_seidel import _csr_arrays, _py_sweep

    m = _spd(30, 10)
    rng = np.random.RandomState(11)
    b, x0 = rng.randn(30), rng.randn(30)
    lb, ub = -0.5 * np.ones(30), 0.5 * np.ones(30)
    data, indices, indptr, nrows = _csr_arrays(m)
    x_py = x0.copy()
    _py_sweep(data, indices, indptr, x_py, b, lb, ub, range(nrows), 1.1, 5)
    x_nat = BoundedGaussSeidel(m, w=1.1).solve(b, lb, ub, x0.copy(),
                                               maxiter=5)
    np.testing.assert_allclose(x_py, x_nat, rtol=1e-12, atol=1e-14)


def test_admm_gauss_seidel_matches_jax():
    """``lp_admm(inner="gauss_seidel")`` against the JAX package's host mode
    on the same LP: x and every curve within 1e-12; the host loop,
    ``_lp_admm_host_gs``, is the JAX function's source verbatim."""
    import inspect

    import pysparselp_tpu.solvers.admm as jadmm
    import pysparselp_tpu_torch.solvers.admm as padmm

    assert inspect.getsource(padmm._lp_admm_host_gs) == inspect.getsource(
        jadmm._lp_admm_host_gs)
    kw = dict(nbvar=25, n_eq=2, n_ineq=25, sparsity=0.25, seed=2)
    lp_j, lp_p = jax_random(**kw)[0], generate_random_lp(**kw)[0]
    run = dict(method="admm", nb_iter=600, nb_iter_plot=100,
               inner="gauss_seidel", nb_inner=2)
    x_j, _ = lp_j.solve(**run)
    x_p, _ = lp_p.solve(device="cpu", **run)
    np.testing.assert_allclose(x_p, x_j, rtol=1e-12, atol=1e-12)
    assert list(lp_p.itrn_curve) == list(lp_j.itrn_curve) == [
        100, 200, 300, 400, 500, 600]
    for key in CURVES[1:]:
        np.testing.assert_allclose(
            np.asarray(getattr(lp_p, key), float),
            np.asarray(getattr(lp_j, key), float), rtol=1e-12, atol=1e-12,
            err_msg=key)


def test_host_mode_still_resolves_the_device():
    """The host mode runs on the host whatever ``device`` says, but
    ``device`` is still resolved: ``"cuda"`` without a card raises, as
    everywhere else."""
    lp, _ = generate_random_lp(nbvar=10, n_eq=1, n_ineq=10, sparsity=0.3,
                               seed=1)
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        lp.solve(method="admm", nb_iter=10, inner="gauss_seidel")


def test_native_copies():
    """``_gauss_seidel.cpp`` is the original byte for byte (in
    ``test_verbatim_host_copies``); ``gauss_seidel.py`` is the original with
    two header lines and another ``_load_native``; ``native/__init__.py``
    exports the same names."""
    def text(pkg):
        with open(os.path.join(REPO, pkg, "native", "gauss_seidel.py")) as f:
            return f.read()

    def without_loader(src):
        start = src.index("def _load_native():")
        return src[:start] + src[src.index("def _ptr("):]

    port = text("pysparselp_tpu_torch").split("\n", 2)
    assert port[0].startswith("# Copy of pysparselp_tpu/native/")
    assert without_loader(port[2]) == without_loader(text("pysparselp_tpu"))
    assert pnative.__all__ == jnative.__all__
