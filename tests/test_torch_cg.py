"""The port's device conjugate gradient (``ops/cg.py``), its factor-once
solvers (``ops/linear_solve.py``) and the operators' ``sq_rowsum_weighted``
(``Σ_j a_ij² d_j`` per row), against the JAX package's on the same inputs
(float64 on the CPU, 1e-12), and, on a card, against their CPU twins.

JAX is imported inside the parity tests: the card machine, which runs this
file's ``cuda`` cases (``python -m pytest --noconftest -m cuda``), has
none."""

import numpy as np
import pytest
import scipy.sparse
import torch

import chip_smoke
from pysparselp_tpu_torch import problem as ppr
from pysparselp_tpu_torch.ops import cg as pcg
from pysparselp_tpu_torch.ops import csr_spmv, dia_spmv
from pysparselp_tpu_torch.ops import bsr_spmv
from pysparselp_tpu_torch.ops.linear_solve import (CgSolver, DenseCholesky,
                                                   make_spd_solver)
from torch_port_helpers import cuda_or_skip, host_system, sc105_lp

torch.set_num_threads(1)


def _spd(n, seed, spread=1.0):
    """A random SPD matrix with eigenvalues from 1 to 10**spread.  Well
    conditioned, so CG reaches each exit before rounding drives two
    products of another summation order apart (on a 40-dimensional
    system with eigenvalues over three decades, JAX's and the port's
    iterates part at 1e-6 by step 20, as any two matmuls would)."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(n, n))
    return (q * np.logspace(0, spread, n)) @ q.T


# (tol, maxiter, preconditioned, x0): one system per case
CG_CASES = {
    "plain": (1e-10, 100, False, False),
    "jacobi": (1e-10, 100, True, False),
    "early_exit": (1e-3, 100, True, False),
    "maxiter_cut": (1e-14, 7, False, False),
    "x0": (1e-10, 100, True, True),
}


def _cg_inputs(case, seed=0):
    tol, maxiter, pre, with_x0 = CG_CASES[case]
    m = _spd(40, seed)
    rng = np.random.RandomState(seed + 1)
    return m, rng.randn(40), rng.randn(40) if with_x0 else None, tol, \
        maxiter, pre


def _port_cg(m, b, x0, tol, maxiter, pre, dtype=torch.float64):
    mt = torch.as_tensor(m, dtype=dtype)
    inv = 1.0 / torch.diagonal(mt)
    return pcg.conjgrad(
        lambda v: mt @ v, torch.as_tensor(b, dtype=dtype),
        x0=None if x0 is None else torch.as_tensor(x0, dtype=dtype),
        maxiter=maxiter, tol=tol, precond=(lambda r: inv * r) if pre else None)


@pytest.mark.parametrize("case", sorted(CG_CASES))
def test_conjgrad_matches_jax(case):
    import jax.numpy as jnp

    from pysparselp_tpu.ops.cg import conjgrad as jax_cg

    m, b, x0, tol, maxiter, pre = _cg_inputs(case)
    mj = jnp.asarray(m)
    inv = 1.0 / jnp.diagonal(mj)
    want = np.asarray(jax_cg(
        lambda v: mj @ v, jnp.asarray(b),
        x0=None if x0 is None else jnp.asarray(x0), maxiter=maxiter, tol=tol,
        precond=(lambda r: inv * r) if pre else None))
    got = _port_cg(m, b, x0, tol, maxiter, pre).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    if case == "early_exit":
        # the exit came before the cap: the solution is not converged
        assert np.linalg.norm(m @ got - b) > 1e-6 * np.linalg.norm(b)


def test_frozen_steps_change_nothing(monkeypatch):
    """Steps past the exit are frozen: reading the stopping flag every
    step, every 16 steps or never gives the same bits; the solve runs to
    the next read of the flag."""
    m, b, x0, tol, maxiter, pre = _cg_inputs("early_exit")
    shipped = pcg.CHECK_EVERY
    results = {}
    for every in (1, shipped, 1000):
        monkeypatch.setattr(pcg, "CHECK_EVERY", every)
        steps = pcg.conjgrad.steps
        results[every] = (_port_cg(m, b, x0, tol, maxiter, pre),
                          pcg.conjgrad.steps - steps)
    exact = results[1][1]
    assert 0 < exact < shipped
    assert results[shipped][1] == shipped
    assert results[1000][1] == maxiter
    for x, _ in results.values():
        assert torch.equal(x, results[1][0])


def test_conjgrad_float32_floor_is_zero():
    """``max(‖b‖, 1e-300)`` is 0 in float32 (as in the JAX loop): a zero
    right-hand side returns the start point in both packages."""
    import jax.numpy as jnp

    from pysparselp_tpu.ops.cg import conjgrad as jax_cg

    m = _spd(10, 3)
    x0 = np.random.RandomState(4).randn(10)
    mj = jnp.asarray(m, jnp.float32)
    want = np.asarray(jax_cg(lambda v: mj @ v, jnp.zeros(10, jnp.float32),
                             x0=jnp.asarray(x0, jnp.float32), tol=1e-10))
    mt = torch.as_tensor(m, dtype=torch.float32)
    got = pcg.conjgrad(lambda v: mt @ v, torch.zeros(10),
                       x0=torch.as_tensor(x0, dtype=torch.float32), tol=1e-10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_linear_solve_wrappers_match_jax():
    """``tests/test_instrumentation.py::test_linear_solve_wrappers`` on
    both packages: each port solver within 1e-12 of JAX's."""
    import jax.numpy as jnp

    from pysparselp_tpu.ops import linear_solve as jls

    rng = np.random.RandomState(0)
    a = rng.randn(30, 30)
    m = a @ a.T + 30 * np.eye(30)
    b = rng.randn(30)
    ref = np.linalg.solve(m, b)
    sp = scipy.sparse.csr_matrix(m)
    mt = torch.as_tensor(m)
    bt = torch.as_tensor(b)
    mj = jnp.asarray(m)
    pairs = [
        (DenseCholesky(m, device="cpu").solve(b), jls.DenseCholesky(m).solve(b),
         1e-8),
        (make_spd_solver(sp, device="cpu").solve(b),
         jls.make_spd_solver(sp).solve(b), 1e-8),
        (CgSolver(lambda v: mt @ v, diag=np.diag(m), maxiter=300).solve(bt),
         jls.CgSolver(lambda v: mj @ v, diag=np.diag(m), maxiter=300).solve(
             jnp.asarray(b)), 1e-6),
        (make_spd_solver(sp, dense_max_dim=10, diag=np.diag(m),
                         device="cpu").solve(bt),
         jls.make_spd_solver(sp, dense_max_dim=10, diag=np.diag(m)).solve(
             jnp.asarray(b)), 1e-6),
        (make_spd_solver(sp, dense_max_dim=10, device="cpu").solve(bt),
         jls.make_spd_solver(sp, dense_max_dim=10).solve(jnp.asarray(b)),
         1e-6),
    ]
    for got, want, atol in pairs:
        np.testing.assert_allclose(got.numpy(), ref, atol=atol)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)


def test_failed_cholesky_gives_nan_and_does_not_raise():
    """A matrix that is not positive definite: JAX's ``cho_factor`` gives
    NaN, and so does the port's factor (``ok`` False), without raising."""
    from pysparselp_tpu.ops import linear_solve as jls

    m = _spd(12, 5) - 2e3 * np.eye(12)
    b = np.random.RandomState(6).randn(12)
    dc = DenseCholesky(m, device="cpu")
    assert not bool(dc.ok)
    got = dc.solve(b).numpy()
    assert np.isnan(got).all()
    assert np.isnan(np.asarray(jls.DenseCholesky(m).solve(b))).all()


# ----------------------------------------------------------------------
# sq_rowsum_weighted
# ----------------------------------------------------------------------


def _kmedians_ineq():
    return host_system(chip_smoke.kmedians_lp(n_points=40,
                                              n_candidates=6))["a_ineq"]


def _banded(m=60, n=50, seed=2):
    rng = np.random.RandomState(seed)
    rows = np.arange(m).repeat(4)
    cols = np.clip(rows + np.tile([-3, 0, 1, 9], m), 0, n - 1)
    return scipy.sparse.csr_matrix((rng.randn(rows.size), (rows, cols)),
                                   shape=(m, n))


def _sc105_ineq():
    return host_system(sc105_lp(port=True)[0])["a_ineq"]


def _partition():
    """Simplex rows: one contiguous run of 5 columns per row, stride 7."""
    rng = np.random.RandomState(8)
    rows = np.arange(30).repeat(5)
    cols = (np.arange(30) * 7)[:, None].repeat(5, 1).ravel() + np.tile(
        np.arange(5), 30)
    return scipy.sparse.csr_matrix((rng.rand(rows.size) + 0.5, (rows, cols)),
                                   shape=(30, 30 * 7))


# port backend -> (host matrix, the JAX ell_from_scipy backend, port class)
SQ_CASES = {
    "dense": (_sc105_ineq, "dense", ppr.DenseMatrix),
    "dia": (_banded, "dia", ppr.DiaMatrix),
    "csr": (_sc105_ineq, "ell", ppr.CsrMatrix),
    "bsr": (_banded, "bsr", ppr.BsrMatrix),
    "partition": (_partition, "partition", ppr.PartitionMatrix),
    "split": (_kmedians_ineq, "split", ppr.ColBlockMatrix),
}


def _d(n, seed=9):
    return np.random.RandomState(seed).rand(n) * 3 + 0.1


@pytest.mark.parametrize("case", sorted(SQ_CASES))
def test_sq_rowsum_weighted_matches_jax(case):
    import jax.numpy as jnp

    from pysparselp_tpu import problem as jpr

    make, jax_backend, kind = SQ_CASES[case]
    a = scipy.sparse.csr_matrix(make())
    op = ppr.ell_from_scipy(a, torch.float64, "cpu", prefer=case)
    assert isinstance(op, kind)
    if jax_backend == "dia":
        jop = jpr.DiaMatrix.from_scipy(a, dtype=jnp.float64,
                                       allow_bf16=False)
    else:
        jop = jpr.ell_from_scipy(a, dtype=jnp.float64, prefer=jax_backend)
    d = _d(a.shape[1])
    got = op.sq_rowsum_weighted(torch.as_tensor(d)).numpy()
    want = np.asarray(jop.sq_rowsum_weighted(jnp.asarray(d)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got, a.multiply(a) @ d, rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("jax_backend", [None, "ell", "segmented", "routed",
                                         "bsr", "split"])
def test_sq_rowsum_weighted_through_convert(jax_backend):
    """The operator the JAX ``ell_from_scipy`` builds, carried to the port
    by ``utils/convert.py::operator_from_jax``, gives JAX's row sums."""
    import jax.numpy as jnp

    from pysparselp_tpu import problem as jpr
    from pysparselp_tpu_torch.utils.convert import operator_from_jax

    a = scipy.sparse.csr_matrix(_kmedians_ineq() if jax_backend == "split"
                                else _sc105_ineq())
    jop = jpr.ell_from_scipy(a, dtype=jnp.float64, prefer=jax_backend)
    op = operator_from_jax(jop, torch.float64, "cpu")
    d = _d(a.shape[1], 10)
    np.testing.assert_allclose(
        op.sq_rowsum_weighted(torch.as_tensor(d)).numpy(),
        np.asarray(jop.sq_rowsum_weighted(jnp.asarray(d))), rtol=1e-12,
        atol=1e-14)


def test_squared_operand_is_built_once():
    """The squared operand is built on the first call and kept; the CSR
    one shares A's launch plan."""
    a = _sc105_ineq()
    d = torch.as_tensor(_d(a.shape[1]))
    for prefer in ("dia", "csr", "bsr"):
        op = ppr.ell_from_scipy(a, torch.float64, "cpu", prefer=prefer)
        first = op.sq_rowsum_weighted(d)
        sq = op._sq
        assert torch.equal(op.sq_rowsum_weighted(d), first)
        assert op._sq is sq
        if prefer == "csr":
            assert sq.plan is op.csr.plan


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sq_rowsum_weighted_on_cuda(dtype):
    """H-DIA, H-CSR and H-BSR on the squared operands against the CPU
    twins (one launch each)."""
    dev = cuda_or_skip()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for prefer, counter in (("dia", dia_spmv.dia_spmv),
                            ("csr", csr_spmv.csr_spmv),
                            ("bsr", bsr_spmv.bsr_spmv)):
        a = _banded()
        d = _d(a.shape[1])
        want = ppr.ell_from_scipy(a, dtype, "cpu", prefer=prefer) \
            .sq_rowsum_weighted(torch.as_tensor(d, dtype=dtype))
        op = ppr.ell_from_scipy(a, dtype, dev, prefer=prefer)
        launches = counter.launches
        got = op.sq_rowsum_weighted(torch.as_tensor(d, dtype=dtype,
                                                    device=dev))
        assert counter.launches == launches + 1
        torch.testing.assert_close(got.cpu(), want, rtol=tol,
                                   atol=tol * float(want.abs().max()))


@pytest.mark.cuda
def test_conjgrad_on_cuda_matches_cpu():
    """The CG loop on the card (H-CSR products) against the same loop on
    the CPU twin, float64."""
    dev = cuda_or_skip()
    a = _banded(80, 80, 4)
    m = scipy.sparse.csr_matrix(a @ a.T + 10 * scipy.sparse.eye(80))
    b = np.random.RandomState(3).randn(80)
    out = []
    for device in ("cpu", dev):
        op = ppr.ell_from_scipy(m, torch.float64, device, prefer="csr")
        out.append(pcg.conjgrad(op.matvec, torch.as_tensor(b, device=device),
                                maxiter=100, tol=1e-12).cpu())
    torch.testing.assert_close(out[1], out[0], rtol=1e-10, atol=1e-12)
