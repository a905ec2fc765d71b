"""H-DIA (``pysparselp_tpu_torch.ops.dia_spmv``) against the JAX package's
DIA SpMV: the Pallas kernel ``_dia_matvec_pallas`` in interpret mode
(float32), the XLA shift loop of ``DiaMatrix._apply`` and scipy (float64).
H-DIA-B, the batched entry, against the JAX ``XlaDiaMatrix`` under
``jax.vmap`` (the batched solver's DIA product) and scipy, and column by
column against H-DIA.

JAX is imported inside the parity tests: the card machine, which runs this
file's ``cuda`` cases (``python -m pytest --noconftest -m cuda``), has none."""

import numpy as np
import pytest
import scipy.sparse
import torch

from pysparselp_tpu_torch.ops import dia_spmv as dia_ops
from pysparselp_tpu_torch.ops.dia_spmv import (dia_spmm, dia_spmm_reference,
                                               dia_spmv, dia_spmv_reference)
from pysparselp_tpu_torch.problem import DiaMatrix
from torch_port_helpers import CudaLike, cuda_or_skip

torch.set_num_threads(1)

CASES = [
    (130, 257, 9, 0),       # unaligned shapes, offsets on both sides
    (64, 64, 5, 1),
    (700, 300, 25, 2),      # more rows than columns
    (300, 700, 17, 3),      # offsets beyond +/-128
]


def _random_dia(m, n, ndiag, seed, frac=0.6):
    rng = np.random.RandomState(seed)
    offs = rng.choice(np.arange(-m + 1, n), size=ndiag, replace=False)
    offs[0], offs[1] = -min(m - 1, 7), min(n - 1, 11)  # both signs present
    rows, cols, vals = [], [], []
    for o in np.unique(offs):
        r = np.arange(max(0, -o), min(m, n - o))
        r = r[rng.rand(r.size) < frac]
        rows.append(r)
        cols.append(r + o)
        vals.append(rng.randn(r.size))
    return scipy.sparse.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(m, n)).tocsr()


def _jax():
    import jax.numpy as jnp

    from pysparselp_tpu import problem as jpr
    from pysparselp_tpu.ops import dia_pallas

    return jnp, jpr, dia_pallas


def _vectors(m, n, seed):
    rng = np.random.RandomState(seed + 100)
    return rng.randn(n), rng.randn(m)


@pytest.mark.parametrize("m,n,ndiag,seed", [CASES[0], CASES[1], CASES[3]])
def test_twin_matches_pallas_kernel_f32(m, n, ndiag, seed):
    """f32: the port's twin against the TPU kernel run in interpret mode;
    rtol 1e-6 because the two may round the sums differently."""
    jnp, jpr, dia_pallas = _jax()
    a = _random_dia(m, n, ndiag, seed)
    x, y = _vectors(m, n, seed)
    jd = jpr.DiaMatrix.from_scipy(a, dtype=jnp.float32, allow_bf16=False)
    pd = DiaMatrix.from_scipy(a, torch.float32, "cpu")
    for vals, offsets, v, n_in, n_out, pv, poffs in (
            (jd.vals, jd.offsets, x, n, m, pd.vals, pd.offs),
            (jd.vals_t, jd.offsets_t, y, m, n, pd.vals_t, pd.offs_t)):
        want = np.asarray(dia_pallas._dia_matvec_pallas(
            vals, offsets, jnp.asarray(v, jnp.float32), n_in, n_out,
            interpret=True))
        got = dia_spmv(pv, poffs, torch.as_tensor(v, dtype=torch.float32),
                       n_out).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m,n,ndiag,seed", CASES)
def test_twin_matches_xla_and_scipy_f64(m, n, ndiag, seed):
    """f64: the twin against the JAX DiaMatrix XLA shift loop and scipy."""
    jnp, jpr, _ = _jax()
    a = _random_dia(m, n, ndiag, seed)
    x, y = _vectors(m, n, seed)
    jd = jpr.DiaMatrix.from_scipy(a, dtype=jnp.float64)
    pd = DiaMatrix.from_scipy(a, torch.float64, "cpu")
    got = pd.matvec(torch.as_tensor(x)).numpy()
    got_t = pd.rmatvec(torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jd.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_t, np.asarray(jd.rmatvec(jnp.asarray(y))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, a @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_t, a.T @ y, rtol=1e-12, atol=1e-12)


def test_operator_reductions_match_jax():
    """Preconditioner reductions of the port's DIA operator equal the JAX
    operator's, and its planes hold exactly the matrix (f64)."""
    jnp, jpr, _ = _jax()
    a = _random_dia(300, 700, 17, 3)
    jd = jpr.DiaMatrix.from_scipy(a, dtype=jnp.float64)
    pd = DiaMatrix.from_scipy(a, torch.float64, "cpu")
    for p in (0.0, 1.0, 2.0):
        np.testing.assert_allclose(pd.abs_power_rowsum(p).numpy(),
                                   np.asarray(jd.abs_power_rowsum(p)),
                                   rtol=1e-12)
        np.testing.assert_allclose(pd.abs_power_colsum(p).numpy(),
                                   np.asarray(jd.abs_power_colsum(p)),
                                   rtol=1e-12)
    dense = np.zeros(a.shape)
    for d, off in enumerate(pd.offsets):
        rows = np.arange(max(0, -off), min(a.shape[0], a.shape[1] - off))
        dense[rows, rows + off] = pd.vals[d, rows].numpy()
    np.testing.assert_array_equal(dense, a.toarray())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_twin_on_cuda(dtype):
    """The CUDA kernel rounds exactly as its twin (no FMA contraction)."""
    dev = cuda_or_skip()
    a = _random_dia(700, 300, 25, 2)
    x, y = _vectors(700, 300, 2)
    pd = DiaMatrix.from_scipy(a, dtype, dev)
    xt = torch.as_tensor(x, dtype=dtype, device=dev)
    yt = torch.as_tensor(y, dtype=dtype, device=dev)
    launches = dia_spmv.launches
    torch.testing.assert_close(
        dia_spmv(pd.vals, pd.offs, xt, pd.nrows),
        dia_spmv_reference(pd.vals, pd.offs, xt, pd.nrows), rtol=0, atol=0)
    torch.testing.assert_close(
        dia_spmv(pd.vals_t, pd.offs_t, yt, pd.ncols),
        dia_spmv_reference(pd.vals_t, pd.offs_t, yt, pd.ncols), rtol=0,
        atol=0)
    assert dia_spmv.launches == launches + 2


def _batch(rows, nb, seed):
    return np.random.RandomState(seed + 200).randn(rows, nb)


@pytest.mark.parametrize("m,n,ndiag,seed", CASES)
def test_batched_twin_matches_vmapped_xla_dia_and_scipy(m, n, ndiag, seed):
    """f64: the batched twin, through ``DiaMatrix.matvec``/``rmatvec`` on
    a batch-last operand, against the JAX batched solver's
    ``XlaDiaMatrix`` under ``jax.vmap`` and scipy; each column equals the
    1-D twin bit for bit."""
    import jax
    import jax.numpy as jnp

    from pysparselp_tpu.batch import XlaDiaMatrix

    a = _random_dia(m, n, ndiag, seed)
    jd = XlaDiaMatrix.from_scipy(a, jnp.float64)
    pd = DiaMatrix.from_scipy(a, torch.float64, "cpu")
    for nb in (1, 5):
        x, y = _batch(n, nb, seed), _batch(m, nb, seed + 1)
        got = pd.matvec(torch.as_tensor(x))
        got_t = pd.rmatvec(torch.as_tensor(y))
        assert got.shape == (m, nb) and got_t.shape == (n, nb)
        want = np.asarray(jax.vmap(jd.matvec)(jnp.asarray(x.T))).T
        want_t = np.asarray(jax.vmap(jd.rmatvec)(jnp.asarray(y.T))).T
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(got.numpy(), a @ x, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(got_t.numpy(), a.T @ y, rtol=1e-12,
                                   atol=1e-12)
        for b in range(nb):
            np.testing.assert_array_equal(
                got[:, b].numpy(),
                dia_spmv_reference(pd.vals, pd.offs,
                                   torch.as_tensor(x[:, b]), m).numpy())
            np.testing.assert_array_equal(
                got_t[:, b].numpy(),
                dia_spmv_reference(pd.vals_t, pd.offs_t,
                                   torch.as_tensor(y[:, b]), n).numpy())


def test_batched_wrapper_on_cuda_launches_and_never_runs_the_twin(
        monkeypatch):
    """For a CUDA operand the batched wrapper launches H-DIA-B's entry
    once and counts it; the twin, patched to raise, is never called, and a
    wrong operand raises instead of running it."""
    a = _random_dia(130, 257, 9, 0)
    pd = DiaMatrix.from_scipy(a, torch.float64, "cpu")
    op = pd.fwd
    calls = []
    op.device, op.device_index = torch.device("cuda"), 0
    op.entry_b = lambda *args: calls.append(args)

    def twin(*_args):
        raise AssertionError("the twin ran for a CUDA operand")

    empty = torch.empty
    monkeypatch.setattr(dia_ops, "dia_spmm_reference", twin)
    monkeypatch.setattr(dia_ops._build, "stream", lambda index: 0)
    monkeypatch.setattr(torch, "empty", lambda *s, **kw: empty(
        *s, **dict(kw, device="cpu")))
    x = CudaLike(torch.zeros((257, 4), dtype=torch.float64))
    launches = dia_spmm.launches
    y = dia_ops.dia_spmm(op, x)
    assert y.shape == (130, 4) and dia_spmm.launches == launches + 1
    assert len(calls) == 1 and calls[0][1:4] == (257, y.data_ptr(), 130)
    assert calls[0][4] == 4
    for bad in (torch.zeros((257, 4), dtype=torch.float32),
                torch.zeros(257, dtype=torch.float64)):
        with pytest.raises(ValueError, match="dia_spmm"):
            dia_ops.dia_spmm(op, CudaLike(bad))
    assert len(calls) == 1 and dia_spmm.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_kernel_matches_twin_and_1d_kernel_on_cuda(dtype):
    """H-DIA-B equals its twin bit for bit and, column by column, H-DIA's
    launch on that column; one launch per product at B = 1, 3 and 16."""
    dev = cuda_or_skip()
    for m, n, ndiag, seed in CASES:
        pd = DiaMatrix.from_scipy(_random_dia(m, n, ndiag, seed), dtype,
                                  dev)
        for nb in (1, 3, 16):
            for side, n_in in ((pd.fwd, n), (pd.bwd, m)):
                x = torch.as_tensor(_batch(n_in, nb, seed), dtype=dtype,
                                    device=dev)
                launches = dia_spmm.launches
                got = dia_ops.dia_spmm(side, x)
                assert dia_spmm.launches == launches + 1
                torch.testing.assert_close(
                    got, dia_spmm_reference(side.vals, side.offs, x,
                                            side.n_out), rtol=0, atol=0)
                for b in range(nb):
                    torch.testing.assert_close(
                        got[:, b], dia_ops.dia_apply(side,
                                                     x[:, b].contiguous()),
                        rtol=0, atol=0)
