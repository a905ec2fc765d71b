"""H-DIA (``pysparselp_tpu_torch.ops.dia_spmv``) against the JAX package's
DIA SpMV: the Pallas kernel ``_dia_matvec_pallas`` in interpret mode
(float32), the XLA shift loop of ``DiaMatrix._apply`` and scipy (float64).
H-DIA-B, the batched entry, against the JAX ``XlaDiaMatrix`` under
``jax.vmap`` (the batched solver's DIA product) and scipy, and column by
column against H-DIA; its plan (``dia_spmm_plan``) on the batch path's
operators and Potts-300's offsets, and its tiled, zero-filled window
emulated in numpy against the twin.

JAX is imported inside the parity tests: the card machine, which runs this
file's ``cuda`` cases (``python -m pytest --noconftest -m cuda``), has none."""

import numpy as np
import pytest
import scipy.sparse
import torch

from pysparselp_tpu_torch.ops import dia_spmv as dia_ops
from pysparselp_tpu_torch.ops.dia_spmv import (dia_spmm, dia_spmm_plan,
                                               dia_spmm_reference, dia_spmv,
                                               dia_spmv_reference,
                                               pack_planes)
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
    once with the plan of its batch size (built once, its parameter struct
    holding the plan) and counts it; the twin, patched to raise, is never
    called, and a wrong operand raises instead of running it."""
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
    monkeypatch.setattr(dia_ops, "_max_ctas", lambda op, plan: 264)
    monkeypatch.setattr(dia_ops._build, "stream", lambda index: 0)
    monkeypatch.setattr(torch, "empty", lambda *s, **kw: empty(
        *s, **dict(kw, device="cpu")))
    x = CudaLike(torch.zeros((257, 4), dtype=torch.float64))
    launches = dia_spmm.launches
    y = dia_ops.dia_spmm(op, x)
    assert y.shape == (130, 4) and dia_spmm.launches == launches + 1
    assert len(calls) == 1
    assert calls[0][1:4] == (x.data_ptr(), 257, y.data_ptr())
    launch = op.batch_launch(4, x.data_ptr() % 16 == 0)
    plan = launch.plan
    assert calls[0][0] == launch.address
    assert plan == dia_spmm_plan(130, pd.offsets, 4, 8, x.data_ptr() % 16 == 0)
    s = launch.struct
    assert (s.n_out, s.nb, s.ndiag, s.rows, s.cols, s.cpt) == (
        130, 4, 9, plan.rows, plan.cols, plan.cpt)
    assert list(s.offsets[:9]) == list(pd.offsets)
    assert s.grid == plan.grid(264) and s.smem_bytes == plan.smem_bytes
    assert launch.planes.shape == (plan.row_tiles, 9, plan.rows)
    for bad in (torch.zeros((257, 4), dtype=torch.float32),
                torch.zeros(257, dtype=torch.float64)):
        with pytest.raises(ValueError, match="dia_spmm"):
            dia_ops.dia_spmm(op, CudaLike(bad))
    assert len(calls) == 1 and dia_spmm.launches == launches + 1


# Potts-300's anchor-aligned inequality system (build_linear_program(300,
# 0.5, 500), 359,996 positions; chip_smoke.aligned_potts)
POTTS300_OFFSETS = (-3, -2, -1, 0, 1, 2, 3, 4, 1196, 1197, 1198, 1199, 1200)
BANDED_OFFSETS = (0, 1, 2, 64)
# (n_out, n_in, offsets, B, itemsize) and the expected (rows, union,
# columns a tile): chip_smoke.py's banded batch operator (150,000², B = 16)
# both ways, in float64 too (128 rows: 256 would not fit one stage), the
# DIA block of its assignment system (150,002 x 150,000, offset -1, B = 8)
# both ways (one diagonal: read direct), Potts-300 (a span too wide for
# one window: one range per diagonal), two far diagonals, and the banded
# operator at B = 300 in float64 (a batch row too wide: column tiles)
PLAN_CASES = {
    "banded": ((150_000, 150_000, BANDED_OFFSETS, 16, 4), (256, True, 16)),
    "banded_t": ((150_000, 150_000, (-64, -2, -1, 0), 16, 4),
                 (256, True, 16)),
    "banded_f64": ((150_000, 150_000, BANDED_OFFSETS, 16, 8),
                   (128, True, 16)),
    "assignment": ((150_002, 150_000, (-1,), 8, 4), (256, True, 8)),
    "assignment_t": ((150_000, 150_002, (1,), 8, 4), (256, True, 8)),
    "potts300": ((359_996, 359_996, POTTS300_OFFSETS, 16, 4),
                 (32, False, 16)),
    "far_pair": ((20_000, 30_000, (0, 5000), 16, 4), (128, False, 16)),
    "banded_b300_f64": ((150_000, 150_000, BANDED_OFFSETS, 300, 8),
                        (32, True, 40)),
}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_dia_spmm_plan(name):
    """The plan's tile, mode and copy list: every tile's ranges lie in
    ``[0, n_in)`` and land in its window where the tile's rows read them
    (so the window's other rows are exactly the reads outside X), both
    stages fit the H100's 227 KB, and a stage fits ``STAGE_BYTES``; one
    diagonal is read direct (nothing staged)."""
    (n_out, n_in, offsets, nb, itemsize), (rows, union, cols) = \
        PLAN_CASES[name]
    plan = dia_spmm_plan(n_out, offsets, nb, itemsize)
    assert (plan.rows, plan.union, plan.cols) == (rows, union, cols)
    assert plan.cpt == 16 // itemsize
    assert plan.direct == (len(offsets) == 1)
    assert plan.bulk == (cols == nb and not plan.direct)
    assert plan.smem_bytes <= dia_ops.SMEM_LIMIT
    assert plan.stage_bytes <= dia_ops.STAGE_BYTES
    assert plan.stage_bytes % 128 == 0 and plan.rows * itemsize % 16 == 0
    span = max(offsets) - min(offsets)
    assert plan.window_rows == (rows + span if union
                                else len(offsets) * rows)
    assert plan.n_tiles == -(-n_out // rows) * -(-nb // cols)
    for tile in (0, 1, plan.n_tiles // 2, plan.n_tiles - 1):
        r0 = tile // plan.col_tiles * rows
        staged = np.zeros(plan.window_rows, bool)
        for first, stop, at in plan.ranges(tile, n_in):
            assert 0 <= first < stop <= n_in
            assert not staged[at:at + stop - first].any()
            staged[at:at + stop - first] = True
        # the X row each window row stands for
        if union:
            want = r0 + min(offsets) + np.arange(plan.window_rows)
        else:
            want = (r0 + np.repeat(offsets, rows)
                    + np.tile(np.arange(rows), len(offsets)))
        np.testing.assert_array_equal(staged, (want >= 0) & (want < n_in))
    if name == "banded":
        assert plan.ranges(0, n_in) == [(0, 320, 0)]
        assert plan.ranges(585, n_in) == [(149_760, 150_000, 0)]
    if name == "banded_t":
        assert plan.ranges(0, n_in) == [(0, 256, 64)]
    if name == "assignment":
        assert plan.ranges(0, n_in) == [(0, 255, 1)]
        assert plan.ranges(plan.n_tiles - 1, n_in) == [(149_759, 150_000,
                                                        0)]
        assert plan.stage_bytes == 0 and plan.smem_bytes == 20
    if name == "potts300":
        assert plan.ranges(0, n_in) == [
            (max(o, 0), o + 32, max(-o, 0) + d * 32)
            for d, o in enumerate(POTTS300_OFFSETS)]


def _emulate_tiles(plan, vals, x):
    """H-DIA-B's tiles on ``plan`` in numpy, ``x`` (n_in, B): per tile the
    staged planes (tile-major, zero past n_out) and window (the plan's
    ranges of X, zeros elsewhere), then per row and column the diagonals
    in order, each product and add rounded."""
    n_in, nb = x.shape
    packed = pack_planes(torch.as_tensor(vals), plan).numpy()
    y = np.full((plan.n_out, nb), np.nan, x.dtype)
    i = np.arange(plan.rows)
    for tile in range(plan.n_tiles):
        rt, ct = divmod(tile, plan.col_tiles)
        r0, c0 = rt * plan.rows, ct * plan.cols
        cw = min(plan.cols, nb - c0)
        win = np.zeros((plan.window_rows, plan.cols), x.dtype)
        for first, stop, at in plan.ranges(tile, n_in):
            win[at:at + stop - first, :cw] = x[first:stop, c0:c0 + cw]
        acc = np.zeros((plan.rows, plan.cols), x.dtype)
        for d, off in enumerate(plan.offsets):
            w = i + off - plan.off_min if plan.union else d * plan.rows + i
            acc = acc + packed[rt, d][:, None] * win[w]
        rows = min(plan.rows, plan.n_out - r0)
        y[r0:r0 + rows, c0:c0 + cw] = acc[:rows, :cw]
    return y


def _plan_variants(n_out, offsets, nb, itemsize):
    """The default plan, and forced ones: one range per diagonal, few
    rows, column tiles, X not 16-byte aligned (one column a thread,
    ``cp.async``), and read direct (nothing staged)."""
    vec = 16 // itemsize
    return {
        "default": dia_spmm_plan(n_out, offsets, nb, itemsize),
        "per_diagonal": dia_spmm_plan(n_out, offsets, nb, itemsize,
                                      union=False),
        "rows_8": dia_spmm_plan(n_out, offsets, nb, itemsize, rows=8),
        "column_tiles": dia_spmm_plan(
            n_out, offsets, nb, itemsize, rows=16,
            cols=vec if nb % vec == 0 and nb > vec else 1),
        "unaligned": dia_spmm_plan(n_out, offsets, nb, itemsize,
                                   aligned=False),
        "direct": dia_spmm_plan(n_out, offsets, nb, itemsize, direct=True),
    }


@pytest.mark.parametrize("nb", [1, 3, 16])
@pytest.mark.parametrize("m,n,ndiag,seed", CASES)
def test_emulated_tiles_match_twin_bitwise(m, n, ndiag, seed, nb):
    """The tiled window, emulated, equals the batched twin bit for bit, in
    float32 and float64, both orientations (n_in != n_out, offsets of
    both signs), on the default plan and the forced ones."""
    a = _random_dia(m, n, ndiag, seed)
    for dtype in (torch.float32, torch.float64):
        pd = DiaMatrix.from_scipy(a, dtype, "cpu")
        for side, n_in, offsets in ((pd.fwd, n, pd.offsets),
                                    (pd.bwd, m, pd.offsets_t)):
            x = torch.as_tensor(_batch(n_in, nb, seed), dtype=dtype)
            want = dia_spmm_reference(side.vals, side.offs, x,
                                      side.n_out).numpy()
            variants = _plan_variants(side.n_out, offsets, nb,
                                      x.element_size())
            for label, plan in variants.items():
                got = _emulate_tiles(plan, side.vals.numpy(), x.numpy())
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{label} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_kernel_matches_twin_and_1d_kernel_on_cuda(dtype):
    """H-DIA-B equals its twin bit for bit and, column by column, H-DIA's
    launch on that column; one launch per product at B = 1, 3 and 16, on
    the default plan and the forced ones of :func:`_plan_variants` (one
    range per diagonal, few rows, column tiles, ``cp.async``, direct),
    and with X at a storage offset that is not 16-byte aligned (its own
    plan); a plan that needs an aligned X raises on it."""
    dev = cuda_or_skip()
    for m, n, ndiag, seed in CASES:
        pd = DiaMatrix.from_scipy(_random_dia(m, n, ndiag, seed), dtype,
                                  dev)
        for nb in (1, 3, 16):
            for side, n_in, offsets in ((pd.fwd, n, pd.offsets),
                                        (pd.bwd, m, pd.offsets_t)):
                xh = _batch(n_in, nb, seed)
                x = torch.as_tensor(xh, dtype=dtype, device=dev)
                want = dia_spmm_reference(side.vals, side.offs, x,
                                          side.n_out)
                columns = torch.stack(
                    [dia_ops.dia_apply(side, x[:, b].contiguous())
                     for b in range(nb)], dim=1)
                launches = dia_spmm.launches
                got = dia_ops.dia_spmm(side, x)
                assert dia_spmm.launches == launches + 1
                torch.testing.assert_close(got, want, rtol=0, atol=0)
                assert torch.equal(got, columns), (m, n, nb)
                for label, plan in _plan_variants(
                        side.n_out, offsets, nb, x.element_size()).items():
                    got = dia_ops.dia_spmm(side, x, plan=plan)
                    assert torch.equal(got, want), (m, n, nb, label)
                # X at a storage offset of one value: not 16-byte aligned
                buf = torch.zeros(n_in * nb + 1, dtype=dtype, device=dev)
                xu = buf[1:].view(n_in, nb)
                xu.copy_(x)
                assert xu.data_ptr() % 16 != 0
                assert torch.equal(dia_ops.dia_spmm(side, xu), want)
                if nb % (16 // x.element_size()) == 0:
                    with pytest.raises(ValueError, match="aligned"):
                        dia_ops.dia_spmm(side, xu, plan=dia_spmm_plan(
                            side.n_out, offsets, nb, x.element_size()))
