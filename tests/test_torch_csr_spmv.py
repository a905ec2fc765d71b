"""H-CSR (``pysparselp_tpu_torch.ops.csr_spmv``) against scipy (float64)
and against the JAX package's routed gather kernels K7
(``_routed_spmv_call``, one table) and K8 (``_routed_tiled_spmv_call``,
tiled table) run in interpret mode (float32), through ``CsrMatrix``.
H-CSR-B, the batched entry on the same plan, against scipy and the JAX
batched solver's gather-ELL product under ``jax.vmap`` (float64), and its
summation order emulated in numpy, and held column by column near H-CSR's.

JAX is imported inside the parity tests: the card machine, which runs this
file's ``cuda`` cases (``python -m pytest --noconftest -m cuda``), has none."""

import re

import numpy as np
import pytest
import scipy.sparse
import torch

from pysparselp_tpu_torch.ops import csr_spmv as ops
from pysparselp_tpu_torch.problem import CsrMatrix
from torch_port_helpers import CudaLike, cuda_or_skip

torch.set_num_threads(1)


def _rand(m, n, density, seed):
    rng = np.random.RandomState(seed)
    return scipy.sparse.random(m, n, density=density, random_state=rng,
                               format="csr")


def _hot_column():
    """Every row references column 7 (``tests/test_ell_routed.py:43-55``)."""
    m, n = 300, 200
    a = scipy.sparse.csr_matrix((np.ones(m), (np.arange(m), np.full(m, 7))),
                                shape=(m, n))
    return (a + _rand(m, n, 0.02, seed=3)).tocsr()


def _empty_and_dense_rows():
    """Empty rows beside one full row (``tests/test_ell_routed.py:57-68``)."""
    a = scipy.sparse.lil_matrix((64, 256))
    a[10] = 1.0
    a[20, 5] = 3.0
    return a.tocsr()


def _long_rows():
    """Rows far past the sub-warp limit (the k-medians ``used[c]`` shape):
    a few 5,000-entry rows among 2-entry rows, and empty rows."""
    rng = np.random.RandomState(6)
    m, n = 400, 6000
    rows = [np.repeat(np.arange(0, m, 2), 2)]
    cols = [rng.randint(0, n, rows[0].size)]
    for r in (3, 101, 257):
        rows.append(np.full(5000, r))
        cols.append(rng.choice(n, 5000, replace=False))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return scipy.sparse.csr_matrix((rng.randn(rows.size), (rows, cols)),
                                   shape=(m, n))


MATRICES = {
    "rand_200x200": lambda: _rand(200, 200, 0.03, 403),
    "rand_500x120": lambda: _rand(500, 120, 0.05, 623),
    "rand_90x700": lambda: _rand(90, 700, 0.02, 793),
    "hot_column": _hot_column,
    "empty_and_dense_rows": _empty_and_dense_rows,
    "long_rows": _long_rows,
}


def _vectors(a, seed, dtype=np.float64):
    rng = np.random.RandomState(seed)
    return (rng.randn(a.shape[1]).astype(dtype),
            rng.randn(a.shape[0]).astype(dtype))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_twin_matches_scipy_f64(name):
    a = MATRICES[name]()
    x, y = _vectors(a, 0)
    op = CsrMatrix.from_scipy(a, torch.float64, "cpu")
    np.testing.assert_allclose(op.matvec(torch.as_tensor(x)).numpy(), a @ x,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op.rmatvec(torch.as_tensor(y)).numpy(),
                               a.T @ y, rtol=1e-12, atol=1e-12)
    for p in (0.0, 1.0, 2.0):
        ap = abs(a)
        ap.data = np.where(ap.data > 0, ap.data ** p, 0.0)
        np.testing.assert_allclose(op.abs_power_rowsum(p).numpy(),
                                   ap @ np.ones(a.shape[1]), rtol=1e-12)
        np.testing.assert_allclose(op.abs_power_colsum(p).numpy(),
                                   ap.T @ np.ones(a.shape[0]), rtol=1e-12)
    assert op.shape == a.shape and op.nnz_padded == a.nnz


ROUTED = [("k7", "rand_200x200"), ("k7", "hot_column"),
          ("k7", "empty_and_dense_rows"), ("k8", "tiled_800x500")]


@pytest.mark.parametrize("kernel,name", ROUTED)
def test_twin_matches_routed_kernels_f32(kernel, name):
    """f32: the twin against the routed Pallas kernels in interpret mode,
    both orientations; atol/rtol 2e-5 as ``tests/test_ell_routed.py``."""
    import jax.numpy as jnp

    from pysparselp_tpu.ops.ell_routed import RoutedEllMatrix

    if kernel == "k8":
        a = _rand(800, 500, 0.015, seed=33)
        jop = RoutedEllMatrix.from_scipy(a, dtype=jnp.float32, qt=2)
        assert jop.tiles > 1 and jop.tiles_t > 1
    else:
        a = MATRICES[name]()
        jop = RoutedEllMatrix.from_scipy(a, dtype=jnp.float32)
        assert jop.tiles == 1
    x, y = _vectors(a, 1, np.float32)
    op = CsrMatrix.from_scipy(a, torch.float32, "cpu")
    np.testing.assert_allclose(op.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(jop.matvec(jnp.asarray(x))),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(op.rmatvec(torch.as_tensor(y)).numpy(),
                               np.asarray(jop.rmatvec(jnp.asarray(y))),
                               rtol=2e-5, atol=2e-5)


def _one_row_all():
    """One row holding every entry, among empty rows."""
    rng = np.random.RandomState(8)
    a = scipy.sparse.lil_matrix((20, 3000))
    a[7, :] = rng.randn(3000)
    return a.tocsr()


PLAN_CASES = {
    "empty": lambda: scipy.sparse.csr_matrix((0, 7)),
    "no_entries": lambda: scipy.sparse.csr_matrix((6, 9)),
    "empty_rows": _empty_and_dense_rows,
    "one_row_all": _one_row_all,
    "long_rows": _long_rows,
    "random": lambda: _rand(500, 120, 0.05, 623),
}


def _lane_sums(prod, lanes):
    """Entry ``k`` of ``prod`` added into lane ``k % lanes`` in entry order
    (0 + p_l + p_{l+lanes} + ..., each add rounded)."""
    out = np.zeros(lanes, prod.dtype)
    for lane in range(min(lanes, prod.size)):
        out[lane] = np.cumsum(prod[lane::lanes])[-1]
    return out


def _xor_tree(v):
    """The kernels' shuffle tree over the last axis: at offsets 1, 2, ...,
    every lane adds the lane ``offset`` away, all at once; lane 0's sum."""
    idx = np.arange(v.shape[-1])
    off = 1
    while off < v.shape[-1]:
        v = v + v[..., idx ^ off]
        off *= 2
    return v[..., 0]


def _emulate(plan, indptr, indices, vals, x):
    """The kernel's sums on ``plan``, in its order, in numpy (each product
    and add rounded, as the kernel's ``--fmad=false`` build): a row of
    ``width`` lanes, lane-strided then the shuffle tree; a long row's chunk
    over the block's 256 threads, thread-strided, the tree per warp, then
    the 8 warps in order; a long row's chunk sums, lane-strided over 32
    lanes, then the tree."""
    ip = np.asarray(indptr, np.int64)
    dt = np.dtype(str(vals.dtype).split(".")[1])
    prod = vals.numpy().astype(dt) * x.numpy().astype(dt)[indices.numpy()]
    y = np.full(len(ip) - 1, np.nan, dt)
    long = set(plan.task_row.tolist())
    for r in range(len(ip) - 1):
        if r not in long:
            y[r] = _xor_tree(_lane_sums(prod[ip[r]:ip[r + 1]], plan.width))
    carries = np.zeros(plan.n_chunks, dt)
    for c in range(plan.n_chunks):
        threads = _lane_sums(
            prod[plan.chunk_begin[c]:plan.chunk_end[c]], ops.THREADS)
        total = dt.type(0)
        for warp in _xor_tree(threads.reshape(-1, 32)):
            total = total + warp
        carries[c] = total
    for q in range(plan.n_tasks):
        first = int(plan.task_first[q])
        y[plan.task_row[q]] = _xor_tree(_lane_sums(
            carries[first:first + int(plan.task_count[q])], 32))
    return torch.as_tensor(y)


PLAN_OPTIONS = {"default": {}, "chunk_7": dict(chunk=7),
                "width_2": dict(width=2, chunk=100)}


@pytest.mark.parametrize("option", sorted(PLAN_OPTIONS))
@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_split_plan(name, option):
    """The plan covers every row and every entry once, in order: a row of
    at most LONG_STRIDES * width entries in the row blocks, a longer one
    as one task whose chunks tile its entries in order, each within one
    entry of the row's even share and at most the chunk size (by default
    the long entries over SPREAD_CTAS, within [MIN_CHUNK, MAX_CHUNK])."""
    a = PLAN_CASES[name]()
    kw = PLAN_OPTIONS[option]
    plan = ops.split_plan(a.indptr, **kw)
    lengths = np.diff(a.indptr)
    width = kw.get("width", ops.vector_width(a.nnz, a.shape[0]))
    assert plan.width == width and plan.n_out == a.shape[0]
    assert plan.row_blocks * ops.THREADS >= a.shape[0] * width
    long = np.flatnonzero(lengths > ops.LONG_STRIDES * width)
    assert plan.task_row.tolist() == long.tolist()
    chunk = kw.get("chunk", int(np.clip(-(-int(lengths[long].sum())
                                          // ops.SPREAD_CTAS),
                                        ops.MIN_CHUNK, ops.MAX_CHUNK)))
    covered = np.zeros(a.nnz, int)
    for r in np.flatnonzero(lengths <= ops.LONG_STRIDES * width):
        covered[a.indptr[r]:a.indptr[r + 1]] += 1
    assert plan.n_chunks == int(plan.task_count.sum())
    for q, r in enumerate(long):
        first, count = int(plan.task_first[q]), int(plan.task_count[q])
        cs = np.arange(first, first + count)
        assert first == int(plan.task_count[:q].sum())
        assert plan.chunk_task[cs].tolist() == [q] * count
        begin, end = plan.chunk_begin[cs], plan.chunk_end[cs]
        assert begin[0] == a.indptr[r] and end[-1] == a.indptr[r + 1]
        assert np.array_equal(begin[1:], end[:-1])
        size = end - begin
        assert np.all(np.abs(size - lengths[r] / count) < 1)
        assert size.max() <= chunk and count == -(-lengths[r] // chunk)
        for b, e in zip(begin, end):
            covered[b:e] += 1
    assert np.all(covered == 1)
    packed = plan.packed()
    assert packed.dtype == np.int32
    assert packed.size == 3 * plan.n_chunks + 4 * plan.n_tasks


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_emulated_kernel_order_matches_twin_f64(name):
    """The kernel's summation order on the plan (rows, chunks and the
    chunk sums of long rows), emulated, against the twin and scipy."""
    a = PLAN_CASES[name]()
    x = np.random.RandomState(9).randn(a.shape[1])
    xt = torch.as_tensor(x)
    ip, ix = (torch.as_tensor(v.astype(np.int32)) for v in (a.indptr,
                                                            a.indices))
    vals = torch.as_tensor(a.data, dtype=torch.float64)
    want = ops.csr_spmv_reference(ip, ix, vals, xt, a.shape[0])
    for kw in PLAN_OPTIONS.values():
        got = _emulate(ops.split_plan(a.indptr, **kw), ip, ix, vals, xt)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(got.numpy(), a @ x, rtol=1e-12,
                                   atol=1e-12)


def test_plan_constants_match_kernel_source():
    """The plan's block size and long-row limit are the kernel's."""
    from pathlib import Path

    src = Path(ops.__file__).resolve().parent.parent / "csrc"
    kernel = (src / "csr_spmv.cu").read_text()
    common = (src / "common.cuh").read_text()
    assert "constexpr int kThreads = pslp::kBlock;" in kernel
    assert ops.THREADS == int(re.search(r"kBlock = (\d+);", common).group(1))
    assert ops.LONG_STRIDES == int(
        re.search(r"kLongStrides = (\d+);", kernel).group(1))


def test_operator_carries_its_plans():
    a = _long_rows()
    op = CsrMatrix.from_scipy(a, torch.float64, "cpu")
    for side, mat in ((op.csr, a), (op.csr_t, a.T.tocsr())):
        want = ops.split_plan(mat.indptr)
        assert np.array_equal(side.plan.packed(), want.packed())
        assert side.plan_dev.dtype == torch.int32
        assert side.carries.shape == (want.n_chunks,)
    assert op.csr.plan.n_tasks == 3


def test_wrapper_takes_only_cpu_or_cuda():
    a = _rand(20, 30, 0.2, 1)
    op = CsrMatrix.from_scipy(a, torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.csr_spmv(op.csr, torch.zeros(30, device="meta"))


def _row_of_100k():
    """One row of 100,000 entries (a few hundred chunks) between short
    rows."""
    rng = np.random.RandomState(10)
    m, n = 50, 200_000
    rows = np.r_[np.full(100_000, 20), np.arange(m)]
    cols = np.r_[rng.choice(n, 100_000, replace=False), rng.randint(0, n, m)]
    return scipy.sparse.csr_matrix((rng.randn(rows.size), (rows, cols)),
                                   shape=(m, n))


CUDA_MATRICES = dict(MATRICES, row_of_100k=_row_of_100k,
                     no_entries=lambda: scipy.sparse.csr_matrix((6, 9)),
                     one_row_all=_one_row_all)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_twin_on_cuda(dtype):
    """The kernel against its twin, both orientations, on every fixture,
    one launch per product, with the default plan and with 2 lanes per
    row and chunks of 64 entries; x given as a view at a storage offset.  The twin adds in
    another order, so the limit scales with the row's absolute product.
    A second call gives the same bits, and both plans give the bits of
    the emulated order (:func:`_emulate`)."""
    dev = cuda_or_skip()
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    for name, make in sorted(CUDA_MATRICES.items()):
        a = make()
        op = CsrMatrix.from_scipy(a, dtype, dev)
        x, y = _vectors(a, 2)
        for side, v, absa in ((op.csr, x, abs(a)), (op.csr_t, y, abs(a).T)):
            buf = torch.as_tensor(np.concatenate([[7.0], v]), dtype=dtype,
                                  device=dev)
            xv = buf[1:]
            launches = ops.csr_spmv.launches
            got = ops.csr_spmv(side, xv)
            assert ops.csr_spmv.launches == launches + 1
            want = ops.csr_spmv_reference(side.indptr, side.indices,
                                          side.vals, xv, side.n_out)
            scale = torch.as_tensor(absa @ np.abs(v), dtype=dtype,
                                    device=dev)
            err = (got - want).abs()
            assert bool((err <= rtol * scale).all()), (name, float(err.max()))
            assert torch.equal(ops.csr_spmv(side, xv), got), name
            # 2 lanes per row and chunks of 64 entries: rows past 64
            # entries are long, the long ones many chunks
            small = ops.CsrOperand(side.indptr, side.indices, side.vals,
                                   side.n_in, ops.split_plan(
                                       side.indptr.cpu().numpy(), chunk=64,
                                       width=2))
            got_small = ops.csr_spmv(small, xv)
            err = (got_small - want).abs()
            assert bool((err <= rtol * scale).all()), (name, float(err.max()))
            # the kernel sums in the emulated order, to the bit
            host = [v.cpu() for v in (side.indptr, side.indices, side.vals,
                                      xv)]
            for operand, out in ((side, got), (small, got_small)):
                assert torch.equal(out.cpu(), _emulate(operand.plan, *host)), \
                    name


def _emulate_batch(plan, indptr, indices, vals, x):
    """H-CSR-B's sums on ``plan`` in its order, in numpy, ``x`` (n_in, B):
    a short row in entry order; a chunk of a long row strided over
    ``256 // min(B, 256)`` strands, the strands' sums added in order; a
    long row's chunk sums added in chunk order (each add rounded)."""
    ip = np.asarray(indptr, np.int64)
    dt = np.dtype(str(vals.dtype).split(".")[1])
    xs = x.numpy().astype(dt)
    prod = vals.numpy().astype(dt)[:, None] * xs[indices.numpy()]
    nb = xs.shape[1]

    def in_order(parts):
        total = np.zeros(nb, dt)
        for part in parts:
            total = total + part
        return total

    y = np.full((len(ip) - 1, nb), np.nan, dt)
    long = set(plan.task_row.tolist())
    for r in range(len(ip) - 1):
        if r not in long:
            y[r] = in_order(prod[ip[r]:ip[r + 1]])
    strands = ops.THREADS // min(nb, ops.THREADS)
    carries = np.zeros((plan.n_chunks, nb), dt)
    for c in range(plan.n_chunks):
        seg = prod[plan.chunk_begin[c]:plan.chunk_end[c]]
        carries[c] = in_order(in_order(seg[s::strands])
                              for s in range(strands))
    for q in range(plan.n_tasks):
        first = int(plan.task_first[q])
        y[plan.task_row[q]] = in_order(
            carries[first:first + int(plan.task_count[q])])
    return torch.as_tensor(y)


@pytest.mark.parametrize("nb", [1, 3, 8, 300])
@pytest.mark.parametrize("option", sorted(PLAN_OPTIONS))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_emulated_batch_columns_near_1d_order(name, option, nb):
    """Column b of H-CSR-B's emulated sums (entry order, chunk strands)
    against H-CSR's emulated sums on ``X[:, b]`` (:func:`_emulate`), on
    the same plan, in float32: the two orders differ in rounding only,
    per row within 1e-5 · (|A| |X[:, b]|)_row (the kernels' rtol); every
    column up to B = 8, every 23rd and the last at B = 300."""
    a = MATRICES[name]()
    op = CsrMatrix.from_scipy(a, torch.float32, "cpu").csr
    plan = ops.split_plan(a.indptr, **PLAN_OPTIONS[option])
    xn = np.random.RandomState(nb).randn(a.shape[1], nb)
    x = torch.as_tensor(xn, dtype=torch.float32)
    got = _emulate_batch(plan, op.indptr, op.indices, op.vals, x).numpy()
    scale = abs(a) @ np.abs(xn)
    for b in sorted({*range(0, nb, 1 if nb <= 8 else 23), nb - 1}):
        want = _emulate(plan, op.indptr, op.indices, op.vals,
                        x[:, b].contiguous()).numpy()
        assert np.all(np.abs(got[:, b] - want) <= 1e-5 * scale[:, b]), b


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_batched_twin_matches_scipy_and_vmapped_ell_f64(name):
    """The batched twin, through ``CsrMatrix.matvec``/``rmatvec`` on a
    batch-last operand, against scipy and against the JAX batched solver's
    gather-ELL operator (``EllMatrix``) under ``jax.vmap``; the emulated
    kernel order at B = 1, 3 and 300 (past one block's 256 columns) on
    the default plan and on small chunks, against the twin."""
    import jax
    import jax.numpy as jnp

    from pysparselp_tpu.problem import EllMatrix

    a = MATRICES[name]()
    op = CsrMatrix.from_scipy(a, torch.float64, "cpu")
    jop = EllMatrix.from_scipy(a, dtype=jnp.float64)
    rng = np.random.RandomState(4)
    x, y = rng.randn(a.shape[1], 3), rng.randn(a.shape[0], 3)
    got = op.matvec(torch.as_tensor(x)).numpy()
    got_t = op.rmatvec(torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, a @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_t, a.T @ y, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        got, np.asarray(jax.vmap(jop.matvec)(jnp.asarray(x.T))).T,
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        got_t, np.asarray(jax.vmap(jop.rmatvec)(jnp.asarray(y.T))).T,
        rtol=1e-12, atol=1e-12)
    for nb in (1, 3, 300):
        xb = torch.as_tensor(rng.randn(a.shape[1], nb))
        side = op.csr
        want = ops.csr_spmm_reference(side.indptr, side.indices, side.vals,
                                      xb, side.n_out)
        for kw in PLAN_OPTIONS.values():
            emu = _emulate_batch(ops.split_plan(a.indptr, **kw),
                                 side.indptr, side.indices, side.vals, xb)
            np.testing.assert_allclose(emu.numpy(), want.numpy(), rtol=1e-12,
                                       atol=1e-12)


def test_batched_wrapper_on_cuda_launches_and_never_runs_the_twin(
        monkeypatch):
    """For a CUDA operand the batched wrapper launches H-CSR-B's entry
    once, with the carries and counters of its batch size (never the 1-D
    entry's ``carries``); the twin, patched to raise, is never called, and
    a wrong operand raises instead of running it."""
    a = _long_rows()
    op = CsrMatrix.from_scipy(a, torch.float64, "cpu").csr
    calls = []
    op.device, op.device_index = torch.device("cuda"), 0
    op.entry_b = lambda *args: calls.append(args)
    op.entry = None

    def twin(*_args):
        raise AssertionError("the twin ran for a CUDA operand")

    empty, zeros = torch.empty, torch.zeros
    monkeypatch.setattr(ops, "csr_spmm_reference", twin)
    monkeypatch.setattr(ops._build, "stream", lambda index: 0)
    monkeypatch.setattr(torch, "empty", lambda *s, **kw: empty(
        *s, **dict(kw, device="cpu")))
    monkeypatch.setattr(torch, "zeros", lambda *s, **kw: zeros(
        *s, **dict(kw, device="cpu")))
    x = CudaLike(torch.zeros((a.shape[1], 8), dtype=torch.float64))
    launches = ops.csr_spmm.launches
    y = ops.csr_spmm(op, x)
    assert y.shape == (a.shape[0], 8)
    assert ops.csr_spmm.launches == launches + 1 and len(calls) == 1
    carries, counters = op.batch_scratch(8)
    assert carries.shape == (op.plan.n_chunks * 8,)
    assert counters.shape == (op.plan.n_tasks,)
    assert calls[0][:2] == (carries.data_ptr(), counters.data_ptr())
    assert carries.data_ptr() != op.carries.data_ptr()
    assert calls[0][3:5] == (y.data_ptr(), 8)
    for bad in (torch.zeros((a.shape[1], 8), dtype=torch.float32),
                torch.zeros((a.shape[1] + 1, 8), dtype=torch.float64),
                torch.zeros(a.shape[1], dtype=torch.float64)):
        with pytest.raises(ValueError, match="csr_spmm"):
            ops.csr_spmm(op, CudaLike(bad))
    assert ops.csr_spmm.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_kernel_matches_twin_on_cuda(dtype):
    """H-CSR-B against its twin (per row within rtol · (|A||X|)_row), its
    emulated order (to the bit) and, column by column, the 1-D H-CSR on
    the same plan (per row within rtol · (|A||X[:, b]|)_row: the two
    kernels add in different orders), both orientations, on every
    fixture, at B = 1, 3, 8 and 300, with the default plan and small
    chunks; one launch per product.  X also at a storage offset that is
    not 16-byte aligned, with the same bits.  Batched and 1-D products
    alternate on one operand and each repeats its own bits (the two never
    share a carry or a counter)."""
    dev = cuda_or_skip()
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    rng = np.random.RandomState(5)
    for name, make in sorted(CUDA_MATRICES.items()):
        a = make()
        op = CsrMatrix.from_scipy(a, dtype, dev)
        for side, absa in ((op.csr, abs(a)), (op.csr_t, abs(a).T)):
            small = ops.CsrOperand(side.indptr, side.indices, side.vals,
                                   side.n_in, ops.split_plan(
                                       side.indptr.cpu().numpy(), chunk=64,
                                       width=2))
            host = [v.cpu() for v in (side.indptr, side.indices, side.vals)]
            v1 = torch.as_tensor(rng.randn(side.n_in), dtype=dtype,
                                 device=dev)
            for nb in (1, 3, 8, 300):
                xn = rng.randn(side.n_in, nb)
                xb = torch.as_tensor(xn, dtype=dtype, device=dev)
                buf = torch.zeros(side.n_in * nb + 1, dtype=dtype,
                                  device=dev)
                xu = buf[1:].view(side.n_in, nb)
                xu.copy_(xb)
                assert xu.data_ptr() % 16 != 0
                want = ops.csr_spmm_reference(side.indptr, side.indices,
                                              side.vals, xb, side.n_out)
                scale = torch.as_tensor(absa @ np.abs(xn), dtype=dtype,
                                        device=dev)
                for operand in (side, small):
                    one = ops.csr_spmv(operand, v1)
                    launches = ops.csr_spmm.launches
                    got = ops.csr_spmm(operand, xb)
                    assert ops.csr_spmm.launches == launches + 1
                    err = (got - want).abs()
                    assert bool((err <= rtol * scale).all()), (
                        name, nb, float(err.max()))
                    assert torch.equal(got.cpu(), _emulate_batch(
                        operand.plan, *host, xb.cpu())), (name, nb)
                    for b in range(nb):
                        col = ops.csr_spmv(operand, xb[:, b].contiguous())
                        assert bool(((got[:, b] - col).abs()
                                     <= rtol * scale[:, b]).all()), (
                            name, nb, b)
                    assert torch.equal(ops.csr_spmm(operand, xu), got), (
                        name, nb)
                    assert torch.equal(ops.csr_spmv(operand, v1), one)
                    assert torch.equal(ops.csr_spmm(operand, xb), got)
