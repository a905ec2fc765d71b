"""Exact-bfloat16 values in the CSR-family operators (``problem.CsrMatrix``
and ``problem.PartitionMatrix``, ``from_scipy(..., allow_bf16=...)``), the
JAX package's storage rule for its routed ELL values
(``pysparselp_tpu/ops/ell_routed.py:1421-1429``) and its partition table
(``pysparselp_tpu/problem.py:446-449``).

On the CPU: the port stores the value dtype JAX stores for the same
matrix; the twins of H-CSR (plain and fused), the partition products and
the host reductions on bfloat16 values equal the same operators on
float32 values bit for bit; ``utils.convert`` keeps JAX's bfloat16; the
lowering stores bfloat16 where JAX's TPU lowering does and the dtype where
its gather layouts do; a float32 CP solve of a small transport and a small
k-medians LP on bfloat16 storage is bit-equal to the same solve on float32
values and within ``chip_smoke.NONGRID_RTOL`` (1e-5, the port's limit for
float32 non-grid solves) of JAX's float32 CPU solve.  Also the float32
dual ascent solvers against JAX's on Potts-20 (ROADMAP Queue 3).  Marked
``cuda``: H-CSR on bfloat16 values against the same kernel on float32
values, bit for bit.

JAX is imported inside the tests: the card machine, which runs this file's
``cuda`` cases (``python -m pytest --noconftest -m cuda``), has none."""

import copy
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse
import torch

import chip_smoke
from pysparselp_tpu_torch import batch as pbatch
from pysparselp_tpu_torch import problem as ppr
from pysparselp_tpu_torch.ops import _build
from pysparselp_tpu_torch.ops import csr_spmv as ops
from pysparselp_tpu_torch.problem import (ColBlockMatrix, CsrMatrix,
                                          PartitionMatrix, csr_value_dtype)
from pysparselp_tpu_torch.solvers import chambolle_pock as pcp
from torch_port_helpers import CudaLike, cuda_or_skip, host_system

torch.set_num_threads(1)
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
CP = "chambolle_pock_ppd"


def _partition(values, m=30, width=4, stride=5, col0=3):
    """A partition-shaped matrix (row r holds ``width`` contiguous columns
    from ``col0 + r·stride``) with the given values, row by row."""
    values = np.asarray(values, np.float64).reshape(m, width)
    cols = col0 + np.arange(m)[:, None] * stride + np.arange(width)[None, :]
    rows = np.repeat(np.arange(m), width)
    return scipy.sparse.csr_matrix((values.ravel(), (rows, cols.ravel())),
                                   shape=(m, col0 + m * stride + 2))


def _signs(seed=0, size=120):
    return np.where(np.random.RandomState(seed).rand(size) < 0.5, -1.0, 1.0)


def _one_inexact():
    v = _signs(1)
    v[17] = 0.1
    return v


MATRICES = {
    "pm1": lambda: _partition(_signs()),
    "zero_one": lambda: _partition(
        (np.random.RandomState(2).rand(120) < 0.5).astype(float)),
    "pm1_times_1.1": lambda: _partition(1.1 * _signs(3)),
    "one_inexact": lambda: _partition(_one_inexact()),
    "empty": lambda: scipy.sparse.csr_matrix((20, 40)),
}

# (matrix, dtype, allow_bf16) -> the dtype JAX stores
STORAGE = [("pm1", "float32", "exact", "bfloat16"),
           ("zero_one", "float32", "exact", "bfloat16"),
           ("pm1_times_1.1", "float32", "exact", "float32"),
           ("one_inexact", "float32", "exact", "float32"),
           ("empty", "float32", "exact", "float32"),
           ("pm1", "float64", "exact", "float64"),
           ("pm1_times_1.1", "float32", "always", "bfloat16"),
           ("pm1", "float32", False, "float32")]


def _jax_stored(a, dtype, allow):
    """The value dtypes JAX stores for ``a``: its routed ELL's and
    partition's (``"exact"``, their only rule), else the DIA planes' under
    ``allow_bf16=allow`` (the rule's other settings)."""
    import jax.numpy as jnp

    from pysparselp_tpu import problem as jpr
    from pysparselp_tpu.ops.ell_routed import RoutedEllMatrix

    jdt = getattr(jnp, dtype)
    if allow != "exact":
        return [str(jpr.DiaMatrix.from_scipy(a, dtype=jdt,
                                             allow_bf16=allow).vals.dtype)]
    got = [str(RoutedEllMatrix.from_scipy(a, dtype=jdt).v.dtype)]
    if a.nnz:
        got.append(str(jpr.PartitionMatrix.from_scipy(a, dtype=jdt)
                       .vals.dtype))
    return got


@pytest.mark.parametrize("key, dtype, allow, stored", STORAGE)
def test_from_scipy_stores_the_value_dtype_jax_stores(key, dtype, allow,
                                                      stored):
    """Both CSR orientations and the partition table have JAX's dtype;
    ``"always"`` rounds each value as ``ml_dtypes`` does."""
    import ml_dtypes

    a = MATRICES[key]()
    assert set(_jax_stored(a, dtype, allow)) == {stored}
    tdt, want = getattr(torch, dtype), getattr(torch, stored)
    assert csr_value_dtype(a.data, tdt, allow) == want
    op = CsrMatrix.from_scipy(a, tdt, "cpu", allow_bf16=allow)
    assert op.vals.dtype == op.vals_t.dtype == want
    assert op.csr.dtype == op.csr_t.dtype == tdt
    assert op.csr.carries.dtype == tdt
    rounded = a.data.astype(np.float32).astype(ml_dtypes.bfloat16) \
        if stored == "bfloat16" else a.data.astype(dtype)
    np.testing.assert_array_equal(op.vals.double().numpy(),
                                  rounded.astype(np.float64))
    if a.nnz:
        part = PartitionMatrix.from_scipy(a, tdt, "cpu", allow_bf16=allow)
        assert part.vals.dtype == want
        x = torch.ones(a.shape[1], dtype=tdt)
        assert part.matvec(x).dtype == part.rmatvec(x[:a.shape[0]]).dtype \
            == tdt
        np.testing.assert_array_equal(part.vals.double().numpy().ravel(),
                                      rounded.astype(np.float64))


def test_bf16_values_serve_float32_only():
    a = MATRICES["pm1"]()
    with pytest.raises(TypeError, match="float32 only"):
        ops.CsrOperand.from_host(a.indptr, a.indices, a.data, a.shape[1],
                                 F64, "cpu", value_dtype=BF16)
    assert CsrMatrix.from_scipy(a, F64, "cpu",
                                allow_bf16="always").vals.dtype == F64


def test_kernel_source_exports_the_bf16_entry():
    """The C entry a bfloat16 operand binds (``pslp_csr_spmv_f32_bf16``)
    is exported, and only the 1-D one: H-CSR-B takes the product's dtype."""
    src = (Path(ops.__file__).resolve().parent.parent / "csrc"
           / "csr_spmv.cu").read_text()
    assert _build.plane_suffix(F32, BF16) == "f32_bf16"
    assert "PSLP_CSR(f32_bf16, float, __nv_bfloat16)" in src
    assert "PSLP_CSR_BATCH(f32_bf16" not in src


def test_batched_entry_refuses_bf16_values_on_cuda(monkeypatch):
    """A bfloat16 operand with a CUDA tensor: no batched entry is bound,
    so ``csr_spmm`` raises, never running the twin or a float32 copy."""
    a = MATRICES["pm1"]()
    op = CsrMatrix.from_scipy(a, F32, "cpu", allow_bf16="exact").csr
    assert op.vals.dtype == BF16 and op.entry_b is None
    op.device, op.device_index = torch.device("cuda"), 0

    def twin(*_args):
        raise AssertionError("the twin ran for a CUDA operand")

    monkeypatch.setattr(ops, "csr_spmm_reference", twin)
    launches = ops.csr_spmm.launches
    with pytest.raises(TypeError, match="H-CSR-B"):
        ops.csr_spmm(op, CudaLike(torch.zeros((a.shape[1], 4), dtype=F32)))
    assert ops.csr_spmm.launches == launches


# ----------------------------------------------------------------------
# the twins and host reductions on bfloat16 values against float32 values
# ----------------------------------------------------------------------

def _exact_values(a, seed=4):
    """``a`` with values exact in bfloat16 but not trivially so: some
    squares and square roots are not (±1, ±0.75, ±1.5, ±1.9375, ±255)."""
    a = a.copy()
    pick = np.random.RandomState(seed).randint(0, 5, a.nnz)
    sign = np.where(np.random.RandomState(seed + 1).rand(a.nnz) < 0.5, -1, 1)
    a.data = sign * np.array([1.0, 0.75, 1.5, 1.9375, 255.0])[pick]
    return a


def _long_rows():
    """Short rows beside rows far past the sub-warp limit, and empty rows
    (``tests/test_torch_csr_spmv.py``'s ``_long_rows``)."""
    rng = np.random.RandomState(6)
    m, n = 400, 6000
    rows = [np.repeat(np.arange(0, m, 2), 2)]
    cols = [rng.randint(0, n, rows[0].size)]
    for r in (3, 101, 257):
        rows.append(np.full(5000, r))
        cols.append(rng.choice(n, 5000, replace=False))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return scipy.sparse.csr_matrix((np.ones(rows.size), (rows, cols)),
                                   shape=(m, n))


def _kmedians_block():
    """The k-medians folded inequalities' CSR block (±1)."""
    folded = host_system(chip_smoke.kmedians_lp(n_points=200,
                                                n_candidates=10))["a_ineq"]
    return folded.tocsc()[:, 2000:].tocsr()


TWIN_MATRICES = {
    "random": lambda: _exact_values(scipy.sparse.random(
        300, 200, density=0.04, format="csr",
        random_state=np.random.RandomState(9))),
    "long_rows": lambda: _exact_values(_long_rows()),
    "kmedians_block": _kmedians_block,
}


def _pair(a, fused=False):
    """The operator of ``a`` on bfloat16 values and on float32 values."""
    narrow = CsrMatrix.from_scipy(a, F32, "cpu", fused, allow_bf16="exact")
    wide = CsrMatrix.from_scipy(a, F32, "cpu", fused)
    assert narrow.vals.dtype == BF16 and wide.vals.dtype == F32
    return narrow, wide


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("key", sorted(TWIN_MATRICES))
def test_csr_twins_bit_equal_on_bf16_and_f32_values(key, fused):
    """``csr_spmv`` (plain twin, or the fused multiply-add chain),
    ``csr_spmv_plus`` and the batched twin, both orientations: the
    bfloat16 operator's bits are the float32 operator's, in float32."""
    a = TWIN_MATRICES[key]()
    narrow, wide = _pair(a, fused)
    rng = np.random.RandomState(3)
    for side in ("csr", "csr_t"):
        nop, wop = getattr(narrow, side), getattr(wide, side)
        x = torch.as_tensor(rng.randn(nop.n_in), dtype=F32)
        base = torch.as_tensor(rng.randn(nop.n_out), dtype=F32)
        got = ops.csr_spmv(nop, x)
        assert got.dtype == F32
        assert torch.equal(got, ops.csr_spmv(wop, x))
        assert torch.equal(ops.csr_spmv_plus(nop, x, base),
                           ops.csr_spmv_plus(wop, x, base))
        xb = torch.as_tensor(rng.randn(nop.n_in, 3), dtype=F32)
        assert torch.equal(ops.csr_spmm(nop, xb), ops.csr_spmm(wop, xb))
    x = torch.as_tensor(rng.randn(a.shape[1]), dtype=F32)
    base = torch.as_tensor(rng.randn(a.shape[0]), dtype=F32)
    assert torch.equal(narrow.matvec(x), wide.matvec(x))
    assert torch.equal(narrow.matvec_plus(x, base),
                       wide.matvec_plus(x, base))


@pytest.mark.parametrize("key", sorted(TWIN_MATRICES))
def test_csr_host_reductions_widen_before_arithmetic(key):
    """``abs_power_*sum`` and ``sq_rowsum_weighted`` on bfloat16 values
    equal the float32 values' bit for bit (powers and squares taken in
    float32: a bfloat16 one would round)."""
    a = TWIN_MATRICES[key]()
    narrow, wide = _pair(a)
    d = torch.as_tensor(np.random.RandomState(1).rand(a.shape[1]), dtype=F32)
    for p in (1.0, 2.0, 0.5):
        for name in ("abs_power_rowsum", "abs_power_colsum"):
            got = getattr(narrow, name)(p)
            assert got.dtype == F32
            assert torch.equal(got, getattr(wide, name)(p))
    got = narrow.sq_rowsum_weighted(d)
    assert got.dtype == F32 and torch.equal(got, wide.sq_rowsum_weighted(d))


def test_partition_products_and_reductions_in_the_solve_dtype():
    """A bfloat16 partition table: 1-D and batch-last products, the
    reductions and ``sq_rowsum_weighted`` run in float32 and equal the
    float32 table's bit for bit."""
    a = _exact_values(MATRICES["pm1"](), seed=7)
    narrow = PartitionMatrix.from_scipy(a, F32, "cpu")
    wide = PartitionMatrix.from_scipy(a, F32, "cpu", allow_bf16=False)
    assert narrow.vals.dtype == BF16 and wide.vals.dtype == F32
    rng = np.random.RandomState(5)
    m, n = a.shape
    for x in (torch.as_tensor(rng.randn(n), dtype=F32),
              torch.as_tensor(rng.randn(n, 3), dtype=F32)):
        got = narrow.matvec(x)
        assert got.dtype == F32 and torch.equal(got, wide.matvec(x))
        np.testing.assert_allclose(got.double().numpy(),
                                   a @ x.double().numpy(), rtol=1e-5,
                                   atol=1e-4)
    for y in (torch.as_tensor(rng.randn(m), dtype=F32),
              torch.as_tensor(rng.randn(m, 3), dtype=F32)):
        got = narrow.rmatvec(y)
        assert got.dtype == F32 and torch.equal(got, wide.rmatvec(y))
    for p in (1.0, 2.0, 0.5):
        assert torch.equal(narrow.abs_power_rowsum(p),
                           wide.abs_power_rowsum(p))
        assert torch.equal(narrow.abs_power_colsum(p),
                           wide.abs_power_colsum(p))
    d = torch.as_tensor(rng.rand(n), dtype=F32)
    got = narrow.sq_rowsum_weighted(d)
    assert got.dtype == F32 and torch.equal(got, wide.sq_rowsum_weighted(d))


def test_cost_counts_the_stored_item_size():
    a = MATRICES["pm1"]()
    m, n = a.shape
    for allow, size in (("exact", 2), (False, 4)):
        op = CsrMatrix.from_scipy(a, F32, "cpu", allow_bf16=allow)
        assert ppr.operator_cost_bytes(op) == ppr._csr_bytes(a.nnz, m, n,
                                                             size)
        part = PartitionMatrix.from_scipy(a, F32, "cpu", allow_bf16=allow)
        assert ppr.operator_cost_bytes(part) == ppr._partition_bytes(
            m, n, 5, 4, size)


# ----------------------------------------------------------------------
# carrying JAX operators across
# ----------------------------------------------------------------------

@pytest.mark.parametrize("key, stored", [("pm1", BF16),
                                         ("pm1_times_1.1", F32)])
def test_convert_keeps_jax_value_storage(key, stored):
    """A JAX routed ELL and a JAX partition come across with JAX's value
    dtype (bfloat16 where JAX stores it, for a float32 solve; the dtype
    for float64); a JAX ``EllMatrix`` keeps the dtype, as JAX's does."""
    import jax.numpy as jnp

    from pysparselp_tpu import problem as jpr
    from pysparselp_tpu.ops.ell_routed import RoutedEllMatrix
    from pysparselp_tpu_torch.utils.convert import operator_from_jax

    a = MATRICES[key]()
    x = np.random.RandomState(8).randn(a.shape[1]).astype(np.float32)
    for jop, kind in ((RoutedEllMatrix.from_scipy(a, dtype=jnp.float32),
                       CsrMatrix),
                      (jpr.PartitionMatrix.from_scipy(a, dtype=jnp.float32),
                       PartitionMatrix)):
        op = operator_from_jax(jop, F32, "cpu")
        assert isinstance(op, kind) and op.vals.dtype == stored
        assert operator_from_jax(jop, F64, "cpu").vals.dtype == F64
        got = op.matvec(torch.as_tensor(x))
        assert got.dtype == F32
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jop.matvec(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)
        if kind is CsrMatrix:
            assert op.vals_t.dtype == stored
    ell = operator_from_jax(jpr.EllMatrix.from_scipy(a, dtype=jnp.float32),
                            F32, "cpu")
    assert isinstance(ell, CsrMatrix) and ell.vals.dtype == F32


# ----------------------------------------------------------------------
# the lowering and the solves
# ----------------------------------------------------------------------

SOLVES = {
    # the bench.py workloads at test size, and what they lower to with the
    # dense limit at 0 (the full-size main path's operators)
    "transport": (lambda: chip_smoke.transport_lp(
        n_sources=300, n_sinks=300, n_arcs=4000),
        ("CsrMatrix", "PartitionMatrix")),
    "kmedians": (lambda: chip_smoke.kmedians_lp(n_points=200,
                                                n_candidates=10),
                 ("PartitionMatrix", ["DiaMatrix", "CsrMatrix"])),
}


def _describe(op):
    if op is None:
        return None
    if isinstance(op, ColBlockMatrix):
        return [_describe(b) for b in op.blocks]
    return type(op).__name__


def _host_blocks(a, op):
    """``(host matrix, operator type)`` of each block of the lowered
    ``op`` of ``a``."""
    if not isinstance(op, ColBlockMatrix):
        return [(a, type(op))]
    csc, s = a.tocsc(), op.col_starts
    return [(csc[:, s[b]:s[b + 1]].tocsr(), type(blk))
            for b, blk in enumerate(op.blocks)]


def _stored(op):
    """The value dtype of every block of ``op``."""
    if isinstance(op, ColBlockMatrix):
        return [d for b in op.blocks for d in _stored(b)]
    return [op.vals.dtype] + ([op.vals_t.dtype] if hasattr(op, "vals_t")
                              else [])


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_lowering_stores_bf16_where_jax_does(name, monkeypatch):
    """Every CSR, partition and DIA block of the two LPs stores bfloat16
    in float32 (their values are ±1 and 0/1), the dtype in float64; a CSR
    forced as JAX's "ell" or "segmented" keeps the dtype, as "routed" and
    "csr" take the rule; the batch path's CSR keeps the dtype (JAX's
    batch runs gather-ELL), its partition stores bfloat16 (JAX's batch
    calls ``PartitionMatrix.from_scipy``)."""
    make, want = SOLVES[name]
    monkeypatch.setattr(ppr, "DENSE_AUTO_MAX_ENTRIES", 0)
    monkeypatch.setattr(pbatch, "DENSE_AUTO_MAX_ENTRIES", 0)
    sys_ = host_system(make())
    mats = [sys_["a_eq"], sys_["a_ineq"]]
    ops32 = ppr.lower_systems(mats, F32, "cpu")
    assert [_describe(o) for o in ops32] == list(want)
    assert all(d == BF16 for o in ops32 for d in _stored(o))
    ops64 = ppr.lower_systems(mats, F64, "cpu")
    assert all(d == F64 for o in ops64 for d in _stored(o))
    csr = [block for a, op in zip(mats, ops32)
           for block, kind in _host_blocks(a, op) if kind is CsrMatrix][0]
    for prefer, stored in (("ell", F32), ("segmented", F32), ("routed", BF16),
                           ("csr", BF16)):
        op = ppr.ell_from_scipy(csr, F32, "cpu", prefer=prefer)
        assert isinstance(op, CsrMatrix) and op.vals.dtype == stored
    batched = [pbatch._lower_batch(a, F32, "cpu") for a in mats]
    for op in batched:
        blocks = op.blocks if isinstance(op, ColBlockMatrix) else (op,)
        for b in blocks:
            if isinstance(b, CsrMatrix):
                assert b.vals.dtype == F32
            elif isinstance(b, PartitionMatrix):
                assert b.vals.dtype == BF16


def _jax_lp(name):
    import bench

    return {"transport": lambda: bench._transport_lp(
        n_sources=300, n_sinks=300, n_arcs=4000),
        "kmedians": lambda: bench._kmedians_lp(n_points=200,
                                               n_candidates=10)}[name]()


def _port_lp(jax_lp):
    from pysparselp_tpu_torch.modeling import SparseLP

    lp = SparseLP.__new__(SparseLP)
    lp.__dict__ = copy.deepcopy(jax_lp).__dict__
    return lp


def _f32_values(values, dtype, allow_bf16="exact"):
    return dtype


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_cp_solve_on_bf16_values_is_bit_equal_and_near_jax(name,
                                                           monkeypatch):
    """A float32 CP solve (300 iterations) on the lowering's bfloat16
    values equals the same solve with every value stored in float32 bit
    for bit (x and every curve), and its curves are within NONGRID_RTOL of
    JAX's float32 CPU solve (objectives relative, violations relative to
    max(1, |JAX|))."""
    monkeypatch.setattr(ppr, "DENSE_AUTO_MAX_ENTRIES", 0)
    lowered = []

    def recording(*args, **kwargs):
        lowered.append(ppr.lower_systems(*args, **kwargs))
        return lowered[-1]

    monkeypatch.setattr(pcp, "lower_systems", recording)
    jlp = _jax_lp(name)
    run = dict(method=CP, nb_iter=300, nb_iter_plot=100, dtype=np.float32)
    narrow = _port_lp(jlp)
    x_n, _ = narrow.solve(device="cpu", **run)
    stored = [d for o in lowered[-1] if o is not None for d in _stored(o)]
    assert BF16 in stored and F32 not in stored
    with monkeypatch.context() as patch:
        patch.setattr(ppr, "csr_value_dtype", _f32_values)
        patch.setattr(ppr, "dia_plane_dtype", _f32_values)
        wide = _port_lp(jlp)
        x_w, _ = wide.solve(device="cpu", **run)
    stored = [d for o in lowered[-1] if o is not None for d in _stored(o)]
    assert set(stored) == {F32}
    np.testing.assert_array_equal(x_n, x_w)
    for key in ("itrn_curve",) + chip_smoke.CURVES:
        np.testing.assert_array_equal(getattr(narrow, key),
                                      getattr(wide, key), err_msg=key)
    jlp.solve(**run)
    assert list(narrow.itrn_curve) == list(jlp.itrn_curve)
    worst = chip_smoke.checkpoint_diffs(chip_smoke.curves(narrow),
                                        chip_smoke.curves(jlp))
    assert all(v <= chip_smoke.NONGRID_RTOL for v in worst.values()), worst


# ----------------------------------------------------------------------
# ROADMAP Queue 3: the float32 dual ascent curves against JAX's
# ----------------------------------------------------------------------

# the limit on the curves' relative gap: none, since the iterates are
# bit-equal and the metrics sum in XLA's CPU order on the CPU
# (utils/xla_order.py)
DUAL_F32_RTOL = 0


@pytest.mark.parametrize("method, run", [
    ("dual_gradient_ascent", dict(nb_iter=300, nb_iter_plot=100)),
    ("dual_coordinate_ascent", dict(nb_iter=20, nb_iter_plot=5)),
])
def test_dual_ascent_f32_curves_match_jax(method, run, monkeypatch):
    """Potts-20 (seed 1) in float32, the port against JAX's compiled
    solver: the same x and checkpoints, every curve within DUAL_F32_RTOL
    (bit for bit), and JAX's own jitted ``_dual_energy`` on the port's
    last reduced costs and dual term gives JAX's last dual objective bit
    for bit."""
    import jax
    import jax.numpy as jnp

    from pysparselp_tpu.examples.potts import build_linear_program
    from pysparselp_tpu.solvers import dual_ascent as jda
    from pysparselp_tpu_torch.solvers import dual_ascent as pda

    inputs = []
    energy = pda._dual_energy

    def recording(c_bar, lb, ub, lin):
        inputs.append((c_bar, lb, ub, lin))
        return energy(c_bar, lb, ub, lin)

    monkeypatch.setattr(pda, "_dual_energy", recording)
    jlp = build_linear_program(20, 0.5, 500, seed=1)[0]
    plp = _port_lp(jlp)
    x_j, _ = jlp.solve(method=method, dtype=np.float32, **run)
    x_p, _ = plp.solve(method=method, dtype=np.float32, device="cpu", **run)
    np.testing.assert_array_equal(x_p, x_j)
    assert list(plp.itrn_curve) == list(jlp.itrn_curve)
    for key in chip_smoke.CURVES:
        got = np.asarray(getattr(plp, key), np.float64)
        want = np.asarray(getattr(jlp, key), np.float64)
        np.testing.assert_allclose(got, want, rtol=DUAL_F32_RTOL, atol=0,
                                   err_msg=key)
    last = jax.jit(jda._dual_energy)(
        *(jnp.asarray(v.numpy()) for v in inputs[-1]))
    assert float(last) == float(jlp.dobj_curve[-1])


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

CUDA_MATRICES = dict(TWIN_MATRICES,
                     transport=lambda: host_system(chip_smoke.transport_lp(
                         n_sources=300, n_sinks=300, n_arcs=4000))["a_eq"],
                     no_entries=lambda: scipy.sparse.csr_matrix((6, 9)))


@pytest.mark.cuda
@pytest.mark.parametrize("key", sorted(CUDA_MATRICES))
def test_kernel_bit_equal_on_bf16_and_f32_values_on_cuda(key):
    """H-CSR on bfloat16 values (the ``f32_bf16`` entry) against H-CSR on
    float32 values on the same plan: the same bits, both orientations, one
    launch each; and within the per-row limit of the bfloat16 twin."""
    dev = cuda_or_skip()
    a = CUDA_MATRICES[key]()
    narrow = CsrMatrix.from_scipy(a, F32, dev, allow_bf16="always")
    wide = CsrMatrix.from_scipy(a, F32, dev)
    rng = np.random.RandomState(2)
    for side in ("csr", "csr_t"):
        nop, wop = getattr(narrow, side), getattr(wide, side)
        if a.nnz:   # without entries the values keep the dtype
            assert nop.vals.dtype == BF16
            assert nop.entry.name.endswith("_f32_bf16")
        x = torch.as_tensor(rng.randn(nop.n_in), dtype=F32, device=dev)
        launches = ops.csr_spmv.launches
        got = ops.csr_spmv(nop, x)
        blocks = nop.plan.row_blocks + nop.plan.n_chunks
        assert ops.csr_spmv.launches == launches + (1 if blocks else 0)
        assert torch.equal(got, ops.csr_spmv(wop, x))
        want = ops.csr_spmv_reference(nop.indptr, nop.indices, nop.vals, x,
                                      nop.n_out)
        scale = ops.csr_spmv_reference(nop.indptr, nop.indices,
                                       nop.vals.abs(), x.abs(), nop.n_out)
        assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.cuda
def test_bf16_operand_refuses_the_batched_entry_on_cuda():
    dev = cuda_or_skip()
    a = MATRICES["pm1"]()
    op = CsrMatrix.from_scipy(a, F32, dev, allow_bf16="exact")
    assert op.vals.dtype == BF16
    with pytest.raises(TypeError, match="H-CSR-B"):
        op.matvec(torch.zeros((a.shape[1], 4), dtype=F32, device=dev))
