"""Exact-bfloat16 DIA planes (``problem.DiaMatrix.from_scipy(...,
allow_bf16=...)``, the JAX package's storage rule) and H-CPDIA-G, the
chunk on a persistent cooperative grid (``ops/cp_dia.py::grid_plan``,
``csrc/cp_dia_grid.cu``).

On the CPU: the port stores the plane dtype JAX stores for the same
matrix; the twins of H-DIA, the chunk and the shard step on bfloat16
planes equal the same twins on the same planes in float32 bit for bit;
the chunk twin on the port's copy of JAX's bfloat16 planes meets JAX's
windowed K3 in interpret mode at ``test_torch_cp_dia.py``'s stated rtol
1e-5 and atol 1e-6 (the kernels sum the taps in other orders); a plain
emulation of H-CPDIA-G's schedule (:func:`grid_chunk`) is bit-equal to
the twin.  Marked ``cuda``: H-CPDIA-G against the twin and the two-launch
kernel bit for bit, and H-DIA, H-CPDIA-R, the two-launch kernel and the
shard entry on bfloat16 planes against the same kernels on float32
planes.

The emulation runs the chunk as the kernel splits it: CTA r of the plan's
``ctas`` owns positions ``[r W, (r + 1) W)`` and holds its own copies of
x3 and y with the plan's halos; a pass computes its slab from its copies
only and writes its new entries to its copy and to the shared ("device")
vector; after each pass (the grid barrier) every CTA reads its halos from
the shared vector.  A halo may span several slabs.

JAX is imported inside the tests: the card machine, which runs this file's
``cuda`` cases (``python -m pytest --noconftest -m cuda``), has none."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse
import torch

from pysparselp_tpu_torch.examples.potts import (
    build_linear_program, build_multilabel_linear_program)
from pysparselp_tpu_torch.ops import _build, cp_dia
from pysparselp_tpu_torch.ops.cp_dia import (
    TWO_LAUNCH, cp_dia_chunk, cp_dia_chunk_reference, cp_dia_grid_chunk,
    cp_dia_plan, cp_dia_shard_step, cp_dia_shard_step_reference, grid_plan)
from pysparselp_tpu_torch.ops.dia_spmv import (DiaOperand, dia_apply,
                                               dia_spmv_reference)
from pysparselp_tpu_torch.parallel import sharded_cp_windowed as scw
from pysparselp_tpu_torch.problem import (DiaMatrix, dia_plane_dtype,
                                          lower_systems, one_plane_storage)
from torch_port_helpers import (assert_close, assert_same_bits,
                                cuda_or_skip, host_system, jax_problem,
                                nan_signed_zero_case, port_problem,
                                start_point, torch_pre)

torch.set_num_threads(1)
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16

GRIDS = {
    "potts20": lambda: build_linear_program(20, 0.5, 500)[0],
    "potts100": lambda: build_linear_program(100, 0.5, 500)[0],
    "potts300": lambda: build_linear_program(300, 0.5, 500)[0],
    "multilabel16": lambda: build_multilabel_linear_program(16, 3, seed=2)[0],
    "multilabel64": lambda: build_multilabel_linear_program(64, 4)[0],
}
_systems = {}


def _system(key):
    if key not in _systems:
        _systems[key] = host_system(GRIDS[key](), align=True)
    return _systems[key]


def _f32_planes(op):
    """``op`` with its planes stored in float32 (the same values)."""
    if op is None:
        return None
    return DiaMatrix.from_planes(op.vals.float(), op.offsets,
                                 op.vals_t.float(), op.offsets_t, op.nrows,
                                 op.ncols, F32, op.vals.device)


def _problems(key, device="cpu"):
    """The float32 problem of a grid with its planes as lowered (bfloat16)
    and the same problem on float32 planes, and the steps."""
    prob, pre = port_problem(_system(key), "dia", F32, device)
    wide = dataclasses.replace(prob, a_eq=_f32_planes(prob.a_eq),
                               a_ineq=_f32_planes(prob.a_ineq))
    return prob, wide, pre


def _start(key, prob, dtype, device="cpu", seed=3):
    x, ye, yi = start_point(_system(key), seed)
    return [torch.as_tensor(v, dtype=dtype, device=device)
            for v in (x, ye if prob.a_eq is not None else [], yi)]


# ----------------------------------------------------------------------
# the storage rule against JAX's
# ----------------------------------------------------------------------

def _matrices():
    potts = _system("potts20")["a_ineq"]
    rng = np.random.RandomState(0)
    tenths = scipy.sparse.random(40, 50, density=0.1, random_state=rng,
                                 format="csr")
    tenths.data[:] = 0.1
    rounded = scipy.sparse.random(40, 50, density=0.1, random_state=rng,
                                  format="csr")
    rounded.data[:] = rng.randn(rounded.nnz)
    return dict(potts=potts, tenths=tenths, rounded=rounded)


# (matrix, dtype, allow_bf16) -> the dtype JAX stores
STORAGE = [("potts", "float32", "exact", "bfloat16"),
           ("tenths", "float32", "exact", "float32"),
           ("potts", "float64", "exact", "float64"),
           ("potts", "float32", False, "float32"),
           ("rounded", "float32", "always", "bfloat16"),
           ("rounded", "float32", "exact", "float32")]


@pytest.mark.parametrize("key, dtype, allow, stored", STORAGE)
def test_from_scipy_stores_the_plane_dtype_jax_stores(key, dtype, allow,
                                                      stored):
    """The port's planes have JAX's dtype and, widened, JAX's values (for
    ``"always"``: ``ml_dtypes``' rounding of every value)."""
    import jax.numpy as jnp

    from pysparselp_tpu.problem import DiaMatrix as JaxDia

    a = _matrices()[key]
    want = JaxDia.from_scipy(a, dtype=getattr(jnp, dtype), allow_bf16=allow)
    tdt = getattr(torch, dtype)
    got = DiaMatrix.from_scipy(a, tdt, "cpu", allow_bf16=allow)
    assert str(want.vals.dtype) == stored
    assert got.vals.dtype == got.vals_t.dtype == getattr(torch, stored)
    assert dia_plane_dtype(a.tocoo().data, tdt, allow) == got.vals.dtype
    assert got.dtype == tdt
    for mine, theirs, offsets, size in (
            (got.vals, want.vals, got.offsets, got.nrows),
            (got.vals_t, want.vals_t, got.offsets_t, got.ncols)):
        ref = np.asarray(theirs.astype(jnp.float64))[:len(offsets), :size]
        np.testing.assert_array_equal(mine.double().numpy(), ref)


def test_host_reductions_widen_before_arithmetic():
    """``abs_power_*sum`` and ``sq_rowsum_weighted`` on bfloat16 planes
    equal the float32 planes' bit for bit (squares taken in float32)."""
    prob, wide, _ = _problems("multilabel16")
    for op, ref in ((prob.a_ineq, wide.a_ineq), (prob.a_eq, wide.a_eq)):
        assert op.vals.dtype == BF16 and ref.vals.dtype == F32
        d = torch.as_tensor(np.random.RandomState(1).rand(op.ncols),
                            dtype=F32)
        for p in (1.0, 2.0):
            assert torch.equal(op.abs_power_rowsum(p),
                               ref.abs_power_rowsum(p))
            assert torch.equal(op.abs_power_colsum(p),
                               ref.abs_power_colsum(p))
        assert torch.equal(op.sq_rowsum_weighted(d),
                           ref.sq_rowsum_weighted(d))


def test_mixed_plane_storage_reads_both_systems_in_the_solve_dtype():
    """A system exact in bfloat16 beside one that is not: the kernels take
    one storage type a launch, so the lowering re-stores both in float32
    (``one_plane_storage``, the bfloat16 planes widened exactly), the plan
    prices 4-byte planes without building anything, a launch refuses a
    mixed pair, and the twin computes the same bits on either storage."""
    prob, _, pre = _problems("multilabel16")
    eq = prob.a_eq
    tenths = DiaMatrix.from_planes(
        eq.vals.double().numpy() * 0.1, eq.offsets,
        eq.vals_t.double().numpy() * 0.1, eq.offsets_t, eq.nrows, eq.ncols,
        F32, "cpu")
    mixed = dataclasses.replace(prob, a_eq=tenths)
    assert mixed.a_ineq.vals.dtype == BF16 and tenths.vals.dtype == F32
    assert cp_dia._shape(mixed, F32)[-1] == 4
    assert cp_dia._shape(prob, F32)[-1] == 2
    assert [p.dtype for p in cp_dia._planes(mixed)] == [BF16, BF16, F32, F32]
    with pytest.raises(TypeError, match="several dtypes"):
        _build.check_planes(*cp_dia._planes(mixed), dtype=F32,
                            device=torch.device("cpu"))
    a_eq, a_ineq = one_plane_storage([tenths, mixed.a_ineq])
    assert a_eq is tenths
    assert a_ineq.vals.dtype == F32 and a_ineq.vals_t.dtype == F32
    assert torch.equal(a_ineq.vals_t, mixed.a_ineq.vals_t.float())
    assert torch.equal(a_ineq.vals, mixed.a_ineq.vals.float())
    assert one_plane_storage([None, prob.a_ineq]) == [None, prob.a_ineq]
    stored = dataclasses.replace(mixed, a_ineq=a_ineq)
    assert cp_dia._shape(stored, F32)[-1] == 4
    x, ye, yi = _start("multilabel16", prob, F32)
    assert_same_bits(
        cp_dia_chunk_reference(mixed, pre, x, ye, yi, 5, 1.0, True),
        cp_dia_chunk_reference(stored, pre, x, ye, yi, 5, 1.0, True))
    # the lowering of such a pair: Potts' ±1 beside the tenths
    sys_ = _system("potts20")
    lowered = lower_systems([sys_["a_ineq"] * 0.1, sys_["a_ineq"]], F32,
                            "cpu", [("dia", None, None)] * 2)
    assert [op.vals.dtype for op in lowered] == [F32, F32]
    alone = lower_systems([None, sys_["a_ineq"]], F32, "cpu",
                          [("dia", None, None)] * 2)
    assert alone[1].vals.dtype == BF16


# ----------------------------------------------------------------------
# the twins on bfloat16 planes against float32 planes
# ----------------------------------------------------------------------

def test_dia_twin_bit_equal_on_bf16_and_f32_planes():
    prob, wide, _ = _problems("multilabel16")
    x = torch.as_tensor(np.random.RandomState(2).randn(prob.n), dtype=F32)
    for op, ref in ((prob.a_ineq, wide.a_ineq), (prob.a_eq, wide.a_eq)):
        got = dia_spmv_reference(op.vals, op.offs, x, op.nrows)
        assert got.dtype == F32
        assert torch.equal(got, dia_spmv_reference(ref.vals, ref.offs, x,
                                                   ref.nrows))
        assert torch.equal(op.matvec(x), ref.matvec(x))
        y = x[:op.nrows]
        assert torch.equal(op.rmatvec(y), ref.rmatvec(y))


@pytest.mark.parametrize("key", ["potts20", "multilabel16"])
def test_chunk_twin_bit_equal_on_bf16_and_f32_planes(key):
    prob, wide, pre = _problems(key)
    args = _start(key, prob, F32)
    got = cp_dia_chunk_reference(prob, pre, *args, 9, 1.0, with_sums=True)
    want = cp_dia_chunk_reference(wide, pre, *args, 9, 1.0, with_sums=True)
    assert_same_bits(got, want, key)


def _shards(key, dtype, ndev, device="cpu"):
    """The position-sharded ranks of a grid (its ±1 planes stored in
    bfloat16 for float32): ``[(data, state)]``."""
    sys_d = dict(_system(key))
    x, ye, yi = start_point(sys_d, 4)
    sys_d.update(x0=x, x30=None, y_eq0=ye if sys_d["a_eq"] is not None
                 else None, y_ineq0=yi)
    n = len(sys_d["c"])
    m_eq = sys_d["a_eq"].shape[0] if sys_d["a_eq"] is not None else 0
    info = scw.position_shard_plan(sys_d["a_eq"], sys_d["a_ineq"], n, m_eq,
                                   sys_d["a_ineq"].shape[0], ndev,
                                   np.float32, device="cuda")
    glob = scw.position_system(sys_d, info)
    return [scw.place_position_shard(glob, ndev, r, dtype, device)
            for r in range(ndev)]


def _widened(sh):
    return dataclasses.replace(sh, a_ineq=_f32_planes(sh.a_ineq),
                               a_eq=_f32_planes(sh.a_eq))


@pytest.mark.parametrize("key", ["potts20", "multilabel16"])
def test_shard_step_twin_bit_equal_on_bf16_and_f32_planes(key):
    """One step of each of 3 ranks' slices, from the same state."""
    for data, state in _shards(key, F32, 3):
        sh = data["shard"]
        assert sh.a_ineq.vals.dtype == BF16
        outs = []
        for shard in (sh, _widened(sh)):
            s = {k: v.clone() for k, v in state.items()}
            sums = tuple(torch.zeros_like(s["x"]) for _ in range(3))
            cp_dia_shard_step_reference(
                shard, data["pre"], s["x"], s["x3"],
                s.get("y_eq", s["x"][:0]), s["y_ineq"], data["theta"], sums)
            outs.append([s[k] for k in sorted(s)] + list(sums))
        assert_same_bits(*outs, what=key)


def test_chunk_twin_on_jax_bf16_planes_matches_windowed_kernel(monkeypatch):
    """The port's copy of JAX's planes stays bfloat16, and the chunk twin
    on it meets JAX's windowed K3 (interpret mode, windows and halos) on
    the multi-label 16 grid."""
    import jax.numpy as jnp

    from pysparselp_tpu.ops import cp_windowed
    from pysparselp_tpu.problem import DiaMatrix as JaxDia
    from pysparselp_tpu_torch.utils.convert import problem_from_jax_arrays

    monkeypatch.setattr(cp_windowed, "WINDOWED_VMEM_BUDGET", 2 * 1024 * 1024)
    monkeypatch.setattr(cp_windowed, "_MIN_WQ", 8)
    sys_ = _system("multilabel16")
    jprob, jpre = jax_problem(sys_, "dia", jnp.float32)
    # JAX's own storage (allow_bf16="exact"): the ±1 planes in bfloat16
    jprob = dataclasses.replace(jprob, **{
        k: JaxDia.from_scipy(sys_[k], dtype=jnp.float32)
        for k in ("a_eq", "a_ineq")})
    assert jprob.a_ineq.vals.dtype == jprob.a_eq.vals.dtype == jnp.bfloat16
    prob = problem_from_jax_arrays(jprob, dtype=F32, device="cpu")
    assert prob.a_ineq.vals.dtype == prob.a_eq.vals.dtype == BF16
    pre = torch_pre({k: v for k, v in jpre.items() if k != "theta"}, F32)
    x, ye, yi = start_point(sys_, 1)
    want = cp_windowed._cp_windowed_call_full(
        jprob, jpre, *(jnp.asarray(v, jnp.float32) for v in (x, ye, yi)),
        10, 1.0, interpret=True, with_sums=True)
    got = cp_dia_chunk(prob, pre, *(torch.as_tensor(v, dtype=F32)
                                    for v in (x, ye, yi)),
                       10, 1.0, with_sums=True)
    assert_close(got, want, rtol=1e-5, atol=1e-6, what="cp_windowed")


# ----------------------------------------------------------------------
# H-CPDIA-G's schedule, emulated
# ----------------------------------------------------------------------

def grid_chunk(prob, pre, x, y_eq, y, nsteps, theta, with_sums, plan):
    """H-CPDIA-G's decomposition of a chunk in plain PyTorch (see the
    module docstring)."""
    ae, ai = prob.a_eq, prob.a_ineq
    n = prob.n
    m = prob.m_ineq if ai is not None else 0
    me = prob.m_eq if ae is not None else 0
    W, C = plan.width, plan.ctas
    (hlx, hrx), (hly, hry) = plan.halos
    lo = [r * W for r in range(C)]

    def own(r, length):
        return max(0, min(W, length - lo[r]))

    def read(ext, src, length, r, hl, hr, halos_only):
        """Slab r's copy ``ext`` (position lo + i at ext[hl + i]) from the
        shared vector: its halos, or everything."""
        for i in range(-hl, W + hr):
            if halos_only and 0 <= i < W:
                continue
            p = lo[r] + i
            ext[hl + i] = src[p] if 0 <= p < length else 0.0

    def taps(op_vals, offsets, r, w, ext, hl):
        acc = torch.zeros(w, dtype=x.dtype)
        v = op_vals.to(x.dtype)
        for k, o in enumerate(offsets):
            acc = acc + v[k, lo[r]:lo[r] + w] * ext[hl + o:hl + o + w]
        return acc

    def copies(src, length, hl, hr):
        out = [torch.zeros(hl + W + hr, dtype=x.dtype) for _ in range(C)]
        if src is not None:
            for r in range(C):
                read(out[r], src, length, r, hl, hr, False)
        return out

    g_x3, g_y = x.clone(), y.clone() if ai is not None else None
    g_ye = y_eq.clone() if ae is not None else None
    x3e = copies(None, n, hlx, hrx)
    yie = copies(g_y, m, hly, hry)
    yee = copies(g_ye, me, hly, hry)
    xs = x.clone()
    sx = torch.zeros_like(x)
    si = torch.zeros(m, dtype=x.dtype)
    se = torch.zeros(me, dtype=x.dtype)
    for _ in range(nsteps):
        for r in range(C):                       # primal pass
            w, a = own(r, n), lo[r]
            d = prob.c[a:a + w]
            if ae is not None:
                d = d + taps(ae.vals_t, ae.offsets_t, r, w, yee[r], hly)
            if ai is not None:
                d = d + taps(ai.vals_t, ai.offsets_t, r, w, yie[r], hly)
            xo = xs[a:a + w]
            x2 = torch.clamp(xo - pre["diag_t"][a:a + w] * d,
                             prob.lb[a:a + w], prob.ub[a:a + w])
            x3 = (1.0 + theta) * x2 - theta * xo
            x3e[r][hlx:hlx + w] = x3
            g_x3[a:a + w] = x3
            xs[a:a + w] = x2
            if with_sums:
                sx[a:a + w] = sx[a:a + w] + x2
        for r in range(C):                       # the barrier: x3's halos
            read(x3e[r], g_x3, n, r, hlx, hrx, True)
        for r in range(C):                       # dual pass
            a = lo[r]
            if ae is not None:
                w = own(r, me)
                res = taps(ae.vals, ae.offsets, r, w, x3e[r],
                           hlx) - prob.b_eq[a:a + w]
                new = yee[r][hly:hly + w] + pre["sigma_eq"][a:a + w] * res
                yee[r][hly:hly + w] = new
                g_ye[a:a + w] = new
                if with_sums:
                    se[a:a + w] = se[a:a + w] + new
            if ai is not None:
                w = own(r, m)
                res = taps(ai.vals, ai.offsets, r, w, x3e[r],
                           hlx) - prob.b_upper[a:a + w]
                new = torch.clamp_min(
                    yie[r][hly:hly + w] + pre["sigma_ineq"][a:a + w] * res,
                    0.0)
                yie[r][hly:hly + w] = new
                g_y[a:a + w] = new
                if with_sums:
                    si[a:a + w] = si[a:a + w] + new
        for r in range(C):                       # the barrier: y's halos
            if ai is not None:
                read(yie[r], g_y, m, r, hly, hry, True)
            if ae is not None:
                read(yee[r], g_ye, me, r, hly, hry, True)
    out = (xs, g_x3, g_ye if ae is not None else x[:0],
           g_y if ai is not None else x[:0])
    return out + (sx, se, si) if with_sums else out


def test_grid_emulation_of_an_equality_system_alone():
    """The multi-label grid's equality system without its inequalities:
    the plan prices its planes alone, and the emulation equals the twin."""
    prob, pre = port_problem(_system("multilabel16"), "dia", F32)
    prob = dataclasses.replace(prob, a_ineq=None, b_upper=None, m_ineq=0)
    pre = {k: v for k, v in pre.items() if k != "sigma_ineq"}
    plan = grid_plan(prob, F32, ctas=9)
    assert plan.tier == "grid" and "sy" not in plan.vectors
    x, ye, _ = (torch.as_tensor(v, dtype=F32)
                for v in start_point(_system("multilabel16"), 5))
    args = (prob, pre, x, ye, x[:0], 6, 1.0, True)
    assert_same_bits(grid_chunk(*args[:-1], True, plan),
                     cp_dia_chunk_reference(*args), "equalities alone")


@pytest.mark.parametrize("with_sums", [True, False])
@pytest.mark.parametrize("nsteps", [1, 6])
@pytest.mark.parametrize("key, dtype, ctas", [
    ("potts20", F32, 5), ("potts20", F64, 13), ("multilabel16", F32, 9),
    ("multilabel16", F64, 32)])
def test_grid_emulation_is_bit_equal_to_twin(key, dtype, ctas, nsteps,
                                             with_sums):
    """At 32 CTAs the multi-label grid's slabs (96 positions) are narrower
    than its halos (192): a halo spans several slabs."""
    prob, pre = port_problem(_system(key), "dia", dtype)
    plan = grid_plan(prob, dtype, ctas=ctas)
    assert plan.tier == "grid" and plan.ctas == ctas
    args = _start(key, prob, dtype, seed=5)
    got = grid_chunk(prob, pre, *args, nsteps, 1.0, with_sums, plan)
    want = cp_dia_chunk_reference(prob, pre, *args, nsteps, 1.0, with_sums)
    assert len(got) == len(want)
    assert_same_bits(got, want, key)


def test_grid_plan_keeps_what_fits():
    """Potts-300 in float32 fits only on bfloat16 planes (141,856 bytes of
    planes a CTA); its vectors fill the rest in order; on float32 planes
    no slab fits and the two-launch tier runs."""
    prob, wide, _ = _problems("potts300")
    plan = cp_dia_plan(prob, F32)
    assert plan.tier == "grid" and plan.width == 2728 and plan.ctas == 132
    assert plan.vectors == ("x", "sx", "sy", "c", "t")
    assert cp_dia_plan(wide, F32) == TWO_LAUNCH
    assert grid_plan(wide, F32) is None


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("key, dtype", [
    ("potts100", F32), ("potts100", F64), ("potts300", F32),
    ("multilabel64", F32)])
def test_grid_kernel_matches_twin_and_two_launch_on_cuda(key, dtype):
    """One launch a chunk, bit for bit with the twin and the two-launch
    kernel, with and without sums, at 1, 7 and 60 iterations."""
    dev = cuda_or_skip()
    prob, pre = port_problem(_system(key), "dia", dtype, dev)
    plan = cp_dia_plan(prob, dtype)
    assert plan.tier == "grid"
    args = _start(key, prob, dtype, dev)
    for nsteps in (1, 7, 60):
        for with_sums in (True, False):
            want = cp_dia_chunk_reference(prob, pre, *args, nsteps, 1.0,
                                          with_sums)
            two = cp_dia_chunk(prob, pre, *args, nsteps, 1.0, with_sums,
                               plan=TWO_LAUNCH)
            launches = cp_dia_grid_chunk.launches
            got = cp_dia_chunk(prob, pre, *args, nsteps, 1.0, with_sums)
            assert cp_dia_grid_chunk.launches == launches + 1
            assert_same_bits(got, want, f"{key} twin")
            assert_same_bits(got, two, f"{key} two-launch")


@pytest.mark.cuda
def test_grid_kernel_on_an_equality_system_alone_on_cuda():
    """The multi-label 64 grid's equality system without its inequalities
    (no y, its sum, b or σ): one launch, bit for bit with the twin and the
    two-launch kernel."""
    dev = cuda_or_skip()
    prob, pre = port_problem(_system("multilabel64"), "dia", F32, dev)
    prob = dataclasses.replace(prob, a_ineq=None, b_upper=None, m_ineq=0)
    pre = {k: v for k, v in pre.items() if k != "sigma_ineq"}
    assert cp_dia_plan(prob, F32).tier == "grid"
    x, ye, _ = _start("multilabel64", prob, F32, dev)
    for with_sums in (True, False):
        args = (prob, pre, x, ye, x[:0], 25, 1.0, with_sums)
        launches = cp_dia_grid_chunk.launches
        got = cp_dia_chunk(*args)
        assert cp_dia_grid_chunk.launches == launches + 1
        assert_same_bits(got, cp_dia_chunk_reference(*args), "twin")
        assert_same_bits(got, cp_dia_chunk(*args, plan=TWO_LAUNCH),
                         "two-launch")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("key", ["potts100", "multilabel64"])
def test_grid_kernel_keeps_nan_and_signed_zeros_on_cuda(key, dtype):
    dev = cuda_or_skip()
    sys_, start = nan_signed_zero_case(_system(key), seed=3)
    prob, pre = port_problem(sys_, "dia", dtype, dev)
    assert cp_dia_plan(prob, dtype).tier == "grid"
    args = [torch.as_tensor(v, dtype=dtype, device=dev) for v in start]
    if prob.a_eq is None:
        args[1] = args[1][:0]
    for nsteps in (1, 5):
        want = cp_dia_chunk_reference(prob, pre, *args, nsteps, 1.0, True)
        got = cp_dia_chunk(prob, pre, *args, nsteps, 1.0, True)
        nans, negzeros = assert_same_bits(got, want, key)
        assert nans and negzeros


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["potts20", "potts100", "multilabel64"])
def test_kernels_bit_equal_on_bf16_and_f32_planes_on_cuda(key):
    """H-DIA both ways, the planned tier (H-CPDIA-R at Potts-20, H-CPDIA-G
    else) and the two-launch kernel, each on bfloat16 planes and on the
    same planes in float32."""
    dev = cuda_or_skip()
    prob, wide, pre = _problems(key, dev)
    x = torch.as_tensor(np.random.RandomState(2).randn(prob.n), dtype=F32,
                        device=dev)
    for op, ref in ((prob.a_ineq, wide.a_ineq), (prob.a_eq, wide.a_eq)):
        if op is None:
            continue
        assert op.vals.dtype == BF16
        assert torch.equal(op.matvec(x), ref.matvec(x))
        assert torch.equal(op.rmatvec(x[:op.nrows]),
                           ref.rmatvec(x[:op.nrows]))
        operand = DiaOperand(op.vals, op.offs, op.nrows)
        assert torch.equal(dia_apply(operand, x),
                           dia_spmv_reference(op.vals, op.offs, x, op.nrows))
    args = _start(key, prob, F32, dev)
    tier = cp_dia_plan(prob, F32).tier
    assert tier == ("resident" if key == "potts20" else "grid")
    for plan in (None, TWO_LAUNCH):
        got = cp_dia_chunk(prob, pre, *args, 40, 1.0, True, plan=plan)
        want = cp_dia_chunk(wide, pre, *args, 40, 1.0, True,
                            plan=plan if plan is not None
                            else cp_dia_plan(wide, F32))
        assert_same_bits(got, want, f"{key} {plan or tier}")


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["potts100", "multilabel64"])
def test_shard_entry_bit_equal_on_bf16_and_f32_planes_on_cuda(key):
    """Five steps of each of 4 ranks' slices on the card, from the same
    state, on bfloat16 planes and on float32 planes."""
    dev = cuda_or_skip()
    for data, state in _shards(key, F32, 4, dev):
        sh = data["shard"]
        assert sh.a_ineq.vals.dtype == BF16
        outs = []
        for shard in (sh, _widened(sh)):
            s = {k: v.clone() for k, v in state.items()}
            sums = tuple(torch.zeros_like(s["x"]) for _ in range(3))
            before = cp_dia_shard_step.launches
            for _ in range(5):
                cp_dia_shard_step(shard, data["pre"], s["x"], s["x3"],
                                  s.get("y_eq", s["x"][:0]), s["y_ineq"],
                                  data["theta"], sums)
            assert cp_dia_shard_step.launches == (
                before + 5 * cp_dia.SHARD_LAUNCHES)
            outs.append([s[k] for k in sorted(s)] + list(sums))
        assert_same_bits(*outs, what=key)
