"""H-CPDIA-R (``ops/cp_dia.py``, ``csrc/cp_dia_resident.cu``): the plan
that routes a DIA problem to the resident or the two-launch tier, a plain
emulation of the resident kernel's slab decomposition held bit-equal to the
twin in float64, and (``cuda``-marked) the kernel against the twin, against
the two-launch kernel and through a restart solve.

The emulation (:func:`slab_chunk`) runs the chunk as the kernel splits it:
each of the plan's slabs holds x3, y and y_e in two buffers (one per
iteration parity) with ``reach`` entries of halo on each side, a pass
computes its own positions from its own slab and halos only, and writes
each new entry near a slab edge into the neighbour's halo; the passes of
all slabs end before the next pass starts (the barrier).  Bit-equality with
:func:`cp_dia_chunk_reference` catches a halo, partition or buffer-parity
fault here, where the kernel cannot run.
"""

import numpy as np
import pytest
import torch

from pysparselp_tpu_torch.examples.potts import (
    build_linear_program, build_multilabel_linear_program)
from pysparselp_tpu_torch.ops import cp_dia
from pysparselp_tpu_torch.ops.cp_dia import (cp_dia_chunk,
                                             cp_dia_chunk_reference,
                                             cp_dia_plan,
                                             cp_dia_resident_chunk)
from torch_port_helpers import (assert_same_bits, cuda_or_skip,
                                host_system, nan_signed_zero_case,
                                port_problem, start_point)

torch.set_num_threads(1)
F64 = torch.float64

GRIDS = {
    "potts20": lambda: build_linear_program(20, 0.5, 500)[0],
    "potts50": lambda: build_linear_program(50, 0.5, 500)[0],
    "potts100": lambda: build_linear_program(100, 0.5, 500)[0],
    "potts300": lambda: build_linear_program(300, 0.5, 500)[0],
    "multilabel64": lambda: build_multilabel_linear_program(64, 4)[0],
    "multilabel16": lambda: build_multilabel_linear_program(16, 3, seed=2)[0],
}
_systems = {}


def _system(key):
    if key not in _systems:
        _systems[key] = host_system(GRIDS[key](), align=True)
    return _systems[key]


def _problem(key, dtype, device="cpu"):
    return port_problem(_system(key), "dia", dtype, device)


def _forced(prob, dtype, cluster):
    """The plan at one cluster size (``None``: the largest that fits)."""
    return cp_dia._plan(*cp_dia._shape(prob, dtype), cluster=cluster)


def _offsets(prob):
    return [o for op in (prob.a_ineq, prob.a_eq) if op is not None
            for o in (*op.offsets_t, *op.offsets)]


@pytest.mark.parametrize("key, dtype, tier", [
    ("potts20", torch.float32, "resident"),
    ("potts20", torch.float64, "resident"),
    ("potts50", torch.float32, "resident"),
    ("potts50", torch.float64, "resident"),
    ("multilabel16", torch.float64, "resident"),
    ("potts100", torch.float32, "grid"),
    ("potts100", torch.float64, "grid"),
    ("potts300", torch.float32, "grid"),
    ("potts300", torch.float64, "two_launch"),
    ("multilabel64", torch.float32, "grid"),
    ("multilabel64", torch.float64, "grid"),
])
def test_plan_tier_and_slabs(key, dtype, tier):
    prob, _ = _problem(key, dtype)
    plan = cp_dia_plan(prob, dtype)
    assert plan.tier == tier, plan
    if tier == "two_launch":
        assert plan == cp_dia.TWO_LAUNCH
        return
    positions = max(prob.n, prob.m_ineq, prob.m_eq)
    assert plan.positions == positions
    if tier == "grid":
        _check_grid_plan(prob, dtype, plan)
        return
    # the slabs tile [0, positions) exactly: no gap, no overlap
    assert len(plan.slabs) == plan.cluster + 1
    assert plan.slabs[0] == 0 and plan.slabs[-1] == positions
    widths = np.diff(plan.slabs)
    assert (widths >= 0).all() and (widths <= plan.width).all()
    assert plan.width * plan.cluster >= positions
    assert plan.cluster in cp_dia.CLUSTER_SIZES
    # no CTA past the budget; the halo covers every tap, within a neighbour
    assert plan.smem_bytes <= cp_dia.SMEM_PER_CTA
    assert plan.reach == max(abs(o) for o in _offsets(prob))
    assert plan.reach <= plan.width
    assert plan.threads % 32 == 0 and plan.threads <= cp_dia.MAX_THREADS
    assert plan.threads >= min(plan.width, cp_dia.MAX_THREADS)


def _check_grid_plan(prob, dtype, plan):
    """H-CPDIA-G's plan: a CTA an SM (132), slabs that tile the positions,
    the halos of x3 (A's taps) and y (Aᵀ's), the layout within the budget
    with every plane as stored, and the vectors it keeps in order."""
    positions = plan.positions
    assert plan.ctas == min(cp_dia.GRID_SMS,
                            positions // cp_dia.GRID_MIN_WIDTH)
    assert len(plan.slabs) == plan.ctas + 1
    assert plan.slabs[0] == 0 and plan.slabs[-1] == positions
    assert plan.width == -(-positions // plan.ctas)
    ops = [op for op in (prob.a_ineq, prob.a_eq) if op is not None]
    fwd = [o for op in ops for o in op.offsets]
    assert plan.halos == ((max(0, -min(fwd)), max(0, max(fwd))),
                          (max(0, max(fwd)), max(0, -min(fwd))))
    itemsize = torch.finfo(dtype).bits // 8
    planes = ops[0].vals.element_size()
    assert planes == (2 if dtype == torch.float32 else 8)
    ndiags = [len(o) for op in (prob.a_ineq, prob.a_eq) if op is not None
              for o in (op.offsets_t, op.offsets)]
    m = prob.m_ineq if prob.a_ineq is not None else 0
    me = prob.m_eq if prob.a_eq is not None else 0
    assert plan.smem_bytes == cp_dia.grid_smem_bytes(
        plan.width, plan.halos, ndiags, m, me, itemsize, planes,
        plan.vectors)
    assert plan.smem_bytes <= cp_dia.SMEM_PER_CTA - cp_dia.GRID_STATIC_SMEM
    order = [cp_dia.GRID_VECTORS.index(v) for v in plan.vectors]
    assert order == sorted(order) and "x" in plan.vectors
    assert plan.threads % 32 == 0
    assert plan.threads == min(cp_dia.MAX_THREADS, -(-plan.width // 32) * 32)


def test_plan_takes_the_largest_cluster_that_fits():
    prob, _ = _problem("potts50", torch.float32)
    fits = [c for c in cp_dia.CLUSTER_SIZES
            if _forced(prob, torch.float32, c).tier == "resident"]
    assert fits == [8, 16]
    assert cp_dia_plan(prob, torch.float32).cluster == 16
    # float64 fits only at 16 CTAs; the budget, not the reach, decides
    prob64, _ = _problem("potts50", F64)
    assert [_forced(prob64, F64, c).tier
            for c in cp_dia.CLUSTER_SIZES] == ["two_launch"] * 4 + ["resident"]


def test_plan_counts_the_layout():
    prob, _ = _problem("multilabel16", F64)
    plan = _forced(prob, F64, 8)
    ai, ae = prob.a_ineq, prob.a_eq
    ndiags = (len(ai.offsets_t), len(ai.offsets), len(ae.offsets_t),
              len(ae.offsets))
    assert plan.smem_bytes == cp_dia.resident_smem_bytes(
        plan.width, plan.reach, ndiags, prob.m_ineq, prob.m_eq, 8)
    # per position 6 + both transposes' planes, 3 + planes per system, and
    # two buffers of x3, y and y_e with their halos; four mbarriers
    words = 6 + ndiags[0] + ndiags[2] + 3 + ndiags[1] + 3 + ndiags[3]
    assert plan.smem_bytes == 32 + 8 * (
        plan.width * words + 2 * 3 * (plan.width + 2 * plan.reach))


def _taps(vals, offsets, lo, w, nv, ext, reach):
    """One slab's tap sums in dia_row's order, reading only the slab's
    buffer with its halo (``ext[reach + i]`` is position lo + i)."""
    pos = torch.arange(lo, lo + w)
    acc = torch.zeros(w, dtype=ext.dtype)
    for k, o in enumerate(offsets):
        xv = ext[reach + o:reach + o + w]
        keep = (pos + o >= 0) & (pos + o < nv)
        acc = acc + vals[k, lo:lo + w] * torch.where(keep, xv,
                                                     torch.zeros_like(xv))
    return acc


def slab_chunk(prob, pre, x, y_eq, y, nsteps, theta, with_sums, plan):
    """The resident kernel's decomposition of a chunk in plain PyTorch (see
    the module docstring)."""
    ae, ai = prob.a_eq, prob.a_ineq
    n, C, W, R = prob.n, plan.cluster, plan.width, plan.reach
    m = prob.m_ineq if ai is not None else 0
    me = prob.m_eq if ae is not None else 0
    lo = [r * W for r in range(C)]

    def width(r, length):
        return max(0, min(W, length - lo[r]))

    def buffers(init, length):
        """Two buffers per slab; buffer 1 loaded with the slab and halo."""
        out = []
        for r in range(C):
            ext = torch.full((2, W + 2 * R), float("nan"), dtype=x.dtype)
            for i in range(-R, W + R):
                p = lo[r] + i
                if init is not None and 0 <= p < length:
                    ext[1, R + i] = init[p]
            out.append(ext)
        return out

    def push(exts, r, k, vals):
        """Slab r's new entries into its buffer k and its neighbours'."""
        w = len(vals)
        exts[r][k, R:R + w] = vals
        if r > 0:
            exts[r - 1][k, R + W:R + W + min(R, w)] = vals[:R]
        if r < C - 1 and w > W - R:
            exts[r + 1][k, 0:w - (W - R)] = vals[W - R:]

    x3e = buffers(None, n)
    ye = buffers(y_eq if me else None, me)
    yi = buffers(y if m else None, m)
    xs = [x[lo[r]:lo[r] + width(r, n)].clone() for r in range(C)]
    sx = [torch.zeros_like(v) for v in xs]
    se = [torch.zeros(width(r, me), dtype=x.dtype) for r in range(C)]
    si = [torch.zeros(width(r, m), dtype=x.dtype) for r in range(C)]
    x3_out = [v.clone() for v in xs]
    for it in range(nsteps):
        k = it & 1
        for r in range(C):              # primal pass, slab by slab
            w, a = width(r, n), lo[r]
            d = prob.c[a:a + w]
            if ae is not None:
                d = d + _taps(ae.vals_t, ae.offsets_t, a, w, me, ye[r][k ^ 1],
                              R)
            if ai is not None:
                d = d + _taps(ai.vals_t, ai.offsets_t, a, w, m, yi[r][k ^ 1],
                              R)
            x2 = torch.clamp(xs[r] - pre["diag_t"][a:a + w] * d,
                             prob.lb[a:a + w], prob.ub[a:a + w])
            x3 = (1.0 + theta) * x2 - theta * xs[r]
            xs[r], x3_out[r] = x2, x3
            push(x3e, r, k, x3)
            if with_sums:
                sx[r] = sx[r] + x2
        for r in range(C):              # the barrier, then the dual pass
            a = lo[r]
            if ae is not None:
                w = width(r, me)
                res = _taps(ae.vals, ae.offsets, a, w, n, x3e[r][k],
                            R) - prob.b_eq[a:a + w]
                new = ye[r][k ^ 1, R:R + w] + pre["sigma_eq"][a:a + w] * res
                push(ye, r, k, new)
                if with_sums:
                    se[r] = se[r] + new
            if ai is not None:
                w = width(r, m)
                res = _taps(ai.vals, ai.offsets, a, w, n, x3e[r][k],
                            R) - prob.b_upper[a:a + w]
                new = torch.clamp_min(
                    yi[r][k ^ 1, R:R + w] + pre["sigma_ineq"][a:a + w] * res,
                    0.0)
                push(yi, r, k, new)
                if with_sums:
                    si[r] = si[r] + new
    kl = (nsteps + 1) & 1
    out = (torch.cat(xs), torch.cat(x3_out),
           torch.cat([ye[r][kl, R:R + width(r, me)] for r in range(C)]),
           torch.cat([yi[r][kl, R:R + width(r, m)] for r in range(C)]))
    if with_sums:
        out += (torch.cat(sx), torch.cat(se), torch.cat(si))
    return out


@pytest.mark.parametrize("with_sums", [True, False])
@pytest.mark.parametrize("nsteps", [1, 7])
@pytest.mark.parametrize("key, cluster", [
    ("potts20", None), ("potts20", 4), ("potts50", None),
    ("multilabel16", None), ("multilabel16", 8)])
def test_slab_emulation_is_bit_equal_to_twin(key, cluster, nsteps,
                                             with_sums):
    prob, pre = _problem(key, F64)
    plan = _forced(prob, F64, cluster)
    assert plan.tier == "resident"
    x, ye, yi = (torch.as_tensor(v, dtype=F64)
                 for v in start_point(_system(key), 5))
    ye = ye if prob.a_eq is not None else torch.zeros(0, dtype=F64)
    got = slab_chunk(prob, pre, x, ye, yi, nsteps, 1.0, with_sums, plan)
    want = cp_dia_chunk_reference(prob, pre, x, ye, yi, nsteps, 1.0,
                                  with_sums)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w)


def test_cpu_tensors_run_the_twin_whatever_the_plan():
    prob, pre = _problem("potts20", F64)
    x, ye, yi = (torch.as_tensor(v, dtype=F64)
                 for v in start_point(_system("potts20"), 6))
    want = cp_dia_chunk_reference(prob, pre, x, ye[:0], yi, 3, 1.0, True)
    launches = (cp_dia_chunk.launches, cp_dia_resident_chunk.launches)
    for got in (cp_dia_chunk(prob, pre, x, ye[:0], yi, 3, 1.0, True),
                cp_dia_resident_chunk(prob, pre, x, ye[:0], yi, 3, 1.0, True)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert (cp_dia_chunk.launches, cp_dia_resident_chunk.launches) == launches


def _cuda_inputs(key, dtype, dev):
    prob, pre = _problem(key, dtype, dev)
    x, ye, yi = start_point(_system(key), 3)
    args = [torch.as_tensor(v, dtype=dtype, device=dev)
            for v in (x, ye if prob.a_eq is not None else [], yi)]
    return prob, pre, args


@pytest.mark.cuda
@pytest.mark.parametrize("nsteps", [1, 7, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("key", ["potts20", "potts50", "multilabel16"])
def test_resident_kernel_matches_twin_and_two_launch_on_cuda(key, dtype,
                                                             nsteps):
    dev = cuda_or_skip()
    prob, pre, args = _cuda_inputs(key, dtype, dev)
    assert cp_dia_plan(prob, dtype).tier == "resident"
    for with_sums in (True, False):
        want = cp_dia_chunk_reference(prob, pre, *args, nsteps, 1.0,
                                      with_sums)
        two = cp_dia_chunk(prob, pre, *args, nsteps, 1.0, with_sums,
                           plan=cp_dia.TWO_LAUNCH)
        launches = cp_dia_resident_chunk.launches
        got = cp_dia_chunk(prob, pre, *args, nsteps, 1.0, with_sums)
        assert cp_dia_resident_chunk.launches == launches + 1
        assert len(got) == len(want) == len(two)
        for g, w, t in zip(got, want, two):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
            torch.testing.assert_close(g, t, rtol=0, atol=0)


@pytest.mark.cuda
def test_potts20_restart_solve_runs_the_resident_kernel_on_cuda():
    cuda_or_skip()
    lp, gt, idx, _ = build_linear_program(20, 0.5, 500)
    run = dict(method="chambolle_pock_ppd", nb_iter=8000, nb_iter_plot=2000,
               restart_period=1000, restart="average", dtype=np.float64,
               ground_truth=gt, ground_truth_indices=idx)
    lp.solve(device="cpu", **run)
    want = {k: list(getattr(lp, k)) for k in ("pobj_curve", "dobj_curve")}
    want_dist = list(lp.distance_to_ground_truth)
    launches = cp_dia_resident_chunk.launches
    lp.solve(device="cuda", **run)
    assert cp_dia_resident_chunk.launches > launches
    for key, values in want.items():
        got = np.asarray(getattr(lp, key))
        np.testing.assert_allclose(got, values, rtol=1e-5, atol=1e-5 * max(
            1.0, float(np.max(np.abs(values)))))
    np.testing.assert_allclose(lp.distance_to_ground_truth, want_dist,
                               rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("nsteps", [1, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("key", ["potts20", "multilabel16"])
def test_resident_kernel_keeps_nan_and_signed_zeros_on_cuda(key, dtype,
                                                            nsteps):
    """H-CPDIA-R against the twin on the card, bit for bit, on a NaN cost,
    a NaN bound and costs, bounds and iterates at -0.0 and +0.0."""
    dev = cuda_or_skip()
    sys_, start = nan_signed_zero_case(_system(key), seed=3)
    prob, pre = port_problem(sys_, "dia", dtype, dev)
    assert cp_dia_plan(prob, dtype).tier == "resident"
    args = [torch.as_tensor(v, dtype=dtype, device=dev) for v in start]
    if prob.a_eq is None:
        args[1] = args[1][:0]
    for with_sums in (True, False):
        want = cp_dia_chunk_reference(prob, pre, *args, nsteps, 1.0,
                                      with_sums)
        launches = cp_dia_resident_chunk.launches
        got = cp_dia_chunk(prob, pre, *args, nsteps, 1.0, with_sums)
        assert cp_dia_resident_chunk.launches == launches + 1
        nans, negzeros = assert_same_bits(got, want, what=key)
        assert nans and negzeros
