"""H-CPDIA: ``nsteps`` whole Chambolle-Pock iterations on DIA operators,
equality and inequality systems alike, in two tiers chosen from the shapes
by :func:`cp_dia_plan`:

* ``"resident"`` (H-CPDIA-R, ``csrc/cp_dia_resident.cu``): one launch per
  chunk, the whole state held in the shared memory of one thread-block
  cluster; replaces ``pysparselp_tpu/ops/cp_fused.py::_cp_fused_call`` (K2)
  at its shapes, small aligned grids such as Potts-50;
* ``"two_launch"`` (``csrc/cp_dia.cu``): two launches per iteration, for
  everything that does not fit; replaces
  ``pysparselp_tpu/ops/cp_windowed.py::build_windowed_call`` (K3).

Both have the call contract of ``cp_windowed._cp_windowed_call_full``:
``(x, x3, y_eq, y[, sum_x, sum_y_eq, sum_y])``.  :func:`cp_dia_chunk`
launches the planned tier for CUDA tensors and runs
:func:`cp_dia_chunk_reference`, its plain PyTorch twin, for CPU tensors.
Inputs are never modified.

The two-launch tier has a second entry for the position-sharded mesh
solver (``parallel/sharded_cp_windowed.py``, where JAX runs K3 per shard):
:func:`cp_dia_shard_step` runs one iteration on one rank's
:class:`CpDiaShard`, a halo-padded slice of the position space, updating
the rank's state in place; :func:`cp_dia_shard_step_reference` is its
twin.  On every rank count it equals :func:`cp_dia_chunk` on the whole
system bit for bit (``csrc/cp_dia.cu``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from .dia_spmv import dia_spmv_reference

_P, _I = ctypes.c_void_p, ctypes.c_int

# H-CPDIA-R's limits on Hopper: the dynamic shared memory one block may
# take (227 KB), the cluster sizes (16 is non-portable) and the block size
SMEM_PER_CTA = 232_448
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MAX_THREADS = 1024
MAX_DIAG = 32   # diagonals a tap set may have (csrc: kMaxDiag)


def cp_dia_eligible(prob) -> bool:
    """Every present constraint system is a DiaMatrix."""
    from ..problem import DiaMatrix

    ops = [op for op in (prob.a_eq, prob.a_ineq) if op is not None]
    return bool(ops) and all(isinstance(op, DiaMatrix) for op in ops)


@dataclasses.dataclass(frozen=True)
class CpDiaPlan:
    """How :func:`cp_dia_chunk` runs a DIA problem: ``tier`` is
    ``"resident"`` or ``"two_launch"``; for the resident tier, ``cluster``
    CTAs (C) of ``threads`` threads, CTA r owning positions ``[slabs[r],
    slabs[r + 1])`` of ``[0, positions)`` (``width`` = W each but the
    last), ``smem_bytes`` of shared memory per CTA, ``reach``, the largest
    |offset| of any tap (at most W: a tap reads its own slab or a
    neighbour's; the halo each slab holds of x3 and y)."""

    tier: str
    cluster: int = 0
    width: int = 0
    slabs: tuple = ()
    smem_bytes: int = 0
    reach: int = 0
    threads: int = 0
    positions: int = 0


TWO_LAUNCH = CpDiaPlan("two_launch")


def resident_smem_bytes(width, reach, ndiags, m, me, itemsize) -> int:
    """Shared memory of one H-CPDIA-R CTA (the layout of
    ``csrc/cp_dia_resident.cu``): four mbarriers; per position c, T, l, u,
    x, the x sum and the planes of both transposes, and per present system
    b, sigma, the y sum and its planes; two buffers (one per iteration
    parity) of x3 and of each y with a halo of ``reach`` entries on each
    side (``ndiags``: the diagonal counts of A_i^T, A_i, A_e^T, A_e).  The
    sums are always reserved: a plan does not depend on ``with_sums``."""
    ndt, nd, ndte, nde = ndiags
    words, halos = 6 + ndt + ndte, 1
    if m > 0:
        words, halos = words + 3 + nd, halos + 1
    if me > 0:
        words, halos = words + 3 + nde, halos + 1
    return 32 + itemsize * (width * words + 2 * halos * (width + 2 * reach))


def _shape(prob, dtype):
    """The arguments of :func:`_plan`: a problem's shapes, its four offset
    tuples (A_i^T, A_i, A_e^T, A_e) and the item size of ``dtype``."""
    ae, ai = prob.a_eq, prob.a_ineq
    offsets = (tuple(ai.offsets_t) if ai is not None else (),
               tuple(ai.offsets) if ai is not None else (),
               tuple(ae.offsets_t) if ae is not None else (),
               tuple(ae.offsets) if ae is not None else ())
    m = prob.m_ineq if ai is not None else 0
    me = prob.m_eq if ae is not None else 0
    return prob.n, m, me, offsets, torch.finfo(dtype).bits // 8


@functools.lru_cache(maxsize=64)
def _plan(n, m, me, offsets, itemsize, cluster=None):
    """:func:`cp_dia_plan` on the shapes of :func:`_shape`; ``cluster``
    forces one cluster size (the tests and the probe's sweep)."""
    positions = max(n, m, me)
    reach = max((abs(o) for offs in offsets for o in offs), default=0)
    ndiags = tuple(map(len, offsets))
    if max(ndiags) > MAX_DIAG:
        return TWO_LAUNCH
    sizes = CLUSTER_SIZES[::-1] if cluster is None else (cluster,)
    for c in sizes:
        width = -(-positions // c)
        smem = resident_smem_bytes(width, reach, ndiags, m, me, itemsize)
        if smem > SMEM_PER_CTA or reach > width:
            continue
        slabs = tuple(min(r * width, positions) for r in range(c + 1))
        threads = min(MAX_THREADS, -(-width // 32) * 32)
        return CpDiaPlan("resident", c, width, slabs, smem, reach, threads,
                         positions)
    return TWO_LAUNCH


def cp_dia_plan(prob, dtype):
    """The tier of a DIA problem, from its shapes alone (the card's
    counterpart of JAX's ``fused_vmem_bytes`` / ``FUSED_VMEM_BUDGET`` rule,
    in shared-memory terms): ``"resident"`` at the largest cluster size C
    (the fastest at every size measured, PERF.md) whose slab of
    ``ceil(positions / C)`` positions, with its halos, fits one CTA's
    shared memory and is at least as wide as the farthest tap, with at most
    ``MAX_DIAG`` diagonals a tap set; else ``"two_launch"``."""
    return _plan(*_shape(prob, dtype))


def _empty(x):
    return torch.zeros(0, dtype=x.dtype, device=x.device)


def cp_dia_chunk_reference(prob, pre, x, y_eq, y, nsteps, theta,
                           with_sums=False):
    """Plain twin of :func:`cp_dia_chunk`, in the kernel's operation order."""
    ae, ai = prob.a_eq, prob.a_ineq
    n = prob.n
    x3 = x
    ye = y_eq if ae is not None else _empty(x)
    yi = y if ai is not None else _empty(x)
    sx, se, si = torch.zeros_like(x), torch.zeros_like(ye), torch.zeros_like(yi)
    for _ in range(nsteps):
        d = prob.c
        if ae is not None:
            d = d + dia_spmv_reference(ae.vals_t, ae.offs_t, ye, n)
        if ai is not None:
            d = d + dia_spmv_reference(ai.vals_t, ai.offs_t, yi, n)
        x2 = torch.clamp(x - pre["diag_t"] * d, prob.lb, prob.ub)
        x3 = (1.0 + theta) * x2 - theta * x
        x = x2
        if ae is not None:
            r = dia_spmv_reference(ae.vals, ae.offs, x3, prob.m_eq) - prob.b_eq
            ye = ye + pre["sigma_eq"] * r
        if ai is not None:
            r = (dia_spmv_reference(ai.vals, ai.offs, x3, prob.m_ineq)
                 - prob.b_upper)
            yi = torch.clamp_min(yi + pre["sigma_ineq"] * r, 0.0)
        if with_sums:
            sx, se, si = sx + x, se + ye, si + yi
    out = (x, x3, ye, yi)
    return out + (sx, se, si) if with_sums else out


def cp_dia_chunk(prob, pre, x, y_eq, y, nsteps, theta, with_sums=False,
                 plan=None):
    """Run ``nsteps`` CP iterations; returns ``(x, x3, y_eq, y[, sx, se,
    sy])`` (the eq outputs are empty when ``prob.a_eq`` is None).  On CUDA
    the tier of ``plan`` (default: :func:`cp_dia_plan`) runs; its
    resident tier counts in :func:`cp_dia_resident_chunk`'s ``launches``,
    the two-launch tier in this function's."""
    if x.device.type == "cpu":
        return cp_dia_chunk_reference(prob, pre, x, y_eq, y, nsteps, theta,
                                      with_sums)
    if x.device.type != "cuda":
        raise ValueError(f"cp_dia_chunk runs on CUDA or the CPU, not {x.device}")
    if plan is None:
        plan = cp_dia_plan(prob, x.dtype)
    if plan.tier == "resident":
        return cp_dia_resident_chunk(prob, pre, x, y_eq, y, nsteps, theta,
                                     with_sums, plan)
    ae, ai = prob.a_eq, prob.a_ineq
    dt, dev = x.dtype, x.device
    x = x.clone()
    x3 = x.clone()
    ye = y_eq.clone() if ae is not None else _empty(x)
    yi = y.clone() if ai is not None else _empty(x)
    sums = (tuple(torch.zeros_like(v) for v in (x, ye, yi)) if with_sums
            else (None, None, None))
    args = [prob.c, pre["diag_t"], prob.lb, prob.ub]
    if ai is not None:
        args += [ai.vals_t, ai.offs_t, ai.vals, ai.offs, prob.b_upper,
                 pre["sigma_ineq"]]
    if ae is not None:
        args += [ae.vals_t, ae.offs_t, ae.vals, ae.offs, prob.b_eq,
                 pre["sigma_eq"]]
    _build.check_cuda(*args, x, ye, yi, dtype=dt, device=dev)

    def sys_args(op, b, sigma):
        if op is None:
            return [None, None, 0, None, None, 0, None, None]
        return [op.vals_t, op.offs_t, len(op.offsets_t), op.vals, op.offs,
                len(op.offsets), b, sigma]

    a_in = sys_args(ai, prob.b_upper, pre.get("sigma_ineq"))
    a_eq = sys_args(ae, prob.b_eq, pre.get("sigma_eq"))
    m = prob.m_ineq if ai is not None else 0
    me = prob.m_eq if ae is not None else 0
    vec = [prob.c, pre["diag_t"], prob.lb, prob.ub]
    raw = ([prob.n, m, me] + vec + a_in + a_eq
           + [x, x3, yi, ye, sums[0], sums[2], sums[1]])
    cargs = [v if isinstance(v, int) else None if v is None
             else v.data_ptr() for v in raw]
    argtypes = ([_I] * 3 + [_P] * 4 + [_P, _P, _I, _P, _P, _I, _P, _P] * 2
                + [_P] * 7 + [_build.scalar(dt), _I, _I, _P])
    _build.entry(f"pslp_cp_dia_chunk_{_build.suffix(dt)}", argtypes)(
        *cargs, theta, int(nsteps), int(bool(with_sums)),
        _build.stream(_build.device_index(dev)))
    cp_dia_chunk.launches += 1
    out = (x, x3, ye, yi)
    return out + sums if with_sums else out


cp_dia_chunk.launches = 0


_clusters: dict = {}   # (device, dtype, cluster, threads, bytes) -> count


def _check_clusters(plan, dt, dev):
    """Before a plan's first launch: ``cudaOccupancyMaxActiveClusters``;
    raises when the card cannot hold one such cluster."""
    key = (dev, dt, plan.cluster, plan.threads, plan.smem_bytes)
    if key not in _clusters:
        out = ctypes.c_int(0)
        _build.entry(f"pslp_cp_dia_resident_prepare_{_build.suffix(dt)}",
                     [_I, _I, _I, _P])(
            plan.cluster, plan.threads, plan.smem_bytes, ctypes.byref(out))
        _clusters[key] = out.value
    if _clusters[key] < 1:
        raise RuntimeError(
            f"H-CPDIA-R: the card holds no cluster of {plan.cluster} CTAs "
            f"with {plan.smem_bytes} bytes of shared memory each")


def cp_dia_resident_chunk(prob, pre, x, y_eq, y, nsteps, theta,
                          with_sums=False, plan=None):
    """H-CPDIA-R: the chunk of :func:`cp_dia_chunk` in one launch of one
    cluster (``plan``: a resident :func:`cp_dia_plan`, by default this
    problem's).  The outputs are new tensors the kernel writes whole; the
    offsets travel in the kernel's parameters, from the host tuples."""
    if x.device.type == "cpu":
        return cp_dia_chunk_reference(prob, pre, x, y_eq, y, nsteps, theta,
                                      with_sums)
    if plan is None:
        plan = cp_dia_plan(prob, x.dtype)
    if plan.tier != "resident":
        raise ValueError(f"H-CPDIA-R needs a resident plan, got {plan.tier}")
    ae, ai = prob.a_eq, prob.a_ineq
    dt, dev = x.dtype, x.device
    m = prob.m_ineq if ai is not None else 0
    me = prob.m_eq if ae is not None else 0
    ye_in = y_eq if ae is not None else _empty(x)
    yi_in = y if ai is not None else _empty(x)
    args = [prob.c, pre["diag_t"], prob.lb, prob.ub, x, ye_in, yi_in]
    if ai is not None:
        args += [ai.vals_t, ai.vals, prob.b_upper, pre["sigma_ineq"]]
    if ae is not None:
        args += [ae.vals_t, ae.vals, prob.b_eq, pre["sigma_eq"]]
    _build.check_cuda(*args, dtype=dt, device=dev)
    if max(prob.n, m, me) != plan.positions:
        raise ValueError("the plan was made for another problem")
    _check_clusters(plan, dt, dev)
    out = [torch.empty_like(x), torch.empty_like(x),
           torch.empty_like(ye_in), torch.empty_like(yi_in)]
    sums = ([torch.empty_like(v) for v in (x, ye_in, yi_in)] if with_sums
            else [None, None, None])

    def sys_args(op, b, sigma):
        if op is None:
            return [None, None, None, None]
        return [op.vals_t, op.vals, b, sigma]

    offsets = [o for op in (ai, ae) if op is not None
               for o in (*op.offsets_t, *op.offsets)]
    raw = ([prob.n, m, me,
            len(ai.offsets_t) if ai is not None else 0,
            len(ai.offsets) if ai is not None else 0,
            len(ae.offsets_t) if ae is not None else 0,
            len(ae.offsets) if ae is not None else 0, plan.width, plan.reach,
            (ctypes.c_int * max(len(offsets), 1))(*offsets),
            prob.c, pre["diag_t"], prob.lb, prob.ub]
           + sys_args(ai, prob.b_upper, pre.get("sigma_ineq"))
           + sys_args(ae, prob.b_eq, pre.get("sigma_eq"))
           + [x, yi_in, ye_in, out[0], out[1], out[3], out[2], sums[0],
              sums[2], sums[1]])
    cargs = [v.data_ptr() if torch.is_tensor(v) else v for v in raw]
    argtypes = ([_I] * 9 + [_P] * 23 + [_build.scalar(dt)] + [_I] * 5
                + [_P])
    _build.entry(f"pslp_cp_dia_resident_{_build.suffix(dt)}", argtypes)(
        *cargs, theta, int(nsteps), int(bool(with_sums)), plan.cluster,
        plan.threads, plan.smem_bytes,
        _build.stream(_build.device_index(dev)))
    cp_dia_resident_chunk.launches += 1
    return tuple(out) + tuple(sums) if with_sums else tuple(out)


cp_dia_resident_chunk.launches = 0


@dataclasses.dataclass(frozen=True)
class CpDiaShard:
    """One rank's slice of an anchor-aligned DIA problem for
    :func:`cp_dia_shard_step`.  Local index k holds global position ``g0 +
    k`` for k in ``[0, length)``.  ``interior`` ``(i0, i1)`` is the range
    the rank owns: its duals and running sums.  ``primal`` ``(p0, p1)`` is
    the interior widened by the reach of A's taps: the step computes x and
    x3 there, since the dual reads x3 there.  The caller keeps the halos
    fresh: x over ``primal`` and each y over the reach of Aᵀ's taps from it
    (``[0, length)`` at most).  ``n``, ``m``, ``me`` are the global sizes; a
    system absent from the problem has ``m`` (``me``) 0.  ``c``, ``lb``,
    ``ub``, ``b_ineq``, ``b_eq`` are the local slices, zero outside the
    matrix, and ``a_ineq`` / ``a_eq`` the local planes as a
    :class:`~pysparselp_tpu_torch.problem.DiaMatrix` of ``length`` rows
    and columns (``vals[d, k]`` is A's entry of global row ``g0 + k``)."""

    g0: int
    length: int
    primal: tuple
    interior: tuple
    n: int
    m: int
    me: int
    c: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    a_ineq: object
    b_ineq: torch.Tensor
    a_eq: object = None
    b_eq: torch.Tensor = None
    # the C entry with this shard's constant arguments bound (first launch)
    entry: object = dataclasses.field(default=None, init=False, repr=False,
                                      compare=False)

    def __post_init__(self):
        (p0, p1), (i0, i1) = self.primal, self.interior
        ops = [op for op in (self.a_ineq, self.a_eq) if op is not None]
        fwd = [o for op in ops for o in op.offsets]
        bwd = [o for op in ops for o in op.offsets_t]
        if not (0 <= p0 + min(bwd) and p1 + max(bwd) <= self.length
                and p0 <= i0 + min(fwd) and i1 + max(fwd) <= p1):
            raise ValueError(
                f"CpDiaShard: primal {self.primal} and interior "
                f"{self.interior} do not hold the taps' reach in "
                f"{self.length} positions")


# kernels one cp_dia_shard_step launches: the primal and the dual
SHARD_LAUNCHES = 2


def _local_taps(vals, offsets, v, g0, nv, lo, hi):
    """``Σ_k vals[k, lo:hi] · v[lo + o_k : hi + o_k]`` (local indices),
    a tap whose global position ``g0 + j + o_k`` lies outside ``[0, nv)``
    reading zero; H-CPDIA's ``dia_row_local`` order."""
    g = torch.arange(g0 + lo, g0 + hi, device=v.device)
    acc = torch.zeros(hi - lo, dtype=vals.dtype, device=vals.device)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    for k, o in enumerate(offsets):
        inside = (g + o >= 0) & (g + o < nv)
        acc = acc + vals[k, lo:hi] * torch.where(inside, v[lo + o:hi + o],
                                                 zero)
    return acc


def cp_dia_shard_step_reference(sh: CpDiaShard, pre, x, x3, y_eq, y, theta,
                                sums=None):
    """Plain twin of :func:`cp_dia_shard_step`, in the kernel's operation
    order; updates ``x``, ``x3``, ``y_eq``, ``y`` and ``sums`` in place."""
    (p0, p1), (i0, i1) = sh.primal, sh.interior
    ae, ai = sh.a_eq, sh.a_ineq
    g = torch.arange(sh.g0 + p0, sh.g0 + p1, device=x.device)
    keep = (g >= 0) & (g < sh.n)
    d = sh.c[p0:p1]
    if sh.me > 0:
        d = d + _local_taps(ae.vals_t, ae.offsets_t, y_eq, sh.g0, sh.me, p0,
                            p1)
    if sh.m > 0:
        d = d + _local_taps(ai.vals_t, ai.offsets_t, y, sh.g0, sh.m, p0, p1)
    xo = x[p0:p1]
    x2 = torch.clamp(xo - pre["diag_t"][p0:p1] * d, sh.lb[p0:p1],
                     sh.ub[p0:p1])
    x3_new = (1.0 + theta) * x2 - theta * xo
    x3[p0:p1] = torch.where(keep, x3_new, x3[p0:p1])
    x[p0:p1] = torch.where(keep, x2, xo)
    gi = torch.arange(sh.g0 + i0, sh.g0 + i1, device=x.device)
    sx, se, si = sums if sums is not None else (None, None, None)
    if sx is not None:
        kept = keep[i0 - p0:i1 - p0]
        sx[i0:i1] = torch.where(kept, sx[i0:i1] + x[i0:i1], sx[i0:i1])
    if sh.me > 0:
        r = _local_taps(ae.vals, ae.offsets, x3, sh.g0, sh.n, i0,
                        i1) - sh.b_eq[i0:i1]
        rows = (gi >= 0) & (gi < sh.me)
        y_eq[i0:i1] = torch.where(
            rows, y_eq[i0:i1] + pre["sigma_eq"][i0:i1] * r, y_eq[i0:i1])
        if se is not None:
            se[i0:i1] = torch.where(rows, se[i0:i1] + y_eq[i0:i1], se[i0:i1])
    if sh.m > 0:
        r = _local_taps(ai.vals, ai.offsets, x3, sh.g0, sh.n, i0,
                        i1) - sh.b_ineq[i0:i1]
        rows = (gi >= 0) & (gi < sh.m)
        y[i0:i1] = torch.where(
            rows, torch.clamp_min(y[i0:i1] + pre["sigma_ineq"][i0:i1] * r,
                                  0.0), y[i0:i1])
        if si is not None:
            si[i0:i1] = torch.where(rows, si[i0:i1] + y[i0:i1], si[i0:i1])


def _shard_entry(sh: CpDiaShard, dt):
    """The C shard entry with ``sh``'s constant arguments bound."""
    def sys_args(op, b):
        if op is None:
            return [None, None, 0, None, None, 0, None]
        return [op.vals_t, op.offs_t, len(op.offsets_t), op.vals, op.offs,
                len(op.offsets), b]

    (p0, p1), (i0, i1) = sh.primal, sh.interior
    head = ([sh.length, sh.g0, p0, p1, i0, i1, sh.n, sh.m, sh.me, sh.c,
             sh.lb, sh.ub] + sys_args(sh.a_ineq, sh.b_ineq)
            + sys_args(sh.a_eq, sh.b_eq))
    argtypes = ([_I] * 9 + [_P] * 3 + [_P, _P, _I, _P, _P, _I, _P] * 2
                + [_P] * 10 + [_build.scalar(dt), _P])
    return _build.Entry(f"pslp_cp_dia_shard_step_{_build.suffix(dt)}",
                        argtypes, *head)


def cp_dia_shard_stepper(sh: CpDiaShard, pre, x, x3, y_eq, y, theta,
                         sums=None):
    """:func:`cp_dia_shard_step` on these tensors, checked once: a callable
    whose every call runs one iteration in place (so repeated calls
    advance the state; a loop pays no per-iteration checks)."""
    if x.device.type == "cpu":
        return lambda: cp_dia_shard_step_reference(sh, pre, x, x3, y_eq, y,
                                                   theta, sums)
    if x.device.type != "cuda":
        raise ValueError(f"cp_dia_shard_step runs on CUDA or the CPU, not "
                         f"{x.device}")
    ye = y_eq if sh.me > 0 else None
    yi = y if sh.m > 0 else None
    sx, se, si = sums if sums is not None else (None, None, None)
    if sh.me == 0:
        se = None
    if sh.m == 0:
        si = None
    t, s, s_eq = (pre["diag_t"], pre.get("sigma_ineq") if sh.m else None,
                  pre.get("sigma_eq") if sh.me else None)
    state = [v for v in (x, x3, ye, yi, sx, se, si, t, s, s_eq)
             if v is not None]
    _build.check_cuda(*state, dtype=sh.c.dtype, device=sh.c.device)
    if any(v.shape != (sh.length,) for v in state):
        raise ValueError(f"cp_dia_shard_step: every vector must have "
                         f"{sh.length} entries")
    if sh.entry is None:
        _build.check_cuda(sh.c, sh.lb, sh.ub, sh.b_ineq, sh.b_eq,
                          dtype=sh.c.dtype, device=sh.c.device)
        object.__setattr__(sh, "entry", _shard_entry(sh, sh.c.dtype))
    ptrs = tuple(None if v is None else v.data_ptr()
                 for v in (t, s, s_eq, x, x3, yi, ye, sx, si, se))
    index = _build.device_index(x.device)

    def step():
        sh.entry(*ptrs, theta, _build.stream(index))
        cp_dia_shard_step.launches += SHARD_LAUNCHES

    # the launches read these tensors' memory by address: hold them
    step.tensors = state
    return step


def cp_dia_shard_step(sh: CpDiaShard, pre, x, x3, y_eq, y, theta,
                      sums=None):
    """One CP iteration on a rank's slice (H-CPDIA's shard entry, two
    launches), in place: x and x3 over ``sh.primal``, ``y_eq`` / ``y`` and
    the running ``sums`` ``(sx, s_eq, s_ineq)`` over ``sh.interior``.
    ``pre`` holds the local step vectors ``diag_t``, ``sigma_ineq`` and
    ``sigma_eq`` (for a present system).  Every tensor has ``sh.length``
    entries; an absent system's dual (and its sum) may be any tensor of
    the dtype.  CPU tensors run :func:`cp_dia_shard_step_reference`; CUDA
    tensors launch the kernel or raise (:func:`cp_dia_shard_stepper`
    checks once for a loop of iterations)."""
    cp_dia_shard_stepper(sh, pre, x, x3, y_eq, y, theta, sums)()


cp_dia_shard_step.launches = 0
