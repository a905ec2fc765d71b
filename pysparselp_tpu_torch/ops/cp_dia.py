"""H-CPDIA: ``nsteps`` whole Chambolle-Pock iterations on DIA operators,
equality and inequality systems alike, in three tiers chosen from the
shapes by :func:`cp_dia_plan`:

* ``"resident"`` (H-CPDIA-R, ``csrc/cp_dia_resident.cu``): one launch per
  chunk, the whole state held in the shared memory of one thread-block
  cluster; replaces ``pysparselp_tpu/ops/cp_fused.py::_cp_fused_call`` (K2)
  at its shapes, small aligned grids such as Potts-50;
* ``"grid"`` (H-CPDIA-G, ``csrc/cp_dia_grid.cu``): one cooperative launch
  per chunk on a persistent grid, a CTA an SM, each CTA's slab of every
  plane held in its shared memory for the chunk, x3 and y exchanged
  through L2 between two grid barriers an iteration; replaces
  ``pysparselp_tpu/ops/cp_windowed.py::build_windowed_call`` (K3) where a
  slab's planes fit (Potts-100, and Potts-300 and the multi-label grids in
  float32 on bfloat16 planes);
* ``"two_launch"`` (``csrc/cp_dia.cu``): two launches per iteration, for
  everything else (K3's other shapes: Potts-300 in float64, Potts-500 and
  up).

The planes are read as the operator stores them (bfloat16 for a float32
solve whose values are exact in it, ``problem.DiaMatrix``), widened
exactly to the solve dtype: every tier computes bit for bit what it
computes on the float32 planes.

All have the call contract of ``cp_windowed._cp_windowed_call_full``:
``(x, x3, y_eq, y[, sum_x, sum_y_eq, sum_y])``.  :func:`cp_dia_chunk`
launches the planned tier for CUDA tensors and runs
:func:`cp_dia_chunk_reference`, its plain PyTorch twin, for CPU tensors.
Inputs are never modified.

The position-sharded mesh solver (``parallel/sharded_cp_windowed.py``,
where JAX runs K3 per shard) runs one iteration a call on one rank's
:class:`CpDiaShard`, a halo-padded slice of the position space, updating
the rank's state in place: :func:`cp_dia_shard_step`, H-CPDIA's
iteration in one cooperative launch a call, planes read in place
(``csrc/cp_dia_grid.cu``; :func:`shard_plan` sizes its grid), which also
writes the rank's outgoing halo packet; the two-launch shard entry
(``csrc/cp_dia.cu``, ``two_launch=True``) stays as its reference;
:func:`cp_dia_shard_step_reference` is their twin.  On every rank count
each equals :func:`cp_dia_chunk` on the whole system bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from .dia_spmv import dia_spmv_reference, widen

_P, _I = ctypes.c_void_p, ctypes.c_int

# H-CPDIA-R's limits on Hopper: the dynamic shared memory one block may
# take (227 KB), the cluster sizes (16 is non-portable) and the block size
SMEM_PER_CTA = 232_448
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MAX_THREADS = 1024
MAX_DIAG = 32   # diagonals a tap set may have (csrc: kMaxDiag)
# H-CPDIA-G's grid: a CTA an SM of the H100 SXM (the plan of a problem on
# a card takes the card's own count), at least GRID_MIN_WIDTH positions a
# CTA
GRID_SMS = 132
GRID_MIN_WIDTH = 32
# H-CPDIA-G's static shared memory (its table of vector slabs), beside the
# dynamic shared memory grid_smem_bytes counts
GRID_STATIC_SMEM = 128
# the vectors H-CPDIA-G keeps a slab of in shared memory where they fit,
# in this order (csrc/cp_dia_grid.cu's kVector order): the ones it reads
# and writes every iteration first, then the constants
GRID_VECTORS = ("x", "sx", "sy", "sye", "c", "t", "lb", "ub", "b", "s",
                "be", "se")


def cp_dia_eligible(prob) -> bool:
    """Every present constraint system is a DiaMatrix."""
    from ..problem import DiaMatrix

    ops = [op for op in (prob.a_eq, prob.a_ineq) if op is not None]
    return bool(ops) and all(isinstance(op, DiaMatrix) for op in ops)


@dataclasses.dataclass(frozen=True)
class CpDiaPlan:
    """How :func:`cp_dia_chunk` runs a DIA problem: ``tier`` is
    ``"resident"``, ``"grid"`` or ``"two_launch"``.  For the resident tier,
    ``cluster`` CTAs (C) of ``threads`` threads, CTA r owning positions
    ``[slabs[r], slabs[r + 1])`` of ``[0, positions)`` (``width`` = W each
    but the last), ``smem_bytes`` of shared memory per CTA, ``reach``, the
    largest |offset| of any tap (at most W: a tap reads its own slab or a
    neighbour's; the halo each slab holds of x3 and y).  For the grid tier
    (:func:`grid_plan`) the same ``width``, ``slabs``, ``threads``,
    ``smem_bytes`` and ``positions`` over ``ctas`` CTAs; ``halos`` ``(left,
    right)`` of x3 (A's taps) and of y and y_e (Aᵀ's); ``vectors``, the
    names of :data:`GRID_VECTORS` whose slab stays in shared memory.  For
    the shard entry (``"shard"``, :func:`shard_plan`), ``ctas`` CTAs of
    ``threads`` threads, each owning ``width`` of the slice's
    ``positions`` widened positions."""

    tier: str
    cluster: int = 0
    width: int = 0
    slabs: tuple = ()
    smem_bytes: int = 0
    reach: int = 0
    threads: int = 0
    positions: int = 0
    ctas: int = 0
    halos: tuple = ()
    vectors: tuple = ()


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
    tuples (A_i^T, A_i, A_e^T, A_e), the item size of ``dtype`` and that
    of the planes as stored."""
    ae, ai = prob.a_eq, prob.a_ineq
    offsets = (tuple(ai.offsets_t) if ai is not None else (),
               tuple(ai.offsets) if ai is not None else (),
               tuple(ae.offsets_t) if ae is not None else (),
               tuple(ae.offsets) if ae is not None else ())
    m = prob.m_ineq if ai is not None else 0
    me = prob.m_eq if ae is not None else 0
    return (prob.n, m, me, offsets, torch.finfo(dtype).bits // 8,
            _plane_itemsize(prob, dtype))


def _plane_itemsize(prob, dtype):
    """The item size of the planes as a launch reads them: as stored, or
    ``dtype``'s where the systems store theirs in different dtypes (read
    in the solve dtype once :func:`~..problem.one_plane_storage` has
    re-stored them)."""
    kinds = {op.vals.dtype for op in (prob.a_ineq, prob.a_eq)
             if op is not None}
    return torch.finfo(kinds.pop() if len(kinds) == 1 else dtype).bits // 8


def _planes(prob):
    """``(vt, v, vte, ve)``: the planes of A_iᵀ, A_i, A_eᵀ, A_e as stored
    (None where a system is absent).  A launch takes them in one storage
    dtype (``_build.check_planes``; the lowering gives one,
    :func:`~..problem.one_plane_storage`)."""
    ai, ae = prob.a_ineq, prob.a_eq
    return (ai.vals_t if ai is not None else None,
            ai.vals if ai is not None else None,
            ae.vals_t if ae is not None else None,
            ae.vals if ae is not None else None)


def _halo(offsets):
    """``(left, right)`` reach of a set of taps: the entries a slab's
    taps read before its first position and past its last."""
    return max([0] + [-o for o in offsets]), max([0, *offsets])


def grid_smem_bytes(width, halos, ndiags, m, me, itemsize, plane_itemsize,
                    vectors=()):
    """Shared memory of one H-CPDIA-G CTA (the layout of
    ``csrc/cp_dia_grid.cu``): the slab of every plane as stored (rounded
    up to 16 bytes), x3 with A's halos, y and y_e (each present system)
    with Aᵀ's, then a slab of each of ``vectors``."""
    (hlx, hrx), (hly, hry) = halos
    planes = -(-plane_itemsize * width * sum(ndiags) // 16) * 16
    ext = (width + hlx + hrx) + (width + hly + hry) * (
        (m > 0) + (me > 0))
    return planes + itemsize * (ext + width * len(vectors))


def _grid_width(positions, sms, ctas=None):
    """``(ctas, width, threads)`` of a CTA-an-SM grid over ``positions``:
    at most one CTA an SM and at least ``GRID_MIN_WIDTH`` positions a CTA
    (unless ``ctas`` is given), ``width`` positions each, ``threads`` the
    width rounded up to a warp, at most ``MAX_THREADS``."""
    if ctas is None:
        ctas = max(1, min(sms, positions // GRID_MIN_WIDTH))
    width = -(-positions // ctas)
    return ctas, width, min(MAX_THREADS, -(-width // 32) * 32)


@functools.lru_cache(maxsize=64)
def _grid(n, m, me, offsets, itemsize, plane_itemsize, sms, ctas=None):
    """H-CPDIA-G's plan (:func:`grid_plan`), or None."""
    positions = max(n, m, me)
    ndiags = tuple(map(len, offsets))
    if max(ndiags) > MAX_DIAG or positions == 0:
        return None
    ctas, width, threads = _grid_width(positions, sms, ctas)
    halos = (_halo(offsets[1] + offsets[3]), _halo(offsets[0] + offsets[2]))
    budget = SMEM_PER_CTA - GRID_STATIC_SMEM
    smem = grid_smem_bytes(width, halos, ndiags, m, me, itemsize,
                           plane_itemsize)
    if smem > budget:
        return None
    present = {"sy": m > 0, "b": m > 0, "s": m > 0, "sye": me > 0,
               "be": me > 0, "se": me > 0}
    vectors = []
    for name in GRID_VECTORS:
        if present.get(name, True) and smem + itemsize * width <= budget:
            vectors.append(name)
            smem += itemsize * width
    slabs = tuple(min(r * width, positions) for r in range(ctas + 1))
    return CpDiaPlan("grid", width=width, slabs=slabs, smem_bytes=smem,
                     threads=threads, positions=positions, ctas=ctas,
                     halos=halos, vectors=tuple(vectors))


@functools.lru_cache(maxsize=64)
def _plan(n, m, me, offsets, itemsize, plane_itemsize=None, cluster=None,
          sms=GRID_SMS):
    """:func:`cp_dia_plan` on the shapes of :func:`_shape`; ``cluster``
    forces the resident tier at one cluster size, or the two-launch tier
    where that does not fit (the tests and the probe's sweep)."""
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
    if cluster is None:
        grid = _grid(n, m, me, offsets, itemsize, plane_itemsize or itemsize,
                     sms)
        if grid is not None:
            return grid
    return TWO_LAUNCH


def _sms(prob):
    """The SM count the grid tier plans with: the card's, for a problem on
    one, else the H100 SXM's."""
    dev = prob.c.device
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return GRID_SMS


def cp_dia_plan(prob, dtype):
    """The tier of a DIA problem, from its shapes alone (the card's
    counterpart of JAX's ``fused_vmem_bytes`` / ``FUSED_VMEM_BUDGET`` rule,
    in shared-memory terms), with at most ``MAX_DIAG`` diagonals a tap
    set: ``"resident"`` at the largest cluster size C (the fastest at every
    size measured, PERF.md) whose slab of ``ceil(positions / C)``
    positions, with its halos, fits one CTA's shared memory and is at
    least as wide as the farthest tap; else ``"grid"`` where a slab of
    every plane as stored and of x3 and y with their halos fits one CTA
    of a CTA-an-SM grid (:func:`grid_plan`); else ``"two_launch"``."""
    return _plan(*_shape(prob, dtype), sms=_sms(prob))


def grid_plan(prob, dtype, ctas=None):
    """H-CPDIA-G's plan for a problem, or None where a slab does not fit.
    CTA r of ``ctas`` (default: one an SM, ``_sms``, with at least
    ``GRID_MIN_WIDTH`` positions each) owns positions ``[r W, (r + 1) W)``
    (W = ``ceil(positions / ctas)``) for the whole chunk.

    Where it all lives, per CTA (``threads`` = W rounded up to a warp, at
    most 1,024, so at most 64 registers a thread; ``csrc/cp_dia_grid.cu``):

    * shared memory: the slab of every plane (A_iᵀ, A_i, A_eᵀ, A_e) as
      stored, staged once a chunk; x3 with A's halo and y, y_e with Aᵀ's
      (``halos``: the taps' reach, which may span several slabs), the slab
      written by this CTA and the halos read from L2 after each grid
      barrier; then the slabs of as many of ``GRID_VECTORS`` as fit
      (``vectors``), in that order;
    * device memory (L2-resident): x3 and y, written by their owner each
      iteration, read as halos by the others; every vector left out of
      ``vectors``, read (and x and the sums written) in place each
      iteration;
    * registers: one position's arithmetic at a time."""
    shape = _shape(prob, dtype)
    return _grid(*shape, _sms(prob), ctas)


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


def _check(prob, pre, x, y_eq, y):
    """The chunk's tensors on x's device: the vectors in x's dtype, the
    planes (:func:`_planes`) in one storage dtype the kernels take with it;
    returns the planes, that dtype's C entry suffix and ``(m, me)``."""
    ae, ai = prob.a_eq, prob.a_ineq
    dt, dev = x.dtype, x.device
    vecs = [prob.c, pre["diag_t"], prob.lb, prob.ub, x]
    offs = [op.offs for op in (ai, ae) if op is not None] + [
        op.offs_t for op in (ai, ae) if op is not None]
    if ai is not None:
        vecs += [y, prob.b_upper, pre["sigma_ineq"]]
    if ae is not None:
        vecs += [y_eq, prob.b_eq, pre["sigma_eq"]]
    _build.check_cuda(*vecs, *offs, dtype=dt, device=dev)
    planes = _planes(prob)
    sfx = _build.plane_suffix(dt, _build.check_planes(*planes, dtype=dt,
                                                       device=dev))
    m = prob.m_ineq if ai is not None else 0
    me = prob.m_eq if ae is not None else 0
    return planes, sfx, m, me


def cp_dia_chunk(prob, pre, x, y_eq, y, nsteps, theta, with_sums=False,
                 plan=None):
    """Run ``nsteps`` CP iterations; returns ``(x, x3, y_eq, y[, sx, se,
    sy])`` (the eq outputs are empty when ``prob.a_eq`` is None).  On CUDA
    the tier of ``plan`` (default: :func:`cp_dia_plan`) runs; its
    resident tier counts in :func:`cp_dia_resident_chunk`'s ``launches``,
    its grid tier in :func:`cp_dia_grid_chunk`'s, the two-launch tier in
    this function's."""
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
    if plan.tier == "grid":
        return cp_dia_grid_chunk(prob, pre, x, y_eq, y, nsteps, theta,
                                 with_sums, plan)
    ae, ai = prob.a_eq, prob.a_ineq
    dt, dev = x.dtype, x.device
    (vt, v, vte, ve), sfx, m, me = _check(prob, pre, x, y_eq, y)
    x = x.clone()
    x3 = x.clone()
    ye = y_eq.clone() if ae is not None else _empty(x)
    yi = y.clone() if ai is not None else _empty(x)
    sums = (tuple(torch.zeros_like(v) for v in (x, ye, yi)) if with_sums
            else (None, None, None))

    def sys_args(op, vt, v, b, sigma):
        if op is None:
            return [None, None, 0, None, None, 0, None, None]
        return [vt, op.offs_t, len(op.offsets_t), v, op.offs,
                len(op.offsets), b, sigma]

    a_in = sys_args(ai, vt, v, prob.b_upper, pre.get("sigma_ineq"))
    a_eq = sys_args(ae, vte, ve, prob.b_eq, pre.get("sigma_eq"))
    vec = [prob.c, pre["diag_t"], prob.lb, prob.ub]
    raw = ([prob.n, m, me] + vec + a_in + a_eq
           + [x, x3, yi, ye, sums[0], sums[2], sums[1]])
    cargs = [v if isinstance(v, int) else None if v is None
             else v.data_ptr() for v in raw]
    argtypes = ([_I] * 3 + [_P] * 4 + [_P, _P, _I, _P, _P, _I, _P, _P] * 2
                + [_P] * 7 + [_build.scalar(dt), _I, _I, _P])
    _build.entry(f"pslp_cp_dia_chunk_{sfx}", argtypes)(
        *cargs, theta, int(nsteps), int(bool(with_sums)),
        _build.stream(_build.device_index(dev)))
    cp_dia_chunk.launches += 1
    out = (x, x3, ye, yi)
    return out + sums if with_sums else out


cp_dia_chunk.launches = 0


_clusters: dict = {}   # (device, entry, cluster, threads, bytes) -> count


def _check_clusters(plan, sfx, dev):
    """Before a plan's first launch: ``cudaOccupancyMaxActiveClusters``;
    raises when the card cannot hold one such cluster."""
    key = (dev, sfx, plan.cluster, plan.threads, plan.smem_bytes)
    if key not in _clusters:
        out = ctypes.c_int(0)
        _build.entry(f"pslp_cp_dia_resident_prepare_{sfx}",
                     [_I, _I, _I, _P])(
            plan.cluster, plan.threads, plan.smem_bytes, ctypes.byref(out))
        _clusters[key] = out.value
    if _clusters[key] < 1:
        raise RuntimeError(
            f"H-CPDIA-R: the card holds no cluster of {plan.cluster} CTAs "
            f"with {plan.smem_bytes} bytes of shared memory each")


def _counts(prob):
    """The diagonal counts of A_iᵀ, A_i, A_eᵀ, A_e (0 where absent) and
    the offsets of those present, in that order, as one ctypes array."""
    taps = [(op.offsets_t, op.offsets) if op is not None else ((), ())
            for op in (prob.a_ineq, prob.a_eq)]
    counts = [len(offs) for pair in taps for offs in pair]
    offsets = [o for pair in taps for offs in pair for o in offs]
    return counts, (ctypes.c_int * max(len(offsets), 1))(*offsets)


def cp_dia_resident_chunk(prob, pre, x, y_eq, y, nsteps, theta,
                          with_sums=False, plan=None):
    """H-CPDIA-R: the chunk of :func:`cp_dia_chunk` in one launch of one
    cluster (``plan``: a resident :func:`cp_dia_plan`, by default this
    problem's).  The outputs are new tensors the kernel writes whole; the
    offsets travel in the kernel's parameters, from the host tuples.  The
    planes are widened to the solve dtype as they are staged (the layout
    of :func:`resident_smem_bytes` holds them so)."""
    if x.device.type == "cpu":
        return cp_dia_chunk_reference(prob, pre, x, y_eq, y, nsteps, theta,
                                      with_sums)
    if plan is None:
        plan = cp_dia_plan(prob, x.dtype)
    if plan.tier != "resident":
        raise ValueError(f"H-CPDIA-R needs a resident plan, got {plan.tier}")
    ae, ai = prob.a_eq, prob.a_ineq
    dt, dev = x.dtype, x.device
    ye_in = y_eq if ae is not None else _empty(x)
    yi_in = y if ai is not None else _empty(x)
    (vt, v, vte, ve), sfx, m, me = _check(prob, pre, x, ye_in, yi_in)
    if max(prob.n, m, me) != plan.positions:
        raise ValueError("the plan was made for another problem")
    _check_clusters(plan, sfx, dev)
    out = [torch.empty_like(x), torch.empty_like(x),
           torch.empty_like(ye_in), torch.empty_like(yi_in)]
    sums = ([torch.empty_like(v) for v in (x, ye_in, yi_in)] if with_sums
            else [None, None, None])

    def sys_args(op, vt, v, b, sigma):
        if op is None:
            return [None, None, None, None]
        return [vt, v, b, sigma]

    counts, offsets = _counts(prob)
    raw = ([prob.n, m, me, *counts, plan.width, plan.reach, offsets,
            prob.c, pre["diag_t"], prob.lb, prob.ub]
           + sys_args(ai, vt, v, prob.b_upper, pre.get("sigma_ineq"))
           + sys_args(ae, vte, ve, prob.b_eq, pre.get("sigma_eq"))
           + [x, yi_in, ye_in, out[0], out[1], out[3], out[2], sums[0],
              sums[2], sums[1]])
    cargs = [v.data_ptr() if torch.is_tensor(v) else v for v in raw]
    argtypes = ([_I] * 9 + [_P] * 23 + [_build.scalar(dt)] + [_I] * 5
                + [_P])
    _build.entry(f"pslp_cp_dia_resident_{sfx}", argtypes)(
        *cargs, theta, int(nsteps), int(bool(with_sums)), plan.cluster,
        plan.threads, plan.smem_bytes,
        _build.stream(_build.device_index(dev)))
    cp_dia_resident_chunk.launches += 1
    return tuple(out) + tuple(sums) if with_sums else tuple(out)


cp_dia_resident_chunk.launches = 0


_grids: dict = {}   # (device, kind, suffix, threads, bytes) -> CTAs


def _check_grid(plan, kind, sfx, dev, smem=True):
    """Before a plan's first cooperative launch, once a plan: the C entry
    ``pslp_{kind}_prepare_{sfx}`` (the kernel's dynamic shared memory
    allowed, its occupancy read); raises when the card cannot hold
    ``plan.ctas`` CTAs at once."""
    key = (dev, kind, sfx, plan.threads, plan.smem_bytes)
    if key not in _grids:
        out = ctypes.c_int(0)
        args = [plan.threads, plan.smem_bytes] if smem else [plan.threads]
        _build.entry(f"pslp_{kind}_prepare_{sfx}", [_I] * len(args) + [_P])(
            *args, ctypes.byref(out))
        _grids[key] = out.value
    if _grids[key] < plan.ctas:
        raise RuntimeError(
            f"pslp_{kind}_{sfx}: the card holds {_grids[key]} CTAs of "
            f"{plan.threads} threads and {plan.smem_bytes} bytes of shared "
            f"memory at once, the plan {plan.ctas}")


def cp_dia_grid_chunk(prob, pre, x, y_eq, y, nsteps, theta, with_sums=False,
                      plan=None):
    """H-CPDIA-G: the chunk of :func:`cp_dia_chunk` in one cooperative
    launch of ``plan.ctas`` CTAs (``plan``: a :func:`grid_plan`, by default
    this problem's :func:`cp_dia_plan`).  The outputs are new tensors the kernel writes
    whole.  A launch the card refuses (fewer resident CTAs than the
    plan's) raises; nothing falls back to another tier."""
    if x.device.type == "cpu":
        return cp_dia_chunk_reference(prob, pre, x, y_eq, y, nsteps, theta,
                                      with_sums)
    if plan is None:
        plan = cp_dia_plan(prob, x.dtype)
    if plan.tier != "grid":
        raise ValueError(f"H-CPDIA-G needs a grid plan, got {plan.tier}")
    ae, ai = prob.a_eq, prob.a_ineq
    dt, dev = x.dtype, x.device
    ye_in = y_eq if ae is not None else _empty(x)
    yi_in = y if ai is not None else _empty(x)
    (vt, v, vte, ve), sfx, m, me = _check(prob, pre, x, ye_in, yi_in)
    if max(prob.n, m, me) != plan.positions:
        raise ValueError("the plan was made for another problem")
    out = [torch.empty_like(x), torch.empty_like(x),
           torch.empty_like(ye_in), torch.empty_like(yi_in)]
    sums = ([torch.empty_like(v) for v in (x, ye_in, yi_in)] if with_sums
            else [None, None, None])
    _check_grid(plan, "cp_dia_grid", sfx, dev)
    counts, offsets = _counts(prob)
    in_smem = sum(1 << GRID_VECTORS.index(name) for name in plan.vectors)
    (hlx, hrx), (hly, hry) = plan.halos
    raw = ([prob.n, m, me, *counts, plan.width, hlx, hrx, hly, hry, in_smem,
            offsets, prob.c, pre["diag_t"], prob.lb, prob.ub, prob.b_upper,
            pre.get("sigma_ineq"), prob.b_eq, pre.get("sigma_eq"), vt, v, vte,
            ve, x, yi_in, ye_in, out[0], out[1], out[3], out[2], sums[0],
            sums[2], sums[1]])
    cargs = [v.data_ptr() if torch.is_tensor(v) else v for v in raw]
    argtypes = ([_I] * 13 + [_P] * 23 + [_build.scalar(dt)] + [_I] * 5
                + [_P])
    _build.entry(f"pslp_cp_dia_grid_{sfx}", argtypes)(
        *cargs, theta, int(nsteps), int(bool(with_sums)), plan.ctas,
        plan.threads, plan.smem_bytes,
        _build.stream(_build.device_index(dev)))
    cp_dia_grid_chunk.launches += 1
    return tuple(out) + tuple(sums) if with_sums else tuple(out)


cp_dia_grid_chunk.launches = 0


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
    # the C entries with this shard's constant arguments bound (first
    # launch): the two-launch entry, and the one-launch entry with its plan
    entry: object = dataclasses.field(default=None, init=False, repr=False,
                                      compare=False)
    grid: object = dataclasses.field(default=None, init=False, repr=False,
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

    @property
    def packet_edges(self):
        """``((xl, xr), (yl, yr))``: the rank's edges in its outgoing halo
        packet (``parallel/mesh.py::halo_pack`` of x with A's reach, then y
        and y_eq with the slice's halos): x's last ``xl`` and first ``xr``
        interior entries, each y's last ``yl`` and first ``yr``."""
        (p0, p1), (i0, i1) = self.primal, self.interior
        return (i0 - p0, p1 - i1), (i0, self.length - i1)

    @property
    def packet_size(self):
        (xl, xr), (yl, yr) = self.packet_edges
        return xl + xr + (yl + yr) * (2 if self.me > 0 else 1)


# kernels one cp_dia_shard_step launches (the two-launch reference: 2)
SHARD_LAUNCHES = 1


def shard_plan(sh: CpDiaShard, sms=None):
    """The shard entry's grid (``"shard"``, planes in place): CTA r of
    ``ctas`` (one an SM at most, at least ``GRID_MIN_WIDTH`` positions
    each) owns ``width`` positions of the widened range ``sh.primal``, of
    ``threads`` threads (the width rounded up to a warp, at most 1,024):
    the grid is sized to the shard, not to the card."""
    positions = sh.primal[1] - sh.primal[0]
    ctas, width, threads = _grid_width(positions, sms or _sms(sh))
    return CpDiaPlan("shard", width=width, threads=threads,
                     positions=positions, ctas=ctas)


def _local_taps(vals, offsets, v, g0, nv, lo, hi):
    """``Σ_k vals[k, lo:hi] · v[lo + o_k : hi + o_k]`` (local indices),
    a tap whose global position ``g0 + j + o_k`` lies outside ``[0, nv)``
    reading zero; H-CPDIA's ``dia_row_local`` order (bfloat16 planes
    widened exactly)."""
    g = torch.arange(g0 + lo, g0 + hi, device=v.device)
    vals = widen(vals)
    acc = torch.zeros(hi - lo, dtype=vals.dtype, device=vals.device)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    for k, o in enumerate(offsets):
        inside = (g + o >= 0) & (g + o < nv)
        acc = acc + vals[k, lo:hi] * torch.where(inside, v[lo + o:hi + o],
                                                 zero)
    return acc


def shard_packet(sh: CpDiaShard, x, y_eq, y):
    """The rank's outgoing halo packet of its state: ``parallel/mesh.py::
    halo_pack`` of the items x, y and, where present, y_eq, with the
    widths of :attr:`CpDiaShard.packet_edges`."""
    from ..parallel.mesh import halo_pack

    (xl, xr), (yl, yr) = sh.packet_edges
    i0, i1 = sh.interior
    ys = (y, y_eq) if sh.me > 0 else (y,)
    return halo_pack([(x, i0, i1, xl, xr)]
                     + [(t, i0, i1, yl, yr) for t in ys])


def cp_dia_shard_step_reference(sh: CpDiaShard, pre, x, x3, y_eq, y, theta,
                                sums=None, packet=None):
    """Plain twin of :func:`cp_dia_shard_step`, in the kernel's operation
    order; updates ``x``, ``x3``, ``y_eq``, ``y``, ``sums`` and ``packet``
    (:func:`shard_packet` of the new state) in place."""
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
    if packet is not None:
        packet.copy_(shard_packet(sh, x, y_eq, y))


def _sys_args(op, planes, b):
    """A system's C arguments, or the absent system's."""
    if op is None:
        return [None, None, 0, None, None, 0, None]
    vt, v = planes
    return [vt, op.offs_t, len(op.offsets_t), v, op.offs, len(op.offsets), b]


def _shard_entry(sh: CpDiaShard, dt):
    """The two-launch C shard entry with ``sh``'s constant arguments
    bound."""
    vt, v, vte, ve = _planes(sh)
    sfx = _build.plane_suffix(dt, _build.check_planes(
        vt, v, vte, ve, dtype=dt, device=sh.c.device))
    (p0, p1), (i0, i1) = sh.primal, sh.interior
    head = ([sh.length, sh.g0, p0, p1, i0, i1, sh.n, sh.m, sh.me, sh.c,
             sh.lb, sh.ub] + _sys_args(sh.a_ineq, (vt, v), sh.b_ineq)
            + _sys_args(sh.a_eq, (vte, ve), sh.b_eq))
    argtypes = ([_I] * 9 + [_P] * 3 + [_P, _P, _I, _P, _P, _I, _P] * 2
                + [_P] * 10 + [_build.scalar(dt), _P])
    return _build.Entry(f"pslp_cp_dia_shard_step_{sfx}", argtypes, *head)


def _shard_grid_entry(sh: CpDiaShard, dt):
    """``(plan, entry, offsets)``: the one-launch shard entry's plan
    (:func:`shard_plan`, checked against the card once) and its C entry
    with ``sh``'s constant arguments bound (``offsets``: the host table
    the entry copies into the kernel's parameters, held with it)."""
    vt, v, vte, ve = _planes(sh)
    sfx = _build.plane_suffix(dt, _build.check_planes(
        vt, v, vte, ve, dtype=dt, device=sh.c.device))
    plan = shard_plan(sh)
    _check_grid(plan, "cp_dia_shard_grid", sfx, sh.c.device, smem=False)
    counts, offsets = _counts(sh)
    offsets = torch.tensor(list(offsets), dtype=torch.int32)
    (p0, p1), (i0, i1) = sh.primal, sh.interior
    (xl, xr), (yl, yr) = sh.packet_edges
    head = [sh.length, sh.g0, p0, p1, i0, i1, sh.n, sh.m, sh.me, *counts,
            plan.width, xl, xr, yl, yr, offsets, sh.c, sh.lb, sh.ub,
            sh.b_ineq, sh.b_eq, vt, v, vte, ve]
    argtypes = ([_I] * 18 + [_P] * 10 + [_P] * 3 + [_P] * 8
                + [_build.scalar(dt), _I, _I, _P])
    return (plan, _build.Entry(f"pslp_cp_dia_shard_grid_{sfx}", argtypes,
                               *head), offsets)


def cp_dia_shard_stepper(sh: CpDiaShard, pre, x, x3, y_eq, y, theta,
                         sums=None, packet=None, two_launch=False):
    """:func:`cp_dia_shard_step` on these tensors, checked once: a callable
    whose every call runs one iteration in place (so repeated calls
    advance the state; a loop pays no per-iteration checks)."""
    if x.device.type == "cpu":
        return lambda: cp_dia_shard_step_reference(sh, pre, x, x3, y_eq, y,
                                                   theta, sums, packet)
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
    if packet is not None:
        _build.check_cuda(packet, dtype=sh.c.dtype, device=sh.c.device)
        if two_launch or packet.shape != (sh.packet_size,):
            raise ValueError(f"cp_dia_shard_step: a packet of "
                             f"{sh.packet_size} entries, one-launch entry "
                             f"only")
        state.append(packet)
    _build.check_cuda(sh.c, sh.lb, sh.ub, sh.b_ineq, sh.b_eq,
                      dtype=sh.c.dtype, device=sh.c.device)
    index = _build.device_index(x.device)
    if two_launch:
        if sh.entry is None:
            object.__setattr__(sh, "entry", _shard_entry(sh, sh.c.dtype))
        entry, launches = sh.entry, 2
        tail = tuple(None if v is None else v.data_ptr()
                     for v in (t, s, s_eq, x, x3, yi, ye, sx, si, se))
        tail += (theta,)
    else:
        if sh.grid is None:
            object.__setattr__(sh, "grid", _shard_grid_entry(sh, sh.c.dtype))
        plan, entry, _offsets = sh.grid
        launches = SHARD_LAUNCHES
        tail = tuple(None if v is None else v.data_ptr()
                     for v in (t, s, s_eq, x, x3, yi, ye, sx, si, se,
                               packet))
        tail += (theta, plan.ctas, plan.threads)

    def step():
        entry(*tail, _build.stream(index))
        cp_dia_shard_step.launches += launches

    # the launches read these tensors' memory by address: hold them
    step.tensors = state
    return step


def cp_dia_shard_step(sh: CpDiaShard, pre, x, x3, y_eq, y, theta,
                      sums=None, packet=None, two_launch=False):
    """One CP iteration on a rank's slice, in place: x and x3 over
    ``sh.primal``, ``y_eq`` / ``y`` and the running ``sums`` ``(sx, s_eq,
    s_ineq)`` over ``sh.interior``, and ``packet`` (``sh.packet_size``
    entries, or None) set to the rank's outgoing halo packet
    (:func:`shard_packet`).  ``pre`` holds the local step vectors
    ``diag_t``, ``sigma_ineq`` and ``sigma_eq`` (for a present system).
    Every tensor has ``sh.length`` entries; an absent system's dual (and
    its sum) may be any tensor of the dtype.  CPU tensors run
    :func:`cp_dia_shard_step_reference`; CUDA tensors launch H-CPDIA-G's
    shard entry (one cooperative launch; ``two_launch``: the two-launch
    entry, the tests' reference, which writes no packet) or raise
    (:func:`cp_dia_shard_stepper` checks once for a loop of iterations).
    ``launches`` counts the kernels launched."""
    cp_dia_shard_stepper(sh, pre, x, x3, y_eq, y, theta, sums, packet,
                         two_launch)()


cp_dia_shard_step.launches = 0
