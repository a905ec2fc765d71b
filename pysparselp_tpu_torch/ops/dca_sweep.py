"""H-DCA: a dual coordinate ascent sweep over the constraint rows of one
system (kernel source: ``csrc/dca_sweep.cu``).

No ``pallas_call`` stands behind it: it computes what the JAX package's
compiled loops compute, ``_dca_sweep_eq`` / ``_dca_sweep_ineq``
(``pysparselp_tpu/solvers/dual_ascent.py:323`` and ``:342``, one
``fori_loop`` over every row in order) and one colour group of
``_dca_color_sweep`` (``:285``).  PyTorch has no device loop: written as
plain tensor operations a row step is some 20 launches, and a sweep of
Potts-300's 358,800 rows millions of them.

Each row ``i`` of the padded row view (:class:`EllRows`: width ``K`` = the
longest row, padding slots hold value 0 at column 0, as the JAX
``EllMatrix``) takes the exact coordinate step of
:func:`~pysparselp_tpu_torch.ops.linesearch.exact_dual_line_search` over
its ``K`` slots, with ``tie_t`` drawn from the key chain
(:mod:`~pysparselp_tpu_torch.utils.jax_prng`), guarded by ``active[i] &
isfinite``, projected to ``y >= 0`` for inequality rows, and adds the step
times the row into ``c̄``.

Row ``i + 1`` depends on row ``i`` only through a column they share, so
the sequential sweep runs on a level schedule (:class:`LevelSchedule`,
built once per row view): a row's level is one more than the highest level
of any earlier row that touches one of its columns (a padding slot touches
column 0).  Rows of one level are pairwise column-disjoint, and running
the levels in order, each level's rows at once, gives every row the c̄ the
sequential sweep gives it, and every column its updates in the same order:
the same bits (:func:`dca_sweep_levels_reference` shows it on the CPU).

* :func:`dca_sweep` runs the sequential sweep: three launches for the whole
  system (the key chain; the draws, with the rows staged in level order;
  the levels), the key split once per row, active or not, as in JAX; it
  returns ``(y, c̄, key)`` with the key after the last row.
* :func:`dca_color_sweep` runs the blocked sweep (H-DCA-C): every colour
  group (rows with pairwise disjoint columns) of a :class:`ColorPlan`, built
  once per system, in one launch, each group's ``(rows,)`` ties drawn from
  its own split of the key; it returns ``(y, c̄, key)``.
* :func:`dca_color_step` runs one colour group, or a slice of one:
  ``tie_offset`` starts its ties at that element of the group's draw (a
  mesh rank's slice: ``jax.random.uniform``'s element ``i`` hashes the
  counter ``(0, i)`` whatever the draw's size, so a slice of the group's
  draw is a draw from ``tie_offset``).

On CUDA tensors they launch the kernels (``launches`` counts them) or
raise; on CPU tensors they run :func:`dca_sweep_reference`,
:func:`dca_color_sweep_reference` and :func:`dca_color_step_reference`,
the JAX loop bodies in PyTorch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import numpy as np
import scipy.sparse
import torch

from ..utils.jax_prng import (split, threefry2x32, uniform, uniform_at_zero,
                               uniform_scalar)
from . import _build
from .linesearch import SCAN_BASE, exact_dual_line_search

# the longest row H-DCA takes (kMaxRow in csrc/dca_sweep.cu)
MAX_ROW = 1024
# the kernels one sequential sweep launches: the key chain, the draws (and
# staging) and the levels
SWEEP_LAUNCHES = 3
# the level kernel's shared memory (csrc/dca_sweep.cu): rows of up to
# SCAN_BASE slots take one thread each and need none; longer rows take one
# warp each, with a scratch of 7 K + 1 + kScanTmp entries, for up to 32
# warps; c̄ sits beside them where it fits a block's 232,448 bytes
# (kSmemLimit)
_SCAN_TMP, _SMEM_LIMIT, _MAX_WARPS = 128, 232448, 32

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
# vals, cols, b, active, y, c_bar, lb, ub, perm, level_ptr, n_levels, m, K,
# n, k1, k2, work, key_out, project, stream
_ARGTYPES_SWEEP = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                   _U, _U, _P, _P, _I, _P)
# vals, cols, b, active, y, c_bar, lb, ub, order, ptr, n_groups, n_rows,
# max_rows, keys, k1, k2, tie_offset, sv, sc, sl, su, sb, flips, epoch, K,
# project, stream
_ARGTYPES_COLOR = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                   _U, _U, _U, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P)


@dataclasses.dataclass(frozen=True)
class LevelSchedule:
    """The rows of a row view grouped by level: ``perm`` (int32, every row
    once, level by level, ascending within a level) and ``ptr`` (int32,
    ``levels + 1`` offsets into ``perm``), on the row view's device;
    ``seconds`` is the host time it took to build."""

    perm: torch.Tensor
    ptr: torch.Tensor
    levels: int
    seconds: float

    @staticmethod
    def from_cols(cols: np.ndarray, device) -> "LevelSchedule":
        """The schedule of the padded column table ``cols`` (m, K), built
        level by level (Kahn's order over the graph whose edges join each
        use of a column to its next use), vectorised over a level."""
        t0 = time.perf_counter()
        m, k = cols.shape
        flat = np.asarray(cols, np.int64).ravel()
        by_col = np.argsort(flat, kind="stable")
        col, row = flat[by_col], by_col // max(k, 1)
        # one use per (row, column): a row's padding slots are one use
        first = np.ones(col.size, bool)
        first[1:] = (col[1:] != col[:-1]) | (row[1:] != row[:-1])
        col, row = col[first], row[first]
        nxt = col[1:] == col[:-1]
        src, dst = row[:-1][nxt], row[1:][nxt]
        indeg = np.bincount(dst, minlength=m)
        succ = dst[np.argsort(src, kind="stable")]
        start = np.zeros(m + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=m), out=start[1:])
        level = np.flatnonzero(indeg == 0)
        groups = []
        while level.size:
            groups.append(level)
            lo, cnt = start[level], start[level + 1] - start[level]
            total = int(cnt.sum())
            if not total:
                break
            pos = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            reached, times = np.unique(succ[np.repeat(lo, cnt) + pos],
                                       return_counts=True)
            indeg[reached] -= times
            level = reached[indeg[reached] == 0]
        perm = np.concatenate(groups) if groups else np.zeros(0, np.int64)
        if perm.size != m:
            raise AssertionError("level schedule: not every row was placed")
        ptr = np.zeros(len(groups) + 1, np.int64)
        np.cumsum([g.size for g in groups], out=ptr[1:])
        return LevelSchedule(
            perm=torch.as_tensor(perm.astype(np.int32), device=device),
            ptr=torch.as_tensor(ptr.astype(np.int32), device=device),
            levels=len(groups), seconds=time.perf_counter() - t0)


@dataclasses.dataclass(frozen=True)
class EllRows:
    """The padded row view of a constraint matrix that the sweep walks:
    ``vals`` (m, K) and ``cols`` (m, K) int32, row ``i``'s entries first in
    column order, then zeros at column 0 (``EllMatrix.from_scipy``'s row
    form, width ``K`` = the longest row, at least 1), and its level
    schedule."""

    vals: torch.Tensor
    cols: torch.Tensor
    ncols: int
    schedule: LevelSchedule

    @staticmethod
    def from_tables(vals, cols, ncols, dtype, device) -> "EllRows":
        """The row view of the padded tables ``vals`` / ``cols`` (numpy),
        with its level schedule."""
        cols = np.array(cols, np.int32)
        return EllRows(
            vals=torch.as_tensor(np.array(vals), dtype=dtype, device=device),
            cols=torch.as_tensor(cols, device=device), ncols=int(ncols),
            schedule=LevelSchedule.from_cols(cols, device))

    @staticmethod
    def from_scipy(a, dtype, device) -> "EllRows":
        csr = scipy.sparse.csr_matrix(a)
        m, n = csr.shape
        cnt = np.diff(csr.indptr)
        k = max(int(cnt.max()) if cnt.size else 0, 1)
        vals = np.zeros((m, k))
        cols = np.zeros((m, k), np.int32)
        if csr.nnz:
            row_of = np.repeat(np.arange(m), cnt)
            pos = np.arange(csr.nnz) - csr.indptr[row_of]
            vals[row_of, pos] = csr.data
            cols[row_of, pos] = csr.indices
        return EllRows.from_tables(vals, cols, n, dtype, device)


@dataclasses.dataclass(frozen=True)
class ColorPlan:
    """The colour groups of one system as H-DCA-C runs them, built once
    (:meth:`build`): ``order`` (int32, every row once, group by group, each
    group in its given order), ``ptr`` (int32, ``len(groups) + 1`` offsets
    into ``order``), ``groups`` (each group's rows, views of ``order``),
    ``max_rows`` (the largest group).  For rows of up to ``SCAN_BASE``
    slots, ``staged``: the rows' static data in that order, slot-major
    (slot ``j`` of position ``q`` at ``[j, q]``): ``vals``, ``cols`` and
    ``lb`` / ``ub`` at the columns, each ``(K, m)``, and ``b`` ``(m,)``;
    None for longer rows, which the kernel reads in place.  Only ``active``,
    ``y`` and ``c̄`` change from sweep to sweep, so nothing is staged per
    sweep.  ``seconds`` is the build's host time."""

    order: torch.Tensor
    ptr: torch.Tensor
    groups: tuple
    max_rows: int
    staged: dict | None
    seconds: float

    @staticmethod
    def build(ell: "EllRows", groups, b, lb, ub) -> "ColorPlan":
        """The plan of ``groups`` (row-id arrays that together hold every
        row of ``ell`` once), staged from ``b``, ``lb`` and ``ub``: the
        sweep must be given these same vectors."""
        t0 = time.perf_counter()
        dev = ell.vals.device
        m, k = ell.vals.shape
        sizes = [len(g) for g in groups]
        order = (np.concatenate([np.asarray(g, np.int64) for g in groups])
                 if groups else np.zeros(0, np.int64))
        if not np.array_equal(np.sort(order), np.arange(m)):
            raise ValueError("ColorPlan: the groups must hold every row once")
        ptr = np.zeros(len(groups) + 1, np.int64)
        np.cumsum(sizes, out=ptr[1:])
        order_t = torch.as_tensor(order.astype(np.int32), device=dev)
        staged = None
        if k <= SCAN_BASE:
            rows = order_t.long()
            cols = ell.cols[rows].T.contiguous()
            at = cols.long()
            staged = dict(vals=ell.vals[rows].T.contiguous(), cols=cols,
                          lb=lb[at], ub=ub[at], b=b[rows])
        return ColorPlan(
            order=order_t,
            ptr=torch.as_tensor(ptr.astype(np.int32), device=dev),
            groups=tuple(order_t[lo:hi] for lo, hi in zip(ptr, ptr[1:])),
            max_rows=max(sizes, default=0), staged=staged,
            seconds=time.perf_counter() - t0)


def color_plan_bytes(plan: ColorPlan) -> int:
    """The device bytes a plan holds (its order, offsets and staged
    rows)."""
    tensors = [plan.order, plan.ptr, *(plan.staged or {}).values()]
    return sum(t.numel() * t.element_size() for t in tensors)


def sweep_work_bytes(m, width, itemsize) -> int:
    """The bytes of a sequential sweep's workspace (``Work`` in
    csrc/dca_sweep.cu): each row's key (two uint32) and draw, and for rows
    of up to ``SCAN_BASE`` slots the rows staged in level order (values and
    the bounds at the columns as ``itemsize``, int32 columns, b, active)."""
    nbytes = m * (8 + itemsize)
    if width <= SCAN_BASE:
        nbytes += m * width * (3 * itemsize + 4) + m * (itemsize + 1)
    return nbytes


def cbar_in_smem(width, n, itemsize) -> bool:
    """Whether the sequential sweep keeps c̄ (``n`` entries) in shared
    memory: beside nothing for rows of up to ``SCAN_BASE`` slots (a thread
    a row), beside the warps' scratch for wider rows (a warp a row)."""
    if width <= SCAN_BASE:
        return n * itemsize <= _SMEM_LIMIT
    per_warp = (7 * width + 1 + _SCAN_TMP) * itemsize
    warps = min(_MAX_WARPS, _SMEM_LIMIT // per_warp)
    return warps * per_warp + n * itemsize <= _SMEM_LIMIT


def _row_step(vals, cols, b_i, active_i, y_i, c_bar, lb, ub, tie_t, project):
    """One row's (or a batch of rows') step: ``(y_new, diff)``."""
    alpha = exact_dual_line_search(vals, b_i, c_bar[cols], ub[cols],
                                   lb[cols], tie_t)
    alpha = torch.where(active_i & torch.isfinite(alpha), alpha, 0.0)
    if project:
        # jnp.maximum(s, 0.0) as XLA computes it: -0 gives +0, NaN stays
        s = y_i + alpha
        y_new = torch.where(s <= 0, 0.0, s)
        return y_new, y_new - y_i
    return y_i + alpha, alpha


def dca_sweep_reference(ell, b, active, y, c_bar, lb, ub, key, project):
    """Plain twin of :func:`dca_sweep`: the rows in order, one split of the
    key and one draw per row, ``c̄`` updated slot by slot (padding slots
    add 0 at column 0, as the JAX scatter does)."""
    y, c_bar = y.clone(), c_bar.clone()
    cols = ell.cols.long()
    for i in range(ell.vals.shape[0]):
        key, sub = split(key)
        t = uniform_scalar(sub, c_bar.dtype)
        y_new, diff = _row_step(ell.vals[i], cols[i], b[i], active[i], y[i],
                                c_bar, lb, ub, t, project)
        y[i] = y_new
        c_bar.index_add_(0, cols[i], diff * ell.vals[i])
    return y, c_bar, key


def _row_draws(keys, dtype, device):
    """Each row's tie draw ``uniform(sub_i)``, ``sub_i`` the second half of
    ``split(keys[i])``, hashed for all rows at once."""
    k = torch.tensor(keys, dtype=torch.int64, device=device).reshape(-1, 2)
    zero = torch.zeros_like(k[:, 0])
    sub = threefry2x32((k[:, 0], k[:, 1]), zero, zero + 1)
    return uniform_at_zero(sub, dtype)


def dca_sweep_levels_reference(ell, b, active, y, c_bar, lb, ub, key,
                               project):
    """The sequential sweep on the level schedule, as the kernel runs it:
    the key chain's draws first (one per row, in row order), then each
    level's rows as one batch of row steps, their c̄ updates added row by
    row, slot by slot.  Equal to :func:`dca_sweep_reference` bit for
    bit."""
    y, c_bar = y.clone(), c_bar.clone()
    keys = []
    for _ in range(ell.vals.shape[0]):
        keys.append(key)
        key = threefry2x32(key, 0, 0)
    tie = _row_draws(keys, c_bar.dtype, c_bar.device)
    sched = ell.schedule
    perm, ptr = sched.perm.long(), sched.ptr.tolist()
    for lo, hi in zip(ptr, ptr[1:]):
        rows = perm[lo:hi]
        v, cl = ell.vals[rows], ell.cols[rows].long()
        y_new, diff = _row_step(v, cl, b[rows], active[rows], y[rows], c_bar,
                                lb, ub, tie[rows], project)
        y[rows] = y_new
        c_bar.index_add_(0, cl.reshape(-1), (diff[:, None] * v).reshape(-1))
    return y, c_bar, key


def dca_color_step_reference(ell, b, active, y, c_bar, lb, ub, rows, sub,
                             project, tie_offset=0):
    """Plain twin of :func:`dca_color_step`: the group's rows searched as
    one batch, their ties ``uniform(sub, (tie_offset + rows,))[tie_offset:]``."""
    rows = rows.long()
    tie = uniform(sub, rows.shape, c_bar.dtype, c_bar.device,
                  offset=tie_offset)
    v, cl = ell.vals[rows], ell.cols[rows].long()
    y_new, diff = _row_step(v, cl, b[rows], active[rows], y[rows], c_bar, lb,
                            ub, tie, project)
    y, c_bar = y.clone(), c_bar.clone()
    y[rows] = y_new
    c_bar.index_add_(0, cl.reshape(-1), (diff[:, None] * v).reshape(-1))
    return y, c_bar


def dca_color_sweep_reference(ell, plan, b, active, y, c_bar, lb, ub, key,
                              project):
    """Plain twin of :func:`dca_color_sweep`: per group of ``plan``, one
    split of the key and :func:`dca_color_step_reference`."""
    for rows in plan.groups:
        key, sub = split(key)
        y, c_bar = dca_color_step_reference(ell, b, active, y, c_bar, lb, ub,
                                            rows, sub, project)
    return y, c_bar, key


def _check(ell, tensors, what):
    if ell.vals.shape[1] > MAX_ROW:
        raise ValueError(
            f"{what}: a row of {ell.vals.shape[1]} slots is past H-DCA's "
            f"limit of {MAX_ROW} (MAX_ROW)")
    dev, dtype = ell.vals.device, ell.vals.dtype
    for t in tensors:
        if t.device != dev or not t.is_contiguous() or (
                t.is_floating_point() and t.dtype != dtype):
            raise ValueError(f"{what}: every tensor must be a contiguous "
                             f"{dtype} (or int/bool) tensor on {dev}")


def dca_sweep(ell: EllRows, b, active, y, c_bar, lb, ub, key, project):
    """The sequential sweep over every row of ``ell``: returns new ``(y,
    c̄, key)`` (the inputs are not modified).  ``active`` is a bool tensor
    per row, ``key`` the port's key pair, ``project`` clamps ``y >= 0``.
    On the card: the key chain (one thread), the draws with the rows
    staged in level order (a grid) and the levels (one block),
    ``SWEEP_LAUNCHES`` launches on the current stream."""
    dev = ell.vals.device
    if dev.type == "cpu":
        return dca_sweep_reference(ell, b, active, y, c_bar, lb, ub, key,
                                   project)
    if dev.type != "cuda":
        raise ValueError(f"dca_sweep runs on CUDA or the CPU, not {dev}")
    m, k = ell.vals.shape
    n = c_bar.shape[0]
    sched = ell.schedule
    active = active.to(torch.uint8)
    _check(ell, (ell.cols, b, active, y, c_bar, lb, ub, sched.perm,
                 sched.ptr), "dca_sweep")
    y, c_bar = y.clone(), c_bar.clone()
    key_out = torch.empty(2, dtype=torch.int64, device=dev)
    if m:
        work = torch.empty(sweep_work_bytes(m, k, ell.vals.element_size()),
                           dtype=torch.uint8, device=dev)
        fn = _build.entry(f"pslp_dca_sweep_{_build.suffix(ell.vals.dtype)}",
                          _ARGTYPES_SWEEP)
        fn(ell.vals.data_ptr(), ell.cols.data_ptr(), b.data_ptr(),
           active.data_ptr(), y.data_ptr(), c_bar.data_ptr(), lb.data_ptr(),
           ub.data_ptr(), sched.perm.data_ptr(), sched.ptr.data_ptr(),
           sched.levels, m, k, n, key[0], key[1], work.data_ptr(),
           key_out.data_ptr(), int(project),
           _build.stream(_build.device_index(dev)))
        dca_sweep.launches += SWEEP_LAUNCHES
        k1, k2 = key_out.tolist()
        key = (k1, k2)
    return y, c_bar, key


dca_sweep.launches = 0


def _color_launch(ell, b, active, y, c_bar, lb, ub, project, order, ptr,
                  n_groups, max_rows, keys, key, tie_offset, staged, what):
    """One launch of H-DCA-C on ``order``'s rows: returns new ``(y, c̄)``.
    ``ptr`` None runs them as one group; ``keys`` (int32 pairs, one a
    group) None draws from ``key``; ``staged`` None reads the rows in
    place."""
    dev = ell.vals.device
    k = ell.vals.shape[1]
    if active.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"{what}: active must be bool or uint8")
    _check(ell, (ell.cols, b, active, y, c_bar, lb, ub, order), what)
    y, c_bar = y.clone(), c_bar.clone()
    flips, epoch = _flip_words(dev, n_groups)
    st = staged or {}
    ptrs = [st[name].data_ptr() if st else None
            for name in ("vals", "cols", "lb", "ub", "b")]
    fn = _build.entry(f"pslp_dca_color_sweep_{_build.suffix(ell.vals.dtype)}",
                      _ARGTYPES_COLOR)
    fn(ell.vals.data_ptr(), ell.cols.data_ptr(), b.data_ptr(),
       active.data_ptr(), y.data_ptr(), c_bar.data_ptr(), lb.data_ptr(),
       ub.data_ptr(), order.data_ptr(),
       None if ptr is None else ptr.data_ptr(), n_groups, order.numel(),
       max_rows, None if keys is None else keys.data_ptr(), key[0], key[1],
       int(tie_offset), *ptrs, flips.data_ptr(), epoch, k, int(project),
       _build.stream(_build.device_index(dev)))
    return y, c_bar


_FLIPS: dict = {}


def _flip_words(dev, n_groups):
    """The kernel's column-0 words (one a group, ``csrc/dca_sweep.cu``
    ``col0_update``) on ``dev`` and this launch's epoch: a word is set when
    it holds the epoch, so the words are never cleared (zeroed once when
    they grow; the epoch counts launches on the device's stream order)."""
    words, epoch = _FLIPS.get(dev, (None, 0))
    if words is None or words.numel() < n_groups:
        words = torch.zeros(max(n_groups, 64), dtype=torch.int32, device=dev)
        epoch = 0
    epoch = epoch % 0x7FFFFFFF + 1
    _FLIPS[dev] = (words, epoch)
    return words, epoch


def dca_color_sweep(ell: EllRows, plan: ColorPlan, b, active, y, c_bar, lb,
                    ub, key, project):
    """The blocked sweep over ``plan``'s colour groups: returns new ``(y,
    c̄, key)`` (the inputs are not modified), each group's ties drawn from
    its own split of ``key``.  ``b``, ``lb`` and ``ub`` are the vectors the
    plan was built from.  On the card: ONE launch of H-DCA-C for every
    group, a cooperative grid with a grid barrier between groups; a launch
    the card refuses raises."""
    dev = ell.vals.device
    if dev.type == "cpu":
        return dca_color_sweep_reference(ell, plan, b, active, y, c_bar, lb,
                                         ub, key, project)
    if dev.type != "cuda":
        raise ValueError(f"dca_color_sweep runs on CUDA or the CPU, not {dev}")
    subs = []
    for _ in plan.groups:
        key, sub = split(key)
        subs.append(sub)
    if plan.max_rows:
        keys = torch.as_tensor(np.asarray(subs, np.uint32).view(np.int32),
                               device=dev)
        y, c_bar = _color_launch(ell, b, active, y, c_bar, lb, ub, project,
                                 plan.order, plan.ptr, len(plan.groups),
                                 plan.max_rows, keys, (0, 0), 0, plan.staged,
                                 "dca_color_sweep")
        dca_color_sweep.launches += 1
    else:
        y, c_bar = y.clone(), c_bar.clone()
    return y, c_bar, key


dca_color_sweep.launches = 0


def dca_color_step(ell: EllRows, b, active, y, c_bar, lb, ub, rows, sub,
                   project, tie_offset=0):
    """One colour group ``rows`` (int32, pairwise disjoint columns) of the
    blocked sweep, its ties drawn from the sub key ``sub`` starting at
    element ``tie_offset``: returns new ``(y, c̄)``.  On the card: H-DCA-C
    on this one group, its rows read in place."""
    dev = ell.vals.device
    if dev.type == "cpu":
        return dca_color_step_reference(ell, b, active, y, c_bar, lb, ub,
                                        rows, sub, project, tie_offset)
    if dev.type != "cuda":
        raise ValueError(f"dca_color_step runs on CUDA or the CPU, not {dev}")
    rows = rows.to(torch.int32)
    if not rows.numel():
        return y.clone(), c_bar.clone()
    y, c_bar = _color_launch(ell, b, active, y, c_bar, lb, ub, project, rows,
                             None, 1, rows.numel(), None, sub, tie_offset,
                             None, "dca_color_step")
    dca_color_step.launches += 1
    return y, c_bar


dca_color_step.launches = 0
