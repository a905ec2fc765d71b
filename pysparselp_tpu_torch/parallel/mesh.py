"""A 1-D device mesh over a ``torch.distributed`` process group (mirrors
``pysparselp_tpu/parallel/mesh.py``).

The JAX package's mesh is a ``jax.sharding.Mesh`` over the devices of one
process, and ``shard_map`` runs one program body per device.  Here each rank
is a process that holds one shard: :class:`Mesh` names the group, this
rank's place in it and its device, and supplies the collectives the sharded
solvers use: :meth:`Mesh.psum`, :meth:`Mesh.pmax` and :meth:`Mesh.pmin`
(``dist.all_reduce`` with SUM, MAX and MIN), :meth:`Mesh.all_gather`
(``dist.all_gather``, the JAX ``all_gather(..., tiled=True)``) and
:meth:`Mesh.halo_exchange`, the neighbour exchange of the position-sharded
solver (JAX's two ``lax.ppermute`` per array), every array's edges packed
into one ``dist.all_gather``; :class:`HaloRoute` is the same exchange
with its buffers and placement built once, for the solver's iterations.

The backend is always the caller's choice; nothing here switches one for
another.  NCCL takes one GPU per rank.  Several ranks on one GPU need
``backend="gloo"``, which reduces CUDA tensors through host memory.  Every
collective reduces a contiguous 1-D view of a copy of its input, so a 0-d
tensor travels as one element on either backend and no backend needs its
own staging (gloo's SUM and MAX of 0-d and 1-D CUDA tensors are tested on
the card: ``tests/test_torch_sharded.py``).

:func:`spawn` starts one process per rank (the tests, ``chip_smoke.py``).
:func:`pad_gather_width` is the JAX package's, verbatim: the host helper
that pads per-shard gather tables to one width for ``shard_map``'s uniform
shards.  The port's ranks are processes, each holding its own tables, so
its sharded layouts do not need it.
"""

from __future__ import annotations

import collections
import os
import queue as _queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..problem import resolve_device

# after a rank fails, how long spawn waits for the other ranks' reports
FAILURE_GRACE_S = 5.0


class Mesh:
    """One rank's view of a 1-D mesh over ``group`` (``None``: the default
    group), computing on ``device``.

    ``calls`` counts the collectives this rank issued, keyed by
    ``(op, numel)`` (``("sum", n)`` is the iteration's n-vector psum,
    ``("gather", k)`` an all-gather of ``k`` entries a rank, ``("halo",
    k)`` a halo exchange that sends ``k`` entries a rank)."""

    def __init__(self, device="cuda", group=None, axis_name="rows"):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialized torch.distributed "
                               "process group (dist.init_process_group)")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.axis_name = axis_name
        self.calls = collections.Counter()

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r}, device={self.device})")

    def _all_reduce(self, t, op, name):
        out = t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out.view(-1), op=op, group=self.group)
        self.calls[(name, out.numel())] += 1
        return out

    def psum(self, t):
        """The sum of ``t`` over the ranks (a new tensor)."""
        return self._all_reduce(t, dist.ReduceOp.SUM, "sum")

    def pmax(self, t):
        """The elementwise maximum of ``t`` over the ranks (a new tensor)."""
        return self._all_reduce(t, dist.ReduceOp.MAX, "max")

    def pmin(self, t):
        """The elementwise minimum of ``t`` over the ranks (a new tensor)."""
        return self._all_reduce(t, dist.ReduceOp.MIN, "min")

    def all_gather(self, t):
        """Every rank's ``t`` (at least 1-D, one shape on every rank),
        concatenated along the first axis in rank order: ``(size *
        t.shape[0], ...)``."""
        src = t.detach().clone(memory_format=torch.contiguous_format)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        self.calls[("gather", src.numel())] += 1
        return torch.cat(parts)

    def halo_exchange(self, items):
        """Refresh halos in place, the counterpart of JAX's
        ``sharded_cp_windowed._halo_refresh``.  ``items`` holds ``(t, lo,
        hi, left, right)``: a 1-D tensor whose rank-owned range is ``[lo,
        hi)``; ``t[lo - left:lo]`` receives rank - 1's ``t[hi - left:hi]``
        and ``t[hi:hi + right]`` rank + 1's ``t[lo:lo + right]`` (the ranks
        agree on the widths).  Every item's edges travel in one all-gather
        (:func:`halo_pack`), counted as ``("halo", k)``.  The halo a mesh
        edge faces has no neighbour and is left as it is: its positions lie
        outside the problem, where the callers' arrays hold zeros, the
        global layout's neutral padding (JAX's ``ppermute`` delivers zeros
        there).  One rank issues no collective."""
        if self.size == 1:
            return
        packet = halo_pack(items)
        parts = [torch.empty_like(packet) for _ in range(self.size)]
        dist.all_gather(parts, packet, group=self.group)
        self.calls[("halo", packet.numel())] += 1
        last = self.size - 1
        halo_unpack(items, parts[self.rank - 1] if self.rank > 0 else None,
                    parts[self.rank + 1] if self.rank < last else None)


def halo_pack(items, out=None):
    """One rank's packet for :meth:`Mesh.halo_exchange`: each item's
    right edge ``t[hi - left:hi]`` (rank + 1's left halo), then each
    item's left edge ``t[lo:lo + right]`` (rank - 1's right halo); into
    ``out`` where given."""
    return torch.cat([t[hi - left:hi] for t, _lo, hi, left, _r in items]
                     + [t[lo:lo + right] for t, lo, _hi, _l, right in items],
                     out=out)


def halo_unpack(items, from_prev, from_next):
    """Write the halos of ``items`` from the packets (:func:`halo_pack`)
    of rank - 1 (``from_prev``) and rank + 1 (``from_next``); ``None``
    leaves that side as it is."""
    k = 0
    for t, lo, _hi, left, _right in items:
        if from_prev is not None:
            t[lo - left:lo] = from_prev[k:k + left]
        k += left
    for t, _lo, hi, _left, right in items:
        if from_next is not None:
            t[hi:hi + right] = from_next[k:k + right]
        k += right


class HaloRoute:
    """:meth:`Mesh.halo_exchange` of a fixed set of items, its buffers and
    placement built once: a call is one all-gather of :attr:`packet` into
    :attr:`recv` and ONE ``index_copy_`` that writes rank - 1's right edges
    and rank + 1's left edges into the halos.  The items' arrays are
    copied into views of one flat buffer (:attr:`views`, in the order of
    ``arrays``; the buffer's tail takes the received entries no halo
    needs), and the caller refreshes :attr:`packet` (:func:`halo_pack`'s
    layout) before each call: :meth:`pack` from the views, or a kernel
    that writes it as it updates them (H-CPDIA's shard entry).  ``items``
    are ``(t, lo, hi, left, right)`` with ``t`` one of ``arrays``.  Each
    placement adds one to ``HaloRoute.launches``."""

    launches = 0

    def __init__(self, mesh, arrays, items):
        self.mesh = mesh
        rank, size = mesh.rank, mesh.size
        k = sum(left + right for _t, _lo, _hi, left, right in items)
        starts = np.cumsum([0] + [a.numel() for a in arrays])
        where = {id(a): int(at) for a, at in zip(arrays, starts)}
        # rank - 1's packet to rank + 1's, the part of recv a rank reads
        first, last = max(rank - 1, 0), min(rank + 1, size - 1)
        region = (last + 1 - first) * k
        dst = np.arange(starts[-1], starts[-1] + region)
        split, left_at, right_at = sum(it[3] for it in items), 0, 0
        for t, lo, hi, left, right in items:
            at = where[id(t)]
            if rank > 0:
                q = (rank - 1 - first) * k + left_at
                dst[q:q + left] = at + np.arange(lo - left, lo)
            if rank < size - 1:
                q = (rank + 1 - first) * k + split + right_at
                dst[q:q + right] = at + np.arange(hi, hi + right)
            left_at, right_at = left_at + left, right_at + right
        ref = arrays[0]
        self.flat = ref.new_empty(int(starts[-1]) + region)
        self.views = [self.flat[int(a):int(b)]
                      for a, b in zip(starts[:-1], starts[1:])]
        for view, a in zip(self.views, arrays):
            view.copy_(a)
        self.items = [(self.views[[id(a) for a in arrays].index(id(t))], lo,
                       hi, left, right) for t, lo, hi, left, right in items]
        self.index = torch.as_tensor(dst, device=ref.device)
        self.src = slice(first * k, first * k + region)
        self.packet = ref.new_empty(k)
        self.recv = ref.new_empty(size * k)
        self.parts = list(self.recv.view(size, k).unbind(0))

    def pack(self):
        """:attr:`packet` from the views (one launch)."""
        halo_pack(self.items, out=self.packet)

    def __call__(self):
        """Every rank's packet into :attr:`recv` (one all-gather), then
        :meth:`place`."""
        mesh = self.mesh
        if mesh.backend == "nccl":
            dist.all_gather_into_tensor(self.recv, self.packet,
                                        group=mesh.group)
        else:
            dist.all_gather(self.parts, self.packet, group=mesh.group)
        mesh.calls[("halo", self.packet.numel())] += 1
        self.place()

    def place(self):
        """The neighbours' edges from :attr:`recv` (rank r's packet at
        ``[r k, (r + 1) k)``) into the halos: one ``index_copy_``."""
        self.flat.index_copy_(0, self.index, self.recv[self.src])
        HaloRoute.launches += 1


def pad_gather_width(mats_v, mats_i, k_max=None):
    """Stack per-shard (rows, K_i, ...) value/index pairs after padding
    every K_i to a common gather width (zero values, index 0) — shard_map
    requires shape-uniform shards.  Shared by the sharded ADMM tile
    builder and the sharded-IPM ELL builder."""
    if k_max is None:
        k_max = max(v.shape[1] for v in mats_v)
    out_v, out_i = [], []
    for v, i in zip(mats_v, mats_i):
        pad = k_max - v.shape[1]
        if pad:
            v = np.concatenate(
                [v, np.zeros((v.shape[0], pad) + v.shape[2:], v.dtype)], 1)
            i = np.concatenate(
                [i, np.zeros((i.shape[0], pad), i.dtype)], 1)
        out_v.append(v)
        out_i.append(i)
    return np.stack(out_v), np.stack(out_i)


def default_mesh(device="cuda", group=None, axis_name="rows") -> Mesh:
    """A :class:`Mesh` over the initialized default group (or ``group``).
    Raises when no group is initialized, or when ``device`` is CUDA and
    this machine has none: it never moves to the CPU by itself."""
    return Mesh(device=device, group=group, axis_name=axis_name)


def check_mesh(mesh) -> Mesh:
    """``mesh`` if it is a :class:`Mesh`, else a ``TypeError``."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh={mesh!r}: expected a pysparselp_tpu_torch.parallel.mesh."
            "Mesh (see default_mesh and spawn), not "
            f"{type(mesh).__module__}.{type(mesh).__qualname__}")
    return mesh


def _run_rank(fn, rank, world_size, backend, device, init_method, results,
              args):
    """One rank: join the group, run ``fn(mesh, *args)``, report, leave.
    The report goes out before the group is left, so a failing rank's
    traceback is queued before the errors its departure raises on the
    others."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            resolve_device(dev)
            if dev.index is None:
                dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
        out = fn(Mesh(device=dev), *args)
        report = (rank, True, out if rank == 0 else None)
    except Exception:  # noqa: BLE001 - reported to the parent
        report = (rank, False, traceback.format_exc())
    results.put(report)
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn, world_size, backend, device, *args, timeout=1800.0):
    """Run ``fn(mesh, *args)`` on ``world_size`` new processes and return
    rank 0's result.

    Processes start with the ``spawn`` method and meet through a
    ``file://`` rendezvous in a fresh temporary directory (no TCP port, so
    concurrent callers never collide).  ``backend`` is passed to
    ``dist.init_process_group`` as given.  ``device="cuda"`` puts rank
    ``r`` on GPU ``r % torch.cuda.device_count()``.  ``fn`` and ``args``
    must pickle, and ``fn`` must live in a module that does not import
    jax.  When a rank raises, the others have ``FAILURE_GRACE_S`` seconds
    to report (a rank's failure makes its peers' collectives fail too),
    then they are stopped and a ``RuntimeError`` carries every reported
    traceback, the first one first."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="pslp_mesh_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_run_rank, daemon=True,
                             args=(fn, rank, world_size, backend, str(device),
                                   init, results, args))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        grace = None        # set at the first failure: the others' reports
        out, done, failed = None, set(), {}
        try:
            while len(done) < world_size:
                if time.monotonic() > (deadline if grace is None else grace):
                    break
                try:
                    rank, ok, value = results.get(timeout=0.2)
                except _queue.Empty:
                    for r, p in enumerate(procs):
                        if r not in done and p.exitcode not in (None, 0):
                            done.add(r)
                            failed[r] = (f"rank {r} exited with code "
                                         f"{p.exitcode} and no result")
                else:
                    done.add(rank)
                    if not ok:
                        failed[rank] = f"rank {rank} raised:\n{value}"
                    elif rank == 0:
                        out = value
                if failed and grace is None:
                    grace = time.monotonic() + FAILURE_GRACE_S
            if len(done) < world_size and not failed:
                failed[None] = f"no result within {timeout:.0f} s"
        finally:
            for p in procs:
                if failed and p.is_alive():
                    p.terminate()
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
        if failed:
            raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}, "
                               f"world_size={world_size}, backend={backend!r}"
                               "): " + "\n".join(failed.values()))
    return out
