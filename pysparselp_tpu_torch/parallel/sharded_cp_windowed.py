"""Position-sharded CP over a :class:`~.mesh.Mesh`: stencil domain
decomposition (mirrors ``pysparselp_tpu/parallel/sharded_cp_windowed.py``).

The row-sharded path (:mod:`.sharded_cp`) keeps the primal replicated and
pays one n-vector all-reduce an iteration.  An anchor-aligned DIA system
has a 1-D position space with a local stencil, so it shards like a
stencil computation instead:

* rank r owns the contiguous positions ``[r·W, (r + 1)·W)`` of the ``P =
  max(n, m, m_eq)`` positions (``W = ceil(P / ranks)``) and holds them
  with a halo on each side, in one local layout for every vector and
  plane (:class:`~pysparselp_tpu_torch.ops.cp_dia.CpDiaShard`);
* each iteration refreshes the halos of x, y and y_eq from the two
  neighbours (:class:`~.mesh.HaloRoute`: one collective and one launch
  that places the halos, none on one rank), then runs one iteration of
  H-CPDIA's shard entry
  (:func:`~pysparselp_tpu_torch.ops.cp_dia.cp_dia_shard_step`, one
  cooperative launch, which also writes the next exchange's packet), where
  JAX runs its windowed kernel (K3) per shard;
* the halos are wide enough for the primal to be recomputed over the
  dual's reach (JAX's ``h = hq + gq``): x over the reach of A's taps, y
  over that plus the reach of Aᵀ's, so one exchange an iteration serves
  both passes and the result equals the one-device two-launch chunk bit
  for bit;
* the ranks at the mesh edges face positions outside the problem, which
  hold zeros, the global layout's neutral padding.

Primal and duals are fully sharded: an iteration moves O(halo) entries
instead of an n-vector.  The restart controller
(:func:`sharded_windowed_chunk_restart`) and the checkpoint metrics
(:func:`sharded_windowed_metrics`) run on each rank's interior with H-DIA
(:func:`_interior_matvec`) and reduce scalars only.

Not ported, because they answer the TPU: the window layout's 128-lane rows
and pad windows, its VMEM budgets and per-window tiled planes (a rank
holds contiguous position ranges), ``dispatch_iteration_cap`` and the
``lru_cache``d ``shard_map`` closures (a chunk's iterations run from the
host loop).  The checkpoints always reduce their metrics on the mesh; x is
gathered only where the callback or ``force_integer`` reads it (JAX's
non-light checkpoints evaluate the one-device metrics on the gathered
state: the same quantities in another reduction order).
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse
import torch

from ..ops.cp_dia import CpDiaShard, cp_dia_shard_stepper
from ..ops.dia_spmv import DiaOperand, dia_apply
from ..problem import (DIA_AUTO_MAX_OFFSETS, DiaMatrix, _diagonal_count,
                       dia_plane_dtype, one_plane_storage)
from .mesh import HaloRoute, check_mesh

# what the last run_position_sharded call on this process ran: the regime,
# the ranks, the positions per rank, the halo widths, the build's host
# seconds
last_run_info = None

# test hook, the counterpart of JAX's ``cp_windowed._FORCE_INTERPRET``:
# the plan's gate passes on the CPU too (it passes on CUDA always)
_FORCE_CPU = False


def _is_float32(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    return dtype is not None and np.dtype(dtype) == np.float32


def _host_dia(csr):
    """Host planes of a scipy matrix: ``offsets``/``vals`` (``(ndiag,
    m)``) and ``offsets_t``/``vals_t`` (``(ndiag_t, n)``), as
    ``DiaMatrix.from_scipy`` stores them, and ``plane_dtype``, the dtype
    it stores them in for float32 (bfloat16 where every value is exact
    there, as JAX's position-sharded planes); None for a matrix without
    entries (no tap set)."""
    coo = scipy.sparse.coo_matrix(csr)
    coo.sum_duplicates()
    if coo.nnz == 0:
        return None
    m, n = coo.shape
    vals, offsets = DiaMatrix._planes(coo, m)
    vals_t, offsets_t = DiaMatrix._planes(coo.T.tocoo(), n)
    return dict(offsets=tuple(int(o) for o in offsets), vals=vals,
                offsets_t=tuple(int(o) for o in offsets_t), vals_t=vals_t,
                plane_dtype=dia_plane_dtype(coo.data, torch.float32))


def halo_plan(systems, n, m, m_eq, ndev):
    """The shard geometry of ``ndev`` ranks, or None: ``positions`` P,
    ``width`` W, ``x_halo`` (left, right), the reach of A's taps, and
    ``y_halo``, that plus the reach of Aᵀ's (over every present system in
    ``systems``, :func:`_host_dia` dicts); :func:`shard_width` checks W."""
    fwd = [o for s in systems if s is not None for o in s["offsets"]]
    bwd = [o for s in systems if s is not None for o in s["offsets_t"]]
    rl, rr = max(0, -min(fwd)), max(0, max(fwd))
    y_halo = (rl + max(0, -min(bwd)), rr + max(0, max(bwd)))
    return shard_width(dict(positions=max(n, m, m_eq), x_halo=(rl, rr),
                            y_halo=y_halo), ndev)


def shard_width(plan, ndev):
    """``plan`` with the width W of ``ndev`` ranks, or None.  A rank
    supplies its neighbours' halos from its own range, so more than one
    rank needs W at least as wide as the widest halo (JAX's ``nw >=
    ndev``)."""
    width = -(-plan["positions"] // ndev)
    if ndev > 1 and width < max(plan["y_halo"]):
        return None
    return dict(plan, width=width)


def position_shard_plan(a_eq, a_ineq, n, m_eq, m_ineq, ndev, dtype,
                        device="cuda"):
    """The plan of the position-sharded path, or ``None``.

    Eligible when ``dtype`` is float32, an inequality system is present,
    every (already anchor-aligned) system has at most
    ``DIA_AUTO_MAX_OFFSETS`` diagonals and a non-empty tap set, and each of
    the ``ndev`` ranks is at least as wide as the halo it supplies
    (:func:`halo_plan`): JAX's gate without its TPU window plan.  JAX's
    passes on a TPU; this one passes on CUDA, and on the CPU only under
    the ``_FORCE_CPU`` test hook.  Returns ``dict(plan=..., dia=...,
    dia_eq=...)`` (host planes, ``dia_eq`` None without equalities)."""
    if not _is_float32(dtype):
        return None
    if a_ineq is None or a_ineq.shape[0] == 0:
        return None
    if not (_FORCE_CPU or torch.device(device).type == "cuda"):
        return None
    # the O(nnz) diagonal count before any plane is materialized
    csr_in = scipy.sparse.csr_matrix(a_ineq)
    if _diagonal_count(csr_in) > DIA_AUTO_MAX_OFFSETS:
        return None
    csr_eq = None
    if a_eq is not None and a_eq.shape[0] > 0:
        csr_eq = scipy.sparse.csr_matrix(a_eq)
        if _diagonal_count(csr_eq) > DIA_AUTO_MAX_OFFSETS:
            return None
    di = _host_dia(csr_in)
    if di is None:
        return None
    de = None
    if csr_eq is not None:
        de = _host_dia(csr_eq)
        if de is None:
            return None
    plan = halo_plan([di, de], n, m_ineq, m_eq, ndev)
    if plan is None:
        return None
    return dict(plan=plan, dia=di, dia_eq=de)


def position_system(sys_d, plan_info, alpha=1.0, theta=1.0, omega=1.0):
    """The whole system as every rank cuts it (host arrays): the sizes,
    the planes of ``plan_info``, the vectors, the diagonal preconditioners
    (the single-device formulas, ``omega`` applied statically), the
    starting state and the plan's halos (:func:`place_position_shard`
    sets the width of its rank count).  ``sys_d`` is the aligned system dict (``a_eq, beq,
    a_ineq, b_ineq, c, lb, ub, x0, x30, y_eq0, y_ineq0``)."""
    from ..solvers.chambolle_pock import host_preconditioners

    de = plan_info["dia_eq"]
    a_eq = sys_d["a_eq"] if de is not None else None
    n = int(np.asarray(sys_d["c"]).size)
    m = sys_d["a_ineq"].shape[0]
    m_eq = a_eq.shape[0] if a_eq is not None else 0
    diag_t, sigma_eq, sigma_ineq = host_preconditioners(
        a_eq, sys_d["a_ineq"], alpha=alpha, omega=omega)

    def vec(key, size):
        v = sys_d.get(key)
        return np.zeros(size) if v is None else np.asarray(v, np.float64)

    x0 = vec("x0", n)
    glob = dict(n=n, m=m, m_eq=m_eq, theta=float(theta),
                plan=plan_info["plan"], dia=plan_info["dia"], dia_eq=de,
                c=vec("c", n), lb=vec("lb", n), ub=vec("ub", n),
                diag_t=diag_t, sigma_ineq=sigma_ineq, b_ineq=vec("b_ineq", m),
                x=x0, x3=vec("x30", n) if sys_d.get("x30") is not None
                else x0, y_ineq=vec("y_ineq0", m))
    if de is not None:
        glob.update(sigma_eq=sigma_eq, beq=vec("beq", m_eq),
                    y_eq=vec("y_eq0", m_eq))
    return glob


def place_position_shard(glob, ndev, rank, dtype=torch.float32,
                         device="cuda"):
    """Rank ``rank``'s ``(data, state)`` of ``ndev`` on ``device``, cut
    from the whole system ``glob`` (:func:`position_system`).  Every local
    vector covers global positions ``[g0, g0 + length)``, zero outside the
    problem; the state's halos start filled from ``glob``."""
    n, m, m_eq = glob["n"], glob["m"], glob["m_eq"]
    di, de = glob["dia"], glob["dia_eq"]
    plan = shard_width(glob["plan"], ndev)
    if plan is None:
        raise ValueError(f"{ndev} ranks are narrower than their halos")
    width = plan["width"]
    (xl, xr), (hl, hr) = plan["x_halo"], plan["y_halo"]
    g0 = rank * width - hl
    length = hl + width + hr
    i0, i1 = hl, hl + width
    p0, p1 = i0 - xl, i1 + xr
    dev = torch.device(device)

    def cut_host(v, size):
        """``v`` (..., size) -> (..., length) at ``[g0, g0 + length)``."""
        v = np.asarray(v, np.float64)
        out = np.zeros(v.shape[:-1] + (length,))
        a, b = max(g0, 0), min(g0 + length, size)
        if b > a:
            out[..., a - g0:b - g0] = v[..., a:b]
        return out

    def cut(v, size):
        return torch.as_tensor(cut_host(v, size), dtype=dtype, device=dev)

    def local_dia(s, rows):
        planes = s.get("plane_dtype") if dtype == torch.float32 else None
        return DiaMatrix.from_planes(cut_host(s["vals"], rows), s["offsets"],
                                     cut_host(s["vals_t"], n),
                                     s["offsets_t"], length, length, dtype,
                                     dev, planes)

    a_in, a_eq = one_plane_storage([
        local_dia(di, m), local_dia(de, m_eq) if de is not None else None])
    shard = CpDiaShard(g0=g0, length=length, primal=(p0, p1),
                       interior=(i0, i1), n=n, m=m, me=m_eq,
                       c=cut(glob["c"], n), lb=cut(glob["lb"], n),
                       ub=cut(glob["ub"], n), a_ineq=a_in,
                       b_ineq=cut(glob["b_ineq"], m), a_eq=a_eq,
                       b_eq=cut(glob["beq"], m_eq) if de is not None
                       else None)
    pre = dict(diag_t=cut(glob["diag_t"], n),
               sigma_ineq=cut(glob["sigma_ineq"], m))
    if de is not None:
        pre["sigma_eq"] = cut(glob["sigma_eq"], m_eq)

    def operand(vals, offsets, lo, hi):
        """H-DIA over local rows ``[lo, hi)`` of a local layout vector."""
        offs = torch.as_tensor(np.asarray(offsets, np.int32) + lo,
                               device=dev)
        return DiaOperand(vals[:, lo:hi].contiguous(), offs, hi - lo)

    ops = dict(a=operand(a_in.vals, a_in.offsets, i0, i1),
               at=operand(a_in.vals_t, a_in.offsets_t, p0, p1))
    if a_eq is not None:
        ops.update(ae=operand(a_eq.vals, a_eq.offsets, i0, i1),
                   aet=operand(a_eq.vals_t, a_eq.offsets_t, p0, p1))
    data = dict(shard=shard, pre=pre, ops=ops, plan=plan, ndev=ndev,
                rank=rank, n=n, m=m, m_eq=m_eq, has_eq=de is not None,
                theta=float(glob["theta"]),
                pos=torch.arange(rank * width, (rank + 1) * width,
                                 device=dev))
    state = dict(x=cut(glob["x"], n), x3=cut(glob["x3"], n),
                 y_ineq=cut(glob["y_ineq"], m))
    if de is not None:
        state["y_eq"] = cut(glob["y_eq"], m_eq)
    return data, state


def build_position_sharded(sys_d, mesh, alpha=1.0, theta=1.0,
                           plan_info=None, omega=1.0):
    """This rank's float32 ``(data, state)`` on ``mesh.device``.

    ``sys_d`` is the ALIGNED system dict (scipy matrices + numpy vectors):
    keys ``a_eq, beq, a_ineq, b_ineq, c, lb, ub, x0, x30, y_eq0,
    y_ineq0``.  ``omega`` statically applies the primal weight (τ·ω, σ/ω,
    the single-device ``_scale_pre``); the restart controller builds with
    ``omega=1`` and scales inside the chunk."""
    mesh = check_mesh(mesh)
    if plan_info is None:
        a_eq = sys_d["a_eq"]
        plan_info = position_shard_plan(
            a_eq, sys_d["a_ineq"], np.asarray(sys_d["c"]).size,
            a_eq.shape[0] if a_eq is not None else 0,
            sys_d["a_ineq"].shape[0], mesh.size, torch.float32,
            device=mesh.device)
    assert plan_info is not None, "caller must check position_shard_plan"
    glob = position_system(sys_d, plan_info, alpha=alpha, theta=theta,
                           omega=omega)
    return place_position_shard(glob, mesh.size, mesh.rank, torch.float32,
                                mesh.device)


def _unpack(state):
    ye = state.get("y_eq")
    if ye is None:
        ye = state["x"].new_zeros(0)
    return state["x"], state["x3"], state["y_ineq"], ye


def _pack(data, x, x3, y, ye):
    out = dict(x=x, x3=x3, y_ineq=y)
    if data["has_eq"]:
        out["y_eq"] = ye
    return out


def _gather(data, mesh, arrays):
    """The global vectors (``(array, size)`` pairs, on the device) from
    every rank's interior: one all-gather, none on one rank."""
    i0, i1 = data["shard"].interior
    width = i1 - i0
    parts = [a[i0:i1] for a, _size in arrays]
    whole = torch.cat(parts)
    if mesh.size > 1:
        whole = mesh.all_gather(whole)
    whole = whole.reshape(mesh.size, len(arrays), width)
    return [whole[:, k].reshape(-1)[:size]
            for k, (_a, size) in enumerate(arrays)]


def unshard_state(data, state, mesh):
    """The global ``(x, x3, y_eq, y)`` as float64 numpy arrays, on every
    rank (one all-gather)."""
    x, x3, y, ye = _unpack(state)
    arrays = [(x, data["n"]), (x3, data["n"]), (y, data["m"])]
    if data["has_eq"]:
        arrays.append((ye, data["m_eq"]))
    out = [v.detach().to(device="cpu", dtype=torch.float64).numpy()
           for v in _gather(data, check_mesh(mesh), arrays)]
    return out[0], out[1], out[3] if data["has_eq"] else np.zeros(0), out[2]


def halo_items(data, xs=(), ys=()):
    """The :meth:`~.mesh.Mesh.halo_exchange` items of a rank's x-like
    arrays ``xs`` (halo: the reach of A's taps) and y-like arrays ``ys``
    (the full halo)."""
    i0, i1 = data["shard"].interior
    (xl, xr), (yl, yr) = data["plan"]["x_halo"], data["plan"]["y_halo"]
    return ([(t, i0, i1, xl, xr) for t in xs]
            + [(t, i0, i1, yl, yr) for t in ys])


def state_halo_items(data, state):
    """The items an iteration refreshes: x, y and y_eq."""
    x, _x3, y, ye = _unpack(state)
    return halo_items(data, xs=(x,), ys=(y, ye) if data["has_eq"] else (y,))


def _iterate(data, mesh, pre, x, x3, y, ye, nsteps, sums=None):
    """``nsteps`` iterations from ``(x, x3, y, ye)`` (left as they are;
    ``sums`` are updated in place); returns the new ``(x, x3, y, ye)``.
    Each iteration: on more than one rank the halo exchange of x, y and
    y_eq (:class:`~.mesh.HaloRoute`: one all-gather of the packet the
    previous call wrote, one launch to place the halos), then one call of
    the shard entry (one launch), which also writes the next packet."""
    x3 = x3.clone()
    route, packet = None, None
    if mesh.size > 1:
        arrays = (x, y, ye) if data["has_eq"] else (x, y)
        route = HaloRoute(mesh, arrays, state_halo_items(
            data, _pack(data, x, x3, y, ye)))
        route.pack()
        x, y = route.views[:2]
        ye = route.views[2] if data["has_eq"] else ye
        packet = route.packet
    else:
        x, y, ye = x.clone(), y.clone(), ye.clone()
    step = cp_dia_shard_stepper(data["shard"], pre, x, x3, ye, y,
                                data["theta"], sums, packet)
    for _ in range(nsteps):
        if route is not None:
            route()
        step()
    return x, x3, y, ye


def _scaled(pre, omega):
    """The step vectors at primal weight ``omega`` (τ·ω, σ/ω)."""
    out = dict(pre, diag_t=pre["diag_t"] * omega,
               sigma_ineq=pre["sigma_ineq"] / omega)
    if "sigma_eq" in pre:
        out["sigma_eq"] = pre["sigma_eq"] / omega
    return out


def _interior_matvec(op, arr):
    """A DIA product restricted to a shard's rows (H-DIA): ``op`` holds
    the local planes of rows ``[lo, hi)`` with offsets shifted by ``lo``,
    so ``result[r] = Σ_j vals[j, r] · arr[lo + r + off_j]`` reads the
    halo-fresh local layout ``arr`` directly."""
    return dia_apply(op, arr)


def _interior(data, a):
    i0, i1 = data["shard"].interior
    return a[i0:i1]


def _dual_direction(data, y, ye):
    """``c + Aᵀy (+ A_eᵀy_e)`` over the primal range (halo-fresh y)."""
    sh, ops = data["shard"], data["ops"]
    p0, p1 = sh.primal
    d = sh.c[p0:p1] + _interior_matvec(ops["at"], y)
    if data["has_eq"]:
        d = d + _interior_matvec(ops["aet"], ye)
    return d


def _score_parts(data, x, y, ye):
    """This rank's ``(pobj, dual, pviol)`` of the KKT progress score of
    halo-fresh layouts (JAX's ``score`` before its psums)."""
    sh, ops = data["shard"], data["ops"]
    (p0, _p1), (i0, i1) = sh.primal, sh.interior
    b_i, lb_i, ub_i = (_interior(data, v) for v in (sh.b_ineq, sh.lb, sh.ub))
    dd = _dual_direction(data, y, ye)[i0 - p0:i1 - p0]
    r = torch.clamp_min(_interior_matvec(ops["a"], x) - b_i, 0.0)
    pviol = torch.sum(r * r)
    dual = -torch.dot(_interior(data, y), b_i)
    if data["has_eq"]:
        be_i = _interior(data, sh.b_eq)
        re_ = _interior_matvec(ops["ae"], x) - be_i
        pviol = pviol + torch.sum(re_ * re_)
        dual = dual - torch.dot(_interior(data, ye), be_i)
    dual = dual + torch.sum(torch.where(dd < 0, dd * ub_i, dd * lb_i))
    pobj = torch.dot(_interior(data, sh.c), _interior(data, x))
    return torch.stack([pobj, dual, pviol])


def _score(parts):
    pobj, dual, pviol = parts
    gap = torch.abs(pobj - dual) / (1.0 + torch.abs(pobj) + torch.abs(dual))
    return torch.sqrt(pviol + gap * gap)


def sharded_kkt_score(data, state, mesh):
    """The KKT score of a halo-fresh sharded state (seeds the restart
    controller; one psum)."""
    x, _x3, y, ye = _unpack(state)
    return _score(check_mesh(mesh).psum(_score_parts(data, x, y, ye)))


def sharded_windowed_chunk(data, state, mesh, nsteps: int):
    """Advance ``nsteps`` iterations, fully sharded; returns the new state
    (the input's tensors are left as they were).  Each iteration: one
    halo exchange of x, y and y_eq with both neighbours, then one call of
    H-CPDIA's shard entry."""
    assert nsteps >= 1
    mesh = check_mesh(mesh)
    x, x3, y, ye = _iterate(data, mesh, data["pre"], *_unpack(state), nsteps)
    return _pack(data, x, x3, y, ye)


def sharded_windowed_chunk_restart(data, rstate, mesh, nsteps: int,
                                   period: int):
    """Device-resident PDLP restart controller for the position-sharded
    path: ``nsteps`` iterations with a restart-to-average check every
    ``period`` iterations.

    The sharded twin of ``solvers.chambolle_pock._cp_chunk_restart_device``:
    the shard entry keeps the running sums, and a check costs one halo
    exchange (the state and the averages), two interior SpMV pairs and two
    psums of packed scalars (both scores, then both movements).
    ``rstate`` carries the sharded ``state``, the sharded restart point
    (``zx``/``zeq``/``zineq``) and the replicated 0-d ``omega``,
    ``mu_restart`` and ``mu_last``; ``data`` holds the unscaled steps."""
    from ..solvers.chambolle_pock import pdlp_restart

    assert nsteps >= 1 and period >= 1
    mesh = check_mesh(mesh)
    has_eq = data["has_eq"]
    nblocks, rem = divmod(nsteps, period)
    x, x3, y, ye = _unpack(rstate["state"])
    rs = dict(rstate, zeq=rstate.get("zeq"))
    if rs["zeq"] is None:
        rs["zeq"] = ye

    def movement(a, b):
        return torch.sum((_interior(data, a) - _interior(data, b)) ** 2)

    for _ in range(nblocks):
        pre = _scaled(data["pre"], rs["omega"])
        sums = (torch.zeros_like(x), torch.zeros_like(ye),
                torch.zeros_like(y))
        x, x3, y, ye = _iterate(data, mesh, pre, x, x3, y, ye, period, sums)
        inv = 1.0 / period
        ax, aye, ay = (s * inv for s in sums)
        mesh.halo_exchange(halo_items(
            data, xs=(x, ax), ys=(y, ay, ye, aye) if has_eq else (y, ay)))
        scores = mesh.psum(torch.cat([_score_parts(data, x, y, ye),
                                      _score_parts(data, ax, ay, aye)]))

        def candidate(use_avg):
            z = tuple(torch.where(use_avg, a, v)
                      for a, v in zip((ax, ay, aye), (x, y, ye)))
            dy2 = movement(z[1], rs["zineq"])
            if has_eq:
                dy2 = dy2 + movement(z[2], rs["zeq"])
            dx, dy = torch.sqrt(mesh.psum(torch.stack(
                [movement(z[0], rs["zx"]), dy2])))
            return z, dx, dy

        do, (zx, zineq, zeq), scalars = pdlp_restart(
            rs, _score(scores[:3]), _score(scores[3:]), candidate)
        x3 = torch.where(do, zx, x3)
        x = torch.where(do, zx, x)
        y = torch.where(do, zineq, y)
        if has_eq:
            ye = torch.where(do, zeq, ye)
        rs = dict(
            rs, **scalars,
            zx=torch.where(do, zx, rs["zx"]),
            zeq=torch.where(do, zeq, rs["zeq"]) if has_eq else rs["zeq"],
            zineq=torch.where(do, zineq, rs["zineq"]))
    if rem:
        x, x3, y, ye = _iterate(data, mesh, _scaled(data["pre"], rs["omega"]),
                                x, x3, y, ye, rem)
    return dict(state=_pack(data, x, x3, y, ye), omega=rs["omega"],
                mu_restart=rs["mu_restart"], mu_last=rs["mu_last"],
                zx=rs["zx"], zeq=rs["zeq"] if has_eq else None,
                zineq=rs["zineq"])


def sharded_windowed_metrics(data, state, mesh):
    """Checkpoint metrics computed on the mesh: the sharded twin of the
    single-device metrics (``chambolle_pock.cp_chunk_impl``), equal up to
    the reduction order.

    One halo exchange, then scalar collectives only: ``energy1``, the
    box-dual bound ``energy2`` and ``energy_rounded`` in one psum; the
    violation maxima (``max_violated_inequality`` over the true rows: it
    can be negative) and the rounded iterate's infeasibility (JAX's
    ``pmin`` of feasibility) in one pmax.  The dual-feasible minimizer
    ``x4`` is computed over the primal range, so its products need no
    second exchange."""
    mesh = check_mesh(mesh)
    sh, ops = data["shard"], data["ops"]
    (p0, p1) = sh.primal
    has_eq = data["has_eq"]
    x, _x3, y, ye = (t.clone() for t in _unpack(state))
    mesh.halo_exchange(halo_items(data, xs=(x,),
                                  ys=(y, ye) if has_eq else (y,)))
    d = _dual_direction(data, y, ye)
    x4 = torch.zeros_like(x)
    x4[p0:p1] = torch.where(d < 0, sh.ub[p0:p1], sh.lb[p0:p1])
    xr = torch.round(x)
    c_i, b_i = _interior(data, sh.c), _interior(data, sh.b_ineq)
    y_i = _interior(data, y)
    r_in = _interior_matvec(ops["a"], x) - b_i
    energy1 = torch.dot(c_i, _interior(data, x)) + torch.dot(y_i, r_in)
    energy2 = (torch.dot(c_i, _interior(data, x4))
               + torch.dot(y_i, _interior_matvec(ops["a"], x4) - b_i))
    energy_rounded = torch.dot(c_i, _interior(data, xr))
    max_v_in = torch.max(torch.where(data["pos"] < data["m"], r_in,
                                     torch.full_like(r_in, -float("inf"))))
    feasible = torch.max(_interior_matvec(ops["a"], xr) - b_i) <= 0
    max_v_eq = torch.full_like(max_v_in, -float("inf"))
    if has_eq:
        ye_i, be_i = _interior(data, ye), _interior(data, sh.b_eq)
        r_eq = _interior_matvec(ops["ae"], x) - be_i
        energy1 = energy1 + torch.dot(ye_i, r_eq)
        energy2 = energy2 + torch.dot(
            ye_i, _interior_matvec(ops["ae"], x4) - be_i)
        max_v_eq = torch.max(torch.abs(r_eq))
        feasible = feasible & (torch.max(torch.abs(
            _interior_matvec(ops["ae"], xr) - be_i)) == 0)
    sums = mesh.psum(torch.stack([energy1, energy2, energy_rounded]))
    maxes = mesh.pmax(torch.stack([max_v_in, max_v_eq,
                                   (~feasible).to(max_v_in.dtype)]))
    return dict(energy1=sums[0], energy2=sums[1],
                max_violated_equality=(maxes[1] if has_eq
                                       else torch.zeros_like(maxes[1])),
                max_violated_inequality=maxes[0], energy_rounded=sums[2],
                rounded_feasible=maxes[2] == 0)


def run_position_sharded(sys_d, mesh, info, nb_max_iter=1000,
                         nb_iter_plot=100, callback_func=None,
                         max_time=None, start_time=None,
                         force_integer=False, stop_tol=None,
                         light_metrics=False, theta=1.0, alpha=1.0,
                         omega=1.0, restart=None, restart_period=None):
    """Host loop for the position-sharded CP path.

    Same contract as the row-sharded loop: chunked iterations, checkpoint
    metrics through the standard callback protocol, ``stop_tol`` /
    ``max_time`` / ``force_integer`` semantics.  Every checkpoint reduces
    its metrics on the mesh (:func:`sharded_windowed_metrics`); x is
    gathered for a callback that wants the solution, for
    ``force_integer``'s best point and once at the end.  ``omega`` applies
    the primal weight; ``restart="average"`` runs the device-resident PDLP
    controller (:func:`sharded_windowed_chunk_restart`).  Returns
    ``(x_aligned, best_integer_solution)`` on every rank."""
    from ..solvers.base import HostLoop, chunk_schedule, emit_callback

    global last_run_info
    mesh = check_mesh(mesh)
    loop = HostLoop(start_time, max_time)
    t0 = time.perf_counter()
    data, state = build_position_sharded(
        sys_d, mesh, alpha=alpha, theta=theta, plan_info=info,
        omega=1.0 if restart == "average" else float(omega))
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    plan = data["plan"]
    last_run_info = dict(regime="position-sharded", ranks=mesh.size,
                         positions=plan["positions"],
                         positions_per_rank=plan["width"],
                         x_halo=plan["x_halo"], y_halo=plan["y_halo"],
                         planes=str(data["shard"].a_ineq.vals.dtype)[6:],
                         restart=restart,
                         build_s=time.perf_counter() - t0)
    n = data["n"]

    def x_global():
        return _gather(data, mesh, [(state["x"], n)])[0]

    wants_x = (callback_func is not None
               and getattr(callback_func, "wants_solution", True))
    rstate = None
    if restart == "average":
        # the controller starts from the KKT score of the initial point,
        # whose halos the build filled
        period = int(min(restart_period or nb_iter_plot, nb_iter_plot))
        rstate = dict(state=state,
                      omega=torch.tensor(float(omega), dtype=state["x"].dtype,
                                         device=mesh.device),
                      mu_restart=sharded_kkt_score(data, state, mesh),
                      mu_last=torch.tensor(np.inf, dtype=state["x"].dtype,
                                           device=mesh.device),
                      zx=state["x"], zeq=state.get("y_eq"),
                      zineq=state["y_ineq"])
    niter = 0
    best_integer_solution = None
    best_integer_energy = np.inf
    for nsteps in chunk_schedule(nb_max_iter, nb_iter_plot):
        if restart == "average":
            rstate = sharded_windowed_chunk_restart(data, rstate, mesh,
                                                    nsteps, period)
            state = rstate["state"]
        else:
            state = sharded_windowed_chunk(data, state, mesh, nsteps)
        niter += nsteps
        metrics = sharded_windowed_metrics(data, state, mesh)
        # light contract: a solution-less callback gets the local x
        x_cb = x_global() if wants_x else state["x"]
        if force_integer and bool(metrics["rounded_feasible"]):
            er = float(metrics["energy_rounded"])
            if er < best_integer_energy:
                best_integer_energy = er
                xg = x_cb if wants_x else x_global()
                best_integer_solution = np.round(
                    xg.detach().to("cpu", torch.float64).numpy())
        emit_callback(
            callback_func, niter, x_cb,
            metrics["energy1"], metrics["energy2"],
            lambda: loop.elapsed,
            metrics["max_violated_equality"],
            metrics["max_violated_inequality"],
            light=light_metrics,
        )
        if loop.timed_out:
            break
        if stop_tol is not None:
            e1, e2 = float(metrics["energy1"]), float(metrics["energy2"])
            gap = abs(e1 - e2) / (1.0 + abs(e1) + abs(e2))
            feas = max(float(metrics["max_violated_equality"]),
                       float(metrics["max_violated_inequality"]))
            if feas < stop_tol and gap < stop_tol:
                break
    x_final = x_global().detach().to("cpu", torch.float64).numpy()
    return x_final, best_integer_solution
