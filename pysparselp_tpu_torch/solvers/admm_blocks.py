"""Consensus (block-decomposition) ADMM, PyTorch port of
``pysparselp_tpu/solvers/admm_blocks.py``.

Reference: ``pysparselp/ADMMBlocks.py:45-348`` — Boyd §7.1/7.2 general-form
consensus: the equality system (after slack conversion) is split by the
model's per-batch ``blocks`` metadata; each block solves its own KKT
subproblem over only the columns it touches, with per-block primal copies
and duals, and a global consensus average.

As in the JAX package, every block's subproblem is reduced by Schur
complement to its SPD ``A_b A_bᵀ`` system, padded to a common ``(rows_max,
cols_max)`` shape and batched: one batched Cholesky at setup
(``ops/linear_solve.cholesky_upper``), one batched ``cholesky_solve`` and
two batched products (``torch.bmm``) per iteration.  The consensus sum of
the blocks' copies of each variable is ``Sᵀ v`` with ``S`` the 0/1 map of
the blocks' column slots to the variables, a
:class:`~pysparselp_tpu_torch.problem.CsrMatrix` built once: H-CSR on the
card sums a variable's copies in slot order, as JAX's scatter-add does on
the CPU, where ``index_add_`` on CUDA would add them through atomics in no
fixed order.

``mesh=`` (a :class:`~pysparselp_tpu_torch.parallel.mesh.Mesh`) shards the
block batch over a ``torch.distributed`` group, as the JAX package's
``_admm_blocks_chunk_sharded`` does: the batch is padded to a multiple of
the rank count (:func:`_pad_blocks_to`), each rank factors and solves its
own blocks and sums their copies into the consensus locally (its own
consensus map), and one ``psum`` of the (n + 1)-vector a iteration merges
the sums.  The mesh decides the device; on one rank the chunk is the
one-device chunk bit for bit.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import torch

from ..ops.linear_solve import cholesky_upper
from ..preconditioning import convert_to_standard_form_with_bounds
from ..problem import CsrMatrix, resolve_device, resolve_dtype
from ..parallel.mesh import check_mesh
from .base import HostLoop, ToleranceStop, chunk_schedule, emit_callback, to_np


def _build_blocks(a, beq):
    """Split standard-form equalities by block metadata into padded dense
    per-block tensors (host-side, once).

    Returns dict with: sub_a (B, mr, mc), ids (B, mc) int32 (dummy = n),
    row_mask (B, mr), col_mask (B, mc), beq_pad (B, mr), nb_used (n,).
    """
    blocks = getattr(a, "blocks", None) or [(0, a.shape[0])]
    n = a.shape[1]
    csr = scipy.sparse.csr_matrix(a)

    subs, ids_list, bs = [], [], []
    for (r0, r1) in blocks:
        sub = csr[r0:r1, :]
        touched = np.nonzero(np.asarray(np.abs(sub).sum(axis=0)).ravel())[0]
        subs.append(sub[:, touched].toarray())
        ids_list.append(touched)
        bs.append(np.asarray(beq[r0:r1], float))

    nb = len(subs)
    mr = max(s.shape[0] for s in subs)
    mc = max(s.shape[1] for s in subs)
    sub_a = np.zeros((nb, mr, mc))
    ids = np.full((nb, mc), n, dtype=np.int32)  # n = dummy slot
    row_mask = np.zeros((nb, mr))
    col_mask = np.zeros((nb, mc))
    beq_pad = np.zeros((nb, mr))
    nb_used = np.zeros(n)
    for k, (s, t, bvec) in enumerate(zip(subs, ids_list, bs)):
        sub_a[k, : s.shape[0], : s.shape[1]] = s
        ids[k, : t.size] = t
        row_mask[k, : s.shape[0]] = 1.0
        col_mask[k, : t.size] = 1.0
        beq_pad[k, : bvec.size] = bvec
        nb_used[t] += 1
    return dict(
        sub_a=sub_a, ids=ids, row_mask=row_mask, col_mask=col_mask,
        beq_pad=beq_pad, nb_used=nb_used, nb_blocks=nb,
    )


# _pad_blocks_to: verbatim copy of pysparselp_tpu/solvers/admm_blocks.py:87-101
def _pad_blocks_to(blocks, nb_pad):
    """Pad the block batch dim to ``nb_pad`` (for even mesh sharding)."""
    nb = blocks["nb_blocks"]
    if nb_pad == nb:
        return blocks
    pad = nb_pad - nb
    out = dict(blocks)
    for k in ("sub_a", "ids", "row_mask", "col_mask", "beq_pad"):
        v = blocks[k]
        padv = np.zeros((pad,) + v.shape[1:], dtype=v.dtype)
        if k == "ids":
            padv += v.max()  # dummy slot index n
        out[k] = np.concatenate([v, padv], axis=0)
    out["nb_blocks"] = nb_pad
    return out


def consensus_map(ids, col_mask, n, dtype, device):
    """``S``, the ``(B·mc) × (n + 1)`` 0/1 map of the blocks' used column
    slots (``col_mask``) to their variables ``ids``: ``S.rmatvec(v)`` is the
    consensus scatter-add ``zeros(n + 1).at[ids].add(v)`` of ``v`` masked
    to the used slots, each variable's copies summed in slot order."""
    slots = np.flatnonzero(np.asarray(col_mask).reshape(-1))
    s = scipy.sparse.csr_matrix(
        (np.ones(slots.size), (slots, np.asarray(ids).reshape(-1)[slots])),
        shape=(np.asarray(ids).size, n + 1))
    return CsrMatrix.from_scipy(s, dtype, device)


def _admm_blocks_chunk(data, state, nsteps: int, mesh=None):
    """``nsteps`` iterations over the blocks in ``data``: all of them, or
    with ``mesh`` this rank's, their consensus sums merged by one psum an
    iteration and the metrics' sum and maximum by one psum and one pmax."""
    sub_a, sub_at, ids = data["sub_a"], data["sub_at"], data["ids"]
    chol, sel = data["chol"], data["sel"]
    col_mask, row_mask = data["col_mask"], data["row_mask"]
    beq = data["beq_pad"]
    c_ext, lb_ext, ub_ext = data["c_ext"], data["lb_ext"], data["ub_ext"]
    inv_used = data["inv_used"]
    gamma, alpha = data["gamma"], data["alpha"]
    n = c_ext.shape[0] - 1

    def bmv(m, v):
        return torch.bmm(m, v[..., None])[..., 0]

    x_b, lam_b, xp = state
    for _ in range(nsteps):
        xp_g = xp[ids] * col_mask  # (B, mc) gather
        y1 = gamma * xp_g - lam_b
        # Schur solve of each block's KKT system (admm_blocks.py:196-200)
        rhs = bmv(sub_a, y1) - gamma * beq
        nu = torch.cholesky_solve(rhs[..., None], chol, upper=True)[..., 0]
        xv = (y1 - bmv(sub_at, nu)) / gamma * col_mask
        x_b = alpha * xv + (1.0 - alpha) * xp_g
        # consensus: xp = (Σ_b (x_b + λ_b/γ) − c/γ) / nb_used, clipped.
        # Variables in no block keep their previous xp (ADMMBlocks.py:290-296
        # only zeroes xp where nb_used > 0), so they descend along −c/γ until
        # they hit their bound.
        acc = sel.rmatvec(((x_b + lam_b / gamma) * col_mask).reshape(-1))
        if mesh is not None:
            acc = mesh.psum(acc)
        base = torch.where(data["used_mask"], acc[:n], xp[:n])
        xp = (base - c_ext[:n] / gamma) * inv_used
        xp = torch.minimum(torch.maximum(xp, lb_ext[:n]), ub_ext[:n])
        xp = torch.cat([xp, xp.new_zeros(1)])
        lam_b = lam_b + gamma * (x_b - xp[ids] * col_mask)
    state = (x_b, lam_b, xp)

    diff = x_b - xp[ids] * col_mask
    spread = torch.sum((0.5 * gamma * diff**2 + lam_b * diff) * col_mask)
    # residual of the original equalities at the consensus point
    r = (bmv(sub_a, xp[ids] * col_mask) - beq) * row_mask
    worst = torch.max(torch.abs(r))
    if mesh is not None:
        spread, worst = mesh.psum(spread), mesh.pmax(worst)
    metrics = dict(
        energy1=torch.dot(c_ext[:-1], xp[:-1]) + spread,
        max_violated_equality=worst,
        max_violated_inequality=xp.new_zeros(()),
    )
    return state, metrics


def lp_admm_block_decomposition(
    c,
    a_eq,
    beq,
    a_ineq,
    b_lower,
    b_upper,
    lb,
    ub,
    x0=None,
    gamma_ineq=0.7,
    nb_iter=100,
    callback_func=None,
    max_time=None,
    use_preconditioning=True,
    use_lu=True,
    nb_iter_plot=10,
    alpha=1.95,
    dtype=None,
    start_time=None,
    mesh=None,
    stop_tol=None,
    light_metrics=False,
    device="cuda",
):
    """Consensus ADMM over the model's block structure; signature parity with
    ``ADMMBlocks.py:45`` (plus ``device``).  ``mesh`` shards the block
    batch over its ranks (on the mesh's device)."""
    del use_preconditioning, use_lu  # dense-Cholesky path covers both
    if mesh is not None:
        mesh = check_mesh(mesh)
        dev = mesh.device
    else:
        dev = resolve_device(device)
    dtype = resolve_dtype(dtype, dev)
    c = np.asarray(c, np.float64)
    n0 = c.size
    if x0 is None:
        x0 = np.zeros(n0)
    if a_eq is not None and a_eq.shape[0] == 0:
        a_eq, beq = None, None
    if a_ineq is not None and a_ineq.shape[0] == 0:
        a_ineq = None
    c2, a, b, lb2, ub2, x02 = convert_to_standard_form_with_bounds(
        c, a_eq, beq, a_ineq, b_lower, b_upper, np.asarray(lb, float),
        np.asarray(ub, float), x0,
    )
    n = a.shape[1]

    blocks = _build_blocks(a, b)
    mine = slice(None)
    if mesh is not None:
        nb_loc = -(-blocks["nb_blocks"] // mesh.size)
        blocks = _pad_blocks_to(blocks, nb_loc * mesh.size)
        mine = slice(mesh.rank * nb_loc, (mesh.rank + 1) * nb_loc)
    ridge = 1e-9 + 1e-12 * float(np.abs(blocks["sub_a"]).sum())
    # this rank's blocks (every block without a mesh)
    blocks.update({k: blocks[k][mine] for k in (
        "sub_a", "ids", "row_mask", "col_mask", "beq_pad")})
    sub_a = blocks["sub_a"]
    # batched one-time factorization of all block Schur complements
    # S_b = A_b A_bᵀ: the JAX package's einsum product, by BLAS (numpy's
    # einsum loop takes minutes on Potts-50's four (2450, 7400) blocks)
    s_all = np.matmul(sub_a, sub_a.transpose(0, 2, 1)) + ridge * np.eye(
        sub_a.shape[1]
    )

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=dev)

    chol, _ok = cholesky_upper(vec(s_all))
    data = dict(
        sub_a=vec(sub_a),
        ids=torch.as_tensor(blocks["ids"], dtype=torch.int64, device=dev),
        chol=chol,
        sel=consensus_map(blocks["ids"], blocks["col_mask"], n, dtype, dev),
        col_mask=vec(blocks["col_mask"]),
        row_mask=vec(blocks["row_mask"]),
        beq_pad=vec(blocks["beq_pad"]),
        c_ext=vec(np.concatenate([c2, [0.0]])),
        lb_ext=vec(np.concatenate([lb2, [0.0]])),
        ub_ext=vec(np.concatenate([ub2, [0.0]])),
        inv_used=vec(1.0 / np.maximum(blocks["nb_used"], 1)),
        used_mask=torch.as_tensor(blocks["nb_used"] > 0, device=dev),
        gamma=vec(gamma_ineq),
        alpha=vec(alpha),
    )
    data["sub_at"] = data["sub_a"].transpose(1, 2).contiguous()

    xp0 = np.clip(x02, lb2, ub2)
    xp = vec(np.concatenate([xp0, [0.0]]))
    x_b = xp[data["ids"]] * data["col_mask"]
    state = (x_b, torch.zeros_like(x_b), xp)

    loop = HostLoop(start_time=start_time, max_time=max_time)
    tstop = ToleranceStop(stop_tol)
    niter = 0
    for nsteps in chunk_schedule(nb_iter, nb_iter_plot):
        state, metrics = _admm_blocks_chunk(data, state, nsteps, mesh)
        niter += nsteps
        emit_callback(
            callback_func, niter, state[2][:n0],
            metrics["energy1"], metrics["energy1"], lambda: loop.elapsed,
            metrics["max_violated_equality"], metrics["max_violated_inequality"],
            light=light_metrics,
        )
        if loop.timed_out or tstop.check(
            metrics["energy1"], metrics["max_violated_equality"],
        ):
            break
    return to_np(state[2][:n0])
