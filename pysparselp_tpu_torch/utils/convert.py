"""Carry a lowered problem and solver state from the JAX package to the port.

:func:`problem_from_jax_arrays` rebuilds the port's
:class:`~pysparselp_tpu_torch.problem.LPProblem` from a JAX ``LPProblem``
(read through ``numpy.asarray`` and matched by class name; this module
imports no jax): a JAX ``DiaMatrix`` is stripped of its Pallas
kernel-layout padding to ``vals[:ndiag, :nrows]`` (``vals_t`` likewise), the
batched solver's unpadded ``XlaDiaMatrix`` (``pysparselp_tpu/batch.py``)
comes across as a ``DiaMatrix`` plane for plane, a ``DenseMatrix`` whole, a ``PartitionMatrix`` as the port's
``PartitionMatrix``, a ``BsrMatrix`` as the port's ``BsrMatrix`` rebuilt
from the entries of its block-ELL tiles (bf16 tiles widened, which is
exact; the padding slots and the TPU grid's padding tile-rows hold zeros
and are dropped), a ``ColBlockMatrix`` block by
block, and the gather layouts (``EllMatrix``, ``SegmentedEllMatrix``,
``RoutedEllMatrix``) through their entries as a ``CsrMatrix``.  Values JAX
stores in bfloat16 (DIA planes, a partition's table, routed ELL values)
stay bfloat16 for float32; the rest are stored in the dtype.
:func:`state_from_numpy` carries the ``(x, x3, y_eq, y_ineq)`` state and the
restart controller's ``rstate``; :func:`state_to_numpy` goes back.  Together
they let both packages run on the same lowered problem.
:func:`sharded_from_jax` carries one rank's shard of a JAX sharded
solver's data and state to the port's, for each sharded layout: the
row-sharded CP solver's per-shard DIA (``layout="cp"``), the interior
point's column blocks (``"ipm"``), the ADMM row system's block-ELL tiles
(``"admm"``), the blocked DCA's padded colour groups (``"dca"``),
``admm_blocks``' padded block batch (``"blocks"``) and the
position-sharded CP's padded window layout (``"position"``); the port's
rank count may differ from the JAX mesh's.
:func:`key_from_jax` / :func:`key_to_jax` carry a ``jax.random`` key (its
two uint32 words, as numpy) to the port's key pair and back, and
:func:`ell_rows_from_jax` a JAX ``EllMatrix``'s padded rows to the
:class:`~pysparselp_tpu_torch.ops.dca_sweep.EllRows` the coordinate sweep
walks.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import torch

from ..problem import (BsrMatrix, ColBlockMatrix, CsrMatrix, DenseMatrix,
                       DiaMatrix, LPProblem, PartitionMatrix,
                       one_plane_storage, resolve_device, resolve_dtype)


def _np(a):
    return np.asarray(a).astype(np.float64)


def _plane_dtype(planes, dtype):
    """The port's storage of JAX planes (or values, or a value table) for
    a ``dtype`` solve: JAX's bfloat16 stays bfloat16 (its values are exact
    there) for float32; anything else is stored in ``dtype``."""
    if str(planes.dtype) == "bfloat16" and dtype == torch.float32:
        return torch.bfloat16
    return dtype


def _ell_entries(vals, cols):
    """``(rows, cols, vals)`` of an ELL table: row ``r`` holds
    ``vals[r, k]`` at column ``cols[r, k]`` (padding slots hold zeros)."""
    vals, cols = _np(vals), np.asarray(cols, np.int64)
    rows = np.broadcast_to(np.arange(vals.shape[0])[:, None], vals.shape)
    return rows.ravel(), cols.ravel(), vals.ravel()


def _csr(rows, cols, vals, shape):
    """The CSR of the given entries with the zero slots dropped."""
    csr = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=shape)
    csr.eliminate_zeros()
    return csr


def _bsr_entries(op):
    """The CSR of a JAX block-ELL ``BsrMatrix`` from its ``A`` tiles:
    ``tiles[r, k][t, m] = A[r·tm + m, cols[r, k]·tn + t]``."""
    tiles = _np(op.tiles)
    tn, tm = tiles.shape[2:]
    flat = np.flatnonzero(tiles)
    r, k, t, m = np.unravel_index(flat, tiles.shape)
    cols = np.asarray(op.cols, np.int64)[r, k] * tn + t
    return _csr(r * tm + m, cols, tiles.ravel()[flat], (op.nrows, op.ncols))


def operator_from_jax(op, dtype, device):
    """The port's operator for a JAX operator (``None`` stays ``None``)."""
    if op is None:
        return None
    kind = type(op).__name__
    shape = (op.nrows, op.ncols)
    if kind in ("DiaMatrix", "XlaDiaMatrix"):
        nd, ndt = len(op.offsets), len(op.offsets_t)
        return DiaMatrix.from_planes(
            _np(op.vals)[:nd, :op.nrows], op.offsets,
            _np(op.vals_t)[:ndt, :op.ncols], op.offsets_t,
            op.nrows, op.ncols, dtype, device, _plane_dtype(op.vals, dtype))
    if kind == "DenseMatrix":
        return DenseMatrix(a=torch.as_tensor(_np(op.a), dtype=dtype,
                                             device=device),
                           nrows=op.nrows, ncols=op.ncols)
    if kind == "PartitionMatrix":
        return PartitionMatrix(
            vals=torch.as_tensor(_np(op.vals),
                                 dtype=_plane_dtype(op.vals, dtype),
                                 device=device),
            col0=op.col0, stride=op.stride, width=op.width, nrows=op.nrows,
            ncols=op.ncols)
    if kind == "BsrMatrix":
        return BsrMatrix.from_scipy(_bsr_entries(op), dtype, device)
    if kind == "ColBlockMatrix":
        return ColBlockMatrix(
            blocks=tuple(operator_from_jax(b, dtype, device)
                         for b in op.blocks),
            col_starts=tuple(op.col_starts), nrows=op.nrows, ncols=op.ncols)
    if kind == "EllMatrix":
        csr = _csr(*_ell_entries(op.vals, op.cols), shape)
    elif kind == "SegmentedEllMatrix":
        # the segments hold the rows in width order; row_inv maps each
        # original row to its position in their concatenation
        pos = np.argsort(np.asarray(op.row_inv))
        rows, cols, vals, base = [], [], [], 0
        for seg_vals, seg_cols in op.segs:
            r, c, v = _ell_entries(seg_vals, seg_cols)
            rows.append(pos[base + r])
            cols.append(c)
            vals.append(v)
            base += seg_vals.shape[0]
        csr = _csr(np.concatenate(rows), np.concatenate(cols),
                   np.concatenate(vals), shape)
    elif kind == "RoutedEllMatrix":
        # its values stay bfloat16 where JAX stores them so (exact there)
        bf16 = _plane_dtype(op.v, dtype) == torch.bfloat16
        return CsrMatrix.from_scipy(op.to_scipy(), dtype, device,
                                    allow_bf16="always" if bf16 else False)
    else:
        raise TypeError(f"no port counterpart for a JAX {kind}")
    return CsrMatrix.from_scipy(csr, dtype, device)


def problem_from_jax_arrays(jprob, dtype=None, device="cpu") -> LPProblem:
    """The port's LPProblem with the JAX problem's arrays and operators
    (DIA planes in one storage dtype, :func:`~..problem.one_plane_storage`)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)

    def vec(v):
        return None if v is None else torch.as_tensor(_np(v), dtype=dt,
                                                      device=dev)

    a_eq, a_ineq = one_plane_storage([operator_from_jax(jprob.a_eq, dt, dev),
                                      operator_from_jax(jprob.a_ineq, dt,
                                                        dev)])
    return LPProblem(
        c=vec(jprob.c), lb=vec(jprob.lb), ub=vec(jprob.ub),
        a_eq=a_eq, b_eq=vec(jprob.b_eq), a_ineq=a_ineq,
        b_lower=vec(jprob.b_lower), b_upper=vec(jprob.b_upper),
        n=int(jprob.n), m_eq=int(jprob.m_eq), m_ineq=int(jprob.m_ineq))


def _to_tensors(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_tensors(v, dtype, device) for v in tree)
    return torch.as_tensor(_np(tree), dtype=dtype, device=device)


def state_from_numpy(state, rstate=None, dtype=None, device="cpu"):
    """``(x, x3, y_eq, y_ineq)`` (and, if given, the restart controller's
    ``rstate`` dict: ``state``, ``omega``, ``mu_restart``, ``mu_last``,
    ``zx``, ``zeq``, ``zineq``) as tensors.  Returns the state tuple, or
    ``(state, rstate)`` when ``rstate`` is given."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)
    st = _to_tensors(tuple(state), dt, dev)
    if rstate is None:
        return st
    return st, _to_tensors(dict(rstate), dt, dev)


def state_to_numpy(tree):
    """float64 numpy copy of a state tuple / rstate dict of tensors."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(state_to_numpy(v) for v in tree)
    return tree.detach().to(device="cpu", dtype=torch.float64).numpy()


def sharded_from_jax(data, state, ndev, rank, dtype=None, device="cpu",
                     layout="cp", **kw):
    """Rank ``rank`` of an ``ndev``-rank mesh: the port's shard of a JAX
    sharded solver's data and state, read as numpy arrays with the JAX
    mesh axis first.  ``layout`` names the solver: ``"cp"`` (below),
    ``"ipm"`` (:func:`_ipm_from_jax`), ``"admm"``
    (:func:`_admm_from_jax`), ``"dca"`` (:func:`_dca_from_jax`) or
    ``"blocks"`` (:func:`_blocks_from_jax`) or ``"position"``
    (:func:`_position_from_jax`); ``kw`` goes to the layout's function.

    ``"cp"``: the port's ``(data, state)`` (as
    ``parallel.sharded_cp.build_sharded_cp_data`` returns them) for the JAX
    package's ``build_sharded_cp_data(..., operator="dia")`` data and its
    (possibly advanced) state.

    The JAX shard height is rounded up to 128 rows and its values padded
    to the TPU kernel's layout; the port's shard height is ``ceil(m /
    ndev)``.  So each system's padding is stripped, its shards joined and
    its rows split again, and so are its ``sigma`` and the sharded duals
    ``y_eq``/``y_ineq``: a JAX sharded state resumes in the port."""
    from ..parallel.sharded_cp import local_rows, place_shard
    from ..parallel.sharded_dia import shard_planes

    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)
    if layout != "cp":
        convert = {"ipm": _ipm_from_jax, "admm": _admm_from_jax,
                   "dca": _dca_from_jax, "blocks": _blocks_from_jax,
                   "position": _position_from_jax}[layout]
        return convert(data, state, ndev, rank, dt, dev, **kw)
    n = np.asarray(data["c"]).size
    systems, ys = {}, {}
    for name in ("eq", "ineq"):
        if name not in data:
            continue
        sys_j = data[name]
        if "dia_vals" not in sys_j:
            raise TypeError("sharded_from_jax carries the per-shard DIA "
                            "layout (operator='dia') only")
        m = int(data[name + "_m"])
        ndev_j, rows_j = np.asarray(sys_j["b"]).shape
        offs_j = np.asarray(sys_j["dia_offs"], np.int64)
        ndiag = offs_j.shape[1]
        vals = np.concatenate(
            [_np(sys_j["dia_vals"][d])[:ndiag, :rows_j]
             for d in range(ndev_j)], axis=1)[:, :m]
        # shard 0 starts at row 0, so its offsets are the global ones
        sys_, rows_loc, m_pad = shard_planes(
            offs_j[0], vals, _np(sys_j["b"]).reshape(-1)[:m], n, ndev, rank)
        sys_ = dict(sys_, m=m, m_pad=m_pad, rows_loc=rows_loc)
        systems[name] = dict(sys_, sigma=local_rows(
            _np(sys_j["sigma"]).reshape(-1)[:m], sys_, rank))
        ys[name] = local_rows(_np(state["y_" + name]).reshape(-1)[:m], sys_,
                              rank)
    return place_shard(data["c"], data["lb"], data["ub"], data["diag_t"],
                       data["theta"], systems, _np(state["x"]),
                       _np(state["x3"]), ys, dt, dev)


def _position_from_jax(data, state, ndev, rank, dtype, device):
    """``layout="position"``: the JAX ``build_position_sharded`` data and
    its (possibly advanced) state, arrays stacked over the JAX shards in
    the padded window layout (``(ndev, (nw_l + 2)·wq, 128)``, value planes
    tiled per window with ``hq`` halo rows), as the port's rank ``rank``
    of ``ndev`` holds them (``parallel.sharded_cp_windowed.
    place_position_shard``): each vector and plane is read back to its
    global positions from the shards' interior windows, then cut again."""
    from ..parallel.sharded_cp_windowed import (halo_plan,
                                                place_position_shard)

    wq, hq, _gq, nw_l = (int(v) for v in data["plan"])
    n, m, m_eq = int(data["n"]), int(data["m"]), int(data["m_eq"])
    has_eq = bool(data["has_eq"])

    def vec(stacked, size):
        """JAX's ``_unshard_vec``: the interior windows, concatenated."""
        return _np(stacked)[:, wq:(nw_l + 1) * wq, :].reshape(-1)[:size]

    def planes(tiles, size):
        """(ndev, nw_l, ndiag, qc, 128) window tiles -> (ndiag, size):
        rows ``hq:hq + wq`` of tile (s, j) are window ``s·nw_l + j``."""
        t = _np(tiles)[:, :, :, hq:hq + wq, :]
        return np.moveaxis(t, 2, 0).reshape(t.shape[2], -1)[:, :size]

    def dia(vt_tiles, v_tiles, offsets, offsets_t, rows):
        return dict(offsets=tuple(int(o) for o in offsets),
                    vals=planes(v_tiles, rows),
                    offsets_t=tuple(int(o) for o in offsets_t),
                    vals_t=planes(vt_tiles, n),
                    plane_dtype=_plane_dtype(v_tiles, torch.float32))

    consts, tiles = data["consts"], data["planes"]
    glob = dict(n=n, m=m, m_eq=m_eq, theta=float(data["theta"]),
                dia=dia(tiles[0], tiles[1], data["offsets"],
                        data["offsets_t"], m),
                dia_eq=(dia(tiles[2], tiles[3], data["eq_offsets"],
                            data["eq_offsets_t"], m_eq) if has_eq else None),
                c=vec(consts[0], n), diag_t=vec(consts[1], n),
                lb=vec(consts[2], n), ub=vec(consts[3], n),
                sigma_ineq=vec(consts[4], m), b_ineq=vec(consts[5], m),
                x=vec(state["x"], n), x3=vec(state["x3"], n),
                y_ineq=vec(state["y_ineq"], m))
    if has_eq:
        glob.update(sigma_eq=vec(consts[6], m_eq), beq=vec(consts[7], m_eq),
                    y_eq=vec(state["y_eq"], m_eq))
    # the halos of these planes (one rank's plan: any count has them)
    glob["plan"] = halo_plan([glob["dia"], glob["dia_eq"]], n, m, m_eq, 1)
    return place_position_shard(glob, ndev, rank, dtype, device)


def _tile_shards_csr(tiles, cols, rows_loc, n):
    """The CSR of the rows ``rows_loc`` a shard of JAX block-ELL tiles
    (``tiles[d, r, k][t, m] = A_d[r·tm + m, cols[d, r, k]·tn + t]``,
    ``parallel/sharded_admm.py``) hold, the shards stacked in order."""
    tiles, cols = _np(tiles), np.asarray(cols, np.int64)
    ndev, _, _, tn, tm = tiles.shape
    flat = np.flatnonzero(tiles)
    d, r, k, t, m = np.unravel_index(flat, tiles.shape)
    row = r * tm + m
    keep = row < rows_loc
    return _csr((d * rows_loc + row)[keep],
                (cols[d, r, k] * tn + t)[keep], tiles.ravel()[flat][keep],
                (ndev * rows_loc, n))


def _ipm_from_jax(data, state, ndev, rank, dtype, device, n,
                  dense_threshold=4096):
    """``layout="ipm"``: the JAX ``build_sharded_ipm_data`` column blocks
    (dense ``a`` or the ELL tables ``ell_vals`` / ``ell_cols``) and the
    iterate ``(x, y, s)`` (x and s column-sharded) of a standard form with
    ``n`` columns, as the port's rank ``rank`` of ``ndev`` holds them
    (``parallel.sharded_mehrotra.build_ipm_shard``): ``(data, n_loc,
    use_dense, (x, y, s))``, or without ``state`` the first three."""
    from ..parallel.sharded_mehrotra import build_ipm_shard

    b = _np(data["b"])
    c_j = _np(data["c"])
    n_loc_j = c_j.shape[1]
    if "a" in data:
        a = np.concatenate(list(_np(data["a"])), axis=1)[:, :n]
        a = scipy.sparse.csr_matrix(a)
    else:
        vals, cols = _np(data["ell_vals"]), np.asarray(data["ell_cols"],
                                                       np.int64)
        d, r, k = np.nonzero(vals)
        a = _csr(r, d * n_loc_j + cols[d, r, k], vals[d, r, k],
                 (b.size, c_j.size))[:, :n]
    out = build_ipm_shard(a, b, c_j.reshape(-1)[:n], ndev, rank, dtype,
                          device, dense_threshold)
    if state is None:
        return out
    n_loc = out[1]

    def cols_of(v):
        full = np.zeros(n_loc * ndev)
        full[:n] = _np(v).reshape(-1)[:n]
        return torch.as_tensor(full[rank * n_loc:(rank + 1) * n_loc],
                               dtype=dtype, device=device)

    x, y, s = state
    return out + ((cols_of(x), torch.as_tensor(_np(y), dtype=dtype,
                                               device=device), cols_of(s)),)


def _admm_from_jax(data, state, ndev, rank, dtype, device, m, n):
    """``layout="admm"``: the JAX ``sharded_admm.build_sharded_system``
    data (its rows' block-ELL ``tiles`` / ``cols``, ``b``) of an ``m × n``
    system, and ``state`` None or the row-sharded ``lam`` of
    ``admm_chunk_sharded``, as the port's rank ``rank`` of ``ndev`` holds
    them (``parallel.sharded_admm.build_sharded_system``, CSR shards):
    ``(sys_l, rows_loc, lam)``."""
    from ..parallel.sharded_cp import _host_system, local_rows, place_system

    rows_j = np.asarray(data["b"]).shape[1]
    a = _tile_shards_csr(data["tiles"], data["cols"], rows_j, n)[:m]
    b = _np(data["b"]).reshape(-1)[:m]
    sys_ = _host_system(a, b, "tiles", ndev, rank)
    sys_l = place_system(sys_, dtype, device, keys=("b", "row_mask"))
    lam = None
    if state is not None:
        lam = torch.as_tensor(local_rows(_np(state).reshape(-1)[:m], sys_,
                                         rank), dtype=dtype, device=device)
    return sys_l, sys_["rows_loc"], lam


def _dca_from_jax(data, state, ndev, rank, dtype, device, m):
    """``layout="dca"``: the JAX ``sharded_dca.pad_groups`` colour groups
    (each ``(ndev_jax, rg_loc)``, dummy id ``m``) as the port's colour
    groups: a list of row-id arrays, the dummies dropped (pass it to
    ``parallel.sharded_dca.shard_groups`` with the port's mesh).  The
    groups are the same on every rank; ``state`` is not read."""
    del state, ndev, rank, dtype, device
    groups = []
    for g in data:
        g = np.asarray(g).reshape(-1)
        groups.append(g[g < m].astype(np.int64))
    return groups


def _blocks_from_jax(data, state, ndev, rank, dtype, device, nb_blocks):
    """``layout="blocks"``: the JAX ``admm_blocks`` block batch padded for
    its mesh (``sub_a``, ``ids``, ``row_mask``, ``col_mask``, ``beq_pad``,
    the real block count ``nb_blocks`` first) and its state ``(x_b,
    lam_b, xp)``, padded again for ``ndev`` port ranks
    (``solvers.admm_blocks._pad_blocks_to``), rank ``rank``'s blocks:
    ``(blocks, (x_b, lam_b, xp))`` with ``blocks`` numpy and the state
    tensors (``xp`` whole)."""
    from ..solvers.admm_blocks import _pad_blocks_to

    keys = ("sub_a", "ids", "row_mask", "col_mask", "beq_pad")
    blocks = {k: np.asarray(data[k])[:nb_blocks] for k in keys}
    blocks["nb_blocks"] = nb_blocks
    nb_loc = -(-nb_blocks // ndev)
    blocks = _pad_blocks_to(blocks, nb_loc * ndev)
    mine = slice(rank * nb_loc, (rank + 1) * nb_loc)
    blocks.update({k: blocks[k][mine] for k in keys})
    if state is None:
        return blocks, None
    x_b, lam_b, xp = (_np(v) for v in state)

    def rows(v):
        v = np.concatenate([v[:nb_blocks], np.zeros(
            (nb_loc * ndev - nb_blocks,) + v.shape[1:])])
        return torch.as_tensor(v[mine], dtype=dtype, device=device)

    return blocks, (rows(x_b), rows(lam_b),
                    torch.as_tensor(xp, dtype=dtype, device=device))


def key_from_jax(key):
    """The port's key pair ``(k1, k2)`` from a raw JAX PRNG key (any array
    of its two uint32 words)."""
    k1, k2 = (int(v) & 0xFFFFFFFF for v in np.asarray(key).reshape(-1))
    return (k1, k2)


def key_to_jax(key):
    """The port's key pair as the raw JAX key's uint32 words (numpy; pass
    it to ``jnp.asarray``)."""
    return np.asarray(key, dtype=np.uint32)


def ell_rows_from_jax(ell, dtype=None, device="cpu"):
    """The padded row view of a JAX ``EllMatrix`` (its ``vals`` / ``cols``
    tables, padding slots included), as the coordinate sweep walks it."""
    from ..ops.dca_sweep import EllRows

    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)
    return EllRows.from_tables(_np(ell.vals), np.asarray(ell.cols),
                               ell.ncols, dt, dev)
