"""Row-sharded blocked dual coordinate ascent over a :class:`~.mesh.Mesh`
(mirrors ``pysparselp_tpu/parallel/sharded_dca.py``).

The blocked mode of
:func:`~pysparselp_tpu_torch.solvers.dual_ascent.dual_coordinate_ascent`
(graph-coloured sweeps; the sequential mode is one chain through every
row's reduced-cost update and cannot be split).  Rows of one colour have
pairwise disjoint columns, so

* each colour group is split over the ranks (``ceil(size / ndev)`` rows
  a rank, :func:`pad_groups`'s split); each rank runs its slice on H-DCA's
  colour step (:func:`~pysparselp_tpu_torch.ops.dca_sweep.dca_color_step`)
  against the replicated reduced costs;
* the group's updates merge with two ``psum``s, of the y rows (an
  m-vector) and of the c̄ columns (an n-vector), each holding one rank's
  entries where that rank wrote and zeros elsewhere.  The entries travel
  as their bit patterns (int32 or int64 sums, exact whatever the order of
  the additions), so every rank takes each written entry with the bits the
  writing rank computed.  A rank writes every column its rows' slots
  touch, zero-valued ones too (a stored zero adds ±0, which turns a -0 to
  +0).  Column 0 alone may be touched on several ranks: every padding
  slot lies there.  One rank writes its bits (:func:`_column0`), and where
  others touch it too the c̄ psum carries one more word, their flags
  (:func:`_merge_cbar`), so no two ranks' bit patterns meet in a sum;
* everything between the groups (the active sets, the c̄ rebuilds, the
  primal guess, the metrics) is the one-device solver's code on
  replicated data.

Communication per outer iteration: 2·#colours psums per constraint
system (the c̄ psum of a group whose column 0 several ranks touch holds
n + 1 words).  A group's ties are drawn at its whole size and each rank
takes its slice (the colour step's ``tie_offset``), so every rank count draws
the one-device blocked sweep's ties, and a one-rank mesh is that sweep bit
for bit.
"""

from __future__ import annotations

import copy

import numpy as np
import scipy.sparse
import torch

from ..ops.dca_sweep import dca_color_step
from ..problem import resolve_dtype
from ..utils.jax_prng import split
from .mesh import check_mesh

_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}
# what the last dual_coordinate_ascent_sharded call on this process ran:
# the rank count, the variables and, per system, its rows and colours
last_run_info: dict | None = None


# pad_groups: verbatim copy of pysparselp_tpu/parallel/sharded_dca.py:45-55
def pad_groups(groups, ndev, m):
    """Pad each color's row-id array to an ndev multiple (dummy id = m)
    and reshape to (ndev, rg_loc)."""
    out = []
    for g in groups:
        g = np.asarray(g, np.int32)
        rg_loc = max(-(-g.size // ndev), 1)
        gp = np.full(ndev * rg_loc, m, np.int32)
        gp[:g.size] = g
        out.append(gp.reshape(ndev, rg_loc))
    return tuple(out)


def _written_cols(csr, rows, width):
    """The columns the rows ``rows`` of ``csr`` write in c̄: every stored
    entry's, zero-valued ones too, and column 0 where a row has fewer than
    ``width`` entries (its padding slots; ``EllRows``' width)."""
    sub = csr[rows]
    cols = sub.indices
    if (np.diff(sub.indptr) < width).any():
        cols = np.append(cols, 0)
    return np.unique(cols)


def _column0(csr, slices, width):
    """Which rank writes column 0's bits for a group split into
    ``slices`` (one row-id array a rank), and whether other ranks touch it
    too: ``(writer, shared)``.  The writer is the rank whose row stores an
    entry at column 0 (a group's rows share no stored column, so at most
    one), else the first rank whose rows have padding; ``writer`` is None
    where no rank touches column 0."""
    touch, owner = [], None
    for r, rows in enumerate(slices):
        sub = csr[rows]
        if (sub.indices == 0).any():
            owner = r
        if (sub.indices == 0).any() or (np.diff(sub.indptr) < width).any():
            touch.append(r)
    if not touch:
        return None, False
    return (owner if owner is not None else touch[0]), len(touch) > 1


def shard_groups(groups, a, mesh):
    """Each colour group (row ids) split over the mesh as :func:`pad_groups`
    splits it, as this rank needs it on ``mesh.device``: ``rows`` (its
    slice, int32), ``offset`` (its first tie), the int64 index tensors
    of the y rows and c̄ columns it writes (``my_rows``, ``my_cols``) and
    that the whole group writes (``all_rows``, ``all_cols``), and column
    0's merge: ``col0_shared`` (ranks other than its writer touch it) and
    ``col0_flag`` (this rank is one of them)."""
    mesh = check_mesh(mesh)
    csr = scipy.sparse.csr_matrix(a)
    m = csr.shape[0]
    width = max(int(np.diff(csr.indptr).max(initial=0)), 1)
    dev = mesh.device

    def idx(v, dtype=torch.int64):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)

    out = []
    for g, padded in zip(groups, pad_groups(groups, mesh.size, m)):
        slices = [p[p < m] for p in padded]
        mine = slices[mesh.rank]
        writer, shared = _column0(csr, slices, width)
        cols = _written_cols(csr, mine, width)
        if writer != mesh.rank:
            cols = cols[cols != 0]
        out.append(dict(
            rows=idx(mine, torch.int32),
            offset=mesh.rank * padded.shape[1],
            my_rows=idx(mine), my_cols=idx(cols),
            all_rows=idx(np.asarray(g)),
            all_cols=idx(_written_cols(csr, np.asarray(g), width)),
            col0_shared=shared,
            col0_flag=shared and writer != mesh.rank
            and 0 in _written_cols(csr, mine, width)))
    return tuple(out)


def _merge(mesh, old, new, mine, written, flags=None):
    """``old`` with the entries ``written`` (over all ranks) set to the
    values the writing rank holds in its ``new`` (at ``mine``): one psum of
    the bit patterns.  ``flags``: one more word in the psum (this rank's
    flag word, or 0), returned summed over the ranks."""
    ints = _BITS[old.dtype]
    n = old.shape[0]
    bits = torch.zeros(n + (flags is not None), dtype=ints, device=old.device)
    bits[mine] = new.view(ints)[mine]
    if flags is not None:
        bits[n] = flags
    bits = mesh.psum(bits)
    out = old.clone()
    out.view(ints)[written] = bits[written]
    return out, (bits[n] if flags is not None else None)


# a rank's column-0 flags: its padding turned c̄[0] from -0 to +0 (+1), or
# to NaN (+_NAN_FLAG); summed over at most _NAN_FLAG - 1 ranks
_NAN_FLAG = 1 << 16


def _merge_cbar(mesh, old, new, g):
    """c̄ after a group: :func:`_merge` of the columns, then column 0 as one
    device gives it where several ranks touch it.  Adding zeros is exact
    and order-free but for -0 + +0 = +0 and a NaN, and only the writer may
    add a nonzero there, so one device's c̄[0] is the writer's, made +0
    where it is -0 and another rank's padding added a +0, and NaN where
    another rank's padding gave a NaN (a NaN's bits are the arithmetic's
    own, as on the card)."""
    if not g["col0_shared"]:
        return _merge(mesh, old, new, g["my_cols"], g["all_cols"])[0]
    ints = _BITS[old.dtype]
    if g["col0_flag"]:
        o, w = old[0], new[0]
        pos = (o == 0) & torch.signbit(o) & (w == 0) & ~torch.signbit(w)
        nan = torch.isnan(w) & ~torch.isnan(o)
        flags = pos.to(ints) + nan.to(ints) * _NAN_FLAG
    else:
        flags = torch.zeros((), dtype=ints, device=old.device)
    out, flags = _merge(mesh, old, new, g["my_cols"], g["all_cols"], flags)
    x = out[0]
    x = torch.where((flags >= _NAN_FLAG) & ~torch.isnan(x),
                    torch.full_like(x, float("nan")), x)
    x = torch.where((flags % _NAN_FLAG > 0) & (x == 0) & torch.signbit(x),
                    torch.zeros_like(x), x)
    out[0] = x
    return out


def sharded_color_sweep(ell, b, active, y, c_bar, lb, ub, key, groups,
                        project, mesh):
    """The blocked sweep with each group split over the ranks: per group
    one split of the key, one colour step on this rank's slice and two
    psums; returns ``(y, c̄, key)``, replicated."""
    for g in groups:
        key, sub = split(key)
        y_r, c_r = dca_color_step(ell, b, active, y, c_bar, lb, ub,
                                  g["rows"], sub, project,
                                  tie_offset=g["offset"])
        y = _merge(mesh, y, y_r, g["my_rows"], g["all_rows"])[0]
        c_bar = _merge_cbar(mesh, c_bar, c_r, g)
    return y, c_bar, key


def dual_coordinate_ascent_sharded(
    x, lp, mesh, nb_max_iter=20, callback_func=None, y_eq=None,
    y_ineq=None, max_time=None, nb_iter_plot=1, dtype=None,
    start_time=None, seed=1, use_greedy_round=True,
):
    """Mesh-parallel blocked dual coordinate ascent; the one-device
    solver's contract (returns ``(x, y_eq, y_ineq)`` on every rank) and its
    loop (:func:`~pysparselp_tpu_torch.solvers.dual_ascent.dca_run`).
    ``mesh`` decides the device."""
    global last_run_info
    from ..solvers.dual_ascent import dca_run, dca_setup

    del x
    mesh = check_mesh(mesh)
    dtype = resolve_dtype(dtype, mesh.device)
    lp2 = copy.deepcopy(lp)
    lp2.convert_to_one_sided_inequality_system()
    data = dca_setup(lp2, dtype, mesh.device, "blocked", mesh=mesh)
    last_run_info = dict(ranks=mesh.size, n=int(data["c"].shape[0]), **{
        which: dict(rows=int(data[f"b_{which}"].shape[0]),
                    colours=len(data[f"{which}_groups"]))
        for which in ("eq", "ineq") if f"{which}_groups" in data})
    return dca_run(data, lp2, nb_max_iter, callback_func, y_eq, y_ineq,
                   max_time, nb_iter_plot, start_time, seed,
                   use_greedy_round)
