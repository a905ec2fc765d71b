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
  writing rank computed;
* everything between the groups (the active sets, the c̄ rebuilds, the
  primal guess, the metrics) is the one-device solver's code on
  replicated data.

Communication per outer iteration: 2·#colours psums per constraint
system.  A group's ties are drawn at its whole size and each rank takes
its slice (the colour step's ``tie_offset``), so every rank count draws
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


def _written_cols(csr, rows):
    """The columns the rows ``rows`` of ``csr`` write in c̄: their entries
    with a nonzero value.  A zero-valued slot (padding, or a stored zero)
    adds ±0, which changes an entry only from -0 to +0; the merge keeps
    the entry's old bits there, so a mesh sweep departs from the
    one-device sweep only where c̄ holds -0 at such a column."""
    sub = csr[rows]
    return np.unique(sub.indices[sub.data != 0])


def shard_groups(groups, a, mesh):
    """Each colour group (row ids) split over the mesh as :func:`pad_groups`
    splits it, as this rank needs it on ``mesh.device``: ``rows`` (its
    slice, int32), ``offset`` (its first tie), and the int64 index tensors
    of the y rows and c̄ columns it writes (``my_rows``, ``my_cols``) and
    that the whole group writes (``all_rows``, ``all_cols``)."""
    mesh = check_mesh(mesh)
    csr = scipy.sparse.csr_matrix(a)
    m = csr.shape[0]
    dev = mesh.device

    def idx(v, dtype=torch.int64):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)

    out = []
    for g, padded in zip(groups, pad_groups(groups, mesh.size, m)):
        mine = padded[mesh.rank]
        mine = mine[mine < m]
        out.append(dict(
            rows=idx(mine, torch.int32),
            offset=mesh.rank * padded.shape[1],
            my_rows=idx(mine), my_cols=idx(_written_cols(csr, mine)),
            all_rows=idx(np.asarray(g)),
            all_cols=idx(_written_cols(csr, np.asarray(g)))))
    return tuple(out)


def _merge(mesh, old, new, mine, written):
    """``old`` with the entries ``written`` (over all ranks) set to the
    values the writing rank holds in its ``new`` (at ``mine``): one psum of
    the bit patterns."""
    ints = _BITS[old.dtype]
    bits = torch.zeros(old.shape, dtype=ints, device=old.device)
    bits[mine] = new.view(ints)[mine]
    bits = mesh.psum(bits)
    out = old.clone()
    out.view(ints)[written] = bits[written]
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
        y = _merge(mesh, y, y_r, g["my_rows"], g["all_rows"])
        c_bar = _merge(mesh, c_bar, c_r, g["my_cols"], g["all_cols"])
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
