"""Plain reference of the binary Potts segmentation LP.

Built from the upstream example ``pysparselp/examples/example_pott_segmentation.py``
(lines 12-92): one variable per pixel in [0, 1] with cost ``unary / coef_mul``,
and for every 4-neighbour pair (i, j) an auxiliary variable a in [0, 1] with
cost ``round(coef_potts * coef_mul) / coef_mul`` and the two rows
``x_i - x_j - a <= 0`` and ``-x_i + x_j - a <= 0``.  Variables are the pixels
(row-major), then the horizontal pairs' auxiliaries, then the vertical ones;
rows are the horizontal pairs' first rows, their second rows, then the
vertical pairs' first and second rows.  That is the order in which the
modeling API's ``ImageLP.add_pott_model`` numbers them, so a solution vector
of the system under test is read here index for index.

Three plain pieces, in NumPy, SciPy and PyTorch only:

* :class:`PottsLP`: the matrices, costs and bounds, and the evaluation of a
  solution (cost, worst constraint or bound violation);
* :func:`graph_cut_energy`: the exact optimum of the LP, which is tight for
  the binary model (the upstream example's ground truth), as an integer
  minimum cut by ``scipy.sparse.csgraph.maximum_flow``;
* :func:`cp_run`: diagonally preconditioned Chambolle-Pock iterations
  (Pock & Chambolle, ICCV 2011; ``pysparselp/ChambollePockPPD.py:122-315``,
  alpha = 1, theta = 1) on a batch of cost vectors, in any torch dtype and
  on any device, with the upstream chunk metrics after each chunk.

Nothing here imports the system under test.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import torch
from scipy.sparse.csgraph import breadth_first_order, maximum_flow


def _pairs(height, width):
    ids = np.arange(height * width).reshape(height, width)
    first = np.concatenate([ids[:, 1:].ravel(), ids[1:, :].ravel()])
    second = np.concatenate([ids[:, :-1].ravel(), ids[:-1, :].ravel()])
    n_h = height * (width - 1)
    return first, second, n_h


def lp_dims(height, width):
    """``(nnz, n, m)`` of the LP of an image: 3 nonzeros a row, a column a
    pixel and a pair, two rows a pair."""
    pairs = height * (width - 1) + (height - 1) * width
    return 6 * pairs, height * width + pairs, 2 * pairs


class PottsLP:
    """The LP of one image shape; per-frame data enters through the costs.

    ``unary`` is an integer image (``round(coef_mul * U(-1, 1))``) or a batch
    of them ``(B, H, W)``."""

    def __init__(self, height, width, coef_potts, coef_mul):
        self.height, self.width = height, width
        self.coef_mul = coef_mul
        self.w_int = int(round(coef_potts * coef_mul))
        self.n_pix = height * width
        a, b, n_h = _pairs(height, width)
        self.pair_a, self.pair_b = a, b
        n_pairs = a.size
        self.n = self.n_pix + n_pairs
        aux = self.n_pix + np.arange(n_pairs)
        blocks = []
        for lo, hi in ((0, n_h), (n_h, n_pairs)):
            for sign in (1.0, -1.0):
                k = hi - lo
                cols = np.stack([a[lo:hi], b[lo:hi], aux[lo:hi]], axis=1)
                vals = np.tile([sign, -sign, -1.0], (k, 1))
                blocks.append((cols, vals))
        self.cols = np.concatenate([c for c, _ in blocks])
        self.vals = np.concatenate([v for _, v in blocks])
        self.m = self.cols.shape[0]
        self.matrix = scipy.sparse.csr_matrix(
            (self.vals.ravel(), self.cols.ravel(),
             np.arange(0, 3 * self.m + 1, 3)), shape=(self.m, self.n))
        self.lb = np.zeros(self.n)
        self.ub = np.ones(self.n)
        self.b = np.zeros(self.m)

    def costs(self, unary):
        """``(n,)`` or ``(B, n)`` cost vectors of integer unary images."""
        unary = np.asarray(unary, np.float64)
        lead = unary.shape[:-2]
        c = np.empty(lead + (self.n,))
        c[..., :self.n_pix] = unary.reshape(lead + (self.n_pix,)) / self.coef_mul
        c[..., self.n_pix:] = self.w_int / self.coef_mul
        return c

    def evaluate(self, x, unary):
        """``(cost, violation)`` of solution(s) ``x`` in float64: the cost
        ``c . x`` and the worst of the row residuals ``A x - b`` and the
        bound excesses, at least 0."""
        x = np.atleast_2d(np.asarray(x, np.float64))
        c = np.atleast_2d(self.costs(unary))
        cost = np.einsum("bn,bn->b", c, x)
        resid = (self.matrix @ x.T).T - self.b
        viol = np.maximum.reduce([
            resid.max(axis=1), (self.lb - x).max(axis=1),
            (x - self.ub).max(axis=1), np.zeros(x.shape[0])])
        return cost, viol


def graph_cut_energy(lp: PottsLP, unary):
    """The exact optimum ``min c . x`` of the LP for one integer image, by
    an integer minimum s-t cut on the 4-connected grid: the LP relaxation of
    the binary Potts model is tight, so the optimum is attained at the
    cut's labelling.  Returns ``(energy, labels)``."""
    u = np.asarray(unary, np.int64).ravel()
    n = lp.n_pix
    src, sink = n, n + 1
    pos, neg = np.nonzero(u > 0)[0], np.nonzero(u < 0)[0]
    a, b = lp.pair_a, lp.pair_b
    rows = np.concatenate([pos, np.full(neg.size, src), a, b])
    cols = np.concatenate([np.full(pos.size, sink), neg, b, a])
    caps = np.concatenate([u[pos], -u[neg],
                           np.full(2 * a.size, lp.w_int)]).astype(np.int32)
    graph = scipy.sparse.csr_matrix((caps, (rows, cols)), shape=(n + 2, n + 2))
    flow = maximum_flow(graph, src, sink)
    residual = graph - flow.flow
    residual.data = np.maximum(residual.data, 0)
    residual.eliminate_zeros()
    reach = breadth_first_order(residual, src, directed=True,
                                return_predecessors=False)
    labels = np.zeros(n)
    labels[reach[reach < n]] = 1.0
    energy_int = u @ labels + lp.w_int * np.abs(labels[a] - labels[b]).sum()
    return float(energy_int) / lp.coef_mul, labels


def max_residual(lp: PottsLP, x):
    """The worst row residual ``max(A x - b)`` of one solution, unclipped
    (the quantity a solver reports as its worst inequality violation)."""
    return float((lp.matrix @ np.asarray(x, np.float64) - lp.b).max())


def bound_excess(lp: PottsLP, x):
    """How far solution(s) ``x`` leave the box ``[lb, ub]`` (0 inside)."""
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    return float(max(np.max(lp.lb[:n] - x), np.max(x - lp.ub[:n]), 0.0))


def pixel_energy(lp: PottsLP, pixels, unary):
    """The Potts energy ``(u . x + w sum |x_i - x_j|) / coef_mul`` of relaxed
    pixel labels: the LP's cost with every auxiliary at its best value
    ``|x_i - x_j|``, so it is at least the optimum for labels in [0, 1]."""
    p = np.asarray(pixels, np.float64).ravel()
    u = np.asarray(unary, np.float64).ravel()
    e = u @ p + lp.w_int * np.abs(p[lp.pair_a] - p[lp.pair_b]).sum()
    return float(e) / lp.coef_mul


class _Ell:
    """Rows of a sparse matrix padded to one width: ``(rows, k)`` column
    indices and values (padding: column 0, value 0)."""

    def __init__(self, csr, dtype, device):
        csr = scipy.sparse.csr_matrix(csr)
        counts = np.diff(csr.indptr)
        k = max(int(counts.max(initial=0)), 1)
        rows = csr.shape[0]
        slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], counts)
        row = np.repeat(np.arange(rows), counts)
        idx = np.zeros((rows, k), np.int64)
        val = np.zeros((rows, k))
        idx[row, slot] = csr.indices
        val[row, slot] = csr.data
        self.rows, self.k = rows, k
        self.idx = torch.as_tensor(idx.ravel(), device=device)
        self.val = torch.as_tensor(val[:, :, None], dtype=dtype, device=device)

    def apply(self, v):
        """``M @ v`` for ``v`` of shape ``(cols, B)``."""
        g = torch.index_select(v, 0, self.idx).view(self.rows, self.k, -1)
        return (self.val * g).sum(dim=1)


class CpState:
    """Chambolle-Pock state for a batch: ``x`` ``(n, B)``, ``y`` ``(m, B)``,
    updated in place (so that a run of steps can be captured in a CUDA
    graph and replayed)."""

    UNROLL = 100

    def __init__(self, lp: PottsLP, unary, dtype, device):
        self.dtype, self.device = dtype, torch.device(device)
        c = np.atleast_2d(lp.costs(unary)).T
        a = lp.matrix
        t = 1.0 / np.maximum(np.asarray(abs(a).sum(axis=0)).ravel(), 1e-300)
        s = 1.0 / np.maximum(np.asarray(abs(a).sum(axis=1)).ravel(), 1e-300)

        def vec(v):
            return torch.as_tensor(np.ascontiguousarray(v), dtype=dtype,
                                   device=device)

        self.a = _Ell(a, dtype, device)
        self.at = _Ell(a.T.tocsr(), dtype, device)
        self.c = vec(c)
        self.lb = vec(lp.lb[:, None])
        self.ub = vec(lp.ub[:, None])
        self.b = vec(lp.b[:, None])
        self.t = vec(t[:, None])
        self.s = vec(s[:, None])
        bsz = c.shape[1]
        self.x = torch.zeros((lp.n, bsz), dtype=dtype, device=device)
        self.y = torch.zeros((lp.m, bsz), dtype=dtype, device=device)
        self._graph = None

    def step(self):
        d = self.c + self.at.apply(self.y)
        x2 = torch.minimum(torch.maximum(self.x - self.t * d, self.lb),
                           self.ub)
        x3 = 2.0 * x2 - self.x
        self.x.copy_(x2)
        self.y.copy_(torch.clamp_min(
            self.y + self.s * (self.a.apply(x3) - self.b), 0.0))

    def steps(self, k):
        """``k`` steps; on a GPU, runs of :attr:`UNROLL` steps replay one
        captured CUDA graph (the same operations, launched at once)."""
        if self.device.type != "cuda" or k < 2 * self.UNROLL:
            for _ in range(k):
                self.step()
            return
        if self._graph is None:
            for _ in range(3):          # warm-up steps, counted in k
                self.step()
            k -= 3
            torch.cuda.synchronize()
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph):
                for _ in range(self.UNROLL):
                    self.step()
        reps, rest = divmod(k, self.UNROLL)
        for _ in range(reps):
            self._graph.replay()
        for _ in range(rest):
            self.step()

    def metrics(self):
        """The chunk metrics of ``ChambollePockPPD.py:242-315`` per column,
        as float64 numpy arrays: the primal energy ``c.x + y.(Ax - b)``,
        the dual bound ``c.x4 + y.(A x4 - b)`` at the box minimiser x4 of
        the reduced costs, and the worst row residual of x."""
        d = self.c + self.at.apply(self.y)
        x4 = torch.where(d < 0, self.ub, self.lb)
        r = self.a.apply(self.x) - self.b
        e1 = (self.c * self.x).sum(0) + (self.y * r).sum(0)
        e2 = (self.c * x4).sum(0) + (self.y * (self.a.apply(x4) - self.b)).sum(0)
        viol = r.max(dim=0).values
        return {k: v.to(torch.float64).cpu().numpy()
                for k, v in (("energy1", e1), ("energy2", e2),
                             ("viol", viol))}


def cp_run(lp: PottsLP, unary, iterations, dtype=torch.float64,
           device="cpu", chunk=None, stop_tol=None):
    """Run ``iterations`` Chambolle-Pock iterations from zero, a chunk of
    ``chunk`` (default: all) at a time, on the batch of integer images
    ``unary``.  With ``stop_tol`` a column stops (its state frozen, as a
    separate solve would end) after the first chunk whose worst residual
    and relative gap ``|e1 - e2| / (1 + |e1| + |e2|)`` are both below it.
    Returns ``(x, curves)``: ``x`` ``(B, n)`` float64 and, per chunk, the
    iteration count and the metrics of :meth:`CpState.metrics`."""
    st = CpState(lp, unary, dtype, device)
    chunk = chunk or iterations
    done = 0
    curves = {"itrn": [], "energy1": [], "energy2": [], "viol": []}
    active = None
    while done < iterations:
        k = min(chunk, iterations - done)
        x_prev, y_prev = st.x.clone(), st.y.clone()
        st.steps(k)
        if active is not None:
            keep = torch.as_tensor(active, device=device)[None, :]
            st.x.copy_(torch.where(keep, st.x, x_prev))
            st.y.copy_(torch.where(keep, st.y, y_prev))
        done += k
        met = st.metrics()
        curves["itrn"].append(done)
        for key, v in met.items():
            curves[key].append(v)
        if stop_tol is not None:
            gap = np.abs(met["energy1"] - met["energy2"]) / (
                1.0 + np.abs(met["energy1"]) + np.abs(met["energy2"]))
            conv = (met["viol"] < stop_tol) & (gap < stop_tol)
            active = ~conv if active is None else active & ~conv
            if not active.any():
                break
    x = st.x.to(torch.float64).cpu().numpy().T
    return np.ascontiguousarray(x), {k: np.asarray(v) for k, v in
                                     curves.items()}
