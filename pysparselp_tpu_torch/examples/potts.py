# Copy of the model builders of pysparselp_tpu/examples/potts.py (ImageLP,
# graph_cut_segmentation, build_linear_program,
# build_multilabel_linear_program; tests/test_torch_slice.py holds them
# equal), its batched serving demo, solve_batch_segmentation, and its
# every-method driver, run (verbatim; tests/test_torch_examples.py holds
# its source equal).
"""Potts image-model LP relaxation, with an exact graph-cut oracle.

Reference: ``pysparselp/examples/example_pott_segmentation.py`` — a binary
Potts segmentation whose LP relaxation is tight, so the exact combinatorial
optimum (min-cut) is the ground truth for solver convergence curves.

The reference uses PyMaxflow for the oracle; here the min-cut is computed
with ``scipy.sparse.csgraph.maximum_flow`` (integer capacities, standard
s/t-graph construction) and the source-side partition is recovered by BFS on
the residual graph — no external dependency.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
from scipy.sparse.csgraph import breadth_first_order, maximum_flow

from ..modeling import SparseLP, solving_methods


class ImageLP(SparseLP):
    """LP relaxations of Potts image models
    (``example_pott_segmentation.py:12-51``)."""

    def add_penalized_differences(self, ids1, ids2, coef_penalization):
        """Add |x[ids1] − x[ids2]| terms to the objective via aux variables."""
        ids1 = np.asarray(ids1)
        ids2 = np.asarray(ids2)
        assert ids1.size == ids2.size
        max_diff = np.maximum(
            self.upper_bounds[ids1] - self.lower_bounds[ids2],
            self.upper_bounds[ids2] - self.lower_bounds[ids1],
        )
        aux = self.add_variables_array(
            ids1.shape, upper_bounds=max_diff, lower_bounds=0,
            costs=coef_penalization,
        )
        if np.isscalar(coef_penalization):
            assert coef_penalization > 0
        else:
            assert np.asarray(coef_penalization).shape == aux.shape
            assert np.min(coef_penalization) >= 0
        cols = np.column_stack((ids1.ravel(), ids2.ravel(), aux.ravel()))
        vals = np.tile(np.array([1.0, -1.0, -1.0]), [ids1.size, 1])
        self.add_inequality_constraints(cols, vals, lower_bounds=None,
                                        upper_bounds=0)
        vals = np.tile(np.array([-1.0, 1.0, -1.0]), [ids1.size, 1])
        self.add_inequality_constraints(cols, vals, lower_bounds=None,
                                        upper_bounds=0)

    def add_pott_horizontal(self, indices, coef_penalization):
        self.add_penalized_differences(
            indices[:, 1:], indices[:, :-1], coef_penalization
        )

    def add_pott_vertical(self, indices, coef_penalization):
        self.add_penalized_differences(
            indices[1:, :], indices[:-1, :], coef_penalization
        )

    def add_pott_model(self, indices, coef_penalization):
        self.add_pott_horizontal(indices, coef_penalization)
        self.add_pott_vertical(indices, coef_penalization)


def graph_cut_segmentation(unary, pairwise_weight):
    """Exact minimizer of E(x) = Σ u_i x_i + w Σ_{i~j} |x_i − x_j|, x ∈ {0,1}
    on a 4-connected grid, via integer max-flow/min-cut.

    ``unary`` must be integer-valued (scale and round first, like the
    reference's ``coef_mul`` trick, ``example_pott_segmentation.py:62-66``).
    """
    h, w = unary.shape
    n = h * w
    idx = np.arange(n).reshape(h, w)
    source, sink = n, n + 1

    rows, cols, caps = [], [], []

    def add_edge(i, j, cap):
        if cap > 0:
            rows.append(i)
            cols.append(j)
            caps.append(int(cap))

    u = np.asarray(unary)
    for i in range(n):
        ui = u.ravel()[i]
        # x_i = 1 (source side) pays u_i⁺; x_i = 0 pays u_i⁻
        add_edge(i, sink, max(ui, 0))
        add_edge(source, i, max(-ui, 0))
    wint = int(pairwise_weight)
    for a, b in (
        (idx[:, 1:].ravel(), idx[:, :-1].ravel()),
        (idx[1:, :].ravel(), idx[:-1, :].ravel()),
    ):
        for i, j in zip(a, b):
            add_edge(i, j, wint)
            add_edge(j, i, wint)

    g = scipy.sparse.csr_matrix(
        (caps, (rows, cols)), shape=(n + 2, n + 2), dtype=np.int32
    )
    res = maximum_flow(g, source, sink)
    residual = g - res.flow
    residual.data = np.maximum(residual.data, 0)
    residual.eliminate_zeros()
    reachable = breadth_first_order(
        residual, source, directed=True, return_predecessors=False
    )
    x = np.zeros(n, dtype=np.int64)
    x[reachable[reachable < n]] = 1
    return x.reshape(h, w)


def build_linear_program(image_size, coef_potts, coef_mul, seed=1):
    """Potts LP + exact ground truth (``example_pott_segmentation.py:54-92``)."""
    nb_labels = 1
    rng = np.random.RandomState(seed)
    size_image = (image_size, image_size, nb_labels)
    unary_terms = np.round(coef_mul * (rng.rand(*size_image) * 2 - 1))
    coef_potts_int = round(coef_potts * coef_mul)

    gt = graph_cut_segmentation(unary_terms[:, :, 0], coef_potts_int)
    ground_truth = gt[:, :, None]

    lp = ImageLP()
    indices = lp.add_variables_array(
        shape=size_image, lower_bounds=0, upper_bounds=1,
        costs=unary_terms / coef_mul,
    )
    lp.add_pott_model(indices[:, :, 0], coef_potts_int / coef_mul)
    return lp, ground_truth, indices, unary_terms


def build_multilabel_linear_program(image_size, n_labels=4, coef_potts=0.5,
                                    coef_mul=500, seed=1):
    """K-label Potts LP: the standard relaxation with per-pixel simplex
    EQUALITIES (``sum_k x[i,j,k] = 1``) plus per-label penalized
    differences.  The binary model (:func:`build_linear_program`,
    ``example_pott_segmentation.py:54-92``) is the tight K=1 special case;
    the multi-label form is the canonical equality+inequality grid LP —
    the bench's eq-system windowed-kernel workload.

    Returns ``(lp, indices)``; ``indices`` has shape
    ``(image_size, image_size, n_labels)``."""
    rng = np.random.RandomState(seed)
    size_image = (image_size, image_size, n_labels)
    unary_terms = np.round(coef_mul * (rng.rand(*size_image) * 2 - 1))

    lp = ImageLP()
    indices = lp.add_variables_array(
        shape=size_image, lower_bounds=0, upper_bounds=1,
        costs=unary_terms / coef_mul,
    )
    # per-pixel label simplex: one equality row over the K label copies
    cols = indices.reshape(-1, n_labels)
    lp.add_equality_constraints(cols, np.ones_like(cols, np.float64),
                                b=np.ones(cols.shape[0]))
    coef = round(coef_potts * coef_mul) / coef_mul
    for k in range(n_labels):
        lp.add_pott_model(indices[:, :, k], coef)
    return lp, indices


def solve_batch_segmentation(images, coef_potts, nb_iter=20_000,
                             **solve_kwargs):
    """Segment a BATCH of same-sized images in one batched solve (the
    port's ``pysparselp_tpu/examples/potts.py::solve_batch_segmentation``).

    The Potts LP's constraint matrix and pairwise costs depend only on
    the grid shape and ``coef_potts`` — per-frame data enters solely
    through the unary entries of the cost vector.  Build the LP once for
    the first frame, batch the cost vector over frames, and run the
    whole stack through :func:`pysparselp_tpu_torch.solve_cp_batch` (the
    serving pattern: one batched CP loop for the stream; ``device`` and
    ``dtype`` go to it with the other keyword arguments).  The reference
    would re-solve each frame from scratch
    (``example_pott_segmentation.py:54-92`` has no batched path).

    Returns ``(segmentations, info)``: ``(B, H, W)`` relaxed label maps
    (threshold at 0.5 for the binary labeling) and the batched-solver
    info dict."""
    from ..batch import solve_cp_batch

    imgs = np.asarray(images, np.float64)
    if imgs.ndim != 3:
        raise ValueError(f"images must be (B, H, W), got {imgs.shape}")
    bsz = imgs.shape[0]

    lp = ImageLP()
    indices = lp.add_variables_array(
        shape=imgs[0].shape + (1,), lower_bounds=0, upper_bounds=1,
        costs=imgs[0][:, :, None],
    )
    lp.add_pott_model(indices[:, :, 0], coef_potts)

    flat = indices[:, :, 0].ravel()
    costs = np.broadcast_to(lp.costsvector, (bsz, lp.nb_variables)).copy()
    costs[:, flat] = imgs.reshape(bsz, -1)
    x, info = solve_cp_batch(lp, costs=costs, nb_iter=nb_iter,
                             **solve_kwargs)
    return x[:, flat].reshape(imgs.shape), info


def run(display=False, image_size=50, coef_mul=500, coef_potts=0.5,
        max_time=15, methods=None, nb_iter=1000000, nb_iter_plot=500):
    """Run all solvers on the Potts LP; returns per-method distance curves
    (the reference's test contract, ``example_pott_segmentation.py:95-187``)."""
    lp, ground_truth, indices, _unary = build_linear_program(
        image_size, coef_potts, coef_mul
    )
    if methods is None:
        methods = [
            m for m in solving_methods
            if m not in ("scipy_simplex", "scipy_interior_point")
        ]
    curves = {}
    for method in methods:
        sol, _elapsed = lp.solve(
            method=method, nb_iter=nb_iter, max_time=max_time,
            ground_truth=ground_truth, ground_truth_indices=indices,
            nb_iter_plot=nb_iter_plot,
        )
        curves[method] = list(lp.distance_to_ground_truth)
        if display:  # pragma: no cover
            import matplotlib.pyplot as plt

            plt.loglog(lp.itrn_curve, lp.distance_to_ground_truth,
                       label=method)
    if display:  # pragma: no cover
        import matplotlib.pyplot as plt

        plt.legend()
        plt.show()
    return curves


if __name__ == "__main__":
    run(display=True)
