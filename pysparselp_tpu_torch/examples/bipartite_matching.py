# Verbatim copy of pysparselp_tpu/examples/bipartite_matching.py
"""Maximum-weight bipartite matching LP relaxation.

Reference: ``pysparselp/examples/example_bipartite_matching.py`` — the
matching polytope of a bipartite graph is integral, so the LP relaxation is
exact.
"""

from __future__ import annotations

import numpy as np

from ..modeling import SparseLP


def add_bipartite_constraint(lp, indices):
    columns = indices
    values = np.ones(columns.shape)
    lp.add_inequality_constraints(columns, values, lower_bounds=-np.inf,
                                  upper_bounds=1)
    columns = indices.T
    values = np.ones(columns.shape)
    lp.add_inequality_constraints(columns, values, lower_bounds=-np.inf,
                                  upper_bounds=1)


def run(display=False, n=50, seed=2):
    """Solves a random assignment LP with several methods; returns per-method
    final costs (``example_bipartite_matching.py:17-45``)."""
    np.random.seed(seed)
    cost = -np.random.rand(n, n)
    lp = SparseLP()
    indices = lp.add_variables_array(cost.shape, 0, 1, cost)
    add_bipartite_constraint(lp, indices)

    results = {}
    for method, nb_iter in (
        ("mehrotra", 50),
        ("dual_coordinate_ascent", 200),
        ("chambolle_pock_ppd", 20000),
    ):
        s = lp.solve(method=method, nb_iter=nb_iter, max_time=40,
                     nb_iter_plot=max(1, nb_iter // 4))[0]
        results[method] = float(lp.costsvector.dot(s))
        if display:  # pragma: no cover
            print(f"{method} final cost: {results[method]}")
    return results


if __name__ == "__main__":
    run(display=True)
