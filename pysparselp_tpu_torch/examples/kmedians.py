# Verbatim copy of pysparselp_tpu/examples/kmedians.py
"""K-medians clustering LP relaxation.

Reference: ``pysparselp/examples/example_kmedians.py`` (formulation after the
facility-location LP relaxation of k-median).

Provenance: the LP formulation block and data generation are transcribed
from the reference example (``example_kmedians.py:24-44,68-75``) so the
benchmark stays bit-identical — ``tests/test_examples.py`` asserts the
reference's exact cost constant, which requires the same problem instance.
The solver stack underneath is original.
"""

from __future__ import annotations

import numpy as np

from ..modeling import SparseLP


def clustering(points, k, n_center_candidates, method="admm", nb_iter=1000,
               seed=None):
    """(``example_kmedians.py:17-66``) — returns ``(labels, cost)``."""
    n = points.shape[0]
    rng = np.random if seed is None else np.random.RandomState(seed)
    center_candidates = points[rng.choice(n, n_center_candidates), :]

    pairdistances = np.sqrt(
        np.sum((points[:, None, :] - center_candidates[None, :, :]) ** 2,
               axis=2)
    )

    lp = SparseLP()
    labeling = lp.add_variables_array(pairdistances.shape, 0, 1, pairdistances)
    used_as_center = lp.add_variables_array(n_center_candidates, 0, 1, 0)
    lp.add_inequality_constraints(
        used_as_center[None, :], np.ones((1, n_center_candidates)),
        lower_bounds=0, upper_bounds=k,
    )
    lp.add_inequality_constraints(
        labeling, np.ones((n, n_center_candidates)),
        lower_bounds=1, upper_bounds=1,
    )
    id_columns = np.ones((n, 1)).dot(used_as_center[None, :])
    columns = np.column_stack(
        (labeling.reshape(-1, 1), id_columns.reshape(-1, 1))
    ).astype(int)
    values = np.column_stack(
        (np.ones(n * n_center_candidates), -np.ones(n * n_center_candidates))
    )
    lp.add_inequality_constraints(columns, values, lower_bounds=None,
                                  upper_bounds=0)

    s = lp.solve(method=method, nb_iter=nb_iter, max_time=np.inf,
                 nb_iter_plot=max(1, nb_iter // 2))[0]
    x = s[labeling]
    label = np.argmax(x, axis=1)

    cost = 0.0
    for l in range(n_center_candidates):
        group = np.nonzero(label == l)
        if len(group[0]) == 0:
            continue
        center_id = np.argmin(np.sum(pairdistances[group, :], axis=1))
        cost += np.sum(pairdistances[group, center_id])
    return label, float(cost)


def run(display=False, method="admm", nb_iter=1000):
    """Returns the clustering cost (``example_kmedians.py:69-97``)."""
    np.random.seed(0)
    k = 5
    n = 500
    prng = np.random.RandomState(0)
    centers = prng.randn(k, 2)
    gt_labels = np.floor(prng.rand(n) * 5).astype(np.int64)
    points = 0.4 * prng.randn(n, 2) + centers[gt_labels, :]
    n_center_candidates = 50
    label, cost = clustering(points, k, n_center_candidates, method=method,
                             nb_iter=nb_iter)
    if display:  # pragma: no cover
        print("cost", cost)
    return cost


if __name__ == "__main__":
    run(display=True)
