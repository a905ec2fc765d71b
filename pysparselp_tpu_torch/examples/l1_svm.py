# Verbatim copy of pysparselp_tpu/examples/l1_svm.py
"""L1-regularized multi-class SVM as an LP.

Reference: ``pysparselp/examples/example_l1_svm.py`` (Zhu, Rosset, Hastie,
Tibshirani, "1-norm support vector machines", NIPS 2004).

Provenance: the problem construction is transcribed from the reference
example so its accuracy constants stay meaningful as fixtures
(``tests/test_examples.py``); the solver stack underneath is original.
"""

from __future__ import annotations

import numpy as np

from ..modeling import SparseLP, solving_methods


class L1SVM(SparseLP):
    """L1-regularized multi-class SVM (``example_l1_svm.py:10-88``)."""

    def add_abs_penalization(self, indices, coef_penalization):
        indices = np.asarray(indices)
        aux = self.add_variables_array(indices.size, upper_bounds=None,
                                       lower_bounds=0)
        self.set_costs_variables(
            aux, np.full(aux.shape, float(np.mean(coef_penalization)))
            if np.isscalar(coef_penalization)
            else np.asarray(coef_penalization, float).ravel()
        )
        cols = np.column_stack((indices.ravel(), aux.ravel()))
        vals = np.tile(np.array([1.0, -1.0]), [indices.size, 1])
        self.add_inequality_constraints(cols, vals, lower_bounds=None,
                                        upper_bounds=0)
        vals = np.tile(np.array([-1.0, -1.0]), [indices.size, 1])
        self.add_inequality_constraints(cols, vals, lower_bounds=None,
                                        upper_bounds=0)

    def set_data(self, x, classes, nb_classes=None):
        nb_examples = x.shape[0]
        xh = np.hstack((x, np.ones((nb_examples, 1))))
        assert x.shape[0] == len(classes)
        if nb_classes is None:
            nb_classes = int(np.max(classes)) + 1
        nb_features = x.shape[1]

        self.weights_indices = self.add_variables_array(
            (nb_classes, nb_features + 1), None, None
        )
        self.add_abs_penalization(self.weights_indices, 1)
        self.epsilons_indices = self.add_variables_array(
            (nb_examples, 1), upper_bounds=None, lower_bounds=0, costs=1
        )
        e = np.ones((nb_examples, nb_classes))
        e[np.arange(nb_examples), classes] = 0

        cols1 = self.weights_indices[classes, :]
        vals1 = xh
        for k in range(nb_classes):
            keep = classes != k
            cols2 = np.tile(self.weights_indices[[k], :], [nb_examples, 1])
            vals2 = -xh
            vals3 = np.ones(self.epsilons_indices.shape)
            cols3 = self.epsilons_indices
            vals = np.column_stack((vals1, vals2, vals3))
            cols = np.column_stack((cols1, cols2, cols3))
            self.add_inequality_constraints(
                cols[keep, :], vals[keep, :], lower_bounds=e[keep, k],
                upper_bounds=None,
            )

    def train(self, method="chambolle_pock_ppd", nb_iter=2000, **kwargs):
        sol, _elapsed = self.solve(method=method, nb_iter=nb_iter,
                                   max_time=np.inf, **kwargs)
        self.weights = sol[self.weights_indices]
        marges = sol[self.epsilons_indices]
        self.active_set = np.nonzero(marges > 1e-3)[0]

    def classify(self, x):
        xh = np.hstack((x, np.ones((x.shape[0], 1))))
        scores = xh @ self.weights.T
        return np.argmax(scores, axis=1)


def make_data(nb_examples=1000, nb_classes=3, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(nb_examples, 2)
    xh = np.hstack((x, np.ones((nb_examples, 1))))
    weights = rng.randn(nb_classes, 2)
    weights = weights / np.sum(weights**2, axis=1)[:, None]
    weights = np.hstack((weights, -0.5 * np.sum(weights, axis=1)[:, None]))
    classes = np.argmax((weights @ xh.T).T, axis=1)
    return x, classes


def run(display=False, methods=None, nb_iter=2000):
    """Train with each solver; returns per-method classification accuracy (%)
    (the reference's test contract, ``example_l1_svm.py:91-137``)."""
    x, classes = make_data()
    svm = L1SVM()
    svm.set_data(x, classes)
    if methods is None:
        methods = [
            m for m in solving_methods
            if m not in (
                "mehrotra", "scipy_simplex", "scipy_interior_point",
                "dual_gradient_ascent", "dual_coordinate_ascent",
            )
        ]
    percent_valid = {}
    for method in methods:
        svm.train(method=method, nb_iter=nb_iter, nb_iter_plot=max(1, nb_iter))
        classes2 = svm.classify(x)
        percent_valid[method] = 100.0 * float(np.mean(classes == classes2))
    if display:  # pragma: no cover
        print(percent_valid)
    return percent_valid


if __name__ == "__main__":
    print(run(display=True))
