"""Sparse inverse covariance estimation as an LP (CLIME), the port's
counterpart of ``pysparselp_tpu/examples/sparse_inv_covariance.py``.

CLIME (Cai, Liu & Luo, JASA 2011) estimates a sparse precision matrix P
from an empirical covariance C by solving  min ‖P‖₁  s.t.  ‖C P − I‖_∞ ≤ λ,
modeled with a kron(C, I) constraint block and L1 penalization via
auxiliary variables.  With p features the LP has 2p² variables and, folded
one-sided, 4p² rows and 2p³ + 4p² nonzeros; the reverse Cuthill-McKee
layout presolve clusters the dense kron(C, I) block into tiles, so on the
card it lowers to the block-sparse backend (H-BSR).

``SparseInvCov`` is a verbatim copy of the JAX example's class (:17-33);
:func:`clime_lp` is the LP-building part of its ``run`` (:59-73) as a
function of the samples.  :func:`make_data` differs: the machine with the
card has no scikit-learn, so the sparse SPD precision that the JAX example
takes from ``sklearn.datasets.make_sparse_spd_matrix`` is built here with
numpy from a seed (:func:`sparse_precision`).
"""

from __future__ import annotations

import numpy as np
from scipy import linalg, sparse

from ..modeling import SparseLP


# SparseInvCov: verbatim copy of pysparselp_tpu/examples/sparse_inv_covariance.py:17-33
class SparseInvCov(SparseLP):
    """Models the sparse-inverse-covariance LP
    (``example_sparse_inv_covariance.py:14-35``)."""

    def add_abs_penalization(self, ids, coef_penalization):
        ids = np.asarray(ids)
        aux = self.add_variables_array(
            ids.shape, upper_bounds=None, lower_bounds=0,
            costs=coef_penalization,
        )
        cols = np.column_stack((ids.ravel(), aux.ravel()))
        vals = np.tile(np.array([1.0, -1.0]), [ids.size, 1])
        self.add_inequality_constraints(cols, vals, lower_bounds=None,
                                        upper_bounds=0)
        vals = np.tile(np.array([-1.0, -1.0]), [ids.size, 1])
        self.add_inequality_constraints(cols, vals, lower_bounds=None,
                                        upper_bounds=0)


def sparse_precision(n_features, rng):
    """A sparse symmetric positive definite precision matrix: ``LᵀL`` for a
    unit lower-triangular ``L`` (under a random symmetric permutation) whose
    off-diagonal entries are nonzero with probability 0.02, with magnitudes
    uniform in [0.4, 0.7] and random signs: the construction (and the JAX
    example's settings) of scikit-learn's ``make_sparse_spd_matrix``,
    written with numpy (it does not give scikit-learn's numbers)."""
    p = n_features
    aux = np.zeros((p, p))
    mask = np.tril(rng.uniform(size=(p, p)) > 0.98, k=-1)
    count = int(mask.sum())
    aux[mask] = rng.uniform(0.4, 0.7, count) * rng.choice([-1.0, 1.0], count)
    perm = rng.permutation(p)
    chol = np.eye(p) - aux[perm][:, perm]
    return chol.T @ chol


def make_data(n_samples=40, n_features=20, seed=1):
    """``(x, prec, cov)``: ``n_samples`` standardized draws from N(0, cov),
    ``cov`` the inverse of a :func:`sparse_precision` rescaled to a unit
    diagonal, and ``prec`` its inverse (the JAX example's ``make_data``
    with the precision built by numpy)."""
    prng = np.random.RandomState(seed)
    prec = sparse_precision(n_features, prng)
    cov = linalg.inv(prec)
    d = np.sqrt(np.diag(cov))
    cov /= d
    cov /= d[:, np.newaxis]
    prec *= d
    prec *= d[:, np.newaxis]
    x = prng.multivariate_normal(np.zeros(n_features), cov, size=n_samples)
    x -= x.mean(axis=0)
    x /= x.std(axis=0)
    return x, prec, cov


def clime_lp(x, lamb=0.15):
    """The CLIME LP of the samples ``x`` (n_samples × p), one-sided:
    ``(lp, ids)`` with ``ids`` the p × p variable indices of P."""
    n_features = x.shape[1]
    emp_cov = (x.T @ x) / x.shape[0]

    lp = SparseInvCov()
    ids = lp.add_variables_array(shape=emp_cov.shape, lower_bounds=None,
                                 upper_bounds=None)
    c = sparse.kron(sparse.csr_matrix(emp_cov), sparse.eye(n_features))
    lp.add_inequality_constraints_sparse(
        c,
        np.eye(emp_cov.shape[0]).flatten() - lamb,
        np.eye(emp_cov.shape[0]).flatten() + lamb,
    )
    lp.add_abs_penalization(ids, 1)
    lp.convert_to_one_sided_inequality_system()
    return lp, ids


def run(display=False, method="mehrotra", nb_iter=6000, lamb=0.15,
        device="cuda"):
    """Returns ``(sum_abs_diff, nb_zeros_lp)`` as the JAX example's ``run``,
    with its default method, the interior point."""
    x, prec, _cov = make_data()
    lp, ids = clime_lp(x, lamb)
    sol = lp.solve(method=method, nb_iter=nb_iter, max_time=np.inf,
                   nb_iter_plot=max(1, nb_iter // 4), device=device)[0]
    lp_prec = sol[ids]
    lp_prec = 0.5 * (lp_prec + lp_prec.T)
    lp_prec = lp_prec * (np.abs(lp_prec) > 1e-8)

    sum_abs_diff = float(np.sum(np.abs(lp_prec - prec)))
    nb_zeros_lp = int(np.sum(lp_prec == 0))
    if display:  # pragma: no cover
        print("sum_abs_diff", sum_abs_diff, "nb_zeros", nb_zeros_lp)
    return sum_abs_diff, nb_zeros_lp


if __name__ == "__main__":
    run(display=True)
