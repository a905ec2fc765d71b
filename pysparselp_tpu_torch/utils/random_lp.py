# Verbatim copy of pysparselp_tpu/utils/random_lp.py
"""Random feasible sparse-LP generator (reference ``pysparselp/randomLP.py``).

Generates LPs with a known interior feasible point: draw x*, build sparse
A_ineq / A_eq with ≥ 2 nnz per row, choose right-hand sides so x* stays
feasible, and box bounds straddling x*.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse

from ..modeling import SparseLP


def rand_sparse(shape, sparsity, rng=None):
    rng = rng or np.random
    if isinstance(shape, (tuple, list)):
        return (
            np.round(rng.randn(*shape) * 100) * (rng.rand(*shape) < sparsity) / 100
        )
    return np.round(rng.randn(shape) * 100) * (rng.rand(shape) < sparsity) / 100


def generate_random_lp(nbvar, n_eq, n_ineq, sparsity, seed=None):
    """Returns ``(lp, feasible_x)`` (mirrors ``randomLP.py:29-75``)."""
    if seed is not None:
        np.random.seed(seed)
    feasible_x = rand_sparse(nbvar, sparsity=1)

    a_ineq = None
    if n_ineq > 0:
        while True:
            a_ineq = scipy.sparse.csr_matrix(rand_sparse((n_ineq, nbvar), sparsity))
            keep = ((a_ineq != 0) @ np.ones(nbvar)) >= 2
            if np.sum(keep) >= 1:
                break
        bmin = a_ineq @ feasible_x
        b_upper = np.ceil((bmin + abs(rand_sparse(n_ineq, sparsity))) * 1000) / 1000
        b_lower = None
        a_ineq = a_ineq[keep, :]
        b_upper = b_upper[keep]

    costs = rand_sparse(nbvar, sparsity=1)
    t = rand_sparse(nbvar, sparsity=1)
    lower_bounds = feasible_x + np.minimum(0, t)
    upper_bounds = feasible_x + np.maximum(0, t)

    lp = SparseLP()
    lp.add_variables_array(
        nbvar, lower_bounds=lower_bounds, upper_bounds=upper_bounds, costs=costs
    )
    if n_eq > 0:
        a_eq = scipy.sparse.csr_matrix(rand_sparse((n_eq, nbvar), sparsity))
        b_eq = a_eq @ feasible_x
        keep = ((a_eq != 0) @ np.ones(nbvar)) >= 2
        a_eq = a_eq[keep, :]
        b_eq = b_eq[keep]
        if a_eq.nnz > 0:
            lp.add_equality_constraints_sparse(a_eq, b_eq)
    if n_ineq > 0 and a_ineq.nnz > 0:
        lp.add_inequality_constraints_sparse(a_ineq, b_lower, b_upper)

    assert lp.check_solution(feasible_x)
    return lp, feasible_x
