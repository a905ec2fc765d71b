# Verbatim copy of pysparselp_tpu/examples/basis_pursuit_denoising.py
"""Basis-pursuit denoising as an LP.

Reference: ``pysparselp/examples/example_basis_pursuit_denoising.py`` —
min ‖y − M x‖₁ + λ‖x‖₁ via soft constraints.  (The reference example calls a
method that does not exist there, ``add_soft_linear_constraint_rows`` at
``example_basis_pursuit_denoising.py:28`` — this framework provides it as an
alias of ``add_soft_inequality_constraints``, so the example actually runs.)

Provenance: the BPDN model definition is transcribed from the reference
example (fixed as described above) to preserve the benchmark fixture; the
solver stack underneath is original.
"""

from __future__ import annotations

import numpy as np

from ..modeling import SparseLP


def run(display=False, method="chambolle_pock_ppd", nb_iter=20000, seed=0):
    """Returns ``(cost_gt, cost_opt)``; asserts the optimum beats the
    generating signal's cost."""
    rng = np.random.RandomState(seed)
    m, n = 20, 100
    mat = rng.randn(m, n)
    ratio_zeros = 0.9
    x = rng.randn(n) * (rng.rand(n) > ratio_zeros)
    noise = 0.05 * rng.laplace(size=m)
    y = mat.dot(x) + noise
    lambda_coef = 1.0

    cost_gt = np.sum(np.abs(y - mat.dot(x))) + lambda_coef * np.sum(np.abs(x))

    lp = SparseLP()
    x_id = lp.add_variables_array((n,), lower_bounds=None, upper_bounds=None)
    lp.add_soft_linear_constraint_rows(
        cols=np.tile(x_id[None, :], (m, 1)),
        vals=mat,
        lower_bounds=y,
        upper_bounds=y,
        coef_penalization=1,
    )
    lp.add_soft_linear_constraint_rows(
        cols=x_id[:, None],
        vals=np.ones((n, 1)),
        lower_bounds=0,
        upper_bounds=0,
        coef_penalization=lambda_coef,
    )

    sol, _duration = lp.solve(method, nb_iter=nb_iter,
                              nb_iter_plot=max(1, nb_iter // 4))
    x_opt = sol[x_id]
    cost_opt = np.sum(np.abs(y - mat.dot(x_opt))) + lambda_coef * np.sum(
        np.abs(x_opt)
    )
    if display:  # pragma: no cover
        print(f"cost gt = {cost_gt}  cost opt = {cost_opt}")
    assert cost_opt <= cost_gt + 1e-6
    return cost_gt, cost_opt


if __name__ == "__main__":
    run(display=True)
