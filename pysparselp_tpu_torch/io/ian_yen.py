# Verbatim copy of pysparselp_tpu/io/ian_yen.py
"""LPsparse (Ian E.H. Yen) text-format exporter.

Equivalent of the reference's ``SparseLP.save_ian_e_h_yen``
(``pysparselp/SparseLP.py:368-412``): dumps the LP as the six plain-text
files consumed by the LPsparse solver (github.com/ianyen/LPsparse):

* ``c`` — objective vector, one value per line;
* ``a_eq`` / ``beq`` — equality system in 1-based COO triplets, first line
  ``m n 0``;
* ``A`` / ``b`` — one-sided inequalities ``A x <= b`` (variable upper bounds
  are appended as explicit rows, since the format has no box bounds);
* ``meta`` — ``nb`` (variables), ``nf`` (free vars, always 0 here), ``mI``,
  ``mE`` counts.

Like the reference, the problem must first be converted to one-sided
inequalities and all variable lower bounds must be exactly 0 (the LPsparse
canonical form assumes x >= 0).
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse


def _write_coo(path, mat):
    """Write a matrix as 1-based COO triplets with an ``m n 0`` header line."""
    coo = mat.tocoo()
    with open(path, "w") as f:
        f.write("%d %d %f\n" % (coo.shape[0], coo.shape[1], 0.0))
        for r, c, v in zip(coo.row, coo.col, coo.data):
            f.write("%d %d %f\n" % (r + 1, c + 1, v))


def save_ian_e_h_yen(lp, folder):
    """Export ``lp`` to LPsparse text files in ``folder``.

    Raises ``ValueError`` for problems not in the expected canonical form
    (two-sided inequalities, or nonzero lower bounds), matching the
    reference's guard prints at ``SparseLP.py:369-376``.
    """
    if lp.b_lower is not None and lp.a_inequalities.shape[0] > 0 and not np.all(
        np.isinf(lp.b_lower) & (lp.b_lower < 0)
    ):
        raise ValueError(
            "b_lower is not None: convert the problem with "
            "convert_to_one_sided_inequality_system first"
        )
    if not np.all(lp.lower_bounds == 0):
        raise ValueError("lower bound constraints on variables should be 0")

    os.makedirs(folder, exist_ok=True)
    n = lp.nb_variables

    a_eq = lp.a_equalities.tocsr()
    _write_coo(os.path.join(folder, "a_eq"), a_eq)
    np.savetxt(os.path.join(folder, "beq"), np.asarray(lp.b_equalities), fmt="%f")
    np.savetxt(os.path.join(folder, "c"), np.asarray(lp.costsvector), fmt="%f")

    # upper bounds become explicit inequality rows x_i <= ub_i
    upper_bounded = np.nonzero(~np.isinf(lp.upper_bounds))[0]
    bound_rows = scipy.sparse.coo_matrix(
        (np.ones(len(upper_bounded)), (np.arange(len(upper_bounded)), upper_bounded)),
        (len(upper_bounded), n),
    )
    a_ineq = scipy.sparse.vstack((lp.a_inequalities.tocsr(), bound_rows)).tocoo()
    b_upper = np.hstack((np.asarray(lp.b_upper), lp.upper_bounds[upper_bounded]))
    _write_coo(os.path.join(folder, "A"), a_ineq)
    np.savetxt(os.path.join(folder, "b"), b_upper, fmt="%f")

    with open(os.path.join(folder, "meta"), "w") as f:
        f.write("nb\t%d\n" % n)
        f.write("nf\t%d\n" % 0)
        f.write("mI\t%d\n" % a_ineq.shape[0])
        f.write("mE\t%d\n" % a_eq.shape[0])
