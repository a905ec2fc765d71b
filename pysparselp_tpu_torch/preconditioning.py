# Verbatim copy of pysparselp_tpu/preconditioning.py
"""Host-side problem preconditioning and standard-form conversion.

Equivalents of the reference's ``pysparselp/tools.py:88-311`` free functions,
operating on scipy CSR matrices that may carry a ``blocks`` attribute (list of
half-open row ranges).  These run once at solver-setup time on the host; the
results are what gets lowered to the device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse


def _get_blocks(a, default_whole=True):
    blocks = getattr(a, "blocks", None)
    if blocks is None:
        return [(0, a.shape[0])] if default_whole and a.shape[0] else []
    # normalize reference-style inclusive ends defensively: we always store
    # half-open ranges, produced by BlockedCSR
    return list(blocks)


def precondition_constraints(a, b, b2=None, alpha=2):
    """Row-scale constraints by 1/(Σ_j |a_ij|^alpha)^(1/alpha)
    (``tools.py:272-290``); preserves block structure."""
    blocks = _get_blocks(a)  # before re-wrapping (csr_matrix() drops attrs)
    a = scipy.sparse.csr_matrix(a)
    abs_pow = np.abs(a.data) ** alpha
    sums = np.add.reduceat(
        np.concatenate((abs_pow, [0.0])),
        np.minimum(a.indptr[:-1], abs_pow.size),
    ) * (np.diff(a.indptr) > 0)
    tmp = sums ** (1.0 / alpha)
    tmp[tmp == 0] = 1.0
    d = 1.0 / tmp
    sigma = scipy.sparse.diags(d).tocsr()
    a_p = (sigma @ a).tocsr()
    a_p.blocks = blocks
    bp = d * b if b is not None else None
    if b2 is None:
        return a_p, bp
    return a_p, bp, d * b2


def precondition_lp_right(c, a_eq, beq, lb, ub, x0, alpha=2):
    """Column-scale the LP by 1/(Σ_i |a_ij|^alpha)^(1/alpha)
    (``tools.py:293-311``); returns ``(r, c2, a_eq2, b_eq2, lb2, ub2, x02)``
    with ``x = r @ x'``."""
    a_eq = scipy.sparse.csr_matrix(a_eq)
    csc = a_eq.tocsc()
    abs_pow = np.abs(csc.data) ** alpha
    sums = np.add.reduceat(
        np.concatenate((abs_pow, [0.0])),
        np.minimum(csc.indptr[:-1], abs_pow.size),
    ) * (np.diff(csc.indptr) > 0)
    tmp = sums ** (1.0 / alpha)
    tmp[tmp == 0] = 1.0
    diag_r = 1.0 / tmp
    r = scipy.sparse.diags(diag_r).tocsr()
    a_eq2 = (a_eq @ r).tocsr()
    a_eq2.blocks = _get_blocks(a_eq)
    return r, c @ r, a_eq2, beq, tmp * lb, tmp * ub, tmp * x0


def convert_to_standard_form_with_bounds(c, a_eq, beq, a_ineq, b_lower, b_upper,
                                         lb, ub, x0):
    """Fold two-sided inequalities into equalities via bounded slack variables
    (``tools.py:88-127``): returns ``(c2, a_eq2, b_eq2, lb2, ub2, x02)`` where
    ``a_eq2`` carries merged block metadata.
    """
    if a_ineq is None:
        a = scipy.sparse.csr_matrix(a_eq)
        a.blocks = _get_blocks(a_eq)
        return c, a, beq, lb, ub, x0
    ineq_blocks = _get_blocks(a_ineq)  # before re-wrapping (csr_matrix() drops attrs)
    a_ineq = scipy.sparse.csr_matrix(a_ineq)
    ni = a_ineq.shape[0]
    if a_eq is not None:
        eq_blocks = _get_blocks(a_eq)
        a_eq = scipy.sparse.csr_matrix(a_eq)
        m_e = a_eq.shape[0]
        a_eq2 = scipy.sparse.bmat(
            [
                [a_eq, None],
                [a_ineq, -scipy.sparse.eye(ni)],
            ]
        ).tocsr()
        a_eq2.blocks = eq_blocks + [
            (b0 + m_e, b1 + m_e) for (b0, b1) in ineq_blocks
        ]
        b_eq2 = np.concatenate((beq, np.zeros(ni)))
    else:
        a_eq2 = scipy.sparse.hstack(
            (a_ineq, -scipy.sparse.eye(ni))
        ).tocsr()
        a_eq2.blocks = ineq_blocks
        b_eq2 = np.zeros(ni)

    if b_lower is None:
        b_lower = np.full(ni, -np.inf)
    if b_upper is None:
        b_upper = np.full(ni, np.inf)
    lb2 = np.concatenate((lb, b_lower))
    ub2 = np.concatenate((ub, b_upper))
    x02 = np.concatenate((x0, a_ineq @ x0))
    c2 = np.concatenate((c, np.zeros(ni)))
    return c2, a_eq2, b_eq2, lb2, ub2, x02
