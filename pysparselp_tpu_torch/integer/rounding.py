# Verbatim copy of pysparselp_tpu/integer/rounding.py
"""Greedy integer rounding via propagation + backtracking, and local search.

Host-side integerization tools (reference
``pysparselp/constraintPropagation.py:186-511``):

* ``greedy_round`` — DFS over variables in a given order: round a variable,
  propagate bound tightening (native C++ kernel), backtrack on
  infeasibility, flipping to the opposite value before stepping back.
* ``greedy_fix`` — bit-flip local search that descends the weighted
  constraint-violation score of a rounded solution.
"""

from __future__ import annotations

import copy

import numpy as np

from .propagation import propagate_constraints, revert


def greedy_round(x, lp, callback_func=None, maxiter=np.inf, order=None,
                 fixed=None, display_func=None):
    """Round ``x`` to integers keeping ``lp``'s constraints feasible.

    Returns ``(x_rounded, valid)``; semantics of
    ``constraintPropagation.py:186-342``.
    """
    if callback_func is not None:
        callback_func(0, np.round(x), 0, 0, 0, 0, 0)
    lp2 = copy.deepcopy(lp)
    lp2.convert_to_all_inequalities()
    assert lp2.a_equalities is None

    x_u = lp2.upper_bounds.copy()
    x_l = lp2.lower_bounds.copy()
    if fixed is not None:
        x_l[fixed] = x[fixed]
        x_u[fixed] = x[fixed]

    a_csr = lp2.a_inequalities.tocsr()
    a_csc = a_csr.tocsc()
    b_l = lp2.b_lower.copy()
    b_u = lp2.b_upper.copy()

    if order is None:
        order = np.argsort(lp2.costsvector * (2 * np.round(x) - 1))

    x_r = x.copy()
    mask = np.zeros(x.size, dtype=np.int32)
    depth = 0
    nb_backtrack = 0

    valid, _ = propagate_constraints(
        np.arange(a_csr.shape[1]), x_l, x_u, a_csr, a_csc, b_l, b_u, []
    )
    if valid == 0:
        return x_r, 0

    back_ops: list[list] = [[] for _ in range(x.size)]
    niter = 0
    while 0 <= depth < x.size:
        niter += 1
        if niter > maxiter:
            break
        id_var = order[depth]

        if mask[id_var] == 2:
            # both values tried at this depth: unwind one level
            mask[id_var] = 0
            revert(back_ops[depth], x_l, x_u)
            depth -= 1
            if depth >= 0:
                revert(back_ops[depth], x_l, x_u)
            continue

        if x_u[id_var] == x_l[id_var]:
            # already fixed by propagation
            back_ops[depth] = []
            x_r[id_var] = x_u[id_var]
            mask[id_var] = 2
            depth += 1
            continue

        if mask[id_var] == 0:
            x_r[id_var] = np.round(x[id_var])
            mask[id_var] = 1
        else:  # mask == 1: try the flipped value
            x_r[id_var] = 1 - round(x[id_var])
            mask[id_var] = 2

        ops = [(1, int(id_var), float(x_u[id_var])),
               (0, int(id_var), float(x_l[id_var]))]
        back_ops[depth] = ops
        x_u[id_var] = x_r[id_var]
        x_l[id_var] = x_r[id_var]

        valid, _ = propagate_constraints(
            [id_var], x_l, x_u, a_csr, a_csc, b_l, b_u, ops
        )
        fixed_now = x_l == x_u
        x_r[fixed_now] = x_l[fixed_now]
        if display_func is not None:
            display_func(x_r)
        if valid:
            depth += 1
        else:
            revert(ops, x_l, x_u)
            if mask[id_var] == 2:
                mask[id_var] = 0
                depth -= 1
                nb_backtrack += 1
                if depth >= 0:
                    revert(back_ops[depth], x_l, x_u)

    valid, _ = propagate_constraints(
        np.arange(a_csr.shape[1]), x_l, x_u, a_csr, a_csc, b_l, b_u, []
    )
    return x_r, valid


def greedy_fix(x, lp, nb_max_iter=1000, callback_func=None,
               use_xor_moves=False):
    """Local search decreasing the weighted violation score of ``round(x)``
    (``constraintPropagation.py:345-511``).

    Constraints named ``"xors"`` get weight 1000 like the reference.  With
    ``use_xor_moves=True``, 4-variable one-hot reassignment moves on the
    ``"xors"`` constraint rows (set one variable of the group to 1 and the
    others to 0 in a single step, ``constraintPropagation.py:389-410``)
    compete with single bit flips each iteration — these escape local minima
    where every single flip breaks the xor constraint it touches.  (The
    reference computes these move scores but never applies them; here the
    moves actually run.)
    """
    xr = np.round(x)
    lp2 = copy.deepcopy(lp)
    lp2.convert_to_all_inequalities()
    lp2.convert_to_one_sided_inequality_system()
    assert np.all(xr <= lp2.upper_bounds)
    assert np.all(xr >= lp2.lower_bounds)

    a = lp2.a_inequalities.tocsr()
    a_csc = a.tocsc()
    m = a.shape[0]
    constraints_costs = np.ones(m)
    for item in lp2.find_inequality_constraints_from_name("xors"):
        constraints_costs[item["start"]: item["end"] + 1] = 1000

    r_ineq = a @ xr - lp2.b_upper
    r_thr = np.maximum(r_ineq, 0)
    score = float(r_thr @ constraints_costs)

    # 4-variable groups of the "xors" constraint rows (deduplicated: the
    # one-sided conversion emits each row twice, once per direction)
    xor_groups = []
    if use_xor_moves:
        seen = set()
        for item in lp2.find_inequality_constraints_from_name("xors"):
            for r in range(item["start"], item["end"] + 1):
                ids = a.indices[a.indptr[r]: a.indptr[r + 1]]
                if ids.size != 4:
                    continue
                key = tuple(sorted(int(i) for i in ids))
                if key not in seen:
                    seen.add(key)
                    xor_groups.append(np.asarray(key))

    def _multi_move_decrease(ids, delta):
        """Score change of ``xr[ids] += delta`` (rows deduplicated)."""
        rows_l, ch_l = [], []
        for i, dv in zip(ids, delta):
            if dv == 0:
                continue
            sl = slice(a_csc.indptr[i], a_csc.indptr[i + 1])
            rows_l.append(a_csc.indices[sl])
            ch_l.append(a_csc.data[sl] * dv)
        if not rows_l:
            return 0.0, None, None
        rows_u, inv = np.unique(np.concatenate(rows_l), return_inverse=True)
        ch = np.zeros(rows_u.size)
        np.add.at(ch, inv, np.concatenate(ch_l))
        new_r = r_ineq[rows_u] + ch
        dec = float(
            (np.maximum(new_r, 0) - r_thr[rows_u]) @ constraints_costs[rows_u]
        )
        return dec, rows_u, ch

    for _ in range(nb_max_iter):
        # score change of flipping each candidate bit
        dx = 1 - 2 * xr  # flip direction per variable
        # candidates: variables touching a violated constraint
        violated_rows = np.nonzero(r_thr > 0)[0]
        if violated_rows.size == 0:
            break
        cand = np.unique(
            np.concatenate(
                [a.indices[a.indptr[j]: a.indptr[j + 1]] for j in violated_rows]
            )
        )
        best_dec, best_move = 0.0, None
        for i in cand:
            rows = a_csc.indices[a_csc.indptr[i]: a_csc.indptr[i + 1]]
            vals = a_csc.data[a_csc.indptr[i]: a_csc.indptr[i + 1]]
            new_r = r_ineq[rows] + vals * dx[i]
            dec = float(
                (np.maximum(new_r, 0) - r_thr[rows]) @ constraints_costs[rows]
            )
            if dec < best_dec:
                best_dec = dec
                best_move = (np.asarray([i]), np.asarray([dx[i]]), rows,
                             vals * dx[i])
        for ids in xor_groups:
            cur = xr[ids]
            for k in range(4):
                delta = -cur.copy()
                delta[k] += 1.0
                if not np.any(delta):
                    continue  # already this one-hot assignment
                dec, rows_u, ch = _multi_move_decrease(ids, delta)
                if rows_u is not None and dec < best_dec:
                    best_dec = dec
                    best_move = (ids, delta, rows_u, ch)
        if best_move is None:
            break
        ids, delta, rows_u, ch = best_move
        r_ineq[rows_u] += ch
        r_thr[rows_u] = np.maximum(r_ineq[rows_u], 0)
        xr[ids] += delta
        score += best_dec
        if callback_func is not None:
            callback_func(0, xr, 0, 0, 0, 0, 0)
    return xr
