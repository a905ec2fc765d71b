# Copy of pysparselp_tpu/modeling.py; solve() gains ``device=`` and dispatches
# to this package's solvers (tests/test_torch_slice.py holds the two equal).
"""Host-side LP modeling layer: the :class:`SparseLP` class.

This is the TPU-native framework's equivalent of the reference modeling API
(``pysparselp/SparseLP.py:162-1383``): incremental construction of

    min  cᵀx   s.t.  A_e x = b_e,   b_lower ≤ A_i x ≤ b_upper,   l ≤ x ≤ u

with variable arrays, named groups, batched sparse constraints (equality,
two-sided inequality, soft/penalized via auto auxiliary variables), named
constraint ranges, solution checking and solver dispatch.

Design split (deliberately different from the reference): model construction
and form conversions are pure host numpy/scipy — dynamic shapes stay OFF the
device.  ``solve()`` lowers the finished model once into a statically-shaped,
padded, device-resident :class:`~pysparselp_tpu.problem.LPProblem` on which the
JAX solvers run as compiled loops.

All conversion methods return back-maps with the convention

    x_original = m_change @ x_new + shift

(the reference applies ``m_change*x - shift``, a latent sign bug that is
invisible in its tests because all fixed/shifted bounds there are 0 —
see ``pysparselp/SparseLP.py:1156-1157``).
"""

from __future__ import annotations

import copy
import time

import numpy as np
import scipy.sparse

from .sparse_host import BlockedCSR, crd_matrix

_BUILTIN_METHODS = (
    "mehrotra",
    "scipy_simplex",
    "scipy_interior_point",
    "dual_coordinate_ascent",
    "dual_gradient_ascent",
    "chambolle_pock_ppd",
    "admm",
    "admm2",
    "admm_blocks",
)

_OPTIONAL_METHODS = ()
try:  # pragma: no cover - optional dependency
    import osqp  # noqa: F401

    _OPTIONAL_METHODS += ("osqp",)
except Exception:
    pass
try:  # pragma: no cover - optional dependency
    import cvxpy

    _OPTIONAL_METHODS += ("ECOS", "SCS")
    # CVXOPT is only reachable when cvxpy actually has the backend
    # (mirrors the reference's per-solver probe, ``SparseLP.py:66-72``)
    if "CVXOPT" in cvxpy.installed_solvers():
        _OPTIONAL_METHODS += ("CVXOPT",)
except Exception:
    pass

solving_methods = _BUILTIN_METHODS + _OPTIONAL_METHODS


def _as_bound_array(shape, value, default):
    """Broadcast scalar/None bounds to a full array (``SparseLP.py:458-490``)."""
    if value is None:
        out = np.full(shape, default, dtype=np.float64)
    elif np.isscalar(value) or np.ndim(value) == 0:
        out = np.full(shape, float(value), dtype=np.float64)
    else:
        out = np.asarray(value, dtype=np.float64)
        if tuple(out.shape) != tuple(shape):
            raise ValueError(f"bounds shape {out.shape} does not match {shape}")
    return out


class SparseLP:
    """Incremental sparse-LP model (API parity with ``pysparselp/SparseLP.py:162``)."""

    def __init__(self):
        self.nb_variables = 0
        self.variables_dict: dict[str, np.ndarray] = {}
        self.upper_bounds = np.empty(0, dtype=np.float64)
        self.lower_bounds = np.empty(0, dtype=np.float64)
        self.costsvector = np.empty(0, dtype=np.float64)
        self.is_integer = np.empty(0, dtype=bool)
        self.a_inequalities = BlockedCSR(0)
        self.b_lower: np.ndarray | None = np.empty(0, dtype=np.float64)
        self.b_upper: np.ndarray | None = np.empty(0, dtype=np.float64)
        self.a_equalities = BlockedCSR(0)
        self.b_equalities = np.empty(0, dtype=np.float64)
        self.equality_constraint_names: list[dict] = []
        self.inequality_constraint_names: list[dict] = []
        self.solution = None  # optional known solution used for debug checking

    # ------------------------------------------------------------------
    # variables
    # ------------------------------------------------------------------

    def add_variables_array(
        self, shape, lower_bounds, upper_bounds, costs=0, name=None, is_integer=False
    ):
        """Add an array of variables; returns their index array (``SparseLP.py:421``)."""
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape),)
        shape = tuple(int(s) for s in shape)
        nb_added = int(np.prod(shape))
        indices = np.arange(nb_added).reshape(shape) + self.nb_variables
        self.nb_variables += nb_added

        self.a_inequalities.set_ncols(self.nb_variables)
        self.a_equalities.set_ncols(self.nb_variables)

        if np.isscalar(costs) or np.ndim(costs) == 0:
            costs = np.full(shape, float(costs), dtype=np.float64)
        else:
            costs = np.asarray(costs, dtype=np.float64)
            if tuple(costs.shape) != shape:
                raise ValueError("costs shape mismatch")

        lb = _as_bound_array(shape, lower_bounds, -np.inf)
        ub = _as_bound_array(shape, upper_bounds, np.inf)

        self.upper_bounds = np.append(self.upper_bounds, ub.ravel())
        self.lower_bounds = np.append(self.lower_bounds, lb.ravel())
        self.costsvector = np.append(self.costsvector, costs.ravel())
        if np.isscalar(is_integer) or np.ndim(is_integer) == 0:
            int_mask = np.full(nb_added, bool(is_integer))
        else:
            int_mask = np.asarray(is_integer, dtype=bool)
            if tuple(int_mask.shape) != shape:
                raise ValueError("is_integer shape mismatch")
            int_mask = int_mask.ravel()
        self.is_integer = np.append(self.is_integer, int_mask)
        if name:
            self.variables_dict[name] = indices
        return indices

    def convert_bounds_to_vectors(self, shape, lower_bounds, upper_bounds):
        return (
            _as_bound_array(shape, lower_bounds, -np.inf),
            _as_bound_array(shape, upper_bounds, np.inf),
        )

    def set_bounds_on_variables(self, indices, lower_bounds, upper_bounds):
        idx = np.asarray(indices).ravel()
        if np.isscalar(lower_bounds) or np.ndim(lower_bounds) == 0:
            self.lower_bounds[idx] = lower_bounds
        else:
            self.lower_bounds[idx] = np.asarray(lower_bounds).ravel()
        if np.isscalar(upper_bounds) or np.ndim(upper_bounds) == 0:
            self.upper_bounds[idx] = upper_bounds
        else:
            self.upper_bounds[idx] = np.asarray(upper_bounds).ravel()

    def get_variables_indices(self, name):
        """Indices of the variable group registered under ``name``."""
        return self.variables_dict[name]

    def set_costs_variables(self, indices, costs):
        indices = np.asarray(indices)
        costs = np.asarray(costs, dtype=np.float64)
        if costs.shape != indices.shape:
            raise ValueError("costs shape must match indices shape")
        self.costsvector[indices.ravel()] = costs.ravel()

    def get_variables_bounds(self):
        return None, self.lower_bounds, self.upper_bounds

    # ------------------------------------------------------------------
    # constraints
    # ------------------------------------------------------------------

    def nb_equality_constraints(self) -> int:
        return self.a_equalities.shape[0]

    def nb_inequality_constraints(self) -> int:
        return self.a_inequalities.shape[0]

    def add_equality_constraints_sparse(self, a, b):
        """Append rows of a scipy sparse matrix as equalities (``SparseLP.py:511``)."""
        self.a_equalities.append_scipy(a)
        self.a_equalities.set_ncols(self.nb_variables)
        self.b_equalities = np.append(
            self.b_equalities, np.broadcast_to(np.asarray(b, np.float64), (a.shape[0],))
        )

    def add_inequality_constraints_sparse(self, a, lower_bounds=None, upper_bounds=None):
        """Append ``lower_bounds <= A x <= upper_bounds`` rows (``SparseLP.py:515``).

        Scalar equal bounds are routed to the equality system like the
        reference does.
        """
        if (
            np.isscalar(lower_bounds)
            and np.isscalar(upper_bounds)
            and lower_bounds == upper_bounds
        ):
            self.add_equality_constraints_sparse(
                a, np.full(a.shape[0], float(lower_bounds))
            )
            return
        m = a.shape[0]
        lb = _as_bound_array((m,), lower_bounds, -np.inf)
        ub = _as_bound_array((m,), upper_bounds, np.inf)
        self.a_inequalities.append_scipy(a)
        self.a_inequalities.set_ncols(self.nb_variables)
        self.b_lower = np.append(self.b_lower, lb)
        self.b_upper = np.append(self.b_upper, ub)

    def add_equality_constraints(self, cols, vals, b):
        """Add ``sum_j vals[i,j] x[cols[i,j]] == b[i]`` (``SparseLP.py:539``)."""
        self.add_inequality_constraints(cols, vals, lower_bounds=b, upper_bounds=b)

    def add_inequality_constraints(self, cols, vals, lower_bounds=None, upper_bounds=None):
        """Add ``lb[i] <= sum_j vals[i,j] x[cols[i,j]] <= ub[i]`` (``SparseLP.py:560``)."""
        self.add_soft_inequality_constraints(
            cols, vals, coef_penalization=np.inf,
            lower_bounds=lower_bounds, upper_bounds=upper_bounds,
        )

    def add_soft_equality_constraints(self, cols, vals, b, coef_penalization):
        """Penalized equalities via aux variables (``SparseLP.py:546``)."""
        return self.add_soft_inequality_constraints(
            cols, vals, lower_bounds=b, upper_bounds=b,
            coef_penalization=coef_penalization,
        )

    def add_soft_inequality_constraints(
        self, cols, vals, coef_penalization, lower_bounds=None, upper_bounds=None
    ):
        """Soft two-sided constraints: adds ``sum_i pen_i * max(0, lb_i - y_i, y_i - ub_i)``
        to the objective via one auxiliary variable per row (``SparseLP.py:575``).
        """
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        if np.all(np.asarray(coef_penalization) == np.inf):
            a = crd_matrix(cols, vals)
            if a.shape[1] < self.nb_variables:
                a = scipy.sparse.csr_matrix(
                    (a.data, a.indices, a.indptr), shape=(a.shape[0], self.nb_variables)
                )
            is_eq = (
                lower_bounds is not None
                and upper_bounds is not None
                and np.all(np.asarray(lower_bounds) == np.asarray(upper_bounds))
            )
            if is_eq:
                self.add_equality_constraints_sparse(
                    a, np.broadcast_to(np.asarray(lower_bounds, np.float64), (a.shape[0],))
                )
            else:
                m = a.shape[0]
                lb = _as_bound_array((m,), lower_bounds, -np.inf)
                ub = _as_bound_array((m,), upper_bounds, np.inf)
                self.a_inequalities.append_scipy(a)
                self.a_inequalities.set_ncols(self.nb_variables)
                self.b_lower = np.append(self.b_lower, lb)
                self.b_upper = np.append(self.b_upper, ub)
            return None

        if np.any(np.asarray(coef_penalization) == np.inf):
            raise NotImplementedError(
                "mixing np.inf with finite penalizations is not handled"
            )
        cols, vals = np.broadcast_arrays(cols, vals)
        aux = self.add_variables_array(
            (cols.shape[0],), upper_bounds=None, lower_bounds=0,
            costs=np.broadcast_to(
                np.asarray(coef_penalization, np.float64), (cols.shape[0],)
            ).copy(),
        )
        cols2 = np.column_stack((cols, aux))
        if upper_bounds is None and lower_bounds is None:
            raise ValueError("needs at least one of lower_bounds/upper_bounds")
        if upper_bounds is not None:
            vals2 = np.column_stack((vals, -np.ones((vals.shape[0], 1))))
            self.add_inequality_constraints(
                cols2, vals2, lower_bounds=None, upper_bounds=upper_bounds
            )
        if lower_bounds is not None:
            vals2 = np.column_stack((vals, np.ones((vals.shape[0], 1))))
            self.add_inequality_constraints(
                cols2, vals2, lower_bounds=lower_bounds, upper_bounds=None
            )
        return aux

    def add_soft_linear_constraint_rows(
        self, cols, vals, coef_penalization, lower_bounds=None, upper_bounds=None
    ):
        """Alias kept for reference-API users; the reference's basis-pursuit
        example calls this name which does not exist there
        (``examples/example_basis_pursuit_denoising.py:28``)."""
        return self.add_soft_inequality_constraints(
            cols, vals, coef_penalization,
            lower_bounds=lower_bounds, upper_bounds=upper_bounds,
        )

    def add_inequalities_pairs(
        self, indices_and_weight_pairs, lower_bounds, upper_bounds, check=True
    ):
        """Add rows given (indices, weight) pairs (fixed version of ``SparseLP.py:615``)."""
        cols, vals = [], []
        for t in indices_and_weight_pairs:
            cols.append(np.asarray(t[0]).flatten())
            vals.append((np.ones(np.asarray(t[0]).shape) * t[1]).flatten())
        if isinstance(upper_bounds, np.ndarray):
            upper_bounds = upper_bounds.flatten()
        if isinstance(lower_bounds, np.ndarray):
            lower_bounds = lower_bounds.flatten()
        self.add_inequality_constraints(
            np.column_stack(cols), np.column_stack(vals), lower_bounds, upper_bounds
        )
        if self.solution is not None and check:
            assert self.check_solution(self.solution)

    # ------------------------------------------------------------------
    # constraint naming (``SparseLP.py:228-275``)
    # ------------------------------------------------------------------

    def start_constraint_name(self, name):
        if name:
            self._last_name_start = name
            self._last_name_eq_start = self.nb_equality_constraints()
            self._last_name_ineq_start = self.nb_inequality_constraints()

    def end_constraint_name(self, name):
        if not name:
            return
        assert self._last_name_start == name
        if self.nb_equality_constraints() > self._last_name_eq_start:
            self.equality_constraint_names.append(
                {
                    "name": name,
                    "start": self._last_name_eq_start,
                    "end": self.nb_equality_constraints() - 1,
                }
            )
        if self.nb_inequality_constraints() > self._last_name_ineq_start:
            self.inequality_constraint_names.append(
                {
                    "name": name,
                    "start": self._last_name_ineq_start,
                    "end": self.nb_inequality_constraints() - 1,
                }
            )

    def get_inequality_constraint_name_from_id(self, idv):
        for d in self.inequality_constraint_names:
            if d["start"] <= idv <= d["end"]:
                return d
        return None

    def get_equality_constraint_name_from_id(self, idv):
        for d in self.equality_constraint_names:
            if d["start"] <= idv <= d["end"]:
                return d
        return None

    def find_inequality_constraints_from_name(self, name):
        return [d for d in self.inequality_constraint_names if d["name"] == name]

    # ------------------------------------------------------------------
    # checking (``SparseLP.py:186-226``)
    # ------------------------------------------------------------------

    def max_constraint_violation(self, solution) -> float:
        solution = np.asarray(solution, dtype=np.float64)
        max_v = 0.0
        if self.lower_bounds.size:
            max_v = max(max_v, float(np.max(self.lower_bounds - solution)))
            max_v = max(max_v, float(np.max(solution - self.upper_bounds)))
        if self.a_equalities is not None and self.a_equalities.shape[0] > 0:
            max_v = max(
                max_v,
                float(np.max(np.abs(self.a_equalities.matvec(solution) - self.b_equalities))),
            )
        if self.a_inequalities is not None and self.a_inequalities.shape[0] > 0:
            r = self.a_inequalities.matvec(solution)
            if self.b_upper is not None:
                max_v = max(max_v, float(np.max(r - self.b_upper)))
            if self.b_lower is not None:
                max_v = max(max_v, float(np.max(self.b_lower - r)))
        return max_v

    def check_solution(self, solution, tol=1e-6) -> bool:
        return self.max_constraint_violation(solution) < tol

    def cost(self, solution) -> float:
        return float(self.costsvector.dot(np.asarray(solution)))

    # ------------------------------------------------------------------
    # form conversions (reference ``SparseLP.py:632-928``)
    # ------------------------------------------------------------------

    def remove_fixed_variables(self):
        """Eliminate variables with ub == lb; returns ``(m_change, shift)`` with
        ``x_original = m_change @ x_reduced + shift`` (``SparseLP.py:632``)."""
        free = self.upper_bounds > self.lower_bounds
        id_free = np.nonzero(free)[0]
        nb_free = int(free.sum())
        m_change = scipy.sparse.coo_matrix(
            (np.ones(nb_free), (id_free, np.arange(nb_free))),
            shape=(self.nb_variables, nb_free),
        ).tocsr()
        shift = np.zeros(self.nb_variables)
        shift[~free] = self.lower_bounds[~free]

        self.b_equalities = self.b_equalities - self.a_equalities.matvec(shift)
        if self.a_inequalities.shape[0] > 0:
            a_shift = self.a_inequalities.matvec(shift)
            if self.b_lower is not None:
                self.b_lower = self.b_lower - a_shift
            if self.b_upper is not None:
                self.b_upper = self.b_upper - a_shift

        self.costsvector = self.costsvector[free]
        self.is_integer = self.is_integer[free]
        self.a_inequalities = BlockedCSR.from_scipy(
            self.a_inequalities.tocsr()[:, free], blocks=self.a_inequalities.blocks
        )
        self.a_equalities = BlockedCSR.from_scipy(
            self.a_equalities.tocsr()[:, free], blocks=self.a_equalities.blocks
        )
        self.nb_variables = nb_free
        self.lower_bounds = self.lower_bounds[free]
        self.upper_bounds = self.upper_bounds[free]
        return m_change, shift

    def convert_to_one_sided_inequality_system(self):
        """Rewrite two-sided rows as ``A x <= b_upper`` only (``SparseLP.py:835``).

        Fixes the reference's ``mapping_lower`` bug (uses ``!= np.inf`` where
        ``!= -np.inf`` is intended, ``SparseLP.py:841``).
        """
        if self.a_inequalities.shape[0] == 0 or self.b_lower is None:
            return
        a = self.a_inequalities.tocsr()
        keep_upper = np.nonzero(self.b_upper != np.inf)[0]
        keep_lower = np.nonzero(self.b_lower != -np.inf)[0]
        mapping_upper = np.concatenate(([0], np.cumsum(self.b_upper != np.inf)))
        mapping_lower = np.concatenate(([0], np.cumsum(self.b_lower != -np.inf)))

        # Remap inclusive [start, end] name ranges: the new start of row s is
        # the count of kept rows before it, and the new inclusive end of row e
        # is mapping[e + 1] - 1 — correct even when the range's boundary rows
        # themselves are dropped (inf bound).
        new_names = []
        for d in self.inequality_constraint_names:
            new_names.append(
                {
                    "name": d["name"],
                    "start": int(mapping_upper[d["start"]]),
                    "end": int(mapping_upper[d["end"] + 1]) - 1,
                }
            )
        for d in self.inequality_constraint_names:
            new_names.append(
                {
                    "name": d["name"],
                    "start": int(keep_upper.size + mapping_lower[d["start"]]),
                    "end": int(keep_upper.size + mapping_lower[d["end"] + 1]) - 1,
                }
            )
        self.inequality_constraint_names = new_names

        if keep_lower.size and keep_upper.size:
            new_a = scipy.sparse.vstack((a[keep_upper, :], -a[keep_lower, :])).tocsr()
        elif keep_lower.size:
            new_a = (-a).tocsr()[keep_lower, :]
        else:
            new_a = a[keep_upper, :]
        self.b_upper = np.concatenate(
            (self.b_upper[keep_upper], -self.b_lower[keep_lower])
        )
        self.b_lower = None
        self.a_inequalities = BlockedCSR.from_scipy(new_a)

    def convert_to_all_inequalities(self):
        """Merge equalities into the two-sided inequality system (``SparseLP.py:881``)."""
        if self.a_inequalities is not None:
            m_i = self.a_inequalities.shape[0]
            if self.b_lower is None:
                self.b_lower = np.full(m_i, -np.inf)
            if self.b_upper is None:
                self.b_upper = np.full(m_i, np.inf)
        if self.a_equalities is None:
            return
        if self.a_equalities.shape[0] == 0:
            self.a_equalities = None
            self.b_equalities = None
            return

        m_e = self.a_equalities.shape[0]
        new_names = list(self.equality_constraint_names)
        for d in self.inequality_constraint_names:
            new_names.append(
                {"name": d["name"], "start": m_e + d["start"], "end": m_e + d["end"]}
            )
        self.inequality_constraint_names = new_names
        self.equality_constraint_names = []

        eq_blocks = list(self.a_equalities.blocks)
        ineq_blocks = [(b[0] + m_e, b[1] + m_e) for b in self.a_inequalities.blocks]
        stacked = scipy.sparse.vstack(
            (self.a_equalities.tocsr(), self.a_inequalities.tocsr())
        ).tocsr()
        self.a_inequalities = BlockedCSR.from_scipy(stacked, blocks=eq_blocks + ineq_blocks)
        self.b_lower = np.concatenate((self.b_equalities, self.b_lower))
        self.b_upper = np.concatenate((self.b_equalities, self.b_upper))
        self.a_equalities = None
        self.b_equalities = None

    def convert_to_all_inequalities_without_bounds(self):
        """Also fold box bounds into inequality rows (``SparseLP.py:913``)."""
        self.convert_to_all_inequalities()
        non_free = np.nonzero(
            ~(np.isinf(self.lower_bounds) & np.isinf(self.upper_bounds))
        )[0]
        k = non_free.size
        eye_reduced = scipy.sparse.coo_matrix(
            (np.ones(k), (np.arange(k), non_free)), shape=(k, self.nb_variables)
        )
        blocks = list(self.a_inequalities.blocks)
        m_old = self.a_inequalities.shape[0]
        stacked = scipy.sparse.vstack(
            (self.a_inequalities.tocsr(), eye_reduced)
        ).tocsr()
        self.a_inequalities = BlockedCSR.from_scipy(
            stacked, blocks=blocks + [(m_old, m_old + k)]
        )
        self.b_lower = np.concatenate((self.b_lower, self.lower_bounds[non_free]))
        self.b_upper = np.concatenate((self.b_upper, self.upper_bounds[non_free]))
        self.lower_bounds = np.full(self.nb_variables, -np.inf)
        self.upper_bounds = np.full(self.nb_variables, np.inf)

    def convert_to_all_equalities(self):
        """Replace inequalities by equalities plus bounded slack vars (``SparseLP.py:819``)."""
        if self.a_inequalities is None or self.a_inequalities.shape[0] == 0:
            self.a_inequalities = BlockedCSR(self.nb_variables)
            self.b_lower = np.empty(0)
            self.b_upper = np.empty(0)
            return
        m = self.a_inequalities.shape[0]
        a_ineq = self.a_inequalities.tocsr()
        ineq_blocks = list(self.a_inequalities.blocks)
        self.add_variables_array(m, self.b_lower, self.b_upper)
        ext = scipy.sparse.hstack(
            (a_ineq, -scipy.sparse.eye(m))
        ).tocsr()
        m_e = self.a_equalities.shape[0]
        self.a_equalities.append_scipy(ext)
        # keep per-batch block structure from the original inequality system
        self.a_equalities.blocks.pop()
        self.a_equalities.blocks.extend(
            [(b[0] + m_e, b[1] + m_e) for b in ineq_blocks]
        )
        self.b_equalities = np.append(self.b_equalities, np.zeros(m))
        self.a_inequalities = BlockedCSR(self.nb_variables)
        self.b_lower = np.empty(0)
        self.b_upper = np.empty(0)

    def convert_to_slack_form(self):
        """Convert to ``min cᵀy s.t. A y = b, y >= 0`` (``SparseLP.py:676``).

        Returns ``(m_change, shift)`` with ``x_original = m_change @ y + shift``.
        """
        self.convert_to_one_sided_inequality_system()
        n = self.nb_variables

        # 1) negate variables that are only bounded above:  x = D x'
        reverse = np.isinf(self.lower_bounds) & ~np.isinf(self.upper_bounds)
        d = np.ones(n)
        d[reverse] = -1.0
        m1 = scipy.sparse.diags(d).tocsr()
        lower = np.where(reverse, -self.upper_bounds, self.lower_bounds)
        upper = np.where(reverse, -self.lower_bounds, self.upper_bounds)
        a_ineq = (self.a_inequalities.tocsr() @ m1).tocsr()
        a_eq = (self.a_equalities.tocsr() @ m1).tocsr()
        b_upper = self.b_upper.copy() if self.b_upper is not None else np.empty(0)
        b_eq = self.b_equalities.copy()

        # 2) shift finite lower bounds to 0:  x' = y + s
        s = np.where(np.isinf(lower), 0.0, lower)
        if a_ineq.shape[0]:
            b_upper = b_upper - a_ineq @ s
        b_eq = b_eq - a_eq @ s
        upper = upper - s
        lower = lower - s

        # 3) finite upper bounds become inequality rows  e_i y <= ub_i
        id_upper = np.nonzero(~np.isinf(upper))[0]
        if id_upper.size:
            t = scipy.sparse.coo_matrix(
                (np.ones(id_upper.size), (np.arange(id_upper.size), id_upper)),
                shape=(id_upper.size, n),
            )
            a_ineq = scipy.sparse.vstack((a_ineq, t)).tocsr()
            b_upper = np.concatenate((b_upper, upper[id_upper]))

        # 4) free variables (lower still -inf) become differences p - q >= 0
        free = np.isinf(lower)
        nb_free = int(free.sum())
        if nb_free:
            nb_not_free = n - nb_free
            # column j of m2 maps new variable j back to original variables
            new_pos = np.where(free, np.cumsum(free) + nb_not_free - 1, np.cumsum(~free) - 1)
            rows = np.concatenate((np.arange(n), np.nonzero(free)[0]))
            cols_idx = np.concatenate((new_pos, new_pos[free] + nb_free))
            vals = np.concatenate((np.ones(n), -np.ones(nb_free)))
            m2 = scipy.sparse.coo_matrix(
                (vals, (rows, cols_idx)), shape=(n, nb_not_free + 2 * nb_free)
            ).tocsr()
        else:
            m2 = scipy.sparse.eye(n).tocsr()
        n_pos = m2.shape[1]
        a_eq = (a_eq @ m2).tocsr()
        a_ineq = (a_ineq @ m2).tocsr()
        costs = m2.T @ (m1.T @ self.costsvector)

        # 5) inequality rows A y <= b become A y + z = b with slack z >= 0
        nb_slack = a_ineq.shape[0]
        a_full = scipy.sparse.bmat(
            [
                [a_eq, None],
                [a_ineq, scipy.sparse.eye(nb_slack)],
            ]
        ).tocsr() if nb_slack else a_eq
        b_full = np.concatenate((b_eq, b_upper)) if nb_slack else b_eq
        n_new = n_pos + nb_slack

        m_change = (m1 @ m2).tocsr()
        m_change = scipy.sparse.csr_matrix(
            (m_change.data, m_change.indices, m_change.indptr), shape=(n, n_new)
        )
        shift = m1 @ s

        self.nb_variables = n_new
        self.costsvector = np.concatenate((costs, np.zeros(nb_slack)))
        self.lower_bounds = np.zeros(n_new)
        self.upper_bounds = np.full(n_new, np.inf)
        self.is_integer = np.zeros(n_new, dtype=bool)
        self.a_equalities = BlockedCSR.from_scipy(a_full)
        self.b_equalities = b_full
        self.a_inequalities = BlockedCSR(n_new)
        self.b_lower = None
        self.b_upper = None
        return m_change, shift

    # ------------------------------------------------------------------
    # I/O (implemented in io/, bound here for API parity)
    # ------------------------------------------------------------------

    def save_mps(self, filename):
        from .io.mps import save_mps

        save_mps(self, filename)

    def save_ian_e_h_yen(self, folder):
        from .io.ian_yen import save_ian_e_h_yen

        save_ian_e_h_yen(self, folder)

    def convert_to_cvxpy(self):
        """Return ``(cvxpy.Problem, x)`` (reference ``SparseLP.py:930-988``)."""
        from .solvers.cvxpy_bridge import convert_to_cvxpy

        return convert_to_cvxpy(self)

    # ------------------------------------------------------------------
    # solve dispatch (``SparseLP.py:990-1383``)
    # ------------------------------------------------------------------

    def solve(
        self,
        method=None,
        get_timing=True,
        x0=None,
        nb_iter=10000,
        max_time=None,
        callback_func=None,
        nb_iter_plot=10,
        plot_solution=None,
        ground_truth=None,
        ground_truth_indices=None,
        force_integer=False,
        dtype=None,
        config=None,
        light_metrics=False,
        device="cuda",
        **solver_kwargs,
    ):
        """Solve the LP; returns ``(x, elapsed)`` (or ``x`` if not get_timing).

        ``device`` names the torch device the solver runs on (``"cuda"`` by
        default; asking for CUDA where there is none raises).  ``dtype=None``
        means float32 on CUDA and float64 on the CPU.

        Records the same convergence-curve attributes as the reference
        (``SparseLP.py:1018-1093``): ``distance_to_ground_truth``,
        ``distanceToGroundTruthAfterRounding``, ``opttime_curve``,
        ``dopttime_curve``, ``pobj_curve``, ``dobj_curve``, ``pobjbound``,
        ``max_violated_inequality``, ``max_violated_equality``,
        ``max_violated_constraint``, ``itrn_curve``.

        Extra keyword arguments are forwarded to the solver.  Notable ones
        beyond the reference's API:

        * ``stop_tol`` — tolerance-based termination (first-order family);
        * ``restart="average"`` / ``omega="auto"`` — PDLP-style acceleration
          for ``chambolle_pock_ppd``;
        * ``light_metrics=True`` (``chambolle_pock_ppd`` and the ADMM
          family: ``admm``/``admm2``/``admm_blocks``) — each
          checkpoint costs exactly ONE device fetch: the per-checkpoint
          host-side violation recompute and solution transfer are skipped,
          and ``max_violated_constraint`` records the device-computed
          violation of the solver's (converted, one-sided) system instead
          of re-deriving it from the original matrices.  Curve values are
          materialized to floats after the solve.  Intended for remote/
          tunneled devices where every fetch costs tens of milliseconds;
          ground-truth distance (if requested) still fetches the solution.

        ``config`` accepts a typed per-solver dataclass from
        :mod:`pysparselp_tpu_torch.config` (e.g. ``Admm2Config(adaptive_rho=True)``)
        naming the method and its options; explicitly passed non-default
        keyword arguments win over config fields.  Unknown solver options
        raise ``TypeError`` listing the valid fields for the method.
        """
        # lazy: keeps pure modeling torch-free
        from .solvers import dispatch
        from .solvers.base import fetch
        from .utils.instrumentation import span

        if config is not None:
            # typed configuration (pysparselp_tpu.config): the config names
            # the method and provides option values.  ``method=None`` is the
            # sentinel default, so an EXPLICITLY passed method is always
            # distinguishable from the default — a genuine mismatch between
            # an explicit method and the config's solver family errors
            # instead of silently picking one.
            if method is not None:
                from .config import CONFIG_CLASSES

                if CONFIG_CLASSES.get(method) is not type(config):
                    raise ValueError(
                        f"method={method!r} conflicts with the supplied "
                        f"config {type(config).__name__} (which configures "
                        f"method {config.method!r}); pass one or the other"
                    )
            else:
                method = config.method
            common = dict(nb_iter=config.nb_iter,
                          nb_iter_plot=config.nb_iter_plot,
                          max_time=config.max_time, dtype=config.dtype)
            if nb_iter == 10000:
                nb_iter = common["nb_iter"]
            if nb_iter_plot == 10:
                nb_iter_plot = common["nb_iter_plot"]
            max_time = max_time if max_time is not None else common["max_time"]
            dtype = dtype if dtype is not None else common["dtype"]
            solver_kwargs = {**config.solver_kwargs(), **solver_kwargs}
        if method is None:
            method = "chambolle_pock_ppd"

        start = time.perf_counter()
        self.distance_to_ground_truth = []
        self.distanceToGroundTruthAfterRounding = []
        self.opttime_curve = []
        self.dopttime_curve = []
        self.pobj_curve = []
        self.dobj_curve = []
        self.pobjbound = []
        self.max_violated_inequality = []
        self.max_violated_equality = []
        self.max_violated_constraint = []
        self.itrn_curve = []

        user_callback = callback_func

        def recording_callback(
            niter,
            solution,
            energy1,
            energy2,
            duration,
            max_violated_equality,
            max_violated_inequality,
            is_active_variable=None,
            state=None,
        ):
            if light_metrics:
                # one-fetch checkpoints: append raw device scalars (they
                # are materialized to floats after the solve, off the
                # clock); never touch the solution unless a ground-truth
                # distance was requested
                if ground_truth is not None:
                    gt_idx = (
                        ground_truth_indices
                        if ground_truth_indices is not None
                        else np.arange(len(ground_truth))
                    )
                    sol_np = np.asarray(solution)
                    self.distance_to_ground_truth.append(
                        float(np.mean(np.abs(ground_truth - sol_np[gt_idx])))
                    )
                    self.distanceToGroundTruthAfterRounding.append(
                        float(np.mean(np.abs(
                            ground_truth - np.round(sol_np[gt_idx]))))
                    )
                self.itrn_curve.append(niter)
                self.opttime_curve.append(duration)
                self.dopttime_curve.append(duration)
                self.dobj_curve.append(energy2)
                self.pobj_curve.append(energy1)
                self.max_violated_equality.append(max_violated_equality)
                self.max_violated_inequality.append(max_violated_inequality)
                if plot_solution is not None:
                    # a plot hook forces wants_solution=True below, so the
                    # solver fetched/unpermuted the solution already
                    plot_solution(niter, np.asarray(solution),
                                  is_active_variable=is_active_variable)
                if user_callback is not None:
                    user_callback(
                        niter, solution, energy1, energy2, duration,
                        max_violated_equality, max_violated_inequality,
                        **({"state": state}
                           if getattr(user_callback, "wants_state", False)
                           else {}),
                    )
                return
            if ground_truth is not None:
                gt_idx = (
                    ground_truth_indices
                    if ground_truth_indices is not None
                    else np.arange(len(ground_truth))
                )
                self.distance_to_ground_truth.append(
                    float(np.mean(np.abs(ground_truth - solution[gt_idx])))
                )
                self.distanceToGroundTruthAfterRounding.append(
                    float(np.mean(np.abs(ground_truth - np.round(solution[gt_idx]))))
                )
            self.itrn_curve.append(niter)
            self.opttime_curve.append(duration)
            self.dopttime_curve.append(duration)
            self.dobj_curve.append(energy2)
            self.pobj_curve.append(energy1)
            self.max_violated_constraint.append(self.max_constraint_violation(solution))
            self.max_violated_equality.append(max_violated_equality)
            self.max_violated_inequality.append(max_violated_inequality)
            if plot_solution is not None:
                plot_solution(niter, solution, is_active_variable=is_active_variable)
            if user_callback is not None:
                user_callback(
                    niter,
                    solution,
                    energy1,
                    energy2,
                    duration,
                    max_violated_equality,
                    max_violated_inequality,
                    **(
                        {"state": state}
                        if getattr(user_callback, "wants_state", False)
                        else {}
                    ),
                )

        recording_callback.wants_state = getattr(
            user_callback, "wants_state", False
        )
        # light mode never reads the solution (so the solver can skip the
        # per-checkpoint device fetch + unpermute) — unless a ground-truth
        # distance, a plot hook or a user callback needs it
        recording_callback.wants_solution = (
            not light_metrics
            or ground_truth is not None
            or plot_solution is not None
            or user_callback is not None
        )

        if light_metrics:
            solver_kwargs["light_metrics"] = True
        with span("solve"):
            x = dispatch(
                self,
                method=method,
                x0=x0,
                nb_iter=nb_iter,
                max_time=max_time,
                callback_func=recording_callback,
                nb_iter_plot=nb_iter_plot,
                start_time=start,
                force_integer=force_integer,
                dtype=dtype,
                device=device,
                **solver_kwargs,
            )
            elapsed = time.perf_counter() - start
            if light_metrics:
                # materialize the lazily-recorded device scalars (off the
                # clock)
                with span("postsolve"):
                    self.pobj_curve = [fetch(v) for v in self.pobj_curve]
                    self.dobj_curve = [fetch(v) for v in self.dobj_curve]
                    self.max_violated_equality = [
                        fetch(v) for v in self.max_violated_equality]
                    self.max_violated_inequality = [
                        fetch(v) for v in self.max_violated_inequality]
                    self.max_violated_constraint = [
                        max(a, b) for a, b in zip(
                            self.max_violated_equality,
                            self.max_violated_inequality)]
        if get_timing:
            return x, elapsed
        return x

    def __deepcopy__(self, memo):
        out = SparseLP.__new__(type(self))
        out.__dict__ = {
            k: (v.copy() if isinstance(v, (np.ndarray, BlockedCSR)) else copy.deepcopy(v, memo))
            for k, v in self.__dict__.items()
        }
        return out
