"""Device LP problem containers for the PyTorch port (mirrors
``pysparselp_tpu/problem.py``).

``solve()`` lowers the finished host model once into an :class:`LPProblem`
of torch tensors on one device.  Each constraint system becomes one of
three operators, chosen by :func:`ell_from_scipy`:

* :class:`DenseMatrix` — small systems; ``A @ x`` is a plain ``matmul``
  (the JAX package leaves this product to XLA as well);
* :class:`DiaMatrix` — systems with few distinct ``(col - row)`` diagonals
  (the anchor-aligned grid LPs); both SpMV directions run the hand-written
  H-DIA kernel (:mod:`pysparselp_tpu_torch.ops.dia_spmv`) on CUDA;
* :class:`CsrMatrix` — everything else, in plain torch (gather plus
  ``index_add_``), standing in for the JAX package's XLA-only
  ``EllMatrix``/``SegmentedEllMatrix``.

The numpy layout helpers (:func:`anchor_align`, :func:`aligned_offset_count`,
:func:`embed_matrix`, :func:`apply_align_embedding`, :func:`dia_offsets`)
are copies of the JAX package's, which the port cannot import (importing
any ``pysparselp_tpu`` module imports jax).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse
import torch

from .ops.dia_spmv import dia_spmv

# ell_from_scipy's rule (plain, not calibrated; to be re-derived from H100
# measurements): a system whose dense form has at most DENSE_MAX_ENTRIES
# entries (4 MB of float32, the dense fused kernel's budget) is dense; a
# larger one with at most DIA_AUTO_MAX_OFFSETS distinct diagonals is DIA
# (the anchor-aligned grid LPs land on 8-15); the rest is CSR.
DENSE_MAX_ENTRIES = 1 << 20
DIA_AUTO_MAX_OFFSETS = 32


def resolve_device(device="cuda") -> torch.device:
    """The torch device to run on; asking for CUDA without it raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def resolve_dtype(dtype, device) -> torch.dtype:
    """``None`` means float32 on CUDA and float64 on the CPU; numpy and
    torch spellings of float32/float64 are accepted."""
    if dtype is None:
        return torch.float32 if torch.device(device).type == "cuda" \
            else torch.float64
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {np.float32: torch.float32,
               np.float64: torch.float64}.get(np.dtype(dtype).type)
    if out not in (torch.float32, torch.float64):
        raise ValueError(f"dtype {dtype!r}: the port computes in float32 "
                         "or float64")
    return out


def abs_pow0(v, p):
    """``|v|**p`` with ``0**0 == 0`` (stored zeros never count toward the
    preconditioner sums; mirrors the JAX helper)."""
    av = v.abs()
    return torch.where(av > 0, av ** p, torch.zeros_like(av))


@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Dense operator: SpMV as a float32/float64 ``matmul`` (TF32 off)."""

    a: torch.Tensor  # (nrows, ncols)
    nrows: int
    ncols: int

    def __post_init__(self):
        if self.a.is_cuda:
            # full-precision products, like the JAX dense kernel's
            # precision=HIGHEST (TF32 keeps ~3 decimal digits)
            torch.backends.cuda.matmul.allow_tf32 = False

    def matvec(self, x):
        return self.a @ x

    def rmatvec(self, y):
        return y @ self.a

    def abs_power_rowsum(self, p):
        return abs_pow0(self.a, p).sum(dim=1)

    def abs_power_colsum(self, p):
        return abs_pow0(self.a, p).sum(dim=0)

    @staticmethod
    def from_scipy(a, dtype, device) -> "DenseMatrix":
        csr = scipy.sparse.csr_matrix(a)
        return DenseMatrix(
            a=torch.as_tensor(csr.toarray(), dtype=dtype, device=device),
            nrows=csr.shape[0], ncols=csr.shape[1])


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Diagonal (DIA) operator, both orientations stored.

    ``vals[d, r] = A[r, r + offsets[d]]`` (zero where the diagonal leaves
    the matrix), shape ``(ndiag, nrows)``; ``vals_t`` holds Aᵀ the same way
    over ``offsets_t = -offsets``.  The offsets live twice: as Python ints
    (host logic, the plain twins) and as int32 device tensors ``offs`` /
    ``offs_t`` (the kernels' argument).  No kernel-layout padding: the
    H-DIA kernel bounds-checks each read instead.
    """

    vals: torch.Tensor     # (ndiag, nrows)
    vals_t: torch.Tensor   # (ndiag_t, ncols)
    offsets: tuple
    offsets_t: tuple
    offs: torch.Tensor     # int32 (ndiag,)
    offs_t: torch.Tensor   # int32 (ndiag_t,)
    nrows: int
    ncols: int

    @property
    def ndiag(self):
        return len(self.offsets)

    def matvec(self, x):
        return dia_spmv(self.vals, self.offs, x, self.nrows)

    def rmatvec(self, y):
        return dia_spmv(self.vals_t, self.offs_t, y, self.ncols)

    def abs_power_rowsum(self, p):
        return abs_pow0(self.vals, p).sum(dim=0)

    def abs_power_colsum(self, p):
        return abs_pow0(self.vals_t, p).sum(dim=0)

    @staticmethod
    def from_planes(vals, offsets, vals_t, offsets_t, nrows, ncols, dtype,
                    device) -> "DiaMatrix":
        """From host ``(ndiag, nrows)`` / ``(ndiag_t, ncols)`` planes."""
        def i32(o):
            return torch.as_tensor(np.asarray(o, np.int32).reshape(-1),
                                   device=device)

        return DiaMatrix(
            vals=torch.as_tensor(np.asarray(vals, np.float64), dtype=dtype,
                                 device=device).reshape(len(offsets), nrows),
            vals_t=torch.as_tensor(np.asarray(vals_t, np.float64),
                                   dtype=dtype, device=device
                                   ).reshape(len(offsets_t), ncols),
            offsets=tuple(int(o) for o in offsets),
            offsets_t=tuple(int(o) for o in offsets_t),
            offs=i32(offsets), offs_t=i32(offsets_t),
            nrows=int(nrows), ncols=int(ncols))

    @staticmethod
    def _planes(coo, n_major):
        off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
        offsets = np.unique(off)
        vals = np.zeros((offsets.size, n_major))
        np.add.at(vals, (np.searchsorted(offsets, off), coo.row), coo.data)
        return vals, offsets

    @staticmethod
    def from_scipy(a, dtype, device) -> "DiaMatrix":
        coo = scipy.sparse.coo_matrix(a)
        coo.sum_duplicates()
        m, n = coo.shape
        vals, offsets = DiaMatrix._planes(coo, m)
        vals_t, offsets_t = DiaMatrix._planes(coo.T.tocoo(), n)
        return DiaMatrix.from_planes(vals, offsets, vals_t, offsets_t, m, n,
                                     dtype, device)


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """Plain-torch sparse operator: ``A @ x`` is a gather of ``x`` and an
    ``index_add_`` into the rows; ``Aᵀ @ y`` runs over a second copy of
    the entries sorted by column."""

    rows: torch.Tensor     # int64 (nnz,), row-major order
    cols: torch.Tensor
    vals: torch.Tensor
    rows_t: torch.Tensor   # the same entries in column-major order
    cols_t: torch.Tensor
    vals_t: torch.Tensor
    nrows: int
    ncols: int

    def _zeros(self, size):
        return torch.zeros(size, dtype=self.vals.dtype,
                           device=self.vals.device)

    def matvec(self, x):
        return self._zeros(self.nrows).index_add_(
            0, self.rows, self.vals * x[self.cols])

    def rmatvec(self, y):
        return self._zeros(self.ncols).index_add_(
            0, self.cols_t, self.vals_t * y[self.rows_t])

    def abs_power_rowsum(self, p):
        return self._zeros(self.nrows).index_add_(
            0, self.rows, abs_pow0(self.vals, p))

    def abs_power_colsum(self, p):
        return self._zeros(self.ncols).index_add_(
            0, self.cols_t, abs_pow0(self.vals_t, p))

    @staticmethod
    def from_scipy(a, dtype, device) -> "CsrMatrix":
        csr = scipy.sparse.csr_matrix(a)
        csr.sum_duplicates()
        csc = csr.tocsc()
        m, n = csr.shape

        def t(v, dt=torch.int64):
            return torch.as_tensor(np.asarray(v), dtype=dt, device=device)

        rows = np.repeat(np.arange(m), np.diff(csr.indptr))
        cols_t = np.repeat(np.arange(n), np.diff(csc.indptr))
        return CsrMatrix(
            rows=t(rows), cols=t(csr.indices), vals=t(csr.data, dtype),
            rows_t=t(csc.indices), cols_t=t(cols_t),
            vals_t=t(csc.data, dtype), nrows=m, ncols=n)


def ell_from_scipy(a, dtype, device, prefer=None):
    """Lower a scipy sparse matrix to one of the port's operators.

    The rule (see the constants above): dense when the dense form has at
    most ``DENSE_MAX_ENTRIES`` entries; else DIA when it has at most
    ``DIA_AUTO_MAX_OFFSETS`` distinct diagonals; else CSR.  ``prefer``
    ("dense", "dia" or "csr") forces a backend.
    """
    csr = scipy.sparse.csr_matrix(a)
    m, n = csr.shape
    if prefer is None:
        if m * n <= DENSE_MAX_ENTRIES:
            prefer = "dense"
        elif csr.nnz and dia_offsets(csr).size <= DIA_AUTO_MAX_OFFSETS:
            prefer = "dia"
        else:
            prefer = "csr"
    if prefer == "dense":
        return DenseMatrix.from_scipy(csr, dtype, device)
    if prefer == "dia":
        return DiaMatrix.from_scipy(csr, dtype, device)
    if prefer == "csr":
        return CsrMatrix.from_scipy(csr, dtype, device)
    raise ValueError(f"prefer={prefer!r}: the port's backends are 'dense', "
                     "'dia' and 'csr'")


def lowers_to_dia(nrows, ncols, ndiag) -> bool:
    """Whether :func:`ell_from_scipy`'s rule picks DIA for a system of this
    size with ``ndiag`` distinct diagonals."""
    return (nrows * ncols > DENSE_MAX_ENTRIES
            and 0 < ndiag <= DIA_AUTO_MAX_OFFSETS)


@dataclasses.dataclass(frozen=True)
class LPProblem:
    """Lowered LP: min cᵀx, A_e x = b_e, bl ≤ A_i x ≤ bu, l ≤ x ≤ u.
    Absent constraint systems are ``None``."""

    c: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    a_eq: object
    b_eq: torch.Tensor | None
    a_ineq: object
    b_lower: torch.Tensor | None
    b_upper: torch.Tensor | None
    n: int
    m_eq: int
    m_ineq: int


# ----------------------------------------------------------------------
# numpy layout helpers: copies of pysparselp_tpu/problem.py (anchor_align,
# aligned_offset_count, embed_matrix, ALIGN_PAD_RHS, apply_align_embedding,
# dia_offsets); tests/test_torch_slice.py holds them equal
# ----------------------------------------------------------------------


def anchor_align(mats):
    """Anchor-aligned embedding: the diagonal-collapsing presolve.

    LPs built from batched constraint templates over structured index sets
    (image grids, batched differences — e.g. the Potts model,
    ``reference/pysparselp/examples/example_pott_segmentation.py:39-51``)
    have *piecewise*-affine column patterns: plain (row, col) ordering
    scatters the nonzeros over O(grid side) diagonals, and RCM makes it
    worse (Potts-50: 107 → 2412 diagonals).

    This embedding instead derives positions from the sparsity pattern
    itself: every row is keyed by its **anchor** (smallest column), every
    column by its **home** (the most common anchor among rows touching it).
    Rows/columns are placed at ``T·rank(key) + slot`` where ``T`` is the
    largest key-group size.  Constraint templates that advance through the
    index set in lockstep then land on O(#templates²) exact diagonals
    regardless of grid jumps (Potts-50: 17 diagonals, 6× less padding than
    raw DIA).  The price is zero-padded row/column slots — free in DIA
    storage.

    ``mats``: list of scipy sparse matrices sharing their column space
    (e.g. ``[a_eq, a_ineq]``; entries may be None).  Returns
    ``(row_pos_list, col_pos, m_new_list, n_new)`` with original→new
    position arrays per system; padded slots hold no rows/cols.
    """
    live = [scipy.sparse.csr_matrix(m) for m in mats if m is not None]
    if not live:
        raise ValueError("anchor_align needs at least one matrix")
    n = live[0].shape[1]
    joint = live[0] if len(live) == 1 else scipy.sparse.vstack(live).tocsr()
    joint.sort_indices()
    cnt = np.diff(joint.indptr)
    nonempty = cnt > 0
    anchor_r = np.zeros(joint.shape[0], np.int64)
    anchor_r[nonempty] = joint.indices[joint.indptr[:-1][nonempty]]

    # column home = mode of the anchors of the rows containing the column
    coo = joint.tocoo()
    ra = anchor_r[coo.row]
    order = np.lexsort((ra, coo.col))
    cs, as_ = coo.col[order], ra[order]
    # run-length encode (col, anchor) pairs
    new_pair = np.empty(cs.size, bool)
    if cs.size:
        new_pair[0] = True
        new_pair[1:] = (cs[1:] != cs[:-1]) | (as_[1:] != as_[:-1])
    starts = np.nonzero(new_pair)[0]
    u_col = cs[starts]
    u_anch = as_[starts]
    counts = np.diff(np.append(starts, cs.size))
    # per column, the anchor with max count: sort by (col, count) and take
    # the last entry of each col run
    o2 = np.lexsort((counts, u_col))
    uc2, ua2 = u_col[o2], u_anch[o2]
    last = np.empty(uc2.size, bool)
    if uc2.size:
        last[:-1] = uc2[1:] != uc2[:-1]
        last[-1] = True
    home = np.full(n, -1, np.int64)
    home[uc2[last]] = ua2[last]
    col_live = home >= 0

    keys = np.unique(np.concatenate([anchor_r[nonempty],
                                     home[col_live]]))
    n_ranks = keys.size

    def _slot(ranks):
        order = np.argsort(ranks, kind="stable")
        sr = ranks[order]
        first = np.searchsorted(sr, sr, side="left")
        within = np.empty(ranks.size, np.int64)
        within[order] = np.arange(ranks.size) - first
        return within

    rank_col = np.searchsorted(keys, home[col_live])
    w_col = _slot(rank_col)
    rank_rows = []
    w_rows = []
    for mat in live:
        ne = np.diff(mat.indptr) > 0
        mat.sort_indices()
        ar = np.zeros(mat.shape[0], np.int64)
        ar[ne] = mat.indices[mat.indptr[:-1][ne]]
        rr = np.searchsorted(keys, ar[ne])
        rank_rows.append((ne, rr))
        w_rows.append(_slot(rr))
    t = max(
        [int(w_col.max()) + 1 if w_col.size else 1]
        + [int(w.max()) + 1 if w.size else 1 for w in w_rows]
    )
    base = n_ranks * t

    col_pos = np.empty(n, np.int64)
    col_pos[col_live] = rank_col * t + w_col
    col_pos[~col_live] = base + np.arange(int((~col_live).sum()))
    n_new = base + int((~col_live).sum())

    row_pos_list, m_new_list = [], []
    for (ne, rr), w in zip(rank_rows, w_rows):
        pos = np.empty(ne.size, np.int64)
        pos[ne] = rr * t + w
        pos[~ne] = base + np.arange(int((~ne).sum()))
        row_pos_list.append(pos)
        m_new_list.append(base + int((~ne).sum()))
    out_rows, out_m = [], []
    i = 0
    for m in mats:
        if m is None:
            out_rows.append(None)
            out_m.append(None)
        else:
            out_rows.append(row_pos_list[i])
            out_m.append(m_new_list[i])
            i += 1
    return out_rows, col_pos, out_m, n_new


def aligned_offset_count(mats, return_plan=False, return_spans=False) -> tuple:
    """Preview of :func:`anchor_align`: per-system diagonal counts and the
    embedded sizes, without materializing the embedded matrices.  With
    ``return_plan=True`` also returns the computed position plan so the
    caller can apply the embedding without re-running the (O(nnz log nnz))
    alignment.  With ``return_spans=True`` additionally returns per-system
    ``(off_min, off_max)`` pairs (None for absent systems)."""
    plan = anchor_align(mats)
    row_pos_list, col_pos, m_new_list, n_new = plan
    counts = []
    spans = []
    for m, pos in zip(mats, row_pos_list):
        if m is None:
            counts.append(0)
            spans.append(None)
            continue
        coo = scipy.sparse.coo_matrix(m)
        off = col_pos[coo.col] - pos[coo.row]
        counts.append(int(np.unique(off).size))
        spans.append((int(off.min()), int(off.max())) if off.size
                     else (0, 0))
    out = (counts, m_new_list, n_new)
    if return_spans:
        out += (spans,)
    if return_plan:
        out += (plan,)
    return out


def embed_matrix(a, row_pos, col_pos, m_new, n_new):
    """Scatter a sparse matrix into the embedded (padded) position space."""
    coo = scipy.sparse.coo_matrix(a)
    return scipy.sparse.coo_matrix(
        (coo.data, (row_pos[coo.row], col_pos[coo.col])),
        shape=(m_new, n_new),
    ).tocsr()


ALIGN_PAD_RHS = 1e30  # padded inequality rows: 0 <= big is never active


def apply_align_embedding(plan, sys):
    """Apply an :func:`anchor_align` position plan to a problem dict.

    ``sys`` holds ``a_eq, beq, a_ineq, b_ineq, c, lb, ub`` and optionally
    ``x0, x30, y_eq0, y_ineq0`` (inequalities already one-sided).  Returns
    ``(new_sys, pos_eq, pos_in, col_pos)`` with the embedded matrices,
    scattered vectors (padded rows get the never-active rhs sentinel for
    inequalities / 0 for equalities; padded columns are fixed at zero:
    ``c = 0, l = u = 0``), and the original→new position maps.
    """
    (pe, pi), col_pos, (me, mi), n_new = plan
    out = dict(sys)
    pos_eq = pos_in = None
    if sys.get("a_eq") is not None:
        out["a_eq"] = embed_matrix(sys["a_eq"], pe, col_pos, me, n_new)
        b2 = np.zeros(me)
        b2[pe] = np.asarray(sys["beq"], np.float64)
        out["beq"] = b2
        pos_eq = pe
        if sys.get("y_eq0") is not None:
            y2 = np.zeros(me)
            y2[pe] = np.asarray(sys["y_eq0"], np.float64)
            out["y_eq0"] = y2
    if sys.get("a_ineq") is not None:
        out["a_ineq"] = embed_matrix(sys["a_ineq"], pi, col_pos, mi, n_new)
        b2 = np.full(mi, ALIGN_PAD_RHS)
        b2[pi] = np.asarray(sys["b_ineq"], np.float64)
        out["b_ineq"] = b2
        pos_in = pi
        if sys.get("y_ineq0") is not None:
            y2 = np.zeros(mi)
            y2[pi] = np.asarray(sys["y_ineq0"], np.float64)
            out["y_ineq0"] = y2

    def scatter_cols(v):
        o = np.zeros(n_new)
        o[col_pos] = np.asarray(v, np.float64)
        return o

    for k in ("c", "lb", "ub", "x0", "x30"):
        if sys.get(k) is not None:
            out[k] = scatter_cols(sys[k])
    return out, pos_eq, pos_in, col_pos


def dia_offsets(a) -> np.ndarray:
    """Distinct (col − row) diagonal offsets of the matrix, ascending."""
    coo = scipy.sparse.coo_matrix(a)
    if coo.nnz == 0:
        return np.zeros(0, np.int64)
    off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    return np.unique(off)
