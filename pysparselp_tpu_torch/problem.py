"""Device LP problem containers for the PyTorch port (mirrors
``pysparselp_tpu/problem.py``).

``solve()`` lowers the finished host model once into an :class:`LPProblem`
of torch tensors on one device.  :func:`ell_from_scipy` lowers each
constraint system to one of these operators:

* :class:`DenseMatrix` — ``A @ x`` is a plain ``matmul`` (the JAX package
  leaves this product to XLA as well);
* :class:`DiaMatrix` — few distinct ``(col - row)`` diagonals (the
  anchor-aligned grid LPs); both SpMV directions run the hand-written
  H-DIA kernel (:mod:`pysparselp_tpu_torch.ops.dia_spmv`) on CUDA;
* :class:`PartitionMatrix` — assignment/simplex rows (one contiguous
  column run per row on a fixed stride): a strided window of ``x`` times a
  dense value table, plain torch;
* :class:`CsrMatrix` — unstructured systems; both directions run the
  hand-written H-CSR kernel (:mod:`pysparselp_tpu_torch.ops.csr_spmv`) on
  CUDA, over the CSR of ``A`` and of ``Aᵀ``;
* :class:`BsrMatrix` — clustered systems (after the RCM layout presolve):
  one set of small dense tiles, the nonzero ones only, indexed by tile-row
  and by tile-column; both directions run the hand-written H-BSR kernel
  (:mod:`pysparselp_tpu_torch.ops.bsr_spmv`) on CUDA;
* :class:`ColBlockMatrix` — contiguous column blocks, each lowered by the
  same chooser (a dense head beside a sparse tail, ``[A | ±I]`` shapes).

Every operator but :class:`BsrMatrix` also takes a batch-last operand: its
``matvec`` maps ``(ncols, B)`` to ``(nrows, B)`` and its ``rmatvec`` maps
``(nrows, B)`` to ``(ncols, B)``, one column per problem of a batched solve
(:mod:`pysparselp_tpu_torch.batch`).  DIA and CSR run their batched kernels
H-DIA-B and H-CSR-B on CUDA, dense runs one ``matmul`` for the batch,
partition and column blocks the same plain torch with a trailing axis.

The numpy layout helpers (:func:`anchor_align`, :func:`aligned_offset_count`,
:func:`embed_matrix`, :func:`apply_align_embedding`, :func:`dia_offsets`,
:func:`partition_geometry`, :func:`_candidate_cuts`, :func:`col_split_plan`,
:func:`rcm_permutation`, :func:`apply_rcm_permutation`) are copies of the
JAX package's, which the port cannot import (importing any
``pysparselp_tpu`` module imports jax).  The cost model
(:func:`estimate_stream_bytes`, :func:`choose_layout`) is this card's own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse
import torch
import torch.nn.functional as F

from .ops import bsr_spmv as _bsr
from .ops import csr_spmv as _csr
from .ops.cp_dense import DENSE_FUSED_BUDGET, _pad128
from .ops.dia_spmv import DiaOperand, dia_apply, dia_spmm, widen

# The layout chooser (estimate_stream_bytes) prices each candidate by the
# bytes one SpMV pair (A x and Aᵀ y) moves, counted from the shapes: each
# value, index and vector read once, each output written once.  These byte
# counts are a model, to be calibrated against H100 times in the port's
# benchmark (ROADMAP M4) with scripts/probe_csr_spmv.py and the kernel
# times chip_smoke.py records; none of the JAX package's TPU calibrations
# (ELL_GATHER_BYTES_PER_NNZ, DIA_PALLAS_COST_PER_ENTRY, ...) carries over.
DENSE_AUTO_MAX_ENTRIES = 64 * 1024 * 1024   # the dense operator limit
DIA_AUTO_MAX_OFFSETS = 32
# the block-sparse candidate's limit on stored tile entries (its one tile
# set), the JAX package's value
BSR_AUTO_MAX_ENTRIES = 128 * 1024 * 1024
# H-BSR gives each tile-row (A x) and each tile-column (Aᵀ y) one warp,
# which loads a batch of tile values (BsrOperand.warp_batch_bytes) and waits
# one round trip of its loads before the next; Aᵀ y's round trip is two
# loads deep (the tile's position, then the tile).  So a product takes at
# least the longest line's bytes at one warp's rate, batch bytes per round
# trip: priced as the bytes the card streams meanwhile, line bytes ×
# warp_line_price(itemsize).  Checked on the L1-SVM system after RCM, whose
# longest tile-column holds 3,755 16×16 f32 tiles (3.85 MB): the model
# gives 657 µs, its Aᵀ y took 685-697 µs (scripts/compare_kernels.py;
# NVIDIA H100 80GB HBM3, 700 W).
HBM_BYTES_PER_S = 3.35e12    # the H100's memory rate
BSR_ROUND_TRIP_S = 0.7e-6    # two dependent global loads on the H100


def warp_line_price(itemsize: int) -> float:
    """Bytes the card streams per byte of H-BSR's longest tile-line (the
    card's rate over one warp's)."""
    return (HBM_BYTES_PER_S * BSR_ROUND_TRIP_S
            / _bsr.BsrOperand.warp_batch_bytes(itemsize))


# one gathered x entry of a CSR product: a whole 32-byte sector, since
# unstructured column indices share no sector
CSR_GATHER_BYTES = 32
# An LP whose every system is DIA runs H-CPDIA: two launches per iteration
# for the whole LP, where the per-operator iteration launches ~2 SpMVs per
# system and ~15 elementwise kernels.  A launch is priced at the bytes the
# card streams while the host issues it: ~4.5 us per launch (the Potts-50
# restart solve of scripts/profile_port.py: ~8.9 us of host time per
# two-launch iteration, NVIDIA H100 80GB HBM3, 700 W) at 3.35 TB/s.  DIA is
# credited with the launches it saves.
LAUNCH_BYTES = 15_000_000
PER_OP_LAUNCHES = 17
FUSED_LAUNCHES = 2
FUSED_CREDIT_BYTES = (PER_OP_LAUNCHES - FUSED_LAUNCHES) * LAUNCH_BYTES


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


def default_dtype() -> torch.dtype:
    """The dtype the layout chooser prices with: float32, the card's
    working dtype, whatever the run's dtype, so a float64 run lowers to the
    same operators as the float32 card run it is checked against."""
    return torch.float32


def abs_pow0(v, p):
    """``|v|**p`` with ``0**0 == 0`` (stored zeros never count toward the
    preconditioner sums; mirrors the JAX helper)."""
    av = v.abs()
    return torch.where(av > 0, av ** p, torch.zeros_like(av))


def _tensor(v, dtype, device):
    return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                           device=device)


def _squared(op, make):
    """The operand of ``A∘A`` that ``sq_rowsum_weighted`` runs the
    operator's kernel on: ``make()`` on the first call, then kept on the
    (frozen) operator."""
    sq = op.__dict__.get("_sq")
    if sq is None:
        sq = make()
        object.__setattr__(op, "_sq", sq)
    return sq


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

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nnz_padded(self):
        return self.a.numel()

    def matvec(self, x):
        return self.a @ x

    def rmatvec(self, y):
        return y @ self.a if y.dim() == 1 else self.a.T @ y

    def abs_power_rowsum(self, p):
        return abs_pow0(self.a, p).sum(dim=1)

    def abs_power_colsum(self, p):
        return abs_pow0(self.a, p).sum(dim=0)

    def sq_rowsum_weighted(self, d):
        """``Σ_j a_ij² d_j`` per row, ``diag(A·diag(d)·Aᵀ)``."""
        return (self.a * self.a) @ d

    @staticmethod
    def from_scipy(a, dtype, device) -> "DenseMatrix":
        csr = scipy.sparse.csr_matrix(a)
        return DenseMatrix(a=_tensor(csr.toarray(), dtype, device),
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

    The planes are stored in bfloat16 where the JAX package stores them so
    (:meth:`from_scipy`'s ``allow_bf16``): a float32 operator whose every
    value is exact in bfloat16 streams half the plane bytes.  Products and
    sums run in the solve dtype (``dtype``): every kernel and twin widens a
    plane value exactly as it reads it, so a bfloat16 operator computes
    bit for bit what its float32 copy computes.
    """

    vals: torch.Tensor     # (ndiag, nrows)
    vals_t: torch.Tensor   # (ndiag_t, ncols)
    offsets: tuple
    offsets_t: tuple
    offs: torch.Tensor     # int32 (ndiag,)
    offs_t: torch.Tensor   # int32 (ndiag_t,)
    nrows: int
    ncols: int
    # both orientations ready to launch, checked once
    fwd: DiaOperand = dataclasses.field(init=False, repr=False,
                                        compare=False)
    bwd: DiaOperand = dataclasses.field(init=False, repr=False,
                                        compare=False)

    def __post_init__(self):
        object.__setattr__(self, "fwd",
                           DiaOperand(self.vals, self.offs, self.nrows))
        object.__setattr__(self, "bwd",
                           DiaOperand(self.vals_t, self.offs_t, self.ncols))

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nnz_padded(self):
        return self.vals.numel() + self.vals_t.numel()

    @property
    def ndiag(self):
        return len(self.offsets)

    @property
    def dtype(self):
        """The solve dtype: the planes' own, float32 for bfloat16 planes."""
        return self.fwd.dtype

    def matvec(self, x):
        if x.dim() == 1:
            return dia_apply(self.fwd, x)
        return dia_spmm(self.fwd, x)

    def rmatvec(self, y):
        if y.dim() == 1:
            return dia_apply(self.bwd, y)
        return dia_spmm(self.bwd, y)

    def abs_power_rowsum(self, p):
        return abs_pow0(widen(self.vals), p).sum(dim=0)

    def abs_power_colsum(self, p):
        return abs_pow0(widen(self.vals_t), p).sum(dim=0)

    def sq_rowsum_weighted(self, d):
        """H-DIA on the squared value planes (built once, squared in the
        solve dtype: a bfloat16 square is not exact in general)."""
        def make():
            v = widen(self.vals)
            return DiaOperand(v * v, self.offs, self.nrows)

        return dia_apply(_squared(self, make), d)

    @staticmethod
    def from_planes(vals, offsets, vals_t, offsets_t, nrows, ncols, dtype,
                    device, plane_dtype=None) -> "DiaMatrix":
        """From ``(ndiag, nrows)`` / ``(ndiag_t, ncols)`` planes, stored as
        ``plane_dtype`` (default ``dtype``; bfloat16 only with float32): a
        torch tensor keeps its own dtype, host arrays are rounded to it."""
        def i32(o):
            return torch.as_tensor(np.asarray(o, np.int32).reshape(-1),
                                   device=device)

        def planes(v, rows, cols):
            v = (v.to(device) if torch.is_tensor(v)
                 else _tensor(v, plane_dtype or dtype, device))
            if v.dtype != dtype and (v.dtype, dtype) != (torch.bfloat16,
                                                         torch.float32):
                raise TypeError(f"DiaMatrix: {v.dtype} planes for a {dtype} "
                                "solve (bfloat16 planes serve float32 only)")
            return v.reshape(rows, cols)

        return DiaMatrix(
            vals=planes(vals, len(offsets), nrows),
            vals_t=planes(vals_t, len(offsets_t), ncols),
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
    def from_scipy(a, dtype, device, allow_bf16="exact") -> "DiaMatrix":
        """The DIA operator of a scipy matrix, its planes stored as the
        JAX package's ``DiaMatrix.from_scipy`` stores them
        (:func:`dia_plane_dtype`)."""
        coo = scipy.sparse.coo_matrix(a)
        coo.sum_duplicates()
        m, n = coo.shape
        vals, offsets = DiaMatrix._planes(coo, m)
        vals_t, offsets_t = DiaMatrix._planes(coo.T.tocoo(), n)
        return DiaMatrix.from_planes(
            vals, offsets, vals_t, offsets_t, m, n, dtype, device,
            dia_plane_dtype(coo.data, dtype, allow_bf16))

    def widened(self) -> "DiaMatrix":
        """This operator with its planes stored in the solve dtype: a copy
        of bfloat16 planes, widened exactly; ``self`` where they are
        already."""
        if self.vals.dtype == self.dtype:
            return self
        return dataclasses.replace(self, vals=widen(self.vals),
                                   vals_t=widen(self.vals_t))


def one_plane_storage(ops):
    """``ops``, one problem's constraint systems (``None`` kept), as
    H-CPDIA reads them: where every present system is a DiaMatrix and
    their planes are stored in different dtypes (one exact in bfloat16,
    another not), each re-stored in the solve dtype
    (:meth:`DiaMatrix.widened`), since a launch reads every plane in one
    storage dtype.  Widening is exact: every product is unchanged."""
    present = [op for op in ops if op is not None]
    if (not all(isinstance(op, DiaMatrix) for op in present)
            or len({op.vals.dtype for op in present}) <= 1):
        return list(ops)
    return [None if op is None else op.widened() for op in ops]


def dia_plane_dtype(values, dtype, allow_bf16="exact") -> torch.dtype:
    """The dtype JAX's ``DiaMatrix.from_scipy(a, dtype, allow_bf16)``
    stores the planes of a matrix holding ``values`` in: bfloat16 for a
    float32 ``dtype`` where ``allow_bf16`` is ``"always"`` (rounded), or
    ``"exact"`` and every value survives bfloat16 unchanged; else
    ``dtype`` (``allow_bf16=False``, float64, no entries).  With
    ``"exact"`` this is also the rule of JAX's ``RoutedEllMatrix.
    from_scipy`` (``pysparselp_tpu/ops/ell_routed.py:1421-1429``) and
    ``PartitionMatrix.from_scipy`` (``_bf16_exact``)."""
    values = np.asarray(values)
    if dtype != torch.float32 or not allow_bf16 or values.size == 0:
        return dtype
    if allow_bf16 == "always":
        return torch.bfloat16
    v = torch.as_tensor(values.astype(np.float32))
    exact = bool((v.to(torch.bfloat16).float() == v).all())
    return torch.bfloat16 if exact else dtype


# the storage of CSR values and of a partition's value table: the DIA rule
csr_value_dtype = dia_plane_dtype


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """Unstructured operator: the CSR of ``A`` (``csr``) serves ``A @ x``
    and the CSR of ``Aᵀ`` (``csr_t``, the CSC of ``A``) serves ``Aᵀ @ y``,
    both through :func:`~pysparselp_tpu_torch.ops.csr_spmv.csr_spmv`
    (H-CSR on CUDA).  Each orientation carries its launch plan (lanes per
    row, long rows cut into chunks), built once here.

    The values are stored in bfloat16 where the JAX operator this one
    mirrors stores them so (:meth:`from_scipy`'s ``allow_bf16``): a
    float32 operator whose every value is exact in bfloat16 streams half
    the value bytes.  Products and sums run in the solve dtype (each
    orientation's ``dtype``): H-CSR and the twins widen each value exactly
    as they read it, so a bfloat16 operator computes bit for bit what its
    float32 copy computes."""

    csr: _csr.CsrOperand
    csr_t: _csr.CsrOperand
    nrows: int
    ncols: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nnz_padded(self):
        return self.vals.numel()

    # the arrays of each orientation
    indptr = property(lambda self: self.csr.indptr)
    indices = property(lambda self: self.csr.indices)
    vals = property(lambda self: self.csr.vals)
    indptr_t = property(lambda self: self.csr_t.indptr)
    indices_t = property(lambda self: self.csr_t.indices)
    vals_t = property(lambda self: self.csr_t.vals)

    def matvec(self, x):
        if x.dim() == 1:
            return _csr.csr_spmv(self.csr, x)
        return _csr.csr_spmm(self.csr, x)

    def rmatvec(self, y):
        if y.dim() == 1:
            return _csr.csr_spmv(self.csr_t, y)
        return _csr.csr_spmm(self.csr_t, y)

    def matvec_plus(self, x, base):
        """``base + A x`` (:func:`~pysparselp_tpu_torch.ops.csr_spmv.
        csr_spmv_plus`)."""
        return _csr.csr_spmv_plus(self.csr, x, base)

    def rmatvec_plus(self, y, base):
        """``base + Aᵀ y``."""
        return _csr.csr_spmv_plus(self.csr_t, y, base)

    @staticmethod
    def _row_sum(indptr, v, n):
        rows = torch.repeat_interleave(torch.arange(n, device=v.device),
                                       indptr.diff().long())
        return torch.zeros(n, dtype=v.dtype, device=v.device).index_add_(
            0, rows, v)

    # the reductions widen bfloat16 values first: a bfloat16 power or sum
    # would round
    def abs_power_rowsum(self, p):
        return self._row_sum(self.indptr, abs_pow0(widen(self.vals), p),
                             self.nrows)

    def abs_power_colsum(self, p):
        return self._row_sum(self.indptr_t, abs_pow0(widen(self.vals_t), p),
                             self.ncols)

    def sq_rowsum_weighted(self, d):
        """H-CSR on the squared values, over A's plan (built once; squared
        in the solve dtype: a bfloat16 square is not exact in general)."""
        c = self.csr

        def make():
            v = widen(c.vals)
            return _csr.CsrOperand(c.indptr, c.indices, v * v, c.n_in,
                                   c.plan)

        return _csr.csr_spmv(_squared(self, make), d)

    @staticmethod
    def from_scipy(a, dtype, device, fused=False,
                   allow_bf16=False) -> "CsrMatrix":
        """The CSR operator of a scipy matrix, computing in ``dtype``.
        ``allow_bf16`` stores the values as :func:`csr_value_dtype` says:
        ``False`` (the default) keeps ``dtype``, as JAX's gather layouts
        (``EllMatrix``, ``SegmentedEllMatrix``, the batch path's and the
        shards' operators) do; ``"exact"`` stores bfloat16 for float32
        where every value is exact there, as JAX's ``RoutedEllMatrix``
        does (the lowering, :func:`ell_from_scipy`, passes it);
        ``"always"`` rounds them to bfloat16.  ``fused=True``: on the CPU,
        both products round each row as a fused multiply-add chain, as the
        JAX package's gather products do there (the dual ascent solvers,
        whose exact comparisons of reduced costs need that rounding)."""
        csr = scipy.sparse.csr_matrix(a, dtype=np.float64)
        csr.sum_duplicates()
        if csr.nnz > _csr.MAX_NNZ:
            raise ValueError(f"{csr.nnz} entries do not fit int32 indices")
        csc = csr.tocsc()
        m, n = csr.shape
        store = csr_value_dtype(csr.data, dtype, allow_bf16)
        return CsrMatrix(
            csr=_csr.CsrOperand.from_host(csr.indptr, csr.indices, csr.data,
                                          n, dtype, device, fused, store),
            csr_t=_csr.CsrOperand.from_host(csc.indptr, csc.indices,
                                            csc.data, m, dtype, device,
                                            fused, store),
            nrows=m, ncols=n)


@dataclasses.dataclass(frozen=True)
class BsrMatrix:
    """Block-sparse operator (the JAX ``BsrMatrix``,
    ``pysparselp_tpu/ops/bsr_pallas.py:236-346``, in the port's own
    format): ONE tile set, a CSR of the nonzero ``T×T`` tiles of ``A`` with
    a tile-column index beside it (:class:`~pysparselp_tpu_torch.ops.
    bsr_spmv.BsrOperand`), serves ``A @ x`` and ``Aᵀ @ y``, both through
    :func:`~pysparselp_tpu_torch.ops.bsr_spmv.bsr_spmv` (H-BSR on CUDA).
    The zeros inside the stored tiles count as zero in the reductions."""

    op: _bsr.BsrOperand
    nrows: int
    ncols: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def tile(self):
        return self.op.tile

    @property
    def nnz_padded(self):
        """The stored entries: nonzero tiles × T², once per tile set."""
        return self.op.stored_entries

    def matvec(self, x):
        return _bsr.bsr_spmv(self.op, x)

    def rmatvec(self, y):
        return _bsr.bsr_spmv(self.op, y, transpose=True)

    def abs_power_rowsum(self, p):
        return self.op.line_sum(abs_pow0(self.op.tiles, p).sum(dim=2))

    def abs_power_colsum(self, p):
        parts = abs_pow0(self.op.tiles, p).sum(dim=1)
        return self.op.line_sum(parts[self.op.tile_of.long()],
                                transpose=True)

    def sq_rowsum_weighted(self, d):
        """H-BSR on the squared tile set (built once)."""
        return _bsr.bsr_spmv(_squared(self, self.op.squared), d)

    @staticmethod
    def from_scipy(a, dtype, device,
                   tile=_bsr.DEFAULT_TILE) -> "BsrMatrix":
        op = _bsr.BsrOperand.from_scipy(a, dtype, device, tile)
        return BsrMatrix(op=op, nrows=op.nrows, ncols=op.ncols)


# partition_geometry: verbatim copy of pysparselp_tpu/problem.py:316-343
def partition_geometry(csr):
    """``(col0, stride, width)`` if every row's nonzeros occupy a
    contiguous column run of one fixed ``width``, with the runs advancing
    by one fixed ``stride >= width`` (so the runs never overlap) from a
    base column ``col0`` — the assignment/partition pattern: simplex rows
    of assignment LPs (one row per point over its candidate block, e.g.
    the k-medians LP, ``reference/pysparselp/examples/
    example_kmedians.py:40-44``), transport-LP source equalities over
    arc blocks, one-hot label sums.  Returns ``None`` otherwise."""
    m, n = csr.shape
    if m == 0 or csr.nnz == 0:
        return None
    cnt = np.diff(csr.indptr)
    w = int(cnt[0])
    if w <= 0 or not np.all(cnt == w):
        return None
    if not csr.has_sorted_indices:
        csr = csr.sorted_indices()
    idx = csr.indices.reshape(m, w)
    starts = idx[:, 0].astype(np.int64)
    if not np.all(idx == starts[:, None] + np.arange(w)[None, :]):
        return None
    if m == 1:
        return int(starts[0]), w, w
    stride = int(starts[1] - starts[0])
    if stride < w or not np.all(np.diff(starts) == stride):
        return None
    return int(starts[0]), stride, w


@dataclasses.dataclass(frozen=True)
class PartitionMatrix:
    """Partition/assignment operator: SpMV as reshape + multiply-reduce
    (mirrors the JAX ``PartitionMatrix``, ``problem.py:352-453``).

    Rows whose nonzeros are one contiguous ``width``-column run advancing
    by a fixed ``stride`` (:func:`partition_geometry`) need no gathers:
    ``A @ x`` is a strided window of ``x`` reshaped to ``(m, stride)``
    against the dense ``(m, width)`` value table, and ``Aᵀ @ y`` is the
    same reshape run backwards (every slot owns a distinct column, so the
    scatter is a flatten).  No TPU kernel stands behind it in the JAX
    package; plain torch serves both directions here too.

    The value table is stored as JAX stores it (:meth:`from_scipy`'s
    ``allow_bf16``): bfloat16 for a float32 operator whose every value is
    exact there.  Every product and sum runs in the solve dtype:
    ``matvec`` and ``rmatvec`` multiply the table by a
    vector (or a batch-last ``(m, width, B)`` window) of the solve dtype,
    which promotes each value exactly, as JAX's ``vals.astype(x.dtype)``;
    the reductions widen the table first.
    """

    vals: torch.Tensor   # (nrows, width); bfloat16 when exact for float32
    col0: int
    stride: int
    width: int
    nrows: int
    ncols: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nnz_padded(self):
        return self.vals.numel()

    @property
    def _span(self):
        return (self.nrows - 1) * self.stride + self.width

    def _window(self, x):
        """The ``(m, width)`` view of ``x`` each row multiplies (``(m,
        width, B)`` for a batch-last ``x``)."""
        m, w, s = self.nrows, self.width, self.stride
        xs = x[self.col0:self.col0 + self._span]
        tail = tuple(xs.shape[1:])
        if s > w:
            xs = F.pad(xs, (0, 0) * len(tail) + (0, m * s - self._span))
            return xs.reshape((m, s) + tail)[:, :w]
        return xs.reshape((m, w) + tail)

    def matvec(self, x):
        if x.dim() == 1:
            return torch.sum(self.vals * self._window(x), dim=1)
        return torch.sum(self.vals[:, :, None] * self._window(x), dim=1)

    def _scatter(self, contrib):
        """Place ``(m, width)`` per-slot values (``(m, width, B)`` for a
        batch) at their columns."""
        s, w = self.stride, self.width
        tail = tuple(contrib.shape[2:])
        pad = (0, 0) * len(tail)
        if s > w:
            contrib = F.pad(contrib, pad + (0, s - w))
        flat = contrib.reshape((-1,) + tail)[:self._span]
        return F.pad(flat, pad + (self.col0,
                                  self.ncols - self.col0 - self._span))

    def rmatvec(self, y):
        if y.dim() == 1:
            return self._scatter(self.vals * y[:, None])
        return self._scatter(self.vals[:, :, None] * y[:, None, :])

    def abs_power_rowsum(self, p):
        return torch.sum(abs_pow0(widen(self.vals), p), dim=1)

    def abs_power_colsum(self, p):
        return self._scatter(abs_pow0(widen(self.vals), p))

    def sq_rowsum_weighted(self, d):
        v = widen(self.vals)
        return torch.sum(v * v * self._window(d), dim=1)

    @staticmethod
    def from_scipy(a, dtype, device, allow_bf16="exact") -> "PartitionMatrix":
        """The partition operator of a scipy matrix, its value table
        stored as JAX's ``PartitionMatrix.from_scipy`` stores it
        (:func:`csr_value_dtype`; ``"exact"``, JAX's only rule, by
        default)."""
        csr = scipy.sparse.csr_matrix(a)
        if not csr.has_sorted_indices:
            csr = csr.sorted_indices()
        geo = partition_geometry(csr)
        if geo is None:
            raise ValueError("matrix rows are not a fixed-width "
                             "contiguous-column partition pattern")
        col0, stride, w = geo
        store = csr_value_dtype(csr.data, dtype, allow_bf16)
        return PartitionMatrix(
            vals=_tensor(csr.data.reshape(csr.shape[0], w), store, device),
            col0=col0, stride=stride, width=w, nrows=csr.shape[0],
            ncols=csr.shape[1])


@dataclasses.dataclass(frozen=True)
class ColBlockMatrix:
    """Composite operator: contiguous column blocks, each lowered by the
    chooser on its own (mirrors the JAX ``ColBlockMatrix``,
    ``problem.py:635-701``).  ``matvec`` sums the block products (every
    block yields a full-height output); ``rmatvec`` concatenates the block
    results in column order.  The cuts come from :func:`col_split_plan`.
    """

    blocks: tuple       # lowered sub-operators, in column order
    col_starts: tuple   # block b covers cols [starts[b], starts[b+1])
    nrows: int
    ncols: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nnz_padded(self):
        return sum(b.nnz_padded for b in self.blocks)

    def _slices(self, x):
        s = self.col_starts
        return [x[s[b]:s[b + 1]] for b in range(len(self.blocks))]

    def matvec(self, x):
        parts = self._slices(x)
        out = self.blocks[0].matvec(parts[0])
        for blk, xs in zip(self.blocks[1:], parts[1:]):
            out = out + blk.matvec(xs)
        return out

    def rmatvec(self, y):
        return torch.cat([b.rmatvec(y) for b in self.blocks])

    def abs_power_rowsum(self, p):
        out = self.blocks[0].abs_power_rowsum(p)
        for blk in self.blocks[1:]:
            out = out + blk.abs_power_rowsum(p)
        return out

    def abs_power_colsum(self, p):
        return torch.cat([b.abs_power_colsum(p) for b in self.blocks])

    def sq_rowsum_weighted(self, d):
        parts = self._slices(d)
        out = self.blocks[0].sq_rowsum_weighted(parts[0])
        for blk, ds in zip(self.blocks[1:], parts[1:]):
            out = out + blk.sq_rowsum_weighted(ds)
        return out


# ----------------------------------------------------------------------
# the layout chooser
# ----------------------------------------------------------------------


def fits_dense_chunk(m, n) -> bool:
    """A system small enough for H-CPDENSE's budget (and under the dense
    limit) is dense: that kernel runs a whole chunk in one launch, where
    any per-operator layout pays ~17 launches per iteration, which bound
    it at this size rather than its bytes."""
    return (0 < m * n <= DENSE_AUTO_MAX_ENTRIES
            and _pad128(m) * _pad128(n) * 4 <= DENSE_FUSED_BUDGET)


def _dense_bytes(m, n, s):
    return 2 * m * n * s + 2 * (m + n) * s


def _dia_bytes(ndiag, m, n, s):
    return ndiag * (m + n) * s + 2 * (m + n) * s


def _csr_bytes(nnz, m, n, s):
    # values and int32 indices per direction, the two row-pointer arrays,
    # one sector per gathered entry, both outputs
    return (2 * nnz * (s + 4) + (m + n + 2) * 4 + 2 * nnz * CSR_GATHER_BYTES
            + (m + n) * s)


def _bsr_bytes(n_tiles, longest, m, n, s, tile=_bsr.DEFAULT_TILE,
               line_price=None):
    # per direction: the one tile set, its int32 tile ids (one per tile for
    # A x, two for Aᵀ y), the pointers, x in and y out; or, where more,
    # the longest line (``longest``: tile-row, tile-column) at one warp's
    # rate (``line_price`` bytes per byte, warp_line_price by default)
    if line_price is None:
        line_price = warp_line_price(s)
    tile_bytes = tile * tile * s
    total = 0
    for ids, lines, line in ((1, -(-m // tile), longest[0]),
                             (2, -(-n // tile), longest[1])):
        stream = (n_tiles * (tile_bytes + 4 * ids) + (lines + 1) * 4
                  + (m + n) * s)
        total += max(stream, line_price * line * tile_bytes)
    return total


def _partition_bytes(m, n, stride, width, s):
    # the value table per direction, the window of x, y in and out, and
    # the full-width Aᵀ y output
    return 2 * m * width * s + m * stride * s + 2 * m * s + n * s


def _shape_candidates(m, n, ndiag, nnz, s):
    """Bytes per SpMV pair of the candidates that shapes alone price."""
    out = {"csr": _csr_bytes(nnz, m, n, s)}
    if m * n <= DENSE_AUTO_MAX_ENTRIES:
        out["dense"] = _dense_bytes(m, n, s)
    if 0 < ndiag <= DIA_AUTO_MAX_OFFSETS:
        out["dia"] = _dia_bytes(ndiag, m, n, s)
    return out


def _diagonal_count(csr) -> int:
    """``dia_offsets(csr).size`` where it is at most
    ``DIA_AUTO_MAX_OFFSETS``, else some count above it.  Without the sort:
    a row's distinct entries lie on distinct diagonals, so a longer row
    answers at once; otherwise one flag per possible offset."""
    m, n = csr.shape
    row_nnz = np.diff(csr.indptr)
    if (row_nnz.size and row_nnz.max() > DIA_AUTO_MAX_OFFSETS
            and csr.has_canonical_format):
        return int(row_nnz.max())
    rows = np.repeat(np.arange(m, dtype=np.int64), row_nnz)
    seen = np.zeros(m + n, bool)
    seen[csr.indices + (m - rows)] = True
    return int(np.count_nonzero(seen))


def _candidates(csr, dtype):
    """``{backend: bytes per SpMV pair}`` of the streaming candidates that
    the column-split search prices for every piece."""
    m, n = csr.shape
    s = torch.empty((), dtype=dtype).element_size()
    cands = _shape_candidates(m, n, _diagonal_count(csr), csr.nnz, s)
    geo = partition_geometry(csr)
    if geo is not None:
        _, stride, w = geo
        cands["partition"] = _partition_bytes(m, n, stride, w, s)
    return cands


def _bsr_candidate(csr, dtype, line_price=None):
    """Bytes per SpMV pair of the block-sparse candidate (its default
    tiles, priced from the counts of nonzero tiles without building them;
    ``line_price`` as :func:`_bsr_bytes`), or ``None`` past
    ``BSR_AUTO_MAX_ENTRIES`` stored entries."""
    tile = _bsr.DEFAULT_TILE
    n_tiles, *longest = _bsr.tile_counts(csr, tile)
    if n_tiles * tile * tile > BSR_AUTO_MAX_ENTRIES:
        return None
    return _bsr_bytes(n_tiles, longest, *csr.shape,
                      torch.empty((), dtype=dtype).element_size(), tile,
                      line_price)


def estimate_stream_bytes(csr, dtype=None):
    """``(backend, bytes)`` of the cheapest candidate the column-split
    search prices, by the bytes one SpMV pair moves (see the constants
    above).  Candidates: dense (≤ ``DENSE_AUTO_MAX_ENTRIES`` entries;
    always, when the system fits H-CPDENSE's budget), DIA
    (≤ ``DIA_AUTO_MAX_OFFSETS`` diagonals), partition
    (:func:`partition_geometry`) and CSR.  The block-sparse candidate is
    priced for whole systems only, by :func:`choose_layout`: its tile
    counts take a pass over the entries, which the search would pay for
    each of its up to 601 pieces."""
    dtype = dtype or default_dtype()
    csr = scipy.sparse.csr_matrix(csr)
    m, n = csr.shape
    if csr.nnz == 0:
        return "csr", 0
    if fits_dense_chunk(m, n):
        s = torch.empty((), dtype=dtype).element_size()
        return "dense", _dense_bytes(m, n, s)
    cands = _candidates(csr, dtype)
    best = min(cands, key=cands.get)
    return best, cands[best]


def operator_cost_bytes(op) -> int:
    """Bytes per SpMV pair of a LOWERED operator, by the chooser's model at
    the item size its values are stored in (bfloat16 DIA planes, CSR
    values and partition tables at 2 bytes)."""
    if op is None:
        return 0
    if isinstance(op, ColBlockMatrix):
        return sum(operator_cost_bytes(b) for b in op.blocks)
    m, n = op.shape
    if isinstance(op, DenseMatrix):
        return _dense_bytes(m, n, op.a.element_size())
    if isinstance(op, DiaMatrix):
        return _dia_bytes(op.ndiag, m, n, op.vals.element_size())
    if isinstance(op, PartitionMatrix):
        return _partition_bytes(m, n, op.stride, op.width,
                                op.vals.element_size())
    if isinstance(op, BsrMatrix):
        return _bsr_bytes(op.op.n_tiles, op.op.longest_lines, m, n,
                          op.op.tiles.element_size(), op.tile)
    return _csr_bytes(op.nnz_padded, m, n, op.vals.element_size())


# _candidate_cuts, col_split_plan and their constants: verbatim copy of
# pysparselp_tpu/problem.py:1154-1225 (its effective_stream_bytes, the
# presolve's price, is the third value of choose_layout here)
# column-split search: accept a split only when it beats the best whole-
# matrix layout by this factor (slicing + extra matvec dispatch overhead
# must not eat a marginal win)
COL_SPLIT_MIN_GAIN = 0.7
COL_SPLIT_MAX_DEPTH = 2
COL_SPLIT_TILE = 128          # candidate cuts at lane-tile boundaries
_COL_SPLIT_DENSITY_JUMP = 4.0  # adjacent-tile nnz ratio marking a boundary


def _candidate_cuts(csr, max_cands=6):
    """Column indices where the per-column nnz density changes character
    (tile-summed, ratio > _COL_SPLIT_DENSITY_JUMP), largest jumps first.

    Each tile-boundary candidate is refined to the EXACT per-column jump
    inside its two neighboring tiles when one exists: structural
    boundaries (e.g. the labeling|used split of the k-medians LP at
    column 150 000) rarely fall on a 128 multiple, and a cut 112 columns
    short of the boundary glues diagonal stragglers onto the hot dense
    block — the mixed block then lowers 10× worse than either side
    alone (advisor r5 finding: 5.4× k-medians came from exactly this)."""
    n = csr.shape[1]
    tile = COL_SPLIT_TILE
    nt = -(-n // tile)
    if nt < 2:
        return []
    colnnz = np.bincount(csr.indices, minlength=nt * tile)
    tnnz = colnnz.reshape(nt, tile).sum(axis=1).astype(np.float64) + 1.0
    ratio = np.maximum(tnnz[1:] / tnnz[:-1], tnnz[:-1] / tnnz[1:])
    order = np.argsort(-ratio)
    cuts = []
    for i in order[:max_cands]:
        if ratio[i] < _COL_SPLIT_DENSITY_JUMP:
            continue
        c = (int(i) + 1) * tile
        lo, hi = max(c - tile, 0), min(c + tile, n)
        seg = colnnz[lo:hi].astype(np.float64) + 1.0
        if seg.size >= 2:
            r = np.maximum(seg[1:] / seg[:-1], seg[:-1] / seg[1:])
            j = int(np.argmax(r))
            exact = lo + j + 1
            if r[j] >= _COL_SPLIT_DENSITY_JUMP and exact != c:
                cuts.append(exact)
        cuts.append(c)
    return [c for c in dict.fromkeys(cuts) if 0 < c < n]


def col_split_plan(csr, dtype=None, depth=COL_SPLIT_MAX_DEPTH):
    """Best contiguous column split of ``csr`` under the bytes-streamed
    model: returns ``(effective_bytes, cuts)`` where ``cuts`` is a sorted
    tuple of interior split columns (empty = no split helps).  Recursive
    bisection over density-change candidates; each piece is priced by
    :func:`estimate_stream_bytes`, so a split is kept exactly when the
    per-block layouts (dense head / diagonal tail / …) stream fewer
    effective bytes than any whole-matrix layout."""
    dtype = dtype or default_dtype()
    csr = scipy.sparse.csr_matrix(csr)
    _, whole = estimate_stream_bytes(csr, dtype)
    best = (whole, ())
    if depth <= 0:
        return best
    cands = _candidate_cuts(csr)
    csc = csr.tocsc() if cands else None
    for cut in cands:
        left = csc[:, :cut].tocsr()
        right = csc[:, cut:].tocsr()
        cl, cuts_l = col_split_plan(left, dtype, depth - 1)
        cr, cuts_r = col_split_plan(right, dtype, depth - 1)
        tot = cl + cr
        if tot < best[0]:
            best = (tot, cuts_l + (cut,) + tuple(c + cut for c in cuts_r))
    return best


def choose_layout(csr, bsr_line_price=None):
    """``(backend, cuts, bytes)``: the backend :func:`ell_from_scipy`
    lowers ``csr`` to, priced at :func:`default_dtype`, the column cuts
    when the backend is ``"split"``, and the bytes one SpMV pair of that
    layout moves (what the layout presolve compares across
    permutations).  ``bsr_line_price`` replaces :func:`warp_line_price` as
    the price of H-BSR's longest tile-line (0 prices the tile set alone)."""
    m, n = csr.shape
    dtype = default_dtype()
    if fits_dense_chunk(m, n):
        return "dense", (), _dense_bytes(
            m, n, torch.empty((), dtype=dtype).element_size())
    best, cost = estimate_stream_bytes(csr)
    if csr.nnz:
        bsr = _bsr_candidate(csr, dtype, bsr_line_price)
        if bsr is not None and bsr < cost:
            best, cost = "bsr", bsr
        # composite column blocks: [structured | ±I | …] matrices move
        # fewer bytes when the head and the tails get their own layouts
        split_cost, cuts = col_split_plan(csr)
        if cuts and split_cost < COL_SPLIT_MIN_GAIN * cost:
            return "split", cuts, split_cost
    return best, (), cost


# the JAX package's gather layouts that keep the dtype (EllMatrix,
# SegmentedEllMatrix); its routed ELL stores exact values in bfloat16
_DTYPE_GATHER_LAYOUTS = ("ell", "segmented")


def ell_from_scipy(a, dtype, device, prefer=None, cuts=None):
    """Lower a scipy sparse matrix to one of the port's operators.

    The backend comes from :func:`choose_layout` on every device, so the
    CPU runs take the branches the card does.  ``prefer`` forces one:
    "dense", "dia", "partition", "bsr", "split" (at ``cuts``, searched when
    ``None``) or "csr"; the JAX package's gather layouts ("ell",
    "segmented", "routed") map to "csr".

    Values are stored as the JAX operator stores them: DIA planes, a
    partition's table and CSR values (for ``None``, "csr" and "routed",
    JAX's TPU lowering's ``RoutedEllMatrix``) in bfloat16 for float32
    where every value is exact there; "ell" and "segmented" (JAX's
    ``EllMatrix``, ``SegmentedEllMatrix``) and dense in the dtype.
    """
    csr = scipy.sparse.csr_matrix(a)
    allow_bf16 = "exact"
    if prefer in _DTYPE_GATHER_LAYOUTS:
        prefer, allow_bf16 = "csr", False
    elif prefer == "routed":
        prefer = "csr"
    if prefer is None:
        prefer, cuts, _ = choose_layout(csr)
    elif prefer == "split" and cuts is None:
        cuts = col_split_plan(csr)[1]
    if prefer == "dense":
        return DenseMatrix.from_scipy(csr, dtype, device)
    if prefer == "dia":
        return DiaMatrix.from_scipy(csr, dtype, device)
    if prefer == "partition":
        return PartitionMatrix.from_scipy(csr, dtype, device)
    if prefer == "csr":
        return CsrMatrix.from_scipy(csr, dtype, device,
                                    allow_bf16=allow_bf16)
    if prefer == "bsr":
        return BsrMatrix.from_scipy(csr, dtype, device)
    if prefer == "split":
        return _lower_col_split(csr, cuts, dtype, device)
    raise ValueError(f"prefer={prefer!r}: the port's backends are 'dense', "
                     "'dia', 'partition', 'bsr', 'split' and 'csr'")


def _lower_col_split(csr, cuts, dtype, device):
    """Lower each contiguous column block independently (each through the
    same chooser) into a :class:`ColBlockMatrix`."""
    n = csr.shape[1]
    starts = (0,) + tuple(cuts) + (n,)
    csc = csr.tocsc()
    blocks = tuple(
        ell_from_scipy(csc[:, starts[b]:starts[b + 1]].tocsr(), dtype,
                       device)
        for b in range(len(starts) - 1))
    return ColBlockMatrix(blocks=blocks, col_starts=starts,
                          nrows=csr.shape[0], ncols=n)


def _dia_pays(cands) -> bool:
    """DIA within the fused-iteration credit of the cheapest candidate."""
    return ("dia" in cands
            and cands["dia"] <= min(cands.values()) + FUSED_CREDIT_BYTES)


def fused_dia_pays(csr) -> bool:
    """Whether this system takes DIA when the whole LP can run H-CPDIA:
    DIA is a candidate and streams no more than the cheapest layout plus
    the launches the fused iteration saves (``FUSED_CREDIT_BYTES``)."""
    csr = scipy.sparse.csr_matrix(csr)
    if csr.nnz == 0 or fits_dense_chunk(*csr.shape):
        return False
    return _dia_pays(_candidates(csr, default_dtype()))


def lowers_to_dia(nrows, ncols, ndiag, nnz) -> bool:
    """:func:`fused_dia_pays` for a system known by its shape, diagonal
    count and entries (the anchor-alignment preview; a partition candidate
    is not previewed)."""
    if nnz == 0 or fits_dense_chunk(nrows, ncols):
        return False
    s = torch.empty((), dtype=default_dtype()).element_size()
    return _dia_pays(_shape_candidates(nrows, ncols, ndiag, nnz, s))


def lower_systems(mats, dtype, device, layouts=None):
    """Lower an LP's constraint systems (``None`` stays ``None``).  When
    DIA pays for every present system (:func:`fused_dia_pays`), all are
    DIA and H-CPDIA runs the whole iteration; otherwise each system gets
    its :func:`choose_layout` result, from ``layouts`` (one per system, as
    the layout presolve priced them) or chosen here.  DIA planes come in
    one storage dtype (:func:`one_plane_storage`)."""
    present = [a for a in mats if a is not None]
    if present and all(fused_dia_pays(a) for a in present):
        layouts = [("dia", None, None)] * len(mats)
    elif layouts is None:
        layouts = [(None, None, None)] * len(mats)
    return one_plane_storage([
        None if a is None else ell_from_scipy(a, dtype, device, prefer, cuts)
        for a, (prefer, cuts, _) in zip(mats, layouts)])


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
# dia_offsets; tests/test_torch_slice.py holds them equal) and the verbatim
# rcm_permutation / apply_rcm_permutation (tests/test_torch_bsr_spmv.py)
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


# apply_rcm_permutation and rcm_permutation: verbatim copy of
# pysparselp_tpu/problem.py:912-961
def apply_rcm_permutation(sys):
    """RCM-permute a problem dict (same keys as
    :func:`apply_align_embedding`).  Returns
    ``(new_sys, pos_eq, pos_in, col_pos)`` with position maps in the same
    original→new convention."""
    a_eq, a_one = sys.get("a_eq"), sys.get("a_ineq")
    m_e = a_eq.shape[0] if a_eq is not None else 0
    parts = [p for p in (a_eq, a_one) if p is not None]
    joint = (parts[0] if len(parts) == 1
             else scipy.sparse.vstack(parts).tocsr())
    rows, cols = rcm_permutation(joint)
    out = dict(sys)
    pos_eq = pos_in = None
    if a_eq is not None:
        rows_eq = rows[rows < m_e]
        pos_eq = np.empty(m_e, np.int64)
        pos_eq[rows_eq] = np.arange(m_e)
        out["a_eq"] = a_eq[rows_eq, :][:, cols]
        out["beq"] = np.asarray(sys["beq"])[rows_eq]
        if sys.get("y_eq0") is not None:
            out["y_eq0"] = np.asarray(sys["y_eq0"], np.float64)[rows_eq]
    if a_one is not None:
        rows_in = rows[rows >= m_e] - m_e
        pos_in = np.empty(rows_in.size, np.int64)
        pos_in[rows_in] = np.arange(rows_in.size)
        out["a_ineq"] = a_one[rows_in, :][:, cols]
        out["b_ineq"] = np.asarray(sys["b_ineq"])[rows_in]
        if sys.get("y_ineq0") is not None:
            out["y_ineq0"] = np.asarray(sys["y_ineq0"], np.float64)[rows_in]
    for k in ("c", "lb", "ub", "x0", "x30"):
        if sys.get(k) is not None:
            out[k] = np.asarray(sys[k], np.float64)[cols]
    col_pos = np.empty(cols.size, np.int64)
    col_pos[cols] = np.arange(cols.size)
    return out, pos_eq, pos_in, col_pos


def rcm_permutation(a):
    """Bandwidth-reducing row/col permutation of a sparse matrix via
    reverse Cuthill-McKee on the symmetrized bipartite pattern; returns
    ``(rows, cols)`` index arrays (permuted -> original)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = scipy.sparse.csr_matrix(a)
    m = a.shape[0]
    bip = scipy.sparse.bmat([[None, a], [a.T, None]], format="csr")
    perm = np.asarray(reverse_cuthill_mckee(bip, symmetric_mode=True))
    rows = perm[perm < m]
    cols = perm[perm >= m] - m
    return rows.astype(np.int64), cols.astype(np.int64)


def dia_offsets(a) -> np.ndarray:
    """Distinct (col − row) diagonal offsets of the matrix, ascending."""
    coo = scipy.sparse.coo_matrix(a)
    if coo.nnz == 0:
        return np.zeros(0, np.int64)
    off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    return np.unique(off)
