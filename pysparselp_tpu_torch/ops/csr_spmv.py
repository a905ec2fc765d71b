"""H-CSR: the CSR sparse matrix-vector product, ``y[r] = Σ_{k=indptr[r]}^
{indptr[r+1]-1} vals[k] · x[indices[k]]`` (kernel source:
``csrc/csr_spmv.cu``).

Replaces ``pysparselp_tpu/ops/ell_routed.py::_routed_spmv_call`` (K7) and
``_routed_tiled_spmv_call`` (K8): what their host-built routes compute, an
unstructured ``y = A x``, in either orientation (the caller passes the CSR
of ``A`` or of ``Aᵀ``).

The kernel is one launch per product over a plan that :func:`split_plan`
builds once, when :class:`CsrOperand` is built: every row gets a sub-warp
of ``width`` lanes, except a row longer than ``LONG_STRIDES * width``
entries, which is cut into chunks of equal entries (within one), one
thread block each; the chunks' sums are added in chunk order by the last
chunk to finish (the row is a "task").  :func:`csr_spmv` launches the
kernel for CUDA tensors and runs :func:`csr_spmv_reference`, its plain
PyTorch twin, for CPU tensors; it never falls back from one to the other.

H-CSR-B, the batched product ``Y[r, b] = Σ_k vals[k] · X[indices[k], b]``
over ``X`` of shape ``(n_in, B)`` (batch-last, contiguous), is the same
module's second kernel entry, on the same plan: :func:`csr_spmm` launches it
for CUDA tensors and runs :func:`csr_spmm_reference` for CPU tensors.  Its
chunk carries (``n_chunks × B``) and arrival counters are its own, one set
per batch size (:meth:`CsrOperand.batch_scratch`), never the 1-D entry's.

The values are stored in the product's dtype, or in bfloat16 for a float32
product whose every value is exact there (the JAX package's routed ELL
storage): H-CSR and the twins widen each value exactly as they read it, so
the result is bit for bit the float32 values' on the same plan.  H-CSR-B
takes values in the product's dtype only (the batch path stores them so)
and raises on bfloat16 ones.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _build
from .dia_spmv import widen

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P)
# the batched entry: the same head, then carries, counters, X, Y, B, stream
_ARGTYPES_B = _ARGTYPES[:8] + (_P, _P, _P, _P, _I, _P)
THREADS = 256             # a thread block (kThreads in csrc/csr_spmv.cu)
# a row longer than LONG_STRIDES * width entries is cut into chunks
# (kLongStrides in csrc/csr_spmv.cu)
LONG_STRIDES = 32
# the long rows' entries are cut into chunks of at least MIN_CHUNK and at
# most MAX_CHUNK entries, into SPREAD_CTAS chunks (two per SM of the H100's
# 132) where those bounds allow, so that even a few long rows fill the card
SPREAD_CTAS = 264
MIN_CHUNK = 512
MAX_CHUNK = 8192
MAX_NNZ = 2**31 - 1


def vector_width(nnz, n_out) -> int:
    """Lanes per row: the power of two in 2..32 at or above the mean row
    length."""
    mean = nnz / max(n_out, 1)
    width = 2
    while width < 32 and width < mean:
        width *= 2
    return width


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How one CSR matrix is cut into the kernel's thread blocks (int32
    arrays).  The first ``row_blocks`` blocks give each row ``width``
    lanes; long rows (more than ``LONG_STRIDES * width`` entries) are tasks:
    task ``q`` is row ``task_row[q]``, cut into ``task_count[q]`` chunks
    from chunk ``task_first[q]`` on, and chunk ``c`` (a block of its own)
    sums entries ``[chunk_begin[c], chunk_end[c])`` of task
    ``chunk_task[c]`` into slot ``c`` of the operator's ``carries``."""

    n_out: int
    width: int
    chunk_begin: np.ndarray
    chunk_end: np.ndarray
    chunk_task: np.ndarray
    task_row: np.ndarray
    task_first: np.ndarray
    task_count: np.ndarray

    @property
    def n_chunks(self) -> int:
        return self.chunk_begin.size

    @property
    def n_tasks(self) -> int:
        return self.task_row.size

    @property
    def row_blocks(self) -> int:
        return -(-self.n_out * self.width // THREADS)

    def packed(self) -> np.ndarray:
        """The kernel's int32 plan: the arrays in the order of
        ``plan_view`` in the kernel source, then the tasks' arrival
        counters (zero)."""
        return np.concatenate([
            self.chunk_begin, self.chunk_end, self.chunk_task, self.task_row,
            self.task_first, self.task_count,
            np.zeros(self.n_tasks, np.int32)]).astype(np.int32)


def split_plan(indptr, chunk=None, width=None) -> SplitPlan:
    """The plan of a CSR matrix with row pointers ``indptr`` (host array):
    ``width`` lanes per row (:func:`vector_width` by default), and each
    long row cut into ``ceil(length / chunk)`` chunks whose sizes differ by
    at most one entry.  ``chunk`` defaults to the long rows' entries over
    ``SPREAD_CTAS``, within ``[MIN_CHUNK, MAX_CHUNK]``."""
    indptr = np.asarray(indptr, np.int64)
    n_out = indptr.size - 1
    lengths = np.diff(indptr)
    if width is None:
        width = vector_width(int(indptr[-1]), n_out)
    rows = np.flatnonzero(lengths > LONG_STRIDES * width)
    long_len = lengths[rows]
    if chunk is None:
        chunk = int(np.clip(-(-int(long_len.sum()) // SPREAD_CTAS),
                            MIN_CHUNK, MAX_CHUNK))
    count = -(-long_len // chunk)
    first = np.cumsum(count) - count
    task = np.repeat(np.arange(rows.size), count)
    piece = np.arange(task.size) - first[task]
    start, size, k = indptr[rows][task], long_len[task], count[task]

    def i32(v):
        return np.asarray(v, np.int32)

    return SplitPlan(n_out=n_out, width=int(width),
                     chunk_begin=i32(start + piece * size // k),
                     chunk_end=i32(start + (piece + 1) * size // k),
                     chunk_task=i32(task), task_row=i32(rows),
                     task_first=i32(first), task_count=i32(count))


class CsrOperand:
    """One orientation of a CSR matrix on its device, ready to launch: the
    arrays (``indptr`` int32 (n_out + 1,), ``indices`` int32 (nnz,),
    ``vals`` (nnz,)), their :class:`SplitPlan` packed into one int32
    tensor, the chunks' ``carries`` and the kernel's bound C entry.
    Checked once here; :func:`csr_spmv` checks only ``x``.  ``plan`` is
    :func:`split_plan` of ``indptr`` (computed here when None, which reads
    ``indptr`` back to the host once).  ``vals`` is float32 or float64,
    or bfloat16 for a float32 product: ``dtype``, the product's (of ``x``,
    the output and the carries), is then float32."""

    __slots__ = ("indptr", "indices", "vals", "n_in", "n_out", "plan",
                 "plan_dev", "carries", "device", "dtype", "x_shape",
                 "device_index", "entry", "entry_b", "_scratch", "fused",
                 "_slots")

    def __init__(self, indptr, indices, vals, n_in, plan=None, fused=False):
        nnz = vals.shape[0]
        n_out = indptr.shape[0] - 1
        if nnz > MAX_NNZ:
            raise ValueError(f"csr_spmv: {nnz} entries do not fit int32 "
                             "indices")
        if (indptr.dtype != torch.int32 or indices.dtype != torch.int32
                or indices.shape != (nnz,) or vals.dim() != 1):
            raise ValueError("csr_spmv: indptr (n_out + 1,) and indices "
                             "(nnz,) must be int32, vals (nnz,)")
        if vals.dtype not in (torch.float32, torch.float64, torch.bfloat16):
            raise TypeError(f"csr_spmv takes float32, float64 or bfloat16 "
                            f"values, got {vals.dtype}")
        dev = vals.device
        for t in (indptr, indices, vals):
            if t.device != dev or (dev.type == "cuda"
                                   and not t.is_contiguous()):
                raise ValueError("csr_spmv: indptr, indices and vals must "
                                 "be contiguous, on one device")
        self.indptr, self.indices, self.vals = indptr, indices, vals
        self.n_in, self.n_out = int(n_in), n_out
        self.plan = plan if plan is not None else split_plan(
            indptr.cpu().numpy())
        self.plan_dev = torch.as_tensor(self.plan.packed(), device=dev)
        self.dtype = (torch.float32 if vals.dtype == torch.bfloat16
                      else vals.dtype)
        self.carries = torch.zeros(self.plan.n_chunks, dtype=self.dtype,
                                   device=dev)
        self.device = dev
        self.x_shape = (self.n_in,)
        self.device_index = self.entry = self.entry_b = None
        self._scratch = {}
        # the CPU twin rounds each row as a fused multiply-add chain
        # (csr_spmv_fused_reference); the card is not affected
        self.fused, self._slots = bool(fused), None
        if dev.type == "cuda":
            self.device_index = _build.device_index(dev)
            head = (indptr, indices, vals, self.plan_dev, n_out,
                    self.plan.width, self.plan.n_chunks, self.plan.n_tasks)
            self.entry = _build.Entry(
                f"pslp_csr_spmv_{_build.plane_suffix(self.dtype, vals.dtype)}",
                _ARGTYPES, *head, self.carries)
            if vals.dtype == self.dtype:
                self.entry_b = _build.Entry(
                    f"pslp_csr_spmm_{_build.suffix(self.dtype)}",
                    _ARGTYPES_B, *head)

    def batch_scratch(self, nb):
        """``(carries, counters)`` of the batched entry at batch size
        ``nb``: ``n_chunks × nb`` carries and one zeroed arrival counter
        per long row, made on the first call at that size and kept."""
        found = self._scratch.get(nb)
        if found is None:
            found = self._scratch[nb] = (
                torch.zeros(self.plan.n_chunks * nb, dtype=self.dtype,
                            device=self.device),
                torch.zeros(self.plan.n_tasks, dtype=torch.int32,
                            device=self.device))
        return found

    @staticmethod
    def from_host(indptr, indices, data, n_in, dtype, device, fused=False,
                  value_dtype=None):
        """From host CSR arrays (the plan from the host ``indptr``), the
        values stored as ``value_dtype`` (default ``dtype``; bfloat16
        only with float32)."""
        def i32(v):
            return torch.as_tensor(np.asarray(v, np.int32), device=device)

        value_dtype = value_dtype or dtype
        if value_dtype != dtype and (value_dtype, dtype) != (torch.bfloat16,
                                                             torch.float32):
            raise TypeError(f"CsrOperand: {value_dtype} values for a {dtype} "
                            "product (bfloat16 values serve float32 only)")
        return CsrOperand(
            i32(indptr), i32(indices),
            torch.as_tensor(np.asarray(data, np.float64), dtype=value_dtype,
                            device=device), n_in, split_plan(indptr),
            fused=fused)

    def row_slots(self):
        """Per position ``p`` of a row, the entries at that position and
        their rows (``[(entries, rows), ...]``, made on first use)."""
        if self._slots is None:
            lengths = self.indptr.diff().long()
            rows = torch.arange(self.n_out, device=self.device)
            self._slots = []
            for p in range(int(lengths.max()) if self.n_out else 0):
                r = rows[lengths > p]
                self._slots.append((self.indptr[r].long() + p, r))
        return self._slots


def csr_spmv_reference(indptr, indices, vals, x, n_out):
    """Plain twin: a gather of ``x`` and an ``index_add_`` into the rows
    (on the CPU it adds in entry order); bfloat16 values widened exactly
    to float32."""
    vals = widen(vals)
    rows = torch.repeat_interleave(
        torch.arange(n_out, device=vals.device), indptr.diff().long())
    y = torch.zeros(n_out, dtype=vals.dtype, device=vals.device)
    return y.index_add_(0, rows, vals * x[indices.long()])


def csr_spmv_fused_reference(op, x, base=None):
    """Plain twin that rounds each row ``y[r] = fma(v_k, x_k, ... fma(v_0,
    x_0, 0))``, its entries in order: what a gather-multiply-reduce over
    padded rows gives on XLA's CPU backend, which contracts the multiply
    into the sum (the JAX package's ``EllMatrix`` products on the CPU).
    ``torch.addcmul`` is that fused multiply-add on the CPU.  With
    ``base``, ``base + A x``: added after the sums, except where no row
    has two entries (a padded width of 1, whose reduction XLA removes):
    there the product fuses into the addition, ``fma(v_0, x_0, base)``."""
    slots = op.row_slots()
    vals = widen(op.vals)
    y = torch.zeros(op.n_out, dtype=vals.dtype, device=vals.device)
    if base is not None and len(slots) <= 1:
        y, base = base.clone(), None
    idx = op.indices.long()
    for entries, rows in slots:
        y[rows] = torch.addcmul(y[rows], vals[entries], x[idx[entries]])
    return y if base is None else base + y


def csr_spmv_plus(op: "CsrOperand", x, base):
    """``base + A x`` for the CSR operand ``op``: H-CSR and an addition on
    the card; on the CPU, for a ``fused`` operand, rounded as
    :func:`csr_spmv_fused_reference` rounds it."""
    if x.device.type == "cpu" and op.fused:
        return csr_spmv_fused_reference(op, x, base)
    return base + csr_spmv(op, x)


def csr_spmm_reference(indptr, indices, vals, x, n_out):
    """Plain twin of H-CSR-B: :func:`csr_spmv_reference` with a trailing
    batch axis, ``x`` (n_in, B) -> (n_out, B)."""
    vals = widen(vals)
    rows = torch.repeat_interleave(
        torch.arange(n_out, device=vals.device), indptr.diff().long())
    y = torch.zeros((n_out, x.shape[1]), dtype=vals.dtype, device=vals.device)
    return y.index_add_(0, rows, vals[:, None] * x[indices.long()])


def csr_spmm(op: CsrOperand, x):
    """``Y = A X`` for the CSR operand ``op``; ``x`` (n_in, B) batch-last,
    contiguous (H-CSR-B)."""
    if x.device.type == "cpu":
        return csr_spmm_reference(op.indptr, op.indices, op.vals, x,
                                  op.n_out)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmm runs on CUDA or the CPU, not {x.device}")
    if (x.device != op.device or x.dtype != op.dtype or x.dim() != 2
            or x.shape[0] != op.n_in or not x.is_contiguous()):
        raise ValueError(
            f"csr_spmm: x must be a contiguous ({op.n_in}, B) {op.dtype} "
            f"tensor on {op.device}, got {tuple(x.shape)} {x.dtype} on "
            f"{x.device}")
    if op.entry_b is None:
        raise TypeError(f"csr_spmm: H-CSR-B reads values stored in the "
                        f"product's dtype ({op.dtype}), got {op.vals.dtype}")
    nb = x.shape[1]
    y = torch.empty((op.n_out, nb), dtype=op.dtype, device=op.device)
    if nb and op.n_out * nb + op.plan.n_chunks:
        carries, counters = op.batch_scratch(nb)
        op.entry_b(carries.data_ptr(), counters.data_ptr(), x.data_ptr(),
                   y.data_ptr(), nb, _build.stream(op.device_index))
        csr_spmm.launches += 1
    return y


csr_spmm.launches = 0


def csr_spmv(op: CsrOperand, x):
    """``y = A x`` for the CSR operand ``op``; ``x`` (n_in,) may be a
    contiguous view at a storage offset."""
    if x.device.type == "cpu":
        if op.fused:
            return csr_spmv_fused_reference(op, x)
        return csr_spmv_reference(op.indptr, op.indices, op.vals, x,
                                  op.n_out)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmv runs on CUDA or the CPU, not {x.device}")
    if (x.device != op.device or x.dtype != op.dtype
            or x.shape != op.x_shape or not x.is_contiguous()):
        raise ValueError(
            f"csr_spmv: x must be a contiguous ({op.n_in},) {op.dtype} "
            f"tensor on {op.device}, got {tuple(x.shape)} {x.dtype} on "
            f"{x.device}")
    y = torch.empty(op.n_out, dtype=op.dtype, device=op.device)
    if op.plan.row_blocks + op.plan.n_chunks:
        op.entry(x.data_ptr(), y.data_ptr(), _build.stream(op.device_index))
        csr_spmv.launches += 1
    return y


csr_spmv.launches = 0
