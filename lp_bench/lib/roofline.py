"""The yardstick of the kernels' roofline shares: the published peaks of the
card and the work of an operation counted from the LP, not from how the
program stores it.

Least time of a call = max(operations / peak FLOP/s, bytes / peak bytes/s),
with each input of the call read once and each output written once.  Two
implementations of one operation on one LP are held to the same work, so a
change of storage or of kernel moves a share only by taking less time.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops_f32": 67e12, "bytes_per_s": 3.35e12},
}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"

# bytes of an element at the solve dtype
ITEMSIZE = {"float32": 4, "float64": 8}


def peak(kind: str) -> dict:
    """The peaks of the card named ``kind`` (the H100 SXM's by default)."""
    return PEAKS.get(kind, PEAKS[DEFAULT_PEAK])


def cp_iteration_ops(nnz: int, n: int, m: int) -> int:
    """Floating-point operations of one CP-PPD iteration on an LP of ``nnz``
    constraint nonzeros, ``n`` columns and ``m`` rows
    (``ChambollePockPPD.py:199-240``): Aᵀy and A x̄ (a multiply and an add
    per nonzero each); per column the reduced cost, the step, the two-sided
    clamp and the extrapolation (1 + 2 + 2 + 3); per row the residual, the
    dual step and the clamp (1 + 2 + 1)."""
    return 4 * nnz + 9 * n + 4 * m


def cp_chunk_bytes(nnz: int, n: int, m: int, itemsize: int) -> int:
    """Bytes of one chunk call at the solve dtype: the nonzeros' values, the
    column vectors c, l, u, T, x and the row vectors b, Σ, y read once, and
    x and y written once."""
    return itemsize * (nnz + 5 * n + 3 * m + n + m)


def cp_least_seconds(chunks, nnz, n, m, itemsize, pk) -> float:
    """Least time of CP chunks of the iteration counts ``chunks``."""
    ops = cp_iteration_ops(nnz, n, m)
    byts = cp_chunk_bytes(nnz, n, m, itemsize)
    return sum(max(k * ops / pk["flops_f32"], byts / pk["bytes_per_s"])
               for k in chunks)


def spmm_least_seconds(nnz: int, rows_out: int, cols_in: int, batch: int,
                       itemsize: int, pk) -> float:
    """Least time of one batched product ``Y = M X`` (M with ``nnz``
    nonzeros, ``rows_out`` × ``cols_in``, X with ``batch`` columns): a
    multiply and an add per nonzero and column; the values, X read once and
    Y written once."""
    ops = 2 * nnz * batch
    byts = itemsize * (nnz + batch * (cols_in + rows_out))
    return max(ops / pk["flops_f32"], byts / pk["bytes_per_s"])
