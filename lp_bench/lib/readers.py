"""Arithmetic the per-layer metric readers share: the measured span's idle
share, the LP's size, and the CP chunk kernels' names."""

from __future__ import annotations

from ..reference import potts as ref
from .roofline import ITEMSIZE

# the CP chunk kernels of every tier (H-CPDIA-R, H-CPDIA-G, the two-launch
# H-CPDIA, H-CPDENSE): their names end in "kernel" and start with "cp_"
CP_KERNELS = r"\bcp_\w*kernel"
# the batched products (H-CSR-B, H-DIA-B)
SPMM_KERNELS = r"\b(csr_batch_kernel|dia_spmm_kernel)\b"


def idle_share(ctx, kind):
    """Percent of the measured span with no device record running, for runs
    of traffic kind ``kind`` (else None)."""
    if ctx.kind != kind:
        return None
    t0, t1 = ctx.segment
    if t1 <= t0 or not ctx.trace.device_in(t0, t1):
        return None
    return 100.0 * (1.0 - ctx.trace.busy(t0, t1) / (t1 - t0))


def lp_dims(ctx):
    """``(nnz, n, m)`` of the cell's LP, counted from the model."""
    size = int(ctx.config["image_size"])
    return ref.lp_dims(size, size)


def itemsize(ctx):
    return ITEMSIZE[ctx.config["dtype"]]


def solve_spans(ctx):
    """``(span, solve)`` pairs of a closed loop's solves."""
    return list(zip(ctx.trace.spans.get("solve", []), ctx.run.solves))


def first_cp_kernel(ctx, a, b):
    """The first CP chunk kernel record inside ``[a, b]`` or None."""
    recs = ctx.trace.device_in(a, b, CP_KERNELS)
    return recs[0] if recs else None
