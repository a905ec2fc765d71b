"""``cp_roofline``: the CP chunk kernels' share of their roofline, in %.

The least time of the measured span's chunks (``lib/roofline.py``: each
chunk's iterations of CP-PPD's operations on the LP's nonzeros, rows and
columns at the f32 peak, or its bytes at the HBM peak, whichever is larger)
over the device time of the CP chunk kernels in the span.  Every tier is
held to the same work."""

from lp_bench.lib import readers, roofline


def read(ctx):
    if ctx.kind != "single_solve":
        return None
    recs = ctx.trace.device_in(*ctx.segment, readers.CP_KERNELS)
    busy = sum(b - a for a, b, _, _ in recs) * 1e-6
    if busy <= 0:
        return None
    nnz, n, m = readers.lp_dims(ctx)
    least = roofline.cp_least_seconds(ctx.run.chunks(), nnz, n, m,
                                      readers.itemsize(ctx), ctx.peak)
    return 100.0 * least / busy
