"""``spmm_roofline.batch``: the batched products' share of their roofline,
in %.

Per lock-step iteration the batch runs two products (Aᵀ Y, then A X̄) and
per checkpoint three more (Aᵀ Y, A X, A X4), each held to
``roofline.spmm_least_seconds`` on the LP's nonzeros; their least time
over the device time of the batched product kernels in the span."""

from lp_bench.lib import readers, roofline


def read(ctx):
    if ctx.kind != "batch":
        return None
    recs = ctx.trace.device_in(*ctx.segment, readers.SPMM_KERNELS)
    busy = sum(b - a for a, b, _, _ in recs) * 1e-6
    if busy <= 0:
        return None
    nnz, n, m = readers.lp_dims(ctx)
    bsz = int(ctx.traffic["batch"])
    size = readers.itemsize(ctx)
    a_x = roofline.spmm_least_seconds(nnz, m, n, bsz, size, ctx.peak)
    at_y = roofline.spmm_least_seconds(nnz, n, m, bsz, size, ctx.peak)
    c = ctx.run.curves["itrn"]
    j = ctx.run.last
    iters = int(c[j] - c[0])
    least = iters * (a_x + at_y) + j * (at_y + 2 * a_x)
    return 100.0 * least / busy
