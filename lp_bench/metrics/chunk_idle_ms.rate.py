"""``chunk_idle_ms.rate``: milliseconds the card idles inside the
program's ``pslp.cp.chunk`` spans (a chunk's enqueue) within the measured
span, per checkpoint interval (single_solve runs)."""

from lp_bench.lib import spans


def read(ctx):
    return spans.idle_inside(ctx, "single_solve", "cp.chunk")
