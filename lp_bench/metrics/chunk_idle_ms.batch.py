"""``chunk_idle_ms.batch``: milliseconds the card idles inside the
program's ``pslp.batch.chunk`` spans (a lock-step chunk's enqueue) within
the measured span, per checkpoint interval (batch runs)."""

from lp_bench.lib import spans


def read(ctx):
    return spans.idle_inside(ctx, "batch", "batch.chunk")
