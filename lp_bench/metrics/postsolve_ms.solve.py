"""``postsolve_ms.solve``: host milliseconds a solve spends in the
program's ``pslp.postsolve`` spans (the final fetch and unpermute, the
back map of the fixed variables, the light-metrics curves' reads), the
mean over the traced solves."""

from lp_bench.lib import spans


def read(ctx):
    sec = spans.stage_seconds(ctx, "postsolve")
    return None if sec is None else sec * 1e3
