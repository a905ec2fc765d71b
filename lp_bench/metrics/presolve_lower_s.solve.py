"""``presolve_lower_s.solve``: host seconds a solve spends in the
program's ``pslp.presolve.lower`` span (``lower_systems`` and its copies
to the device, the preconditioner sums, the initial state and KKT score),
the mean over the traced solves."""

from lp_bench.lib import spans


def read(ctx):
    return spans.stage_seconds(ctx, "presolve.lower")
