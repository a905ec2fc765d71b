"""``presolve_layout_s.solve``: host seconds a solve spends in the
program's ``pslp.presolve.layout`` span (the one-sided fold, the primal
weight's estimate, the layout's choice, the align or RCM embedding), the
mean over the traced solves."""

from lp_bench.lib import spans


def read(ctx):
    return spans.stage_seconds(ctx, "presolve.layout")
