"""``presolve_reduce_s.solve``: host seconds a solve spends in the
program's ``pslp.presolve.reduce`` span (dispatch: the LP's copy,
``remove_fixed_variables``, the warm start's map, the CSR conversion),
the mean over the traced solves."""

from lp_bench.lib import spans


def read(ctx):
    return spans.stage_seconds(ctx, "presolve.reduce")
