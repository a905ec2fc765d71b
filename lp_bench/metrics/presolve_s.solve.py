"""``presolve_s.solve``: host seconds from a solve's call to the launch of
its first CP chunk kernel (dispatch, the align presolve, the lowering and
the preconditioners), the mean over the traced solves."""

from lp_bench.lib import readers


def read(ctx):
    if ctx.kind != "closed_loop":
        return None
    spent = []
    for (a, b), _ in readers.solve_spans(ctx):
        rec = readers.first_cp_kernel(ctx, a, b)
        if rec is None:
            continue
        launch = ctx.trace.launch_of.get(rec[0]) or rec[0]
        spent.append((launch - a) * 1e-6)
    return sum(spent) / len(spent) if spent else None
