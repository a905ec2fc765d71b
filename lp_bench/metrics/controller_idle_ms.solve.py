"""``controller_idle_ms.solve``: milliseconds the card idles per checkpoint
after a solve's first CP chunk kernel (the chunk loop's and the restart
controller's host work between chunks), over the traced solves."""

from lp_bench.lib import readers


def read(ctx):
    if ctx.kind != "closed_loop":
        return None
    idle = checkpoints = 0.0
    for (a, b), solve in readers.solve_spans(ctx):
        rec = readers.first_cp_kernel(ctx, a, b)
        if rec is None:
            continue
        idle += sum(g1 - g0 for g0, g1 in ctx.trace.gaps(rec[0], b))
        checkpoints += len(solve["curves"]["itrn"])
    return idle * 1e-3 / checkpoints if checkpoints else None
