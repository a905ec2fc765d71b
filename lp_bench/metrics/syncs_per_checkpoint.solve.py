"""``syncs_per_checkpoint.solve``: the program's blocking device reads
(``pslp.sync`` spans) inside the traced solves over their checkpoints."""

from lp_bench.lib import spans


def read(ctx):
    if ctx.kind != "closed_loop":
        return None
    found = spans.ProgramSpans(ctx.trace)
    syncs = checkpoints = 0
    for span, solve in spans.traced_solves(ctx, found):
        syncs += len(found.within("sync", *span))
        checkpoints += len(solve["curves"]["itrn"])
    return syncs / checkpoints if checkpoints else None
