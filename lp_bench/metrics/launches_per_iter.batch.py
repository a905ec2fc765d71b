"""``launches_per_iter.batch``: kernels the card ran per lock-step batch
iteration in the measured span (checkpoints' kernels included)."""


def read(ctx):
    if ctx.kind != "batch":
        return None
    c = ctx.run.curves["itrn"]
    iters = int(c[ctx.run.last] - c[0])
    if iters <= 0:
        return None
    kernels = [r for r in ctx.trace.device_in(*ctx.segment) if r[3] == "kernel"]
    return len(kernels) / iters if kernels else None
