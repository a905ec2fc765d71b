"""``idle_share.solve``: percent of the measured span in which no kernel, copy
or fill ran on the card (closed_loop runs)."""

from lp_bench.lib import readers


def read(ctx):
    return readers.idle_share(ctx, "closed_loop")
