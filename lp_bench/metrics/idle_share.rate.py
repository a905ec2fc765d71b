"""``idle_share.rate``: percent of the measured span in which no kernel, copy
or fill ran on the card (single_solve runs)."""

from lp_bench.lib import readers


def read(ctx):
    return readers.idle_share(ctx, "single_solve")
