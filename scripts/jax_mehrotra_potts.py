#!/usr/bin/env python3
"""The JAX package's Mehrotra interior point on a Potts grid, on the CPU in
float64: the reference figure that ``chip_smoke.py``'s
``main_path_mehrotra_potts300`` holds the port's graph-cut distance to.

    python3 scripts/jax_mehrotra_potts.py [--size 300] [--nb-iter 100]

Builds ``pysparselp_tpu.examples.potts.build_linear_program(size, 0.5,
500)``, solves it with ``method="mehrotra"`` (one checkpoint per IPM
iteration) and prints one JSON line: the standard-form shape, the IPM
iterations, whether the rows took the dense or the CG path, the final mean
|x - graph cut| over the segmentation variables, and the wall seconds.
This script imports jax (the card's machine has none): it runs where the
JAX package does, never on the card.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=300)
    ap.add_argument("--nb-iter", type=int, default=100)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from pysparselp_tpu.examples.potts import build_linear_program

    lp, gt, idx, _ = build_linear_program(args.size, 0.5, 500)
    slack = copy.deepcopy(lp)
    slack.remove_fixed_variables()
    slack.convert_to_slack_form()
    m, n = slack.a_equalities.shape
    t0 = time.perf_counter()
    x, _ = lp.solve(method="mehrotra", nb_iter=args.nb_iter, nb_iter_plot=1,
                    dtype=np.float64)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "size": args.size, "standard_form": [int(m), int(n)],
        "path": "dense" if m <= 4096 and m * n <= 64_000_000 else "cg",
        "ipm_iterations": len(lp.itrn_curve),
        "mean_dist_graph_cut": float(np.mean(np.abs(x[idx] - gt))),
        "wall_s": wall, "platform": "cpu (JAX, float64)"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
