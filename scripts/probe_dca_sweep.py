#!/usr/bin/env python3
"""Whether H-DCA's time depends on its surroundings, on one NVIDIA GPU: the
sequential sweep over Potts-300's one-sided rows (358,800 rows of <= 3
entries, c̄ in global memory), float32, from two states, with the L2 warm
or flushed, and inside the DCA solve.

    python3 scripts/probe_dca_sweep.py [--reps 3] [--rows 0]

* ``state``: the solve's start (y = 0, c̄ = c, every row active) against
  ``chip_smoke.dca_state``'s seeded mid-solve state;
* ``l2``: each call warm (the previous call's data in the 50 MB L2) or
  cold (a 256 MB buffer written between calls);
* ``solve``: the DCA solve's own sweeps (``lp.solve(method=
  "dual_coordinate_ascent")``, 2 sweeps) under the profiler.

Device milliseconds per sweep and microseconds per row from the
profiler's kernel time, with ``nvidia-smi``'s SM clock read right after
each case. One JSON line per case (the card's name and power limit
first), also written to ``chiprun_out/probe_dca_sweep.json``; exits
nonzero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_dca_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke
    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.ops import dca_sweep as dca
    from pysparselp_tpu_torch.utils.jax_prng import prng_key

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rows", type=int, default=0,
                    help="the first ROWS rows only (0: all)")
    args = ap.parse_args()

    out = []

    def emit(**rec):
        print(json.dumps(rec), flush=True)
        out.append(rec)

    emit(card=smi("name,power.limit"))
    lp = build_linear_program(300, 0.5, 500)[0]
    lp.convert_to_one_sided_inequality_system()
    a = lp.a_inequalities.tocsr()
    system = (a, np.asarray(lp.b_upper), lp.costsvector, lp.lower_bounds,
              lp.upper_bounds)
    rows = args.rows or None
    m = rows or a.shape[0]
    mid = chip_smoke.dca_state(torch, system, torch.float32, rows=rows)
    ell, b, _active, _y, _cb, lb, ub = mid
    start = (ell, b, torch.ones(m, dtype=torch.bool, device="cuda"),
             torch.zeros(m, device="cuda"),
             torch.as_tensor(lp.costsvector, dtype=torch.float32,
                             device="cuda"), lb, ub)
    flush = torch.empty(64 * 2**20, device="cuda")
    key = prng_key(1)
    for state, sargs in (("solve_start", start), ("mid_solve", mid)):
        for l2 in ("warm", "cold"):
            def call(sargs=sargs, l2=l2):
                if l2 == "cold":
                    flush.fill_(1.0)
                dca.dca_sweep(*sargs, key, True)

            ms = chip_smoke.device_ms(torch, call, "dca_sweep_kernel",
                                      dca.dca_sweep, reps=args.reps)
            emit(case="kernel", state=state, l2=l2, rows=m,
                 device_ms_per_sweep=ms, device_us_per_row=ms / m * 1e3,
                 sm_clock_mhz=smi("clocks.sm"))
    lp, gt, idx, _ = build_linear_program(300, 0.5, 500)
    run = dict(method="dual_coordinate_ascent", nb_iter=2, nb_iter_plot=1,
               dtype=np.float32, device="cuda")
    ms = chip_smoke.device_ms(torch, lambda: lp.solve(**run),
                              "dca_sweep_kernel", dca.dca_sweep, reps=1) / 2
    emit(case="solve", rows=a.shape[0], device_ms_per_sweep=ms,
         device_us_per_row=ms / a.shape[0] * 1e3,
         sm_clock_mhz=smi("clocks.sm"))
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "probe_dca_sweep.json").write_text(
        "".join(json.dumps(r) + "\n" for r in out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
