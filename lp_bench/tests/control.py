#!/usr/bin/env python3
"""The check's control: the plain reference in bfloat16 (the precision
below the configurations' float32) in the program's place, through a
cell's set-up, window and check, at the cell's own size.  Every number
compared is printed beside its limit; the control has to come out not
correct.  Run on the card:

    python3 lp_bench/tests/control.py --workload potts300.steady \\
        --seeds 1 2 3 --iterations 1400000

``--iterations`` gives a window call the iterations a run of the program
makes (``detail.iterations`` of its result lines); ``--solves`` the whole
solves of a closed loop (default: one a frame of its pool).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from lp_bench.lib import checks, drive, spec  # noqa: E402
from lp_bench.lib.systems import ControlSystem  # noqa: E402


def control_run(cell, seed, device, iterations=None, solves=None,
                seconds=1e9):
    """One control run of ``cell``: ``(numbers, attempted, failed)``.  The
    control's checkpoints all count as inside its window (``seconds``):
    its iterations are fixed, not its time."""
    system = ControlSystem(device, cell.config)
    run = drive.driver(system, cell, seed)
    run.setup()
    system.iterations = iterations
    if cell.traffic["kind"] == "closed_loop":
        run.solves = []
        for i in range(solves or len(run.lps)):
            frame = int(run.order[i % len(run.order)])
            x, curves = system.solve(run.lps[frame], **run.kw)
            run.solves.append({"frame": frame, "x": x, "curves": curves})
    else:
        run.window(seconds)
    return checks.check(run, cell.limits, device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--iterations", type=int)
    p.add_argument("--solves", type=int)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums, attempted, failed = control_run(cell, seed, args.device,
                                              args.iterations, args.solves)
        correct = failed == 0 and all(nums[k] <= cell.limits[k] for k in nums)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": correct, "attempted": attempted,
                          "failed": failed, "seconds": time.perf_counter() - t0,
                          "checks": {k: {"value": v, "limit": cell.limits[k]}
                                     for k, v in nums.items()}}), flush=True)


if __name__ == "__main__":
    main()
