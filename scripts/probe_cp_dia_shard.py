#!/usr/bin/env python3
"""Where one call of H-CPDIA's shard entry spends its device time, on one
NVIDIA GPU.

    python3 scripts/probe_cp_dia_shard.py [--reps 200]

On Potts-300's aligned system (float32, bfloat16 planes; the seeded start
of ``chip_smoke.shard_system``), as one shard (the one-rank mesh) and as
an inner quarter shard (rank 1 of 4), in one process:

* the one-launch entry (``cp_dia_shard_stepper``, one cooperative launch
  a call) and the two-launch entry (``two_launch=True``), by CUDA events
  and profiler device time per call, each kernel of the two-launch entry
  apart (its primal pass and its dual pass);
* the one-launch entry's fixed cost at its own grid: an empty cooperative
  launch (``pslp_grid_sync_loop`` with no barrier) and one with one grid
  barrier, at the plan's CTAs and threads.

Prints one JSON line per shape with the card's name and power limit;
exits nonzero without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=200)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_cp_dia_shard: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.ops import _build, cp_dia
    from pysparselp_tpu_torch.parallel import sharded_cp_windowed as scw

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    sys_, info = smoke.shard_system(build_linear_program(300, 0.5, 500)[0])
    glob = scw.position_system(sys_, info)
    sync = _build.entry("pslp_grid_sync_loop",
                        [ctypes.c_int] * 3 + [ctypes.c_void_p])
    stream = _build.stream(_build.device_index("cuda"))
    dt, reps = torch.float32, args.reps
    l2_rates = smoke.l2_read_rates(torch)

    def device_by_name(fn):
        """Device µs per call of each kernel name over ``reps`` calls."""
        out = {}
        for e in smoke.profiled_kernels(torch, fn, reps):
            out[e.name] = out.get(e.name, 0.0) + e.elapsed_us() / reps
        return {("primal" if "primal" in k else "dual" if "dual" in k
                 else "one_launch" if "shard_grid" in k else k): v
                for k, v in out.items()}

    for shape, ndev, rank in (("whole", 1, 0),
                              ("quarter", smoke.MESH_RANKS, 1)):
        data, st = scw.place_position_shard(glob, ndev, rank, dt, "cuda")
        sh, empty = data["shard"], st["x"].new_zeros(0)
        old = {k: v.clone() for k, v in st.items()}
        one = cp_dia.cp_dia_shard_stepper(sh, data["pre"], st["x"], st["x3"],
                                          empty, st["y_ineq"], 1.0)
        two = cp_dia.cp_dia_shard_stepper(sh, data["pre"], old["x"],
                                          old["x3"], empty, old["y_ineq"],
                                          1.0, two_launch=True)
        plan = cp_dia.shard_plan(sh)
        fixed = {}
        for label, nsyncs in (("launch", 0), ("launch_and_barrier", 1)):
            def run(nsyncs=nsyncs):
                sync(plan.ctas, plan.threads, nsyncs, stream)
            fixed[label] = dict(
                device_us=sum(device_by_name(run).values()),
                events_us=smoke.cuda_ms(torch, run, reps) * 1e3)
        rec = dict(nvidia_smi=smi, shape=shape, positions=sh.length,
                   primal=list(sh.primal), interior=list(sh.interior),
                   ctas=plan.ctas, threads=plan.threads,
                   bound_us=smoke.shard_bound(
                       data, 4, l2_rates)["bound_ms"] * 1e3,
                   fixed=fixed)
        for label, fn in (("one_launch", one), ("two_launch", two)):
            rec[label] = dict(events_us=smoke.cuda_ms(torch, fn, reps) * 1e3,
                              device_us_by_kernel=device_by_name(fn))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
