#!/usr/bin/env python3
"""H-CPDIA-R's cost model on one NVIDIA GPU: the cluster barrier alone, and
the resident chunk at every cluster size its plan admits.

    python3 scripts/probe_cp_dia_resident.py [--nsteps 200] [--reps 20]

* ``barrier``: one launch of one cluster of C CTAs (C = 1, 2, 4, 8, 16; 128
  and 1,024 threads each) that runs 2 x ``nsteps`` barriers and nothing
  else (``pslp_cluster_sync_loop``), for each of ``BARRIERS``:
  ``cluster.sync()`` and ``__syncthreads()`` with a local mbarrier phase
  (the kernel's pass barrier when its halos have landed); CUDA events over
  ``reps`` launches, in microseconds per barrier and per iteration (two
  barriers).
* ``chunk``: Potts-20 and Potts-50 (``chip_smoke.lowered``), float32 and
  float64, H-CPDIA-R forced at each cluster size whose slab fits
  (``cp_dia._plan`` with ``cluster=C``) and the two-launch H-CPDIA,
  ``nsteps`` iterations with sums from a seeded start: each held against
  the plain twin (``chip_smoke.compare``: rtol 1e-5 f32, 1e-12 f64), then
  ``chip_smoke.call_times`` per iteration (events, profiler device time,
  host) and kernels per call; beside them the plan's shared-memory bound
  (the bytes both passes read and write in shared memory over C SMs at
  128 B per clock and the card's largest SM clock, ``nvidia-smi
  clocks.max.sm``) and the per-iteration streaming bound
  (``chip_smoke.chunk_bound``).

One JSON line per measurement, with the card's name and power limit, also
written to ``chiprun_out/probe_cp_dia_resident.json``; exits nonzero
without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the modes of pslp_cluster_sync_loop
BARRIERS = ("cluster.sync", "__syncthreads + local mbarrier")


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nsteps", type=int, default=200)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_cp_dia_resident: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import numpy as np

    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.ops import _build, cp_dia

    card = smi("name,power.limit")
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    out_path = ROOT / "chiprun_out" / "probe_cp_dia_resident.json"
    out_path.parent.mkdir(exist_ok=True)
    lines = []

    def emit(**rec):
        rec = dict(nvidia_smi=card, **rec)
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    _build.library()
    log = _build.build_info["log"]
    emit(probe="build", seconds=_build.build_info["seconds"],
         sm_clock_max_mhz=sm_mhz,
         ptxas=log[log.find("== cp_dia_resident.cu"):][:4000])
    sync = _build.entry("pslp_cluster_sync_loop",
                        [ctypes.c_int] * 4 + [ctypes.c_void_p])
    stream = _build.stream(_build.device_index("cuda"))
    nsyncs = 2 * args.nsteps
    for mode, what in enumerate(BARRIERS):
        for c in cp_dia.CLUSTER_SIZES:
            for threads in (128, 1024):
                ms = smoke.cuda_ms(
                    torch, lambda c=c, threads=threads, mode=mode: sync(
                        c, threads, nsyncs, mode, stream), args.reps)
                emit(probe="barrier", barrier=what, cluster=c,
                     threads=threads, syncs=nsyncs,
                     us_per_barrier=ms * 1e3 / nsyncs,
                     us_per_iteration=ms * 1e3 / args.nsteps)

    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    for size in (20, 50):
        lp = build_linear_program(size, 0.5, 500)[0]
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[1]
            prob, pre = smoke.lowered(lp, dt, dev)
            x0 = torch.as_tensor(rng.rand(prob.n), dtype=dt, device=dev)
            ye0 = torch.zeros(0, dtype=dt, device=dev)
            yi0 = torch.as_tensor(rng.rand(prob.m_ineq) * 0.1, dtype=dt,
                                  device=dev)
            want = cp_dia.cp_dia_chunk_reference(prob, pre, x0, ye0, yi0,
                                                 args.nsteps, 1.0, True)
            planes = sum(o.vals.numel() + o.vals_t.numel()
                         for o in (prob.a_eq, prob.a_ineq) if o is not None)
            stream_ms = smoke.chunk_bound(prob, planes, planes)[0]
            plans = [cp_dia._plan(*cp_dia._shape(prob, dt), cluster=c)
                     for c in cp_dia.CLUSTER_SIZES]
            plans = [p for p in plans if p.tier == "resident"]
            plans.append(cp_dia.TWO_LAUNCH)
            for plan in plans:
                def run(plan=plan, prob=prob, pre=pre, x0=x0, yi0=yi0):
                    return cp_dia.cp_dia_chunk(prob, pre, x0, ye0, yi0,
                                               args.nsteps, 1.0, True,
                                               plan=plan)

                what = f"potts{size} {plan.tier} C={plan.cluster}"
                for ns in (1, 7):
                    smoke.compare(torch, cp_dia.cp_dia_chunk(
                        prob, pre, x0, ye0, yi0, ns, 1.0, True, plan=plan),
                        cp_dia.cp_dia_chunk_reference(
                            prob, pre, x0, ye0, yi0, ns, 1.0, True),
                        name, f"{what} nsteps={ns}")
                err = smoke.compare(torch, run(), want, name, what)
                times = smoke.call_times(torch, run, reps=args.reps,
                                         host_reps=args.reps)
                rec = dict(probe="chunk", problem=f"potts{size}", dtype=name,
                           n=prob.n, tier=plan.tier, cluster=plan.cluster,
                           width=plan.width, threads=plan.threads,
                           smem_bytes=plan.smem_bytes, nsteps=args.nsteps,
                           max_abs_err=err,
                           per_iteration_us={
                               k: times[k] / args.nsteps
                               for k in ("events_us", "device_us",
                                         "host_us")},
                           kernels_per_call=times["kernels_per_call"],
                           kernel_names=times["kernel_names"],
                           stream_bound_us=stream_ms * 1e3)
                if plan.tier == "resident":
                    smem = smoke.resident_smem_traffic(prob, x0.element_size())
                    rec["smem_bytes_per_iteration"] = smem
                    rec["smem_bound_us"] = smem / (
                        plan.cluster * 128 * sm_mhz * 1e6) * 1e6
                emit(**rec)
    out_path.write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
