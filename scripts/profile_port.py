#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path, on one NVIDIA GPU.

    python3 scripts/profile_port.py

Runs the solves that ``chip_smoke.py`` drives (Potts-300 f32 with
``light_metrics``, 2000 iterations; Potts-50 and SC105 f32 with restart to
average; the transport LP of ``bench.py`` f32 with ``light_metrics``, 2000
iterations, on the per-operator path) once to build and warm up, then once
each under ``torch.profiler``; then, without a warm-up solve (its host
presolve takes minutes), the CLIME LP of ``chip_smoke.py`` (p = 150) f32
with ``light_metrics``, 2000 iterations, twice: with ``permute="rcm"``
(block-sparse, H-BSR: ``bsr_rows_kernel`` for A x, ``bsr_cols_kernel``
for Aᵀ y) and with ``permute=False`` (unpermuted, H-CSR).
For each solve it prints one JSON line: the wall time, the device time and
count of each kernel (and memcpy) by name, the device busy share (device
time / wall time) and the device events per iteration, and for the
``light_metrics`` solves the device and kernel time (memcpy excluded) per
iteration and the wall time per iteration in the steady window between
the two checkpoints.  Then the four batched serving configurations of
``chip_smoke.py`` (``BATCH``: dense B = 64, banded B = 16, assignment B = 8,
unstructured B = 8) through ``solve_cp_batch``, f32, each warmed up by one
solve and then profiled over its steady run (a checkpoint every quarter):
the device time per iteration split into the batched products
(``dia_spmm_kernel``, ``csr_batch_kernel``, dense GEMMs) and the rest (the
unfused elementwise passes), launches per iteration and the busy share of
the steady window.  ``--runs NAME ...`` profiles only the named runs
(``batch_banded`` and so on).  The same
lines go to ``chiprun_out/profile_port.json``.  Exits nonzero without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def device_events(prof, DeviceType):
    """``{name: [count, microseconds]}`` over the device events."""
    out = defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            out[evt.name][0] += 1
            out[evt.name][1] += evt.time_range.elapsed_us()
    return dict(out)


# device kernels of a batched product: H-DIA-B, H-CSR-B and cuBLAS GEMMs
BATCH_PRODUCT_KERNELS = ("dia_spmm_kernel", "csr_batch_kernel", "gemm",
                         "gemv", "splitKreduce")


def profile_batch(torch, name, lp, smi, profile, ProfilerActivity,
                  DeviceType):
    """One profiled ``solve_cp_batch`` of a ``chip_smoke.BATCH``
    configuration (after a warm-up solve)."""
    import numpy as np

    from chip_smoke import BATCH, batch_costs
    from pysparselp_tpu_torch import solve_cp_batch

    cfg = BATCH[name]
    nb_iter = cfg["nb_iter"]
    kw = dict(costs=batch_costs(lp, cfg["bsz"], cfg["vary"]),
              nb_iter=nb_iter, nb_iter_plot=nb_iter // 4, dtype=np.float32,
              device="cuda")
    solve_cp_batch(lp, **kw)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _x, info = solve_cp_batch(lp, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof, DeviceType)
    kernels = {k: v for k, v in events.items()
               if "Memcpy" not in k and "Memset" not in k}
    product_us = sum(us for k, (_, us) in kernels.items()
                     if any(p in k for p in BATCH_PRODUCT_KERNELS))
    kernel_us = sum(us for _, us in kernels.values())
    itrn, sec = info["itrn"], info["opttime"]
    steady_us = (sec[-1] - sec[0]) / (itrn[-1] - itrn[0]) * 1e6
    return dict(run=f"batch_{name}", nvidia_smi=smi, batch=cfg["bsz"],
                backend=info["backend"], wall_s=wall,
                device_s=sum(us for _, us in events.values()) * 1e-6,
                kernel_us_per_iter=kernel_us / nb_iter,
                product_us_per_iter=product_us / nb_iter,
                elementwise_us_per_iter=(kernel_us - product_us) / nb_iter,
                elementwise_share=(kernel_us - product_us) / kernel_us,
                launches_per_iter=sum(c for c, _ in kernels.values())
                / nb_iter,
                steady_wall_us_per_iter=steady_us,
                steady_busy_share=kernel_us / nb_iter / steady_us,
                checkpoints_s=[float(t) for t in sec],
                events={k: dict(count=c, us=us)
                        for k, (c, us) in sorted(events.items())})


def main() -> int:
    import argparse

    import torch
    if not torch.cuda.is_available():
        print("profile_port: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--runs", nargs="*", default=None,
                        help="profile only these runs")
    wanted = parser.parse_args().runs
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import BATCH, CLIME, clime_lp, sc105_lp, transport_lp
    from pysparselp_tpu_torch.examples.potts import build_linear_program

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    runs = {
        "potts300": (lambda: build_linear_program(300, 0.5, 500)[0],
                     dict(nb_iter=2000, nb_iter_plot=1000, light_metrics=True)),
        "potts50_restart": (lambda: build_linear_program(50, 0.5, 500)[0],
                            dict(nb_iter=36000, nb_iter_plot=12000,
                                 restart="average", restart_period=4000)),
        "sc105_restart": (lambda: sc105_lp()[0],
                          dict(nb_iter=72000, nb_iter_plot=72000,
                               restart="average", restart_period=4000)),
        "transport": (transport_lp,
                      dict(nb_iter=2000, nb_iter_plot=1000,
                           light_metrics=True)),
        "clime_rcm_bsr": (lambda: clime_lp(**CLIME),
                          dict(nb_iter=2000, nb_iter_plot=1000,
                               light_metrics=True, permute="rcm")),
        "clime_unpermuted_csr": (lambda: clime_lp(**CLIME),
                                 dict(nb_iter=2000, nb_iter_plot=1000,
                                      light_metrics=True, permute=False)),
    }
    lines = []
    for name, (make, kw) in runs.items():
        if wanted is not None and name not in wanted:
            continue
        kw = dict(method="chambolle_pock_ppd", dtype=np.float32,
                  device="cuda", **kw)
        if not name.startswith("clime"):
            make().solve(**kw)  # build the kernels, warm the caches
        lp = make()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lp.solve(**kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = device_events(prof, DeviceType)
        device_us = sum(us for _, us in events.values())
        rec = dict(run=name, nvidia_smi=smi, wall_s=wall,
                   device_s=device_us * 1e-6,
                   busy_share=device_us * 1e-6 / wall,
                   checkpoints_s=[float(t) for t in lp.opttime_curve],
                   itrn=[int(i) for i in lp.itrn_curve],
                   events={k: dict(count=c, us=us)
                           for k, (c, us) in sorted(events.items())})
        rec["events_per_iter"] = (sum(c for c, _ in events.values())
                                  / lp.itrn_curve[-1])
        if kw.get("light_metrics"):
            iters = lp.itrn_curve[-1] - lp.itrn_curve[0]
            rec["device_us_per_iter"] = device_us / lp.itrn_curve[-1]
            rec["kernel_us_per_iter"] = sum(
                us for k, (_, us) in events.items()
                if "Memcpy" not in k and "Memset" not in k
            ) / lp.itrn_curve[-1]
            rec["steady_wall_us_per_iter"] = (
                (lp.opttime_curve[-1] - lp.opttime_curve[0]) / iters * 1e6)
            rec["steady_busy_share"] = (rec["device_us_per_iter"]
                                        / rec["steady_wall_us_per_iter"])
        if name.startswith("clime"):
            rec["spmv_us_per_iter"] = sum(
                us for k, (_, us) in events.items()
                if "bsr_rows_kernel" in k or "bsr_cols_kernel" in k
                or "csr_kernel" in k
                ) / lp.itrn_curve[-1]
            rec["steady_busy_share"] = (rec["kernel_us_per_iter"]
                                        / rec["steady_wall_us_per_iter"])
        if name == "potts300":
            chunk_us = sum(us for k, (_, us) in events.items()
                           if "cp_primal_kernel" in k
                           or "cp_dual_kernel" in k)
            rec["cp_device_us_per_iter"] = chunk_us / lp.itrn_curve[-1]
            rec["steady_busy_share"] = (rec["cp_device_us_per_iter"]
                                        / rec["steady_wall_us_per_iter"])
        print(json.dumps(rec), flush=True)
        lines.append(rec)
    for name, cfg in BATCH.items():
        if wanted is not None and f"batch_{name}" not in wanted:
            continue
        rec = profile_batch(torch, name, cfg["make"](), smi, profile,
                            ProfilerActivity, DeviceType)
        print(json.dumps(rec), flush=True)
        lines.append(rec)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_port.json").write_text(
        "\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
