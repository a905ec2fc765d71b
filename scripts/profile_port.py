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
the two checkpoints.  The same
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_port: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import CLIME, clime_lp, sc105_lp, transport_lp
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
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_port.json").write_text(
        "\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
