#!/usr/bin/env python3
"""Whether ``torch.profiler`` keeps every kernel record of a trace as the
process ages, on one NVIDIA GPU: a 20,000-iteration Potts-50 CP solve
(float32, 2,000-iteration chunks, 10 H-CPDIA-R launches) traced at a
given age of the process, twice in a row.

    python3 scripts/probe_trace_loss.py plain|profile_trace|eager \\
        [--ages 0 150 300]

* ``plain``: a bare ``torch.profiler.profile`` (CPU and CUDA activity);
* ``profile_trace``: ``utils.profile_trace``, which replays its warm-up
  CUDA graph first and cuts it from the trace (``warmup_kept``: how many
  of the graph's kernel records the trace held before the cut);
* ``eager``: a bare profile that first launches ``--burst`` one-element
  adds one by one (``burst``; their launches come first).

Per trace: the kernel events, the kernel launches the trace records and
how many of them lack their kernel record (``missing``, with the first
launch indices in time order), those among the solve's own launches
(``solve_missing``), and H-CPDIA-R's events against its launch counter.
One JSON line per trace (the card's name and power limit first), also
written to ``probe_trace_loss_<variant>.json`` in the repository's
output directory (``dest`` below); exits nonzero without CUDA.  Run the variants as
separate processes to compare them at the same ages.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variant", choices=("plain", "profile_trace", "eager"))
    ap.add_argument("--ages", type=float, nargs="+", default=[0, 150, 300])
    ap.add_argument("--burst", type=int, default=512)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_trace_loss: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from torch.profiler import ProfilerActivity, profile

    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.ops import cp_dia
    from pysparselp_tpu_torch.utils import instrumentation

    lines = [subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()]
    print(lines[0], flush=True)
    lp = build_linear_program(50, 0.5, 500)[0]

    def solve():
        lp.solve(method="chambolle_pock_ppd", nb_iter=20000,
                 nb_iter_plot=2000, dtype=np.float32, device="cuda")

    solve()
    torch.cuda.synchronize()
    kept = []
    cut = instrumentation.cut_warmup

    def counting_cut(path):
        kept.append(cut(path))
        return kept[-1]

    instrumentation.cut_warmup = counting_cut
    scratch = torch.zeros(16, device="cuda")
    tmp = Path(tempfile.mkdtemp())
    t0 = time.time()

    def trace(age):
        cp_dia.cp_dia_resident_chunk.launches = 0
        burst = args.burst if args.variant == "eager" else 0
        path = tmp / "trace.json"
        if args.variant == "profile_trace":
            with instrumentation.profile_trace(str(tmp)):
                solve()
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(burst):
                    scratch.add_(1.0)
                solve()
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        corr = {e.get("args", {}).get("correlation") for e in kernels}
        launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                           and "Launch" in e["name"]), key=lambda e: e["ts"])
        miss = [i for i, e in enumerate(launches)
                if e.get("args", {}).get("correlation") not in corr]
        return dict(
            variant=args.variant, age_s=age, kernels=len(kernels),
            launches=len(launches), burst=burst, missing=len(miss),
            missing_first=miss[:5], solve_missing=sum(i >= burst for i in miss),
            h_cpdia_r_events=sum("cp_dia_resident" in e["name"]
                                 for e in kernels),
            counter=cp_dia.cp_dia_resident_chunk.launches,
            warmup_kept=kept.pop() if kept else None,
            trace_bytes=path.stat().st_size)

    for age in args.ages:
        time.sleep(max(0.0, age - (time.time() - t0)))
        for _ in range(2):
            rec = trace(time.time() - t0)
            lines.append(json.dumps(rec))
            print(lines[-1], flush=True)
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"probe_trace_loss_{args.variant}.json").write_text(
        "\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
