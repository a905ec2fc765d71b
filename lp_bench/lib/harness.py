"""One run of one cell: set-up, the measured window, the metrics, the
output check, and the result line.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; ``checks``, each number compared beside its limit, comes
last); the last lines of standard error are those numbers again.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

from . import checks, drive, spec
from .systems import PortSystem

FORBIDDEN = ("jax", "jaxlib", "flax", "pysparselp_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (names compared whole: ``pysparselp_tpu_torch`` is not one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line(torch):
    """The card's name and power limit, as ``nvidia-smi`` reads them, on a
    line of plain text (not JSON, so that it is never taken for a result)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    limits = "; ".join(out[:torch.cuda.device_count()]) or "not read"
    return f"lp_bench: card {torch.cuda.get_device_name(0)}; nvidia-smi: {limits}"


class RunContext:
    """What a per-layer metric reader sees of a traced run."""

    def __init__(self, run, trace, segment, peak):
        self.run = run
        self.trace = trace
        self.segment = segment
        self.peak = peak
        self.kind = run.traffic["kind"]
        self.config = run.cell.config
        self.traffic = run.traffic


def measure(cell, seed, seconds, trace, system, device, t_start,
            bench_dir=spec.BENCH_DIR):
    """Set up, run the window, check; returns the result line's dict, with
    ``checks`` last."""
    import torch

    from . import roofline
    from .trace import Tracer

    if "host_threads" in cell.traffic:
        torch.set_num_threads(int(cell.traffic["host_threads"]))
    run = drive.driver(system, cell, seed)
    ready_s = time.perf_counter() - t_start
    run.setup()
    drive.sync(device)
    setup_s = time.perf_counter() - t_start

    window_s = seconds
    if trace and "trace_seconds" in cell.traffic:
        window_s = min(seconds, float(cell.traffic["trace_seconds"]))
    with Tracer(trace) as tr:
        run.window(window_s)
        drive.sync(device)
    on_card = device == "cuda"
    peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0
    metrics = {}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak_bytes)}
    breakdown = None
    if not trace:
        e2e = dict(run.end_to_end(), setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    elif tr.trace is not None:
        seg = run.segment(tr.trace)
        pk = roofline.peak(dev["kind"])
        ctx = RunContext(run, tr.trace, seg, pk)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], bench_dir)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev["busy_s"] = tr.trace.busy(*seg) * 1e-6
        dev["window_s"] = (seg[1] - seg[0]) * 1e-6
        breakdown = {"device_ops": tr.trace.device_ops(*seg),
                     "idle_gaps": tr.trace.idle_gaps(*seg)}
    detail = dict(run.detail(), ready_s=ready_s,
                  kernel_build_s=drive.kernel_build_seconds() if on_card else 0.0)

    # the reference runs on the device after the program's state is freed
    for k in ("lp", "lps"):
        if hasattr(run, k):
            delattr(run, k)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    nums, attempted, failed = checks.check(run, cell.limits, device)
    result = {"correct": bool(failed == 0 and all(
                  nums[k] <= cell.limits[k] for k in nums)),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["detail"] = detail
    result["checks"] = {k: {"value": v, "limit": cell.limits[k]}
                        for k, v in nums.items()}
    return result


def main(argv, t_start):
    args = parse(argv)
    import torch

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"lp_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(card_line(torch), flush=True)
    system = PortSystem("cuda", cell.config["dtype"])
    result = measure(cell, args.seed, args.seconds, bool(args.trace), system,
                     "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"lp_bench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
