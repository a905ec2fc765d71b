#!/usr/bin/env python3
"""The program's spans in one traced run of a benchmark cell, on one
NVIDIA GPU.

    python3 scripts/probe_spans.py --workload potts300.to_tol --seed 7

Runs the cell as ``lp_bench/run.py --trace 1`` does (``lp_bench.lib.
harness.measure``, ``--seconds`` 45 by default) and keeps its trace; then
prints one JSON line: the run's result line (``result``) and, over the
trace's measured span,

* ``coverage``: the device's idle microseconds and the share of them
  inside some stage of the program (a ``pslp.*`` span other than the
  roots ``pslp.solve`` and ``pslp.batch``);
* ``clock``: the ``pslp.sync`` spans that end no earlier than 50 µs
  before the end of the last device record started before them, and all
  that follow one;
* ``idle_by_span``: idle microseconds by the innermost program span
  around them (``-``: none);
* ``spans_per_s``: program spans a second, by name;
* ``segment_edges``: the innermost program span at the measured span's
  start and end;
* ``top_gaps``: the ten longest idle gaps, each as ``[the harness's host
  name, the innermost program span, seconds]``;
* ``span_cost_us``: host microseconds a ``span`` entered and left costs
  with the profiler recording (CPU and CUDA activities, as the harness
  traces), with none recording, and a bare ``record_function`` with none.

The line also goes to ``chiprun_out/probe_spans_<cell>_<seed>.json``.
Exits nonzero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def innermost(trace, t0, t1):
    """``[(start, end, name)]``: ``[t0, t1]`` cut where a program span
    begins or ends, each piece named by the innermost span holding it
    (``-`` where none does)."""
    from lp_bench.lib.spans import ProgramSpans

    spans = ProgramSpans(trace)
    found = sorted((a, b, name) for name in spans.names()
                   for a, b in spans.clipped(name, t0, t1))
    cuts = sorted({t0, t1} | {x for a, b, _ in found for x in (a, b)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        inner = [s for s in found if s[0] <= a and b <= s[1]]
        # spans nest, so the shortest that holds the piece is innermost
        out.append((a, b, min(inner, key=lambda s: s[1] - s[0])[2]
                    if inner else "-"))
    return out


def idle_by_span(trace, t0, t1):
    pieces = innermost(trace, t0, t1)
    out, j = {}, 0
    for g0, g1 in trace.gaps(t0, t1):
        while pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            a, b, name = pieces[k]
            out[name] = out.get(name, 0.0) + min(g1, b) - max(g0, a)
            k += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def span_cost_us(torch, n=20_000):
    from pysparselp_tpu_torch.utils.instrumentation import span

    def per_call(make, k):
        t = time.perf_counter()
        for _ in range(k):
            with make("probe"):
                pass
        return (time.perf_counter() - t) / k * 1e6

    off = per_call(span, 10 * n)
    bare = per_call(torch.profiler.record_function, n)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        on = per_call(span, n)
    return {"profiler_on": on, "profiler_off": off,
            "bare_record_function_off": bare}


def main(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=45.0)
    args = p.parse_args(argv)
    import torch

    from lp_bench.lib import harness, spans, spec
    from lp_bench.lib.systems import PortSystem

    if not torch.cuda.is_available():
        print("probe_spans: no CUDA device", file=sys.stderr)
        return 2
    kept = {}

    class Keep(harness.RunContext):
        def __init__(self, *a):
            super().__init__(*a)
            kept["ctx"] = self

    harness.RunContext = Keep
    cell = spec.load_cell(args.workload)
    print(harness.card_line(torch), flush=True)
    result = harness.measure(cell, args.seed, args.seconds, True,
                             PortSystem("cuda", cell.config["dtype"]),
                             "cuda", T_START)
    ctx = kept["ctx"]
    trace, (t0, t1) = ctx.trace, ctx.segment
    covered, idle = spans.idle_covered(trace, t0, t1)
    agree, syncs = spans.sync_clock_agreement(trace)
    seconds = (t1 - t0) * 1e-6
    found = spans.ProgramSpans(trace)
    begun = {name: len(found.within(name, t0, t1)) / seconds
             for name in found.names()}
    pieces = innermost(trace, t0, t1)
    gaps = sorted(trace.gaps(t0, t1), key=lambda g: g[0] - g[1])[:10]
    top = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        name = next((n for a, b, n in pieces if a <= mid <= b), "-")
        top.append([trace.host_at(mid), name, (g1 - g0) * 1e-6])
    edges = [next((n for a, b, n in pieces if a <= t <= b), "-")
             for t in (t0, t1)]
    out = {"workload": args.workload, "seed": args.seed,
           "segment_edges": edges,
           "coverage": {"idle_us": idle, "covered_us": covered,
                        "share": covered / idle if idle else None},
           "clock": {"agreeing": agree, "syncs": syncs},
           "idle_by_span": idle_by_span(trace, t0, t1),
           "spans_per_s": begun, "segment_s": seconds, "top_gaps": top,
           "span_cost_us": span_cost_us(torch), "result": result}
    line = json.dumps(out)
    print(line, flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"probe_spans_{args.workload}_{args.seed}.json").write_text(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
