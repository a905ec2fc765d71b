#!/usr/bin/env python3
"""Where the time of a blocked dual coordinate ascent sweep goes, on one
NVIDIA GPU: Potts-300 (``build_linear_program(300, 0.5, 500)``), float32,
``mode="blocked"``, 3 sweeps, one checkpoint a sweep (``chip_smoke.py``'s
``main_path_dca_potts`` run).

    python3 scripts/profile_dca_blocked.py [--sweeps 3]

Prints JSON lines (also written to ``chiprun_out/profile_dca_blocked.json``):

* ``setup``: ``dca_setup``'s seconds, its colouring (``_color_rows``) and
  the colour plans' build (``ColorPlan.seconds``) apart;
* ``plain``: the solve as it runs, its seconds a sweep
  (``opttime_curve``);
* ``traced``: the same solve under ``utils.profile_trace``
  (``chip_smoke.traced``): device seconds, kernels and busy share a sweep,
  kernel time by name;
* ``stages``: the same solve with each stage of a sweep timed by
  ``time.perf_counter`` between two ``torch.cuda.synchronize()`` (so a
  stage's host and device work, without overlap with the next): of
  ``_dca_outer`` the reduced costs (``_dca_reduced_costs``), the tie point
  (``_tie_point``), the active set (the product before the sweep,
  ``CsrMatrix.matvec_plus``), the colour sweep (``_sweep``) and the rest
  (the primal guess, the energy, the violations); of ``dca_run`` the host
  copies (``to_np``), ``greedy_round`` and the callback
  (``emit_callback``), and the rest of the loop (its host reads); once a
  solve, ``dca_setup``, ``dca_run`` and the rest of ``lp.solve`` around
  them (the copy and one-sided form of the LP, the dispatch).

The solver's code is not changed: the stages are wrapped from outside.
Exits nonzero without CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out" / "profile_dca_blocked.json"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweeps", type=int, default=3)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_dca_blocked: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import numpy as np

    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.integer import rounding
    from pysparselp_tpu_torch.problem import CsrMatrix
    from pysparselp_tpu_torch.solvers import dual_ascent as da

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("")

    def emit(what, **fields):
        line = json.dumps(dict(what=what, nvidia_smi=smi, **fields))
        print(line, flush=True)
        with OUT.open("a") as f:
            f.write(line + "\n")

    lp, gt, idx, _ = build_linear_program(300, 0.5, 500)
    run = dict(method="dual_coordinate_ascent", nb_iter=args.sweeps,
               nb_iter_plot=1, mode="blocked", dtype=np.float32,
               device="cuda", ground_truth=gt, ground_truth_indices=idx)

    # the set-up, the colouring timed apart, then kept for the solves below
    colour, plans, seen = da._color_rows, [], {}
    setup = da.dca_setup

    def timed_colour(csr):
        t0 = time.perf_counter()
        out = colour(csr)
        seen["colour_s"] = seen.get("colour_s", 0.0) + (
            time.perf_counter() - t0)
        seen["groups"] = out
        return out

    def timed_setup(*a, **kw):
        t0 = time.perf_counter()
        data = setup(*a, **kw)
        seen["setup_s"] = time.perf_counter() - t0
        plans.extend(v for k, v in data.items() if k.endswith("_plan"))
        return data

    da._color_rows, da.dca_setup = timed_colour, timed_setup
    lp.solve(**dict(run, nb_iter=1))
    da._color_rows = lambda csr: seen["groups"]
    emit("setup", setup_s=seen["setup_s"], colour_s=seen["colour_s"],
         plan_s=sum(p.seconds for p in plans),
         groups=[len(p.groups) for p in plans])

    lp.solve(**run)
    t = [0.0] + [float(v) for v in lp.opttime_curve]
    emit("plain", sweeps=len(t) - 1,
         s_per_sweep=[b - a for a, b in zip(t, t[1:])],
         dual_energy=[float(v) for v in lp.dobj_curve])

    wall, dev = smoke.traced(torch, lambda: lp.solve(**run))
    t = [0.0] + [float(v) for v in lp.opttime_curve]
    sweeps = len(t) - 1
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.elapsed_us() * 1e-3
    device_s = sum(by_name.values()) * 1e-3
    emit("traced", sweeps=sweeps, wall_s=wall,
         s_per_sweep=[b - a for a, b in zip(t, t[1:])],
         device_ms_per_sweep=device_s / sweeps * 1e3,
         kernels_per_sweep=len(dev) / sweeps,
         # device time a sweep over the seconds of a sweep after the first
         # (the first holds the set-up)
         busy=device_s / sweeps / ((t[-1] - t[1]) / (sweeps - 1))
         if sweeps > 1 else None,
         device_ms_by_kernel=dict(sorted(by_name.items(),
                                         key=lambda kv: -kv[1])[:12]))

    # each stage between two synchronisations
    stage_s, calls = {}, {}
    state = {"swept": False}

    def add(name, dt):
        stage_s[name] = stage_s.get(name, 0.0) + dt
        calls[name] = calls.get(name, 0) + 1

    def wrap(name, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            add(name, time.perf_counter() - t0)
            return out
        return timed

    outer, sweep, matvec_plus = da._dca_outer, da._sweep, \
        CsrMatrix.matvec_plus

    def timed_outer(*a, **kw):
        state["swept"] = False
        return wrap("outer", outer)(*a, **kw)

    def timed_sweep(*a, **kw):
        out = wrap("colour_sweep", sweep)(*a, **kw)
        state["swept"] = True
        return out

    def timed_matvec_plus(self, *a, **kw):
        name = "active" if not state["swept"] else "metrics_products"
        return wrap(name, matvec_plus)(self, *a, **kw)

    saved = {k: getattr(da, k) for k in (
        "_dca_outer", "_sweep", "_dca_reduced_costs", "_tie_point", "to_np",
        "emit_callback", "dca_setup", "dca_run")}
    greedy = rounding.greedy_round
    da._dca_outer, da._sweep = timed_outer, timed_sweep
    da._dca_reduced_costs = wrap("reduced_costs", saved["_dca_reduced_costs"])
    da._tie_point = wrap("tie_point", saved["_tie_point"])
    da.to_np = wrap("to_np", saved["to_np"])
    da.emit_callback = wrap("callback", saved["emit_callback"])
    da.dca_setup = wrap("setup", setup)
    da.dca_run = wrap("run", saved["dca_run"])
    rounding.greedy_round = wrap("greedy_round", greedy)
    CsrMatrix.matvec_plus = timed_matvec_plus
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp.solve(**run)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            setattr(da, k, v)
        rounding.greedy_round = greedy
        CsrMatrix.matvec_plus = matvec_plus
    sweeps = len(lp.opttime_curve)
    inner = sum(stage_s.get(k, 0.0) for k in (
        "reduced_costs", "tie_point", "active", "colour_sweep",
        "metrics_products"))
    ms = {k: v / sweeps * 1e3 for k, v in stage_s.items()}
    ms["outer_rest"] = (stage_s["outer"] - inner) / sweeps * 1e3
    # once a solve: the set-up (the colouring kept from the first solve),
    # the loop (dca_run), and around them the solver's copy and one-sided
    # form of the LP and the dispatch; a sweep: what the loop does outside
    # the stages (its host reads of the energy and the violations)
    setup_s, run_s = stage_s.pop("setup"), stage_s.pop("run")
    ms.pop("setup")
    ms.pop("run")
    loop = sum(stage_s.get(k, 0.0) for k in (
        "outer", "to_np", "greedy_round", "callback"))
    emit("stages", sweeps=sweeps, total_s=total, setup_s=setup_s,
         run_s=run_s, around_run_s=total - setup_s - run_s,
         ms_per_sweep=ms, ms_per_call={
             k: v / calls[k] * 1e3 for k, v in stage_s.items()},
         calls=calls, loop_rest_ms_per_sweep=(run_s - loop) / sweeps * 1e3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
