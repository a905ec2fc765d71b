"""Shared helpers of the benchmark's CPU tests: cells of ``BENCHMARK.json``
cut to a tiny image so that a whole run fits a test."""

from __future__ import annotations

import time

from lp_bench.lib import harness, spec
from lp_bench.lib.systems import PortSystem

# a tiny stand-in of each traffic mix: the same kind, fewer iterations
TINY_TRAFFIC = {
    "single_solve": {"nb_iter_plot": 200},
    "closed_loop": {"pool": 2, "solve_kwargs": {
        "nb_iter": 4000, "nb_iter_plot": 200, "restart": "average",
        "restart_period": 200, "stop_tol": 1e-4}},
    "batch": {"batch": 4, "nb_iter_plot": 50, "check_frames": 4},
}
SEED = 2 ** 31 + 11


def tiny_cell(name, size=12, **kw):
    cell = spec.load_cell(name, **kw)
    cell.config["image_size"] = size
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["kind"]])
    return cell


def run_cpu(cell, system=None, seconds=0.5, trace=False, seed=SEED):
    """One run of ``cell`` on the CPU (the port's plain twins): the result
    dict a run prints."""
    system = system or PortSystem("cpu", cell.config["dtype"])
    return harness.measure(cell, seed, seconds, trace, system, "cpu",
                           time.perf_counter())
