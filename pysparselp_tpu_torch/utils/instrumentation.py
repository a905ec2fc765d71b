# Copy of pysparselp_tpu/utils/instrumentation.py; SolutionStat, save_arguments
# and load_arguments are verbatim, profile_trace runs torch.profiler, and
# span marks the solvers' stages in its traces.
"""Observability helpers: solution statistics, call capture, profiling.

Equivalents of the reference's instrumentation layer
(``pysparselp/tools.py:173-269`` — ``SolutionStat``, ``save_arguments`` —
and the ad-hoc per-loop prints): a callback-protocol statistics tracker, a
pickle-based repro capture, a ``torch.profiler`` trace context for real
device profiles instead of host tic/tocs, and the program's spans
(:func:`span`), which name its stages in any such trace.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import pickle
import time

import numpy as np
import torch


class SolutionStat:
    """Tracks solver progress through the standard callback protocol.

    Equivalent of the reference's curve tracker (``tools.py:173-242``): per
    callback records iteration, wall-clock, primal/dual energies, violations,
    the true cost/violation recomputed from the LP, and — when the problem is
    0/1-integer — whether the rounded iterate is feasible and its cost.

    Use as ``lp.solve(..., callback_func=stat)`` (instances are callable) or
    compose with another callback via ``stat.wrap(cb)``.
    """

    def __init__(self, lp=None, tol=1e-6):
        self.lp = lp
        self.tol = tol
        self.iterations = []
        self.times = []
        self.energies1 = []
        self.energies2 = []
        self.max_violations_eq = []
        self.max_violations_ineq = []
        self.costs = []
        self.true_violations = []
        self.rounded_feasible = []
        self.rounded_costs = []
        self.best_rounded_cost = np.inf
        self.best_rounded_solution = None

    def __call__(self, niter, solution, energy1, energy2, duration,
                 max_violated_eq, max_violated_ineq, **_):
        self.iterations.append(int(niter))
        self.times.append(float(duration))
        self.energies1.append(float(energy1))
        self.energies2.append(float(energy2))
        self.max_violations_eq.append(float(max_violated_eq))
        self.max_violations_ineq.append(float(max_violated_ineq))
        if self.lp is not None:
            solution = np.asarray(solution)
            self.costs.append(float(self.lp.cost(solution)))
            viol = float(self.lp.max_constraint_violation(solution))
            self.true_violations.append(viol)
            r = np.round(solution)
            rviol = float(self.lp.max_constraint_violation(r))
            feas = rviol < self.tol
            self.rounded_feasible.append(feas)
            rcost = float(self.lp.cost(r))
            self.rounded_costs.append(rcost)
            if feas and rcost < self.best_rounded_cost:
                self.best_rounded_cost = rcost
                self.best_rounded_solution = r

    def wrap(self, callback):
        """Chain: record stats, then forward to ``callback``."""

        def chained(*args, **kw):
            self(*args, **kw)
            if callback is not None:
                callback(*args, **kw)

        return chained

    def summary(self) -> dict:
        return {
            "niter": self.iterations[-1] if self.iterations else 0,
            "elapsed": self.times[-1] if self.times else 0.0,
            "final_cost": self.costs[-1] if self.costs else None,
            "final_violation": (
                self.true_violations[-1] if self.true_violations else None
            ),
            "best_rounded_cost": (
                None if self.best_rounded_cost == np.inf
                else self.best_rounded_cost
            ),
        }


def save_arguments(filename, level: int = 1):
    """Pickle the calling function's arguments for offline repro.

    Equivalent of ``tools.py:245-269``: captures the caller's bound locals
    (its arguments at entry) into ``filename`` so a failing solver call can
    be replayed standalone.
    """
    frame = inspect.stack()[level].frame
    args, _, _, values = inspect.getargvalues(frame)
    payload = {}
    for name in args:
        v = values[name]
        try:
            pickle.dumps(v)
        except Exception:
            continue
        payload[name] = v
    with open(filename, "wb") as f:
        pickle.dump(payload, f)
    return payload


def load_arguments(filename) -> dict:
    with open(filename, "rb") as f:
        return pickle.load(f)


# the profiler loses the first device records of each trace, the more the
# older the process (on an H100 with torch 2.11, about one record for every
# 12 s of the process's age: scripts/probe_trace_loss.py); on a card each
# trace therefore starts with one replay of a CUDA graph of this many tiny
# kernels, whose records take the loss and are then cut from the trace
WARMUP_KERNELS = 4096
_WARMUP_GRAPHS = {}


def _warmup_graph(torch):
    """The current card's CUDA graph of ``WARMUP_KERNELS`` one-element adds,
    captured once (outside any trace)."""
    device = torch.cuda.current_device()
    if device not in _WARMUP_GRAPHS:
        buf = torch.zeros(1, device="cuda")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(WARMUP_KERNELS):
                buf.add_(1.0)
        _WARMUP_GRAPHS[device] = (graph, buf)
    return _WARMUP_GRAPHS[device][0]


def cut_warmup(path):
    """Remove the warm-up graph's launch, kernels and flow arrows from the
    Chrome trace at ``path`` (its first ``cudaGraphLaunch``); return how
    many of its kernel records the trace held.  None held means the loss
    may have reached the traced run's first records: that warns."""
    import json
    import warnings

    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and "GraphLaunch" in e.get("name", "")),
                      key=lambda e: e["ts"])
    if not launches:
        return 0
    corr = launches[0].get("args", {}).get("correlation")
    ours = [e for e in events if e.get("args", {}).get("correlation") == corr
            or (e.get("cat") == "ac2g" and e.get("id") == corr)]
    kept = sum(e.get("cat") == "kernel" for e in ours)
    drop = {id(e) for e in ours}
    trace["traceEvents"] = [e for e in events if id(e) not in drop]
    with open(path, "w") as f:
        json.dump(trace, f)
    if not kept:
        warnings.warn(f"{path}: the profiler kept none of the "
                      f"{WARMUP_KERNELS} warm-up kernel records, so the "
                      "traced run's first device records may be missing",
                      stacklevel=2)
    return kept


@contextlib.contextmanager
def profile_trace(log_dir=None, enabled=True):
    """Capture a ``torch.profiler`` trace around a solver run.

    The replacement for the reference's host-side ``Chrono`` tic/tocs
    (``tools.py:34-44``, ``ADMM.py:110-113``): wall-clock around a launch
    measures nothing on an asynchronous device — a profiler trace shows the
    real kernel timeline.  Records CPU activity, and CUDA activity (every
    kernel, the hand kernels' too) when ``torch.cuda.is_available()``; on
    exit writes a Chrome trace, ``trace.json``, under ``log_dir`` (default
    ``torch_trace_<unix time>`` in the working directory), which the
    context yields.  View with Perfetto or ``chrome://tracing``.  On a
    card the trace first replays a warm-up CUDA graph whose kernel records
    absorb the profiler's loss of a trace's first records, and cuts them
    from the written trace (:func:`cut_warmup`).
    """
    if not enabled:
        yield None
        return
    log_dir = log_dir or os.path.join(
        os.getcwd(), f"torch_trace_{int(time.time())}"
    )
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    warmup = None
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        warmup = _warmup_graph(torch)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    if warmup is not None:
        warmup.replay()
        torch.cuda.synchronize()
    try:
        yield log_dir
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        if warmup is not None:
            cut_warmup(path)


SPAN_PREFIX = "pslp."
_NO_SPAN = contextlib.nullcontext()
_autograd_profiler = torch.autograd.profiler


def span(name: str):
    """A context that marks a stage of the program as the host span
    ``pslp.<name>`` in the trace of a running ``torch.profiler`` (a
    ``record_function`` range: it lands in the same trace as the kernels,
    on the same clock, so a trace's idle gaps can be put down to a stage).
    With no profiler recording it is a shared no-op context, and the call
    costs one read of the profiler's flag: ``record_function`` itself costs
    microseconds even when nothing records.

    The solvers open spans at their stage boundaries, at most a few a
    chunk, never an iteration or a launch: ``solve`` (``SparseLP.solve``,
    the root), ``presolve.reduce``, ``presolve.layout``, ``presolve.lower``,
    ``cp.chunk``, ``cp.checkpoint`` and ``postsolve`` (Chambolle-Pock);
    ``batch`` (``solve_cp_batch``, a root), ``batch.lower``, ``batch.chunk``
    and ``batch.checkpoint``; ``sync`` around each blocking read of a
    device tensor (``solvers.base.fetch``)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN
