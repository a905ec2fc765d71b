"""The general generator: drives the system under test through one traffic
mix, as its data file describes it.

A traffic file (``traffic/<name>.json``) names one of three kinds and its
parameters; a new mix of a known kind is a new data file:

* ``"single_solve"``: one ``SparseLP.solve`` of the configuration's LP from
  zero, a checkpoint every ``nb_iter_plot`` iterations (``light_metrics``),
  ended by ``max_time`` past the window.  The window is the ``seconds``
  after the first checkpoint;
* ``"closed_loop"``: one client solving, back to back, frames of a pool of
  ``pool`` images drawn from the seed, each a whole ``SparseLP.solve`` with
  the mix's solver options (``solve_kwargs``), until the window ends;
* ``"batch"``: one batched segmentation call over ``batch`` frames, a
  checkpoint every ``nb_iter_plot`` lock-step iterations, its iterations
  sized in set-up to outlast the window.

Set-up builds the inputs and the LPs and runs one short call of the same
kind at the same shapes, which warms every shape the window uses.  Spans of
the harness (``trace.span``) mark each call in a traced run.
"""

from __future__ import annotations

import math
import time

import numpy as np

from . import inputs
from .trace import span


def kernel_build_seconds():
    """Seconds the port spent building its kernel library in this process
    (0 when it loaded the cached build): the port's own record."""
    from pysparselp_tpu_torch.ops import _build

    info = _build.build_info
    return 0.0 if info.get("cached", True) else float(info.get("seconds", 0.0))


def sync(device):
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


class SingleSolve:
    """One long solve; the rate is read from its checkpoints."""

    def __init__(self, system, cell, seed):
        self.system, self.cell, self.seed = system, cell, seed
        self.traffic = cell.traffic
        self.plot = int(self.traffic["nb_iter_plot"])

    def setup(self):
        t0 = time.perf_counter()
        self.unary = inputs.unary_images(self.cell.config, self.seed, 1)[0]
        self.lp = self.system.build(self.cell.config, self.unary)
        self.setup_parts = {"build_s": time.perf_counter() - t0}
        _, warm = self.system.solve(self.lp, nb_iter=2 * self.plot,
                                    nb_iter_plot=self.plot,
                                    **self.traffic.get("solve_kwargs", {}))
        self.setup_parts["warm_s"] = float(warm["opttime"][-1])
        self.first_s = float(warm["opttime"][0]) - kernel_build_seconds()
        self.rate = self.plot / max(float(warm["opttime"][1] - warm["opttime"][0]),
                                    1e-9)

    def window(self, seconds):
        max_time = 1.5 * self.first_s + seconds + 1.0
        chunks = math.ceil(20.0 * self.rate * max_time / self.plot) + 2
        with span("solve"):
            self.x, self.curves = self.system.solve(
                self.lp, nb_iter=chunks * self.plot, nb_iter_plot=self.plot,
                max_time=max_time, **self.traffic.get("solve_kwargs", {}))
        t = self.curves["opttime"]
        self.last = int(np.searchsorted(t, t[0] + seconds, side="right")) - 1

    def end_to_end(self):
        c, j = self.curves, self.last
        if j < 1:
            return {}
        rate = (c["itrn"][j] - c["itrn"][0]) / (c["opttime"][j] - c["opttime"][0])
        return {"iters_per_s": float(rate)}

    def segment(self, trace):
        """The measured span on the trace's clock: first to last checkpoint
        of the window."""
        s0 = trace.spans["solve"][0][0]
        t = self.curves["opttime"]
        return s0 + 1e6 * float(t[0]), s0 + 1e6 * float(t[self.last])

    def chunks(self):
        """Iterations of each chunk that ran inside the measured span."""
        return list(np.diff(self.curves["itrn"][:self.last + 1]))

    def detail(self):
        c = self.curves
        return {"iterations": int(c["itrn"][-1]),
                "checkpoints_in_window": int(self.last + 1),
                "first_checkpoint_s": float(c["opttime"][0]),
                **self.setup_parts}


class ClosedLoop:
    """Whole solves back to back by one client."""

    def __init__(self, system, cell, seed):
        self.system, self.cell, self.seed = system, cell, seed
        self.traffic = cell.traffic
        self.kw = dict(self.traffic["solve_kwargs"])

    def setup(self):
        t0 = time.perf_counter()
        pool = int(self.traffic["pool"])
        self.unary = inputs.unary_images(self.cell.config, self.seed, pool)
        self.lps = [self.system.build(self.cell.config, u) for u in self.unary]
        self.order = inputs.rng(self.seed, "order").permutation(pool)
        warm = dict(self.kw, stop_tol=None,
                    nb_iter=2 * int(self.kw["nb_iter_plot"]))
        t1 = time.perf_counter()
        self.system.solve(self.lps[self.order[-1]], **warm)
        self.setup_parts = {"build_s": t1 - t0,
                            "warm_s": time.perf_counter() - t1}

    def window(self, seconds):
        self.solves = []
        t0 = time.perf_counter()
        with span("window"):
            while time.perf_counter() - t0 < seconds:
                frame = int(self.order[len(self.solves) % len(self.order)])
                a = time.perf_counter()
                with span("solve"):
                    x, curves = self.system.solve(self.lps[frame], **self.kw)
                b = time.perf_counter()
                self.solves.append({"frame": frame, "x": x, "curves": curves,
                                    "seconds": b - a})
        self.wall = time.perf_counter() - t0

    def end_to_end(self):
        return {"solve_s": self.wall / len(self.solves)}

    def segment(self, trace):
        return trace.spans["window"][0]

    def detail(self):
        cap = int(self.kw["nb_iter"])
        its = [int(s["curves"]["itrn"][-1]) for s in self.solves]
        return {"solves": len(self.solves),
                "at_cap": int(sum(i >= cap for i in its)),
                "iterations": its, **self.setup_parts}


class Batch:
    """One batched call over a batch of frames."""

    def __init__(self, system, cell, seed):
        self.system, self.cell, self.seed = system, cell, seed
        self.traffic = cell.traffic
        self.plot = int(self.traffic["nb_iter_plot"])
        cfg = cell.config
        mul = float(cfg["coef_mul"])
        self.coef = round(cfg["coef_potts"] * mul) / mul

    def setup(self):
        t0 = time.perf_counter()
        bsz = int(self.traffic["batch"])
        self.unary = inputs.unary_images(self.cell.config, self.seed, bsz)
        self.images = self.unary / float(self.cell.config["coef_mul"])
        _, warm = self.system.segment_batch(self.images, self.coef,
                                            2 * self.plot, self.plot)
        t = warm["opttime"]
        self.setup_parts = {"warm_s": time.perf_counter() - t0}
        self.step_s = max(float(t[1] - t[0]), 1e-9)
        self.first_s = float(t[0]) - kernel_build_seconds()

    def window(self, seconds):
        span_s = 1.5 * self.first_s + seconds + 1.0
        chunks = math.ceil(span_s / self.step_s) + 1
        with span("solve"):
            self.maps, self.curves = self.system.segment_batch(
                self.images, self.coef, chunks * self.plot, self.plot)
        t = self.curves["opttime"]
        self.last = int(np.searchsorted(t, t[0] + seconds, side="right")) - 1

    def end_to_end(self):
        c, j = self.curves, self.last
        if j < 1:
            return {}
        bsz = self.maps.shape[0]
        rate = bsz * (c["itrn"][j] - c["itrn"][0]) / (c["opttime"][j]
                                                       - c["opttime"][0])
        return {"batch_iters_per_s": float(rate)}

    def segment(self, trace):
        s0 = trace.spans["solve"][0][0]
        t = self.curves["opttime"]
        return s0 + 1e6 * float(t[0]), s0 + 1e6 * float(t[self.last])

    def detail(self):
        c = self.curves
        return {"iterations": int(c["itrn"][-1]),
                "checkpoints_in_window": int(self.last + 1),
                "backend": c.get("backend"), **self.setup_parts}


KINDS = {"single_solve": SingleSolve, "closed_loop": ClosedLoop,
         "batch": Batch}


def driver(system, cell, seed):
    return KINDS[cell.traffic["kind"]](system, cell, seed)
