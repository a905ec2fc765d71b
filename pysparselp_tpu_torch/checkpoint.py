# Verbatim copy of pysparselp_tpu/checkpoint.py
"""Solver-state checkpoint / resume.

The reference has no checkpointing beyond warm starts (every solver accepts
``x0``; the dual methods accept ``y_eq``/``y_ineq`` — ``SparseLP.py:994``,
``DualCoordinateAscent.py:69-80``).  For long TPU runs the framework makes
this a first-class subsystem: solver state is a handful of vectors
(primal iterate, duals, iteration counter), saved atomically to ``.npz``
and restorable into any solver's warm-start arguments.

Orbax is intentionally not required — the state is tiny and host-resident
at chunk boundaries, so an atomic-rename ``.npz`` write is simpler and has
no async machinery to misfire; the format is also readable from plain numpy
for offline analysis.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

FORMAT_VERSION = 1


def save_checkpoint(path, x, y_eq=None, y_ineq=None, niter=0, meta=None):
    """Atomically write solver state to ``path`` (.npz)."""
    payload = {
        "version": np.asarray(FORMAT_VERSION),
        "niter": np.asarray(int(niter)),
        "x": np.asarray(x, np.float64),
    }
    if y_eq is not None:
        payload["y_eq"] = np.asarray(y_eq, np.float64)
    if y_ineq is not None:
        payload["y_ineq"] = np.asarray(y_ineq, np.float64)
    if meta:
        for k, v in meta.items():
            payload["meta_" + k] = np.asarray(v)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path) -> dict:
    """Load solver state; returns dict with x / y_eq / y_ineq / niter / meta."""
    with np.load(path) as z:
        out = {
            "niter": int(z["niter"]),
            "x": z["x"],
            "y_eq": z["y_eq"] if "y_eq" in z else None,
            "y_ineq": z["y_ineq"] if "y_ineq" in z else None,
            "meta": {
                k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")
            },
        }
    return out


class CheckpointingCallback:
    """Callback-protocol adapter: checkpoint every ``every_sec`` seconds.

    Chain into ``lp.solve(..., callback_func=ckpt.wrap(user_cb))``; on each
    callback tick past the interval, the current iterate is saved.  Solvers
    that support full-state reporting (``wants_state`` protocol, e.g.
    chambolle_pock_ppd) also persist their duals and extrapolation state, so
    a resume continues the exact trajectory::

        st = load_checkpoint(p)
        lp.solve(..., x0=st["x"], y_eq0=st["y_eq"], y_ineq0=st["y_ineq"],
                 x30=st["meta"].get("x3"))

    For solvers without state reporting, resume with ``x0=st["x"]`` only.
    """

    wants_state = True

    def __init__(self, path, every_sec=60.0):
        self.path = path
        self.every_sec = every_sec
        self._last = -float("inf")

    def __call__(self, niter, solution, energy1, energy2, duration,
                 max_violated_eq, max_violated_ineq, state=None, **_):
        if duration - self._last >= self.every_sec:
            meta = {"energy1": energy1}
            y_eq = y_ineq = None
            if state is not None:
                y_eq = state.get("y_eq")
                y_ineq = state.get("y_ineq")
                if state.get("x3") is not None:
                    meta["x3"] = state["x3"]
            save_checkpoint(self.path, solution, y_eq=y_eq, y_ineq=y_ineq,
                            niter=niter, meta=meta)
            self._last = duration

    def wrap(self, callback):
        def chained(*args, **kw):
            self(*args, **kw)
            if callback is not None:
                if not getattr(callback, "wants_state", False):
                    kw.pop("state", None)
                callback(*args, **kw)

        chained.wants_state = True
        return chained
