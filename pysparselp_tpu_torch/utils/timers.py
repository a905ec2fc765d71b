# Verbatim copy of pysparselp_tpu/utils/timers.py
"""Small instrumentation helpers (reference ``pysparselp/tools.py:34-59``)."""

from __future__ import annotations

import time


class Chrono:
    """tic/toc wall-clock timer."""

    def __init__(self):
        self.start = None

    def tic(self):
        self.start = time.perf_counter()
        return self

    def toc(self) -> float:
        return time.perf_counter() - self.start


class CheckDecrease:
    """Asserts a tracked value never increases beyond a tolerance."""

    def __init__(self, val=None, tol=1e-10):
        self.val = val
        self.tol = tol

    def set_value(self, val):
        self.val = val

    def add_value(self, val):
        assert self.val is None or self.val >= val - self.tol, (
            f"value increased: {self.val} -> {val}"
        )
        self.val = val
