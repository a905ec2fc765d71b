# Verbatim copy of pysparselp_tpu/integer/__init__.py
from .propagation import propagate_constraints, revert
from .rounding import greedy_fix, greedy_round

__all__ = ["propagate_constraints", "revert", "greedy_round", "greedy_fix"]
