# Verbatim copy of pysparselp_tpu/utils/__init__.py
from .debug import assert_all_finite, debug_mode
from .instrumentation import (
    SolutionStat,
    load_arguments,
    profile_trace,
    save_arguments,
)
from .timers import CheckDecrease, Chrono
from .xorshift import XorShift

__all__ = [
    "Chrono",
    "CheckDecrease",
    "XorShift",
    "SolutionStat",
    "save_arguments",
    "load_arguments",
    "profile_trace",
    "debug_mode",
    "assert_all_finite",
]
