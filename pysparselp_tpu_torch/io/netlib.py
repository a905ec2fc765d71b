"""Netlib LP test-problem loader (mirrors ``pysparselp_tpu/io/netlib.py``).

The problems and their perPlex exact solutions are read by file path from
the JAX package's vendored data (``pysparselp_tpu/io/data``), which sits
beside this package in the repository; nothing is imported from that
package and nothing is duplicated.  Unlike the original, a missing problem
raises instead of being fetched: the port needs no network.
"""

from __future__ import annotations

import os

from .mps import mps_parser

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "pysparselp_tpu", "io", "data")


def get_problem(problem_name, data_dir=None):
    """Load a netlib problem (+ perPlex exact solution when available).

    Returns the ``mps_parser`` dict with a ``solution`` entry.
    """
    here = data_dir or DATA_DIR
    filename_lp = os.path.join(here, "netlib", problem_name.upper() + ".SIF")
    filename_sol = os.path.join(here, "perPlex", problem_name.lower() + ".txt")
    if not os.path.isfile(filename_lp):
        raise FileNotFoundError(
            f"netlib problem {problem_name!r} not found at {filename_lp}")
    with open(filename_lp) as file_lp:
        f_sol = open(filename_sol) if os.path.isfile(filename_sol) else None
        try:
            return mps_parser(file_lp, f_sol)
        finally:
            if f_sol is not None:
                f_sol.close()
