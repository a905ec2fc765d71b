#!/usr/bin/env python3
"""Host seconds of CP-PPD's layout presolve and lowering, per workload.

    python3 scripts/time_presolve.py [--repo PATH] [--device cuda]

Builds the Potts-300 segmentation LP, ``bench.py``'s four non-grid LPs
(transport, unstructured, k-medians, L1-SVM) and CLIME at p = 150 with
``chip_smoke.py``'s builders, folds each
as the solver does, and times what the solver of the port at ``PATH``
(default: this checkout; an older checkout to compare with) runs before its
first iteration: the layout presolve (``_choose_layout``; in a checkout
without the RCM presolve, ``_auto_layout``), the permutation it chose,
and ``lower_systems`` of the chosen systems onto ``--device``.  Prints one
JSON line per workload; nothing is solved.  Run checkouts in turns (older,
this, this, older) to compare them on one host.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load(name, path):
    """Import ``path`` as module ``name`` (registered in ``sys.modules``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=str(ROOT),
                        help="checkout whose port is timed")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import torch

    import pysparselp_tpu_torch.examples as examples
    from pysparselp_tpu_torch import problem
    from pysparselp_tpu_torch.solvers import chambolle_pock as pcp

    # this checkout's builders on the timed checkout's modeling layer
    if not (Path(examples.__file__).parent
            / "sparse_inv_covariance.py").exists():
        load("pysparselp_tpu_torch.examples.sparse_inv_covariance",
             ROOT / "pysparselp_tpu_torch/examples/sparse_inv_covariance.py")
    smoke = load("chip_smoke", ROOT / "chip_smoke.py")
    from pysparselp_tpu_torch.examples.potts import build_linear_program

    makers = {"potts300": lambda: build_linear_program(300, 0.5, 500)[0],
              **smoke.WORKLOADS}
    makers["clime"] = lambda: smoke.clime_lp(**smoke.CLIME)
    for name, make in makers.items():
        sys_ = smoke.folded(make())
        mats = [sys_["a_eq"], sys_["a_ineq"]]
        t0 = time.perf_counter()
        if hasattr(pcp, "_choose_layout"):
            choice, plan, layouts = pcp._choose_layout(mats)
        else:
            plan, layouts = pcp._auto_layout(mats), None
            choice = None if plan is None else "align"
        presolve_s = time.perf_counter() - t0
        if choice == "align":
            sys_ = problem.apply_align_embedding(plan, sys_)[0]
        elif choice == "rcm":
            sys_ = problem.apply_rcm_permutation(sys_)[0]
        permute_s = time.perf_counter() - t0 - presolve_s
        t0 = time.perf_counter()
        kw = {} if layouts is None else {"layouts": layouts}
        ops = problem.lower_systems([sys_["a_eq"], sys_["a_ineq"]],
                                    torch.float32, args.device, **kw)
        if args.device == "cuda":
            torch.cuda.synchronize()
        lower_s = time.perf_counter() - t0
        print(json.dumps(dict(
            workload=name, repo=str(repo), permutation=choice,
            lowered=[smoke.describe(o) for o in ops], presolve_s=presolve_s,
            permute_s=permute_s, lower_s=lower_s,
            total_s=presolve_s + permute_s + lower_s)), flush=True)
        del ops, sys_, mats
    return 0


if __name__ == "__main__":
    sys.exit(main())
