#!/usr/bin/env python3
"""Drive the PyTorch port (``pysparselp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and the exit code is
nonzero):

1. environment: torch version, the card's name and power limit, the time
   to build the kernels from ``pysparselp_tpu_torch/csrc`` with nvcc;
2. every hand-written kernel against its plain PyTorch twin on the card, at
   the main path's shapes (Potts-300, multi-label Potts 64x64 K=4, netlib
   SC105), float32 and float64, with times;
3. the main path, ``SparseLP.solve(method="chambolle_pock_ppd")`` on the
   Potts-300 segmentation LP in float32, held checkpoint by checkpoint
   against the port's own float64 CPU run;
4. convergence: Potts-50 to the graph-cut optimum and SC105 to the perPlex
   optimum with restart-to-average.

The launch counters are set to 0 just before each solve and read just
after it; the kernel table takes H-DIA's and H-CPDIA's counts from the
Potts-300 solve and H-CPDENSE's from the SC105 solve (``launches_run``
names the solve).  Then the kernel table as one JSON line and, last, the
device line ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the package beside this script, it exits nonzero and prints no result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
# tolerance of a kernel against its twin, per output:
# max|kernel - twin| <= RTOL * max(1, max|twin|)
RTOL = {"float32": 1e-5, "float64": 1e-12}
# the Potts-300 f32 CUDA solve against the f64 CPU solve, at every
# checkpoint: objectives within MAIN_RTOL relative, violations within
# MAIN_RTOL * max(1, |f64 value|)
MAIN_RTOL = 1e-5
KERNELS = {
    "H-DIA": dict(source="pysparselp_tpu_torch/csrc/dia_spmv.cu",
                  replaces="pysparselp_tpu/ops/dia_pallas.py:168",
                  launches_run="main_path_potts300"),
    "H-CPDIA": dict(source="pysparselp_tpu_torch/csrc/cp_dia.cu",
                    replaces="pysparselp_tpu/ops/cp_windowed.py:392; "
                             "pysparselp_tpu/ops/cp_fused.py:192",
                    launches_run="main_path_potts300"),
    "H-CPDENSE": dict(source="pysparselp_tpu_torch/csrc/cp_dense.cu",
                      replaces="pysparselp_tpu/ops/cp_fused.py:381",
                      launches_run="converge_sc105"),
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` calls (CUDA events, one
    warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(torch, got, want, dtype_name, what):
    """Max abs error over paired outputs; raises when an output is past
    its tolerance, ``RTOL * max(1, max|twin output|)``."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if w.numel() == 0:
            continue
        err = float((g - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        if not err <= RTOL[dtype_name] * scale:
            raise AssertionError(
                f"{what} ({dtype_name}) output {i}: max |kernel - twin| = "
                f"{err:.3e} > {RTOL[dtype_name]:.0e} * {scale:.3e}")
        worst = max(worst, err)
    return worst


def lowered(lp, dtype, device):
    """The problem and preconditioners the solver lowers ``lp`` to on
    ``device`` (fixed variables removed, inequalities folded, the automatic
    layout presolve applied)."""
    import numpy as np
    import torch

    from pysparselp_tpu_torch.problem import (LPProblem, apply_align_embedding,
                                              ell_from_scipy)
    from pysparselp_tpu_torch.solvers.chambolle_pock import (
        _auto_layout, _fold_one_sided, host_preconditioners)

    lp = copy.deepcopy(lp)
    lp.remove_fixed_variables()
    a_eq = lp.a_equalities.tocsr() if lp.a_equalities.shape[0] else None
    a_in = lp.a_inequalities.tocsr() if lp.a_inequalities.shape[0] else None
    a_one, b_one = _fold_one_sided(a_in, lp.b_lower if a_in is not None else None,
                                   lp.b_upper if a_in is not None else None)
    sys_ = dict(a_eq=a_eq, beq=lp.b_equalities if a_eq is not None else None,
                a_ineq=a_one, b_ineq=b_one, c=lp.costsvector,
                lb=lp.lower_bounds, ub=lp.upper_bounds)
    plan = _auto_layout([a_eq, a_one])
    if plan is not None:
        sys_ = apply_align_embedding(plan, sys_)[0]

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)

    ops = [ell_from_scipy(a, dtype, device) if a is not None else None
           for a in (sys_["a_eq"], sys_["a_ineq"])]
    prob = LPProblem(
        c=vec(sys_["c"]), lb=vec(sys_["lb"]), ub=vec(sys_["ub"]),
        a_eq=ops[0], b_eq=vec(sys_["beq"]) if ops[0] is not None else None,
        a_ineq=ops[1], b_lower=None,
        b_upper=vec(sys_["b_ineq"]) if ops[1] is not None else None,
        n=len(sys_["c"]), m_eq=ops[0].nrows if ops[0] is not None else 0,
        m_ineq=ops[1].nrows if ops[1] is not None else 0)
    diag_t, s_eq, s_in = host_preconditioners(sys_["a_eq"], sys_["a_ineq"])
    pre = {"diag_t": vec(diag_t)}
    if s_eq is not None:
        pre["sigma_eq"] = vec(s_eq)
    if s_in is not None:
        pre["sigma_ineq"] = vec(s_in)
    return prob, pre


def sc105_lp():
    import numpy as np

    from pysparselp_tpu_torch import SparseLP
    from pysparselp_tpu_torch.io.netlib import get_problem

    d = get_problem("SC105")
    gt = d["solution"]
    lp = SparseLP()
    lp.add_variables_array(
        len(d["cost_vector"]), lower_bounds=d["lower_bounds"],
        upper_bounds=np.minimum(d["upper_bounds"], np.max(gt) * 2),
        costs=d["cost_vector"])
    lp.add_equality_constraints_sparse(d["a_eq"], d["b_eq"])
    lp.add_inequality_constraints_sparse(d["a_ineq"], d["b_lower"],
                                         d["b_upper"])
    lp.convert_to_one_sided_inequality_system()
    return lp, gt


def phase_kernels(torch, problems, table):
    """Phase 2: each kernel against its twin on the card."""
    import numpy as np

    from pysparselp_tpu_torch.ops import cp_dense, cp_dia, dia_spmv

    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[1]
        # H-DIA: the aligned Potts-300 operator, both orientations
        prob, _ = lowered(problems["potts300"], dt, dev)
        op = prob.a_ineq
        x = torch.as_tensor(rng.randn(op.ncols), dtype=dt, device=dev)
        y = torch.as_tensor(rng.randn(op.nrows), dtype=dt, device=dev)
        err = compare(torch, [dia_spmv.dia_spmv(op.vals, op.offs, x, op.nrows),
                              dia_spmv.dia_spmv(op.vals_t, op.offs_t, y, op.ncols)],
                      [dia_spmv.dia_spmv_reference(op.vals, op.offs, x, op.nrows),
                       dia_spmv.dia_spmv_reference(op.vals_t, op.offs_t, y,
                                                   op.ncols)],
                      name, "H-DIA potts300")
        rec = dict(kernel="H-DIA", dtype=name, shape=[op.nrows, op.ncols],
                   ndiag=op.ndiag, max_abs_err=err)
        if dt == torch.float32:
            rec.update(timings(
                torch, lambda: dia_spmv.dia_spmv(op.vals, op.offs, x, op.nrows),
                lambda: dia_spmv.dia_spmv_reference(op.vals, op.offs, x,
                                                    op.nrows), 200))
            table["H-DIA"].update(ms=rec["ms"], plain_ms=rec["plain_ms"])
        table["H-DIA"]["max_abs_err"] = max(table["H-DIA"]["max_abs_err"], err)
        emit("kernels", **rec)

        # H-CPDIA: Potts-300 (ineq-only) and multi-label Potts (eq+ineq)
        for key, nsteps in (("potts300", 100), ("multilabel64", 100)):
            prob, pre = lowered(problems[key], dt, dev)
            if not cp_dia.cp_dia_eligible(prob):
                raise AssertionError(f"{key} did not lower to DIA operators")
            x0 = torch.as_tensor(rng.rand(prob.n), dtype=dt, device=dev)
            ye0 = torch.as_tensor(rng.rand(prob.m_eq) * 0.1, dtype=dt,
                                  device=dev)
            yi0 = torch.as_tensor(rng.rand(prob.m_ineq) * 0.1, dtype=dt,
                                  device=dev)

            def kern(nsteps=nsteps, prob=prob, pre=pre):
                return cp_dia.cp_dia_chunk(prob, pre, x0, ye0, yi0, nsteps,
                                           1.0, with_sums=True)

            def plain(nsteps=nsteps, prob=prob, pre=pre):
                return cp_dia.cp_dia_chunk_reference(prob, pre, x0, ye0, yi0,
                                                     nsteps, 1.0,
                                                     with_sums=True)

            err = compare(torch, kern(), plain(), name, f"H-CPDIA {key}")
            rec = dict(kernel="H-CPDIA", problem=key, dtype=name,
                       n=prob.n, m_eq=prob.m_eq, m_ineq=prob.m_ineq,
                       nsteps=nsteps, max_abs_err=err)
            if dt == torch.float32:
                rec.update(timings(torch, kern, plain, 3, per=nsteps))
                if key == "potts300":
                    table["H-CPDIA"].update(ms=rec["ms"],
                                            plain_ms=rec["plain_ms"])
            table["H-CPDIA"]["max_abs_err"] = max(
                table["H-CPDIA"]["max_abs_err"], err)
            emit("kernels", **rec)

        # H-CPDENSE: SC105, 1000 iterations with sums
        prob, pre = lowered(problems["sc105"], dt, dev)
        if not cp_dense.cp_dense_eligible(prob):
            raise AssertionError("SC105 did not lower to dense operators")
        x0 = torch.zeros(prob.n, dtype=dt, device=dev)
        ye0 = torch.zeros(prob.m_eq, dtype=dt, device=dev)
        yi0 = torch.zeros(prob.m_ineq, dtype=dt, device=dev)

        def kern_d(prob=prob, pre=pre):
            return cp_dense.cp_dense_chunk(prob, pre, x0, ye0, yi0, 1000, 1.0,
                                           with_sums=True)

        def plain_d(prob=prob, pre=pre):
            return cp_dense.cp_dense_chunk_reference(prob, pre, x0, ye0, yi0,
                                                     1000, 1.0, with_sums=True)

        err = compare(torch, kern_d(), plain_d(), name, "H-CPDENSE sc105")
        rec = dict(kernel="H-CPDENSE", problem="sc105", dtype=name,
                   n=prob.n, m_eq=prob.m_eq, m_ineq=prob.m_ineq, nsteps=1000,
                   max_abs_err=err)
        if dt == torch.float32:
            rec.update(timings(torch, kern_d, plain_d, 3, per=1000))
            table["H-CPDENSE"].update(ms=rec["ms"], plain_ms=rec["plain_ms"])
        table["H-CPDENSE"]["max_abs_err"] = max(
            table["H-CPDENSE"]["max_abs_err"], err)
        emit("kernels", **rec)


def timings(torch, kern, plain, reps, per=1):
    """Kernel and twin in turns (plain, kernel, kernel, plain); ms per
    ``per`` iterations."""
    t = [cuda_ms(torch, f, reps) for f in (plain, kern, kern, plain)]
    return dict(ms=(t[1] + t[2]) / 2 / per, plain_ms=(t[0] + t[3]) / 2 / per)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a GPU", file=sys.stderr)
        return 2
    if not (HERE / "pysparselp_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the repository (pysparselp_tpu_torch/ "
              "not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import numpy as np

    from pysparselp_tpu_torch.examples.potts import (
        build_linear_program, build_multilabel_linear_program)
    from pysparselp_tpu_torch.ops import _build, cp_dense, cp_dia, dia_spmv

    counters = {"H-DIA": dia_spmv.dia_spmv, "H-CPDIA": cp_dia.cp_dia_chunk,
                "H-CPDENSE": cp_dense.cp_dense_chunk}

    def counted_solve(lp, **kw):
        """``lp.solve(**kw)`` with every launch counter set to 0 just
        before; returns (wall seconds, the counts of this solve)."""
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        lp.solve(**kw)
        wall = time.perf_counter() - t0
        return wall, {k: fn.launches for k, fn in counters.items()}

    # phase 1: environment and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         build_seconds=_build.build_info["seconds"],
         build_cached=_build.build_info["cached"])
    if _build.build_info["log"]:
        print(_build.build_info["log"], file=sys.stderr)

    t0 = time.perf_counter()
    problems = {
        "potts300": build_linear_program(300, 0.5, 500)[0],
        "multilabel64": build_multilabel_linear_program(64, 4)[0],
        "sc105": sc105_lp()[0],
    }
    emit("problems", build_seconds=time.perf_counter() - t0)

    table = {k: dict(name=k, route="cuda", **v, launches=None,
                     max_abs_err=0.0, ms=None, plain_ms=None)
             for k, v in KERNELS.items()}
    phase_kernels(torch, problems, table)

    # phase 3: the main path on Potts-300
    lp300 = build_linear_program(300, 0.5, 500)[0]
    run = dict(method="chambolle_pock_ppd", nb_iter=2000, nb_iter_plot=1000,
               light_metrics=True)
    wall, n300 = counted_solve(lp300, dtype=np.float32, device="cuda", **run)
    its = ((lp300.itrn_curve[-1] - lp300.itrn_curve[0])
           / (lp300.opttime_curve[-1] - lp300.opttime_curve[0]))
    names = ("pobj_curve", "dobj_curve", "max_violated_equality",
             "max_violated_inequality")
    got = {k: [float(v) for v in getattr(lp300, k)] for k in names}
    itrn = list(lp300.itrn_curve)
    t0 = time.perf_counter()
    lp300.solve(dtype=np.float64, device="cpu", **run)
    cpu_wall = time.perf_counter() - t0
    want = {k: [float(v) for v in getattr(lp300, k)] for k in names}
    if lp300.itrn_curve != itrn:
        raise AssertionError(f"checkpoints {itrn} vs {lp300.itrn_curve}")
    # worst difference per curve, relative to its limit's scale
    worst = {}
    for k in names:
        rel = [abs(g - w) / (abs(w) if k.endswith("obj_curve")
                             else max(1.0, abs(w)))
               for g, w in zip(got[k], want[k])]
        worst[k] = max(rel)
    emit("main_path_potts300", n=lp300.nb_variables, wall_s=wall,
         iters_per_s_steady=its, itrn=itrn, f32_cuda=got, f64_cpu=want,
         worst_rel_diff=worst, rel_limit=MAIN_RTOL, cpu_wall_s=cpu_wall,
         launches=n300)
    if not all(v <= MAIN_RTOL for v in worst.values()):
        raise AssertionError(f"Potts-300 f32 CUDA vs f64 CPU: {worst}")
    for key in ("H-DIA", "H-CPDIA"):
        table[key]["launches"] = n300[key]

    # phase 4: convergence with restart-to-average
    lp50, gt50, idx50, _ = build_linear_program(50, 0.5, 500)
    wall, n50 = counted_solve(
        lp50, method="chambolle_pock_ppd", nb_iter=36000, nb_iter_plot=12000,
        restart_period=4000, restart="average", dtype=np.float32,
        ground_truth=gt50, ground_truth_indices=idx50, device="cuda")
    d50 = float(np.min(lp50.distance_to_ground_truth))
    emit("converge_potts50", dist=lp50.distance_to_ground_truth,
         itrn=lp50.itrn_curve, seconds=lp50.opttime_curve, wall_s=wall,
         launches=n50)
    if not d50 < 1e-2:
        raise AssertionError(f"Potts-50 reached dist {d50} (need < 1e-2)")
    lp105, gt105 = sc105_lp()
    wall, n105 = counted_solve(
        lp105, method="chambolle_pock_ppd", nb_iter=72000, nb_iter_plot=72000,
        restart="average", restart_period=4000, dtype=np.float32,
        ground_truth=gt105, ground_truth_indices=np.arange(len(gt105)),
        device="cuda")
    d105 = float(lp105.distance_to_ground_truth[-1])
    emit("converge_sc105", dist=d105, seconds=lp105.opttime_curve[-1],
         wall_s=wall, launches=n105)
    if not d105 < 1e-3:
        raise AssertionError(f"SC105 reached dist {d105} (need < 1e-3)")
    table["H-CPDENSE"]["launches"] = n105["H-CPDENSE"]
    for key, rec in table.items():
        if not rec["launches"]:
            raise AssertionError(f"{key} was not launched in the "
                                 f"{rec['launches_run']} solve")

    print(json.dumps({"kernels": list(table.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
