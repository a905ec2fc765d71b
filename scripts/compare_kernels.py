#!/usr/bin/env python3
"""Per-call times of the port's SpMV and CP-chunk kernels, as the main
path calls them, for one checkout of the repository, on one NVIDIA GPU.

    python3 scripts/compare_kernels.py [--repo PATH] [--sections ...]

Imports ``pysparselp_tpu_torch`` from ``PATH`` (default: this checkout) and
this checkout's ``chip_smoke.py`` for the workloads and the timer, so two
commits compare on one card: ``git archive`` the other into a directory
that ``.gitignore`` lists and run it, this checkout, this checkout, it, in
one call.  Times, in float32, through the operators' own entry points:

* H-CSR on ``chip_smoke.csr_matrices`` (transport, unstructured, the
  k-medians CSR block; ``A x`` and ``Aᵀ y``), beside cuSPARSE
  (``torch.mv`` of a ``torch.sparse_csr_tensor``); the transport and
  k-medians systems, whose values are exact in bfloat16, also on values
  stored in bfloat16, in turns with float32 values, where the checkout
  stores them so (``values`` in each line);
* H-BSR on the RCM-permuted CLIME system at p = 150 through
  ``BsrMatrix.from_scipy(a, ...)`` at the checkout's default tiles
  (``matvec``, ``rmatvec``, and the pair in turns, ``chip_smoke.pair_times``);
* H-DIA on the aligned Potts-300 system (``A x``) and on its 4 row shards
  (forward and window, K5's function), beside cuSPARSE;
* H-CPDIA (``cp_dia_chunk``, chunks with sums, per iteration) at Potts-50
  (H-CPDIA-R where the checkout plans it), Potts-100, Potts-300 and the
  multi-label 64 grid (H-CPDIA-G where the checkout plans it; the
  two-launch kernel forced beside it), the planes as the checkout stores
  them; Potts-300's main-path solve (2,000 float32 iterations,
  ``light_metrics``) twice, its steady iterations/s; and Potts-50's
  steady run and restart solve: iterations/s, seconds to the graph cut
  and the device's busy share (:func:`time_cpdia`);
* H-CPDIA's shard entry, one call, on Potts-300 as one shard and on a
  quarter shard, the two-launch shard entry beside it where the checkout
  keeps it (:func:`time_cpdia_shard`); the two-launch chunk kernel, the
  tier of planes past shared memory, at Potts-300 in float64 and Potts-500
  in float32, with Potts-500's host build seconds and device memory
  (:func:`time_two_launch_tier`); ``--sections cpdia_shard`` runs these
  two alone;
* H-CPDENSE, 1,000 iterations with sums, per iteration: on SC105, on
  ``chip_smoke.dense_system`` (operators past shared memory) and on square
  random systems of ``SQUARE_SIZES`` rows and columns; where the checkout
  takes ``lanes``, also at each of ``LANES`` lanes per output.

For each, ``chip_smoke.call_times``: CUDA events over back-to-back calls,
the profiler's device time and kernels per call, and host time per call.
Then the four per-operator solves of ``chip_smoke.WORKLOADS`` (transport,
unstructured, k-medians, L1-SVM), float32, ``SOLVE_ITERS`` iterations
with ``light_metrics``, twice each: their steady iterations/s; and L1-SVM
twice more with the chooser's price of H-BSR's longest tile-line at zero
(``l1svm_no_line_price``: ``_choose_layout(..., bsr_line_price=0)`` in
the solve; the chooser then takes RCM and H-BSR).
H-BSR is also timed on that RCM-permuted L1-SVM system, whose longest
tile-column gives one warp's streaming rate (new-format checkouts only).
H-DCA (``--sections dca``): the sequential sweep over Potts-300's
one-sided rows in float32 (``chip_smoke.dca_state``'s mid-solve state):
device milliseconds a sweep (the mean of each H-DCA kernel's profiler
events, summed over the kernels a sweep launches: one in a checkout
before the level schedule, the key chain, the draws and the levels
after), CUDA events over whole calls, and the sequential DCA solve of
Potts-300 for 3 sweeps (float32): its dual energy after each sweep,
printed exactly, and its seconds a sweep (:func:`time_dca`); then H-DCA-C,
a colour sweep of the same state through the checkout's entry (one launch
where it has ``dca_color_sweep``, a launch a group before), and the
blocked solve's dual energies and seconds a sweep
(:func:`time_dca_colour`; the colouring kept in ``build/`` for the
checkouts after the first).
The batched products (``--sections batch``): H-DIA-B on
``chip_smoke.BATCH``'s banded operator (B = 16) and the DIA block of its
assignment system (B = 8), H-CSR-B on the unstructured one (B = 8), both
orientations, float32 and float64, through ``dia_spmm`` / ``csr_spmm``;
then the banded and unstructured ``solve_cp_batch`` runs profiled as
``scripts/profile_port.py --runs batch_banded batch_unstructured``
profiles them, with their problem-iterations/s and busy share
(:func:`time_batch`).
``--sections`` picks a subset (``csr bsr dia cpdense cpdia cpdia_shard
solves dca batch``).
Prints one JSON line per measurement (with the card's name and power limit
and the repository path); exits nonzero without CUDA.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import inspect
import json
import subprocess
import sys
import warnings
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
SQUARE_SIZES = (16, 48, 104, 152)
LANES = (1, 2, 4, 8, 16)
SOLVE_ITERS = 2000
SECTIONS = ("csr", "bsr", "dia", "cpdense", "cpdia", "cpdia_shard",
            "solves", "dca", "batch")
# the two-launch chunk tier's shapes: (name, grid size, dtype name), and
# its iterations a timed chunk (with sums)
TIER_CASES = (("potts300", 300, "float64"), ("potts500", 500, "float32"))
TIER_STEPS = 100


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=str(ROOT),
                        help="checkout whose pysparselp_tpu_torch is timed")
    parser.add_argument("--sections", nargs="+", choices=SECTIONS,
                        default=list(SECTIONS),
                        help="what to time (default: all)")
    args = parser.parse_args()
    sections = set(args.sections)
    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    repo = str(Path(args.repo).resolve())
    sys.path.insert(0, repo)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.modules["chip_smoke"] = smoke
    import numpy as np

    import pysparselp_tpu_torch
    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.ops import bsr_spmv, cp_dense, dia_spmv
    from pysparselp_tpu_torch.parallel.sharded_dia import build_system_dia
    from pysparselp_tpu_torch.problem import (BsrMatrix, CsrMatrix,
                                              apply_rcm_permutation)
    from pysparselp_tpu_torch.solvers import chambolle_pock
    from pysparselp_tpu_torch.solvers.chambolle_pock import _choose_layout

    if not pysparselp_tpu_torch.__file__.startswith(repo):
        raise AssertionError(f"imported {pysparselp_tpu_torch.__file__}, "
                             f"not from {repo}")
    warnings.filterwarnings("ignore", message="Sparse (CSR|BSR) tensor")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    dt = torch.float32
    rng = np.random.RandomState(0)

    def emit(kernel, problem, side, kern, lib=None, per=1, reps=200,
             **extra):
        rec = dict(repo=repo, nvidia_smi=smi, kernel=kernel,
                   problem=problem, side=side, **extra,
                   kernel_us=smoke.call_times(torch, kern, reps=reps,
                                              host_reps=max(reps, 3)))
        if per != 1:
            rec["per_iteration_us"] = {
                k: rec["kernel_us"][k] / per
                for k in ("events_us", "device_us", "host_us")}
        if lib is not None:
            rec["library_us"] = smoke.call_times(torch, lib, reps=reps)
        print(json.dumps(rec), flush=True)

    if "csr" in sections:
        time_csr(smoke, torch, emit, rng, dt, dev, CsrMatrix)
    if "bsr" in sections:
        time_bsr(smoke, torch, emit, rng, dt, dev, repo, smi, BsrMatrix,
                 bsr_spmv, apply_rcm_permutation)
    if "dia" in sections:
        time_dia(smoke, torch, emit, rng, dt, dev, build_linear_program,
                 dia_spmv, build_system_dia)
    if "cpdense" in sections:
        time_cpdense(smoke, torch, emit, dt, dev, cp_dense)
    if sections & {"cpdia", "cpdia_shard"}:
        time_cpdia_shard(smoke, torch, emit, dt)
        time_two_launch_tier(smoke, torch, rng, dev, repo, smi)
    if "cpdia" in sections:
        time_cpdia(smoke, torch, emit, rng, dt, dev, repo, smi)
    if "solves" in sections:
        time_solves(smoke, np, repo, smi, chambolle_pock, _choose_layout)
    if "dca" in sections:
        time_dca(smoke, torch, np, repo, smi, build_linear_program)
    if "batch" in sections:
        time_batch(smoke, torch, emit, rng, dev, repo, smi)
    return 0


def time_csr(smoke, torch, emit, rng, dt, dev, CsrMatrix):
    # H-CSR on the main path's unstructured systems; where the checkout
    # stores exact values in bfloat16 (CsrMatrix.from_scipy's allow_bf16),
    # the systems of chip_smoke.BF16_CSR on both storages, in turns
    # (float32, bfloat16, bfloat16, float32 values)
    workloads = {k: smoke.folded(make())
                 for k, make in smoke.WORKLOADS.items() if k != "l1svm"}
    bf16 = "allow_bf16" in inspect.signature(CsrMatrix.from_scipy).parameters
    for key, a in smoke.csr_matrices(workloads).items():
        stores = {"float32": CsrMatrix.from_scipy(a, dt, dev)}
        if bf16 and key in smoke.BF16_CSR:
            stores["bfloat16"] = CsrMatrix.from_scipy(a, dt, dev,
                                                      allow_bf16="exact")
        order = (["float32", "bfloat16", "bfloat16", "float32"]
                 if len(stores) > 1 else ["float32"])
        for side, host, n_in in (("A", a, a.shape[1]),
                                 ("At", a.T.tocsr(), a.shape[0])):
            x = torch.as_tensor(rng.randn(n_in), dtype=dt, device=dev)
            lib = smoke.sparse_tensor(torch, host, dt, dev)
            for values in order:
                op = stores[values]
                fn = op.matvec if side == "A" else op.rmatvec
                emit("H-CSR", key, side, lambda fn=fn, x=x: fn(x),
                     lambda lib=lib, x=x: torch.mv(lib, x),
                     values=str(op.vals.dtype).split(".")[1])


def time_bsr(smoke, torch, emit, rng, dt, dev, repo, smi, BsrMatrix, bsr_spmv,
             apply_rcm_permutation):
    # H-BSR on the RCM-permuted CLIME matrix, as the operator serves it
    clime = smoke.folded(smoke.clime_lp(**smoke.CLIME))
    a = apply_rcm_permutation(clime)[0]["a_ineq"]
    op = BsrMatrix.from_scipy(a, dt, dev)
    x = torch.as_tensor(rng.randn(op.ncols), dtype=dt, device=dev)
    y = torch.as_tensor(rng.randn(op.nrows), dtype=dt, device=dev)
    bsr_systems = [("clime150_rcm", a)]
    if hasattr(bsr_spmv, "BsrOperand"):
        # a tile-column of 3,755 tiles: one warp's rate (the chooser's
        # warp_line_price); the 128x128 block-ELL would store GBs
        l1svm = apply_rcm_permutation(smoke.folded(smoke.l1svm_lp()))[0]
        bsr_systems.append(("l1svm_rcm", l1svm["a_ineq"]))
    for key, a in bsr_systems:
        op = BsrMatrix.from_scipy(a, dt, dev)
        x = torch.as_tensor(rng.randn(op.ncols), dtype=dt, device=dev)
        y = torch.as_tensor(rng.randn(op.nrows), dtype=dt, device=dev)
        emit("H-BSR", key, "A", lambda: op.matvec(x))
        emit("H-BSR", key, "At", lambda: op.rmatvec(y))
        lines = (dict(longest_lines=op.op.longest_lines, tile=op.tile)
                 if hasattr(op, "op") else {})
        print(json.dumps(dict(
            repo=repo, nvidia_smi=smi, kernel="H-BSR", problem=key,
            side="pair", stored_entries=op.nnz_padded, **lines,
            pair_us=smoke.pair_times(torch, lambda: op.matvec(x),
                                     lambda: op.rmatvec(y)))), flush=True)
        del op
    del clime, bsr_systems, a


def time_dia(smoke, torch, emit, rng, dt, dev, build_linear_program,
             dia_spmv, build_system_dia):
    # H-DIA: aligned Potts-300 and its 4 row shards (K5's function)
    lp300 = build_linear_program(300, 0.5, 500)[0]
    prob, _ = smoke.lowered(lp300, dt, dev)
    op = prob.a_ineq
    x = torch.as_tensor(rng.randn(op.ncols), dtype=dt, device=dev)
    lib = smoke.sparse_tensor(torch, smoke.dia_scipy(op), dt, dev)
    emit("H-DIA", "potts300", "A", lambda: op.matvec(x),
         lambda: torch.mv(lib, x))
    potts = smoke.aligned_potts(lp300)
    prepared = hasattr(dia_spmv, "DiaOperand")
    for rank in range(smoke.MESH_RANKS):
        s, rows_loc, _ = build_system_dia(potts["a_ineq"], potts["b_ineq"],
                                          smoke.MESH_RANKS, rank)
        for side, vals_h, offs_h, n_in, n_out in (
                ("forward", s["dia_vals"], s["dia_offs"],
                 potts["a_ineq"].shape[1], rows_loc),
                ("window", s["dia_vals_t"], s["dia_offs_t"], rows_loc,
                 s["dia_vals_t"].shape[1])):
            vals = torch.as_tensor(vals_h, dtype=dt, device=dev)
            offs = torch.as_tensor(offs_h, device=dev)
            xs = torch.as_tensor(rng.randn(n_in), dtype=dt, device=dev)
            if prepared:
                operand = dia_spmv.DiaOperand(vals, offs, n_out)

                def kern(operand=operand, xs=xs):
                    return dia_spmv.dia_apply(operand, xs)
            else:
                def kern(vals=vals, offs=offs, xs=xs, n_out=n_out):
                    return dia_spmv.dia_spmv(vals, offs, xs, n_out)
            emit("H-DIA (K5)", f"potts300 shard {rank}", side, kern)


def time_cpdense(smoke, torch, emit, dt, dev, cp_dense):
    # H-CPDENSE, 1,000 iterations with sums per call: SC105, the system
    # past shared memory of chip_smoke.py, and square random systems of m
    # rows (half equalities) by m columns, whose times per iteration give
    # the kernel's fixed cost per iteration and its cost per entry
    lanes_knob = "lanes" in inspect.signature(
        cp_dense.cp_dense_chunk).parameters
    systems = [("sc105", None), ("dense_past_shared", smoke.dense_system())]
    systems += [(f"square_{m}", smoke.dense_system(m // 2, m - m // 2, m,
                                                   seed=m))
                for m in SQUARE_SIZES]
    for key, host in systems:
        if host is None:
            prob, pre = smoke.lowered(smoke.sc105_lp()[0], dt, dev)
        else:
            prob, pre = smoke.lowered_system(host, dt, dev)
        if not cp_dense.cp_dense_eligible(prob):
            raise AssertionError(f"{key} did not lower to dense operators")
        zeros = [torch.zeros(k, dtype=dt, device=dev)
                 for k in (prob.n, prob.m_eq, prob.m_ineq)]
        emit("H-CPDENSE", key, f"chunk {prob.m_eq}+{prob.m_ineq}x{prob.n}",
             lambda prob=prob, pre=pre, zeros=zeros: cp_dense.cp_dense_chunk(
                 prob, pre, *zeros, 1000, 1.0, with_sums=True),
             per=1000, reps=5)
        if not lanes_knob or key == "dense_past_shared":
            continue
        for lanes in LANES:
            emit("H-CPDENSE", key, f"chunk, {lanes} lanes per output",
                 lambda prob=prob, pre=pre, zeros=zeros, lanes=lanes:
                 cp_dense.cp_dense_chunk(prob, pre, *zeros, 1000, 1.0,
                                         with_sums=True, lanes=lanes),
                 per=1000, reps=5)


def time_cpdia(smoke, torch, emit, rng, dt, dev, repo, smi):
    """H-CPDIA through ``cp_dia_chunk`` per iteration, chunks with sums: at
    Potts-50 (K2's shape; H-CPDIA-R where the checkout plans it, else the
    two-launch kernel), Potts-100, Potts-300 and the multi-label 64 grid
    (K3's; H-CPDIA-G where the checkout plans it, and the two-launch kernel
    forced beside any other tier).  Potts-300's main-path solve twice
    (2,000 float32 iterations, ``light_metrics``): its steady
    iterations/s.  Then Potts-50's solves: ``bench.py::measure_potts``'s
    steady run (200,000 iterations, a checkpoint every 50,000,
    ``light_metrics``) twice, its steady iterations/s and distance to the
    graph cut, and 20,000 iterations of it under the profiler (the busy
    share); the restart solve of ``chip_smoke.py``'s converge_potts50
    (36,000 iterations, restart to average every 4,000) twice, its seconds
    to the graph cut (mean distance < 1e-2), and once under the
    profiler."""
    import numpy as np

    from pysparselp_tpu_torch.examples.potts import (
        build_linear_program, build_multilabel_linear_program)
    from pysparselp_tpu_torch.ops import cp_dia

    grids = (("potts50", lambda: build_linear_program(50, 0.5, 500)[0], 200),
             ("potts100", lambda: build_linear_program(100, 0.5, 500)[0],
              100),
             ("potts300", lambda: build_linear_program(300, 0.5, 500)[0],
              100),
             ("multilabel64",
              lambda: build_multilabel_linear_program(64, 4)[0], 100))
    for key, make, nsteps in grids:
        prob, pre = smoke.lowered(make(), dt, dev)
        x0 = torch.as_tensor(rng.rand(prob.n), dtype=dt, device=dev)
        ye0 = torch.as_tensor(rng.rand(prob.m_eq) * 0.1, dtype=dt,
                              device=dev)
        yi0 = torch.as_tensor(rng.rand(prob.m_ineq) * 0.1, dtype=dt,
                              device=dev)
        tier = (cp_dia.cp_dia_plan(prob, dt).tier
                if hasattr(cp_dia, "cp_dia_plan") else "two_launch")
        planes = str(prob.a_ineq.vals.dtype).split(".")[1]
        plans = [(tier, None)]
        if tier != "two_launch":
            plans.append(("two_launch", cp_dia.TWO_LAUNCH))
        for name, plan in plans:
            emit("H-CPDIA", key, f"chunk of {nsteps}, {name}, {planes} "
                 "planes",
                 lambda prob=prob, pre=pre, x0=x0, ye0=ye0, yi0=yi0,
                 nsteps=nsteps, plan=plan:
                 cp_dia.cp_dia_chunk(prob, pre, x0, ye0, yi0, nsteps, 1.0,
                                     with_sums=True, plan=plan),
                 per=nsteps, reps=20)

    lp300 = build_linear_program(300, 0.5, 500)[0]
    rates = []
    for _ in range(2):
        lp300.solve(method="chambolle_pock_ppd", nb_iter=2000,
                    nb_iter_plot=1000, light_metrics=True, dtype=np.float32,
                    device="cuda")
        rates.append(smoke.steady_rate(lp300))
    print(json.dumps(dict(repo=repo, nvidia_smi=smi, solve="potts300",
                          iters_per_s_steady=rates)), flush=True)

    lp, gt, idx, _ = build_linear_program(50, 0.5, 500)
    steady = dict(method="chambolle_pock_ppd", nb_iter=200_000,
                  nb_iter_plot=50_000, dtype=np.float32, light_metrics=True,
                  device="cuda")
    rates, dists = [], []
    for _ in range(2):
        x, _ = lp.solve(**steady)
        rates.append(smoke.steady_rate(lp))
        dists.append(float(np.mean(np.abs(gt - x[idx]))))
    window = smoke.profile_window(torch, lambda: lp.solve(
        **dict(steady, nb_iter=20_000, nb_iter_plot=5_000)))
    restart = dict(method="chambolle_pock_ppd", nb_iter=36000,
                   nb_iter_plot=12000, restart_period=4000,
                   restart="average", dtype=np.float32, ground_truth=gt,
                   ground_truth_indices=idx, device="cuda")
    to_cut = []
    for _ in range(2):
        lp.solve(**restart)
        below = np.nonzero(np.asarray(lp.distance_to_ground_truth)
                           < 1e-2)[0]
        to_cut.append(float(lp.opttime_curve[below[0]]) if below.size
                      else None)
    restart_window = smoke.profile_window(torch,
                                          lambda: lp.solve(**restart))
    print(json.dumps(dict(repo=repo, nvidia_smi=smi, solve="potts50",
                          iters_per_s_steady=rates, dist=dists,
                          profiled_20k=window,
                          restart_seconds_to_graph_cut=to_cut,
                          restart_profiled=restart_window)), flush=True)


def time_cpdia_shard(smoke, torch, emit, dt):
    """H-CPDIA's shard entry, one call (one iteration) through the
    checkout's ``cp_dia_shard_stepper`` as the mesh solve calls it, on
    Potts-300's aligned system as one shard (the one-rank mesh) and on an
    inner quarter shard (rank 1 of 4), float32: the checkout's entry (one
    cooperative launch writing the packet on the quarter shard where it
    has one; two launches before), and where the checkout keeps it the
    two-launch entry beside it, with ``chip_smoke.shard_bound`` at this
    run's L2 read rates."""
    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.ops import cp_dia
    from pysparselp_tpu_torch.parallel import sharded_cp_windowed as scw

    params = inspect.signature(cp_dia.cp_dia_shard_stepper).parameters
    sys_, info = smoke.shard_system(build_linear_program(300, 0.5, 500)[0])
    glob = scw.position_system(sys_, info)
    l2_rates = smoke.l2_read_rates(torch)
    for shape, ndev, rank in (("whole", 1, 0),
                              ("quarter", smoke.MESH_RANKS, 1)):
        data, st = scw.place_position_shard(glob, ndev, rank, dt, "cuda")
        sh, empty = data["shard"], st["x"].new_zeros(0)
        extra = {}
        if "packet" in params and ndev > 1:
            extra["packet"] = torch.empty(sh.packet_size, dtype=dt,
                                          device="cuda")
        entries = [("checkout", extra)]
        if "two_launch" in params:
            entries.append(("two_launch", dict(two_launch=True)))
        bound = smoke.shard_bound(data, 4, l2_rates)
        for name, kwargs in entries:
            state = {k: v.clone() for k, v in st.items()}
            step = cp_dia.cp_dia_shard_stepper(
                sh, data["pre"], state["x"], state["x3"], empty,
                state["y_ineq"], 1.0, **kwargs)
            emit("H-CPDIA (shard)", f"potts300_{shape}", f"one call, {name}",
                 step, reps=200, positions=sh.length,
                 primal=list(sh.primal), interior=list(sh.interior),
                 packet="packet" in kwargs, l2_read_rate_by_mib=l2_rates,
                 **bound)


def time_two_launch_tier(smoke, torch, rng, dev, repo, smi):
    """The chunk tier of the planes past shared memory, the two-launch
    kernel, per iteration of a chunk of TIER_STEPS with sums, on
    TIER_CASES (Potts-300 in float64, Potts-500 in float32 on its bfloat16
    planes), each with the checkout's planned tier, the call times, the
    streaming bound (each plane and vector once an iteration) and, for the
    LP, the host seconds to build and lower it and the device memory it
    takes."""
    import time

    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.ops import cp_dia

    for key, size, name in TIER_CASES:
        dt = getattr(torch, name)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        lp = build_linear_program(size, 0.5, 500)[0]
        build_s = time.perf_counter() - t0
        prob, pre = smoke.lowered(lp, dt, dev)
        torch.cuda.synchronize()
        lower_s = time.perf_counter() - t0 - build_s
        held = torch.cuda.memory_allocated() - base
        x0 = torch.as_tensor(rng.rand(prob.n), dtype=dt, device=dev)
        ye0 = torch.as_tensor(rng.rand(prob.m_eq) * 0.1, dtype=dt,
                              device=dev)
        yi0 = torch.as_tensor(rng.rand(prob.m_ineq) * 0.1, dtype=dt,
                              device=dev)

        def run():
            return cp_dia.cp_dia_chunk(prob, pre, x0, ye0, yi0, TIER_STEPS,
                                       1.0, True, plan=cp_dia.TWO_LAUNCH)

        planes = sum(o.vals.numel() + o.vals_t.numel()
                     for o in (prob.a_eq, prob.a_ineq) if o is not None)
        item, plane = x0.element_size(), prob.a_ineq.vals.element_size()
        nbytes = plane * planes + item * (9 * prob.n + 6 * (
            prob.m_eq + prob.m_ineq))
        times = smoke.call_times(torch, run, reps=5, host_reps=5)
        rec = dict(repo=repo, nvidia_smi=smi, kernel="H-CPDIA chunk tier",
                   problem=key, dtype=name,
                   planes=str(prob.a_ineq.vals.dtype).split(".")[1],
                   positions=max(prob.n, prob.m_eq, prob.m_ineq),
                   build_s=build_s, lower_s=lower_s, device_bytes=held,
                   planned=cp_dia.cp_dia_plan(prob, dt).tier,
                   bound_stream_us=nbytes / smoke.HBM_BYTES_PER_S * 1e6,
                   bytes_per_iteration=nbytes,
                   two_launch_us={k: v / TIER_STEPS if k.endswith("_us")
                                  else v for k, v in times.items()})
        print(json.dumps(rec), flush=True)
        del prob, pre, x0, ye0, yi0, lp
        torch.cuda.empty_cache()


def time_solves(smoke, np, repo, smi, chambolle_pock, _choose_layout):
    # the per-operator solves: steady iterations/s, twice; and L1-SVM with
    # the chooser's price of H-BSR's longest tile-line at zero
    priced = "bsr_line_price" in inspect.signature(_choose_layout).parameters
    solves = [(k, make, None) for k, make in smoke.WORKLOADS.items()]
    if priced:
        solves.append(("l1svm_no_line_price", smoke.WORKLOADS["l1svm"], 0))
    for key, make, line_price in solves:
        choose = (_choose_layout if line_price is None else
                  functools.partial(_choose_layout,
                                    bsr_line_price=line_price))
        lp = make()
        sys_ = smoke.folded(lp)
        choice, _plan, layouts = choose([sys_["a_eq"], sys_["a_ineq"]])
        rates = []
        with mock.patch.object(chambolle_pock, "_choose_layout", choose):
            for _ in range(2):
                lp.solve(method="chambolle_pock_ppd", nb_iter=SOLVE_ITERS,
                         nb_iter_plot=SOLVE_ITERS // 4, light_metrics=True,
                         dtype=np.float32, device="cuda")
                rates.append(smoke.steady_rate(lp))
        print(json.dumps(dict(repo=repo, nvidia_smi=smi, solve=key,
                              permutation=choice,
                              layouts=[lay[0] for lay in layouts or []],
                              iterations=SOLVE_ITERS,
                              iters_per_s_steady=rates)), flush=True)


def time_dca(smoke, torch, np, repo, smi, build_linear_program, reps=3):
    from pysparselp_tpu_torch.ops import dca_sweep as dca
    from pysparselp_tpu_torch.utils.jax_prng import prng_key

    lp, gt, idx, _ = build_linear_program(300, 0.5, 500)
    one_sided = build_linear_program(300, 0.5, 500)[0]
    one_sided.convert_to_one_sided_inequality_system()
    system = (one_sided.a_inequalities.tocsr(),
              np.asarray(one_sided.b_upper), one_sided.costsvector,
              one_sided.lower_bounds, one_sided.upper_bounds)
    args = smoke.dca_state(torch, system, torch.float32)
    key = prng_key(1)

    def sweep():
        return dca.dca_sweep(*args, key, True)

    events = smoke.profiled_kernels(torch, sweep, reps)
    names = sorted({e.name for e in events
                    if "dca" in e.name and "color" not in e.name})
    per_kernel = {}
    for name in names:
        dur = [e.elapsed_us() for e in events if e.name == name]
        per_kernel[name] = sum(dur) / len(dur) * 1e-3
    events_ms = smoke.cuda_ms(torch, sweep, reps)
    run = dict(method="dual_coordinate_ascent", nb_iter=3, nb_iter_plot=1,
               mode="sequential", dtype=np.float32, device="cuda",
               ground_truth=gt, ground_truth_indices=idx)
    lp.solve(**run)
    t = [0.0] + [float(v) for v in lp.opttime_curve]
    print(json.dumps(dict(
        repo=repo, nvidia_smi=smi, kernel="H-DCA", problem="potts300_ineq",
        rows=system[0].shape[0], device_ms_per_sweep=sum(per_kernel.values()),
        device_ms_per_kernel=per_kernel, events_ms_per_call=events_ms,
        solve_dual_energy=[float(v) for v in lp.dobj_curve],
        solve_s_per_sweep=[b - a for a, b in zip(t, t[1:])])), flush=True)
    time_dca_colour(smoke, torch, np, repo, smi, lp, gt, idx, system, args,
                    key, reps)


def cached_colouring(np):
    """Make the checkout's ``_color_rows`` (~25 s at Potts-300) keep its
    groups in ``build/dca_colours_<sha1>.npz`` of this checkout, by the
    matrix's bytes, so the checkouts timed in turns colour each system
    once."""
    import hashlib

    import scipy.sparse

    from pysparselp_tpu_torch.solvers import dual_ascent

    colour = dual_ascent._color_rows

    def cached(csr):
        csr = scipy.sparse.csr_matrix(csr)
        sha = hashlib.sha1(b"".join(memoryview(v).cast("B") for v in (
            csr.indptr, csr.indices, csr.data))).hexdigest()
        path = ROOT / "build" / f"dca_colours_{sha}.npz"
        if path.is_file():
            with np.load(path) as z:
                return [z[f"g{i}"] for i in range(len(z.files))]
        groups = colour(csr)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **{f"g{i}": g for i, g in enumerate(groups)})
        return groups

    dual_ascent._color_rows = cached
    return cached


def time_dca_colour(smoke, torch, np, repo, smi, lp, gt, idx, system, args,
                    key, reps):
    """H-DCA-C on Potts-300's one-sided rows (float32, the mid-solve state
    of :func:`time_dca`): a colour sweep through the checkout's entry (one
    launch on a ``ColorPlan`` where the checkout has it, else one
    ``dca_color_step`` a group), the profiler's device ms of its kernels
    (names holding ``dca_color``) and their launches, CUDA events and host
    ms per sweep (``chip_smoke.call_times``); then the blocked DCA solve of
    Potts-300 for 3 sweeps: its dual energy after each sweep, printed
    exactly, and its seconds a sweep."""
    from pysparselp_tpu_torch.ops import dca_sweep as dca
    from pysparselp_tpu_torch.utils.jax_prng import split

    groups = cached_colouring(np)(system[0])
    ell = args[0]
    if hasattr(dca, "dca_color_sweep"):
        plan = dca.ColorPlan.build(ell, groups, args[1], args[5], args[6])

        def sweep():
            return dca.dca_color_sweep(ell, plan, *args[1:], key, True)
    else:
        rows = [torch.as_tensor(g, dtype=torch.int32, device="cuda")
                for g in groups]

        def sweep():
            y, c_bar, k = args[3], args[4], key
            for g in rows:
                k, sub = split(k)
                y, c_bar = dca.dca_color_step(ell, args[1], args[2], y,
                                              c_bar, args[5], args[6], g,
                                              sub, True)
            return y, c_bar, k

    events = smoke.profiled_kernels(torch, sweep, reps)
    dev = [e for e in events if "dca_color" in e.name]
    calls = smoke.call_times(torch, sweep, reps=50, host_reps=50)
    run = dict(method="dual_coordinate_ascent", nb_iter=3, nb_iter_plot=1,
               mode="blocked", dtype=np.float32, device="cuda",
               ground_truth=gt, ground_truth_indices=idx)
    lp.solve(**run)
    t = [0.0] + [float(v) for v in lp.opttime_curve]
    print(json.dumps(dict(
        repo=repo, nvidia_smi=smi, kernel="H-DCA-C",
        problem="potts300_ineq", groups=len(groups),
        device_ms_per_sweep=sum(e.elapsed_us() for e in dev) / reps * 1e-3,
        launches_per_sweep=len(dev) / reps,
        kernel_names=sorted({e.name for e in dev}),
        events_ms_per_call=calls["events_us"] * 1e-3,
        host_ms_per_call=calls["host_us"] * 1e-3,
        kernels_per_call=calls["kernels_per_call"],
        solve_dual_energy=[float(v) for v in lp.dobj_curve],
        solve_s_per_sweep=[b - a for a, b in zip(t, t[1:])])), flush=True)


def time_batch(smoke, torch, emit, rng, dev, repo, smi):
    """H-DIA-B and H-CSR-B at the batch main path's operators and batch
    sizes, both orientations, float32 and float64; then the banded and
    unstructured batch solves (float32, ``chip_smoke.BATCH``'s
    iterations, a warm-up solve first) under the profiler: problem-
    iterations/s of the steady window, busy share, launches and device
    microseconds per batch iteration, products against elementwise
    passes (``profile_port.profile_batch``); and three more solves without
    the profiler, their steady problem-iterations/s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    from pysparselp_tpu_torch import solve_cp_batch
    from pysparselp_tpu_torch.ops import csr_spmv, dia_spmv

    spec = importlib.util.spec_from_file_location(
        "profile_port", ROOT / "scripts" / "profile_port.py")
    profile_port = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profile_port)
    lps = {k: smoke.BATCH[k]["make"]()
           for k in ("banded", "assign", "unstructured")}
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[1]
        for kernel, key in (("H-DIA-B", "banded"), ("H-DIA-B", "assign"),
                            ("H-CSR-B", "unstructured")):
            op, _ = smoke.batch_operator(lps[key], dt, dev)
            bsz = smoke.BATCH[key]["bsz"]
            if kernel == "H-DIA-B":
                fn, sides = dia_spmv.dia_spmm, (("A", op.fwd), ("At", op.bwd))
            else:
                fn, sides = csr_spmv.csr_spmm, (("A", op.csr),
                                                ("At", op.csr_t))
            for side, operand in sides:
                n_in = operand.n_in if kernel == "H-CSR-B" else (
                    op.ncols if side == "A" else op.nrows)
                x = torch.as_tensor(rng.randn(n_in, bsz), dtype=dt,
                                    device=dev)
                emit(kernel, f"{key} B={bsz} {name}", side,
                     lambda fn=fn, operand=operand, x=x: fn(operand, x))
    for key in ("banded", "unstructured"):
        cfg = smoke.BATCH[key]
        rec = profile_port.profile_batch(torch, key, lps[key], smi, profile,
                                         ProfilerActivity, DeviceType)
        rec.pop("events")
        rec["problem_iters_per_s"] = (cfg["bsz"]
                                      / rec["steady_wall_us_per_iter"] * 1e6)
        # three more solves without the profiler: their steady rates
        unprofiled = []
        for _ in range(3):
            _x, info = solve_cp_batch(
                lps[key], costs=smoke.batch_costs(lps[key], cfg["bsz"],
                                                  cfg["vary"]),
                nb_iter=cfg["nb_iter"], nb_iter_plot=cfg["nb_iter"] // 4,
                dtype=np.float32, device="cuda")
            itrn, sec = info["itrn"], info["opttime"]
            unprofiled.append(cfg["bsz"] * (itrn[-1] - itrn[0])
                              / (sec[-1] - sec[0]))
        rec["problem_iters_per_s_unprofiled"] = unprofiled
        print(json.dumps(dict(repo=repo, **rec)), flush=True)


if __name__ == "__main__":
    sys.exit(main())
