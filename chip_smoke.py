#!/usr/bin/env python3
"""Drive the PyTorch port (``pysparselp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and the exit code is
nonzero):

1. environment: torch version, the card's name and power limit, the time
   to build the kernels from ``pysparselp_tpu_torch/csrc`` with nvcc;
2. every hand-written kernel against its plain PyTorch twin on the card, at
   the main path's shapes (Potts-300, Potts-50, multi-label Potts 64x64
   K=4, netlib SC105 and a dense system past shared memory; for H-CSR the
   transport,
   unstructured and k-medians systems of ``bench.py``, a row of 100,000
   entries and a system without entries; for H-BSR the RCM-permuted CLIME
   system at p = 150, one tile set at the shipped tile size, both
   directions), float32 and float64, with times, each kernel's
   bound and the time of the one PyTorch call that computes the same
   function, where there is one (for H-BSR also H-CSR's time on the same
   matrix).  The SpMV kernels and H-CPDENSE are timed as the main path
   calls them (the operators' prepared entry points) by CUDA events,
   profiler device time, host time per call and kernels per call
   (:func:`call_times`); H-BSR, whose tile set fits the L2, also with the
   L2 flushed before each call (:func:`cold_times`: its kernel-line time),
   and beside the read rates a reduction reaches from L2 and from HBM
   (:func:`read_rates`);
3. the main path, ``SparseLP.solve(method="chambolle_pock_ppd")`` on the
   Potts-300 segmentation LP in float32 (2,000 iterations), its first
   checkpoint held against the port's own float64 CPU run of 1,000;
4. the four non-grid workloads of ``bench.py`` at its sizes (transport,
   unstructured, k-medians, L1-SVM), float32 on the card: the layout
   presolve's choice (none of them is permuted) and its host time, the
   operators each system lowered to, the host lowering time, a
   200-iteration run held
   against the port's own float64 CPU run, and the steady rate over 2,000
   ``light_metrics`` iterations with its kernel launches;
5. CLIME sparse inverse covariance (``examples/sparse_inv_covariance.py``)
   at p = 150 features, 300 samples, lambda = 0.15 (45,000 variables,
   90,000 folded rows, 6.84M nonzeros), float32 on the card with
   ``permute="auto"``, 2,000 ``light_metrics`` iterations: the layout
   presolve's choice (RCM) and its host time, the operators the permuted
   system lowers to (block-sparse) and the host lowering time, the
   solve's first 100 iterations
   held against the port's own float64 CPU run (unpermuted: CP-PPD with
   diagonal preconditioners is permutation-equivariant), and the steady
   rate with its H-BSR launches, beside the steady rate of the same solve
   with ``permute=False`` (unpermuted, lowered to CSR);
6. convergence: Potts-50 to the graph-cut optimum and SC105 to the perPlex
   optimum with restart-to-average (then SC105 once more under the
   profiler: H-CPDENSE's device time per iteration and the seconds
   between its chunk launches); between them ``main_path_potts50``,
   ``bench.py::measure_potts``'s steady run (200,000 float32 iterations,
   a checkpoint every 50,000): its iterations/s, graph-cut distance and,
   once more under the profiler, the device's busy share.

H-CPDIA-R (``csrc/cp_dia_resident.cu``: K2's chunk in one launch of one
thread-block cluster, ``ops/cp_dia.py::cp_dia_plan`` routing Potts-20 and
Potts-50 to it) adds, in phase 2, :func:`phase_resident`: on Potts-20 and
Potts-50, float32 and float64, with and without sums, at 1, 7 and 200
iterations, against the twin and against the two-launch kernel forced on
the same inputs; times, kernels per chunk (1), the three bounds and the
cost of the cluster barrier alone.

The DIA planes are stored in bfloat16 where every value is exact there
(float32 solves; the JAX package's ``allow_bf16="exact"``): H-DIA,
H-CPDIA, H-CPDIA-R and the shard entry are each held bit for bit against
the same kernel on the same planes in float32 (``bit_equal_f32_planes``).
H-CPDIA-G (``csrc/cp_dia_grid.cu``: K3's chunk in one cooperative launch
of a CTA an SM, each CTA's slab of the planes in shared memory; the plan
routes Potts-100, Potts-300 in float32 and the multi-label 64 grid to it,
Potts-300 in float64 to the two-launch H-CPDIA) adds, in phase 2,
:func:`phase_grid`: on those shapes, with and without sums, at 1, 7 and
100 iterations, bit for bit against the twin and the two-launch kernel;
events, device and host time per iteration beside the two-launch kernel's
in the same call, kernels per chunk (1) and the bounds.  Phase 3 prints
the tier and the plane storage on ``main_path_potts300`` (H-CPDIA-G on
bfloat16 planes) and adds ``main_path_potts300_f64``, the same LP in
float64 on the card (the two-launch H-CPDIA), held against the same CPU
run within F64_MAIN_RTOL; ``main_path_potts50``, ``converge_potts50`` and
``main_path_mesh1`` print theirs.

CSR values and partition tables are stored the same way (the JAX package's
routed ELL and ``PartitionMatrix`` storage): phase 2 runs H-CSR on the
transport equalities and the k-medians block (both exact in bfloat16) on
bfloat16 and on float32 values, bit for bit alike, each held against the
twin and timed (``values`` in each ``kernels`` line); phase 4's
``main_path_{name}`` lines and ``main_path_admm_kmedians`` print each
operator's value storage, and transport's and k-medians' CSR and partition
operators must store bfloat16.

The mesh solve (``lp.solve(mesh=...)``, ``parallel/sharded_cp.py``;
float32 aligned DIA systems in the position-sharded regime,
``parallel/sharded_cp_windowed.py``, everything else row-sharded) adds:

* in phase 2, H-DIA on each of the 4 row shards of the aligned Potts-300
  system (``parallel/sharded_dia.py``: K5's function), forward and
  transpose window, float32 and float64, timed beside cuSPARSE; and
  H-CPDIA's shard entry (:func:`phase_shard_kernels`: K3 per shard, one
  cooperative launch a call) in this process, the halos copied by hand,
  over 4 position shards of the same system, over the whole system as one
  shard and over 4 shards of the multi-label 64 x 64, K = 4 grid's (eq +
  ineq), 100 iterations each bit-equal to the two-launch chunk entry, to
  the two-launch shard entry and to float32 planes and within RTOL of the
  twin, float32 and float64, timed on Potts-300 as one shard and on a
  quarter shard in turns with the two-launch shard entry;
* ``main_path_mesh1``, after phase 3: the Potts-300 solve on one device
  and then with ``mesh=`` a one-rank NCCL group in this process (the
  position-sharded regime: ``bench.py``'s ``measure_sharded_overhead``),
  held against phase 3's float64 run, its shard entry and H-DIA launches
  and its collectives (none an iteration) against the prediction, with
  the launches and collectives an iteration; then
  ``main_path_mesh1_rows``: the float64 solve on the same rank, which both
  packages send to the row-sharded path (H-DIA with shard offsets),
  held against the same run;
* ``main_path_mesh4``: 4 gloo ranks on the one card (``parallel.mesh.
  spawn``), Potts-300 and the multi-label 64 x 64, K = 4 grid (eq +
  ineq) position-sharded, Potts-300 in float64 row-sharded on DIA (H-DIA
  with nonzero shard offsets) and the unstructured LP on per-shard CSR,
  200 iterations each, held against the same solves on one device, halo
  exchanges, halo placements and all-reduces against the prediction (a
  position-sharded iteration: one all-gather, two launches);
  then ``main_path_mesh4_methods``: the other mesh methods (``mehrotra``,
  ``admm``, ``admm2``, DGA, DCA, ``admm_blocks``) at small sizes in
  float64 on the 4 ranks, each held against the same solve on a one-rank
  gloo mesh (MESH4_SMALL);
* phase 8b, after phase 8, ``main_path_mesh_solvers``: the mesh solvers
  beside CP on a one-rank NCCL mesh in this process at the width of their
  one-device runs (DGA and blocked DCA on Potts-300, Mehrotra on
  Potts-300's slack form, ``admm`` / ``admm2`` on the k-medians LP,
  ``admm_blocks`` on L1-SVM, DGA on the banded LP on DIA shards), each
  held against its one-device run, its launches and all-reduces against
  the prediction (:func:`phase_mesh_solvers`).

Batched serving (``solve_cp_batch``, ``batch.py``) adds:

* in phase 2, the batched kernels at the batch path's operators and batch
  sizes (:func:`phase_batch_kernels`): H-DIA-B on the banded system and on
  the DIA block of the assignment system, bit-identical to its twin and
  column by column to H-DIA, with its plan (rows a tile, columns a
  thread, the window, one span or one range per diagonal); H-CSR-B on
  the unstructured system, column by column near H-CSR; both
  orientations, float32 and float64, timed warm and with the L2 flushed
  beside cuSPARSE SpMM (``torch.sparse.mm``), each held against two
  bounds: H-DIA-B its bytes at the HBM rate and at the L2 read rate
  (:func:`read_rates`), H-CSR-B its bytes at the HBM rate and its gathered
  rows at the rate the card serves them from L2 (:func:`gather_rate`);
* ``main_path_batch_{dense,banded,assign,unstructured}``, after phase 4:
  ``bench.py``'s three batch configurations at its sizes (dense 512
  variables B = 64, 20,000 iterations; banded 150,000 rows B = 16;
  k-medians assignment B = 8; 2,000 iterations each) and the unstructured
  LP with B = 8 (:func:`phase_batch`): the backends and the host lowering
  time, 100 float32 iterations held against the port's float64 CPU batch
  run, the steady batch and problem iterations/s of three runs, the
  single-problem rate of the same template and the batching efficiency,
  and the batched kernels' launches against the operators' prediction.

The interior point and ADMM solvers (``mehrotra``, ``admm``, ``admm2``)
add:

* in phase 2, the float64 products of their paths (:func:`phase_f64_kernels`):
  H-CSR on the standard forms of Potts-300 (Mehrotra's slack form) and of
  the k-medians LP (ADMM's), H-DIA on the aligned Potts-300 system and
  H-BSR on the RCM-permuted CLIME system, each A x, Aᵀ y and
  ``sq_rowsum_weighted`` (the squared operand) against the twins, with
  device times, the bytes bound and cuSPARSE ``torch.mv`` in float64;
* phase 7, after phase 6: ``main_path_mehrotra_netlib`` (SC105, AFIRO,
  KB2, SC50A, SC50B in float64 on the dense Cholesky path, against their
  perPlex optima and the port's float64 CPU runs),
  ``main_path_mehrotra_potts300`` (float64 on the CG path: the first IPM
  iteration against the CPU twins, the graph-cut distance against the JAX
  package's CPU figure, CG steps and host reads per IPM iteration, one IPM
  iteration under the profiler) and ``main_path_admm_kmedians`` (the
  reference example's clustering cost; ``bench.py``'s k-medians LP under
  ``admm`` and ``admm2``, held against the float64 CPU run, three timed
  float32 runs, launches and busy share per iteration).

The dual ascent solvers and ``admm_blocks`` add:

* in phase 2, H-DCA against its twin (:func:`phase_dca_kernels`): the
  sequential sweep on SC105's one-sided systems, Potts-20, Potts-50, the
  50 x 50 matching LP and Potts-300's first 2,000 rows (c̄ in global
  memory), the colour steps of Potts-50, float32 and float64, bit for bit
  (y, c̄, the returned key); each sweep's levels and schedule seconds, its
  device time split over the key chain, the draws (with the rows staged in
  level order) and the levels, per row
  and per level, the three-part bound (bytes, levels, chain: DCA_* below),
  the twin's time over 1,000 rows extrapolated per sweep; the full
  Potts-300 sweep against the level-by-level twin, in float32; H-DCA-C,
  the colour sweep in one launch, against its twin on Potts-50 (float32,
  float64), the matching LP (a warp a row) and Potts-300 (float32), the
  one-group entry of the mesh path on Potts-50 (whole groups and halves
  from their ``tie_offset``) and on Potts-300; the colour sweep's device,
  events and host time, its plan's bytes, and its two-part bound
  (``dca_color_bound``);
* phase 8, last: ``main_path_dga_potts`` (Potts-50 float64 on the card
  against the CPU, Potts-300 float32: rate, launches, busy share),
  ``main_path_admm_blocks_l1svm`` (the L1-SVM example's accuracy, rate
  and busy share), ``main_path_dca_potts`` (Potts-20 float64 against the
  CPU, Potts-300 float32 in both modes) and ``main_path_dca_matching``
  (the bipartite example's cost against the CPU run).

The host modules and the observability layer add phase 9, after phase 8:

* ``main_path_checkpoint``: CP on Potts-300 (H-CPDIA-G) and Potts-50
  (H-CPDIA-R), float32, 800 iterations straight, then 400 under a
  ``CheckpointingCallback`` and 400 resumed from the checkpoint, the
  resumed x held to the straight one within MAIN_RTOL;
* ``main_path_profile``: ``utils.profile_trace`` around a 20,000-iteration
  Potts-50 solve, one trace, its H-CPDIA-R events held equal to the
  launch counter and every kernel launch it records held to have its
  kernel record, the top five kernels by device time;
* ``main_path_debug``: Potts-50 with a NaN in its cost, trapped by
  ``utils.debug_mode()`` at a chunk boundary, returning without it with
  the NaN positions of the CPU run (the kernels' projections keep a NaN);
* ``main_path_benchmark_random_lp``: ``benchmarks.benchmark_random_lp``
  at its defaults over every method but the scipy bridges, on the card,
  any ``error`` entry failing the phase;
* ``main_path_potts_run``: ``examples.potts.run(image_size=50,
  max_time=2, nb_iter_plot=500)`` on the card, CP held to the graph cut;
* ``host_gauss_seidel``: the native Gauss-Seidel library loaded, and the
  ADMM host mode on the random LP against HiGHS (no kernel launched);

then ``phase9_s``.  The benchmark driver and ``potts.run`` call
``lp.solve`` once per method: :func:`solve_log` counts each call apart.

The launch counters are set to 0 just before each solve and read just
after it; the kernel table takes H-DIA's and H-CPDIA-G's counts from
the Potts-300 solve, H-CPDIA's from its float64 solve, H-CPDIA-R's from
the Potts-50 restart solve (and ``main_path_potts50``'s under
``launches_by_run``), H-CPDIA (shard)'s from the one-rank float32 mesh
solve, H-DIA (K5)'s from the one-rank float64
mesh solve (and the 4-rank one's under ``launches_by_run``), H-CPDENSE's
from the SC105 solve, H-CSR's from the transport solve, H-BSR's from the
CLIME solve, H-DIA-B's from the banded batch solve and H-CSR-B's from the
unstructured batch solve, H-DCA's from the sequential and H-DCA-C's
from the blocked Potts-300 DCA solve (``launches_run`` names the solve);
the phase 7, 8 and 9 solves that launch a hand kernel add its count
under ``launches_by_run``.  Then the kernel table
as one JSON line and, last, the device line ``{"ok": true, "device":
{...}}``.  Without CUDA, or without the package beside this script, it
exits nonzero and prints no result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent
# tolerance of a kernel against its twin, per output:
# max|kernel - twin| <= RTOL * max(1, max|twin|); H-CSR per row:
# |kernel - twin| <= RTOL * (|A| |x|)_row (the twin adds in another order)
RTOL = {"float32": 1e-5, "float64": 1e-12}
# the Potts-300 f32 CUDA solve against the f64 CPU solve, at every
# checkpoint: objectives within MAIN_RTOL relative, violations within
# MAIN_RTOL * max(1, |f64 value|)
MAIN_RTOL = 1e-5
# the Potts-300 f64 CUDA solve against the f64 CPU solve at its checkpoint
# (the same iterations elementwise; the metrics summed in another order)
F64_MAIN_RTOL = 1e-9
# the same check for the non-grid workloads, whose random-sign data rounds
# worse: measured at most 1.1e-6 (the transport equality violation; NVIDIA
# H100 80GB HBM3, 700 W), the limit about ten times that
NONGRID_RTOL = 1e-5
# the card's published peaks (NVIDIA H100 SXM, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
H100_SMS = 132
# each hand-written kernel: its source, the TPU kernels it replaces (K1-K8
# of PERF.md's table, every one of them ported) and the main-path solve
# whose launches the summary line reports.  "H-DIA (K5)" is H-DIA on the
# row shards of the mesh solver, held and timed at the shard shapes.
KERNELS = {
    "H-DIA": dict(source="pysparselp_tpu_torch/csrc/dia_spmv.cu",
                  replaces="pysparselp_tpu/ops/dia_pallas.py:168",
                  tpu_kernels={"K4": "ported"},
                  launches_run="main_path_potts300"),
    "H-DIA (K5)": dict(source="pysparselp_tpu_torch/csrc/dia_spmv.cu",
                       replaces="pysparselp_tpu/ops/dia_pallas.py:232",
                       tpu_kernels={"K5": "ported"},
                       launches_run="main_path_mesh1_rows"),
    # K3's two tiers: H-CPDIA-G (one cooperative launch a chunk) where a
    # slab of the planes fits shared memory, Potts-300 f32 on bf16 planes
    # among them; the two-launch H-CPDIA elsewhere, Potts-300 f64 (its
    # launches from the float64 solve of the main path)
    "H-CPDIA-G": dict(source="pysparselp_tpu_torch/csrc/cp_dia_grid.cu",
                      replaces="pysparselp_tpu/ops/cp_windowed.py:392",
                      tpu_kernels={"K3": "ported"},
                      launches_run="main_path_potts300"),
    "H-CPDIA": dict(source="pysparselp_tpu_torch/csrc/cp_dia.cu",
                    replaces="pysparselp_tpu/ops/cp_windowed.py:392",
                    tpu_kernels={"K3": "ported"},
                    launches_run="main_path_potts300_f64"),
    # H-CPDIA's shard entry: K3 as the position-sharded mesh solve runs it
    # per shard (pysparselp_tpu/parallel/sharded_cp_windowed.py:493, :811),
    # H-CPDIA-G's iteration body in one cooperative launch a call (the
    # two-launch shard entry of csrc/cp_dia.cu is its reference)
    "H-CPDIA (shard)": dict(source="pysparselp_tpu_torch/csrc/cp_dia_grid.cu",
                            replaces="pysparselp_tpu/ops/cp_windowed.py:392",
                            tpu_kernels={"K3": "ported"},
                            launches_run="main_path_mesh1"),
    "H-CPDIA-R": dict(source="pysparselp_tpu_torch/csrc/cp_dia_resident.cu",
                      replaces="pysparselp_tpu/ops/cp_fused.py:192",
                      tpu_kernels={"K2": "ported"},
                      launches_run="converge_potts50"),
    "H-CPDENSE": dict(source="pysparselp_tpu_torch/csrc/cp_dense.cu",
                      replaces="pysparselp_tpu/ops/cp_fused.py:381",
                      tpu_kernels={"K1": "ported"},
                      launches_run="converge_sc105"),
    "H-CSR": dict(source="pysparselp_tpu_torch/csrc/csr_spmv.cu",
                  replaces="pysparselp_tpu/ops/ell_routed.py:1040; "
                           "pysparselp_tpu/ops/ell_routed.py:1132",
                  tpu_kernels={"K7": "ported", "K8": "ported"},
                  launches_run="main_path_transport"),
    "H-BSR": dict(source="pysparselp_tpu_torch/csrc/bsr_spmv.cu",
                  replaces="pysparselp_tpu/ops/bsr_pallas.py:168",
                  tpu_kernels={"K6": "ported"},
                  launches_run="main_path_clime"),
    # the batched entries behind solve_cp_batch: no pallas_call stands
    # behind the vmapped XLA products they replace
    "H-DIA-B": dict(source="pysparselp_tpu_torch/csrc/dia_spmv.cu",
                    replaces="pysparselp_tpu/batch.py:57",
                    tpu_kernels={},
                    launches_run="main_path_batch_banded"),
    "H-CSR-B": dict(source="pysparselp_tpu_torch/csrc/csr_spmv.cu",
                    replaces="pysparselp_tpu/batch.py:147",
                    tpu_kernels={},
                    launches_run="main_path_batch_unstructured"),
    # the dual coordinate ascent sweeps: no pallas_call stands behind the
    # compiled fori_loop sweeps (H-DCA) and colour steps (H-DCA-C) they
    # replace
    "H-DCA": dict(source="pysparselp_tpu_torch/csrc/dca_sweep.cu",
                  replaces="pysparselp_tpu/solvers/dual_ascent.py:323; "
                           "pysparselp_tpu/solvers/dual_ascent.py:342; "
                           "pysparselp_tpu/solvers/dual_ascent.py:285",
                  tpu_kernels={},
                  launches_run="main_path_dca_potts"),
    "H-DCA-C": dict(source="pysparselp_tpu_torch/csrc/dca_sweep.cu",
                    replaces="pysparselp_tpu/solvers/dual_ascent.py:285",
                    tpu_kernels={},
                    launches_run="main_path_dca_potts"),
}
# the kernel table's row of a launch counter that is not a row of its own:
# H-DCA-C's one-group entry (the mesh path's) under H-DCA-C
TABLE_ROW = {"H-DCA-C (group)": "H-DCA-C"}
# the mesh phases: ranks of main_path_mesh4 (gloo, all on the one card)
# and the row-shard count of the K5 kernel phase
MESH_RANKS = 4
# the one-device runs of phases 7 and 8 that main_path_mesh_solvers repeats
# on a one-rank mesh (filled by those phases: the LP, the run's arguments
# and what it gave)
ONE_DEVICE = {}
# the CLIME configuration: p features, samples drawn from N(0, P^-1) with P
# a seeded sparse SPD precision, the l-infinity radius lambda
CLIME = dict(n_features=150, n_samples=300, lamb=0.15, seed=0)


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


class KernelRecord:
    """One kernel of a trace: its name and its start and end on the device
    (µs)."""

    def __init__(self, event):
        self.name = event["name"]
        self.start = float(event["ts"])
        self.end = self.start + float(event.get("dur", 0.0))

    def elapsed_us(self):
        return self.end - self.start


_TRACES = [0]


def traced(torch, fn):
    """``fn()`` once under ``utils.profile_trace`` (its warm-up CUDA graph
    replayed first, which absorbs the profiler's loss of a trace's first
    records, and cut from the trace afterwards): ``(wall seconds, the
    kernel records in start order)``.  Raises when a kernel launch of the
    trace lacks its kernel record: a lossy capture fails, it is not taken
    again."""
    import shutil

    from pysparselp_tpu_torch.utils import profile_trace

    _TRACES[0] += 1
    log_dir = SCRATCH / f"trace_{_TRACES[0]}"
    shutil.rmtree(log_dir, ignore_errors=True)
    torch.cuda.synchronize()
    with profile_trace(str(log_dir)) as d:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = json.loads((Path(d) / "trace.json").read_text())["traceEvents"]
    shutil.rmtree(log_dir, ignore_errors=True)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    correlated = {e.get("args", {}).get("correlation") for e in kernels}
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "Launch" in e.get("name", "")]
    orphans = [e for e in launches
               if e.get("args", {}).get("correlation") not in correlated]
    if orphans:
        raise AssertionError(
            f"trace {_TRACES[0]}: {len(orphans)} of {len(launches)} kernel "
            "launches lack their kernel record (a lossy capture)")
    return wall, sorted((KernelRecord(e) for e in kernels),
                        key=lambda k: k.start)


def profiled_kernels(torch, fn, reps):
    """The kernel records of ``reps`` calls of ``fn()`` (:func:`traced`),
    in start order."""
    def run():
        for _ in range(reps):
            fn()

    dev = traced(torch, run)[1]
    if not dev:
        raise AssertionError(f"the trace of {reps} calls holds no kernel")
    return dev


def call_times(torch, fn, reps=200, host_reps=1000):
    """Per call of ``fn()``, in microseconds: ``events_us`` (CUDA events
    over ``reps`` back-to-back calls, as :func:`cuda_ms`), ``device_us``
    (the profiler's device time of the calls' kernels over ``reps`` calls)
    with ``kernels_per_call`` and their ``kernel_names``, and ``host_us``
    (``time.perf_counter`` over ``host_reps`` calls, one synchronize after
    the loop and outside the time)."""
    events_us = cuda_ms(torch, fn, reps) * 1e3
    t0 = time.perf_counter()
    for _ in range(host_reps):
        fn()
    host_us = (time.perf_counter() - t0) / host_reps * 1e6
    torch.cuda.synchronize()
    dev = profiled_kernels(torch, fn, reps)
    per_call = max(round(len(dev) / reps), 1)
    device_us = (sum(e.elapsed_us() for e in dev) / len(dev)
                 * per_call)
    return dict(events_us=events_us, host_us=host_us, device_us=device_us,
                kernels_per_call=len(dev) / reps,
                kernel_names=sorted({e.name for e in dev}))


def chunk_profile(torch, lp, kernel, run):
    """One more ``lp.solve(**run)`` under :func:`traced`: the device
    time of the chunk kernel (name containing ``kernel``) per iteration,
    its launches, the wall time, and the seconds between one chunk launch's
    end and the next one's start on the device (the restart controller's
    host and device work between chunks), in total and per gap."""
    wall, dev = traced(torch, lambda: lp.solve(**run))
    spans = [(e.start, e.end) for e in dev if kernel in e.name]
    device_s = sum(end - start for start, end in spans) * 1e-6
    gaps = [b[0] - a[1] for a, b in zip(spans, spans[1:])]
    iters = lp.itrn_curve[-1]
    return dict(wall_s=wall, chunk_launches=len(spans),
                chunk_device_s=device_s,
                device_us_per_iteration=device_s / iters * 1e6,
                between_chunks_s=sum(gaps) * 1e-6,
                between_chunks_us=gaps)


def bound(nbytes, ops):
    """``(bound_ms, bound_by)``: the larger of the bytes over the HBM rate
    and the operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def same_bits(torch, got, want):
    """Every paired output equal bit for bit: NaN at the same positions,
    every other entry with the same bits (signed zeros included)."""
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return False
        gn, wn = torch.isnan(g), torch.isnan(w)
        ints = torch.int32 if g.dtype == torch.float32 else torch.int64
        if not (torch.equal(gn, wn) and torch.equal(
                g[~gn].contiguous().view(ints),
                w[~wn].contiguous().view(ints))):
            return False
    return True


def f32_planes(op):
    """A DiaMatrix with its planes stored in float32 (the same values,
    widened): the bfloat16 operator's reference."""
    from pysparselp_tpu_torch.problem import DiaMatrix

    if op is None:
        return None
    return DiaMatrix.from_planes(op.vals.float(), op.offsets,
                                 op.vals_t.float(), op.offsets_t, op.nrows,
                                 op.ncols, op.dtype, op.vals.device)


def planes_of(prob):
    """The storage dtype of a DIA problem's planes, as a name."""
    return str(prob.a_ineq.vals.dtype).split(".")[1]


def dia_tier(lp, dtype):
    """What a CP solve of ``lp`` in ``dtype`` runs on the card: its
    H-CPDIA tier (``cp_dia_plan``) and the storage of its planes."""
    from pysparselp_tpu_torch.ops import cp_dia

    prob, _ = lowered(lp, dtype, "cuda")
    return dict(tier=cp_dia.cp_dia_plan(prob, dtype).tier,
                planes=planes_of(prob))


def folded(lp):
    """The host system the solver lowers ``lp`` to: fixed variables
    removed, inequalities folded one-sided."""
    from pysparselp_tpu_torch.solvers.chambolle_pock import _fold_one_sided

    lp = copy.deepcopy(lp)
    lp.remove_fixed_variables()
    a_eq = lp.a_equalities.tocsr() if lp.a_equalities.shape[0] else None
    a_in = lp.a_inequalities.tocsr() if lp.a_inequalities.shape[0] else None
    a_one, b_one = _fold_one_sided(a_in, lp.b_lower if a_in is not None else None,
                                   lp.b_upper if a_in is not None else None)
    return dict(a_eq=a_eq, beq=lp.b_equalities if a_eq is not None else None,
                a_ineq=a_one, b_ineq=b_one, c=lp.costsvector,
                lb=lp.lower_bounds, ub=lp.upper_bounds)


def lowered(lp, dtype, device):
    """The problem and preconditioners the solver lowers ``lp`` to on
    ``device`` (fixed variables removed, inequalities folded, the automatic
    layout presolve applied)."""
    from pysparselp_tpu_torch.problem import apply_align_embedding
    from pysparselp_tpu_torch.solvers.chambolle_pock import _auto_layout

    sys_ = folded(lp)
    plan = _auto_layout([sys_["a_eq"], sys_["a_ineq"]])
    if plan is not None:
        sys_ = apply_align_embedding(plan, sys_)[0]
    return lowered_system(sys_, dtype, device)


def lowered_system(sys_, dtype, device):
    """:func:`lowered` for a host system (:func:`folded`'s keys)."""
    import numpy as np
    import torch

    from pysparselp_tpu_torch.problem import LPProblem, lower_systems
    from pysparselp_tpu_torch.solvers.chambolle_pock import (
        host_preconditioners)

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)

    ops = lower_systems([sys_["a_eq"], sys_["a_ineq"]], dtype, device)
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


def dense_system(me=150, mi=100, n=300, seed=11):
    """A random dense LP host system (:func:`folded`'s keys) of ``me``
    equality and ``mi`` inequality rows over ``n`` columns in ``[0, 1]``,
    feasible at a random point: 2 x 250 x 300 entries, past one block's
    shared memory for H-CPDENSE's operators, within its 4 MB budget."""
    import numpy as np
    import scipy.sparse

    rng = np.random.RandomState(seed)
    a_eq = scipy.sparse.csr_matrix(rng.randn(me, n) * (rng.rand(me, n) < 0.3))
    a_in = scipy.sparse.csr_matrix(rng.randn(mi, n) * (rng.rand(mi, n) < 0.3))
    xf = rng.rand(n)
    return dict(a_eq=a_eq, beq=a_eq @ xf, a_ineq=a_in,
                b_ineq=a_in @ xf + 0.5, c=rng.randn(n), lb=np.zeros(n),
                ub=np.ones(n))


def describe(op):
    """The backend an operator lowered to, with its shape; a column-block
    composite lists its blocks."""
    if op is None:
        return None
    from pysparselp_tpu_torch.problem import ColBlockMatrix

    if isinstance(op, ColBlockMatrix):
        return {"ColBlockMatrix": list(op.col_starts),
                "blocks": [describe(b) for b in op.blocks]}
    return f"{type(op).__name__}{list(op.shape)}"


def sc105_lp():
    return netlib_lp("SC105")


def netlib_lp(name):
    """A vendored netlib problem as ``tests/test_netlib.py`` builds SC105
    (upper bounds clipped at twice the largest optimal value, inequalities
    one-sided) and its perPlex optimum."""
    import numpy as np

    from pysparselp_tpu_torch import SparseLP
    from pysparselp_tpu_torch.io.netlib import get_problem

    d = get_problem(name)
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


# ----------------------------------------------------------------------
# bench.py's four non-grid workloads, built on the port's SparseLP
# ----------------------------------------------------------------------


def transport_lp(n_sources=50_000, n_sinks=50_000, n_arcs=1_000_000,
                 seed=11):
    """Copy of ``bench.py::_transport_lp`` (bench.py:559-599): uniformly
    random arcs, flow conservation at every source and sink as an equality
    row (column degree exactly 2), plus one never-binding inequality
    row."""
    import numpy as np
    import scipy.sparse

    from pysparselp_tpu_torch import SparseLP

    rng = np.random.RandomState(seed)
    src = rng.randint(0, n_sources, n_arcs)
    dst = rng.randint(0, n_sinks, n_arcs)
    rows = np.concatenate([src, n_sources + dst])
    cols = np.concatenate([np.arange(n_arcs), np.arange(n_arcs)])
    a = scipy.sparse.csr_matrix(
        (np.ones(2 * n_arcs), (rows, cols)),
        shape=(n_sources + n_sinks, n_arcs))
    x0 = rng.rand(n_arcs)
    b = np.asarray(a @ x0)
    c = rng.rand(n_arcs)
    lp = SparseLP()
    lp.add_variables_array(n_arcs, lower_bounds=0, upper_bounds=2,
                           costs=c)
    lp.add_equality_constraints_sparse(a, b)
    lp.add_inequality_constraints(
        np.array([[0, 1]]), np.array([[1.0, 1.0]]), lower_bounds=None,
        upper_bounds=np.array([4.0]))
    return lp


def unstructured_lp(m=150_000, n=100_000, avg=13, seed=5):
    """Copy of ``bench.py::_unstructured_matrix`` (bench.py:414-432) and
    the LP ``measure_unstructured`` builds on it (bench.py:457-461):
    uniform random sparsity, ``Ax <= b`` from a feasible interior point,
    ``0 <= x <= 1``."""
    import numpy as np
    import scipy.sparse

    from pysparselp_tpu_torch import SparseLP

    rng = np.random.RandomState(seed)
    nnz = m * avg
    rows = rng.randint(0, m, nnz)
    cols = rng.randint(0, n, nnz)
    vals = rng.randn(nnz)
    a = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(m, n))
    a.sum_duplicates()
    x0 = rng.rand(n)
    b = np.asarray(a @ x0) + 1.0
    c = rng.rand(n)
    lp = SparseLP()
    lp.add_variables_array(n, lower_bounds=0, upper_bounds=1, costs=c)
    lp.add_inequality_constraints_sparse(a, None, b)
    return lp


def kmedians_lp(n_points=5_000, n_candidates=30, seed=3):
    """Copy of ``bench.py::_kmedians_lp`` (bench.py:484-512): the
    k-medians facility-location relaxation (per-point simplex rows,
    2-entry linking rows, hot ``used[c]`` columns)."""
    import numpy as np

    from pysparselp_tpu_torch import SparseLP

    rng = np.random.RandomState(seed)
    points = rng.randn(n_points, 2)
    centers = points[rng.choice(n_points, n_candidates), :]
    dist = np.sqrt(((points[:, None, :] - centers[None, :, :]) ** 2
                    ).sum(axis=2))
    lp = SparseLP()
    labeling = lp.add_variables_array(dist.shape, 0, 1, dist)
    used = lp.add_variables_array(n_candidates, 0, 1, 0)
    lp.add_inequality_constraints(
        used[None, :], np.ones((1, n_candidates)), lower_bounds=0,
        upper_bounds=5)
    lp.add_inequality_constraints(
        labeling, np.ones((n_points, n_candidates)), lower_bounds=1,
        upper_bounds=1)
    id_cols = np.ones((n_points, 1)).dot(used[None, :])
    cols = np.column_stack((labeling.reshape(-1, 1),
                            id_cols.reshape(-1, 1))).astype(int)
    vals = np.column_stack((np.ones(labeling.size), -np.ones(labeling.size)))
    lp.add_inequality_constraints(cols, vals, lower_bounds=None,
                                  upper_bounds=0)
    return lp


def l1svm_lp(nb_examples=30_000, nf=30, nb_classes=3):
    """The L1-SVM of ``bench.py::measure_l1svm`` (its data, bench.py:
    377-385) on the port's ``examples/l1_svm.py``: a dense weight head
    beside diagonal epsilon/aux tails."""
    import numpy as np

    from pysparselp_tpu_torch.examples.l1_svm import L1SVM

    rng = np.random.RandomState(1)
    x = rng.rand(nb_examples, nf)
    w = rng.randn(nb_classes, nf)
    w = w / np.sum(w**2, axis=1)[:, None]
    wh = np.hstack((w, -0.5 * np.sum(w, axis=1)[:, None]))
    xh = np.hstack((x, np.ones((nb_examples, 1))))
    classes = np.argmax((wh @ xh.T).T, axis=1)
    svm = L1SVM()
    svm.set_data(x, classes, nb_classes)
    return svm


WORKLOADS = {"transport": transport_lp, "unstructured": unstructured_lp,
             "kmedians": kmedians_lp, "l1svm": l1svm_lp}


def batch_dense_lp():
    """The template of ``bench.py::measure_batch_serving`` (bench.py:665-
    667): 512 variables, 64 equality and 384 inequality rows."""
    from pysparselp_tpu_torch.utils.random_lp import generate_random_lp

    return generate_random_lp(nbvar=512, n_eq=64, n_ineq=384, sparsity=0.02,
                              seed=17)[0]


def banded_lp(n=150_000, offsets=(0, 1, 2, 64), seed=7):
    """Copy of ``bench.py::_banded_lp`` (bench.py:702-722): ``n`` variables
    and ``n`` inequality rows on ``len(offsets)`` diagonals, feasible at an
    interior point."""
    import numpy as np
    import scipy.sparse

    from pysparselp_tpu_torch import SparseLP

    rng = np.random.RandomState(seed)
    diags = [rng.rand(n - abs(o)) + 0.5 for o in offsets]
    a = scipy.sparse.diags(diags, offsets, shape=(n, n)).tocsr()
    x0 = rng.rand(n)
    b = np.asarray(a @ x0) + 0.5
    lp = SparseLP()
    lp.add_variables_array(n, lower_bounds=0, upper_bounds=1,
                           costs=rng.rand(n) - 0.3)
    lp.add_inequality_constraints_sparse(a, None, b)
    return lp


# batched serving (solve_cp_batch): bench.py's three configurations
# (measure_batch_serving, _dia, _assign: bench.py:656-803) at its sizes and
# the unstructured LP, each with B cost variants of its template ("add":
# c + 0.1 randn, "scale": c (1 + 0.1 rand), numpy seed 0) and its steady
# run's iterations
BATCH = {
    "dense": dict(make=batch_dense_lp, bsz=64, nb_iter=20_000, vary="add"),
    "banded": dict(make=banded_lp, bsz=16, nb_iter=2_000, vary="add"),
    "assign": dict(make=kmedians_lp, bsz=8, nb_iter=2_000, vary="scale"),
    "unstructured": dict(make=unstructured_lp, bsz=8, nb_iter=2_000,
                         vary="add"),
}
# the batch solves held against the port's float64 CPU batch run: these
# iterations, a checkpoint every BATCH_CHECK_PLOT
BATCH_CHECK_ITERS, BATCH_CHECK_PLOT = 100, 50


def batch_costs(lp, bsz, vary):
    import numpy as np

    rng = np.random.RandomState(0)
    c = lp.costsvector[None, :]
    if vary == "scale":
        return c * (1.0 + 0.1 * rng.rand(bsz, lp.nb_variables))
    return c + 0.1 * rng.randn(bsz, lp.nb_variables)


def batch_systems(lp):
    """``(a_eq, a_one)``: the host systems ``solve_cp_batch`` lowers (the
    inequalities folded one-sided; no fixed variable removed)."""
    from pysparselp_tpu_torch.solvers import _csr
    from pysparselp_tpu_torch.solvers.chambolle_pock import _fold_one_sided

    a_one, _ = _fold_one_sided(_csr(lp.a_inequalities), lp.b_lower,
                               lp.b_upper)
    if a_one is not None and a_one.shape[0] == 0:
        a_one = None
    return _csr(lp.a_equalities), a_one


def clime_lp(n_features=150, n_samples=300, lamb=0.15, seed=0):
    """The CLIME LP of ``examples/sparse_inv_covariance.py`` on seeded
    samples, one-sided."""
    from pysparselp_tpu_torch.examples import sparse_inv_covariance as ex

    x = ex.make_data(n_samples=n_samples, n_features=n_features,
                     seed=seed)[0]
    return ex.clime_lp(x, lamb)[0]


def timings(torch, kern, plain, reps, per=1):
    """Kernel and twin in turns (plain, kernel, kernel, plain); ms per
    ``per`` iterations."""
    t = [cuda_ms(torch, f, reps) for f in (plain, kern, kern, plain)]
    return dict(ms=(t[1] + t[2]) / 2 / per, plain_ms=(t[0] + t[3]) / 2 / per)


def chunk_ops(prob, macs):
    """Operations of one CP iteration with running sums: the products'
    ``macs`` multiply-adds, two operations each (a DIA operator's stored
    plane entries, A's and Aᵀ's, each in one; a dense system's entries
    each in two, A x3 and Aᵀ y), and the updates as the kernels compute
    them: per variable one add per system into d, T d and its subtraction,
    the clip's min and max, x3's two products and a subtraction, the sum's
    add; per inequality row the residual's subtraction, its product with
    sigma, the add to y, the max with 0 and the sum's add; per equality
    row the same without the max."""
    systems = (prob.a_eq is not None) + (prob.a_ineq is not None)
    return (2 * macs + (8 + systems) * prob.n + 5 * prob.m_ineq
            + 4 * prob.m_eq)


def chunk_bound(prob, planes, macs, plane_bytes=4):
    """Bound of one CP iteration with running sums (f32): the operator's
    ``planes`` entries of ``plane_bytes`` each (2 on bfloat16 planes), and
    per iteration c, diag_t, lb, ub, x read and x, x3 written, the x sum
    read and written; b, sigma, y read, y written and the y sum read and
    written per system; the operations of :func:`chunk_ops` for ``macs``
    multiply-adds."""
    rows = prob.m_eq + prob.m_ineq
    return bound(plane_bytes * planes + 4 * (9 * prob.n + 6 * rows),
                 chunk_ops(prob, macs))


def resident_smem_traffic(prob, itemsize):
    """Shared-memory bytes one H-CPDIA-R iteration with sums reads and
    writes: per column c, T, l, u, x and the x sum read, x, x3 and the sum
    written, and each tap of Aᵀ a plane entry and a y entry read; per row
    of each system b, sigma, y and its sum read, y and the sum written, and
    each tap of A a plane entry and an x3 entry read."""
    words = 0
    for op, rows in ((prob.a_ineq, prob.m_ineq), (prob.a_eq, prob.m_eq)):
        if op is not None:
            words += 2 * len(op.offsets_t) * prob.n
            words += (6 + 2 * len(op.offsets)) * rows
    return itemsize * (words + 9 * prob.n)


def sparse_tensor(torch, a, dtype, device):
    """``a`` (scipy) as a ``torch.sparse_csr_tensor`` for the library
    call."""
    import numpy as np

    return torch.sparse_csr_tensor(
        torch.as_tensor(a.indptr.astype(np.int64), device=device),
        torch.as_tensor(a.indices.astype(np.int64), device=device),
        torch.as_tensor(a.data, dtype=dtype, device=device), size=a.shape,
        check_invariants=False)


def dia_scipy(op):
    """The matrix of a DiaMatrix's planes, as scipy CSR."""
    import numpy as np
    import scipy.sparse

    vals = op.vals.double().cpu().numpy()
    r = np.arange(op.nrows)
    rows, cols, data = [], [], []
    for d, off in enumerate(op.offsets):
        keep = (r + off >= 0) & (r + off < op.ncols) & (vals[d] != 0)
        rows.append(r[keep])
        cols.append(r[keep] + off)
        data.append(vals[d][keep])
    return scipy.sparse.csr_matrix(
        (np.concatenate(data), (np.concatenate(rows), np.concatenate(cols))),
        shape=op.shape)


def phase_kernels(torch, problems, table):
    """Phase 2 for the DIA and dense kernels: each against its twin on the
    card."""
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
                   ndiag=op.ndiag, planes=planes_of(prob), max_abs_err=err)
        if dt == torch.float32:
            # the bfloat16 planes against the same planes in float32
            wide = f32_planes(op)
            rec["bit_equal_f32_planes"] = same_bits(
                torch, [op.matvec(x), op.rmatvec(y)],
                [wide.matvec(x), wide.rmatvec(y)])
            if op.vals.dtype != torch.bfloat16 or not rec[
                    "bit_equal_f32_planes"]:
                emit("kernels", **rec)
                raise AssertionError("H-DIA potts300: not bit-equal on "
                                     "bfloat16 and float32 planes")
            # the main path's call: the operator's prepared forward operand
            rec.update(timings(
                torch, lambda: op.matvec(x),
                lambda: dia_spmv.dia_spmv_reference(op.vals, op.offs, x,
                                                    op.nrows), 200))
            lib = sparse_tensor(torch, dia_scipy(op), dt, dev)
            rec["library_ms"] = cuda_ms(torch, lambda: torch.mv(lib, x), 200)
            rec["kernel_us"] = call_times(torch, lambda: op.matvec(x))
            rec["library_us"] = call_times(torch, lambda: torch.mv(lib, x))
            nbytes = (op.vals.element_size() * op.vals.numel()
                      + 4 * (op.ndiag + op.ncols + op.nrows))
            rec["bound_ms"], rec["bound_by"] = bound(nbytes,
                                                     2 * op.vals.numel())
            table["H-DIA"].update({k: rec[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        table["H-DIA"]["max_abs_err"] = max(table["H-DIA"]["max_abs_err"], err)
        emit("kernels", **rec)

        # H-CPDIA, the two-launch kernel forced: Potts-300 (ineq-only;
        # K3's shape) and multi-label Potts (eq+ineq), on the planes as
        # lowered (bfloat16 in float32); phase_grid runs their planned
        # tier, H-CPDIA-G (Potts-300 f64 plans this kernel)
        for key, nsteps in (("potts300", 100), ("multilabel64", 100)):
            prob, pre = lowered(problems[key], dt, dev)
            if not cp_dia.cp_dia_eligible(prob):
                raise AssertionError(f"{key} did not lower to DIA operators")
            tier = cp_dia.cp_dia_plan(prob, dt).tier
            x0 = torch.as_tensor(rng.rand(prob.n), dtype=dt, device=dev)
            ye0 = torch.as_tensor(rng.rand(prob.m_eq) * 0.1, dtype=dt,
                                  device=dev)
            yi0 = torch.as_tensor(rng.rand(prob.m_ineq) * 0.1, dtype=dt,
                                  device=dev)

            def kern(nsteps=nsteps, prob=prob, pre=pre):
                return cp_dia.cp_dia_chunk(prob, pre, x0, ye0, yi0, nsteps,
                                           1.0, with_sums=True,
                                           plan=cp_dia.TWO_LAUNCH)

            def plain(nsteps=nsteps, prob=prob, pre=pre):
                return cp_dia.cp_dia_chunk_reference(prob, pre, x0, ye0, yi0,
                                                     nsteps, 1.0,
                                                     with_sums=True)

            got = kern()
            err = compare(torch, got, plain(), name, f"H-CPDIA {key}")
            rec = dict(kernel="H-CPDIA", problem=key, dtype=name,
                       n=prob.n, m_eq=prob.m_eq, m_ineq=prob.m_ineq,
                       nsteps=nsteps, planned_tier=tier,
                       planes=planes_of(prob), max_abs_err=err)
            if dt == torch.float32:
                wide = dataclasses.replace(
                    prob, a_eq=f32_planes(prob.a_eq),
                    a_ineq=f32_planes(prob.a_ineq))
                rec["bit_equal_f32_planes"] = same_bits(
                    torch, got, cp_dia.cp_dia_chunk(
                        wide, pre, x0, ye0, yi0, nsteps, 1.0,
                        with_sums=True, plan=cp_dia.TWO_LAUNCH))
                if not rec["bit_equal_f32_planes"]:
                    emit("kernels", **rec)
                    raise AssertionError(f"H-CPDIA {key}: not bit-equal on "
                                         "bfloat16 and float32 planes")
                rec.update(timings(torch, kern, plain, 3, per=nsteps))
                rec["kernel_us"] = call_times(torch, kern, reps=3,
                                              host_reps=3)
                planes = sum(o.vals.numel() + o.vals_t.numel()
                             for o in (prob.a_eq, prob.a_ineq)
                             if o is not None)
                item = prob.a_ineq.vals.element_size()
                rec["bound_ms"], rec["bound_by"] = chunk_bound(
                    prob, planes, planes, item)
                rec["bound_f32_planes_ms"] = chunk_bound(prob, planes,
                                                         planes)[0]
                if key == "potts300":
                    table["H-CPDIA"].update({k: rec[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by")})
                    table["H-CPDIA"]["bound_f32_planes_ms"] = rec[
                        "bound_f32_planes_ms"]
            table["H-CPDIA"]["max_abs_err"] = max(
                table["H-CPDIA"]["max_abs_err"], err)
            emit("kernels", **rec)

        # H-CPDENSE: SC105 (its chunk in shared memory) and a system whose
        # operators exceed shared memory (the L2 tier), 1000 iterations
        # with sums
        for key in ("sc105", "dense_past_shared"):
            if key == "sc105":
                prob, pre = lowered(problems[key], dt, dev)
            else:
                prob, pre = lowered_system(dense_system(), dt, dev)
            if not cp_dense.cp_dense_eligible(prob):
                raise AssertionError(f"{key} did not lower to dense operators")
            x0 = torch.zeros(prob.n, dtype=dt, device=dev)
            ye0 = torch.zeros(prob.m_eq, dtype=dt, device=dev)
            yi0 = torch.zeros(prob.m_ineq, dtype=dt, device=dev)

            def kern_d(prob=prob, pre=pre):
                return cp_dense.cp_dense_chunk(prob, pre, x0, ye0, yi0, 1000,
                                               1.0, with_sums=True)

            def plain_d(prob=prob, pre=pre):
                return cp_dense.cp_dense_chunk_reference(
                    prob, pre, x0, ye0, yi0, 1000, 1.0, with_sums=True)

            err = compare(torch, kern_d(), plain_d(), name,
                          f"H-CPDENSE {key}")
            lay = cp_dense.dense_layout(prob.n, prob.m_eq, prob.m_ineq,
                                        x0.element_size())
            rec = dict(kernel="H-CPDENSE", problem=key, dtype=name,
                       n=prob.n, m_eq=prob.m_eq, m_ineq=prob.m_ineq,
                       nsteps=1000, layout=lay, max_abs_err=err)
            if dt == torch.float32:
                rec.update(timings(torch, kern_d, plain_d, 3, per=1000))
                rec["kernel_us"] = call_times(torch, kern_d, reps=3,
                                              host_reps=3)
                # each dense system read once per iteration (twice in the
                # products, once by the bound's count)
                planes = sum(o.a.numel() for o in (prob.a_eq, prob.a_ineq)
                             if o is not None)
                rec["bound_ms"], rec["bound_by"] = chunk_bound(prob, planes,
                                                               2 * planes)
                # the least time of ONE thread block: the iteration's
                # operations at one SM's share of the card's f32 rate
                rec["bound_sm_ms"] = chunk_ops(prob, 2 * planes) / (
                    F32_OPS_PER_S / H100_SMS) * 1e3
                if key == "sc105":
                    table["H-CPDENSE"].update({k: rec[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by")})
            table["H-CPDENSE"]["max_abs_err"] = max(
                table["H-CPDENSE"]["max_abs_err"], err)
            emit("kernels", **rec)


def chunk_io_bound(prob, planes, nsteps, plane_bytes=4):
    """The least time of one ``nsteps``-iteration chunk with sums (f32), per
    iteration, as one function: each input read once (the DIA operator's
    ``planes`` entries of ``plane_bytes`` each, and its offsets; c,
    diag_t, l, u, x; b, sigma, y per system), each output written once (x,
    x3 and the x sum; y and its sum per system), and ``nsteps`` times
    :func:`chunk_ops` (each plane entry in one multiply-add)."""
    rows = prob.m_eq + prob.m_ineq
    offsets = sum(len(o.offsets) + len(o.offsets_t)
                  for o in (prob.a_eq, prob.a_ineq) if o is not None)
    ms, by = bound(plane_bytes * planes
                   + 4 * (offsets + 8 * prob.n + 5 * rows),
                   nsteps * chunk_ops(prob, planes))
    return ms / nsteps, by


def resident_bound(prob, planes, plan, itemsize, nsteps, sm_mhz):
    """H-CPDIA-R's own least time per iteration: the shared-memory bytes of
    an iteration (:func:`resident_smem_traffic`) over the plan's C SMs at
    128 B per clock and the card's largest SM clock (``sm_mhz``), and the
    chunk's one HBM load and store (the bytes of :func:`chunk_io_bound`)
    spread over ``nsteps``; in ms, with the two parts."""
    smem_ms = resident_smem_traffic(prob, itemsize) / (
        plan.cluster * 128 * sm_mhz * 1e6) * 1e3
    rows = prob.m_eq + prob.m_ineq
    hbm_ms = itemsize * (planes + 8 * prob.n + 5 * rows) / HBM_BYTES_PER_S \
        * 1e3 / nsteps
    return dict(ms=smem_ms + hbm_ms, smem_ms=smem_ms, hbm_ms=hbm_ms)


def barrier_times(torch, nsteps=200, reps=20):
    """Microseconds per barrier of ``pslp_cluster_sync_loop``: one cluster
    of C = 8 and 16 CTAs of 640 threads (Potts-50's block) running 2 x
    ``nsteps`` cluster.sync() (mode 0) or __syncthreads() with a local
    mbarrier phase (mode 1: H-CPDIA-R's barrier once its halos landed)."""
    import ctypes

    from pysparselp_tpu_torch.ops import _build

    sync = _build.entry("pslp_cluster_sync_loop",
                        [ctypes.c_int] * 4 + [ctypes.c_void_p])
    stream = _build.stream(_build.device_index("cuda"))
    out = {}
    for mode, what in ((0, "cluster.sync"), (1, "syncthreads+mbarrier")):
        for c in (8, 16):
            ms = cuda_ms(torch, lambda c=c, mode=mode: sync(
                c, 640, 2 * nsteps, mode, stream), reps)
            out[f"{what} C={c}"] = ms * 1e3 / (2 * nsteps)
    return out


def phase_resident(torch, problems, table, sm_mhz):
    """Phase 2 for H-CPDIA-R (K2's shapes): Potts-20 and Potts-50, float32
    and float64, with and without sums, at 1, 7 and 200 iterations (an odd
    count catches a buffer-parity fault), each held against the twin and
    against the two-launch H-CPDIA forced on the same inputs; at 200
    iterations with sums the events, device and host times, kernels per
    call (must be 1), beside the forced two-launch kernel's, and the
    bounds; the cluster barrier's own cost."""
    import numpy as np

    from pysparselp_tpu_torch.ops import cp_dia

    emit("kernels", kernel="H-CPDIA-R", barrier_us=barrier_times(torch))
    rng = np.random.RandomState(1)
    dev = torch.device("cuda")
    for key in ("potts20", "potts50"):
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[1]
            prob, pre = lowered(problems[key], dt, dev)
            plan = cp_dia.cp_dia_plan(prob, dt)
            if plan.tier != "resident":
                raise AssertionError(f"{key} ({name}) planned {plan.tier}")
            x0 = torch.as_tensor(rng.rand(prob.n), dtype=dt, device=dev)
            ye0 = torch.zeros(0, dtype=dt, device=dev)
            yi0 = torch.as_tensor(rng.rand(prob.m_ineq) * 0.1, dtype=dt,
                                  device=dev)
            errs = {}
            for nsteps in (1, 7, 200):
                for sums in (True, False):
                    args = (prob, pre, x0, ye0, yi0, nsteps, 1.0, sums)
                    got = cp_dia.cp_dia_chunk(*args)
                    what = f"H-CPDIA-R {key} nsteps={nsteps} sums={sums}"
                    errs[f"{nsteps}{'+sums' if sums else ''}"] = dict(
                        twin=compare(torch, got,
                                     cp_dia.cp_dia_chunk_reference(*args),
                                     name, what),
                        two_launch=compare(torch, got, cp_dia.cp_dia_chunk(
                            *args, plan=cp_dia.TWO_LAUNCH), name,
                            f"{what} vs two-launch"))
            worst = max(e for v in errs.values() for e in v.values())
            table["H-CPDIA-R"]["max_abs_err"] = max(
                table["H-CPDIA-R"]["max_abs_err"], worst)
            rec = dict(kernel="H-CPDIA-R", problem=key, dtype=name,
                       n=prob.n, m_ineq=prob.m_ineq, cluster=plan.cluster,
                       width=plan.width, threads=plan.threads,
                       smem_bytes=plan.smem_bytes, reach=plan.reach,
                       planes=planes_of(prob), max_abs_err=errs)
            if dt == torch.float32:
                # staged from bfloat16 planes against float32 planes
                wide = dataclasses.replace(prob,
                                           a_ineq=f32_planes(prob.a_ineq))
                args = (x0, ye0, yi0, 200, 1.0, True)
                rec["bit_equal_f32_planes"] = same_bits(
                    torch, cp_dia.cp_dia_chunk(prob, pre, *args),
                    cp_dia.cp_dia_chunk(wide, pre, *args))
                if (prob.a_ineq.vals.dtype != torch.bfloat16
                        or not rec["bit_equal_f32_planes"]):
                    emit("kernels", **rec)
                    raise AssertionError(f"H-CPDIA-R {key}: not bit-equal "
                                         "on bfloat16 and float32 planes")

            def kern(prob=prob, pre=pre, x0=x0, yi0=yi0):
                return cp_dia.cp_dia_chunk(prob, pre, x0, ye0, yi0, 200, 1.0,
                                           True)

            def two(prob=prob, pre=pre, x0=x0, yi0=yi0):
                return cp_dia.cp_dia_chunk(prob, pre, x0, ye0, yi0, 200, 1.0,
                                           True, plan=cp_dia.TWO_LAUNCH)

            def plain(prob=prob, pre=pre, x0=x0, yi0=yi0):
                return cp_dia.cp_dia_chunk_reference(prob, pre, x0, ye0, yi0,
                                                     200, 1.0, True)

            # the kernel and the two-launch kernel in turns, per iteration
            pair = [cuda_ms(torch, f, 20) / 200 for f in (two, kern, kern,
                                                          two)]
            rec["pair_ms"] = dict(resident=(pair[1] + pair[2]) / 2,
                                  two_launch=(pair[0] + pair[3]) / 2)
            rec["kernel_us"] = {k: v / 200 if k.endswith("_us") else v
                                for k, v in call_times(
                                    torch, kern, reps=20, host_reps=20).items()}
            rec["two_launch_us"] = {k: v / 200 if k.endswith("_us") else v
                                    for k, v in call_times(
                                        torch, two, reps=5,
                                        host_reps=5).items()}
            # one kernel per chunk (the profiler may drop an event, never
            # add one)
            names = rec["kernel_us"]["kernel_names"]
            if (round(rec["kernel_us"]["kernels_per_call"]) != 1
                    or len(names) != 1
                    or "cp_dia_resident_kernel" not in names[0]):
                raise AssertionError(f"H-CPDIA-R {key}: not one kernel per "
                                     f"chunk: {rec['kernel_us']}")
            planes = prob.a_ineq.vals.numel() + prob.a_ineq.vals_t.numel()
            itemsize = x0.element_size()
            rec["bound_resident"] = resident_bound(prob, planes, plan,
                                                   itemsize, 200, sm_mhz)
            if dt == torch.float32:
                # the streaming and contract bounds count f32 bytes and
                # operations
                rec["bound_stream_ms"] = chunk_bound(prob, planes, planes)[0]
                rec["bound_ms"], rec["bound_by"] = chunk_io_bound(
                    prob, planes, 200)
                rec.update(timings(torch, kern, plain, 3, per=200))
                if key == "potts50":
                    table["H-CPDIA-R"].update({k: rec[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by")})
                    table["H-CPDIA-R"].update(
                        bound_stream_ms=rec["bound_stream_ms"],
                        bound_resident_ms=rec["bound_resident"]["ms"],
                        two_launch_ms=rec["pair_ms"]["two_launch"])
            emit("kernels", **rec)


# H-CPDIA-G's check and timing cases: the problem and its dtypes (Potts-300
# plans the grid tier in float32 only: on bfloat16 planes)
GRID_CASES = (("potts100", ("float32", "float64")),
              ("potts300", ("float32",)), ("multilabel64", ("float32",)))
GRID_STEPS = 100
# the buffer sizes (MiB, float32) whose back-to-back reads give the L2 rate
# H-CPDIA-G's own bound prices its L2 bytes at: the fastest of the two (a
# 16 MiB read is short enough for its launch to show; 36 MiB is about the
# BSR tile set, whose torch.mv read 4.55 TB/s on an H100 SXM, PERF.md K6)
GRID_L2_PROBE_MIB = (16, 36)


def grid_traffic(prob, plan, itemsize):
    """``(shared, l2)``: the bytes one H-CPDIA-G iteration with sums moves
    in shared memory (each tap a plane entry as stored and a vector entry;
    x3's and the duals' slabs written and read there, their halos stored
    there; the vectors the plan keeps there, read, and x and the sums also
    written) and through L2 (x3 and the duals written, their halos read,
    the other vectors read, and x and the sums also written)."""
    ai, ae = prob.a_ineq, prob.a_eq
    n = prob.n
    m = prob.m_ineq if ai is not None else 0
    me = prob.m_eq if ae is not None else 0
    plane = ai.vals.element_size()
    taps = sum(n * len(op.offsets_t) + rows * len(op.offsets)
               for op, rows in ((ai, m), (ae, me)) if op is not None)
    access = {"x": 2 * n, "sx": 2 * n, "sy": 2 * m, "sye": 2 * me,
              "c": n, "t": n, "lb": n, "ub": n, "b": m, "s": m, "be": me,
              "se": me}
    kept = sum(access[v] for v in plan.vectors)
    left = sum(v for k, v in access.items() if k not in plan.vectors)
    (hlx, hrx), (hly, hry) = plan.halos
    halos = plan.ctas * (hlx + hrx + ((m > 0) + (me > 0)) * (hly + hry))
    slabs = n + 2 * (m + me)
    shared = taps * (plane + itemsize) + itemsize * (kept + slabs + halos)
    l2 = itemsize * (n + m + me + halos + left)
    return shared, l2


def grid_bound(prob, plan, itemsize, sm_mhz, l2_rate):
    """H-CPDIA-G's own least time per iteration, in ms: the larger of its
    shared-memory bytes (:func:`grid_traffic`) over the plan's CTAs at 128
    B per clock and the card's largest SM clock, and its L2 bytes at
    ``l2_rate`` (the fastest read rate :func:`read_rates` measured in this
    run from an L2-resident buffer, over GRID_L2_PROBE_MIB); with the two
    parts.  The two grid barriers are not counted."""
    shared, l2 = grid_traffic(prob, plan, itemsize)
    smem_ms = shared / (plan.ctas * 128 * sm_mhz * 1e6) * 1e3
    l2_ms = l2 / l2_rate * 1e3
    return dict(ms=max(smem_ms, l2_ms), smem_ms=smem_ms, l2_ms=l2_ms,
                smem_bytes=shared, l2_bytes=l2)


def l2_read_rates(torch):
    """``{MiB: bytes/s}``: the L2-resident read rate (:func:`read_rates`)
    of a buffer of each of GRID_L2_PROBE_MIB."""
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    return {mib: read_rates(torch, mib * 1024 * 1024, flush)["l2"]
            for mib in GRID_L2_PROBE_MIB}


def grid_barrier_us(torch, nsyncs=400, reps=10):
    """Microseconds per grid barrier of ``pslp_grid_sync_loop``: one
    cooperative launch of H100_SMS CTAs running ``nsyncs`` grid.sync(), at
    the block sizes H-CPDIA-G's plans take (Potts-100 320 threads, the
    multi-label 64 grid 512, Potts-300 1,024)."""
    import ctypes

    from pysparselp_tpu_torch.ops import _build

    sync = _build.entry("pslp_grid_sync_loop",
                        [ctypes.c_int] * 3 + [ctypes.c_void_p])
    stream = _build.stream(_build.device_index("cuda"))
    return {threads: cuda_ms(torch, lambda threads=threads: sync(
        H100_SMS, threads, nsyncs, stream), reps) * 1e3 / nsyncs
        for threads in (320, 512, 1024)}


def phase_grid(torch, problems, table, sm_mhz):
    """Phase 2 for H-CPDIA-G (K3's shapes whose slab fits shared memory):
    on GRID_CASES, with and without sums, at 1, 7 and GRID_STEPS
    iterations, bit for bit against the twin and against the two-launch
    H-CPDIA forced on the same inputs (NaN and signed zeros included), one
    launch a chunk; in float32, at GRID_STEPS iterations with sums, the
    events, device and host times per iteration beside the two-launch
    kernel's in the same call, kernels per chunk (must be 1), and the
    bounds: the
    contract's (each input read once a chunk), the two-launch kernel's
    streaming bound on these planes and on float32 planes, and the tier's
    own (:func:`grid_bound`); first the grid barrier's own cost
    (:func:`grid_barrier_us`) and the L2 read rate the own bound uses (the
    fastest over GRID_L2_PROBE_MIB).  Returns the L2 read rates by probe
    size, ``{MiB: bytes/s}``."""
    import numpy as np

    from pysparselp_tpu_torch.ops import cp_dia

    rng = np.random.RandomState(2)
    dev = torch.device("cuda")
    l2_rates = l2_read_rates(torch)
    l2_rate = max(l2_rates.values())
    emit("kernels", kernel="H-CPDIA-G", l2_read_rate=l2_rate,
         l2_read_rate_by_mib=l2_rates, barrier_us=grid_barrier_us(torch))
    for key, dtypes in GRID_CASES:
        for name in dtypes:
            dt = getattr(torch, name)
            prob, pre = lowered(problems[key], dt, dev)
            plan = cp_dia.cp_dia_plan(prob, dt)
            if plan.tier != "grid":
                raise AssertionError(f"{key} ({name}) planned {plan.tier}")
            x0 = torch.as_tensor(rng.rand(prob.n), dtype=dt, device=dev)
            ye0 = torch.as_tensor(rng.rand(prob.m_eq) * 0.1, dtype=dt,
                                  device=dev)
            yi0 = torch.as_tensor(rng.rand(prob.m_ineq) * 0.1, dtype=dt,
                                  device=dev)
            checks = {}
            for nsteps in (1, 7, GRID_STEPS):
                for sums in (True, False):
                    args = (prob, pre, x0, ye0, yi0, nsteps, 1.0, sums)
                    before = cp_dia.cp_dia_grid_chunk.launches
                    got = cp_dia.cp_dia_chunk(*args)
                    launched = cp_dia.cp_dia_grid_chunk.launches - before
                    checks[f"{nsteps}{'+sums' if sums else ''}"] = dict(
                        launches=launched,
                        twin=same_bits(torch, got,
                                       cp_dia.cp_dia_chunk_reference(*args)),
                        two_launch=same_bits(torch, got, cp_dia.cp_dia_chunk(
                            *args, plan=cp_dia.TWO_LAUNCH)))
            ok = all(c["launches"] == 1 and c["twin"] and c["two_launch"]
                     for c in checks.values())
            rec = dict(kernel="H-CPDIA-G", problem=key, dtype=name,
                       n=prob.n, m_eq=prob.m_eq, m_ineq=prob.m_ineq,
                       planes=planes_of(prob), ctas=plan.ctas,
                       width=plan.width, threads=plan.threads,
                       smem_bytes=plan.smem_bytes, halos=plan.halos,
                       vectors=plan.vectors, checks=checks,
                       max_abs_err=0.0 if ok else None)
            if not ok:
                emit("kernels", **rec)
                raise AssertionError(f"H-CPDIA-G {key} ({name}): not bit-"
                                     "equal to the twin and the two-launch "
                                     "kernel in one launch")

            if dt != torch.float32:
                # float64 is checked, not timed
                emit("kernels", **rec)
                continue

            def grid(prob=prob, pre=pre, x0=x0, ye0=ye0, yi0=yi0):
                return cp_dia.cp_dia_chunk(prob, pre, x0, ye0, yi0,
                                           GRID_STEPS, 1.0, True)

            def two(prob=prob, pre=pre, x0=x0, ye0=ye0, yi0=yi0):
                return cp_dia.cp_dia_chunk(prob, pre, x0, ye0, yi0,
                                           GRID_STEPS, 1.0, True,
                                           plan=cp_dia.TWO_LAUNCH)

            def plain(prob=prob, pre=pre, x0=x0, ye0=ye0, yi0=yi0):
                return cp_dia.cp_dia_chunk_reference(prob, pre, x0, ye0, yi0,
                                                     GRID_STEPS, 1.0, True)

            def per_iteration(times):
                return {k: v / GRID_STEPS if k.endswith("_us") else v
                        for k, v in times.items()}

            # the two tiers in turns, per iteration
            pair = [cuda_ms(torch, f, 5) / GRID_STEPS
                    for f in (two, grid, grid, two)]
            rec["pair_ms"] = dict(grid=(pair[1] + pair[2]) / 2,
                                  two_launch=(pair[0] + pair[3]) / 2)
            rec["kernel_us"] = per_iteration(call_times(
                torch, grid, reps=5, host_reps=5))
            rec["two_launch_us"] = per_iteration(call_times(
                torch, two, reps=3, host_reps=3))
            names = rec["kernel_us"]["kernel_names"]
            if (round(rec["kernel_us"]["kernels_per_call"]) != 1
                    or len(names) != 1
                    or "cp_dia_grid_kernel" not in names[0]):
                raise AssertionError(f"H-CPDIA-G {key}: not one kernel per "
                                     f"chunk: {rec['kernel_us']}")
            planes = sum(o.vals.numel() + o.vals_t.numel()
                         for o in (prob.a_eq, prob.a_ineq) if o is not None)
            item = prob.a_ineq.vals.element_size()
            rec["bound_grid"] = grid_bound(prob, plan, x0.element_size(),
                                           sm_mhz, l2_rate)
            rec["bound_ms"], rec["bound_by"] = chunk_io_bound(
                prob, planes, GRID_STEPS, item)
            rec["bound_stream_ms"] = chunk_bound(prob, planes, planes,
                                                 item)[0]
            rec["bound_stream_f32_planes_ms"] = chunk_bound(prob, planes,
                                                            planes)[0]
            rec.update(timings(torch, grid, plain, 3, per=GRID_STEPS))
            if key == "potts300":
                table["H-CPDIA-G"].update({k: rec[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by")})
                table["H-CPDIA-G"].update(
                    bound_grid_ms=rec["bound_grid"]["ms"],
                    bound_stream_ms=rec["bound_stream_ms"],
                    bound_stream_f32_planes_ms=rec[
                        "bound_stream_f32_planes_ms"],
                    two_launch_ms=rec["pair_ms"]["two_launch"])
            emit("kernels", **rec)
    return l2_rates


def csr_matrices(workloads):
    """The unstructured systems H-CSR serves on the main path, as host
    scipy CSR: the transport equalities (100,000 x 1,000,000), the
    unstructured inequalities (150,000 x 100,000) and the column block of
    the k-medians folded inequalities that the chooser leaves to CSR (its
    Aᵀ rows are the ~5,000-entry used[c] columns)."""
    from pysparselp_tpu_torch.problem import choose_layout

    out = {"transport": workloads["transport"]["a_eq"],
           "unstructured": workloads["unstructured"]["a_ineq"]}
    km = workloads["kmedians"]["a_ineq"]
    backend, cuts, _bytes = choose_layout(km)
    if backend != "split":
        raise AssertionError(f"k-medians folded system lowered to {backend}")
    out["kmedians_block"] = km.tocsc()[:, cuts[-1]:].tocsr()
    return out


def csr_extra_matrices():
    """H-CSR cases held against the twin but not timed: one row of 100,000
    entries among 2-entry rows (cut into a few hundred chunks) and a
    system without entries."""
    import numpy as np
    import scipy.sparse

    rng = np.random.RandomState(10)
    m, n = 5000, 200_000
    rows = np.r_[np.full(100_000, 2500), np.repeat(np.arange(m), 2)]
    cols = np.r_[rng.choice(n, 100_000, replace=False),
                 rng.randint(0, n, 2 * m)]
    long_row = scipy.sparse.csr_matrix(
        (rng.randn(rows.size), (rows, cols)), shape=(m, n))
    long_row.sum_duplicates()
    return {"row_of_100k": long_row,
            "no_entries": scipy.sparse.csr_matrix((1000, 500))}


# the H-CSR systems whose values are exact in bfloat16 (the transport
# equalities' ones, the k-medians block's ±1): the main path stores them in
# bfloat16 for float32 (the JAX package's routed ELL storage)
BF16_CSR = ("transport", "kmedians_block")


def csr_bytes(operand):
    """Bytes one H-CSR product moves: the values at their stored size and
    the int32 indices, the row pointers, the output, and x read once."""
    nnz = operand.vals.numel()
    item = operand.carries.element_size()   # the product's dtype
    return (nnz * (operand.vals.element_size() + 4)
            + (operand.n_out + 1) * 4 + (operand.n_out + operand.n_in) * item)


def phase_csr(torch, matrices, table):
    """Phase 2 for H-CSR: both orientations of each matrix (and of
    :func:`csr_extra_matrices`) against the twin, per row within RTOL *
    (|A| |x|)_row, float32 and float64, and a second call giving the same
    bits; on the main path's matrices in float32 the kernel, the twin and
    the library call (cuSPARSE through ``torch.mv``) timed by events,
    device time, host time per call and kernels per call (one for H-CSR,
    and no copy to the host).  The systems of ``BF16_CSR`` run in float32
    on both value storages: the values in bfloat16 (as the main path
    stores them; ``values`` in each line) give the bits of the float32
    values' kernel on the same plan, and are held and timed the same way.
    The summary line's H-CSR numbers are transport A x on bfloat16 values,
    the storage its solve runs."""
    import numpy as np

    from pysparselp_tpu_torch.ops import csr_spmv as ops
    from pysparselp_tpu_torch.problem import CsrMatrix

    rng = np.random.RandomState(1)
    dev = torch.device("cuda")
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[1]
        for key, a in {**matrices, **csr_extra_matrices()}.items():
            ops_by_values = {name: CsrMatrix.from_scipy(a, dt, dev)}
            if dt == torch.float32 and key in BF16_CSR:
                narrow = CsrMatrix.from_scipy(a, dt, dev, allow_bf16="exact")
                if narrow.vals.dtype != torch.bfloat16:
                    raise AssertionError(f"H-CSR {key}: values stored in "
                                         f"{narrow.vals.dtype}, not bfloat16")
                ops_by_values["bfloat16"] = narrow
            for side in ("A", "At"):
                x, wide_out = None, None
                for values, op in ops_by_values.items():
                    operand = op.csr if side == "A" else op.csr_t
                    if x is None:
                        x = torch.as_tensor(rng.randn(operand.n_in),
                                            dtype=dt, device=dev)
                    rec, got = csr_case(torch, ops, key, side, name, values,
                                        operand, x, a if key in matrices
                                        else None)
                    if wide_out is None:
                        wide_out = got
                    elif not same_bits(torch, [got], [wide_out]):
                        raise AssertionError(
                            f"H-CSR {key} {side}: bfloat16 values differ "
                            "from float32 values, max "
                            f"{float((got - wide_out).abs().max()):.3e}")
                    else:
                        rec["bit_equal_to_float32_values"] = True
                    if (key, side, values) == ("transport", "A", "bfloat16"):
                        table["H-CSR"].update({k: rec[k] for k in (
                            "ms", "plain_ms", "library_ms", "bound_ms",
                            "bound_by")}, values=values)
                    table["H-CSR"]["max_abs_err"] = max(
                        table["H-CSR"]["max_abs_err"], rec["max_abs_err"])
                    emit("kernels", **rec)


def csr_case(torch, ops, key, side, name, values, operand, x, timed_host):
    """One H-CSR case of :func:`phase_csr`: the kernel against the twin
    per row, a second call's bits, and where ``timed_host`` (the host
    matrix of a main-path system, or None) the timings, the library call
    and the bound.  Returns the record and the kernel's output."""
    def kern():
        return ops.csr_spmv(operand, x)

    def plain():
        return ops.csr_spmv_reference(operand.indptr, operand.indices,
                                      operand.vals, x, operand.n_out)

    got, want = kern(), plain()
    scale = ops.csr_spmv_reference(operand.indptr, operand.indices,
                                   operand.vals.abs(), x.abs(), operand.n_out)
    err = (got - want).abs()
    if not bool((err <= RTOL[name] * scale).all()):
        raise AssertionError(
            f"H-CSR {key} {side} ({name}, {values} values): |kernel - twin| "
            f"past {RTOL[name]:.0e} * (|A||x|)_row, max "
            f"{float(err.max()):.3e}")
    if not torch.equal(kern(), got):
        raise AssertionError(f"H-CSR {key} {side} ({name}, {values} "
                             "values): two calls differ")
    nnz = operand.vals.numel()
    rec = dict(kernel="H-CSR", problem=key, side=side, dtype=name,
               values=values, shape=[operand.n_out, operand.n_in], nnz=nnz,
               width=operand.plan.width,
               blocks=operand.plan.row_blocks + operand.plan.n_chunks,
               long_rows=operand.plan.n_tasks,
               max_abs_err=float(err.max()))
    if operand.dtype == torch.float32 and timed_host is not None:
        rec.update(timings(torch, kern, plain, 50))
        host = timed_host if side == "A" else timed_host.T.tocsr()
        lib = sparse_tensor(torch, host, operand.dtype, operand.device)
        rec["library_ms"] = cuda_ms(
            torch, lambda lib=lib: torch.mv(lib, x), 50)
        rec["kernel_us"] = call_times(torch, kern)
        rec["library_us"] = call_times(torch, lambda lib=lib: torch.mv(lib, x))
        nbytes = csr_bytes(operand)
        rec["bytes"] = nbytes
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2 * nnz)
        rec["achieved_tb_s"] = nbytes / (
            rec["kernel_us"]["device_us"] * 1e-6) / 1e12
        calls = rec["kernel_us"]
        if round(calls["kernels_per_call"]) != 1 or len(
                calls["kernel_names"]) != 1 or "Memcpy" in \
                calls["kernel_names"][0]:
            raise AssertionError(
                f"H-CSR {key} {side}: {calls['kernels_per_call']} device "
                f"events per call, {calls['kernel_names']}")
    return rec, got


def batch_operator(lp, dtype, device):
    """The operator of ``lp``'s inequality system that a batched kernel
    serves, as ``solve_cp_batch`` lowers it, and its host matrix: the whole
    system, or the DIA block of a column split."""
    from pysparselp_tpu_torch.batch import _lower_batch
    from pysparselp_tpu_torch.problem import ColBlockMatrix, DiaMatrix

    a = batch_systems(lp)[1]
    op = _lower_batch(a, dtype, device)
    if isinstance(op, ColBlockMatrix):
        b = next(i for i, blk in enumerate(op.blocks)
                 if isinstance(blk, DiaMatrix))
        s = op.col_starts
        return op.blocks[b], a.tocsc()[:, s[b]:s[b + 1]].tocsr()
    return op, a


def phase_batch_kernels(torch, lps, table):
    """Phase 2 for the batched kernels, at the batch main path's operators
    and batch sizes: H-DIA-B on the banded system (B = 16) and on the DIA
    block of the assignment system (B = 8), H-CSR-B on the unstructured
    system (B = 8), both orientations, float32 and float64, against their
    twins (H-DIA-B bit-identical to the twin and column by column to
    H-DIA; H-CSR-B per row within RTOL * (|A| |X|)_row, a second call
    giving the same bits, and column by column within RTOL of H-CSR on
    that column); in float32 the kernel, the twin and the library call
    (cuSPARSE SpMM through ``torch.sparse.mm`` on the operator's CSR)
    timed by events, device time, host time per call and kernels per
    call, the kernel also with the L2 flushed before each call
    (:func:`cold_times`), and two bounds: the bytes at the HBM rate (the
    kernel line's, held against the cold time) and, for H-DIA-B, at the
    L2 read rate of a buffer of that size (:func:`read_rates`; held against
    the warm time, the solve's case: the data fits the L2), for H-CSR-B
    its gathered X rows (32-byte sectors) at the rate the card serves
    them from L2 (:func:`gather_rate`, on the operator's indices)."""
    import numpy as np

    from pysparselp_tpu_torch.ops import csr_spmv as csr_ops
    from pysparselp_tpu_torch.ops import dia_spmv as dia_ops

    rng = np.random.RandomState(3)
    dev = torch.device("cuda")
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device=dev)
    cases = (("H-DIA-B", "banded"), ("H-DIA-B", "assign"),
             ("H-CSR-B", "unstructured"))
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[1]
        for kernel, key in cases:
            op, host = batch_operator(lps[key], dt, dev)
            bsz = BATCH[key]["bsz"]
            sides = ((("A", op.fwd, host), ("At", op.bwd, None))
                     if kernel == "H-DIA-B" else
                     (("A", op.csr, host), ("At", op.csr_t, None)))
            for side, operand, mat in sides:
                mat = mat if mat is not None else host.T.tocsr()
                n_out, n_in = mat.shape
                x = torch.as_tensor(rng.randn(n_in, bsz), dtype=dt,
                                    device=dev)
                if kernel == "H-DIA-B":
                    def kern(operand=operand, x=x):
                        return dia_ops.dia_spmm(operand, x)

                    def plain(operand=operand, x=x, n_out=n_out):
                        return dia_ops.dia_spmm_reference(
                            operand.vals, operand.offs, x, n_out)

                    got = kern()
                    want = plain()
                    err = compare(torch, [got], [want], name,
                                  f"H-DIA-B {key} {side}")
                    columns = torch.stack(
                        [dia_ops.dia_apply(operand, x[:, b].contiguous())
                         for b in range(bsz)], dim=1)
                    if not (torch.equal(got, want)
                            and torch.equal(got, columns)):
                        raise AssertionError(
                            f"H-DIA-B {key} {side} ({name}) differs from "
                            "its twin or from H-DIA column by column")
                    stored = operand.vals.numel()
                    nbytes = (stored + bsz * (n_in + n_out)) * \
                        x.element_size() + 4 * operand.offs.numel()
                    launch = operand.batch_launch(bsz, x.data_ptr() % 16 == 0)
                    plan = launch.plan
                    extra = dict(
                        ndiag=int(operand.offs.numel()), equals_twin=True,
                        columns_equal_h_dia=True, plan=dict(
                            rows=plan.rows, columns_a_tile=plan.cols,
                            columns_a_thread=plan.cpt,
                            window=("read direct" if plan.direct
                                    else "one span" if plan.union
                                    else "one range per diagonal"),
                            window_rows=plan.window_rows,
                            window_bytes=plan.window_bytes,
                            copy=("none" if plan.direct else
                                  "cp.async.bulk" if plan.bulk
                                  else "cp.async"),
                            smem_bytes=plan.smem_bytes, tiles=plan.n_tiles,
                            grid=launch.struct.grid))
                else:
                    def kern(operand=operand, x=x):
                        return csr_ops.csr_spmm(operand, x)

                    def plain(operand=operand, x=x):
                        return csr_ops.csr_spmm_reference(
                            operand.indptr, operand.indices, operand.vals,
                            x, operand.n_out)

                    got, want = kern(), plain()
                    scale = csr_ops.csr_spmm_reference(
                        operand.indptr, operand.indices, operand.vals.abs(),
                        x.abs(), operand.n_out)
                    diff = (got - want).abs()
                    if not bool((diff <= RTOL[name] * scale).all()):
                        raise AssertionError(
                            f"H-CSR-B {key} {side} ({name}): |kernel - twin|"
                            f" past {RTOL[name]:.0e} * (|A||X|)_row, max "
                            f"{float(diff.max()):.3e}")
                    if not torch.equal(kern(), got):
                        raise AssertionError(f"H-CSR-B {key} {side} "
                                             f"({name}): two calls differ")
                    columns = torch.stack(
                        [csr_ops.csr_spmv(operand, x[:, b].contiguous())
                         for b in range(bsz)], dim=1)
                    col_diff = (got - columns).abs()
                    if not bool((col_diff <= RTOL[name] * scale).all()):
                        raise AssertionError(
                            f"H-CSR-B {key} {side} ({name}): a column past "
                            f"{RTOL[name]:.0e} * (|A||x|)_row of H-CSR on it")
                    err = float(diff.max())
                    stored = operand.vals.numel()
                    nbytes = stored * (x.element_size() + 4) \
                        + (n_out + 1) * 4 + bsz * (n_in + n_out) \
                        * x.element_size()
                    extra = dict(
                        nnz=stored, width=operand.plan.width,
                        long_rows=operand.plan.n_tasks,
                        columns_vs_h_csr_max_abs=float(col_diff.max()),
                        columns_equal_h_csr=bool(torch.equal(got, columns)))
                rec = dict(kernel=kernel, problem=key, side=side, dtype=name,
                           shape=[n_out, n_in], batch=bsz, max_abs_err=err,
                           **extra)
                if dt == torch.float32:
                    rec.update(timings(torch, kern, plain, 50))
                    lib = sparse_tensor(torch, mat, dt, dev)

                    def library(lib=lib, x=x):
                        return torch.sparse.mm(lib, x)

                    rec["library_ms"] = cuda_ms(torch, library, 50)
                    rec["kernel_us"] = call_times(torch, kern)
                    rec["library_us"] = call_times(torch, library)
                    rec["bound_ms"], rec["bound_by"] = bound(
                        nbytes, 2 * stored * bsz)
                    rec["bound_bytes"] = nbytes
                    # one kernel and no copy per call: one kernel name,
                    # at most one event per call (the profiler may drop
                    # events of a long capture, never add them)
                    calls = rec["kernel_us"]
                    names = calls["kernel_names"]
                    if (len(names) != 1 or "Memcpy" in names[0]
                            or calls["kernels_per_call"] > 1.0):
                        raise AssertionError(
                            f"{kernel} {key} {side}: "
                            f"{calls['kernels_per_call']} device events per "
                            f"call, {names}")
                    rec["kernel_cold_us"] = cold_times(torch, kern, names,
                                                       flush)
                    if kernel == "H-DIA-B":
                        rates = read_rates(torch, nbytes, flush)
                        label, second = "l2", nbytes / rates["l2"]
                        rec["l2_read_bytes_per_s"] = rates["l2"]
                    else:
                        sectors = -(-bsz * x.element_size() // 32)
                        gathered = stored * sectors * 32
                        rate, probe_us = gather_rate(torch, x,
                                                     operand.indices)
                        label, second = "gather", gathered / rate
                        rec.update(gather_bytes=gathered,
                                   gather_bytes_per_s=rate,
                                   gather_probe_us=probe_us)
                    rec[f"bound_{label}_ms"] = second * 1e3
                    rec["bounds_us"] = {"hbm": rec["bound_ms"] * 1e3,
                                        label: second * 1e6}
                    rec["binds"] = max(rec["bounds_us"],
                                       key=rec["bounds_us"].get)
                    # the HBM bound against the cold time, the other
                    # against the warm time (the solve's case)
                    rec["share_of_bounds"] = {
                        "hbm_cold": rec["bound_ms"] * 1e3
                        / rec["kernel_cold_us"]["device_us"],
                        f"{label}_warm": second * 1e6 / calls["device_us"]}
                    if side == "A" and key in ("banded", "unstructured"):
                        table[kernel].update({k: rec[k] for k in (
                            "ms", "plain_ms", "library_ms", "bound_ms",
                            "bound_by")})
                        table[kernel][f"bound_{label}_ms"] = second * 1e3
                table[kernel]["max_abs_err"] = max(
                    table[kernel]["max_abs_err"], err)
                emit("kernels", **rec)
    del flush


def bsr_library(torch, a, dtype, device, tile=128):
    """``(lib, n_padded)``: ``a`` (scipy) zero-padded to whole ``tile x
    tile`` blocks as a ``torch.sparse_bsr_tensor`` for the library call
    ``torch.mv(lib, x_padded)`` (cuSPARSE bsrmv), and the padded column
    count; only timed, the port never calls it."""
    import numpy as np
    import scipy.sparse

    m, n = a.shape
    mp, np_ = -(-m // tile) * tile, -(-n // tile) * tile
    coo = scipy.sparse.coo_matrix(a)
    b = scipy.sparse.bsr_matrix(
        scipy.sparse.csr_matrix((coo.data, (coo.row, coo.col)),
                                shape=(mp, np_)), blocksize=(tile, tile))
    b.sort_indices()
    lib = torch.sparse_bsr_tensor(
        torch.as_tensor(b.indptr.astype(np.int64), device=device),
        torch.as_tensor(b.indices.astype(np.int64), device=device),
        torch.as_tensor(b.data, dtype=dtype, device=device), size=(mp, np_),
        check_invariants=False)
    return lib, np_


def pair_times(torch, fa, fb, reps=200, host_reps=1000):
    """An SpMV pair as the solve calls it, ``fa()`` then ``fb()`` (A x then
    Aᵀ y), in microseconds per pair: ``events_us`` (CUDA events over
    ``reps`` pairs back to back), ``host_us`` (``time.perf_counter`` over
    ``host_reps`` pairs, one synchronize after), and the profiler's device
    time per pair (``device_us``) and of each call in the alternation
    (``device_a_us``, ``device_b_us``, by the order of the device events;
    None unless every pair gave the same even count), with
    ``kernels_per_pair``.  Unlike a loop of one direction, each call finds
    in L2 what the other left there."""
    def pair():
        fa()
        fb()

    events_us = cuda_ms(torch, pair, reps) * 1e3
    t0 = time.perf_counter()
    for _ in range(host_reps):
        pair()
    host_us = (time.perf_counter() - t0) / host_reps * 1e6
    torch.cuda.synchronize()
    dev = profiled_kernels(torch, pair, reps)
    per = max(round(len(dev) / reps), 1)
    us = [e.elapsed_us() for e in dev]
    out = dict(events_us=events_us, host_us=host_us,
               device_us=sum(us) / len(us) * per,
               device_a_us=None, device_b_us=None,
               kernels_per_pair=len(dev) / reps,
               kernel_names=sorted({e.name for e in dev}))
    if per % 2 == 0 and len(us) == per * reps:
        half = per // 2
        out["device_a_us"] = sum(
            u for i, u in enumerate(us) if i % per < half) / reps
        out["device_b_us"] = sum(
            u for i, u in enumerate(us) if i % per >= half) / reps
    return out


def bsr_tile_bytes(op, transpose, itemsize):
    """Bytes one H-BSR product of the tile set ``op`` (a ``BsrOperand``)
    must move: its stored tiles, their int32 ids (one a tile for A x,
    two for Aᵀ y), the pointers, x in and y out."""
    lines = op.col_ptr.numel() if transpose else op.row_ptr.numel()
    return (op.stored_entries * itemsize + (2 if transpose else 1) * 4
            * op.n_tiles + lines * 4 + (op.nrows + op.ncols) * itemsize)


def least_spmv_bytes(host, itemsize):
    """The bytes of ``y = host @ x`` in CSR: the entries with their int32
    column indices, the row pointers, x and y (H-CSR's bound)."""
    m, n = host.shape
    return host.nnz * (itemsize + 4) + (m + 1) * 4 + (m + n) * itemsize


L2_FLUSH_BYTES = 256 * 1024 * 1024   # five times the H100's 50 MB L2


def cold_times(torch, fn, names, flush, reps=50):
    """Per call of ``fn()`` with the L2 flushed before it, so its operands
    come from HBM, in microseconds: ``events_us`` (CUDA events around each
    call) and ``device_us`` (the profiler's device time of the call's
    kernels, those named in ``names``).  The flush reads ``flush``, a
    tensor of ``L2_FLUSH_BYTES`` (``amax``: read only, so the L2 holds no
    dirty line to write back during the call, and a kernel no timed call
    uses)."""
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in pairs:
        flush.amax()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    events_us = sum(a.elapsed_time(b) for a, b in pairs) / reps * 1e3

    def flushed():
        flush.amax()
        fn()

    dev = [e for e in profiled_kernels(torch, flushed, reps)
           if e.name in names]
    if not dev:
        raise AssertionError(f"no device event of {names} with the L2 "
                             "flushed")
    per = max(round(len(dev) / reps), 1)
    device_us = sum(e.elapsed_us() for e in dev) / len(dev) * per
    return dict(events_us=events_us, device_us=device_us)


def read_rates(torch, nbytes, flush):
    """Bytes per second at which the card reads ``nbytes`` of float32 in
    one reduction, by the profiler's device time: for each of ``sum``
    (``torch.sum`` of the buffer), ``row_sums`` (over rows of 4,096) and
    ``gemv`` (``torch.mv`` of the buffer as rows of 1,024), ``l2`` back
    to back, the buffer resident in L2 when it fits, and ``hbm`` with the
    L2 flushed before each call (:func:`cold_times`); ``l2`` and ``hbm``
    the fastest of the three."""
    buf = torch.ones(nbytes // 4 // 4096 * 4096, device="cuda")
    ones = torch.ones(1024, device="cuda")
    nbytes = buf.numel() * 4
    out = {"l2": 0.0, "hbm": 0.0}
    for key, fn in (("sum", buf.sum),
                    ("row_sums", lambda: buf.view(-1, 4096).sum(1)),
                    ("gemv", lambda: torch.mv(buf.view(-1, 1024), ones))):
        warm = call_times(torch, fn)
        cold = cold_times(torch, fn, warm["kernel_names"], flush)
        out[key] = {"l2": nbytes / (warm["device_us"] * 1e-6),
                    "hbm": nbytes / (cold["device_us"] * 1e-6)}
        out["l2"] = max(out["l2"], out[key]["l2"])
        out["hbm"] = max(out["hbm"], out[key]["hbm"])
    del buf
    return out


_GATHER_KERNEL = []


def gather_rate(torch, x, indices, reps=200):
    """Bytes per second at which the card serves rows of ``x`` (a 2-D
    float32 CUDA tensor, left in L2 between calls when it fits) gathered
    at the int32 ``indices``: a Triton kernel that reads each index (4
    bytes, coalesced) and its row and adds the rows up per program (a
    row's worth of bytes written a program of 1,024 rows).  The rate is
    the gathered rows' bytes over the profiler's device time of one call;
    also returns that time in microseconds.  Triton is imported here: a
    probe of the card, no part of the port."""
    import triton
    import triton.language as tl

    if not _GATHER_KERNEL:
        @triton.jit
        def gather_rows(x_ptr, idx_ptr, out_ptr, n, COLS: tl.constexpr,
                        BLOCK: tl.constexpr, STEPS: tl.constexpr):
            pid = tl.program_id(0)
            cols = tl.arange(0, COLS)
            acc = tl.zeros([BLOCK, COLS], dtype=tl.float32)
            for step in range(STEPS):
                offs = (pid * STEPS + step) * BLOCK + tl.arange(0, BLOCK)
                mask = offs < n
                j = tl.load(idx_ptr + offs, mask=mask, other=0)
                acc += tl.load(x_ptr + j[:, None] * COLS + cols[None, :],
                               mask=mask[:, None], other=0.0)
            tl.store(out_ptr + pid * COLS + cols, tl.sum(acc, axis=0))

        _GATHER_KERNEL.append(gather_rows)
    kernel = _GATHER_KERNEL[0]
    rows, cols = x.shape
    n = indices.numel()
    block, steps = 128, 8
    grid = (triton.cdiv(n, block * steps),)
    out = torch.empty((grid[0], cols), dtype=x.dtype, device=x.device)

    def call():
        kernel[grid](x, indices, out, n, COLS=cols, BLOCK=block,
                     STEPS=steps)

    want = x.double()[indices.long()].sum(0)
    call()
    if not torch.allclose(out.double().sum(0), want, rtol=1e-4, atol=1e-2):
        raise AssertionError("the gather probe's sums are wrong")
    us = call_times(torch, call, reps=reps, host_reps=reps)["device_us"]
    return n * cols * x.element_size() / (us * 1e-6), us


def phase_bsr(torch, a, table):
    """Phase 2 for H-BSR on ``a``, the RCM-permuted CLIME system, at the
    shipped tile size: both directions of the one tile set, through the
    operator's entry points, against the twin, per row within RTOL *
    (|A| |x|)_row, float32 and float64; in float32 the kernel, the library
    call (cuSPARSE bsrmv at the shipped tile size and at 128x128) and
    H-CSR on the same matrix, each timed twice:
    * cold, the L2 flushed before each call (:func:`cold_times`), against
      the bytes of the call (:func:`bsr_tile_bytes`) over the HBM rate:
      the kernel line's ``ms`` and ``bound_ms``, and the pair's
      ``tile_bound_fraction`` (each product cold);
    * warm, back to back (:func:`call_times`) and as the solve calls them,
      A x then Aᵀ y in turns (:func:`pair_times`), where the tile set
      (37.7 MB at 16x16) stays in the 50 MB L2: beside the time the same
      bytes take at the L2 read rate that a reduction over a buffer of
      the tile set's size reaches in this run (:func:`read_rates`;
      ``l2_read_us``), and the pair in turns against it
      (``in_turns_l2_bound_fraction``).
    Beside them, H-CSR's bytes (:func:`least_spmv_bytes`)."""
    import numpy as np

    from pysparselp_tpu_torch.ops import bsr_spmv as ops
    from pysparselp_tpu_torch.problem import BsrMatrix, CsrMatrix

    rng = np.random.RandomState(2)
    dev = torch.device("cuda")
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device=dev)
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[1]
        s = torch.empty((), dtype=dt).element_size()
        t0 = time.perf_counter()
        mat = BsrMatrix.from_scipy(a, dt, dev)
        build_s = time.perf_counter() - t0
        op = mat.op
        stored = dict(tile=op.tile, n_tiles=op.n_tiles,
                      stored_entries=op.stored_entries,
                      tile_rows=op.row_ptr.numel() - 1,
                      tile_cols=op.col_ptr.numel() - 1,
                      max_tiles_per_row=int(op.row_ptr.diff().max()),
                      max_tiles_per_col=int(op.col_ptr.diff().max()))
        if not bool((op.tiles != 0).flatten(1).any(dim=1).all()):
            raise AssertionError("H-BSR stored a tile without an entry")
        xs = {side: torch.as_tensor(rng.randn(n), dtype=dt, device=dev)
              for side, n in (("A", op.ncols), ("At", op.nrows))}
        calls = {"A": lambda: mat.matvec(xs["A"]),
                 "At": lambda: mat.rmatvec(xs["At"])}
        hosts = {"A": a, "At": a.T.tocsr()}
        f32 = dt == torch.float32
        if f32:
            rates = read_rates(torch, op.stored_entries * s, flush)
            pair = {k: 0.0 for k in (
                "cold_us", "warm_us", "plain_ms", "library_cold_us",
                "library_128_cold_us", "csr_cold_us", "tile_bytes",
                "tile_bound_ms", "csr_bytes", "csr_bound_ms")}
            csr = CsrMatrix.from_scipy(a, dt, dev)
        for side, kern in calls.items():
            transpose = side == "At"
            x, host = xs[side], hosts[side]

            def plain(x=x, transpose=transpose):
                return ops.bsr_spmv_reference(op, x, transpose)

            got, want = kern(), plain()
            scale = ops.bsr_spmv_reference(op.abs(), x.abs(), transpose)
            err = (got - want).abs()
            if not bool((err <= RTOL[name] * scale).all()):
                raise AssertionError(
                    f"H-BSR clime {side} ({name}): |kernel - twin| past "
                    f"{RTOL[name]:.0e} * (|A||x|)_row, max {float(err.max()):.3e}")
            if not torch.equal(got, kern()):
                raise AssertionError(f"H-BSR clime {side} ({name}): two "
                                     "runs differ")
            rec = dict(kernel="H-BSR", problem="clime150_rcm", side=side,
                       dtype=name, shape=list(host.shape),
                       nnz=int(host.nnz), **stored, host_build_s=build_s,
                       max_abs_err=float(err.max()))
            if f32:
                rec["plain_ms"] = cuda_ms(torch, plain, 50)
                rec["kernel_us"] = call_times(torch, kern)
                rec["kernel_cold"] = cold_times(
                    torch, kern, rec["kernel_us"]["kernel_names"], flush)
                for tile, key in ((op.tile, "library"),
                                  (128, "library_128")):
                    lib, n_pad = bsr_library(torch, host, dt, dev, tile)
                    xpad = torch.nn.functional.pad(x, (0, n_pad - x.numel()))

                    def lib_call(lib=lib, xpad=xpad):
                        return torch.mv(lib, xpad)

                    warm = call_times(torch, lib_call, reps=50, host_reps=50)
                    rec[f"{key}_us"] = warm
                    rec[f"{key}_cold"] = cold_times(
                        torch, lib_call, warm["kernel_names"], flush)
                    rec[f"{key}_max_abs_err"] = float(
                        (lib_call()[:want.numel()] - want).abs().max())
                    del lib
                fn = csr.rmatvec if transpose else csr.matvec
                warm = call_times(torch, lambda fn=fn, x=x: fn(x))
                rec["csr_us"] = warm
                rec["csr_cold"] = cold_times(
                    torch, lambda fn=fn, x=x: fn(x), warm["kernel_names"],
                    flush)
                rec["tile_bytes"] = bsr_tile_bytes(op, transpose, s)
                rec["tile_bound_ms"], rec["bound_by"] = bound(
                    rec["tile_bytes"], 2 * op.stored_entries)
                rec["csr_bytes"] = least_spmv_bytes(host, s)
                rec["csr_bound_ms"] = bound(rec["csr_bytes"],
                                            2 * int(host.nnz))[0]
                cold = rec["kernel_cold"]["device_us"]
                warm_dev = rec["kernel_us"]["device_us"]
                rec.update(
                    cold_us=cold, warm_us=warm_dev,
                    library_cold_us=rec["library_cold"]["device_us"],
                    library_128_cold_us=rec["library_128_cold"]["device_us"],
                    csr_cold_us=rec["csr_cold"]["device_us"],
                    tile_bound_fraction=rec["tile_bound_ms"] * 1e3 / cold,
                    l2_read_us=rec["tile_bytes"] / rates["l2"] * 1e6,
                    csr_cold_bound_fraction=rec["csr_bound_ms"] * 1e3
                    / rec["csr_cold"]["device_us"])
                for key in pair:
                    pair[key] += rec[key]
                if side == "A":
                    # the kernel line: one A x with its operands in HBM
                    table["H-BSR"].update(
                        ms=rec["kernel_cold"]["events_us"] * 1e-3,
                        plain_ms=rec["plain_ms"],
                        library_ms=rec["library_cold"]["events_us"] * 1e-3,
                        bound_ms=rec["tile_bound_ms"],
                        bound_by=rec["bound_by"])
            table["H-BSR"]["max_abs_err"] = max(
                table["H-BSR"]["max_abs_err"], rec["max_abs_err"])
            emit("kernels", **rec)
        if f32:
            # the pair as the solve calls it: A x, then Aᵀ y, in turns
            solve_pair = pair_times(torch, calls["A"], calls["At"])
            csr_pair = pair_times(torch, lambda: csr.matvec(xs["A"]),
                                  lambda: csr.rmatvec(xs["At"]))
            emit("kernels", kernel="H-BSR", problem="clime150_rcm",
                 side="pair", dtype=name, **stored, **pair,
                 read_rates=rates,
                 in_turns=solve_pair, csr_in_turns=csr_pair,
                 tile_bound_fraction=pair["tile_bound_ms"] * 1e3
                 / pair["cold_us"],
                 in_turns_l2_bound_fraction=pair["tile_bytes"]
                 / rates["l2"] * 1e6 / solve_pair["device_us"],
                 csr_cold_bound_fraction=pair["csr_bound_ms"] * 1e3
                 / pair["csr_cold_us"])
            del csr
        del mat, op
    del flush


CURVES = ("pobj_curve", "dobj_curve", "max_violated_equality",
          "max_violated_inequality")


def checkpoint_diffs(got, want):
    """Worst difference per curve: objectives relative to |f64|,
    violations relative to max(1, |f64|).  Equal values, infinities
    included (the dual bound of an LP with free variables), and two NaNs
    differ by 0."""
    worst = {}
    for k in CURVES:
        rel = [0.0 if g == w or (g != g and w != w)
               else abs(g - w) / (abs(w) if k.endswith("obj_curve")
                                  else max(1.0, abs(w)))
               for g, w in zip(got[k], want[k])]
        worst[k] = max(rel)
    return worst


def curves(lp):
    return {k: [float(v) for v in getattr(lp, k)] for k in CURVES}


def steady_rate(lp):
    return ((lp.itrn_curve[-1] - lp.itrn_curve[0])
            / (lp.opttime_curve[-1] - lp.opttime_curve[0]))


def value_storage(op):
    """The dtype each operator stores its values in, by name: a column-
    block composite lists its blocks."""
    from pysparselp_tpu_torch.problem import (BsrMatrix, ColBlockMatrix,
                                              DenseMatrix)

    if op is None:
        return None
    if isinstance(op, ColBlockMatrix):
        return [value_storage(b) for b in op.blocks]
    vals = (op.a if isinstance(op, DenseMatrix)
            else op.op.tiles if isinstance(op, BsrMatrix) else op.vals)
    return str(vals.dtype).split(".")[1]


def blocks_of(op):
    """The operators of ``op``: its blocks, or itself."""
    from pysparselp_tpu_torch.problem import ColBlockMatrix

    if op is None:
        return []
    if isinstance(op, ColBlockMatrix):
        return [x for b in op.blocks for x in blocks_of(b)]
    return [op]


# the non-grid workloads whose CSR and partition values are exact in
# bfloat16 (ones and ±1), which the lowering stores so in float32
BF16_WORKLOADS = ("transport", "kmedians")


def count_ops(op, kind):
    """How many operators of ``kind`` ``op`` holds (blocks included)."""
    from pysparselp_tpu_torch.problem import ColBlockMatrix

    if op is None:
        return 0
    if isinstance(op, ColBlockMatrix):
        return sum(count_ops(b, kind) for b in op.blocks)
    return int(isinstance(op, kind))


def phase_nongrid(torch, name, lp, counted_solve):
    """Phase 4 for one workload; returns its launch counts."""
    import numpy as np

    from pysparselp_tpu_torch.problem import (CsrMatrix, DiaMatrix,
                                              PartitionMatrix, lower_systems,
                                              operator_cost_bytes)
    from pysparselp_tpu_torch.solvers.chambolle_pock import _choose_layout

    sys_ = folded(lp)
    mats = [sys_["a_eq"], sys_["a_ineq"]]
    t0 = time.perf_counter()
    choice, _plan, layouts = _choose_layout(mats)
    choose_s = time.perf_counter() - t0
    if choice is not None:
        raise AssertionError(f"{name}: the layout presolve chose {choice!r}")
    t0 = time.perf_counter()
    ops = lower_systems(mats, torch.float32, "cuda", layouts=layouts)
    torch.cuda.synchronize()
    lower_s = time.perf_counter() - t0
    values = {"a_eq": value_storage(ops[0]), "a_ineq": value_storage(ops[1])}
    if name in BF16_WORKLOADS and any(
            op.vals.dtype != torch.bfloat16
            for o in ops for op in blocks_of(o)
            if isinstance(op, (CsrMatrix, PartitionMatrix))):
        raise AssertionError(f"{name}: CSR / partition values stored as "
                             f"{values}, not bfloat16")
    run = dict(method="chambolle_pock_ppd", nb_iter=200, nb_iter_plot=100)
    lp.solve(dtype=np.float32, device="cuda", **run)
    got, itrn = curves(lp), list(lp.itrn_curve)
    t0 = time.perf_counter()
    lp.solve(dtype=np.float64, device="cpu", **run)
    cpu_wall = time.perf_counter() - t0
    want = curves(lp)
    if lp.itrn_curve != itrn:
        raise AssertionError(f"checkpoints {itrn} vs {lp.itrn_curve}")
    worst = checkpoint_diffs(got, want)
    nb_iter, plot = 2000, 1000
    wall, launches = counted_solve(
        lp, method="chambolle_pock_ppd", nb_iter=nb_iter, nb_iter_plot=plot,
        light_metrics=True, dtype=np.float32, device="cuda")
    # the per-operator path: one rmatvec and one matvec per iteration and
    # four products in each checkpoint's metrics, per operator
    per_op = 2 * nb_iter + 4 * (nb_iter // plot)
    predicted = {"H-CSR": per_op * sum(count_ops(o, CsrMatrix) for o in ops),
                 "H-DIA": per_op * sum(count_ops(o, DiaMatrix) for o in ops)}
    emit(f"main_path_{name}", n=len(sys_["c"]),
         nnz=[None if a is None else int(a.nnz) for a in mats],
         lowered={"a_eq": describe(ops[0]), "a_ineq": describe(ops[1])},
         values=values,
         permutation=choice, auto_layout_s=choose_s, lower_s=lower_s,
         bytes_per_spmv_pair=sum(operator_cost_bytes(o) for o in ops),
         itrn=itrn, f32_cuda=got, f64_cpu=want, worst_rel_diff=worst,
         rel_limit=NONGRID_RTOL, cpu_wall_s=cpu_wall, wall_s=wall,
         iters_per_s_steady=steady_rate(lp), launches=launches,
         launches_predicted=predicted)
    if not all(v <= NONGRID_RTOL for v in worst.values()):
        raise AssertionError(f"{name} f32 CUDA vs f64 CPU: {worst}")
    for key, want_n in predicted.items():
        if launches[key] != want_n:
            raise AssertionError(f"{name}: {key} launched {launches[key]} "
                                 f"times, predicted {want_n}")
    if name in ("transport", "unstructured") and not launches["H-CSR"]:
        raise AssertionError(f"{name} ran no H-CSR launch")
    return launches


def batch_diffs(got, want):
    """Worst difference per curve of two batch runs over every checkpoint
    and column: energies relative to |f64|, violations relative to max(1,
    |f64|)."""
    import numpy as np

    from pysparselp_tpu_torch.batch import CURVES as BATCH_CURVES

    worst = {}
    for k in BATCH_CURVES:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        scale = np.abs(w) if k.startswith("energy") else np.maximum(
            1.0, np.abs(w))
        diff = np.where(g == w, 0.0, np.abs(g - w) / np.where(
            scale == 0, 1.0, scale))
        worst[k] = float(diff.max())
    return worst


def phase_batch(torch, name, lp, counters):
    """``main_path_batch_<name>``: ``solve_cp_batch`` on the card for one
    of :data:`BATCH`'s configurations.  The backends chosen and the host
    lowering time; the first ``BATCH_CHECK_ITERS`` iterations in float32,
    held at every checkpoint against the port's float64 CPU batch run
    (:func:`batch_diffs` within ``NONGRID_RTOL``); three timed runs of the
    steady configuration (a checkpoint every quarter), each with its launch
    counts set to 0 just before and read just after, their steady batch
    iterations/s (between the first and last checkpoints) and problem-
    iterations/s (× B), median and spread; the single-problem
    ``chambolle_pock_ppd`` rate on the same template (three runs) and the
    batching efficiency; the launches held against the operators'
    prediction.  Returns the last timed run's launch counts."""
    import numpy as np

    from pysparselp_tpu_torch import solve_cp_batch
    from pysparselp_tpu_torch.batch import _lower_batch
    from pysparselp_tpu_torch.problem import CsrMatrix, DiaMatrix

    cfg = BATCH[name]
    bsz, nb_iter = cfg["bsz"], cfg["nb_iter"]
    costs = batch_costs(lp, bsz, cfg["vary"])
    mats = batch_systems(lp)
    t0 = time.perf_counter()
    ops = [None if a is None else _lower_batch(a, torch.float32, "cuda")
           for a in mats]
    torch.cuda.synchronize()
    lower_s = time.perf_counter() - t0
    check = dict(costs=costs, nb_iter=BATCH_CHECK_ITERS,
                 nb_iter_plot=BATCH_CHECK_PLOT)
    _x, got = solve_cp_batch(lp, dtype=np.float32, device="cuda", **check)
    t0 = time.perf_counter()
    _x, want = solve_cp_batch(lp, dtype=np.float64, device="cpu", **check)
    cpu_wall = time.perf_counter() - t0
    worst = batch_diffs(got, want)

    plot = nb_iter // 4
    runs = []
    for _ in range(3):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        _x, info = solve_cp_batch(lp, costs=costs, nb_iter=nb_iter,
                                  nb_iter_plot=plot, dtype=np.float32,
                                  device="cuda")
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        itrn, sec = info["itrn"], info["opttime"]
        runs.append(dict(wall_s=wall, first_checkpoint_s=float(sec[0]),
                         iters_per_s=float((itrn[-1] - itrn[0])
                                           / (sec[-1] - sec[0]))))
    rates = sorted(r["iters_per_s"] for r in runs)
    single = []
    for _ in range(3):
        lp.solve(method="chambolle_pock_ppd", nb_iter=nb_iter,
                 nb_iter_plot=plot, light_metrics=True, dtype=np.float32,
                 device="cuda")
        single.append(steady_rate(lp))
    single.sort()
    # per operator of a kind: a matvec and an rmatvec per iteration, and
    # an rmatvec and two matvecs in each checkpoint's metrics
    per_op = 2 * nb_iter + 3 * (nb_iter // plot)
    predicted = {"H-DIA-B": per_op * sum(count_ops(o, DiaMatrix)
                                         for o in ops),
                 "H-CSR-B": per_op * sum(count_ops(o, CsrMatrix)
                                         for o in ops)}
    emit(f"main_path_batch_{name}", batch=bsz, n=lp.nb_variables,
         nnz=[None if a is None else int(a.nnz) for a in mats],
         backend=info["backend"],
         lowered={"a_eq": describe(ops[0]), "a_ineq": describe(ops[1])},
         lower_s=lower_s, check_iters=BATCH_CHECK_ITERS,
         itrn=got["itrn"].tolist(), worst_rel_diff=worst,
         rel_limit=NONGRID_RTOL, cpu_f64_wall_s=cpu_wall,
         steady_iters=nb_iter, runs=runs,
         batch_iters_per_s=rates[1], batch_iters_per_s_spread=rates,
         problem_iters_per_s=rates[1] * bsz,
         single_iters_per_s=single[1], single_iters_per_s_spread=single,
         batching_efficiency=rates[1] * bsz / single[1],
         launches=launches, launches_predicted=predicted)
    if not all(v <= NONGRID_RTOL for v in worst.values()):
        raise AssertionError(f"batch {name} f32 CUDA vs f64 CPU: {worst}")
    for key, want_n in predicted.items():
        if launches[key] != want_n:
            raise AssertionError(f"batch {name}: {key} launched "
                                 f"{launches[key]} times, predicted {want_n}")
    for key in ("H-DIA", "H-CSR", "H-CPDIA", "H-CPDIA-G", "H-CPDENSE",
                "H-BSR"):
        if launches[key]:
            raise AssertionError(f"batch {name}: the 1-D kernel {key} ran "
                                 f"{launches[key]} times")
    return launches


def phase_clime(torch, lp, counted_solve):
    """Phase 5: the CLIME LP through ``permute="auto"`` on the card: one
    solve of 2,000 ``light_metrics`` iterations with a checkpoint every
    100, whose layout presolve is the solver's own call, recorded (its
    seconds, the systems it was given and its choice), whose first
    checkpoint is held against the port's own float64 CPU run of 100
    iterations and whose launches against those the lowered operators
    predict.  The lowering is then timed on the recorded systems and
    choice, as the solver calls it.  Returns the solve's launch counts."""
    import numpy as np

    from unittest import mock

    from pysparselp_tpu_torch.problem import (BsrMatrix, CsrMatrix,
                                              DiaMatrix, apply_rcm_permutation,
                                              lower_systems,
                                              operator_cost_bytes)
    from pysparselp_tpu_torch.solvers import chambolle_pock

    real_choose = chambolle_pock._choose_layout
    calls = []

    def recorded_choose(mats, *args, **kwargs):
        t0 = time.perf_counter()
        out = real_choose(mats, *args, **kwargs)
        calls.append((time.perf_counter() - t0, list(mats), out))
        return out

    nb_iter, plot = 2000, 100
    with mock.patch.object(chambolle_pock, "_choose_layout", recorded_choose):
        wall, launches = counted_solve(
            lp, method="chambolle_pock_ppd", nb_iter=nb_iter,
            nb_iter_plot=plot, light_metrics=True, permute="auto",
            dtype=np.float32, device="cuda")
    if len(calls) != 1:
        raise AssertionError(f"CLIME: the solve ran the layout presolve "
                             f"{len(calls)} times, expected once")
    choose_s, mats, (choice, _plan, layouts) = calls[0]
    sys_ = folded(lp)
    for got_a, want_a in zip(mats, (sys_["a_eq"], sys_["a_ineq"])):
        if (got_a is None) != (want_a is None) or (
                got_a is not None and (got_a.shape != want_a.shape
                                       or (got_a != want_a).nnz)):
            raise AssertionError("CLIME: the solver gave the layout presolve "
                                 "other systems than the LP's")
    sys_ = dict(sys_, a_eq=mats[0], a_ineq=mats[1])
    if choice == "rcm":
        sys_ = apply_rcm_permutation(sys_)[0]
    t0 = time.perf_counter()
    ops = lower_systems([sys_["a_eq"], sys_["a_ineq"]], torch.float32,
                        "cuda", layouts=layouts)
    torch.cuda.synchronize()
    lower_s = time.perf_counter() - t0
    n_ops = {kind.__name__: sum(count_ops(o, kind) for o in ops)
             for kind in (BsrMatrix, CsrMatrix, DiaMatrix)}
    described = {"a_eq": describe(ops[0]), "a_ineq": describe(ops[1])}
    bytes_pair = sum(operator_cost_bytes(o) for o in ops)
    del ops, sys_, calls
    got, itrn = curves(lp), list(lp.itrn_curve)
    its = steady_rate(lp)
    # the same solve unpermuted (the chooser lowers it to CSR): what the
    # presolve's pick costs or saves end to end
    wall_csr, launches_csr = counted_solve(
        lp, method="chambolle_pock_ppd", nb_iter=nb_iter, nb_iter_plot=plot,
        light_metrics=True, permute=False, dtype=np.float32, device="cuda")
    its_csr = steady_rate(lp)
    t0 = time.perf_counter()
    lp.solve(method="chambolle_pock_ppd", nb_iter=plot, nb_iter_plot=plot,
             dtype=np.float64, device="cpu")
    cpu_wall = time.perf_counter() - t0
    want = curves(lp)
    if lp.itrn_curve != itrn[:1]:
        raise AssertionError(f"checkpoints {itrn[:1]} vs {lp.itrn_curve}")
    worst = checkpoint_diffs(got, want)
    # per operator: one rmatvec and one matvec per iteration and four
    # products in each checkpoint's metrics
    per_op = 2 * nb_iter + 4 * (nb_iter // plot)
    predicted = {"H-BSR": per_op * n_ops["BsrMatrix"],
                 "H-CSR": per_op * n_ops["CsrMatrix"],
                 "H-DIA": per_op * n_ops["DiaMatrix"]}
    emit("main_path_clime", **CLIME, n=lp.nb_variables,
         rows=[a.shape[0] for a in (lp.a_equalities, lp.a_inequalities)],
         nnz=[None if a is None else int(a.nnz) for a in mats],
         permutation=choice, lowered=described,
         auto_layout_s=choose_s, lower_s=lower_s,
         bytes_per_spmv_pair=bytes_pair, itrn=itrn,
         f32_cuda={k: v[:1] for k, v in got.items()}, f64_cpu=want,
         worst_rel_diff=worst, rel_limit=NONGRID_RTOL, cpu_wall_s=cpu_wall,
         wall_s=wall, iters_per_s_steady=its,
         launches=launches, launches_predicted=predicted,
         unpermuted_wall_s=wall_csr,
         unpermuted_iters_per_s_steady=its_csr,
         unpermuted_launches=launches_csr)
    if not launches_csr["H-CSR"] or launches_csr["H-BSR"]:
        raise AssertionError(f"CLIME unpermuted: launches {launches_csr}, "
                             "expected H-CSR and no H-BSR")
    if choice != "rcm" or not n_ops["BsrMatrix"]:
        raise AssertionError(f"CLIME: presolve chose {choice!r}, lowered to "
                             f"{described}; expected RCM and a BsrMatrix")
    if not all(v <= NONGRID_RTOL for v in worst.values()):
        raise AssertionError(f"CLIME f32 CUDA vs f64 CPU: {worst}")
    for key, want_n in predicted.items():
        if launches[key] != want_n:
            raise AssertionError(f"CLIME: {key} launched {launches[key]} "
                                 f"times, predicted {want_n}")
    return launches


def aligned_potts(lp):
    """The anchor-aligned one-sided system the solver builds for a Potts
    LP (host arrays)."""
    from pysparselp_tpu_torch.problem import apply_align_embedding
    from pysparselp_tpu_torch.solvers.chambolle_pock import _auto_layout

    sys_ = folded(lp)
    plan = _auto_layout([sys_["a_eq"], sys_["a_ineq"]])
    if plan is None:
        raise AssertionError("the Potts LP did not align to DIA")
    return apply_align_embedding(plan, sys_)[0]


def eqineq_aligned():
    """A small random eq+ineq LP (60 columns, 10 equality and 40
    inequality rows; ``tests/test_torch_sharded.py``'s case), anchor
    aligned: 162 positions, 63 and 132 diagonals, so four shards are
    shorter than the diagonals' spread and whole diagonals miss a shard's
    window (offsets outside ``(-w, rows_loc)``, which K5 clamps)."""
    import numpy as np
    import scipy.sparse

    from pysparselp_tpu_torch.problem import (anchor_align,
                                              apply_align_embedding)

    rng = np.random.RandomState(5)
    n = 60
    a_eq = scipy.sparse.random(10, n, density=0.15, random_state=rng,
                               format="csr")
    a_in = scipy.sparse.random(40, n, density=0.12, random_state=rng,
                               format="csr")
    x_feas = rng.rand(n)
    sys_ = dict(a_eq=a_eq, beq=a_eq @ x_feas, a_ineq=a_in,
                b_ineq=a_in @ x_feas + 0.5, c=rng.randn(n), lb=np.zeros(n),
                ub=np.ones(n))
    return apply_align_embedding(anchor_align([a_eq, a_in]), sys_)[0]


def phase_k5(torch, lp, table):
    """Phase 2 for K5's function: H-DIA on each of MESH_RANKS row shards
    (``parallel.sharded_dia``), forward (rows_loc rows, absolute offsets
    into the replicated x) and transpose window (w columns, offsets into
    the shard's duals), against the twin in float32 and float64.  On the
    aligned Potts-300 system, in float32, the kernel, the twin and the
    library call (cuSPARSE ``torch.mv`` of the shard's CSR) are timed, and
    the bound is from the bytes the call needs: the planes, the offsets,
    the x entries the shard's diagonals reach and the output.  Potts-300's
    shards are far taller than their diagonals' spread, so the small
    eq+ineq systems of :func:`eqineq_aligned` (not timed) add shards with
    window offsets outside ``(-w, rows_loc)``."""
    import numpy as np
    import scipy.sparse

    from pysparselp_tpu_torch.ops import dia_spmv
    from pysparselp_tpu_torch.parallel.sharded_cp import _csr_shard
    from pysparselp_tpu_torch.parallel.sharded_dia import build_system_dia

    potts, small = aligned_potts(lp), eqineq_aligned()
    cases = [("potts300_aligned", potts["a_ineq"], potts["b_ineq"]),
             ("eqineq_aligned_eq", small["a_eq"], small["beq"]),
             ("eqineq_aligned_ineq", small["a_ineq"], small["b_ineq"])]
    rng = np.random.RandomState(5)
    dev = torch.device("cuda")
    agg = {k: [] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    outside_small = 0
    for problem, a, b in cases:
        a = scipy.sparse.csr_matrix(a)
        timed = problem == "potts300_aligned"
        n = a.shape[1]
        for rank in range(MESH_RANKS):
            s, rows_loc, _ = build_system_dia(a, b, MESH_RANKS, rank)
            wlo = s["dia_wlo"]
            w = s["dia_vals_t"].shape[1]
            rows = _csr_shard(a, MESH_RANKS, rank)[0]
            spread = int(s["dia_offs"].max() - s["dia_offs"].min())
            sides = {
                "forward": (s["dia_vals"], s["dia_offs"], n, rows_loc, rows,
                            min(rows_loc + spread, n)),
                "window": (s["dia_vals_t"], s["dia_offs_t"], rows_loc, w,
                           rows[:, wlo:wlo + w].T.tocsr(), rows_loc),
            }
            for side, (vals_h, offs_h, n_in, n_out, host, x_needed) in \
                    sides.items():
                outside = int(np.sum((offs_h <= -n_out) | (offs_h >= n_in)))
                if not timed:
                    outside_small += outside
                offs = torch.as_tensor(offs_h, device=dev)
                for dt in (torch.float32, torch.float64):
                    name = str(dt).split(".")[1]
                    vals = torch.as_tensor(vals_h, dtype=dt, device=dev)
                    x = torch.as_tensor(rng.randn(n_in), dtype=dt,
                                        device=dev)

                    # the mesh solve's call: the shard's prepared operand
                    operand = dia_spmv.DiaOperand(vals, offs, n_out)

                    def kern(operand=operand, x=x):
                        return dia_spmv.dia_apply(operand, x)

                    def plain(vals=vals, x=x, n_out=n_out):
                        return dia_spmv.dia_spmv_reference(vals, offs, x,
                                                           n_out)

                    err = compare(torch, [kern()], [plain()], name,
                                  f"H-DIA (K5) {problem} shard {rank} {side}")
                    rec = dict(kernel="H-DIA (K5)", problem=problem,
                               ranks=MESH_RANKS, rank=rank, side=side,
                               dtype=name, shape=[n_out, n_in],
                               ndiag=int(offs_h.size),
                               offsets=offs_h.tolist(),
                               offsets_outside=outside, max_abs_err=err)
                    if timed and dt == torch.float32:
                        rec.update(timings(torch, kern, plain, 200))
                        lib = sparse_tensor(torch, host, dt, dev)
                        rec["library_ms"] = cuda_ms(
                            torch, lambda lib=lib, x=x: torch.mv(lib, x), 200)
                        rec["kernel_us"] = call_times(torch, kern)
                        rec["library_us"] = call_times(
                            torch, lambda lib=lib, x=x: torch.mv(lib, x))
                        nbytes = 4 * (vals.numel() + offs.numel() + x_needed
                                      + n_out)
                        rec["bound_ms"], rec["bound_by"] = bound(
                            nbytes, 2 * vals.numel())
                        for k in agg:
                            agg[k].append(rec[k])
                        table["H-DIA (K5)"]["bound_by"] = rec["bound_by"]
                    table["H-DIA (K5)"]["max_abs_err"] = max(
                        table["H-DIA (K5)"]["max_abs_err"], err)
                    emit("kernels", **rec)
    if not outside_small:
        raise AssertionError("no shard window offset fell outside its range")
    # the summary line: the mean per call over Potts-300's forward and
    # window calls (the mesh solve makes one of each per iteration)
    table["H-DIA (K5)"].update({k: float(np.mean(v)) for k, v in agg.items()})


def shard_system(lp, seed=7):
    """The aligned system of a Potts LP (the one the mesh solve with
    ``permute="align"`` shards) with a seeded start, and its position
    shard plan of MESH_RANKS ranks."""
    import numpy as np
    import torch

    from pysparselp_tpu_torch.parallel import sharded_cp_windowed as scw

    sys_ = aligned_potts(lp)
    rng = np.random.RandomState(seed)
    n, m = sys_["c"].size, sys_["a_ineq"].shape[0]
    m_eq = sys_["a_eq"].shape[0] if sys_["a_eq"] is not None else 0
    sys_ = dict(sys_, x0=rng.rand(n), x30=None, y_ineq0=rng.rand(m) * 0.1,
                y_eq0=rng.rand(m_eq) * 0.1 if m_eq else None)
    info = scw.position_shard_plan(sys_["a_eq"], sys_["a_ineq"], n, m_eq, m,
                                   MESH_RANKS, torch.float32)
    if info is None:
        raise AssertionError("the Potts LP did not plan the position shards")
    return sys_, info


def run_shards(torch, glob, ndev, dtype, nsteps, twin=False, wide=False,
               two_launch=False):
    """``nsteps`` iterations of H-CPDIA's shard entry (or its twin, or
    with ``two_launch`` the two-launch shard entry) on each of ``ndev``
    ranks' slices in this process, the halos copied between them by hand
    (``Mesh.halo_exchange``'s packets); the whole ``(x, x3, y_eq, y)`` from
    the interiors (no ``y_eq`` without equalities).  ``wide``: the slices'
    planes stored in float32, not as cut."""
    import functools

    from pysparselp_tpu_torch.ops import cp_dia
    from pysparselp_tpu_torch.parallel import sharded_cp_windowed as scw
    from pysparselp_tpu_torch.parallel.mesh import halo_pack, halo_unpack

    step = (cp_dia.cp_dia_shard_step_reference if twin
            else functools.partial(cp_dia.cp_dia_shard_step,
                                   two_launch=two_launch))
    ranks = [scw.place_position_shard(glob, ndev, r, dtype, "cuda")
             for r in range(ndev)]
    if wide:
        for d, _st in ranks:
            d["shard"] = dataclasses.replace(
                d["shard"], a_ineq=f32_planes(d["shard"].a_ineq),
                a_eq=f32_planes(d["shard"].a_eq))
    empty = torch.zeros(0, dtype=dtype, device="cuda")
    for _ in range(nsteps):
        items = [scw.state_halo_items(d, st) for d, st in ranks]
        packets = [halo_pack(i) for i in items]
        for r, it in enumerate(items):
            halo_unpack(it, packets[r - 1] if r else None,
                        packets[r + 1] if r + 1 < ndev else None)
        for d, st in ranks:
            step(d["shard"], d["pre"], st["x"], st["x3"],
                 st.get("y_eq", empty), st["y_ineq"], d["theta"])
    keys = (("x", glob["n"]), ("x3", glob["n"]), ("y_eq", glob["m_eq"]),
            ("y_ineq", glob["m"]))
    return [torch.cat([st[k][slice(*d["shard"].interior)]
                       for d, st in ranks])[:size]
            for k, size in keys if size]


def whole_problem(torch, glob, dtype):
    """The one-device problem, steps and start ``(x, y_eq, y)`` of
    ``glob`` (``y_eq`` empty without equalities)."""
    from pysparselp_tpu_torch.problem import DiaMatrix, LPProblem

    def vec(v):
        return torch.as_tensor(v, dtype=dtype, device="cuda")

    def dia(d, rows):
        return DiaMatrix.from_planes(d["vals"], d["offsets"], d["vals_t"],
                                     d["offsets_t"], rows, glob["n"], dtype,
                                     "cuda")

    has_eq = glob["dia_eq"] is not None
    prob = LPProblem(c=vec(glob["c"]), lb=vec(glob["lb"]),
                     ub=vec(glob["ub"]),
                     a_eq=dia(glob["dia_eq"], glob["m_eq"]) if has_eq
                     else None,
                     b_eq=vec(glob["beq"]) if has_eq else None,
                     a_ineq=dia(glob["dia"], glob["m"]), b_lower=None,
                     b_upper=vec(glob["b_ineq"]), n=glob["n"],
                     m_eq=glob["m_eq"], m_ineq=glob["m"])
    pre = dict(diag_t=vec(glob["diag_t"]), sigma_ineq=vec(glob["sigma_ineq"]))
    if has_eq:
        pre["sigma_eq"] = vec(glob["sigma_eq"])
    ye = (vec(glob["y_eq"]) if has_eq
          else torch.zeros(0, dtype=dtype, device="cuda"))
    return prob, pre, vec(glob["x"]), ye, vec(glob["y_ineq"])


def shard_bound(data, itemsize, l2_rates):
    """The least time of one shard entry call without sums, as ``dict(
    bound_ms, bound_by, bound_bytes, bound_rate)``.  Bytes: the Aᵀ planes
    over the primal range's columns and the A planes over the interior's
    rows; per column c, diag_t, lb, ub and x read, x and x3 written; y read
    once over the slice; per row b and sigma read, y written.  Only
    positions inside the problem count.  Back-to-back calls keep these
    bytes in L2 when they fit, so they are priced at the fastest L2 read
    rate this run measured (``l2_rates``, ``{MiB: bytes/s}``, from
    :func:`read_rates`) on a buffer at least as large, else at the HBM
    rate.  Operations: two a stored plane entry, and per column one add
    into d, T d, its subtraction, the clip's two, x3's three; per row the
    residual's subtraction, the product with sigma, the add, the max."""
    sh = data["shard"]
    (p0, p1), (i0, i1) = sh.primal, sh.interior

    def inside(a, b, size):
        return max(0, min(sh.g0 + b, size) - max(sh.g0 + a, 0))

    cols, rows = inside(p0, p1, sh.n), inside(i0, i1, sh.m)
    planes = (len(sh.a_ineq.offsets_t) * cols
              + len(sh.a_ineq.offsets) * rows)
    nbytes = (sh.a_ineq.vals.element_size() * planes
              + itemsize * (7 * cols + inside(0, sh.length, sh.m)
                            + 3 * rows))
    resident = [rate for mib, rate in l2_rates.items()
                if mib * 1024 * 1024 >= nbytes]
    rate = max(resident) if resident else HBM_BYTES_PER_S
    t_bytes = nbytes / rate * 1e3
    t_ops = (2 * planes + 8 * cols + 4 * rows) / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_rate=rate)


# the shard entry's check cases: (problem, ranks); Potts-300 (inequalities
# only) over the mesh solve's MESH_RANKS and as the one-rank solve's single
# shard (both halos outside the problem), the multi-label grid (eq + ineq:
# the equality taps and rows) over MESH_RANKS
SHARD_CASES = (("potts300", MESH_RANKS), ("potts300", 1),
               ("multilabel64", MESH_RANKS))


def phase_shard_kernels(torch, problems, table, l2_rates):
    """Phase 2 for H-CPDIA's shard entry (``cp_dia.cp_dia_shard_step``, K3
    per shard in the position-sharded mesh solve: one cooperative launch a
    call) on the aligned systems of SHARD_CASES: 100 iterations over the
    case's shards in this process, the halos copied by hand, one launch a
    call, bit-equal to the two-launch chunk entry on the whole system, to
    the two-launch shard entry and to float32 planes, and within RTOL of
    the twin on the same inputs, float32 and float64; then, in float32 on
    Potts-300, one call (one iteration) timed on the whole system as one
    shard (the one-rank mesh solve's shape) and on an inner quarter shard,
    in turns with the two-launch shard entry, by events, profiler device
    time and host time, beside the twin, the two-launch chunk per
    iteration and the bound (:func:`shard_bound`, at ``l2_rates``, phase
    2's L2 read rates by probe size)."""
    from pysparselp_tpu_torch.ops import cp_dia
    from pysparselp_tpu_torch.parallel import sharded_cp_windowed as scw

    systems = {}
    for key in sorted({k for k, _ in SHARD_CASES}):
        sys_, info = shard_system(problems[key])
        systems[key] = (scw.position_system(sys_, info), info)
    nsteps = 100
    for key, ndev in SHARD_CASES:
        glob, info = systems[key]
        timed = key == "potts300" and ndev == MESH_RANKS
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[1]
            before = cp_dia.cp_dia_shard_step.launches
            got = run_shards(torch, glob, ndev, dt, nsteps)
            launched = cp_dia.cp_dia_shard_step.launches - before
            if launched != ndev * nsteps * cp_dia.SHARD_LAUNCHES:
                raise AssertionError(f"H-CPDIA (shard) {key}: {launched} "
                                     f"launches for {ndev * nsteps} calls")
            prob, pre, x0, ye0, y0 = whole_problem(torch, glob, dt)
            out = cp_dia.cp_dia_chunk(prob, pre, x0, ye0, y0, nsteps, 1.0,
                                      plan=cp_dia.TWO_LAUNCH)
            want = [out[0], out[1]] + ([out[2]] if glob["m_eq"] else []) \
                + [out[3]]
            same = all(torch.equal(torch.isnan(g), torch.isnan(w))
                       and torch.equal(g[~torch.isnan(g)], w[~torch.isnan(w)])
                       and torch.equal(torch.signbit(g), torch.signbit(w))
                       for g, w in zip(got, want))
            same_two = same_bits(torch, got, run_shards(
                torch, glob, ndev, dt, nsteps, two_launch=True))
            twin = run_shards(torch, glob, ndev, dt, nsteps, twin=True)
            err = compare(torch, got, twin, name,
                          f"H-CPDIA (shard) {key} over {ndev}")
            rec = dict(kernel="H-CPDIA (shard)", problem=f"{key}_aligned",
                       dtype=name, ranks=ndev, nsteps=nsteps,
                       m_eq=glob["m_eq"], m_ineq=glob["m"],
                       plan=scw.shard_width(info["plan"], ndev),
                       planes=str(glob["dia"]["plane_dtype"]).split(".")[1]
                       if dt == torch.float32 else name,
                       bit_equal_to_chunk=same,
                       bit_equal_to_two_launch_entry=same_two,
                       launches_per_call=launched / (ndev * nsteps),
                       max_abs_err=err)
            same = same and same_two
            if dt == torch.float32:
                # the slices' bfloat16 planes against float32 planes
                same = same and same_bits(torch, got, run_shards(
                    torch, glob, ndev, dt, nsteps, wide=True))
                rec["bit_equal_f32_planes"] = same
            table["H-CPDIA (shard)"]["max_abs_err"] = max(
                table["H-CPDIA (shard)"]["max_abs_err"], err)
            if not same:
                emit("kernels", **rec)
                raise AssertionError(f"H-CPDIA (shard) {key} over {ndev} "
                                     f"shards ({name}) differs from the "
                                     "chunk entry, the two-launch shard "
                                     "entry or float32 planes")
            if timed and dt == torch.float32:
                shard_times(torch, glob, rec, x0, l2_rates)
                rec["chunk_ms_per_iteration"] = cuda_ms(
                    torch, lambda: cp_dia.cp_dia_chunk(
                        prob, pre, x0, ye0, y0, nsteps, 1.0,
                        plan=cp_dia.TWO_LAUNCH), 3) / nsteps
                whole, quarter = rec["whole"], rec["quarter"]
                table["H-CPDIA (shard)"].update(
                    ms=whole["ms"], plain_ms=whole["plain_ms"],
                    bound_ms=whole["bound_ms"], bound_by=whole["bound_by"],
                    two_launch_ms=whole["pair_ms"]["two_launch"],
                    quarter_ms=quarter["ms"],
                    quarter_bound_ms=quarter["bound_ms"],
                    quarter_two_launch_ms=quarter["pair_ms"]["two_launch"])
            emit("kernels", **rec)


def shard_times(torch, glob, rec, x0, l2_rates):
    """Time one shard entry call (float32) on the whole system as one
    shard and on an inner quarter shard into ``rec``: its call times, and
    CUDA events in turns with the two-launch shard entry (two_launch,
    one-launch, one-launch, two_launch), each on its own copy of the
    state; the one-launch entry writes the rank's outgoing packet, as the
    mesh solve calls it on more than one rank."""
    from pysparselp_tpu_torch.ops import cp_dia
    from pysparselp_tpu_torch.parallel import sharded_cp_windowed as scw

    dt = torch.float32
    for shard, ndev, rank in (("whole", 1, 0), ("quarter", MESH_RANKS, 1)):
        data, st = scw.place_position_shard(glob, ndev, rank, dt, "cuda")
        sh, empty = data["shard"], x0.new_zeros(0)
        tw = {k: v.clone() for k, v in st.items()}
        old = {k: v.clone() for k, v in st.items()}
        packet = torch.empty(sh.packet_size, dtype=dt, device="cuda")

        # the mesh solve's call: the stepper, checked once
        kern = cp_dia.cp_dia_shard_stepper(
            sh, data["pre"], st["x"], st["x3"], empty, st["y_ineq"], 1.0,
            packet=packet if ndev > 1 else None)
        two = cp_dia.cp_dia_shard_stepper(
            sh, data["pre"], old["x"], old["x3"], empty, old["y_ineq"], 1.0,
            two_launch=True)

        def plain(sh=sh, data=data, tw=tw):
            cp_dia.cp_dia_shard_step_reference(
                sh, data["pre"], tw["x"], tw["x3"], empty, tw["y_ineq"], 1.0)

        times = timings(torch, kern, plain, 200)
        times.update(call_times(torch, kern))
        names = times["kernel_names"]
        if (round(times["kernels_per_call"]) != 1 or len(names) != 1
                or "cp_dia_shard_grid_kernel" not in names[0]):
            raise AssertionError(f"H-CPDIA (shard) {shard}: not one kernel "
                                 f"a call: {times}")
        # events only for the reference: every profiler capture of the
        # script risks a lossy one (traced), so it takes no more of them
        pair = [cuda_ms(torch, f, 200) for f in (two, kern, kern, two)]
        plan = cp_dia.shard_plan(sh)
        rec[shard] = dict(times, positions=sh.length,
                          interior=list(sh.interior), primal=list(sh.primal),
                          ctas=plan.ctas, threads=plan.threads,
                          width=plan.width, packet=ndev > 1,
                          pair_ms=dict(one_launch=(pair[1] + pair[2]) / 2,
                                       two_launch=(pair[0] + pair[3]) / 2))
        rec[shard].update(shard_bound(data, 4, l2_rates))


class one_rank_group:
    """A one-rank ``torch.distributed`` group in this process (``backend``,
    a ``file://`` rendezvous in a temporary directory) and the port's mesh
    over it on ``device``; the group is destroyed on exit."""

    def __init__(self, backend, device="cuda"):
        self.backend, self.device = backend, device

    def __enter__(self):
        import os
        import tempfile

        import torch.distributed as dist

        from pysparselp_tpu_torch.parallel.mesh import default_mesh

        self.tmp = tempfile.TemporaryDirectory(prefix="pslp_mesh_")
        dist.init_process_group(
            self.backend,
            init_method="file://" + os.path.join(self.tmp.name, "rendezvous"),
            world_size=1, rank=0)
        return default_mesh(self.device)

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        self.tmp.cleanup()
        return False


def allreduces(calls):
    """A mesh's ``calls`` counter as ``{"op[numel]": count}``."""
    return {f"{op}[{numel}]": v for (op, numel), v in sorted(calls.items())}


def collectives(calls):
    """A mesh's ``calls`` counter by kind: halo exchanges, scalar
    all-reduces (at most 6 entries: the packed checkpoint and restart
    scalars), vector all-reduces (more) and all-gathers."""
    out = {"halo": 0, "scalar_allreduces": 0, "vector_allreduces": 0,
           "gather": 0}
    for (op, numel), v in calls.items():
        if op in ("halo", "gather"):
            out[op] += v
        else:
            out["scalar_allreduces" if numel <= 6
                else "vector_allreduces"] += v
    return out


def phase_mesh1(torch, lp, want, counted_solve):
    """``main_path_mesh1``: Potts-300, float32, 2,000 ``light_metrics``
    iterations with a checkpoint every 1,000, on one device and then with
    ``mesh=`` a one-rank NCCL group on the card (in this process), as
    ``bench.py::measure_sharded_overhead`` compares them.  The float32
    aligned system takes the position-sharded regime, as in the JAX
    package.  The mesh solve's checkpoints are held against the port's
    float64 CPU run (``want``), its launches and collectives against the
    prediction.  Then ``main_path_mesh1_rows``: the same LP in float64,
    1,000 iterations, which both packages send to the row-sharded path
    (H-DIA with shard offsets, K5's function), its checkpoint held against
    ``want`` and its launches and all-reduces against the prediction.
    Returns the two mesh solves' launch counts."""
    import numpy as np

    from pysparselp_tpu_torch.ops import cp_dia
    from pysparselp_tpu_torch.parallel import sharded_cp
    from pysparselp_tpu_torch.parallel.mesh import HaloRoute

    run = dict(method="chambolle_pock_ppd", nb_iter=2000, nb_iter_plot=1000,
               light_metrics=True, dtype=np.float32, device="cuda")
    rows_run = dict(run, nb_iter=1000, dtype=np.float64)
    with one_rank_group("nccl") as mesh:
        wall_1, n_1 = counted_solve(lp, **run)
        its_1 = steady_rate(lp)
        mesh.calls.clear()
        HaloRoute.launches = 0
        wall_m, n_m = counted_solve(lp, mesh=mesh, **run)
        its_m = steady_rate(lp)
        calls = dict(mesh.calls)
        placed = HaloRoute.launches
        got = curves(lp)
        itrn = list(lp.itrn_curve)
        info = dict(sharded_cp.last_run_info)
        mesh.calls.clear()
        wall_r, n_r = counted_solve(lp, mesh=mesh, **rows_run)
        calls_r = dict(mesh.calls)
        got_r = curves(lp)
        itrn_r = list(lp.itrn_curve)
        info_r = dict(sharded_cp.last_run_info)
    if itrn != [1000, 2000]:
        raise AssertionError(f"mesh1 checkpoints {itrn}")
    worst = checkpoint_diffs(got, want)
    # per iteration one shard entry call (one launch) and no collective
    # and no halo placement on one rank; per checkpoint four interior
    # products (Aᵀ y over the primal range, A x, A x4, A round(x)), one
    # psum and one pmax of packed scalars
    predicted = {"H-CPDIA (shard)": cp_dia.SHARD_LAUNCHES * 2000,
                 "H-CPDIA": 0, "H-CPDIA-G": 0, "H-DIA": 4 * 2,
                 "halo placements": 0,
                 "halo": 0, "vector_allreduces": 0,
                 "scalar_allreduces": 2 * 2, "gather": 0}
    counted = dict(collectives(calls), **{
        k: n_m[k] for k in ("H-CPDIA (shard)", "H-CPDIA", "H-CPDIA-G",
                            "H-DIA")}, **{"halo placements": placed})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    emit("main_path_mesh1", n=lp.nb_variables,
         regime=info["regime"],
         tier="shard entry (one cooperative launch a call)",
         planes=info["planes"], backend="nccl", ranks=1,
         positions=info["positions"],
         positions_per_rank=info["positions_per_rank"],
         x_halo=info["x_halo"], y_halo=info["y_halo"],
         single_iters_per_s_steady=its_1, mesh1_iters_per_s_steady=its_m,
         mesh1_over_single=its_m / its_1, overhead_frac=1.0 - its_m / its_1,
         single_wall_s=wall_1, mesh1_wall_s=wall_m,
         presolve_s=info["presolve_s"], build_s=info["build_s"],
         single_launches=n_1, launches=n_m, allreduces=allreduces(calls),
         counted=counted, predicted=predicted,
         per_iteration={"H-CPDIA (shard)": n_m["H-CPDIA (shard)"] / 2000,
                        "launches": (n_m["H-CPDIA (shard)"] + placed)
                        / 2000,
                        "collectives": (sum(calls.values())
                                        - predicted["scalar_allreduces"])
                        / 2000},
         itrn=itrn, f32_mesh1=got, f64_cpu=want, worst_rel_diff=worst,
         rel_limit=MAIN_RTOL, nvidia_smi=smi)
    if info["regime"] != "position-sharded":
        raise AssertionError(f"mesh1 ran {info['regime']}")
    if not all(v <= MAIN_RTOL for v in worst.values()):
        raise AssertionError(f"Potts-300 mesh1 f32 vs f64 CPU: {worst}")
    if counted != predicted:
        raise AssertionError(f"mesh1 counted {counted}, predicted {predicted}")

    if itrn_r != [1000]:
        raise AssertionError(f"mesh1 rows checkpoints {itrn_r}")
    worst_r = checkpoint_diffs(got_r, want)
    # per iteration one rmatvec (the window) and one matvec per shard, and
    # four products at the checkpoint; one n-vector all-reduce per
    # iteration and one at the checkpoint, whose scalars are packed into
    # one sum and one max
    predicted_r = {"H-DIA": 2 * 1000 + 4, "H-CPDIA (shard)": 0,
                   "halo": 0, "vector_allreduces": 1000 + 1,
                   "scalar_allreduces": 2, "gather": 0}
    counted_r = dict(collectives(calls_r), **{
        k: n_r[k] for k in ("H-DIA", "H-CPDIA (shard)")})
    emit("main_path_mesh1_rows", n=lp.nb_variables, dtype="float64",
         regime=info_r["regime"], backend="nccl", ranks=1,
         rows_loc=info_r["rows_loc"], wall_s=wall_r,
         iters_per_s=1000 / wall_r, launches=n_r,
         allreduces=allreduces(calls_r), counted=counted_r,
         predicted=predicted_r, itrn=itrn_r, f64_mesh1=got_r, f64_cpu=want,
         worst_rel_diff=worst_r, rel_limit=MAIN_RTOL)
    if info_r["regime"] != "row-sharded-dia":
        raise AssertionError(f"mesh1 float64 ran {info_r['regime']}")
    if not all(v <= MAIN_RTOL for v in worst_r.values()):
        raise AssertionError(f"Potts-300 mesh1 f64 vs f64 CPU: {worst_r}")
    if counted_r != predicted_r:
        raise AssertionError(f"mesh1 rows counted {counted_r}, predicted "
                             f"{predicted_r}")
    return n_m, n_r


MESH4_RUN = dict(method="chambolle_pock_ppd", nb_iter=200, nb_iter_plot=100,
                 dtype="float32", device="cuda")
# each case's settings over MESH4_RUN's; Potts-300 in float64 keeps the
# row-sharded DIA path (H-DIA with shard offsets, K5's function) on
# MESH_RANKS ranks, as both packages route float64
MESH4_CASES = {"potts300": dict(permute="align"),
               "potts300_f64": dict(permute="align", dtype="float64"),
               "multilabel64": dict(permute="align"),
               "unstructured": dict(permute=False)}
# what each MESH4_CASES solve runs: the regime and its kernel
MESH4_REGIME = {"potts300": ("position-sharded", "H-CPDIA (shard)"),
                "potts300_f64": ("row-sharded-dia", "H-DIA"),
                "multilabel64": ("position-sharded", "H-CPDIA (shard)"),
                "unstructured": ("row-sharded-csr", "H-CSR")}


def mesh4_run(name):
    return dict(MESH4_RUN, **MESH4_CASES[name])


def mesh4_lp(name):
    from pysparselp_tpu_torch.examples.potts import (
        build_linear_program, build_multilabel_linear_program)

    if name.startswith("potts300"):
        return build_linear_program(300, 0.5, 500)[0]
    if name == "multilabel64":
        return build_multilabel_linear_program(64, 4)[0]
    return unstructured_lp()


# the other mesh methods at small sizes, float64: (LP, run), each solved on
# MESH_RANKS gloo ranks and on one, and held to the one-rank solve within
# MESH4_SMALL_TOL (max |x - x_1| relative to max(1, max |x_1|); 0 is bit
# for bit) and, for DGA, its one-iteration dual objective to 1e-12
MESH4_SMALL = {
    "mehrotra": ("sc105", dict(method="mehrotra", nb_iter=30,
                               nb_iter_plot=1)),
    "admm": ("random", dict(method="admm", nb_iter=200, nb_iter_plot=100)),
    "admm2": ("random", dict(method="admm2", nb_iter=100, nb_iter_plot=50)),
    "dual_gradient_ascent": ("potts20", dict(method="dual_gradient_ascent",
                                             nb_iter=1, nb_iter_plot=1)),
    "dual_coordinate_ascent": ("potts20", dict(
        method="dual_coordinate_ascent", nb_iter=3, nb_iter_plot=1)),
    "admm_blocks": ("potts20", dict(method="admm_blocks", nb_iter=200,
                                    nb_iter_plot=100)),
}
MESH4_SMALL_TOL = {"mehrotra": 1e-8, "admm": 1e-9, "admm2": 1e-9,
                   "dual_gradient_ascent": None, "dual_coordinate_ascent": 0.0,
                   "admm_blocks": 1e-10}


def small_lp(name):
    if name == "sc105":
        return sc105_lp()[0]
    if name == "random":
        from pysparselp_tpu_torch.utils.random_lp import generate_random_lp

        return generate_random_lp(**RANDOM_LP)[0]
    from pysparselp_tpu_torch.examples.potts import build_linear_program

    return build_linear_program(20, 0.5, 500, seed=1)[0]


def mesh_small_solves(mesh):
    """Each MESH4_SMALL solve on ``mesh`` (float64 on its device): x, the
    dual curve and the all-reduces by kind."""
    import numpy as np

    out = {}
    for name, (lp_name, run) in MESH4_SMALL.items():
        lp = small_lp(lp_name)
        mesh.calls.clear()
        t0 = time.perf_counter()
        x, _ = lp.solve(mesh=mesh, dtype=np.float64,
                        device=mesh.device.type, **run)
        out[name] = dict(x=x, dobj=[float(v) for v in lp.dobj_curve],
                         allreduces=allreduces(mesh.calls),
                         seconds=time.perf_counter() - t0)
    return out


def mesh4_rank(mesh, names):
    """One rank of ``main_path_mesh4``: each named LP built here, then
    ``lp.solve(mesh=mesh)``; returns, from rank 0, the checkpoints, the
    steady rate, what the solve ran, its launches and all-reduces, and
    every rank's host seconds (gathered with one psum); then the
    MESH4_SMALL solves (:func:`mesh_small_solves`) under ``"small"``."""
    import numpy as np
    import torch

    from pysparselp_tpu_torch.ops import cp_dia, csr_spmv, dia_spmv
    from pysparselp_tpu_torch.parallel import sharded_cp
    from pysparselp_tpu_torch.parallel.mesh import HaloRoute

    torch.set_num_threads(2)
    out = {}
    for name in names:
        t0 = time.perf_counter()
        lp = mesh4_lp(name)
        model_s = time.perf_counter() - t0
        for fn in (dia_spmv.dia_spmv, csr_spmv.csr_spmv,
                   cp_dia.cp_dia_shard_step, HaloRoute):
            fn.launches = 0
        mesh.calls.clear()
        t0 = time.perf_counter()
        lp.solve(mesh=mesh, **mesh4_run(name))
        wall = time.perf_counter() - t0
        info = dict(sharded_cp.last_run_info)
        calls = dict(mesh.calls)
        mine = torch.zeros((mesh.size, 4), dtype=torch.float64,
                           device=mesh.device)
        mine[mesh.rank] = torch.tensor(
            [model_s, info["presolve_s"], info["build_s"], wall],
            dtype=torch.float64)
        per_rank = mesh.psum(mine).cpu().numpy()
        out[name] = dict(
            curves=curves(lp), itrn=list(lp.itrn_curve),
            iters_per_s_steady=steady_rate(lp), info=info,
            launches={"H-DIA": dia_spmv.dia_spmv.launches,
                      "H-CSR": csr_spmv.csr_spmv.launches,
                      "H-CPDIA (shard)": cp_dia.cp_dia_shard_step.launches,
                      "halo placements": HaloRoute.launches},
            allreduces=allreduces(calls), collectives=collectives(calls),
            host_s_per_rank={k: per_rank[:, i].tolist() for i, k in
                             enumerate(("model", "presolve", "build",
                                        "solve_wall"))})
    t0 = time.perf_counter()
    out["small"] = mesh_small_solves(mesh)
    out["small_s"] = time.perf_counter() - t0
    return out


def phase_mesh4(torch):
    """``main_path_mesh4``: MESH_RANKS gloo ranks on the one card (CUDA
    tensors, all-reduces staged through the host by gloo), each solving
    the MESH4_CASES for 200 iterations: Potts-300 and the multi-label grid
    (``permute="align"``) position-sharded in float32, Potts-300 in
    float64 row-sharded on DIA (K5's function with nonzero shard offsets),
    the unstructured LP (``permute=False``: H-CSR per shard); each run's
    checkpoints held against the same solve on one device within
    MAIN_RTOL, its launches and collectives against the prediction.
    Returns each case's launch counts (rank 0)."""
    from pysparselp_tpu_torch.parallel.mesh import spawn

    import numpy as np

    t0 = time.perf_counter()
    ranks = spawn(mesh4_rank, MESH_RANKS, "gloo", "cuda", list(MESH4_CASES))
    spawn_s = time.perf_counter() - t0
    small, small_s = ranks.pop("small"), ranks.pop("small_s")
    for name, got in ranks.items():
        lp = mesh4_lp(name)
        lp.solve(**mesh4_run(name))
        want = curves(lp)
        if got["itrn"] != list(lp.itrn_curve):
            raise AssertionError(f"mesh4 {name}: checkpoints {got['itrn']} "
                                 f"vs {lp.itrn_curve}")
        worst = checkpoint_diffs(got["curves"], want)
        regime, kernel = MESH4_REGIME[name]
        if regime == "position-sharded":
            # per iteration one halo exchange (one all-gather of the packet
            # the entry wrote, one launch placing the halos) and one shard
            # entry call (one launch); per checkpoint one more exchange,
            # four interior products per system, one psum and one pmax,
            # and an all-gather of x for the recording callback (it wants
            # the solution), one more at the end
            systems = 2 if name == "multilabel64" else 1
            predicted = {kernel: 200, "halo placements": 200,
                         "H-DIA": 4 * systems * 2,
                         "halo": 200 + 2, "vector_allreduces": 0,
                         "scalar_allreduces": 2 * 2, "gather": 2 + 1}
        else:
            # per iteration one product pair and one n-vector all-reduce;
            # per checkpoint four products and one n-vector all-reduce,
            # its scalars packed into one sum and one max
            predicted = {kernel: 2 * 200 + 4 * 2, "halo": 0,
                         "halo placements": 0,
                         "vector_allreduces": 200 + 2,
                         "scalar_allreduces": 2 * 2, "gather": 0}
        counted = dict(got["collectives"],
                       **{k: got["launches"][k] for k in predicted
                          if k in got["launches"]})
        # an iteration's launches and collectives (the checkpoints' apart)
        per_iteration = dict(
            launches=(got["launches"]["H-CPDIA (shard)"]
                      + got["launches"]["halo placements"]) / 200
            if regime == "position-sharded" else None,
            collectives=(got["collectives"]["halo"] - 2) / 200
            if regime == "position-sharded"
            else (got["collectives"]["vector_allreduces"] - 2) / 200)
        emit("main_path_mesh4", problem=name, ranks=MESH_RANKS,
             backend="gloo", device="cuda (one card, every rank)",
             note="collectives go through host memory (gloo's staging of "
                  "CUDA tensors): a transport-bound rate, not a multi-GPU "
                  "figure",
             regime=got["info"]["regime"],
             shard={k: got["info"].get(k) for k in (
                 "rows_loc", "positions_per_rank", "x_halo", "y_halo")},
             host_s_per_rank=got["host_s_per_rank"], spawn_wall_s=spawn_s,
             iters_per_s_steady=got["iters_per_s_steady"],
             single_device_iters_per_s_steady=steady_rate(lp),
             launches_rank0=got["launches"], counted=counted,
             predicted=predicted, per_iteration=per_iteration,
             allreduces_rank0=got["allreduces"],
             dtype=mesh4_run(name)["dtype"], itrn=got["itrn"],
             mesh4=got["curves"], single_device=want, worst_rel_diff=worst,
             rel_limit=MAIN_RTOL)
        if got["info"]["regime"] != regime:
            raise AssertionError(f"mesh4 {name} ran {got['info']['regime']}")
        if not all(v <= MAIN_RTOL for v in worst.values()):
            raise AssertionError(f"mesh4 {name} vs one device: {worst}")
        if counted != predicted:
            raise AssertionError(f"mesh4 {name}: counted {counted}, "
                                 f"predicted {predicted}")
    # the other methods: MESH_RANKS ranks against one (gloo, this process)
    t0 = time.perf_counter()
    with one_rank_group("gloo") as mesh:
        one = mesh_small_solves(mesh)
    one_s = time.perf_counter() - t0
    rec, bad = {}, []
    for name, got in small.items():
        want = one[name]
        scale = max(1.0, float(np.max(np.abs(want["x"]))))
        diff = float(np.max(np.abs(got["x"] - want["x"]))) / scale
        tol = MESH4_SMALL_TOL[name]
        if tol is None:
            dobj_rel = abs(got["dobj"][-1] - want["dobj"][-1]) / abs(
                want["dobj"][-1])
            ok = dobj_rel <= 1e-12
        else:
            dobj_rel = None
            ok = diff <= tol
        rec[name] = dict(lp=MESH4_SMALL[name][0], x_rel_diff=diff,
                         limit=tol, dobj_rel_diff=dobj_rel,
                         bit_equal=diff == 0.0, seconds=got["seconds"],
                         allreduces_rank0=got["allreduces"],
                         allreduces_one_rank=want["allreduces"])
        if not ok:
            bad.append(name)
    emit("main_path_mesh4_methods", ranks=MESH_RANKS, backend="gloo",
         device="cuda (one card, every rank)", dtype="float64",
         methods=rec, mesh4_s=small_s, one_rank_s=one_s)
    if bad:
        raise AssertionError(f"mesh4: {bad} differ from the one-rank "
                             "solve past their limits")
    return {name: got["launches"] for name, got in ranks.items()}


# ----------------------------------------------------------------------
# the interior point and ADMM solvers (mehrotra, admm, admm2)
# ----------------------------------------------------------------------

# the JAX package's Mehrotra on Potts-300 on the CPU in float64
# (scripts/jax_mehrotra_potts.py): 17 IPM iterations on the CG path, mean
# |x - graph cut| 5.548e-4; the card's float64 run is held to the larger
# of 1e-2 and ten times that
JAX_POTTS300_DIST = 0.0005548461760370359
POTTS300_DIST_LIMIT = max(1e-2, 10 * JAX_POTTS300_DIST)
# the card's float64 interior point against the port's float64 CPU run:
# x, y, s within this, relative to the largest entry
MEHROTRA_RTOL = 1e-8
# the vendored netlib problems: the objective within NETLIB_OBJ_RTOL of the
# perPlex optimum's, and mean |x - x*| < 1e-5 where x* is the only optimum
# (AFIRO's optimal face holds other points and KB2 ends 1.6e-5 from x*, in
# the JAX package as in the port)
NETLIB = ("SC105", "AFIRO", "KB2", "SC50A", "SC50B")
NETLIB_UNIQUE = ("SC105", "SC50A", "SC50B")
NETLIB_OBJ_RTOL = 1e-7
# the reference's k-medians clustering cost (tests/test_examples.py:13-19)
KMEDIANS_COST = 238.9849948936172
# bench.py's k-medians LP under ADMM on the card: the timed float32
# iterations, the iterations held against the float64 CPU run and the
# dtype of the card run held.  admm2 takes the CG Schur path there (155,001
# rows > 4,096): up to 100 CG steps an iteration, so fewer of them; its
# float32 CG solves the Schur system to float32's accuracy, which leaves
# the equality violation 1e-4 to 3e-4 from float64's (on the card and in a
# CPU float32 run alike), so its card run is held in float64 and its
# float32 distance is reported
ADMM_RUNS = {"admm": dict(nb_iter=2000, check_iter=200, held="float32"),
             "admm2": dict(nb_iter=200, check_iter=50, held="float64")}
# the H100's float64 rate outside the tensor cores (NVIDIA's data sheet)
F64_OPS_PER_S = 34e12


def mehrotra_slack(lp):
    """The standard form ``dispatch`` hands ``mpc_sol``: fixed variables
    removed, slack form; ``(a, b, c)``."""
    lp = copy.deepcopy(lp)
    lp.remove_fixed_variables()
    lp.convert_to_slack_form()
    return lp.a_equalities.tocsr(), lp.b_equalities, lp.costsvector


def admm_matrix(lp, method):
    """The host standard-form matrix ``lp_admm`` / ``lp_admm2`` lowers
    (default options), from the full LP as ``dispatch`` hands it."""
    from pysparselp_tpu_torch.solvers import _csr
    from pysparselp_tpu_torch.solvers.admm import admm2_system, admm_system

    a_eq, a_in = _csr(lp.a_equalities), _csr(lp.a_inequalities)
    system = admm_system if method == "admm" else admm2_system
    return system(lp.costsvector, a_eq,
                  lp.b_equalities if a_eq is not None else None, a_in,
                  lp.b_lower if a_in is not None else None,
                  lp.b_upper if a_in is not None else None,
                  lp.lower_bounds, lp.upper_bounds)[1]


def operator_products(op):
    """The products of a DIA, CSR or BSR operator (``sq_rowsum_weighted``
    run once before, which builds its squared operand): ``(side, kernel
    name, kernel, twin, |A| |x| of the twin, n_in, bytes, operations)`` for
    A x, Aᵀ y and ``sq`` (Σ_j a_ij² d_j); ``kernel``/``twin``/``scale``
    take x."""
    from pysparselp_tpu_torch.ops import bsr_spmv, csr_spmv, dia_spmv
    from pysparselp_tpu_torch.problem import BsrMatrix, CsrMatrix, DiaMatrix

    out = []
    if isinstance(op, DiaMatrix):
        for side, o, n_in in (("A", op.fwd, op.ncols), ("At", op.bwd,
                                                        op.nrows),
                              ("sq", op._sq, op.ncols)):
            ndiag = o.vals.shape[0]
            nbytes = (o.vals.numel() + n_in + o.n_out) * o.vals.element_size() \
                + 4 * ndiag
            out.append((side, "H-DIA", lambda x, o=o: dia_spmv.dia_apply(o, x),
                        lambda x, o=o: dia_spmv.dia_spmv_reference(
                            o.vals, o.offs, x, o.n_out),
                        lambda x, o=o: dia_spmv.dia_spmv_reference(
                            o.vals.abs(), o.offs, x.abs(), o.n_out),
                        n_in, nbytes, 2 * o.vals.numel()))
    elif isinstance(op, CsrMatrix):
        for side, o in (("A", op.csr), ("At", op.csr_t), ("sq", op._sq)):
            nnz = o.vals.numel()
            s = o.vals.element_size()
            nbytes = nnz * (s + 4) + (o.n_out + 1) * 4 + (o.n_out + o.n_in) * s
            out.append((side, "H-CSR", lambda x, o=o: csr_spmv.csr_spmv(o, x),
                        lambda x, o=o: csr_spmv.csr_spmv_reference(
                            o.indptr, o.indices, o.vals, x, o.n_out),
                        lambda x, o=o: csr_spmv.csr_spmv_reference(
                            o.indptr, o.indices, o.vals.abs(), x.abs(),
                            o.n_out),
                        o.n_in, nbytes, 2 * nnz))
    elif isinstance(op, BsrMatrix):
        for side, o, t in (("A", op.op, False), ("At", op.op, True),
                           ("sq", op._sq, False)):
            out.append((side, "H-BSR",
                        lambda x, o=o, t=t: bsr_spmv.bsr_spmv(o, x, t),
                        lambda x, o=o, t=t: bsr_spmv.bsr_spmv_reference(o, x,
                                                                         t),
                        lambda x, o=o, t=t: bsr_spmv.bsr_spmv_reference(
                            o.abs(), x.abs(), t),
                        o.nrows if t else o.ncols,
                        bsr_tile_bytes(o, t, o.tiles.element_size()),
                        2 * o.stored_entries))
    if not out:
        raise AssertionError(f"{type(op).__name__}: no hand kernel")
    return out


def phase_f64_kernels(torch, systems, table):
    """The products of the interior point and ADMM paths in float64 on the
    card: the operator of each of ``systems`` (``{name: host matrix or
    (host matrix, prefer)}``, lowered by ``ell_from_scipy``: DIA, CSR or
    BSR), A x, Aᵀ y and ``sq_rowsum_weighted`` (through the operator)
    against the twins per row within RTOL * (|A| |x|)_row, with the
    kernel's call times, its bound (bytes at the HBM rate) and cuSPARSE
    ``torch.mv`` in float64 on the same matrix."""
    import numpy as np

    from pysparselp_tpu_torch.problem import ell_from_scipy

    rng = np.random.RandomState(5)
    dev = torch.device("cuda")
    dt = torch.float64
    for key, spec in systems.items():
        host, prefer = spec if isinstance(spec, tuple) else (spec, None)
        t0 = time.perf_counter()
        op = ell_from_scipy(host, dt, dev, prefer=prefer)
        torch.cuda.synchronize()
        lower_s = time.perf_counter() - t0
        path = describe(op)
        d = torch.as_tensor(rng.rand(op.ncols) + 0.1, dtype=dt, device=dev)
        launches = sum(f.launches for f in kernel_counters().values())
        sq = op.sq_rowsum_weighted(d)
        products = operator_products(op)
        if sum(f.launches for f in kernel_counters().values()) != launches + 1:
            raise AssertionError(f"{key} {path}: sq_rowsum_weighted did not "
                                 "launch one hand kernel")
        for side, name, kern, twin, scale, n_in, nbytes, ops in products:
            x = d if side == "sq" else torch.as_tensor(
                rng.randn(n_in), dtype=dt, device=dev)
            got, want = kern(x), twin(x)
            if side == "sq" and not torch.equal(got, sq):
                raise AssertionError(f"{key} {path}: sq_rowsum_weighted "
                                     "differs from its operand's product")
            err = (got - want).abs()
            if not bool((err <= RTOL["float64"] * scale(x)).all()):
                raise AssertionError(
                    f"{name} {key} {path} {side} (float64): |kernel - "
                    f"twin| past {RTOL['float64']:.0e} * (|A||x|)_row, max "
                    f"{float(err.max()):.3e}")
            side_host = {"A": host, "At": host.T.tocsr(),
                         "sq": host.multiply(host).tocsr()}[side]
            lib = sparse_tensor(torch, side_host, dt, dev)
            rec = dict(kernel=name, system=key, lowered=path, side=side,
                       dtype="float64", shape=[int(got.numel()), n_in],
                       max_abs_err=float(err.max()), lower_s=lower_s,
                       kernel_us=call_times(torch, lambda: kern(x),
                                            reps=100, host_reps=200),
                       library_us=call_times(
                           torch, lambda: torch.mv(lib, x), reps=100,
                           host_reps=200),
                       bytes=nbytes)
            rec["bound_us"] = max(nbytes / HBM_BYTES_PER_S,
                                  ops / F64_OPS_PER_S) * 1e6
            rec["bound_share"] = rec["bound_us"] / rec["kernel_us"][
                "device_us"]
            emit("kernels_f64", **rec)
            entry = table[name]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       rec["max_abs_err"])
            entry.setdefault("float64", []).append(dict(
                system=key, side=side, device_us=rec["kernel_us"]["device_us"],
                bound_us=rec["bound_us"],
                library_device_us=rec["library_us"]["device_us"]))


def profile_window(torch, fn):
    """``fn()`` once under :func:`traced`: wall seconds (synchronized),
    device kernels launched, their device seconds, the busy share, and the
    device seconds of the ten kernel names that took most."""
    wall, dev = traced(torch, fn)
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.elapsed_us()
    device_s = sum(by_name.values()) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(wall_s=wall, kernels=len(dev), device_s=device_s,
                busy=device_s / wall,
                top_us={k[:60]: v for k, v in top})


def rel_diff(got, want):
    """max |got - want| over max |want| (numpy or tensors)."""
    import numpy as np

    got, want = (np.asarray(v.cpu() if hasattr(v, "cpu") else v,
                            np.float64) for v in (got, want))
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-300))


def phase_mehrotra_netlib(torch, counted_solve):
    """``main_path_mehrotra_netlib``: the vendored netlib problems through
    ``SparseLP.solve(method="mehrotra")`` in float64 on the card (the dense
    normal-equations path: ``torch.matmul`` and cuSOLVER's Cholesky, no
    hand kernel), 100 iterations: IPM iterations, wall seconds, x against
    the port's float64 CPU run, the objective and distance to the perPlex
    optimum; then one IPM iteration of SC105 under the profiler."""
    import numpy as np

    from pysparselp_tpu_torch.solvers import mehrotra as pm

    out = {}
    for name in NETLIB:
        lp, gt = netlib_lp(name)
        run = dict(method="mehrotra", nb_iter=100, nb_iter_plot=1,
                   dtype=np.float64)
        wall, launches = counted_solve(lp, device="cuda", **run)
        x = counted_solve.out[0]
        iters = len(lp.itrn_curve)
        x_cpu, _ = lp.solve(device="cpu", **run)
        opt = float(lp.costsvector @ gt)
        rec = dict(ipm_iterations=iters, cpu_ipm_iterations=len(lp.itrn_curve),
                   wall_s=wall, objective=float(lp.costsvector @ x),
                   optimum=opt,
                   objective_rel=abs(float(lp.costsvector @ x) - opt)
                   / abs(opt),
                   mean_dist=float(np.mean(np.abs(x - gt))),
                   rel_diff_cpu=rel_diff(x, x_cpu), launches=launches)
        out[name] = rec
        if not (rec["objective_rel"] <= NETLIB_OBJ_RTOL
                and rec["rel_diff_cpu"] <= MEHROTRA_RTOL
                and iters == rec["cpu_ipm_iterations"]
                and (name not in NETLIB_UNIQUE or rec["mean_dist"] < 1e-5)):
            emit("main_path_mehrotra_netlib", problems=out)
            raise AssertionError(f"mehrotra {name}: {rec}")
    a, b, c = mehrotra_slack(netlib_lp("SC105")[0])
    data, dense = pm.setup(a, b, c, torch.float64, "cuda")
    x, y, s = pm._initial_point(data, dense)
    theta = torch.tensor(0.9995, dtype=torch.float64, device="cuda")
    one = profile_window(torch, lambda: pm._ipm_iteration(
        data, x, y, s, theta, 1.0, dense))
    emit("main_path_mehrotra_netlib", problems=out,
         sc105_standard_form=list(a.shape), path="dense" if dense else "cg",
         sc105_one_ipm_iteration=one, obj_rtol=NETLIB_OBJ_RTOL,
         x_rtol=MEHROTRA_RTOL)


def phase_mehrotra_potts300(torch, counted_solve):
    """``main_path_mehrotra_potts300``: Potts-300 through
    ``SparseLP.solve(method="mehrotra")`` in float64 on the card, the CG
    path (its 358,800 inequality rows are the standard form's rows; the
    operator's products run a hand kernel), 100 iterations: the standard
    form and its lowering, the initial point and first IPM iteration held
    against the port's float64 CPU run (MEHROTRA_RTOL), IPM iterations,
    CG solves, steps and host reads of the stopping flag per IPM
    iteration, the host seconds before the first iteration, the wall time,
    the hand kernels' launches, the graph-cut distance (held to
    POTTS300_DIST_LIMIT), and one IPM iteration under the profiler."""
    import numpy as np

    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.ops.cg import conjgrad
    from pysparselp_tpu_torch.problem import BsrMatrix, CsrMatrix, DiaMatrix
    from pysparselp_tpu_torch.solvers import mehrotra as pm

    lp, gt, idx, _ = build_linear_program(300, 0.5, 500)
    t0 = time.perf_counter()
    a, b, c = mehrotra_slack(lp)
    slack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data, dense = pm.setup(a, b, c, torch.float64, "cuda")
    torch.cuda.synchronize()
    lower_s = time.perf_counter() - t0
    if dense:
        raise AssertionError("Potts-300 took the dense path")
    ell = data["ell"]
    # the first iteration on the card against the CPU twins
    theta = 0.9995
    first = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        dd = data if dev == "cuda" else pm.setup(a, b, c, torch.float64,
                                                 "cpu")[0]
        x0, y0, s0 = pm._initial_point(dd, False)
        x1, y1, s1, _m = pm._ipm_iteration(
            dd, x0, y0, s0, torch.tensor(theta, dtype=torch.float64,
                                         device=dev), 1.0, False)
        first[dev] = [v.cpu() for v in (x0, y0, s0, x1, y1, s1)]
        first[dev + "_s"] = time.perf_counter() - t0
    first_diff = {k: rel_diff(g, w) for k, g, w in zip(
        ("x0", "y0", "s0", "x1", "y1", "s1"), first["cuda"], first["cpu"])}
    # the solve
    conjgrad.calls = conjgrad.steps = conjgrad.syncs = 0
    wall, launches = counted_solve(lp, method="mehrotra", nb_iter=100,
                                   nb_iter_plot=1, dtype=np.float64,
                                   device="cuda")
    x = counted_solve.out[0]
    iters = len(lp.itrn_curve)
    cg = dict(calls=conjgrad.calls, steps=conjgrad.steps,
              syncs=conjgrad.syncs)
    dist = float(np.mean(np.abs(x[idx] - gt)))
    xs, ys, ss = pm._initial_point(data, False)
    conjgrad.steps = 0
    one = profile_window(torch, lambda: pm._ipm_iteration(
        data, xs, ys, ss, torch.tensor(theta, dtype=torch.float64,
                                       device="cuda"), 1.0, False))
    one["cg_steps"] = conjgrad.steps
    kinds = {"H-DIA": DiaMatrix, "H-CSR": CsrMatrix, "H-BSR": BsrMatrix}
    lowered_to = {k: count_ops(ell, kind) for k, kind in kinds.items()}
    emit("main_path_mehrotra_potts300", n=lp.nb_variables,
         standard_form=list(a.shape), nnz=int(a.nnz), lowered=describe(ell),
         slack_s=slack_s, lower_s=lower_s,
         first_checkpoint_s=lp.opttime_curve[0], first_iteration=first_diff,
         first_iteration_cuda_s=first["cuda_s"],
         first_iteration_cpu_s=first["cpu_s"], rel_limit=MEHROTRA_RTOL,
         ipm_iterations=iters, wall_s=wall, s_per_ipm_iteration=wall / iters,
         cg=cg, cg_steps_per_ipm_iteration=cg["steps"] / iters,
         host_reads_per_ipm_iteration=(cg["syncs"] + 2 * iters) / iters,
         mean_dist_graph_cut=dist, dist_limit=POTTS300_DIST_LIMIT,
         jax_cpu_dist=JAX_POTTS300_DIST, launches=launches,
         one_ipm_iteration=one)
    if not all(v <= MEHROTRA_RTOL for v in first_diff.values()):
        raise AssertionError(f"Potts-300 first IPM iteration, card vs CPU: "
                             f"{first_diff}")
    if not dist <= POTTS300_DIST_LIMIT:
        raise AssertionError(f"Potts-300 mehrotra ended {dist} from the "
                             f"graph cut (limit {POTTS300_DIST_LIMIT})")
    for key, count in lowered_to.items():
        if count and not launches[key]:
            raise AssertionError(f"Potts-300 mehrotra lowered to {key} and "
                                 "launched none")
    return launches


def phase_admm_kmedians(torch, counted_solve):
    """``main_path_admm_kmedians``: (1) the reference example,
    ``examples/kmedians.py::run(method="admm", nb_iter=1000)`` (500 points,
    50 candidates) in float64 on the card, its clustering cost against the
    reference's constant (within 1e-6); (2) ``bench.py``'s k-medians LP
    (5,000 x 30) under ``admm`` and ``admm2`` in float32 on the card
    (ADMM_RUNS): the standard form's lowering, the first checkpoints held
    against the port's float64 CPU run (NONGRID_RTOL, the rule of the
    non-grid workloads), the steady rate of three ``light_metrics`` runs
    (median and spread), the hand kernels' launches per iteration, and the
    launches and device time per iteration (the difference of a 40- and a
    20-iteration solve under the profiler), whose product with the steady
    rate is the busy share."""
    from unittest import mock

    import numpy as np

    from pysparselp_tpu_torch import SparseLP
    from pysparselp_tpu_torch.examples import kmedians
    from pysparselp_tpu_torch.problem import (BsrMatrix, CsrMatrix, DiaMatrix,
                                              ell_from_scipy)

    solve = SparseLP.solve

    def solve_f64(self, *args, **kw):
        return solve(self, *args, **{"dtype": np.float64, **kw})

    for fn in kernel_counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(SparseLP, "solve", solve_f64):
        cost = kmedians.run(method="admm", nb_iter=1000)
    example = dict(cost=cost, reference=KMEDIANS_COST,
                   wall_s=time.perf_counter() - t0,
                   launches={k: f.launches for k, f in kernel_counters().items()})
    if not abs(cost - KMEDIANS_COST) < 1e-6:
        emit("main_path_admm_kmedians", example=example)
        raise AssertionError(f"k-medians cost {cost} vs {KMEDIANS_COST}")

    lp = kmedians_lp()
    kinds = {"H-DIA": DiaMatrix, "H-CSR": CsrMatrix, "H-BSR": BsrMatrix}
    methods, total = {}, {}
    for method, cfg in ADMM_RUNS.items():
        host = admm_matrix(lp, method)
        op = ell_from_scipy(host, torch.float32, "cuda")
        lowered_to = {k: count_ops(op, kind) for k, kind in kinds.items()}
        check = dict(method=method, nb_iter=cfg["check_iter"],
                     nb_iter_plot=cfg["check_iter"] // 5)
        got = {}
        for dt in ("float32", "float64"):
            lp.solve(dtype=getattr(np, dt), device="cuda", **check)
            got[dt], itrn = curves(lp), list(lp.itrn_curve)
        t0 = time.perf_counter()
        lp.solve(dtype=np.float64, device="cpu", **check)
        cpu_wall = time.perf_counter() - t0
        want = curves(lp)
        if lp.itrn_curve != itrn:
            raise AssertionError(f"checkpoints {itrn} vs {lp.itrn_curve}")
        diffs = {dt: checkpoint_diffs(g, want) for dt, g in got.items()}
        worst = diffs[cfg["held"]]
        ONE_DEVICE[method] = dict(lp=lp, check=check, held=cfg["held"],
                                  f64_cpu=want, itrn=itrn,
                                  cuda=got[cfg["held"]])
        nb_iter = cfg["nb_iter"]
        runs, rates = [], []
        for _ in range(3):
            wall, launches = counted_solve(
                lp, method=method, nb_iter=nb_iter, nb_iter_plot=nb_iter // 2,
                light_metrics=True, dtype=np.float32, device="cuda")
            runs.append(dict(wall_s=wall, launches=launches))
            rates.append(steady_rate(lp))
        # per iteration on the device: two profiled solves of 20 and 40
        # iterations differ by 20 iterations and the same set-up
        windows = [profile_window(torch, lambda k=k: lp.solve(
            method=method, nb_iter=k, nb_iter_plot=k, light_metrics=True,
            dtype=np.float32, device="cuda")) for k in (20, 40)]
        per_iteration = dict(
            launches=(windows[1]["kernels"] - windows[0]["kernels"]) / 20,
            device_us=(windows[1]["device_s"] - windows[0]["device_s"])
            / 20 * 1e6, top_us_40=windows[1]["top_us"])
        per_iteration["busy"] = (per_iteration["device_us"] * 1e-6
                                 * sorted(rates)[1])
        launches = runs[-1]["launches"]
        ONE_DEVICE[method].update(
            timed=dict(method=method, nb_iter=nb_iter,
                       nb_iter_plot=nb_iter // 2, light_metrics=True,
                       dtype=np.float32, device="cuda"),
            iters_per_s_steady=sorted(rates)[1], launches=launches)
        methods[method] = dict(
            standard_form=list(host.shape), nnz=int(host.nnz),
            lowered=describe(op), values=value_storage(op), itrn=itrn,
            cuda=got, f64_cpu=want,
            rel_diff=diffs, held=cfg["held"], rel_limit=NONGRID_RTOL,
            cpu_wall_s=cpu_wall, nb_iter=nb_iter,
            iters_per_s_steady=sorted(rates)[1], iters_per_s_runs=rates,
            runs=runs,
            hand_launches_per_iteration={k: v / nb_iter
                                         for k, v in launches.items()},
            per_iteration=per_iteration)
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        if not all(v <= NONGRID_RTOL for v in worst.values()):
            emit("main_path_admm_kmedians", example=example, methods=methods)
            raise AssertionError(f"{method} {cfg['held']} CUDA vs f64 CPU: "
                                 f"{worst}")
        for key, count in lowered_to.items():
            if count and not launches[key]:
                raise AssertionError(f"{method} lowered to {key} and "
                                     "launched none")
    emit("main_path_admm_kmedians", example=example, methods=methods)
    return total


def phase_potts50(torch, counted_solve):
    """``main_path_potts50``: ``bench.py::measure_potts``'s steady run, the
    Potts-50 solve of 200,000 float32 iterations with ``light_metrics`` and
    checkpoints every 50,000 (one H-CPDIA-R launch each): the steady
    iterations/s from the first to the last checkpoint, the mean distance
    of x to the graph cut (< 1e-2), then the same solve once more under the
    profiler for the device's busy share.  Returns H-CPDIA-R's launches."""
    import numpy as np

    from pysparselp_tpu_torch.examples.potts import build_linear_program

    lp, gt, idx, _ = build_linear_program(50, 0.5, 500)
    run = dict(method="chambolle_pock_ppd", nb_iter=200_000,
               nb_iter_plot=50_000, dtype=np.float32, light_metrics=True,
               device="cuda")
    wall, launches = counted_solve(lp, **run)
    x = counted_solve.out[0]
    dist = float(np.mean(np.abs(gt - x[idx])))
    rate = steady_rate(lp)
    window = profile_window(torch, lambda: lp.solve(**run))
    emit("main_path_potts50", n=lp.nb_variables, iterations=200_000,
         **dia_tier(lp, torch.float32), wall_s=wall,
         iters_per_s_steady=rate,
         us_per_iteration_steady=1e6 / rate, dist=dist, launches=launches,
         profiled=window)
    if not dist < 1e-2:
        raise AssertionError(f"Potts-50 steady run: dist {dist} (need "
                             "< 1e-2)")
    if (not launches["H-CPDIA-R"] or launches["H-CPDIA"]
            or launches["H-CPDIA-G"]):
        raise AssertionError(f"Potts-50 steady run did not run on "
                             f"H-CPDIA-R alone: {launches}")
    return launches["H-CPDIA-R"]



# ----------------------------------------------------------------------
# the dual ascent solvers and admm_blocks: H-DCA and the main paths
# ----------------------------------------------------------------------

# DGA and DCA on the card against the same solve on the CPU, both float64,
# at every checkpoint (checkpoint_diffs): the card's products add in other
# orders (H-CSR, H-DIA), and the solvers compare reduced costs exactly
# (c̄ > 0, c̄ == 0); the limit is stated beside the measured worst in
# PERF.md
DUAL_F64_RTOL = 1e-9
# the bipartite matching LP of examples/bipartite_matching.py: its DCA cost
# on the card (float64) against the CPU run's
MATCHING_COST_RTOL = 1e-9
# the L1-SVM example's admm_blocks accuracy bar (tests/test_examples.py)
L1SVM_ACCURACY = 99.7


def dca_systems():
    """The systems of the kernel phase, as the DCA solver holds them after
    ``convert_to_one_sided_inequality_system``: ``{name: (a, b, c, lb,
    ub)}`` (host arrays)."""
    import copy as copy_

    import numpy as np

    from pysparselp_tpu_torch.examples.bipartite_matching import \
        add_bipartite_constraint
    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.modeling import SparseLP

    lps = {"sc105": sc105_lp()[0],
           "potts20": build_linear_program(20, 0.5, 500, seed=1)[0],
           "potts50": build_linear_program(50, 0.5, 500, seed=1)[0]}
    rng = np.random.RandomState(2)
    cost = -rng.rand(50, 50)
    lp = SparseLP()
    add_bipartite_constraint(lp, lp.add_variables_array(cost.shape, 0, 1,
                                                        cost))
    lps["matching50"] = lp
    out = {}
    for name, lp in lps.items():
        lp = copy_.deepcopy(lp)
        lp.convert_to_one_sided_inequality_system()
        for which, a, b in (("eq", lp.a_equalities, lp.b_equalities),
                            ("ineq", lp.a_inequalities, lp.b_upper)):
            if a is not None and a.shape[0]:
                out[f"{name}_{which}"] = (a.tocsr(), np.asarray(b),
                                          lp.costsvector, lp.lower_bounds,
                                          lp.upper_bounds)
    return out


def dca_state(torch, system, dtype, seed=0, rows=None):
    """A seeded mid-solve state of ``system``: y >= 0 (half of it 0),
    c̄ = c + Aᵀ y, 80% of the rows active; the padded rows (the first
    ``rows`` rows only, when given) and every vector as ``dtype`` tensors
    on the card, in the sweep's argument order."""
    import numpy as np

    from pysparselp_tpu_torch.ops.dca_sweep import EllRows

    a, b, c, lb, ub = system
    if rows is not None:
        a, b = a[:rows], b[:rows]
    rng = np.random.RandomState(seed)
    m = a.shape[0]
    y = np.where(rng.rand(m) < 0.5, 0.0, rng.rand(m))

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device="cuda")

    return (EllRows.from_scipy(a, dtype, "cuda"), t(b),
            torch.as_tensor(rng.rand(m) < 0.8, device="cuda"), t(y),
            t(c + a.T @ y), t(lb), t(ub))


# H-DCA's least time is the largest of three (dca_bound): its bytes; its
# levels, one after another, each at least an L2 round trip for c̄ (taken
# as 200 cycles; 30 where c̄ is in shared memory), the row's dependent
# arithmetic (40: a division, the compares, the scans and the search of a
# short row) and a block barrier (20); and its key chain, m threefry-2x32
# links one after another, each 45 dependent integer operations (20 rounds
# of an add and a xor, 5 key injections on the path) of at least 4 cycles.
# NVIDIA publishes none of these latencies; the figures are below what
# Hopper microbenchmarks report, so the bound stays a least time.
DCA_LEVEL_CYCLES = {True: 30 + 40 + 20, False: 200 + 40 + 20}
DCA_LINK_OPS, DCA_INT_OP_CYCLES = 45, 4
# H-DCA's three kernels a sequential sweep, by the profiler's names
DCA_SWEEP_KERNELS = {"chain": "dca_chain_kernel", "stage": "dca_stage_kernel",
                     "levels": "dca_levels"}


# H-DCA-C's least time (dca_color_bound) is the larger of two: the bytes
# of a colour sweep on its staged rows (dca_color_bytes); and its groups,
# one after another, each at least an L2 round trip for c̄ (200 cycles, as
# DCA_LEVEL_CYCLES), a short row's dependent arithmetic (40) and a grid
# barrier: every block's arrival reaching L2 and the release coming back,
# two more round trips (400).
DCA_GROUP_CYCLES = 200 + 40 + 400


def dca_color_bytes(a, k, itemsize, groups):
    """The least bytes of a colour sweep over the rows of ``a`` staged in
    colour order, padded to ``k`` slots: each staged slot's value, int32
    column and the bounds at it, and each row's b read once; the order
    (int32) and the active flags read, y read and written per row; c̄ read
    and written at each stored entry; each group's key."""
    m = a.shape[0]
    return (m * k * (3 * itemsize + 4) + m * (3 * itemsize + 4 + 1)
            + a.nnz * 2 * itemsize + groups * 8)


def dca_color_bound(nbytes, groups, sm_mhz):
    """H-DCA-C's two least times of a colour sweep in ms (``bytes``,
    ``groups``), the larger (``bound_ms``) and which binds."""
    parts = dict(bytes=nbytes / HBM_BYTES_PER_S * 1e3,
                 groups=groups * DCA_GROUP_CYCLES / sm_mhz * 1e-3)
    binds = max(parts, key=parts.get)
    return dict(parts, bound_ms=parts[binds], binds=binds)


def dca_bound(nbytes, m, levels, cbar_in_smem, sm_mhz):
    """H-DCA's three least times of a sequential sweep in ms (``bytes``,
    ``levels``, ``chain``), the largest (``bound_ms``) and which binds."""
    parts = dict(
        bytes=nbytes / HBM_BYTES_PER_S * 1e3,
        levels=levels * DCA_LEVEL_CYCLES[cbar_in_smem] / sm_mhz * 1e-3,
        chain=m * DCA_LINK_OPS * DCA_INT_OP_CYCLES / sm_mhz * 1e-3)
    binds = max(parts, key=parts.get)
    return dict(parts, bound_ms=parts[binds], binds=binds)


def dca_sweep_split(torch, fn, reps=3):
    """Device ms per sequential sweep ``fn()`` of each of H-DCA's three
    kernels (the mean of its profiler events: each runs once a sweep) and
    their sum."""
    events = profiled_kernels(torch, fn, reps)
    out = {}
    for part, name in DCA_SWEEP_KERNELS.items():
        dev = [e.elapsed_us() for e in events if name in e.name]
        if not dev:
            raise AssertionError(f"H-DCA: the profiler saw no {name}")
        out[part] = sum(dev) / len(dev) * 1e-3
    out["total"] = sum(out.values())
    return out


def dca_sweep_bytes(a, k, itemsize):
    """The least bytes of a sweep over the rows of ``a`` padded to ``k``
    slots: the padded values and int32 columns read once, b, the active
    flags and y read and y written per row, c̄ read and written and lb, ub
    read at each stored entry."""
    m = a.shape[0]
    return (m * k * (itemsize + 4) + m * (3 * itemsize + 1)
            + a.nnz * 4 * itemsize)


def steady_window(torch, solve, short, long):
    """Per iteration on the device: two profiled ``solve(k)`` of ``short``
    and ``long`` iterations share their set-up, so their difference is
    ``long - short`` iterations: device microseconds and kernels per
    iteration, and the longer solve's busiest kernels."""
    w = [profile_window(torch, lambda k=k: solve(k)) for k in (short, long)]
    n = long - short
    return dict(device_us=(w[1]["device_s"] - w[0]["device_s"]) / n * 1e6,
                kernels=(w[1]["kernels"] - w[0]["kernels"]) / n,
                top_us_long=w[1]["top_us"])


def device_ms(torch, fn, name, counter, reps=3):
    """The profiler's device milliseconds per call of ``fn()`` for the
    kernels whose name contains ``name``: their mean duration times the
    launches one call makes (read from the wrapper ``counter``), since the
    profiler may drop an event of a long run."""
    before = counter.launches
    fn()
    per_call = counter.launches - before
    dev = [e for e in profiled_kernels(torch, fn, reps) if name in e.name]
    return (sum(e.elapsed_us() for e in dev) / len(dev)
            * per_call * 1e-3)


def phase_dca_kernels(torch, table, sm_mhz):
    """H-DCA against its twin on the card: the sequential sweep (three
    launches per system: key chain, draws and staging, levels) on SC105's
    one-sided systems, Potts-20, Potts-50 and the 50 x 50 matching LP, and
    Potts-300's first 2,000 rows (c̄ past shared memory), float32 and
    float64, compared bit for bit (y and c̄ as integers, and the returned
    key); device time per sweep and its split over the three kernels, per
    row and per level, the three-part bound, the twin's time on the card
    over 1,000 rows extrapolated per sweep; H-DCA-C's one-launch colour
    sweep against its twin on Potts-50 and the matching LP (float32,
    float64), and its one-group entry on Potts-50's groups, whole and in
    halves from their ``tie_offset``; then Potts-300 in float32 (the main
    path's): the full sequential sweep against the level-by-level twin
    (itself equal to the row-by-row twin on the first 2,000 rows here and
    on every CPU test), its levels and schedule seconds, the colour sweep
    and the group-by-group entry against the twin, the colour sweep's
    device, events and host time, and its bound."""
    import numpy as np

    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.ops import dca_sweep as dca
    from pysparselp_tpu_torch.solvers.dual_ascent import _color_rows
    from pysparselp_tpu_torch.utils.jax_prng import prng_key, split

    systems = dca_systems()
    lp300 = build_linear_program(300, 0.5, 500)[0]
    lp300.convert_to_one_sided_inequality_system()
    systems["potts300_ineq"] = (lp300.a_inequalities.tocsr(),
                                np.asarray(lp300.b_upper),
                                lp300.costsvector, lp300.lower_bounds,
                                lp300.upper_bounds)
    key = prng_key(1)

    def bits(t):
        return t.view(torch.int32 if t.dtype == torch.float32
                      else torch.int64)

    def same(got, want, what):
        if not (torch.equal(bits(got[0]), bits(want[0]))
                and torch.equal(bits(got[1]), bits(want[1]))
                and got[2:] == want[2:]):
            raise AssertionError(f"H-DCA {what}: kernel and twin differ")

    def timed(args, a_rows, project, itemsize, reps=3):
        ell, m = args[0], a_rows.shape[0]
        split_ms = dca_sweep_split(
            torch, lambda: dca.dca_sweep(*args, key, project), reps)
        smem = dca.cbar_in_smem(ell.vals.shape[1], ell.ncols, itemsize)
        bound = dca_bound(dca_sweep_bytes(a_rows, ell.vals.shape[1],
                                          itemsize),
                          m, ell.schedule.levels, smem, sm_mhz)
        return dict(
            rows=m, width=ell.vals.shape[1], n=ell.ncols,
            levels=ell.schedule.levels,
            schedule_s=ell.schedule.seconds, cbar_in_smem=smem,
            bit_equal=True, device_ms_per_sweep=split_ms["total"],
            device_ms_split=split_ms,
            device_us_per_row=split_ms["total"] / m * 1e3,
            levels_us_per_level=(split_ms["levels"] / ell.schedule.levels
                                 * 1e3),
            chain_ns_per_link=split_ms["chain"] / m * 1e6,
            bound=bound)

    records = []
    for name, system in systems.items():
        project = name.endswith("_ineq")
        rows = 2000 if name.startswith("potts300") else None
        m = rows or system[0].shape[0]
        for dt in (torch.float32, torch.float64):
            dname = str(dt).split(".")[1]
            args = dca_state(torch, system, dt, rows=rows)
            got = dca.dca_sweep(*args, key, project)
            want = dca.dca_sweep_reference(*args, key, project)
            same(got, want, f"{name} {dname}")
            if rows:
                same(dca.dca_sweep_levels_reference(*args, key, project),
                     want, f"{name} {dname}: level twin")
            itemsize = torch.empty((), dtype=dt).element_size()
            sub = dca_state(torch, system, dt, rows=min(m, 1000))
            plain = cuda_ms(torch, lambda: dca.dca_sweep_reference(
                *sub, key, project), 1) / sub[0].vals.shape[0] * m
            records.append(dict(system=name, dtype=dname,
                                plain_ms_per_sweep=plain,
                                **timed(args, system[0][:m], project,
                                        itemsize)))

    # the colour sweep (H-DCA-C): one launch a sweep against its twin, bit
    # for bit, on Potts-50 (float32, float64) and the matching LP (rows of
    # 50, a warp a row); then the one-group entry of the mesh path on
    # Potts-50, group by group and on halves of each group from their
    # tie_offset
    def plan_of(args, system):
        groups = _color_rows(system[0])
        return dca.ColorPlan.build(args[0], groups, args[1], args[5],
                                   args[6])

    for name in ("potts50_ineq", "matching50_ineq"):
        for dt in (torch.float32, torch.float64):
            args = dca_state(torch, systems[name], dt)
            plan = plan_of(args, systems[name])
            cargs = (args[0], plan, *args[1:], key, True)
            dca.dca_color_sweep.launches = 0
            got = dca.dca_color_sweep(*cargs)
            same(got, dca.dca_color_sweep_reference(*cargs),
                 f"{name} colour sweep {dt}")
            if dca.dca_color_sweep.launches != 1:
                raise AssertionError("H-DCA-C: not one launch a sweep")
            records.append(dict(system=name, mode="blocked", dtype=str(dt),
                                groups=len(plan.groups),
                                width=args[0].vals.shape[1],
                                staged=plan.staged is not None,
                                bit_equal=True))
    for dt in (torch.float32, torch.float64):
        ell, bt, active, y, cb, lbt, ubt = args = dca_state(
            torch, systems["potts50_ineq"], dt)
        plan = plan_of(args, systems["potts50_ineq"])
        ky, wy, kc, wc = y, y, cb, cb
        oy, oc = y, cb
        k = key
        for g in plan.groups:
            k, sub = split(k)
            ky, kc = dca.dca_color_step(ell, bt, active, ky, kc, lbt, ubt, g,
                                        sub, True)
            wy, wc = dca.dca_color_step_reference(ell, bt, active, wy, wc,
                                                  lbt, ubt, g, sub, True)
            same((ky, kc), (wy, wc), f"potts50 colour step {str(dt)}")
            half = (g.numel() + 1) // 2
            for lo, hi in ((0, half), (half, g.numel())):
                oy, oc = dca.dca_color_step(ell, bt, active, oy, oc, lbt,
                                            ubt, g[lo:hi], sub, True,
                                            tie_offset=lo)
            same((oy, oc), (wy, wc), f"potts50 colour step halves {dt}")
    records.append(dict(system="potts50_ineq", mode="blocked, one group a "
                        "call (mesh entry), whole and halves with "
                        "tie_offset", groups=len(plan.groups),
                        bit_equal=True))

    # the main path's shapes: Potts-300's whole sweep in float32
    a, b, c, lb, ub = systems["potts300_ineq"]
    args = dca_state(torch, systems["potts300_ineq"], torch.float32)
    ell = args[0]
    t0 = time.perf_counter()
    got = dca.dca_sweep(*args, key, True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = dca.dca_sweep_levels_reference(*args, key, True)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    same(got, want, "potts300 float32 sequential sweep")
    plan = plan_of(args, systems["potts300_ineq"])
    cargs = (ell, plan, *args[1:], key, True)

    def colour_sweep():
        return dca.dca_color_sweep(*cargs)

    def colour_twin():
        return dca.dca_color_sweep_reference(*cargs)

    def colour_groups():
        yy, cc, k = args[3], args[4], key
        for g in plan.groups:
            k, sub = split(k)
            yy, cc = dca.dca_color_step(ell, args[1], args[2], yy, cc,
                                        args[5], args[6], g, sub, True)
        return yy, cc, k

    got, want = colour_sweep(), colour_twin()
    same(got, want, "potts300 colour sweep float32")
    same(colour_groups(), want, "potts300 colour steps float32")
    seq = timed(args, a, True, 4, reps=2)
    sub = dca_state(torch, systems["potts300_ineq"], torch.float32,
                    rows=1000)
    seq_plain = cuda_ms(torch, lambda: dca.dca_sweep_reference(
        *sub, key, True), 1) / 1000 * a.shape[0]
    col_ms = device_ms(torch, colour_sweep, "dca_color_sweep",
                       dca.dca_color_sweep)
    col_groups_ms = device_ms(torch, colour_groups, "dca_color_sweep",
                              dca.dca_color_step)
    col_calls = call_times(torch, colour_sweep, reps=50, host_reps=50)
    col_plain = cuda_ms(torch, colour_twin, 2)
    col_bound = dca_color_bound(
        dca_color_bytes(a, ell.vals.shape[1], 4, len(plan.groups)),
        len(plan.groups), sm_mhz)
    level_sizes = np.diff(ell.schedule.ptr.cpu().numpy())
    records.append(dict(system="potts300_ineq", dtype="float32",
                        groups=len(plan.groups), **seq,
                        level_rows_median=float(np.median(level_sizes)),
                        level_rows_max=int(level_sizes.max()),
                        first_sweep_wall_s=first_s,
                        level_twin_wall_s=twin_s,
                        plain_ms_per_sweep=seq_plain,
                        colour_device_ms_per_sweep=col_ms,
                        colour_events_ms_per_call=col_calls["events_us"]
                        * 1e-3,
                        colour_host_ms_per_call=col_calls["host_us"] * 1e-3,
                        colour_kernels_per_call=col_calls[
                            "kernels_per_call"],
                        colour_group_entry_device_ms_per_sweep=col_groups_ms,
                        colour_plan_bytes=dca.color_plan_bytes(plan),
                        colour_plan_s=plan.seconds,
                        colour_rows_max=plan.max_rows,
                        colour_bound=col_bound,
                        colour_bound_share=col_bound["bound_ms"] / col_ms,
                        colour_plain_ms_per_sweep=col_plain))
    emit("kernels_dca", records=records,
         library="none: no one PyTorch call runs a coordinate sweep")
    bound = seq["bound"]
    table["H-DCA"].update(max_abs_err=0.0, ms=seq["device_ms_per_sweep"],
                          plain_ms=seq_plain, bound_ms=bound["bound_ms"],
                          bound_by="operations", library_ms=None)
    table["H-DCA-C"].update(
        max_abs_err=0.0, ms=col_ms, plain_ms=col_plain,
        bound_ms=col_bound["bound_ms"],
        bound_by="bytes" if col_bound["binds"] == "bytes" else "operations",
        library_ms=None)


def golden_curves(size):
    """``tests/goldens/potts{size}_curves.json`` (the JAX package's CPU
    runs), or an empty dict where the checkout lacks it."""
    path = HERE / "tests" / "goldens" / f"potts{size}_curves.json"
    return json.loads(path.read_text()) if path.is_file() else {}


def dual_cuda_vs_cpu(lp, run, counted_solve):
    """``lp.solve(**run)`` in float64 on the card (counted) and on the CPU:
    their curves and distances, the worst checkpoint difference (held to
    DUAL_F64_RTOL) and the card's launches."""
    import numpy as np

    wall, launches = counted_solve(lp, dtype=np.float64, device="cuda",
                                   **run)
    got, itrn = curves(lp), list(lp.itrn_curve)
    dist = [float(v) for v in lp.distance_to_ground_truth]
    t0 = time.perf_counter()
    lp.solve(dtype=np.float64, device="cpu", **run)
    cpu_wall = time.perf_counter() - t0
    if lp.itrn_curve != itrn:
        raise AssertionError(f"checkpoints {itrn} vs {lp.itrn_curve}")
    worst = checkpoint_diffs(got, curves(lp))
    rec = dict(itrn=itrn, cuda=got, f64_cpu=curves(lp), dist_cuda=dist,
               dist_cpu=[float(v) for v in lp.distance_to_ground_truth],
               worst_rel_diff=worst, rel_limit=DUAL_F64_RTOL, wall_s=wall,
               cpu_wall_s=cpu_wall, launches=launches)
    if not all(v <= DUAL_F64_RTOL for v in worst.values()):
        raise AssertionError(f"{run['method']} f64 CUDA vs CPU: {worst}")
    return rec


def phase_dga_potts(torch, counted_solve):
    """``main_path_dga_potts``: dual gradient ascent on Potts-50, 150
    iterations (the golden's run), float64 on the card against the CPU at
    each checkpoint, beside the golden's distances; then Potts-300 in
    float32 for 300 iterations: iterations/s, launches per kernel, and
    the device time, kernels and busy share per iteration (the difference
    of a 20- and a 40-iteration solve under the profiler)."""
    import numpy as np

    from pysparselp_tpu_torch.examples.potts import build_linear_program

    lp, gt, idx, _ = build_linear_program(50, 0.5, 500, seed=1)
    run = dict(method="dual_gradient_ascent", nb_iter=150, nb_iter_plot=50,
               ground_truth=gt, ground_truth_indices=idx)
    p50 = dual_cuda_vs_cpu(lp, run, counted_solve)
    p50["golden_dist"] = golden_curves(50).get(
        "dual_gradient_ascent", {}).get("dist")
    lp, gt, idx, _ = build_linear_program(300, 0.5, 500)
    run = dict(method="dual_gradient_ascent", nb_iter=300, nb_iter_plot=100,
               dtype=np.float32, device="cuda", ground_truth=gt,
               ground_truth_indices=idx)
    wall, launches = counted_solve(lp, **run)
    rate = steady_rate(lp)
    dist = [float(v) for v in lp.distance_to_ground_truth]
    ONE_DEVICE["dga"] = dict(lp=lp, run=run, curves=curves(lp),
                             x=counted_solve.out[0], wall_s=wall,
                             iters_per_s_steady=rate, launches=launches)
    window = steady_window(torch, lambda k: lp.solve(**dict(
        run, nb_iter=k, nb_iter_plot=k)), 20, 40)
    window["busy"] = window["device_us"] * 1e-6 * rate
    emit("main_path_dga_potts", potts50_f64=p50, potts300_f32=dict(
        n=lp.nb_variables, iterations=300, wall_s=wall,
        iters_per_s_steady=rate, dist=dist,
        dobj=ONE_DEVICE["dga"]["curves"]["dobj_curve"], launches=launches,
        per_iteration=window))
    return launches


def phase_dca_potts(torch, counted_solve):
    """``main_path_dca_potts``: sequential dual coordinate ascent on
    Potts-20, 9 sweeps, float64 on the card against the CPU at each
    checkpoint; then Potts-300 in float32, 3 sweeps in each mode: seconds
    per sweep, H-DCA's launches, the dual energy after each sweep, and the
    device time, kernels and busy share of a sweep (the difference of a
    1- and a 2-sweep solve under the profiler).  Returns the sequential
    and the blocked solve's launches."""
    import numpy as np

    from pysparselp_tpu_torch.examples.potts import build_linear_program

    lp, gt, idx, _ = build_linear_program(20, 0.5, 500, seed=1)
    p20 = dual_cuda_vs_cpu(lp, dict(
        method="dual_coordinate_ascent", nb_iter=9, nb_iter_plot=3,
        ground_truth=gt, ground_truth_indices=idx), counted_solve)
    p20["golden_dist"] = golden_curves(20).get(
        "dual_coordinate_ascent", {}).get("dist")
    lp, gt, idx, _ = build_linear_program(300, 0.5, 500)
    modes, counts = {}, {}
    for mode in ("sequential", "blocked"):
        run = dict(method="dual_coordinate_ascent", nb_iter=3,
                   nb_iter_plot=1, mode=mode, dtype=np.float32,
                   device="cuda", ground_truth=gt, ground_truth_indices=idx)
        wall, launches = counted_solve(lp, **run)
        if mode == "blocked":
            ONE_DEVICE["dca"] = dict(lp=lp, run=run, curves=curves(lp),
                                     x=counted_solve.out[0], wall_s=wall,
                                     launches=launches)
        t = [0.0] + [float(v) for v in lp.opttime_curve]
        per_sweep = [b - a for a, b in zip(t, t[1:])]
        # the 3-sweep solve's curves, before the steady window's solves
        # replace them
        energy = [float(v) for v in lp.dobj_curve]
        dist = [float(v) for v in lp.distance_to_ground_truth]
        window = steady_window(torch, lambda k, m=mode: lp.solve(
            method="dual_coordinate_ascent", nb_iter=k, nb_iter_plot=k,
            mode=m, dtype=np.float32, device="cuda"), 1, 2)
        window["busy"] = window["device_us"] * 1e-6 / per_sweep[-1]
        modes[mode] = dict(
            wall_s=wall, s_per_sweep=per_sweep, dual_energy=energy,
            dist=dist, launches=launches, per_sweep=window)
        counts[mode] = launches
    emit("main_path_dca_potts", potts20_f64=p20, potts300_f32=dict(
        n=lp.nb_variables, sweeps=3, **modes))
    if not counts["sequential"]["H-DCA"] or not counts["blocked"]["H-DCA-C"]:
        raise AssertionError(f"Potts-300 DCA did not run on H-DCA: {counts}")
    # the blocked mode: one H-DCA-C launch a sweep, no group-by-group entry
    sweeps = len(modes["blocked"]["dual_energy"])
    if (counts["blocked"]["H-DCA-C"] != sweeps
            or counts["blocked"]["H-DCA-C (group)"]):
        raise AssertionError(f"blocked DCA: {counts['blocked']}, "
                             f"{sweeps} sweeps")
    return counts


def phase_dca_matching(torch, counted_solve):
    """``main_path_dca_matching``: the bipartite matching LP of
    ``examples/bipartite_matching.py`` (n = 50, seed 2), dual coordinate
    ascent for 200 sweeps with greedy rounding, float64 and float32 on the
    card, its cost held against the float64 CPU run; whether the rounding's
    native propagation (``_propagate.so``) loaded."""
    import numpy as np

    from pysparselp_tpu_torch.examples.bipartite_matching import \
        add_bipartite_constraint
    from pysparselp_tpu_torch.integer import propagation
    from pysparselp_tpu_torch.modeling import SparseLP

    np.random.seed(2)
    cost = -np.random.rand(50, 50)
    lp = SparseLP()
    add_bipartite_constraint(lp, lp.add_variables_array(cost.shape, 0, 1,
                                                        cost))
    run = dict(method="dual_coordinate_ascent", nb_iter=200,
               nb_iter_plot=50, max_time=40)
    costs, walls, launches = {}, {}, None
    for dt in ("float64", "float32"):
        walls[dt], n = counted_solve(lp, dtype=getattr(np, dt),
                                     device="cuda", **run)
        costs[dt] = float(lp.costsvector @ counted_solve.out[0])
        launches = launches or n
    t0 = time.perf_counter()
    x, _ = lp.solve(dtype=np.float64, device="cpu", **run)
    cpu = float(lp.costsvector @ x)
    rel = abs(costs["float64"] - cpu) / abs(cpu)
    emit("main_path_dca_matching", cost_cuda=costs, cost_cpu=cpu,
         rel_diff_f64=rel, rel_limit=MATCHING_COST_RTOL, wall_s=walls,
         cpu_wall_s=time.perf_counter() - t0, launches=launches,
         propagate_native=dict(tried=propagation._LIB_TRIED,
                               loaded=propagation._LIB is not None))
    if not rel <= MATCHING_COST_RTOL:
        raise AssertionError(f"matching DCA cost {costs} vs CPU {cpu}")


def phase_admm_blocks_l1svm(torch, counted_solve):
    """``main_path_admm_blocks_l1svm``: the L1-SVM example
    (``examples/l1_svm.py``: 1,000 points, 3 classes) under ``admm_blocks``
    for 2,000 iterations, float64 and float32 on the card: the
    classification accuracy (float64 held to the JAX test's 99.7%),
    iterations/s, H-CSR's launches (the consensus sum), and the device
    time, kernels and busy share per iteration (the difference of a 100-
    and a 200-iteration solve under the profiler)."""
    import numpy as np

    from pysparselp_tpu_torch.examples import l1_svm

    x, classes = l1_svm.make_data()
    svm = l1_svm.L1SVM()
    svm.set_data(x, classes)
    out = {}
    for dt in ("float64", "float32"):
        run = dict(method="admm_blocks", nb_iter=2000, nb_iter_plot=500,
                   max_time=np.inf, dtype=getattr(np, dt), device="cuda")
        wall, launches = counted_solve(svm, **run)
        svm.weights = counted_solve.out[0][svm.weights_indices]
        acc = 100.0 * float(np.mean(svm.classify(x) == classes))
        rate = steady_rate(svm)
        if dt == "float32":
            ONE_DEVICE["admm_blocks"] = dict(
                lp=svm, run=run, curves=curves(svm), x=counted_solve.out[0],
                accuracy=acc, wall_s=wall, iters_per_s_steady=rate,
                launches=launches)
        window = steady_window(torch, lambda k: svm.solve(**dict(
            run, nb_iter=k, nb_iter_plot=k)), 100, 200)
        window["busy"] = window["device_us"] * 1e-6 * rate
        out[dt] = dict(accuracy=acc, wall_s=wall, iters_per_s_steady=rate,
                       launches=launches, per_iteration=window)
    emit("main_path_admm_blocks_l1svm", accuracy_bar=L1SVM_ACCURACY, **out)
    if not out["float64"]["accuracy"] >= L1SVM_ACCURACY:
        raise AssertionError(f"L1-SVM admm_blocks accuracy {out}")
    return out["float32"]["launches"]


# ----------------------------------------------------------------------
# phase 8b: the mesh solvers beside CP on a one-rank NCCL mesh
# ----------------------------------------------------------------------

# the one-rank mesh interior point against the one-device one on Potts-300
# (float64, CG path): f and bᵀy within this relative, the same IPM
# iterations, and x held as the one-device run is (its distance to the
# graph cut within POTTS300_DIST_LIMIT); x's difference is reported (the
# CG-capped steps move x with the rounding of the reductions)
MESH_IPM_RTOL = 1e-6


def phase_mesh_solvers(torch, counted_solve):
    """``main_path_mesh_solvers``: each mesh solver beside CP on a
    one-rank NCCL mesh in this process, at the full width of its one-device
    run and held against it (ONE_DEVICE, recorded by phases 7 and 8, or run
    here): DGA on Potts-300 (f32, 300 iterations), blocked DCA on Potts-300
    (f32, 3 sweeps: bit for bit), Mehrotra on Potts-300's slack form (f64,
    the CG path: ``mpc_sol`` against ``mpc_sol_sharded`` by f, bᵀy, x and
    IPM iterations), ``admm`` and ``admm2`` on the k-medians LP (their
    check runs held to the f64 CPU run within NONGRID_RTOL as on one
    device; their timed f32 runs' rates), ``admm_blocks`` on L1-SVM (f32,
    2,000 iterations) and DGA on the banded LP (f32, 100 iterations; its
    system lowers to DIA, so the shards run H-DIA with shard offsets, K5's
    function).  Each run's launches and its all-reduces by ``op[numel]``
    against the prediction.  Returns the launches by run."""
    import numpy as np

    from pysparselp_tpu_torch.ops.cg import conjgrad
    from pysparselp_tpu_torch.parallel import (sharded_dca, sharded_dga,
                                               sharded_mehrotra)
    from pysparselp_tpu_torch.solvers import mehrotra as pm

    rec, runs, failed = {}, {}, []

    def check(name, ok, what):
        if not ok:
            failed.append(f"{name}: {what}")

    with one_rank_group("nccl") as mesh:
        def mesh_solve(lp, run):
            mesh.calls.clear()
            conjgrad.calls = conjgrad.steps = 0
            wall, launches = counted_solve(lp, mesh=mesh, **run)
            return wall, launches, allreduces(mesh.calls), dict(
                calls=conjgrad.calls, steps=conjgrad.steps)

        # DGA, Potts-300 (CSR shards: the system lowers to CSR on one
        # device too)
        ref = ONE_DEVICE["dga"]
        lp, run = ref["lp"], ref["run"]
        wall, launches, calls, _cg = mesh_solve(lp, run)
        got, x = curves(lp), counted_solve.out[0]
        n, m = lp.nb_variables, lp.a_inequalities.shape[0]
        its, chunks = run["nb_iter"], run["nb_iter"] // run["nb_iter_plot"]
        predicted = {f"sum[{n}]": 2 * its + chunks, f"sum[{n + 1}]": its,
                     "min[2]": its, "sum[1]": chunks, "max[1]": chunks,
                     f"gather[{m}]": 1}
        worst = checkpoint_diffs(got, ref["curves"])
        rec["dga_potts300"] = dict(
            dtype="float32", iterations=its,
            operator=sharded_dga.last_run_info["operator"], wall_s=wall,
            one_device_wall_s=ref["wall_s"],
            iters_per_s_steady=steady_rate(lp),
            one_device_iters_per_s_steady=ref["iters_per_s_steady"],
            worst_rel_diff=worst, rel_limit=MAIN_RTOL,
            bit_equal=got == ref["curves"] and np.array_equal(x, ref["x"]),
            launches=launches, one_device_launches=ref["launches"],
            allreduces=calls, predicted=predicted)
        runs["dga_potts300"] = launches
        check("dga_potts300", all(v <= MAIN_RTOL for v in worst.values()),
              worst)
        check("dga_potts300", calls == predicted, calls)

        # blocked DCA, Potts-300: the ties and the merge exact
        ref = ONE_DEVICE["dca"]
        lp, run = ref["lp"], ref["run"]
        wall, launches, calls, _cg = mesh_solve(lp, run)
        got, x = curves(lp), counted_solve.out[0]
        info = dict(sharded_dca.last_run_info)
        sweeps = len(got["dobj_curve"])
        colours = info["ineq"]["colours"]
        predicted = {f"sum[{info['ineq']['rows']}]": colours * sweeps,
                     f"sum[{info['n']}]": colours * sweeps}
        bit_equal = got == ref["curves"] and np.array_equal(x, ref["x"])
        rec["dca_potts300_blocked"] = dict(
            dtype="float32", sweeps=sweeps, colours=colours, wall_s=wall,
            one_device_wall_s=ref["wall_s"],
            s_per_sweep=wall / sweeps, dual_energy=got["dobj_curve"],
            one_device_dual_energy=ref["curves"]["dobj_curve"],
            bit_equal=bit_equal, launches=launches,
            one_device_launches=ref["launches"], allreduces=calls,
            predicted=predicted)
        runs["dca_potts300_blocked"] = launches
        check("dca_potts300_blocked", bit_equal, "not bit-equal")
        check("dca_potts300_blocked", calls == predicted, calls)
        check("dca_potts300_blocked",
              launches["H-DCA-C (group)"] == colours * sweeps, launches)

        # Mehrotra, Potts-300's slack form, the CG path
        from pysparselp_tpu_torch.examples.potts import build_linear_program

        lp300, gt, idx, _ = build_linear_program(300, 0.5, 500)
        a, b, c = mehrotra_slack(lp300)
        out = {}
        for where in ("one_device", "mesh"):
            for fn in kernel_counters().values():
                fn.launches = 0
            mesh.calls.clear()
            conjgrad.calls = conjgrad.steps = 0
            t0 = time.perf_counter()
            if where == "mesh":
                res = sharded_mehrotra.mpc_sol_sharded(
                    a, b, c, mesh, max_iter=100, dtype=np.float64)
            else:
                res = pm.mpc_sol(a, b, c, max_iter=100, dtype=np.float64,
                                 device="cuda")
            out[where] = dict(
                f=res[0], x=res[1], bty=float(np.dot(b, res[2])),
                niter=res[4], wall_s=time.perf_counter() - t0,
                dist_graph_cut=float(np.mean(np.abs(res[1][idx] - gt))),
                launches={k: fn.launches
                          for k, fn in kernel_counters().items()},
                cg=dict(calls=conjgrad.calls, steps=conjgrad.steps),
                allreduces=allreduces(mesh.calls))
        one, got = out["one_device"], out["mesh"]
        info = dict(sharded_mehrotra.last_run_info)
        evals = info["evaluations"]
        m_rows = a.shape[0]
        predicted = {f"sum[{m_rows}]": got["cg"]["steps"]
                     + got["cg"]["calls"] + 1 + 12 * evals,
                     "sum[2]": 2 * evals, "sum[1]": evals,
                     "min[2]": 2 * evals + 1, "sum[3]": 1,
                     f"gather[{a.shape[1]}]": 2}
        diffs = dict(
            f=abs(got["f"] - one["f"]) / abs(one["f"]),
            bty=abs(got["bty"] - one["bty"]) / abs(one["bty"]),
            x=float(np.max(np.abs(got["x"] - one["x"])))
            / float(np.max(np.abs(one["x"]))))
        rec["mehrotra_potts300"] = dict(
            dtype="float64", regime=info["regime"],
            standard_form=list(a.shape), evaluations=evals,
            **{k: {kk: v for kk, v in r.items() if kk != "x"}
               for k, r in out.items()},
            rel_diff=diffs, rel_limit=MESH_IPM_RTOL,
            dist_limit=POTTS300_DIST_LIMIT, predicted=predicted)
        runs["mehrotra_potts300"] = got["launches"]
        check("mehrotra_potts300", info["regime"] == "cg", info["regime"])
        check("mehrotra_potts300", got["niter"] == one["niter"]
              and diffs["f"] <= MESH_IPM_RTOL
              and diffs["bty"] <= MESH_IPM_RTOL
              and got["dist_graph_cut"] <= POTTS300_DIST_LIMIT, diffs)
        check("mehrotra_potts300", got["allreduces"] == predicted,
              got["allreduces"])

        # admm and admm2, the k-medians LP
        for method in ("admm", "admm2"):
            ref = ONE_DEVICE[method]
            lp = ref["lp"]
            held = ref["held"]
            lp.solve(mesh=mesh, dtype=getattr(np, held), device="cuda",
                     **ref["check"])
            checked = curves(lp)
            worst = checkpoint_diffs(checked, ref["f64_cpu"])
            vs_one = checkpoint_diffs(checked, ref["cuda"])
            # admm2's timed run is cut to 40 iterations here: each of its
            # ~100 CG steps an iteration makes four all-reduces
            timed = (ref["timed"] if method == "admm" else dict(
                ref["timed"], nb_iter=40, nb_iter_plot=20))
            wall, launches, calls, cg = mesh_solve(lp, timed)
            host = admm_matrix(lp, method)
            n2, its = host.shape[1], timed["nb_iter"]
            chunks = its // timed["nb_iter_plot"]
            if method == "admm":
                # nb_inner + 1 = 3 n-vector psums an iteration
                predicted = {f"sum[{n2}]": 3 * its, "sum[1]": chunks,
                             "max[1]": chunks}
            else:
                # one per CG step and one a CG solve's first product, one
                # an iteration for x; three scalar psums a CG step and
                # three a CG solve
                predicted = {f"sum[{n2}]": cg["steps"] + cg["calls"] + its,
                             "sum[1]": 3 * (cg["steps"] + cg["calls"]),
                             "max[1]": chunks}
            rec[f"{method}_kmedians"] = dict(
                held=held, check_iterations=ref["check"]["nb_iter"],
                worst_rel_diff_f64_cpu=worst, rel_limit=NONGRID_RTOL,
                rel_diff_one_device=vs_one, timed_iterations=its,
                wall_s=wall, iters_per_s_steady=steady_rate(lp),
                one_device_iters_per_s_steady=ref["iters_per_s_steady"],
                launches=launches, one_device_launches=ref["launches"],
                cg=cg, allreduces=calls, predicted=predicted)
            runs[f"{method}_kmedians"] = launches
            check(method, all(v <= NONGRID_RTOL for v in worst.values()),
                  worst)
            check(method, calls == predicted, calls)

        # admm_blocks, L1-SVM: one psum of the consensus sums an iteration
        ref = ONE_DEVICE["admm_blocks"]
        svm, run = ref["lp"], ref["run"]
        wall, launches, calls, _cg = mesh_solve(svm, run)
        got = curves(svm)
        its, chunks = run["nb_iter"], run["nb_iter"] // run["nb_iter_plot"]
        vec = {k: v for k, v in calls.items()
               if not k.endswith("[1]")}
        worst = checkpoint_diffs(got, ref["curves"])
        rec["admm_blocks_l1svm"] = dict(
            dtype="float32", iterations=its, wall_s=wall,
            iters_per_s_steady=steady_rate(svm),
            one_device_iters_per_s_steady=ref["iters_per_s_steady"],
            worst_rel_diff=worst, rel_limit=MAIN_RTOL,
            bit_equal=got == ref["curves"] and np.array_equal(
                counted_solve.out[0], ref["x"]),
            launches=launches, one_device_launches=ref["launches"],
            allreduces=calls,
            predicted={"vector psums": its, "sum[1]": chunks,
                       "max[1]": chunks})
        runs["admm_blocks_l1svm"] = launches
        check("admm_blocks_l1svm", all(v <= MAIN_RTOL for v in
                                       worst.values()), worst)
        check("admm_blocks_l1svm", list(vec.values()) == [its]
              and calls.get("sum[1]") == chunks
              and calls.get("max[1]") == chunks, calls)

        # DGA on the banded LP: DIA shards (H-DIA with shard offsets)
        lp = banded_lp()
        run = dict(method="dual_gradient_ascent", nb_iter=100,
                   nb_iter_plot=50, dtype=np.float32, device="cuda")
        wall_1, n_1 = counted_solve(lp, **run)
        want, x_1 = curves(lp), counted_solve.out[0]
        wall, launches, calls, _cg = mesh_solve(lp, run)
        got = curves(lp)
        worst = checkpoint_diffs(got, want)
        operator = sharded_dga.last_run_info["operator"]
        rec["dga_banded"] = dict(
            dtype="float32", iterations=100, operator=operator,
            wall_s=wall, one_device_wall_s=wall_1,
            iters_per_s_steady=steady_rate(lp), worst_rel_diff=worst,
            rel_limit=MAIN_RTOL, bit_equal=got == want and np.array_equal(
                counted_solve.out[0], x_1),
            launches=launches, one_device_launches=n_1, allreduces=calls)
        runs["dga_banded"] = launches
        check("dga_banded", operator == "dia" and launches["H-DIA"] > 0,
              (operator, launches))
        check("dga_banded", all(v <= MAIN_RTOL for v in worst.values()),
              worst)
    emit("main_path_mesh_solvers", backend="nccl", ranks=1,
         device="cuda", solvers=rec)
    if failed:
        raise AssertionError("main_path_mesh_solvers: " + "; ".join(failed))
    return runs


# ----------------------------------------------------------------------
# phase 9: the host modules and the observability layer
# ----------------------------------------------------------------------

# the benchmark driver's random LP at the JAX package's defaults
# (benchmarks.py::benchmark_random_lp)
RANDOM_LP = dict(nbvar=60, n_eq=5, n_ineq=60, sparsity=0.2, seed=1)
# examples/potts.py::run's methods whose last graph-cut distance must be
# finite on the card (mehrotra runs in float32 there and is only printed),
# and CP's bar, tests/test_examples.py's
POTTS_RUN_FINITE = ("chambolle_pock_ppd", "admm", "admm2", "admm_blocks",
                    "dual_gradient_ascent", "dual_coordinate_ascent")
POTTS_RUN_CP_DIST = 0.05
# examples/potts.py::run's arguments: Potts-50, 2 s a method, a curve
# point every 100 iterations (at 500 the sequential DCA emits no point in
# 2 s on the card: 421 sweeps; and admm2's and admm_blocks' first chunk
# runs long past max_time, which is read between chunks)
POTTS_RUN = dict(image_size=50, max_time=2, nb_iter_plot=100)
# where phase 9 writes its checkpoint and trace: inside the checkout's
# build/ directory, which git ignores
SCRATCH = HERE / "build" / "chip_smoke"


def solve_log(counters):
    """Patch ``SparseLP.solve`` until the returned ``restore()`` is
    called: each call runs with every launch counter set to 0 just before
    it and appends its method, wall seconds and nonzero launches to
    ``log``, so drivers that call ``lp.solve`` once per method (the
    benchmark driver, ``examples/potts.py::run``) are counted per
    method.  Returns ``(log, restore)``."""
    from pysparselp_tpu_torch.modeling import SparseLP

    solve, log = SparseLP.solve, []

    def logged(self, *args, **kw):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = solve(self, *args, **kw)
        log.append(dict(method=kw.get("method", args[0] if args else None),
                        wall_s=time.perf_counter() - t0,
                        launches={k: fn.launches for k, fn in counters.items()
                                  if fn.launches}))
        return out

    def restore():
        SparseLP.solve = solve

    SparseLP.solve = logged
    return log, restore


def by_method(log):
    """The last logged solve of each method."""
    return {rec["method"]: rec for rec in log}


def phase_checkpoint(torch, counted_solve):
    """``main_path_checkpoint``: CP-PPD in float32 on the card, on
    Potts-300 (H-CPDIA-G) and Potts-50 (H-CPDIA-R): 800 iterations straight,
    then 400 with ``CheckpointingCallback(path, every_sec=0.0)`` and 400
    more resumed from ``load_checkpoint(path)`` (x0, y_eq0, y_ineq0, x30).
    The resumed x is held to the straight one within MAIN_RTOL · max(1,
    max|x|); each run's launches.  Returns the launches by run."""
    import numpy as np

    from pysparselp_tpu_torch import CheckpointingCallback, load_checkpoint
    from pysparselp_tpu_torch.examples.potts import build_linear_program

    SCRATCH.mkdir(parents=True, exist_ok=True)
    out, runs = {}, {}
    for size, kernel in ((300, "H-CPDIA-G"), (50, "H-CPDIA-R")):
        lp = build_linear_program(size, 0.5, 500)[0]
        run = dict(method="chambolle_pock_ppd", nb_iter_plot=200,
                   dtype=np.float32, device="cuda")
        wall, n_straight = counted_solve(lp, nb_iter=800, **run)
        x_straight = counted_solve.out[0]
        path = SCRATCH / f"checkpoint_potts{size}.npz"
        path.unlink(missing_ok=True)
        wall_first, n_first = counted_solve(
            lp, nb_iter=400, callback_func=CheckpointingCallback(
                str(path), every_sec=0.0).wrap(None), **run)
        st = load_checkpoint(str(path))
        wall_res, n_res = counted_solve(
            lp, nb_iter=400, x0=st["x"], y_eq0=st["y_eq"],
            y_ineq0=st["y_ineq"], x30=st["meta"]["x3"], **run)
        x_res = counted_solve.out[0]
        gap = float(np.max(np.abs(x_res - x_straight)))
        limit = MAIN_RTOL * max(1.0, float(np.max(np.abs(x_straight))))
        out[f"potts{size}"] = dict(
            kernel=kernel, checkpoint_niter=st["niter"],
            checkpoint_bytes=path.stat().st_size,
            max_abs_gap=gap, gap_limit=limit, bit_equal=gap == 0.0,
            launches=dict(straight=n_straight, first=n_first,
                          resumed=n_res),
            wall_s=dict(straight=wall, first=wall_first, resumed=wall_res))
        if st["niter"] != 400 or not gap <= limit:
            raise AssertionError(f"Potts-{size} resume: {out}")
        for name, n in (("straight", n_straight), ("resumed", n_res)):
            if not n[kernel]:
                raise AssertionError(f"Potts-{size} {name} run did not "
                                     f"launch {kernel}: {n}")
            runs[f"main_path_checkpoint/potts{size}_{name}"] = n
    emit("main_path_checkpoint", **out)
    return runs


def phase_profile(torch, counters):
    """``main_path_profile``: ``utils.profile_trace(dir)`` around a
    20,000-iteration Potts-50 CP solve (float32, 2,000-iteration chunks),
    one trace: its kernel events counted by name, H-CPDIA-R's held equal
    to ``cp_dia_resident_chunk.launches`` for that solve and every kernel
    launch the trace records held to have its kernel record; the top five
    kernels by device time and the trace's size."""
    import shutil

    import numpy as np

    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.utils import profile_trace

    lp = build_linear_program(50, 0.5, 500)[0]
    log_dir = SCRATCH / "profile_trace"
    shutil.rmtree(log_dir, ignore_errors=True)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with profile_trace(str(log_dir)) as d:
        lp.solve(method="chambolle_pock_ppd", nb_iter=20000,
                 nb_iter_plot=2000, dtype=np.float32, device="cuda")
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    trace = Path(d) / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    resident = sum("cp_dia_resident_kernel" in e["name"] for e in kernels)
    correlated = {e.get("args", {}).get("correlation") for e in kernels}
    runtime = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                      and "Launch" in e["name"]), key=lambda e: e["ts"])
    orphans = [i for i, e in enumerate(runtime)
               if e.get("args", {}).get("correlation") not in correlated]
    counts, device_us = {}, {}
    for e in kernels:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
        device_us[e["name"]] = device_us.get(e["name"], 0.0) + float(
            e.get("dur", 0.0))
    top = sorted(device_us, key=device_us.get, reverse=True)[:5]
    emit("main_path_profile", log_dir=str(d), trace_bytes=trace.stat().st_size,
         trace_events=len(events), kernel_events=len(kernels),
         kernel_launches=len(runtime), launches_without_kernel=len(orphans),
         orphan_launch_order=orphans[:20], kernel_names=len(counts),
         h_cpdia_r_events=resident, launches=launches, wall_s=wall,
         top5=[dict(name=name[:120], events=counts[name],
                    device_us=device_us[name]) for name in top])
    if not resident or resident != launches.get("H-CPDIA-R") or orphans:
        raise AssertionError(
            f"trace holds {resident} H-CPDIA-R events, the counter "
            f"{launches}; {len(orphans)} of {len(runtime)} launches lack "
            f"their kernel record")
    return launches


def phase_debug(torch, counted_solve):
    """``main_path_debug``: Potts-50 with one NaN in its cost vector
    (neither package's host layer refuses it, so the NaN goes in the cost):
    under ``utils.debug_mode()`` the float32 CP solve on the card raises
    ``FloatingPointError`` at the first chunk boundary after the NaN;
    without it the same solve returns, its x with NaN at the positions the
    CPU run's (the twins') has.  The iteration the trap fired at."""
    import re

    import numpy as np

    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.utils import debug_mode

    lp = build_linear_program(50, 0.5, 500)[0]
    lp.costsvector[3] = np.nan
    run = dict(method="chambolle_pock_ppd", nb_iter=2000, nb_iter_plot=500,
               dtype=np.float32, device="cuda")
    trap = None
    with debug_mode():
        try:
            lp.solve(**run)
        except FloatingPointError as e:
            trap = str(e)
    if trap is None:
        raise AssertionError("debug_mode did not trap the NaN cost")
    wall, launches = counted_solve(lp, **run)
    x = counted_solve.out[0]
    # the kernels' projections keep a NaN as their twins do: the CPU run
    # (the twins) returns the same NaN entries
    x_cpu, _ = lp.solve(**dict(run, device="cpu"))
    nan_cuda, nan_cpu = np.isnan(x), np.isnan(x_cpu)
    emit("main_path_debug", nan_input="cost", trapped=trap,
         trap_iteration=int(re.search(r"iteration (\d+)", trap).group(1)),
         returned_without_debug=True, nan_entries_returned=int(
             nan_cuda.sum()), nan_entries_cpu=int(nan_cpu.sum()),
         same_nan_positions=bool(np.array_equal(nan_cuda, nan_cpu)),
         wall_s=wall, launches=launches)
    if not np.array_equal(nan_cuda, nan_cpu) or not nan_cpu.any():
        raise AssertionError(f"Potts-50 NaN cost: {int(nan_cuda.sum())} NaN "
                             f"entries in x on the card, {int(nan_cpu.sum())}"
                             " on the CPU")


def phase_benchmark_random_lp(torch, counters):
    """``main_path_benchmark_random_lp``: ``benchmarks.benchmark_random_lp``
    at the JAX package's defaults (RANDOM_LP), every method of
    ``solving_methods`` but the scipy bridges, 2,000 iterations, a point
    every 500, 5 s at most each, on the card (float32): per method the
    cost, the distance to HiGHS's solution, seconds and each hand kernel's
    launches.  The driver catches a failing method into ``{"error": ...}``;
    any such entry fails the phase.  Returns (launches by method, the
    random LP, HiGHS's solution)."""
    import numpy as np

    from pysparselp_tpu_torch.benchmarks import benchmark_random_lp
    from pysparselp_tpu_torch.modeling import solving_methods

    methods = [m for m in solving_methods
               if m not in ("scipy_simplex", "scipy_interior_point")]
    log, restore = solve_log(counters)
    try:
        t0 = time.perf_counter()
        results, lp = benchmark_random_lp(
            **RANDOM_LP, methods=methods, nb_iter=2000, nb_iter_plot=500,
            max_time=5, solve_kwargs={"device": "cuda"}, verbose=False)
        wall = time.perf_counter() - t0
    finally:
        restore()
    gt, _ = lp.solve(method="scipy_simplex")
    logged, out = by_method(log), {}
    for method, r in results.items():
        if "error" in r:
            out[method] = r
            continue
        dist = r["distance_to_ground_truth"]
        out[method] = dict(
            cost=r["cost"], max_violation=r["max_violation"],
            mean_abs_dist_to_highs=float(np.mean(np.abs(r["x"] - gt))),
            last_curve_dist=dist[-1] if dist else None,
            curve_points=len(r["itrn_curve"]), elapsed_s=r["elapsed"],
            launches=logged[method]["launches"])
    emit("main_path_benchmark_random_lp", lp=RANDOM_LP, highs_cost=float(
        lp.cost(gt)), methods=out, wall_s=wall)
    errors = {m: r["error"] for m, r in results.items() if "error" in r}
    if errors or set(results) != set(methods):
        raise AssertionError(f"benchmark_random_lp: {errors or results}")
    return {m: rec["launches"] for m, rec in logged.items()}, lp, gt


def phase_potts_run(torch, counters):
    """``main_path_potts_run``: ``examples.potts.run(**POTTS_RUN)`` on the
    card with its default method list (float32): every method's last
    graph-cut distance, curve points, seconds and launches, and the
    iteration CP first came within the bar.  Fails on an exception, on a non-finite (or missing) last
    distance of CP, the ADMM family, DGA or DCA, and on CP's above
    tests/test_examples.py's 0.05; Mehrotra's is printed whatever it is
    (float32 is below what the interior point needs).  Returns the
    launches by method."""
    import numpy as np

    from pysparselp_tpu_torch.examples import potts

    log, restore = solve_log(counters)
    try:
        t0 = time.perf_counter()
        curves = potts.run(**POTTS_RUN)
        wall = time.perf_counter() - t0
    finally:
        restore()
    logged = by_method(log)
    out = {m: dict(last_dist=c[-1] if c else None, points=len(c),
                   wall_s=logged[m]["wall_s"],
                   launches=logged[m]["launches"])
           for m, c in curves.items()}
    below = np.nonzero(np.asarray(curves["chambolle_pock_ppd"])
                       < POTTS_RUN_CP_DIST)[0]
    out["chambolle_pock_ppd"]["first_within_bar_iteration"] = (
        int(below[0] + 1) * POTTS_RUN["nb_iter_plot"] if below.size
        else None)
    emit("main_path_potts_run", **POTTS_RUN, methods=out,
         cp_dist_bar=POTTS_RUN_CP_DIST, wall_s=wall)
    bad = [m for m in POTTS_RUN_FINITE if m in out and not (
        out[m]["last_dist"] is not None and np.isfinite(out[m]["last_dist"]))]
    if bad or not out["chambolle_pock_ppd"]["last_dist"] < POTTS_RUN_CP_DIST:
        raise AssertionError(f"potts.run on the card: {out}")
    return {m: rec["launches"] for m, rec in logged.items()}


def phase_host_gauss_seidel(torch, counted_solve, lp, gt):
    """``host_gauss_seidel``: the native Gauss-Seidel library
    (``native/_gauss_seidel.cpp``, built by g++ into the build directory)
    must load; then ``lp.solve(method="admm", inner="gauss_seidel",
    device="cuda", nb_iter=1000)`` on the benchmark's random LP: its cost
    against HiGHS's and its seconds.  The sweeps run on the host whatever
    ``device`` says, so no hand kernel may be launched."""
    import importlib

    gs = importlib.import_module("pysparselp_tpu_torch.native.gauss_seidel")
    lib = gs._load_native()
    if lib is None:
        raise AssertionError("the native Gauss-Seidel library did not build")
    wall, launches = counted_solve(lp, method="admm", inner="gauss_seidel",
                                   device="cuda", nb_iter=1000)
    x = counted_solve.out[0]
    emit("host_gauss_seidel", runs_on="host (sequential C++ sweeps; "
         "device='cuda' is resolved, not used)", native_library=lib._name,
         cost=float(lp.cost(x)), highs_cost=float(lp.cost(gt)),
         max_violation=float(lp.max_constraint_violation(x)), seconds=wall,
         launches={k: n for k, n in launches.items() if n})
    if any(launches.values()):
        raise AssertionError(f"the host mode launched kernels: {launches}")


def reuse_colourings():
    """Make the port's blocked DCA colour each system once in this run:
    ``solvers.dual_ascent._color_rows`` (deterministic, ~25 s of host work
    at Potts-300) keeps its groups by the matrix's bytes.  The solves after
    the first of a system then leave it out of their wall times."""
    import hashlib

    from pysparselp_tpu_torch.solvers import dual_ascent

    colour, seen = dual_ascent._color_rows, {}

    def cached(csr):
        import scipy.sparse

        csr = scipy.sparse.csr_matrix(csr)
        key = hashlib.sha1(b"".join(
            memoryview(v).cast("B") for v in (
                csr.indptr, csr.indices, csr.data))).hexdigest()
        if key not in seen:
            seen[key] = colour(csr)
        return seen[key]

    dual_ascent._color_rows = cached


def kernel_counters():
    """Each hand kernel's wrapper, whose ``launches`` counts its
    launches."""
    from pysparselp_tpu_torch.ops import (bsr_spmv, cp_dense, cp_dia,
                                          csr_spmv, dca_sweep, dia_spmv)

    return {"H-DIA": dia_spmv.dia_spmv, "H-CPDIA": cp_dia.cp_dia_chunk,
            "H-CPDIA-G": cp_dia.cp_dia_grid_chunk,
            "H-CPDIA (shard)": cp_dia.cp_dia_shard_step,
            "H-CPDIA-R": cp_dia.cp_dia_resident_chunk,
            "H-CPDENSE": cp_dense.cp_dense_chunk,
            "H-CSR": csr_spmv.csr_spmv, "H-BSR": bsr_spmv.bsr_spmv,
            "H-DIA-B": dia_spmv.dia_spmm, "H-CSR-B": csr_spmv.csr_spmm,
            "H-DCA": dca_sweep.dca_sweep,
            "H-DCA-C": dca_sweep.dca_color_sweep,
            "H-DCA-C (group)": dca_sweep.dca_color_step}


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
    from pysparselp_tpu_torch.ops import _build

    warnings.filterwarnings("ignore", message="Sparse (CSR|BSR) tensor support")
    counters = kernel_counters()
    reuse_colourings()

    def counted_solve(lp, **kw):
        """``lp.solve(**kw)`` with every launch counter set to 0 just
        before; returns (wall seconds, the counts of this solve) and keeps
        what the solve returned in ``counted_solve.out``."""
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        counted_solve.out = lp.solve(**kw)
        wall = time.perf_counter() - t0
        return wall, {k: fn.launches for k, fn in counters.items()}

    phase_s, clock = {}, [time.perf_counter()]

    def lap(name):
        """Keep (and print) the seconds since the last lap under
        ``name``."""
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now
        emit("lap", name=name, seconds=phase_s[name],
             total_s=sum(phase_s.values()))

    # phase 1: environment and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0].split()[0])
    _build.library()
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         sm_clock_max_mhz=sm_mhz,
         build_seconds=_build.build_info["seconds"],
         build_cached=_build.build_info["cached"])
    if _build.build_info["log"]:
        print(_build.build_info["log"], file=sys.stderr)
    lap("1_environment_build")

    t0 = time.perf_counter()
    problems = {
        "potts300": build_linear_program(300, 0.5, 500)[0],
        "potts100": build_linear_program(100, 0.5, 500)[0],
        "potts50": build_linear_program(50, 0.5, 500)[0],
        "potts20": build_linear_program(20, 0.5, 500)[0],
        "multilabel64": build_multilabel_linear_program(64, 4)[0],
        "sc105": sc105_lp()[0],
    }
    workloads = {k: make() for k, make in WORKLOADS.items()}
    clime = clime_lp(**CLIME)
    batch_lps = {k: cfg["make"]() for k, cfg in BATCH.items()}
    emit("problems", build_seconds=time.perf_counter() - t0)
    lap("problems")

    table = {k: dict(name=k, route="cuda", **v, launches=None,
                     max_abs_err=0.0, ms=None, plain_ms=None, bound_ms=None,
                     bound_by=None, library_ms=None)
             for k, v in KERNELS.items()}
    phase_kernels(torch, problems, table)
    l2_rates = phase_grid(torch, problems, table, sm_mhz)
    phase_resident(torch, problems, table, sm_mhz)
    phase_csr(torch, csr_matrices({k: folded(lp)
                                   for k, lp in workloads.items()}), table)
    from pysparselp_tpu_torch.problem import apply_rcm_permutation
    phase_bsr(torch, apply_rcm_permutation(folded(clime))[0]["a_ineq"], table)
    phase_k5(torch, problems["potts300"], table)
    phase_shard_kernels(torch, problems, table, l2_rates)
    phase_batch_kernels(torch, batch_lps, table)
    phase_f64_kernels(torch, {
        "potts300_slack": mehrotra_slack(problems["potts300"])[0],
        "kmedians_admm": admm_matrix(workloads["kmedians"], "admm"),
        "kmedians_admm2": admm_matrix(workloads["kmedians"], "admm2"),
        "potts300_aligned": (aligned_potts(problems["potts300"])["a_ineq"],
                             "dia"),
        "clime_rcm": (apply_rcm_permutation(folded(clime))[0]["a_ineq"],
                      "bsr")}, table)
    phase_dca_kernels(torch, table, sm_mhz)
    lap("2_kernels")

    # phase 3: the main path on Potts-300
    lp300 = build_linear_program(300, 0.5, 500)[0]
    run = dict(method="chambolle_pock_ppd", nb_iter=2000, nb_iter_plot=1000,
               light_metrics=True)
    wall, n300 = counted_solve(lp300, dtype=np.float32, device="cuda", **run)
    its = steady_rate(lp300)
    got = curves(lp300)
    itrn = list(lp300.itrn_curve)
    t0 = time.perf_counter()
    lp300.solve(dtype=np.float64, device="cpu",
                **dict(run, nb_iter=run["nb_iter_plot"]))
    cpu_wall = time.perf_counter() - t0
    want = curves(lp300)
    if lp300.itrn_curve != itrn[:1]:
        raise AssertionError(f"checkpoints {itrn[:1]} vs {lp300.itrn_curve}")
    worst = checkpoint_diffs(got, want)
    tier300 = dia_tier(lp300, torch.float32)
    emit("main_path_potts300", n=lp300.nb_variables, wall_s=wall,
         iters_per_s_steady=its, itrn=itrn, f32_cuda=got, f64_cpu=want,
         worst_rel_diff=worst, rel_limit=MAIN_RTOL, cpu_wall_s=cpu_wall,
         **tier300, launches=n300)
    if not all(v <= MAIN_RTOL for v in worst.values()):
        raise AssertionError(f"Potts-300 f32 CUDA vs f64 CPU: {worst}")
    if (tier300 != dict(tier="grid", planes="bfloat16")
            or not n300["H-CPDIA-G"] or n300["H-CPDIA"]):
        raise AssertionError(f"Potts-300 f32 did not run H-CPDIA-G alone on "
                             f"bfloat16 planes: {tier300}, {n300}")
    for key in ("H-DIA", "H-CPDIA-G"):
        table[key]["launches"] = n300[key]
    # the same LP in float64 on the card: the two-launch H-CPDIA on
    # float64 planes, its checkpoint held against the same CPU run (the
    # iterations are elementwise the twin's; the metrics' sums run in
    # another order: F64_MAIN_RTOL)
    wall64, n64 = counted_solve(lp300, dtype=np.float64, device="cuda",
                                **dict(run, nb_iter=run["nb_iter_plot"]))
    got64 = curves(lp300)
    worst64 = checkpoint_diffs(got64, want)
    tier64 = dia_tier(lp300, torch.float64)
    emit("main_path_potts300_f64", n=lp300.nb_variables, wall_s=wall64,
         itrn=list(lp300.itrn_curve), f64_cuda=got64, f64_cpu=want,
         worst_rel_diff=worst64, rel_limit=F64_MAIN_RTOL, **tier64,
         launches=n64)
    if not all(v <= F64_MAIN_RTOL for v in worst64.values()):
        raise AssertionError(f"Potts-300 f64 CUDA vs f64 CPU: {worst64}")
    if tier64["tier"] != "two_launch" or not n64["H-CPDIA"]:
        raise AssertionError(f"Potts-300 f64 did not run the two-launch "
                             f"H-CPDIA: {tier64}, {n64}")
    table["H-CPDIA"]["launches"] = n64["H-CPDIA"]
    lap("3_potts300")

    # phase 3b: the mesh solve, one NCCL rank (position-sharded in
    # float32, row-sharded in float64), then four gloo ranks
    n_pos, n_rows = phase_mesh1(torch, lp300, want, counted_solve)
    table["H-CPDIA (shard)"]["launches"] = n_pos["H-CPDIA (shard)"]
    table["H-DIA"].setdefault("launches_by_run", {})[
        "main_path_mesh1"] = n_pos["H-DIA"]
    table["H-DIA (K5)"]["launches"] = n_rows["H-DIA"]
    n_mesh4 = phase_mesh4(torch)
    table["H-DIA (K5)"].setdefault("launches_by_run", {})[
        "main_path_mesh4/potts300_f64"] = n_mesh4["potts300_f64"]["H-DIA"]
    lap("3b_mesh")

    # phase 4: bench.py's non-grid workloads at its sizes
    for name, lp in workloads.items():
        launches = phase_nongrid(torch, name, lp, counted_solve)
        if name == "transport":
            table["H-CSR"]["launches"] = launches["H-CSR"]
    lap("4_nongrid")

    # phase 4b: batched serving (solve_cp_batch) on H-DIA-B and H-CSR-B
    for name, lp in batch_lps.items():
        launches = phase_batch(torch, name, lp, counters)
        for key in ("H-DIA-B", "H-CSR-B"):
            if KERNELS[key]["launches_run"] == f"main_path_batch_{name}":
                table[key]["launches"] = launches[key]
    lap("4b_batch")

    # phase 5: CLIME through the RCM presolve and the block-sparse operator
    table["H-BSR"]["launches"] = phase_clime(torch, clime,
                                             counted_solve)["H-BSR"]
    lap("5_clime")

    # phase 6: convergence with restart-to-average
    lp50, gt50, idx50, _ = build_linear_program(50, 0.5, 500)
    wall, n50 = counted_solve(
        lp50, method="chambolle_pock_ppd", nb_iter=36000, nb_iter_plot=12000,
        restart_period=4000, restart="average", dtype=np.float32,
        ground_truth=gt50, ground_truth_indices=idx50, device="cuda")
    dists = np.asarray(lp50.distance_to_ground_truth)
    below = np.nonzero(dists < 1e-2)[0]
    emit("converge_potts50", dist=lp50.distance_to_ground_truth,
         **dia_tier(lp50, torch.float32),
         itrn=lp50.itrn_curve, seconds=lp50.opttime_curve, wall_s=wall,
         seconds_to_graph_cut=(float(lp50.opttime_curve[below[0]])
                               if below.size else None),
         launches=n50)
    if not below.size:
        raise AssertionError(f"Potts-50 reached dist {dists.min()} "
                             "(need < 1e-2)")
    if not n50["H-CPDIA-R"] or n50["H-CPDIA"] or n50["H-CPDIA-G"]:
        raise AssertionError(f"Potts-50 did not run on H-CPDIA-R alone: "
                             f"{n50}")
    table["H-CPDIA-R"]["launches"] = n50["H-CPDIA-R"]
    table["H-CPDIA-R"].setdefault("launches_by_run", {})[
        "main_path_potts50"] = phase_potts50(torch, counted_solve)
    lp105, gt105 = sc105_lp()
    run105 = dict(method="chambolle_pock_ppd", nb_iter=72000,
                  nb_iter_plot=72000, restart="average", restart_period=4000,
                  dtype=np.float32, ground_truth=gt105,
                  ground_truth_indices=np.arange(len(gt105)), device="cuda")
    wall, n105 = counted_solve(lp105, **run105)
    d105 = float(lp105.distance_to_ground_truth[-1])
    chunks = chunk_profile(torch, lp105, "cp_dense_kernel", run105)
    emit("converge_sc105", dist=d105, seconds=lp105.opttime_curve[-1],
         wall_s=wall, launches=n105, iterations=72000,
         us_per_iteration=wall / 72000 * 1e6, profiled=chunks)
    if not d105 < 1e-3:
        raise AssertionError(f"SC105 reached dist {d105} (need < 1e-3)")
    table["H-CPDENSE"]["launches"] = n105["H-CPDENSE"]
    lap("6_convergence")

    # phase 7: the interior point and ADMM solvers
    phase_mehrotra_netlib(torch, counted_solve)
    for run, launches in (
            ("main_path_mehrotra_potts300",
             phase_mehrotra_potts300(torch, counted_solve)),
            ("main_path_admm_kmedians",
             phase_admm_kmedians(torch, counted_solve))):
        for key, n in launches.items():
            if n:
                table[TABLE_ROW.get(key, key)].setdefault(
                    "launches_by_run", {})[run] = n
    lap("7_mehrotra_admm")

    # phase 8: the dual ascent solvers and admm_blocks
    t8 = time.perf_counter()
    for run, launches in (
            ("main_path_dga_potts", phase_dga_potts(torch, counted_solve)),
            ("main_path_admm_blocks_l1svm",
             phase_admm_blocks_l1svm(torch, counted_solve))):
        for key, n in launches.items():
            if n:
                table[TABLE_ROW.get(key, key)].setdefault(
                    "launches_by_run", {})[run] = n
    dca_counts = phase_dca_potts(torch, counted_solve)
    table["H-DCA"]["launches"] = dca_counts["sequential"]["H-DCA"]
    table["H-DCA-C"]["launches"] = dca_counts["blocked"]["H-DCA-C"]
    phase_dca_matching(torch, counted_solve)
    emit("phase8", seconds=time.perf_counter() - t8)
    lap("8_dual_ascent")

    # phase 8b: the mesh solvers beside CP, one NCCL rank in this process
    # (H-DIA there runs on DIA shards: K5's function)
    for run, launches in phase_mesh_solvers(torch, counted_solve).items():
        for key, n in launches.items():
            if n:
                table["H-DIA (K5)" if key == "H-DIA"
                      else TABLE_ROW.get(key, key)].setdefault(
                    "launches_by_run", {})[
                    f"main_path_mesh_solvers/{run}"] = n
    lap("8b_mesh_solvers")

    # phase 9: the host modules and the observability layer
    t9 = time.perf_counter()
    runs = phase_checkpoint(torch, counted_solve)
    runs["main_path_profile"] = phase_profile(torch, counters)
    phase_debug(torch, counted_solve)
    bench, random_lp, highs = phase_benchmark_random_lp(torch, counters)
    runs.update({f"main_path_benchmark_random_lp/{m}": n
                 for m, n in bench.items()})
    runs.update({f"main_path_potts_run/{m}": n
                 for m, n in phase_potts_run(torch, counters).items()})
    phase_host_gauss_seidel(torch, counted_solve, random_lp, highs)
    for run, launches in runs.items():
        for key, n in launches.items():
            if n:
                table[TABLE_ROW.get(key, key)].setdefault(
                    "launches_by_run", {})[run] = n
    emit("phase9", phase9_s=time.perf_counter() - t9)
    lap("9_host_observability")
    emit("phase_seconds", total_s=sum(phase_s.values()), **phase_s)
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
