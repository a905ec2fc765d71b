#!/usr/bin/env python3
"""Where the time goes in the row-sharded CP-PPD iteration
(``pysparselp_tpu_torch/parallel/sharded_cp.py``), on one NVIDIA GPU.

    python3 scripts/profile_mesh.py

On the aligned Potts-300 LP (``chip_smoke.py``'s main path; float32, the
per-shard DIA layout) it prints JSON lines, also written to
``chiprun_out/profile_mesh.json``:

* ``k5_device``: H-DIA's and cuSPARSE's device microseconds per call
  (``torch.profiler``) on each of the 4 row shards, forward and window,
  the shapes of ``chip_smoke.py``'s K5 phase.
* ``nccl1``: a one-rank NCCL group in this process.  Host microseconds per
  call (wall clock over back-to-back calls, one synchronisation at the
  end) of the pieces of one iteration: the n-vector ``mesh.psum``, a bare
  ``dist.all_reduce`` of the same tensor, the forward and window H-DIA
  products, and the whole iteration (``sharded_cp_chunk``); the iteration
  again with ``psum`` replaced by a copy, which isolates the collective;
  and a ``torch.profiler`` table of one chunk by host time, with the
  device time of each row.
* ``gloo4``: four gloo ranks on the one card (``parallel.mesh.spawn``),
  each its own shard: per rank the milliseconds of a ``psum`` of a CUDA
  and of a CPU n-vector, and of one iteration.

Exits nonzero without CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
REPS = 500
PROFILED_ITERS = 200


def potts300_shard(mesh):
    """This rank's float32 ``(data, state)`` of the aligned Potts-300 LP."""
    import numpy as np

    from chip_smoke import aligned_potts
    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.parallel.sharded_cp import build_sharded_cp_data

    sys_ = aligned_potts(build_linear_program(300, 0.5, 500)[0])
    return build_sharded_cp_data(
        sys_["c"], None, None, sys_["a_ineq"], sys_["b_ineq"], sys_["lb"],
        sys_["ub"], mesh, dtype=np.float32, operator="dia")


def wall_us(torch, fn, reps):
    """Host microseconds per call over ``reps`` back-to-back calls (one
    warm-up call, one synchronisation at the end)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def nccl1(torch):
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from pysparselp_tpu_torch.parallel import sharded_cp
    from pysparselp_tpu_torch.parallel.mesh import default_mesh
    from pysparselp_tpu_torch.parallel.sharded_dia import (local_matvec_dia,
                                                           local_rmatvec_dia)

    with tempfile.TemporaryDirectory(prefix="pslp_prof_") as tmp:
        dist.init_process_group(
            "nccl", init_method="file://" + os.path.join(tmp, "rendezvous"),
            world_size=1, rank=0)
        try:
            mesh = default_mesh("cuda")
            data, state = potts300_shard(mesh)
            sys_l, n = data["ineq"], data["c"].shape[0]
            x, y = state["x"] + 0.5, state["y_ineq"] + 0.25
            v = torch.ones_like(data["c"])
            rec = dict(
                psum_us=wall_us(torch, lambda: mesh.psum(v), REPS),
                all_reduce_us=wall_us(torch, lambda: dist.all_reduce(v),
                                      REPS),
                forward_us=wall_us(
                    torch, lambda: local_matvec_dia(sys_l, x, n), REPS),
                window_us=wall_us(
                    torch, lambda: local_rmatvec_dia(sys_l, y, n), REPS))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, _ = sharded_cp.sharded_cp_chunk(data, state, mesh, REPS)
            torch.cuda.synchronize()
            rec["iteration_us"] = (time.perf_counter() - t0) / REPS * 1e6
            real_psum = mesh.psum
            mesh.psum = lambda t: t.clone()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sharded_cp.sharded_cp_chunk(data, state, mesh, REPS)
                torch.cuda.synchronize()
                rec["iteration_copy_for_psum_us"] = (
                    (time.perf_counter() - t0) / REPS * 1e6)
            finally:
                mesh.psum = real_psum
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                sharded_cp.sharded_cp_chunk(data, s, mesh, PROFILED_ITERS)
                torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    rec["profile_per_iteration"] = [
        dict(name=e.key, calls=e.count / PROFILED_ITERS,
             self_host_us=e.self_cpu_time_total / PROFILED_ITERS,
             device_us=getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
             / PROFILED_ITERS)
        for e in rows[:16]]
    return rec


def k5_device(torch):
    """Device microseconds per call of H-DIA and of cuSPARSE (``torch.mv``
    of the shard's CSR) on each of the 4 row shards of aligned Potts-300,
    forward and window, under ``torch.profiler``."""
    import scipy.sparse
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import aligned_potts, sparse_tensor
    from profile_port import device_events
    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.ops.dia_spmv import dia_spmv
    from pysparselp_tpu_torch.parallel.sharded_cp import _csr_shard
    from pysparselp_tpu_torch.parallel.sharded_dia import build_system_dia

    sys_ = aligned_potts(build_linear_program(300, 0.5, 500)[0])
    a, b = scipy.sparse.csr_matrix(sys_["a_ineq"]), sys_["b_ineq"]
    n = a.shape[1]
    dev, f32 = torch.device("cuda"), torch.float32
    out = []
    for rank in range(4):
        s, rows_loc, _ = build_system_dia(a, b, 4, rank)
        wlo, w = s["dia_wlo"], s["dia_vals_t"].shape[1]
        rows = _csr_shard(a, 4, rank)[0]
        for side, vals, offs, n_in, n_out, host in (
                ("forward", s["dia_vals"], s["dia_offs"], n, rows_loc, rows),
                ("window", s["dia_vals_t"], s["dia_offs_t"], rows_loc, w,
                 rows[:, wlo:wlo + w].T.tocsr())):
            vals = torch.as_tensor(vals, dtype=f32, device=dev)
            offs = torch.as_tensor(offs, device=dev)
            x = torch.ones(n_in, dtype=f32, device=dev)
            lib = sparse_tensor(torch, host, f32, dev)
            dia_spmv(vals, offs, x, n_out)
            torch.mv(lib, x)
            torch.cuda.synchronize()
            rec = dict(rank=rank, side=side)
            for key, fn in (("h_dia", lambda: dia_spmv(vals, offs, x, n_out)),
                            ("cusparse", lambda: torch.mv(lib, x))):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(REPS // 10):
                        fn()
                    torch.cuda.synchronize()
                kernels = {k: v for k, v in device_events(
                    prof, DeviceType).items() if "emcpy" not in k
                    and "emset" not in k}
                rec[key + "_device_us"] = sum(
                    us for _, us in kernels.values()) / (REPS // 10)
                rec[key + "_kernels"] = sorted(kernels)
            out.append(rec)
    return out


def gloo_rank(mesh, reps):
    """One rank of ``gloo4``: its milliseconds per psum and per iteration."""
    import torch

    from pysparselp_tpu_torch.parallel import sharded_cp

    data, state = potts300_shard(mesh)
    v = torch.ones_like(data["c"])
    v_host = v.cpu()

    def per_call_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    sharded_cp.sharded_cp_chunk(data, state, mesh, 2)
    mine = torch.tensor([per_call_ms(lambda: mesh.psum(v)),
                         per_call_ms(lambda: mesh.psum(v_host)),
                         per_call_ms(lambda: sharded_cp.sharded_cp_chunk(
                             data, state, mesh, 1))], dtype=torch.float64)
    every = torch.zeros((mesh.size, 3), dtype=torch.float64)
    every[mesh.rank] = mine
    every = mesh.psum(every.to(mesh.device)).cpu()
    return {k: every[:, i].tolist() for i, k in enumerate(
        ("psum_cuda_ms", "psum_cpu_ms", "iteration_ms"))}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_mesh: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from pysparselp_tpu_torch.parallel.mesh import spawn

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    lines = [dict(phase="k5_device", problem="potts300_aligned",
                  dtype="float32", ranks=4, nvidia_smi=smi,
                  shards=k5_device(torch)),
             dict(phase="nccl1", problem="potts300_aligned", dtype="float32",
                  nvidia_smi=smi, **nccl1(torch))]
    lines.append(dict(phase="gloo4", problem="potts300_aligned",
                      dtype="float32", ranks=4, nvidia_smi=smi,
                      **spawn(gloo_rank, 4, "gloo", "cuda", 50)))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "profile_mesh.json", "w") as f:
        for rec in lines:
            print(json.dumps(rec), flush=True)
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
