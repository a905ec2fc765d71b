#!/usr/bin/env python3
"""Timing probe of the port's CSR SpMV kernel (H-CSR) on one NVIDIA GPU.

    python3 scripts/probe_csr_spmv.py [--gather-only]

Over a row-length ladder (2, 13, 20 and 5,000 entries per row, about 2M
entries each, 1M columns so that x stays in the L2 cache), float32: times
H-CSR (``ops.csr_spmv.csr_spmv``), its plain PyTorch twin and the library
call ``torch.mv`` on a ``torch.sparse_csr_tensor`` of the same matrix (one
cuSPARSE SpMV), in turns (twin, kernel, kernel, twin) with CUDA events, and
checks the kernel against the twin.  H-CSR and the library call are also
timed by ``chip_smoke.call_times``: device time from the profiler, host
time per call, kernels per call; and H-CSR's device time with its plan
built at other lanes per row (``WIDTHS``) and long-row chunk sizes
(``CHUNKS``).  Prints one JSON line per rung with the default plan's
lanes per row, chunks and long rows, the bytes the product must move, its
bound at 3.35 TB/s and the achieved rate on device time; then one line
per orientation of each of ``chip_smoke.py``'s H-CSR matrices
(transport, unstructured, the k-medians block) with the same plan
times.  Then the gather-only probe (``chip_smoke.gather_rate``, alone with
``--gather-only``): the rate at which the card serves rows of an
L2-resident float32 X of ``GATHER_COLUMNS`` columns (4 to 32 bytes a row)
at the column indices of each orientation of the unstructured batch
operator (``chip_smoke.BATCH``, 1.95M entries) and at as many uniform
random ones: H-CSR-B's gather bound divides its gathered bytes by it.
The same lines go to ``chiprun_out/probe_csr_spmv.json``.  Exits nonzero
without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12     # NVIDIA H100 SXM at 700 W
NNZ = 2_000_000
N_COLS = 1_000_000
ROW_LENGTHS = (2, 13, 20, 5000)
# the plan's lanes per row and long-row chunk sizes tried beside the default
WIDTHS = (2, 4, 8, 16, 32)
CHUNKS = (512, 2048, 8192)
REPS = 50
# columns of X (float32) in the gather-only probe: 4- to 32-byte rows
GATHER_COLUMNS = (1, 2, 4, 8)


def events_ms(torch, fn, reps):
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


def gather_lines(torch, chip_smoke, smi, dev, rng):
    """The gather-only probe's lines: per orientation of the unstructured
    batch operator and per row width, the rate at its indices and at
    uniform random ones."""
    from pysparselp_tpu_torch.problem import CsrMatrix

    a = chip_smoke.batch_systems(chip_smoke.BATCH["unstructured"]["make"]())[1]
    op = CsrMatrix.from_scipy(a, torch.float32, dev)
    lines = []
    for side, operand in (("A", op.csr), ("At", op.csr_t)):
        n = operand.indices.numel()
        uniform = torch.as_tensor(rng.randint(0, operand.n_in, n)
                                  .astype("int32"), device=dev)
        for cols in GATHER_COLUMNS:
            x = torch.as_tensor(rng.randn(operand.n_in, cols),
                                dtype=torch.float32, device=dev)
            rec = dict(probe="gather", problem="unstructured", side=side,
                       rows=operand.n_in, gathers=n, row_bytes=4 * cols,
                       nvidia_smi=smi)
            for label, idx in (("indices", operand.indices),
                               ("uniform", uniform)):
                rate, us = chip_smoke.gather_rate(torch, x, idx)
                rec[label] = dict(bytes_per_s=rate, device_us=us)
            print(json.dumps(rec), flush=True)
            lines.append(rec)
    return lines


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_csr_spmv: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import scipy.sparse

    import chip_smoke
    from pysparselp_tpu_torch.ops import csr_spmv as ops
    from pysparselp_tpu_torch.problem import CsrMatrix

    warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    lines = []
    if "--gather-only" in sys.argv[1:]:
        lines += gather_lines(torch, chip_smoke, smi, dev, rng)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "probe_csr_spmv_gather.json").write_text(
            "\n".join(json.dumps(r) for r in lines) + "\n")
        return 0

    def plans(side, x):
        """Device microseconds per call with the plan built at each of
        WIDTHS lanes per row, and, where the matrix has long rows, at each
        of CHUNKS entries per chunk."""
        ptr = side.indptr.cpu().numpy()
        out = {}
        tries = [(f"width {w}", dict(width=w)) for w in WIDTHS]
        if side.plan.n_tasks:
            tries += [(f"chunk {c}", dict(chunk=c)) for c in CHUNKS]
        for label, kw in tries:
            cut = ops.CsrOperand(side.indptr, side.indices, side.vals,
                                 side.n_in, ops.split_plan(ptr, **kw))
            out[label] = chip_smoke.call_times(
                torch, lambda cut=cut: ops.csr_spmv(cut, x))["device_us"]
        return out

    for length in ROW_LENGTHS:
        m = NNZ // length
        cols = rng.randint(0, N_COLS, (m, length))
        a = scipy.sparse.csr_matrix(
            (rng.randn(m * length), cols.ravel(),
             np.arange(0, m * length + 1, length)), shape=(m, N_COLS))
        a.sum_duplicates()
        op = CsrMatrix.from_scipy(a, torch.float32, dev)
        x = torch.as_tensor(rng.randn(N_COLS), dtype=torch.float32,
                            device=dev)
        lib = torch.sparse_csr_tensor(op.indptr, op.indices, op.vals,
                                      size=(m, N_COLS),
                                      check_invariants=False)

        def kern(op=op, x=x):
            return op.matvec(x)

        def plain(op=op, x=x, m=m):
            return ops.csr_spmv_reference(op.indptr, op.indices, op.vals, x,
                                          m)

        got, want = kern(), plain()
        scale = ops.csr_spmv_reference(op.indptr, op.indices, op.vals.abs(),
                                       x.abs(), m)
        if not bool(((got - want).abs() <= 1e-5 * scale).all()):
            raise AssertionError(f"H-CSR disagrees with its twin at row "
                                 f"length {length}")
        t = [events_ms(torch, f, REPS) for f in (plain, kern, kern, plain)]
        lib_ms = events_ms(torch, lambda lib=lib, x=x: torch.mv(lib, x), REPS)
        nnz = a.nnz
        moved = nnz * 8 + (m + 1) * 4 + m * 4 + N_COLS * 4
        kernel_us = chip_smoke.call_times(torch, kern)
        rec = dict(row_length=length, rows=m, cols=N_COLS, nnz=nnz,
                   width=op.csr.plan.width, chunks=op.csr.plan.n_chunks,
                   long_rows=op.csr.plan.n_tasks,
                   nvidia_smi=smi, ms=(t[1] + t[2]) / 2,
                   plain_ms=(t[0] + t[3]) / 2, library_ms=lib_ms,
                   kernel_us=kernel_us,
                   plans_us=plans(op.csr, x),
                   library_us=chip_smoke.call_times(
                       torch, lambda lib=lib, x=x: torch.mv(lib, x)),
                   bytes=moved, bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                   achieved_tb_s=moved / (kernel_us["device_us"] * 1e-6)
                   / 1e12,
                   max_abs_err=float((got - want).abs().max()))
        print(json.dumps(rec), flush=True)
        lines.append(rec)
    workloads = {k: chip_smoke.folded(make())
                 for k, make in chip_smoke.WORKLOADS.items() if k != "l1svm"}
    for key, a in chip_smoke.csr_matrices(workloads).items():
        op = CsrMatrix.from_scipy(a, torch.float32, dev)
        for side, operand in (("A", op.csr), ("At", op.csr_t)):
            x = torch.as_tensor(rng.randn(operand.n_in), dtype=torch.float32,
                                device=dev)
            rec = dict(problem=key, side=side, nnz=a.nnz,
                       shape=[operand.n_out, operand.n_in],
                       width=operand.plan.width,
                       chunks=operand.plan.n_chunks,
                       long_rows=operand.plan.n_tasks,
                       nvidia_smi=smi, kernel_us=chip_smoke.call_times(
                           torch, lambda operand=operand, x=x:
                           ops.csr_spmv(operand, x)),
                       plans_us=plans(operand, x))
            print(json.dumps(rec), flush=True)
            lines.append(rec)
    lines += gather_lines(torch, chip_smoke, smi, dev, rng)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe_csr_spmv.json").write_text(
        "\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
