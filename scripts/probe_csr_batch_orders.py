#!/usr/bin/env python3
"""What H-CSR-B's summation order costs, on one NVIDIA GPU.

    python3 scripts/probe_csr_batch_orders.py [--reps N]

H-CSR-B (``csrc/csr_spmv.cu``, ``csr_batch_kernel``) runs a thread per
(row, column) and adds a row's entries in entry order, so column b of its
result differs from the 1-D H-CSR (``csr_kernel``) on ``X[:, b]`` in
rounding.  This probe builds variants of that kernel from this checkout's
source, each its own shared library (``nvcc``, the port's flags, into
``build/probe_csr_batch_orders/``), and times them against the shipped
kernel on ``chip_smoke.BATCH``'s unstructured operator (150,000 x 100,000,
1.95M entries, B = 8; ``A X`` and ``Aᵀ Y``, float32 and float64), in turns
(each variant, then all again in reverse order; CUDA events over back-to-
back launches, and the profiler's device time):

* ``lanes_g{2,4,8}``: the same threads and blocks, each thread summing its
  row in ``csr_kernel``'s order instead (the row's W virtual lanes, lane v
  the entries v, v + W, ..., gathered G lanes at a time, folded into the
  shuffle tree's pairs as they come, the lanes past the row's end left
  out and a final + 0 restoring the tree's sign of zero); ``equal`` says
  whether each equals H-CSR column by column (``torch.equal``);
* ``entry_{8,16,32}b``: entry order, but a thread per row and 8, 16 or 32
  bytes of columns (vector loads of X); ``equal`` says whether each
  equals the shipped kernel bit for bit.

The variants run only where the operator has no long row (the
unstructured one has none); their chunk blocks are the shipped ones.
Prints one JSON line per product with the card's name and power limit;
the same lines go to ``chiprun_out/probe_csr_batch_orders.json``.  Exits
nonzero without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "probe_csr_batch_orders"

# csr_kernel's order in a thread: the row's W virtual lanes in groups of
# kGroup, folded into the shuffle tree as a binary counter
ORDER = r"""
__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}

template <typename T, int W, int kGroup>
__device__ __forceinline__ T row_sum(const int* __restrict__ indices,
                                     const T* __restrict__ vals,
                                     const T* __restrict__ x, int nb, int b,
                                     int begin, int end) {
  constexpr int kLevels = log2i(W);
  T stack[kLevels];
  T total = T(0);
  int lanes = W;
  const int len = end - begin;
#pragma unroll
  for (int v0 = 0; v0 < W; v0 += kGroup) {
    if (v0 >= len) { lanes = v0; break; }
    T s[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int k = begin + v0 + g;
      s[g] = k < end ? vals[k] * __ldg(x + static_cast<long long>(
                                            indices[k]) * nb + b) : T(0);
    }
    if (len > W) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        for (int k = begin + v0 + g + W; k < end; k += W) {
          s[g] = s[g] + vals[k] * __ldg(x + static_cast<long long>(
                                            indices[k]) * nb + b);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int v = v0 + g;
      T cur = s[g];
#pragma unroll
      for (int l = 0; l < kLevels; ++l) {
        const int below = (1 << l) - 1;
        if ((v & below) == below) {
          if ((v >> l) & 1) cur = stack[l] + cur; else stack[l] = cur;
        }
      }
      if (v == W - 1) total = cur;
    }
  }
  if (lanes < W) {
    bool have = false;
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      if ((lanes >> l) & 1) {
        total = have ? stack[l] + total : stack[l];
        have = true;
      }
    }
  }
  return total + T(0);
}
"""

# entry order, a thread per row and kC columns (one vector load a entry)
ENTRY = r"""
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
entry_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
             const T* __restrict__ vals, int n_out, int width,
             const T* __restrict__ x, T* __restrict__ y, int nb) {
  struct alignas(sizeof(T) * kC) P { T v[kC]; };
  const int per = nb / kC;
  const long long id =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row = id / per;
  if (row >= n_out) return;
  const int col = static_cast<int>(id - row * per) * kC;
  const int begin = indptr[row], end = indptr[row + 1];
  if (end - begin > kLongStrides * width) return;
  P acc;
#pragma unroll
  for (int c = 0; c < kC; ++c) acc.v[c] = T(0);
  for (int k = begin; k < end; ++k) {
    const T a = vals[k];
    const P xv = *reinterpret_cast<const P*>(
        x + static_cast<long long>(indices[k]) * nb + col);
#pragma unroll
    for (int c = 0; c < kC; ++c) acc.v[c] = acc.v[c] + a * xv.v[c];
  }
  *reinterpret_cast<P*>(y + row * nb + col) = acc;
}
"""

LOOP = """      T acc = T(0);
      for (int k = begin; k < end; ++k) {
        acc = acc + vals[k] * __ldg(x + static_cast<long long>(indices[k])
                                    * nb + b);
      }
      y[static_cast<long long>(row) * nb + b] = acc;"""
KERNEL = ("template <typename T>\n__global__ void __launch_bounds__(kThreads)"
          "\ncsr_batch_kernel(")
LAUNCH = """  csr_batch_kernel<T><<<static_cast<unsigned>(blocks), dim3(cols, strands),
                        0, static_cast<cudaStream_t>(stream_ptr)>>>(
      indptr, indices, vals, plan, counters, n_out, width,
      static_cast<int>(row_blocks), n_chunks, n_tasks, carries, x, y, nb);"""
BATCH_ENTRY = "template <typename T>\nint launch_batch("


def lanes_variant(src, group):
    body = ("      y[static_cast<long long>(row) * nb + b] = row_sum<T, W, "
            f"{group}>(indices, vals, x, nb, b, begin, end);")
    launch = """#define PSLP_L(W)                                                      \\
  csr_batch_kernel<T, W><<<static_cast<unsigned>(blocks),                 \\
      dim3(cols, strands), 0, static_cast<cudaStream_t>(stream_ptr)>>>(   \\
      indptr, indices, vals, plan, counters, n_out, width,                \\
      static_cast<int>(row_blocks), n_chunks, n_tasks, carries, x, y, nb)
  switch (width) {
    case 2: PSLP_L(2); break;
    case 4: PSLP_L(4); break;
    case 8: PSLP_L(8); break;
    case 16: PSLP_L(16); break;
    case 32: PSLP_L(32); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PSLP_L"""
    kernel = KERNEL.replace("template <typename T>",
                            "template <typename T, int W>")
    return (src.replace(LOOP, body).replace(KERNEL, ORDER + "\n" + kernel)
            .replace(LAUNCH, launch))


def entry_variant(src, nbytes):
    launch = f"""  if (n_chunks == 0 && (nb * sizeof(T)) % {nbytes} == 0
      && reinterpret_cast<unsigned long long>(x) % {nbytes} == 0) {{
    constexpr int kC = {nbytes} / sizeof(T);
    const long long rows_blocks =
        (static_cast<long long>(n_out) * (nb / kC) + kThreads - 1) / kThreads;
    entry_kernel<T, kC><<<static_cast<unsigned>(rows_blocks), kThreads, 0,
        static_cast<cudaStream_t>(stream_ptr)>>>(
        indptr, indices, vals, n_out, width, x, y, nb);
    return static_cast<int>(cudaGetLastError());
  }}
"""
    return (src.replace(BATCH_ENTRY, ENTRY + "\n" + BATCH_ENTRY)
            .replace(LAUNCH, launch + LAUNCH))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=300)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_csr_batch_orders: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke
    from pysparselp_tpu_torch.ops import _build
    from pysparselp_tpu_torch.ops import csr_spmv as ops
    from pysparselp_tpu_torch.problem import CsrMatrix

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    src = (_build.SRC_DIR / "csr_spmv.cu").read_text()
    for pattern in (LOOP, KERNEL, LAUNCH, BATCH_ENTRY):
        if pattern not in src:
            raise AssertionError("csr_spmv.cu no longer has the kernel this "
                                 "probe varies")
    sources = {"shipped": src}
    sources.update({f"lanes_g{g}": lanes_variant(src, g) for g in (2, 4, 8)})
    sources.update({f"entry_{b}b": entry_variant(src, b)
                    for b in (8, 16, 32)})
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "common.cuh").write_text((_build.SRC_DIR / "common.cuh")
                                    .read_text())
    procs = {}
    for name, text in sources.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, registers = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        registers[name] = sorted({int(line.split("Used ")[1].split()[0])
                                  for line in log.splitlines()
                                  if "Used" in line and "registers" in line})
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    a = chip_smoke.batch_systems(chip_smoke.BATCH["unstructured"]["make"]())[1]
    lines = []
    for dt in (torch.float32, torch.float64):
        sfx = _build.suffix(dt)
        op = CsrMatrix.from_scipy(a, dt, dev)
        for side, operand in (("A", op.csr), ("At", op.csr_t)):
            if operand.plan.n_tasks:
                raise AssertionError("the probe's variants take no long row")
            nb = chip_smoke.BATCH["unstructured"]["bsz"]
            x = torch.as_tensor(rng.randn(operand.n_in, nb), dtype=dt,
                                device=dev)
            carries, counters = operand.batch_scratch(nb)
            columns = torch.stack([ops.csr_spmv(operand, x[:, b].contiguous())
                                   for b in range(nb)], dim=1)
            shipped = ops.csr_spmm(operand, x)
            calls, check = {}, {}
            for name, lib in libs.items():
                fn = getattr(lib, f"pslp_csr_spmm_{sfx}")
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                y = torch.empty_like(shipped)
                call_args = (
                    operand.indptr.data_ptr(), operand.indices.data_ptr(),
                    operand.vals.data_ptr(), operand.plan_dev.data_ptr(),
                    operand.n_out, operand.plan.width, operand.plan.n_chunks,
                    operand.plan.n_tasks, carries.data_ptr(),
                    counters.data_ptr(), x.data_ptr(), y.data_ptr(), nb,
                    torch.cuda.current_stream().cuda_stream)

                def call(fn=fn, call_args=call_args):
                    _build.check(fn(*call_args), "probe variant")

                call()
                torch.cuda.synchronize()
                want = columns if name.startswith("lanes") else shipped
                check[name] = bool(torch.equal(y, want))
                calls[name] = call
            order = list(calls) + list(reversed(list(calls)))
            events = {name: [] for name in calls}
            for name in order:
                events[name].append(chip_smoke.cuda_ms(
                    torch, calls[name], args.reps) * 1e3)
            rec = dict(problem="unstructured", side=side, dtype=sfx,
                       batch=nb, width=operand.plan.width, nvidia_smi=smi,
                       equal=check, registers=registers,
                       events_us=events, device_us={
                           name: chip_smoke.call_times(
                               torch, call, reps=100, host_reps=10
                           )["device_us"] for name, call in calls.items()})
            print(json.dumps(rec), flush=True)
            lines.append(rec)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe_csr_batch_orders.json").write_text(
        "\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
