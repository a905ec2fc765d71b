// H-DIA: DIA sparse matrix-vector product y[r] = sum_d vals[d, r] * x[r + off_d].
//
// Replaces pysparselp_tpu/ops/dia_pallas.py::_dia_matvec_pallas (K4) and
// computes the function of _dia_matvec_pallas_dyn (K5): the offsets are a
// runtime int32 device array, so one compiled kernel serves every operator.
//
// Bound on the H100: memory.  A call moves ndiag * n_out * itemsize bytes of
// values, plus |x| and |y|; the arithmetic is one multiply-add per value.
// The planes are read as stored: in the compute type, or in bfloat16 for a
// float32 product whose every value is exact in bfloat16 (2 bytes a value,
// widened exactly in registers: pslp::widen).
// Design: one thread per output row walks the diagonals in ascending-offset
// order, so for every diagonal neighbouring threads read neighbouring values
// and neighbouring x entries (one coalesced stream per diagonal, x reused
// from L1/L2 across diagonals).  The TPU kernel's lane rotations, 128-lane
// padding and VMEM residency of x have no counterpart: a bounds check that
// yields zero stands in for the zero padding.
//
// H-DIA-B, the same product over B right-hand sides stored batch-last,
//   Y[r, b] = sum_d vals[d, r] * X[r + off_d, b],   X (n_in, B), Y (n_out, B),
// serves the batched CP iteration (batch.py).  It replaces the vmapped XLA
// shift loop of pysparselp_tpu/batch.py::_dia_shift_mv (:57), which took the
// batch because the Pallas kernels do not vmap; no pallas_call stands behind
// it.  Bound: memory, ndiag * n_out * itemsize bytes of values read once for
// all B columns, plus B * (n_in + n_out) * itemsize of X and Y; on the batch
// path the data fits the 50 MB L2, so a warm call is held against the L2's
// read rate as well.  Design (ops/dia_spmv.py::dia_spmm_plan, built on the
// host once per operator and batch size):
// * a tile is R rows (by a column tile of the batch where a row of X is too
//   wide); in the batch-last layout the X rows a tile reads,
//   [r0 + off_min, r0 + R + off_max), are one contiguous span, which the
//   tile stages in shared memory, clipped to [0, n_in), with its R x ndiag
//   plane values (stored tile-major on the device, zero past n_out).  Rows
//   outside X are zeros in shared memory, so every thread reads without a
//   bounds check.  Where that span is too wide, one range of R rows per
//   diagonal is staged instead (the same kernel with a longer copy list);
// * the copies are cp.async.bulk into an mbarrier where the span is 16-byte
//   aligned (B * itemsize a multiple of 16, X aligned, no column tiles), else
//   cp.async by every thread, 16 bytes or one element a copy;
// * a persistent grid (a few CTAs per SM, every CTA the same number of
//   tiles within one) with two stages: tile t + 1's copy is in flight while
//   tile t is summed;
// * one diagonal reads no X value twice: there (plan.direct) the tile reads
//   X and its planes straight from global memory, 16 bytes a thread, with
//   the same sums;
// * the offsets come by value in the kernel's parameters (up to
//   kParamDiags, the batch path's most), else from the device once a
//   block; no thread loads an offset before its X read;
// * a thread sums CPT neighbouring columns of a row (4 in f32, 2 in f64, 1
//   when B * itemsize is not a multiple of 16), reading shared memory and
//   writing Y as 16-byte vectors, in ascending-offset order with every
//   product and sum rounded apart, pslp::dia_row's arithmetic: the zero
//   rows give the acc + v * 0 the bounds check gives.  So column b equals
//   H-DIA on X[:, b] bit for bit.
#include "common.cuh"

// offsets passed by value (ops/dia_spmv.py PARAM_DIAGS: the batch path's
// DIA_AUTO_MAX_OFFSETS); more are read from the device into shared memory
constexpr int kParamDiags = 32;
constexpr int kMaxSmem = 232448;   // 227 KB, the H100's most a block may use

// the host plan of one operator and batch size (ops/dia_spmv.py::_PlanStruct)
struct DiaBPlan {
  const void* planes;   // (row_tiles, ndiag, rows), zero past n_out
  const int* offs;      // (ndiag,) on the device, read when > kParamDiags
  int n_out, nb, ndiag, rows, cols, cpt, union_window, bulk;
  int row_tiles, col_tiles, window_rows, off_min, grid, stage_bytes,
      smem_bytes, direct;
  int offsets[kParamDiags];
};

namespace {

constexpr int kThreads = pslp::kBlock;

template <typename T, typename P>
__global__ void dia_spmv_kernel(const P* __restrict__ vals,
                                const int* __restrict__ offs, int ndiag,
                                const T* __restrict__ x, int n_in,
                                T* __restrict__ y, int n_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_out) return;
  y[r] = pslp::dia_row<T, P>(vals, offs, ndiag, n_out, x, n_in, r);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int kBytes>
__device__ __forceinline__ void async_copy(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(kBytes) : "memory");
  }
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// order this thread's shared-memory accesses before later async-proxy
// (bulk copy) writes to the same bytes
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ long long clip(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// stage tile `tile`: its plane values and the X rows of its ranges (one
// span, or one R-row range per diagonal), rows outside [0, n_in) zeroed
template <typename T, int CPT>
__device__ __forceinline__ void stage_tile(const DiaBPlan& p, const int* offs,
                                           const T* __restrict__ x, int n_in,
                                           int tile, unsigned char* stage,
                                           unsigned long long* bar) {
  const int rt = tile / p.col_tiles;
  const int c0 = (tile - rt * p.col_tiles) * p.cols;
  const int cw = min(p.cols, p.nb - c0);
  const long long r0 = static_cast<long long>(rt) * p.rows;
  const unsigned plane_bytes = p.ndiag * p.rows * sizeof(T);
  const unsigned char* src_planes =
      static_cast<const unsigned char*>(p.planes) + r0 * p.ndiag * sizeof(T);
  T* win = reinterpret_cast<T*>(stage + plane_bytes);
  const int ranges = p.union_window ? (p.ndiag > 0 ? 1 : 0) : p.ndiag;
  const int span = p.union_window ? p.window_rows : p.rows;
  const int t = threadIdx.x;
  for (int q = 0; q < ranges; ++q) {
    // rows of the range before X and past its end (they may overlap when
    // the range covers all of X; both are zeros)
    const long long lo = r0 + (p.union_window ? p.off_min : offs[q]);
    const int head = static_cast<int>(clip(-lo, span));
    const int tail = static_cast<int>(clip(lo + span - n_in, span));
    const int zeros = (head + tail) * p.cols;
    T* row0 = win + static_cast<long long>(q) * span * p.cols;
    for (int j = t; j < zeros; j += kThreads) {
      const int r = j / p.cols;
      const int at = r < head ? r : span - tail + (r - head);
      row0[static_cast<long long>(at) * p.cols + (j - r * p.cols)] = T(0);
    }
  }
  if (p.bulk) {
    if (t == 0) {
      unsigned total = plane_bytes;
      for (int q = 0; q < ranges; ++q) {
        const long long lo = r0 + (p.union_window ? p.off_min : offs[q]);
        const long long a = clip(lo, n_in), b = clip(lo + span, n_in);
        if (b > a) total += static_cast<unsigned>((b - a) * p.nb * sizeof(T));
      }
      mbar_expect(bar, total);
      if (plane_bytes) bulk_copy(stage, src_planes, plane_bytes, bar);
      for (int q = 0; q < ranges; ++q) {
        const long long lo = r0 + (p.union_window ? p.off_min : offs[q]);
        const long long a = clip(lo, n_in), b = clip(lo + span, n_in);
        if (b > a) {
          bulk_copy(win + (static_cast<long long>(q) * span + (a - lo))
                              * p.nb,
                    x + a * p.nb,
                    static_cast<unsigned>((b - a) * p.nb * sizeof(T)), bar);
        }
      }
    }
    return;
  }
  for (unsigned j = t; j < plane_bytes / 16; j += kThreads) {
    async_copy<16>(stage + 16 * j, src_planes + 16 * j);
  }
  const int per_row = cw / CPT;
  for (int q = 0; q < ranges; ++q) {
    const long long lo = r0 + (p.union_window ? p.off_min : offs[q]);
    const long long a = clip(lo, n_in), b = clip(lo + span, n_in);
    const int pieces = b > a ? static_cast<int>(b - a) * per_row : 0;
    T* dst = win + (static_cast<long long>(q) * span + (a - lo)) * p.cols;
    const T* src = x + a * p.nb + c0;
    for (int j = t; j < pieces; j += kThreads) {
      const int r = j / per_row, g = j - r * per_row;
      async_copy<static_cast<int>(CPT * sizeof(T))>(
          dst + static_cast<long long>(r) * p.cols + g * CPT,
          src + static_cast<long long>(r) * p.nb + g * CPT);
    }
  }
}

// sum tile `tile`: thread (row i, column group g), CPT columns each, the
// diagonals in the plan's (ascending) order, from the staged planes and
// window, or (kDirect: one diagonal, no X value read twice, nothing
// staged) straight from global memory with a read outside X giving zero
template <typename T, int CPT, bool kDirect>
__device__ __forceinline__ void sum_tile(const DiaBPlan& p, const int* offs,
                                         int tile, const unsigned char* stage,
                                         const T* __restrict__ x, int n_in,
                                         T* __restrict__ y) {
  const int rt = tile / p.col_tiles;
  const int c0 = (tile - rt * p.col_tiles) * p.cols;
  const long long r0 = static_cast<long long>(rt) * p.rows;
  const T* planes = kDirect
      ? static_cast<const T*>(p.planes) + r0 * p.ndiag
      : reinterpret_cast<const T*>(stage);
  const T* win = planes + p.ndiag * p.rows;
  const int groups = p.cols / CPT;
  const int di = kThreads / groups, dg = kThreads % groups;
  const long long left = p.n_out - r0;
  const int rows = left < p.rows ? static_cast<int>(left) : p.rows;
  int i = threadIdx.x / groups, g = threadIdx.x % groups;
  while (i < rows) {
    const int col = c0 + g * CPT;
    if (col < p.nb) {
      Pack<T, CPT> acc;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc.v[c] = T(0);
      for (int d = 0; d < p.ndiag; ++d) {
        const T a = planes[d * p.rows + i];
        Pack<T, CPT> xv;
        if (kDirect) {
          const long long xr = r0 + i + offs[d];
          if (xr >= 0 && xr < n_in) {
            xv = *reinterpret_cast<const Pack<T, CPT>*>(x + xr * p.nb + col);
          } else {
#pragma unroll
            for (int c = 0; c < CPT; ++c) xv.v[c] = T(0);
          }
        } else {
          const int w = p.union_window ? i + offs[d] - p.off_min
                                       : d * p.rows + i;
          xv = *reinterpret_cast<const Pack<T, CPT>*>(
              win + static_cast<long long>(w) * p.cols + g * CPT);
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc.v[c] = acc.v[c] + a * xv.v[c];
      }
      *reinterpret_cast<Pack<T, CPT>*>(y + (r0 + i) * p.nb + col) = acc;
    }
    g += dg;
    i += di;
    if (g >= groups) {
      g -= groups;
      ++i;
    }
  }
}

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
dia_spmm_kernel(const __grid_constant__ DiaBPlan p, const T* __restrict__ x,
                int n_in, T* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem + 2 * p.stage_bytes);
  int* offs = reinterpret_cast<int*>(bars + 2);
  const int t = threadIdx.x;
  for (int d = t; d < p.ndiag; d += kThreads) {
    offs[d] = p.ndiag <= kParamDiags ? p.offsets[d] : p.offs[d];
  }
  if (p.direct) {
    __syncthreads();
    for (int tile = blockIdx.x; tile < p.row_tiles * p.col_tiles;
         tile += gridDim.x) {
      sum_tile<T, CPT, true>(p, offs, tile, nullptr, x, n_in, y);
    }
    return;
  }
  if (p.bulk && t == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int n_tiles = p.row_tiles * p.col_tiles;
  int tile = blockIdx.x;
  if (tile < n_tiles) stage_tile<T, CPT>(p, offs, x, n_in, tile, smem, bars);
  if (!p.bulk) async_commit();
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    const int s = it & 1;
    if (next < n_tiles) {
      stage_tile<T, CPT>(p, offs, x, n_in, next,
                         smem + (s ^ 1) * p.stage_bytes, bars + (s ^ 1));
    }
    if (p.bulk) {
      mbar_wait(bars + s, (it >> 1) & 1);
    } else {
      async_commit();
      async_wait_all_but_one();
    }
    __syncthreads();
    sum_tile<T, CPT, false>(p, offs, tile, smem + s * p.stage_bytes, x, n_in,
                            y);
    fence_async_shared();
    __syncthreads();
  }
}

template <typename T, int CPT>
int occupancy(int smem_bytes, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      dia_spmm_kernel<T, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, dia_spmm_kernel<T, CPT>, kThreads, smem_bytes);
  }
  return static_cast<int>(err);
}

template <typename T>
int launch_batch(const DiaBPlan* plan, const T* x, int n_in, T* y,
                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan->cpt == 1) {
    dia_spmm_kernel<T, 1><<<plan->grid, kThreads, plan->smem_bytes, s>>>(
        *plan, x, n_in, y);
  } else {
    dia_spmm_kernel<T, 16 / sizeof(T)>
        <<<plan->grid, kThreads, plan->smem_bytes, s>>>(*plan, x, n_in, y);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch(const P* vals, const int* offs, int ndiag, const T* x, int n_in,
           T* y, int n_out, void* stream) {
  if (n_out > 0) {
    dia_spmv_kernel<T, P><<<pslp::grid_for(n_out), pslp::kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        vals, offs, ndiag, x, n_in, y, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PSLP_DIA_SPMV(SUFFIX, T, P)                                         \
  PSLP_EXPORT int pslp_dia_spmv_##SUFFIX(const P* vals, const int* offs,   \
                                         int ndiag, const T* x, int n_in,  \
                                         T* y, int n_out, void* stream) {  \
    return launch<T, P>(vals, offs, ndiag, x, n_in, y, n_out, stream);     \
  }

PSLP_DIA_SPMV(f32, float, float)
PSLP_DIA_SPMV(f64, double, double)
// float32 products on planes stored in bfloat16 (exact values), the JAX
// package's allow_bf16="exact" storage: half the plane bytes
PSLP_DIA_SPMV(f32_bf16, float, __nv_bfloat16)

PSLP_EXPORT int pslp_dia_spmm_f32(const DiaBPlan* plan, const float* x,
                                  int n_in, float* y, void* stream) {
  return launch_batch<float>(plan, x, n_in, y, stream);
}

PSLP_EXPORT int pslp_dia_spmm_f64(const DiaBPlan* plan, const double* x,
                                  int n_in, double* y, void* stream) {
  return launch_batch<double>(plan, x, n_in, y, stream);
}

// resident CTAs per SM of H-DIA-B at `smem_bytes` of shared memory (and the
// kernel's shared-memory limit raised to 227 KB); `cpt` picks the variant
PSLP_EXPORT int pslp_dia_spmm_occupancy_f32(int cpt, int smem_bytes,
                                            int* blocks) {
  return cpt == 1 ? occupancy<float, 1>(smem_bytes, blocks)
                  : occupancy<float, 4>(smem_bytes, blocks);
}

PSLP_EXPORT int pslp_dia_spmm_occupancy_f64(int cpt, int smem_bytes,
                                            int* blocks) {
  return cpt == 1 ? occupancy<double, 1>(smem_bytes, blocks)
                  : occupancy<double, 2>(smem_bytes, blocks);
}

PSLP_EXPORT const char* pslp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
