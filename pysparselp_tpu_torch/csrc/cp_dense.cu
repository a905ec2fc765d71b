// H-CPDENSE: nsteps whole Chambolle-Pock iterations on dense A_e / A_i in one
// launch.
//
// Replaces pysparselp_tpu/ops/cp_fused.py::_cp_dense_fused_call (K1), which
// kept both dense systems and every vector in one TPU core's VMEM for a whole
// chunk.  Same iteration as H-CPDIA (cp_dia.cu) with dense operators, and the
// same optional running sums of x, y_e and y_i.
//
// Bound on the H100: latency.  At the netlib size this kernel serves (SC105:
// 105 x 103, 43 KB in f32) one iteration is ~22k multiply-adds, far too
// little to fill the card; what costs is the chain of dependent phases.
// Design: ONE persistent thread block runs all nsteps iterations, so the
// per-iteration cost is two __syncthreads() instead of kernel launches.
// A_e and A_i are staged once per launch in dynamic shared memory when they
// fit (<= kSmemBudget bytes; above 48 KB this needs the
// cudaFuncAttributeMaxDynamicSharedMemorySize opt-in below), otherwise they
// are read from global memory, where at the dense budget (4 MB) they sit in
// L2.  Phase 1 (d, x, x3) is one thread per column, walking the rows in
// order; phase 2 (residuals, duals) is one warp per row with a shuffle
// reduction.  Accumulation is in the working precision (no TF32), as the
// TPU kernel's precision=HIGHEST.  The state vectors stay in global memory:
// __syncthreads() orders a block's global writes before its later reads.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr size_t kSmemBudget = 200 * 1024;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cp_dense_kernel(int n, int me, int mi, const T* __restrict__ c,
                const T* __restrict__ t, const T* __restrict__ lb,
                const T* __restrict__ ub, const T* ae_g,
                const T* __restrict__ be, const T* __restrict__ se,
                const T* ai_g, const T* __restrict__ bi,
                const T* __restrict__ si, T* x, T* x3, T* ye, T* yi, T* sx,
                T* sye, T* syi, T theta, int nsteps, int use_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long ne = static_cast<long long>(me) * n;
  const long long ni = static_cast<long long>(mi) * n;
  const T* ae = ae_g;
  const T* ai = ai_g;
  if (use_smem) {
    T* sm = reinterpret_cast<T*>(smem_raw);
    for (long long k = threadIdx.x; k < ne; k += blockDim.x) sm[k] = ae_g[k];
    for (long long k = threadIdx.x; k < ni; k += blockDim.x) sm[ne + k] = ai_g[k];
    ae = sm;
    ai = sm + ne;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int it = 0; it < nsteps; ++it) {
    // phase 1: d = c + A_e^T y_e + A_i^T y_i, primal prox, over-relaxation
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      T d = c[j];
      if (me > 0) {
        T acc = T(0);
        for (int i = 0; i < me; ++i) acc = acc + ae[static_cast<long long>(i) * n + j] * ye[i];
        d = d + acc;
      }
      if (mi > 0) {
        T acc = T(0);
        for (int i = 0; i < mi; ++i) acc = acc + ai[static_cast<long long>(i) * n + j] * yi[i];
        d = d + acc;
      }
      const T xo = x[j];
      const T x2 = pslp::clamp<T>(xo - t[j] * d, lb[j], ub[j]);
      x3[j] = (T(1) + theta) * x2 - theta * xo;
      x[j] = x2;
      if (sx != nullptr) sx[j] = sx[j] + x2;
    }
    __syncthreads();
    // phase 2: residuals over x3 and the dual steps, one warp per row
    for (int row = warp; row < me + mi; row += nwarps) {
      const bool eq = row < me;
      const int i = eq ? row : row - me;
      const T* a = (eq ? ae : ai) + static_cast<long long>(i) * n;
      T acc = T(0);
      for (int j = lane; j < n; j += 32) acc = acc + a[j] * x3[j];
      acc = warp_sum<T>(acc);
      if (lane == 0) {
        if (eq) {
          const T yn = ye[i] + se[i] * (acc - be[i]);
          ye[i] = yn;
          if (sye != nullptr) sye[i] = sye[i] + yn;
        } else {
          T yn = yi[i] + si[i] * (acc - bi[i]);
          yn = yn > T(0) ? yn : T(0);
          yi[i] = yn;
          if (syi != nullptr) syi[i] = syi[i] + yn;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
int chunk(int n, int me, int mi, const T* c, const T* t, const T* lb,
          const T* ub, const T* ae, const T* be, const T* se, const T* ai,
          const T* bi, const T* si, T* x, T* x3, T* ye, T* yi, T* sx, T* sye,
          T* syi, T theta, int nsteps, int with_sums, void* stream) {
  if (!with_sums) sx = sye = syi = nullptr;
  const size_t bytes = (static_cast<size_t>(me) + mi) * n * sizeof(T);
  const int use_smem = bytes <= kSmemBudget;
  const size_t smem = use_smem ? bytes : 0;
  cudaError_t err = cudaFuncSetAttribute(
      cp_dense_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nsteps > 0 && n > 0) {
    cp_dense_kernel<T><<<1, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        n, me, mi, c, t, lb, ub, ae, be, se, ai, bi, si, x, x3, ye, yi, sx,
        sye, syi, theta, nsteps, use_smem);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PSLP_CP_DENSE(SUFFIX, T)                                             \
  PSLP_EXPORT int pslp_cp_dense_chunk_##SUFFIX(                              \
      int n, int me, int mi, const T* c, const T* t, const T* lb,            \
      const T* ub, const T* ae, const T* be, const T* se, const T* ai,       \
      const T* bi, const T* si, T* x, T* x3, T* ye, T* yi, T* sx, T* sye,    \
      T* syi, T theta, int nsteps, int with_sums, void* stream) {            \
    return chunk<T>(n, me, mi, c, t, lb, ub, ae, be, se, ai, bi, si, x, x3,  \
                    ye, yi, sx, sye, syi, theta, nsteps, with_sums, stream); \
  }

PSLP_CP_DENSE(f32, float)
PSLP_CP_DENSE(f64, double)
