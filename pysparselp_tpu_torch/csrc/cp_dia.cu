// H-CPDIA: whole Chambolle-Pock iterations on DIA operators, eq + ineq, two
// launches an iteration.
//
// Replaces pysparselp_tpu/ops/cp_windowed.py::build_windowed_call (K3, one
// iteration per launch over row windows with a recomputed halo, eq + ineq).
// The small aligned grids of pysparselp_tpu/ops/cp_fused.py::_cp_fused_call
// (K2) run on H-CPDIA-R (cp_dia_resident.cu), one launch per chunk, and the
// grids whose slab of planes fits one CTA of a CTA-an-SM grid on H-CPDIA-G
// (cp_dia_grid.cu), one cooperative launch per chunk; this kernel pair
// serves every other DIA problem (ops/cp_dia.py::cp_dia_plan: Potts-300 in
// float64, Potts-500 and up).  The planes are read as stored (P: the
// compute type, or bfloat16 for a float32 solve whose values are exact
// there) and widened exactly (pslp::widen).  The iteration:
//
//   d  = c + A_e^T y_e + A_i^T y_i
//   x2 = clip(x - T*d, l, u);   x3 = (1 + theta) x2 - theta x;   x = x2
//   y_e = y_e + s_e (A_e x3 - b_e)
//   y_i = max(y_i + s_i (A_i x3 - b_i), 0)
//
// with optional running sums of x, y_e and y_i (the restart controller's
// averages).
//
// Bound on the H100: memory.  One iteration streams every value plane once
// (ndiag_t * n + ndiag * m per system) plus about a dozen vectors; at the
// Potts-300 shape (13 + 13 planes of 360k) that is ~59 MB on float32
// planes, ~40 MB on bfloat16 planes, close to the 50 MB L2.  Design: each
// iteration is two launches with no halo.  The primal kernel is one thread per
// column (taps of A^T over y); the dual kernel is one thread per row over the
// inequality rows and, if present, the equality rows (taps of A over x3).  The
// launch boundary is the global barrier that the TPU kernel obtained from
// recomputing a halo.  The host loop below launches all 2 * nsteps kernels onto
// one stream, so Python pays one call per chunk.
//
// The shard entry (pslp_cp_dia_shard_step_*) runs one such iteration on one
// rank's slice of the position space, the counterpart of K3 run per shard
// by pysparselp_tpu/parallel/sharded_cp_windowed.py.  The slice holds global
// positions [g0, g0 + len): the rank's interior [i0, i1) and a halo on each
// side that the caller refreshes from the neighbouring ranks before the
// call.  The primal launch runs over [p0, p1), the interior widened by the
// reach of A's taps (the dual reads x3 there), and reads y inside the halo;
// the dual launch and the running sums run over the interior.  A position
// computes the operations of the one-device kernels above in the same
// order, and a tap whose global position lies outside the matrix adds
// vals * 0 as dia_row does, so one call equals one iteration of the chunk
// entry on the whole system bit for bit, on any number of ranks.
#include "common.cuh"

namespace {

using pslp::dia_row;

template <typename T, typename P>
__global__ void cp_primal_kernel(int n, const T* __restrict__ c,
                                 const T* __restrict__ t,
                                 const T* __restrict__ lb,
                                 const T* __restrict__ ub,
                                 const P* __restrict__ vte,
                                 const int* __restrict__ offte, int ndte,
                                 const T* ye, int me,
                                 const P* __restrict__ vt,
                                 const int* __restrict__ offt, int ndt,
                                 const T* y, int m, T theta, T* x, T* x3,
                                 T* sx) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  T d = c[j];
  if (me > 0) d = d + dia_row<T, P>(vte, offte, ndte, n, ye, me, j);
  if (m > 0) d = d + dia_row<T, P>(vt, offt, ndt, n, y, m, j);
  const T xo = x[j];
  const T x2 = pslp::clamp<T>(xo - t[j] * d, lb[j], ub[j]);
  x3[j] = (T(1) + theta) * x2 - theta * xo;
  x[j] = x2;
  if (sx != nullptr) sx[j] = sx[j] + x2;
}

template <typename T, typename P>
__global__ void cp_dual_kernel(int rows, const T* x3, int n,
                               const P* __restrict__ ve,
                               const int* __restrict__ offe, int nde,
                               const T* __restrict__ be,
                               const T* __restrict__ se, T* ye, T* sye, int me,
                               const P* __restrict__ v,
                               const int* __restrict__ off, int nd,
                               const T* __restrict__ b,
                               const T* __restrict__ s, T* y, T* sy, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  if (i < me) {
    const T r = dia_row<T, P>(ve, offe, nde, me, x3, n, i) - be[i];
    const T yn = ye[i] + se[i] * r;
    ye[i] = yn;
    if (sye != nullptr) sye[i] = sye[i] + yn;
  }
  if (i < m) {
    const T r = dia_row<T, P>(v, off, nd, m, x3, n, i) - b[i];
    T yn = y[i] + s[i] * r;
    yn = pslp::clamp_min0<T>(yn);
    y[i] = yn;
    if (sy != nullptr) sy[i] = sy[i] + yn;
  }
}

template <typename T, typename P>
int chunk(int n, int m, int me, const T* c, const T* t, const T* lb,
          const T* ub, const P* vt, const int* offt, int ndt, const P* v,
          const int* off, int nd, const T* b, const T* s, const P* vte,
          const int* offte, int ndte, const P* ve, const int* offe, int nde,
          const T* be, const T* se, T* x, T* x3, T* y, T* ye, T* sx, T* sy,
          T* sye, T theta, int nsteps, int with_sums, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!with_sums) sx = sy = sye = nullptr;
  const int rows = m > me ? m : me;
  for (int it = 0; it < nsteps; ++it) {
    if (n > 0) {
      cp_primal_kernel<T, P><<<pslp::grid_for(n), pslp::kBlock, 0, st>>>(
          n, c, t, lb, ub, vte, offte, ndte, ye, me, vt, offt, ndt, y, m,
          theta, x, x3, sx);
    }
    if (rows > 0) {
      cp_dual_kernel<T, P><<<pslp::grid_for(rows), pslp::kBlock, 0, st>>>(
          rows, x3, n, ve, offe, nde, be, se, ye, sye, me, v, off, nd, b, s,
          y, sy, m);
    }
    const cudaError_t err = cudaPeekAtLastError();
    if (err != cudaSuccess) break;
  }
  return static_cast<int>(cudaGetLastError());
}

// One row of a DIA product on a rank's slice: local index jl holds global
// position g; tap k reads v at local index jl + offs[k] when its global
// position lies in [0, nv), else zero (dia_row's arithmetic, with the
// planes and v indexed locally, the bounds globally).
template <typename T, typename P>
__device__ __forceinline__ T dia_row_local(const P* __restrict__ vals,
                                           const int* __restrict__ offs,
                                           int ndiag, int stride, const T* v,
                                           int nv, long long g, int jl) {
  T acc = T(0);
  for (int k = 0; k < ndiag; ++k) {
    const int o = offs[k];
    const long long c = g + o;
    const T xv = (c >= 0 && c < nv) ? v[jl + o] : T(0);
    const P a = vals[static_cast<long long>(k) * stride + jl];
    acc = acc + pslp::widen<T>(a) * xv;
  }
  return acc;
}

template <typename T, typename P>
__global__ void cp_shard_primal_kernel(
    int len, int g0, int p0, int p1, int i0, int i1, int n,
    const T* __restrict__ c, const T* __restrict__ t,
    const T* __restrict__ lb, const T* __restrict__ ub,
    const P* __restrict__ vte, const int* __restrict__ offte, int ndte,
    const T* ye, int me, const P* __restrict__ vt,
    const int* __restrict__ offt, int ndt, const T* y, int m, T theta, T* x,
    T* x3, T* sx) {
  const int jl = p0 + blockIdx.x * blockDim.x + threadIdx.x;
  if (jl >= p1) return;
  const long long g = static_cast<long long>(g0) + jl;
  if (g < 0 || g >= n) return;
  T d = c[jl];
  if (me > 0)
    d = d + dia_row_local<T, P>(vte, offte, ndte, len, ye, me, g, jl);
  if (m > 0) d = d + dia_row_local<T, P>(vt, offt, ndt, len, y, m, g, jl);
  const T xo = x[jl];
  const T x2 = pslp::clamp<T>(xo - t[jl] * d, lb[jl], ub[jl]);
  x3[jl] = (T(1) + theta) * x2 - theta * xo;
  x[jl] = x2;
  if (sx != nullptr && jl >= i0 && jl < i1) sx[jl] = sx[jl] + x2;
}

template <typename T, typename P>
__global__ void cp_shard_dual_kernel(
    int len, int g0, int i0, int i1, int n, const T* x3,
    const P* __restrict__ ve, const int* __restrict__ offe, int nde,
    const T* __restrict__ be, const T* __restrict__ se, T* ye, T* sye, int me,
    const P* __restrict__ v, const int* __restrict__ off, int nd,
    const T* __restrict__ b, const T* __restrict__ s, T* y, T* sy, int m) {
  const int il = i0 + blockIdx.x * blockDim.x + threadIdx.x;
  if (il >= i1) return;
  const long long g = static_cast<long long>(g0) + il;
  if (g < 0) return;
  if (g < me) {
    const T r =
        dia_row_local<T, P>(ve, offe, nde, len, x3, n, g, il) - be[il];
    const T yn = ye[il] + se[il] * r;
    ye[il] = yn;
    if (sye != nullptr) sye[il] = sye[il] + yn;
  }
  if (g < m) {
    const T r = dia_row_local<T, P>(v, off, nd, len, x3, n, g, il) - b[il];
    T yn = y[il] + s[il] * r;
    yn = pslp::clamp_min0<T>(yn);
    y[il] = yn;
    if (sy != nullptr) sy[il] = sy[il] + yn;
  }
}

template <typename T, typename P>
int shard_step(int len, int g0, int p0, int p1, int i0, int i1, int n, int m,
               int me, const T* c, const T* lb, const T* ub, const P* vt,
               const int* offt, int ndt, const P* v, const int* off, int nd,
               const T* b, const P* vte, const int* offte, int ndte,
               const P* ve, const int* offe, int nde, const T* be, const T* t,
               const T* s, const T* se, T* x, T* x3, T* y, T* ye, T* sx,
               T* sy, T* sye, T theta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p1 > p0) {
    cp_shard_primal_kernel<T, P>
        <<<pslp::grid_for(p1 - p0), pslp::kBlock, 0, st>>>(
            len, g0, p0, p1, i0, i1, n, c, t, lb, ub, vte, offte, ndte, ye,
            me, vt, offt, ndt, y, m, theta, x, x3, sx);
  }
  if (i1 > i0) {
    cp_shard_dual_kernel<T, P>
        <<<pslp::grid_for(i1 - i0), pslp::kBlock, 0, st>>>(
            len, g0, i0, i1, n, x3, ve, offe, nde, be, se, ye, sye, me, v,
            off, nd, b, s, y, sy, m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PSLP_CP_DIA_SHARD(SUFFIX, T, P)                                       \
  PSLP_EXPORT int pslp_cp_dia_shard_step_##SUFFIX(                            \
      int len, int g0, int p0, int p1, int i0, int i1, int n, int m, int me,  \
      const T* c, const T* lb, const T* ub, const P* vt, const int* offt,     \
      int ndt, const P* v, const int* off, int nd, const T* b, const P* vte,  \
      const int* offte, int ndte, const P* ve, const int* offe, int nde,      \
      const T* be, const T* t, const T* s, const T* se, T* x, T* x3, T* y,    \
      T* ye, T* sx, T* sy, T* sye, T theta, void* stream) {                   \
    return shard_step<T, P>(len, g0, p0, p1, i0, i1, n, m, me, c, lb, ub,    \
                            vt, offt, ndt, v, off, nd, b, vte, offte, ndte,   \
                            ve, offe, nde, be, t, s, se, x, x3, y, ye, sx,    \
                            sy, sye, theta, stream);                          \
  }

PSLP_CP_DIA_SHARD(f32, float, float)
PSLP_CP_DIA_SHARD(f64, double, double)
PSLP_CP_DIA_SHARD(f32_bf16, float, __nv_bfloat16)

#define PSLP_CP_DIA(SUFFIX, T, P)                                            \
  PSLP_EXPORT int pslp_cp_dia_chunk_##SUFFIX(                                \
      int n, int m, int me, const T* c, const T* t, const T* lb,             \
      const T* ub, const P* vt, const int* offt, int ndt, const P* v,        \
      const int* off, int nd, const T* b, const T* s, const P* vte,          \
      const int* offte, int ndte, const P* ve, const int* offe, int nde,     \
      const T* be, const T* se, T* x, T* x3, T* y, T* ye, T* sx, T* sy,      \
      T* sye, T theta, int nsteps, int with_sums, void* stream) {            \
    return chunk<T, P>(n, m, me, c, t, lb, ub, vt, offt, ndt, v, off, nd, b, \
                       s, vte, offte, ndte, ve, offe, nde, be, se, x, x3, y, \
                       ye, sx, sy, sye, theta, nsteps, with_sums, stream);   \
  }

PSLP_CP_DIA(f32, float, float)
PSLP_CP_DIA(f64, double, double)
PSLP_CP_DIA(f32_bf16, float, __nv_bfloat16)
