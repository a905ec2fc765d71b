// H-CPDIA: whole Chambolle-Pock iterations on DIA operators, eq + ineq, two
// launches an iteration.
//
// Replaces pysparselp_tpu/ops/cp_windowed.py::build_windowed_call (K3, one
// iteration per launch over row windows with a recomputed halo, eq + ineq).
// The small aligned grids of pysparselp_tpu/ops/cp_fused.py::_cp_fused_call
// (K2) run on H-CPDIA-R (cp_dia_resident.cu), one launch per chunk; this
// kernel pair serves every DIA problem whose state does not fit one
// cluster's shared memory (ops/cp_dia.py::cp_dia_plan).  The iteration:
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
// Potts-300 shape (13 + 13 planes of 360k f32) that is ~60 MB, close to the
// 50 MB L2.  Design: each iteration is two launches with no halo.  The
// primal kernel is one thread per column (taps of A^T over y); the dual
// kernel is one thread per row over the inequality rows and, if present, the
// equality rows (taps of A over x3).  The launch boundary is the global
// barrier that the TPU kernel obtained from recomputing a halo.  The host
// loop below launches all 2 * nsteps kernels onto one stream, so Python pays
// one call per chunk.
#include "common.cuh"

namespace {

using pslp::dia_row;

template <typename T>
__global__ void cp_primal_kernel(int n, const T* __restrict__ c,
                                 const T* __restrict__ t,
                                 const T* __restrict__ lb,
                                 const T* __restrict__ ub,
                                 const T* __restrict__ vte,
                                 const int* __restrict__ offte, int ndte,
                                 const T* ye, int me,
                                 const T* __restrict__ vt,
                                 const int* __restrict__ offt, int ndt,
                                 const T* y, int m, T theta, T* x, T* x3,
                                 T* sx) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  T d = c[j];
  if (me > 0) d = d + dia_row<T>(vte, offte, ndte, n, ye, me, j);
  if (m > 0) d = d + dia_row<T>(vt, offt, ndt, n, y, m, j);
  const T xo = x[j];
  const T x2 = pslp::clamp<T>(xo - t[j] * d, lb[j], ub[j]);
  x3[j] = (T(1) + theta) * x2 - theta * xo;
  x[j] = x2;
  if (sx != nullptr) sx[j] = sx[j] + x2;
}

template <typename T>
__global__ void cp_dual_kernel(int rows, const T* x3, int n,
                               const T* __restrict__ ve,
                               const int* __restrict__ offe, int nde,
                               const T* __restrict__ be,
                               const T* __restrict__ se, T* ye, T* sye, int me,
                               const T* __restrict__ v,
                               const int* __restrict__ off, int nd,
                               const T* __restrict__ b,
                               const T* __restrict__ s, T* y, T* sy, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  if (i < me) {
    const T r = dia_row<T>(ve, offe, nde, me, x3, n, i) - be[i];
    const T yn = ye[i] + se[i] * r;
    ye[i] = yn;
    if (sye != nullptr) sye[i] = sye[i] + yn;
  }
  if (i < m) {
    const T r = dia_row<T>(v, off, nd, m, x3, n, i) - b[i];
    T yn = y[i] + s[i] * r;
    yn = pslp::clamp_min0<T>(yn);
    y[i] = yn;
    if (sy != nullptr) sy[i] = sy[i] + yn;
  }
}

template <typename T>
int chunk(int n, int m, int me, const T* c, const T* t, const T* lb,
          const T* ub, const T* vt, const int* offt, int ndt, const T* v,
          const int* off, int nd, const T* b, const T* s, const T* vte,
          const int* offte, int ndte, const T* ve, const int* offe, int nde,
          const T* be, const T* se, T* x, T* x3, T* y, T* ye, T* sx, T* sy,
          T* sye, T theta, int nsteps, int with_sums, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!with_sums) sx = sy = sye = nullptr;
  const int rows = m > me ? m : me;
  for (int it = 0; it < nsteps; ++it) {
    if (n > 0) {
      cp_primal_kernel<T><<<pslp::grid_for(n), pslp::kBlock, 0, st>>>(
          n, c, t, lb, ub, vte, offte, ndte, ye, me, vt, offt, ndt, y, m,
          theta, x, x3, sx);
    }
    if (rows > 0) {
      cp_dual_kernel<T><<<pslp::grid_for(rows), pslp::kBlock, 0, st>>>(
          rows, x3, n, ve, offe, nde, be, se, ye, sye, me, v, off, nd, b, s,
          y, sy, m);
    }
    const cudaError_t err = cudaPeekAtLastError();
    if (err != cudaSuccess) break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PSLP_CP_DIA(SUFFIX, T)                                               \
  PSLP_EXPORT int pslp_cp_dia_chunk_##SUFFIX(                                \
      int n, int m, int me, const T* c, const T* t, const T* lb,             \
      const T* ub, const T* vt, const int* offt, int ndt, const T* v,        \
      const int* off, int nd, const T* b, const T* s, const T* vte,          \
      const int* offte, int ndte, const T* ve, const int* offe, int nde,     \
      const T* be, const T* se, T* x, T* x3, T* y, T* ye, T* sx, T* sy,      \
      T* sye, T theta, int nsteps, int with_sums, void* stream) {            \
    return chunk<T>(n, m, me, c, t, lb, ub, vt, offt, ndt, v, off, nd, b, s, \
                    vte, offte, ndte, ve, offe, nde, be, se, x, x3, y, ye,   \
                    sx, sy, sye, theta, nsteps, with_sums, stream);          \
  }

PSLP_CP_DIA(f32, float)
PSLP_CP_DIA(f64, double)
