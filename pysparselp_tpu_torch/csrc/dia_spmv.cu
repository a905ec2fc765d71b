// H-DIA: DIA sparse matrix-vector product y[r] = sum_d vals[d, r] * x[r + off_d].
//
// Replaces pysparselp_tpu/ops/dia_pallas.py::_dia_matvec_pallas (K4) and
// computes the function of _dia_matvec_pallas_dyn (K5): the offsets are a
// runtime int32 device array, so one compiled kernel serves every operator.
//
// Bound on the H100: memory.  A call moves ndiag * n_out * itemsize bytes of
// values, plus |x| and |y|; the arithmetic is one multiply-add per value.
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
// all B columns, plus B * (n_in + n_out) * itemsize of X and Y.  Design: one
// thread per (r, b), b fastest (a block of 256 / min(B, 256) rows by
// min(B, 256) columns, so no thread divides by B), so the B threads of a
// row read its plane value once (a broadcast) and neighbouring X and Y
// entries; the diagonals
// are summed by the same pslp::dia_row arithmetic (ascending offsets, every
// product and sum rounded apart), so column b equals H-DIA on X[:, b] bit
// for bit.
#include "common.cuh"

namespace {

template <typename T>
__global__ void dia_spmv_kernel(const T* __restrict__ vals,
                                const int* __restrict__ offs, int ndiag,
                                const T* __restrict__ x, int n_in,
                                T* __restrict__ y, int n_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_out) return;
  y[r] = pslp::dia_row<T>(vals, offs, ndiag, n_out, x, n_in, r);
}

template <typename T>
__global__ void dia_spmm_kernel(const T* __restrict__ vals,
                                const int* __restrict__ offs, int ndiag,
                                const T* __restrict__ x, int n_in,
                                T* __restrict__ y, int n_out, int nb) {
  // a block is blockDim.y rows x blockDim.x columns, x fastest
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= n_out) return;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    T acc = T(0);
    for (int k = 0; k < ndiag; ++k) {
      const long long c = static_cast<long long>(r) + offs[k];
      const T xv = (c >= 0 && c < n_in) ? x[c * nb + b] : T(0);
      acc = acc + vals[static_cast<long long>(k) * n_out + r] * xv;
    }
    y[static_cast<long long>(r) * nb + b] = acc;
  }
}

template <typename T>
int launch_batch(const T* vals, const int* offs, int ndiag, const T* x,
                 int n_in, T* y, int n_out, int nb, void* stream) {
  if (n_out > 0 && nb > 0) {
    const int bx = nb < pslp::kBlock ? nb : pslp::kBlock;
    const int by = pslp::kBlock / bx;
    dia_spmm_kernel<T><<<(n_out + by - 1) / by, dim3(bx, by), 0,
                         static_cast<cudaStream_t>(stream)>>>(
        vals, offs, ndiag, x, n_in, y, n_out, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* vals, const int* offs, int ndiag, const T* x, int n_in,
           T* y, int n_out, void* stream) {
  if (n_out > 0) {
    dia_spmv_kernel<T><<<pslp::grid_for(n_out), pslp::kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        vals, offs, ndiag, x, n_in, y, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

PSLP_EXPORT int pslp_dia_spmv_f32(const float* vals, const int* offs,
                                  int ndiag, const float* x, int n_in,
                                  float* y, int n_out, void* stream) {
  return launch<float>(vals, offs, ndiag, x, n_in, y, n_out, stream);
}

PSLP_EXPORT int pslp_dia_spmv_f64(const double* vals, const int* offs,
                                  int ndiag, const double* x, int n_in,
                                  double* y, int n_out, void* stream) {
  return launch<double>(vals, offs, ndiag, x, n_in, y, n_out, stream);
}

PSLP_EXPORT int pslp_dia_spmm_f32(const float* vals, const int* offs,
                                  int ndiag, const float* x, int n_in,
                                  float* y, int n_out, int nb, void* stream) {
  return launch_batch<float>(vals, offs, ndiag, x, n_in, y, n_out, nb,
                             stream);
}

PSLP_EXPORT int pslp_dia_spmm_f64(const double* vals, const int* offs,
                                  int ndiag, const double* x, int n_in,
                                  double* y, int n_out, int nb,
                                  void* stream) {
  return launch_batch<double>(vals, offs, ndiag, x, n_in, y, n_out, nb,
                              stream);
}

PSLP_EXPORT const char* pslp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
