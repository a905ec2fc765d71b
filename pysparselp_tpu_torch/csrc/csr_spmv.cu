// H-CSR: CSR sparse matrix-vector product
//   y[r] = sum_{k = indptr[r]}^{indptr[r+1]-1} vals[k] * x[indices[k]].
//
// Replaces the routed gather-ELL apparatus of pysparselp_tpu/ops/ell_routed.py:
// the kernels _routed_kernel (:1006, launched by _routed_spmv_call, K7) and
// _make_tiled_kernel (:1058, launched by _routed_tiled_spmv_call, K8), and the
// ~900 lines of host routing behind them (build_routes / _tiled_transform,
// :80-900).  That apparatus factors every gather into three lane/sublane
// shuffles because the TPU has no general gather (ell_routed.py:3-11).  Hopper
// gathers natively, so none of the routing is ported: this file computes what
// the routes compute, y = A x for an unstructured A.  Both orientations use
// this one kernel: the caller keeps the CSR of A for A x and the CSR of A^T
// (the CSC of A) for A^T y.  There are no atomics, so every run of the same
// inputs gives the same bits.
//
// Bound on the H100 (3.35 TB/s HBM at 700 W): memory.  One call moves
//   nnz * (itemsize + 4)            values and column indices,
//   (n_out + 1) * 4                 row pointers,
//   n_out * itemsize                the output,
// plus the gathered x: n_in * itemsize when x stays in the 50 MB L2 (the
// transport LP's x, 1M f32, is 4 MB), more when the gathers miss.  The
// arithmetic is one multiply-add per stored entry.
//
// Design (a simple kernel that is right first):
// * rows of up to kLongStrides * W entries: a sub-warp of W lanes per row
//   (W = 2..32, picked by the wrapper from the mean row length), lanes
//   striding over the row, then a fixed shuffle tree (xor 1, 2, ..., W/2);
// * longer rows (the k-medians LP's hot used[c] columns of A^T, ~5,000 entries)
//   are skipped by that launch and get a block of kBlock threads each in a
//   second launch over the wrapper's list of long rows: threads stride, each
//   warp reduces by the same shuffle tree, warp partials are summed in order.
// * x is read through the read-only data path (__ldg).
#include "common.cuh"

namespace {

constexpr int kLongStrides = 32;  // a row longer than 32 * W entries is long

template <typename T>
__device__ __forceinline__ T gather_dot(const int* __restrict__ indices,
                                        const T* __restrict__ vals,
                                        const T* __restrict__ x, int begin,
                                        int end, int lane, int step) {
  T acc = T(0);
  for (int k = begin + lane; k < end; k += step) {
    acc = acc + vals[k] * __ldg(x + indices[k]);
  }
  return acc;
}

template <typename T, int W>
__global__ void csr_rows_kernel(const int* __restrict__ indptr,
                                const int* __restrict__ indices,
                                const T* __restrict__ vals,
                                const T* __restrict__ x, T* __restrict__ y,
                                int n_out) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = tid / W;
  // every lane of a sub-warp has the same row, so a sub-warp leaves together
  if (row >= n_out) return;
  const int lane = threadIdx.x % W;
  const int begin = indptr[row];
  const int end = indptr[row + 1];
  if (end - begin > kLongStrides * W) return;  // a long row: second launch
  T acc = gather_dot(indices, vals, x, begin, end, lane, W);
  const unsigned group = (threadIdx.x % 32) / W * W;
  const unsigned mask =
      W == 32 ? 0xffffffffu : (((1u << (W % 32)) - 1u) << group);
#pragma unroll
  for (int off = 1; off < W; off <<= 1) {
    acc = acc + __shfl_xor_sync(mask, acc, off, W);
  }
  if (lane == 0) y[row] = acc;
}

template <typename T>
__global__ void csr_long_rows_kernel(const int* __restrict__ indptr,
                                     const int* __restrict__ indices,
                                     const T* __restrict__ vals,
                                     const T* __restrict__ x,
                                     T* __restrict__ y,
                                     const int* __restrict__ long_rows) {
  __shared__ T partial[pslp::kBlock / 32];
  const int row = long_rows[blockIdx.x];
  T acc = gather_dot(indices, vals, x, indptr[row], indptr[row + 1],
                     threadIdx.x, blockDim.x);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T sum = T(0);
    for (int w = 0; w < pslp::kBlock / 32; ++w) sum = sum + partial[w];
    y[row] = sum;
  }
}

template <typename T, int W>
void launch_rows(const int* indptr, const int* indices, const T* vals,
                 const T* x, T* y, int n_out, cudaStream_t stream) {
  const long long threads = static_cast<long long>(n_out) * W;
  csr_rows_kernel<T, W><<<pslp::grid_for(threads), pslp::kBlock, 0, stream>>>(
      indptr, indices, vals, x, y, n_out);
}

template <typename T>
int launch(const int* indptr, const int* indices, const T* vals, const T* x,
           T* y, int n_out, int width, const int* long_rows, int n_long,
           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_out > 0) {
    switch (width) {
      case 2: launch_rows<T, 2>(indptr, indices, vals, x, y, n_out, stream); break;
      case 4: launch_rows<T, 4>(indptr, indices, vals, x, y, n_out, stream); break;
      case 8: launch_rows<T, 8>(indptr, indices, vals, x, y, n_out, stream); break;
      case 16: launch_rows<T, 16>(indptr, indices, vals, x, y, n_out, stream); break;
      case 32: launch_rows<T, 32>(indptr, indices, vals, x, y, n_out, stream); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (n_long > 0) {
    csr_long_rows_kernel<T><<<n_long, pslp::kBlock, 0, stream>>>(
        indptr, indices, vals, x, y, long_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

PSLP_EXPORT int pslp_csr_spmv_f32(const int* indptr, const int* indices,
                                  const float* vals, const float* x, float* y,
                                  int n_out, int width, const int* long_rows,
                                  int n_long, void* stream) {
  return launch<float>(indptr, indices, vals, x, y, n_out, width, long_rows,
                       n_long, stream);
}

PSLP_EXPORT int pslp_csr_spmv_f64(const int* indptr, const int* indices,
                                  const double* vals, const double* x,
                                  double* y, int n_out, int width,
                                  const int* long_rows, int n_long,
                                  void* stream) {
  return launch<double>(indptr, indices, vals, x, y, n_out, width, long_rows,
                        n_long, stream);
}
