// H-BSR: block-ELL sparse matrix-vector product
//   y[r*TM + m] = sum_k sum_t tiles[r, k, t, m] * x[cols[r, k]*TN + t].
//
// Replaces pysparselp_tpu/ops/bsr_pallas.py::_pallas_spmv (K6; kernel body
// _make_spmv_kernel, :105).  There a sequential grid over groups of eight
// tile-rows streams the dense tiles into VMEM while all of x stays resident,
// and each tile is one (1, TN) x (TN, TM) dot on the matrix unit; bf16 tiles
// need a hi/lo split of x to keep f32-grade products.  This kernel computes
// the same function in Hopper's terms:
// * one thread block per tile-row r, TM threads; thread m owns output row
//   r*TM + m, so the K tiles of a row are summed in registers and nothing is
//   carried between blocks;
// * for each of the row's K tiles, the block stages the TN entries of x at
//   cols[r, k]*TN in shared memory (the last partial tile-column reads zeros
//   past n_in), then each thread walks t: for fixed t the loads
//   tiles[r, k, t, 0:TM] are contiguous across the threads, so the JAX
//   package's pre-transposed layout coalesces as it is;
// * fixed summation order (k, then t) and no atomics, so every run of the
//   same inputs gives the same bits; rows >= n_out are not written;
// * TM (<= 1024) and TN are runtime arguments, so one kernel serves every
//   tile size; float32 and float64 tiles (f32 FMAs make the TPU's bf16 hi/lo
//   split unnecessary; bf16 storage is not ported).
//
// Bound on the H100 (3.35 TB/s HBM at 700 W): memory.  One call moves the
// padded tiles (T_rows*K*TN*TM values, zero slots included), the int32 tile
// ids, x once and y once; the arithmetic is one multiply-add per padded
// entry, 67 TFLOP/s in f32 outside the tensor cores, far below the bytes.
// This first kernel streams every padding entry of every tile; skipping
// empty tile slots, smaller tiles, and TMA/wgmma staging are later work.
#include "common.cuh"

namespace {

template <typename T>
__global__ void bsr_rows_kernel(const T* __restrict__ tiles,
                                const int* __restrict__ cols,
                                const T* __restrict__ x, T* __restrict__ y,
                                int k, int tn, int tm, int n_in, int n_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  const int r = blockIdx.x;
  const int m = threadIdx.x;
  const long long tile_size = static_cast<long long>(tn) * tm;
  const T* row_tiles = tiles + static_cast<long long>(r) * k * tile_size;
  T acc = T(0);
  for (int kk = 0; kk < k; ++kk) {
    const long long c0 = static_cast<long long>(cols[r * k + kk]) * tn;
    __syncthreads();  // every thread is done with the previous slice
    for (int t = m; t < tn; t += tm) {
      xs[t] = c0 + t < n_in ? x[c0 + t] : T(0);
    }
    __syncthreads();
    const T* tile = row_tiles + kk * tile_size + m;
#pragma unroll 8
    for (int t = 0; t < tn; ++t) {
      acc = acc + tile[static_cast<long long>(t) * tm] * xs[t];
    }
  }
  const long long row = static_cast<long long>(r) * tm + m;
  if (row < n_out) y[row] = acc;
}

template <typename T>
int launch(const T* tiles, const int* cols, const T* x, T* y, int t_rows,
           int k, int tn, int tm, int n_in, int n_out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (t_rows > 0 && n_out > 0) {
    const size_t smem = static_cast<size_t>(tn) * sizeof(T);
    bsr_rows_kernel<T><<<t_rows, tm, smem, stream>>>(tiles, cols, x, y, k, tn,
                                                     tm, n_in, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

PSLP_EXPORT int pslp_bsr_spmv_f32(const float* tiles, const int* cols,
                                  const float* x, float* y, int t_rows, int k,
                                  int tn, int tm, int n_in, int n_out,
                                  void* stream) {
  return launch<float>(tiles, cols, x, y, t_rows, k, tn, tm, n_in, n_out,
                       stream);
}

PSLP_EXPORT int pslp_bsr_spmv_f64(const double* tiles, const int* cols,
                                  const double* x, double* y, int t_rows,
                                  int k, int tn, int tm, int n_in, int n_out,
                                  void* stream) {
  return launch<double>(tiles, cols, x, y, t_rows, k, tn, tm, n_in, n_out,
                        stream);
}
