// H-BSR: block-sparse matrix-vector product over a CSR of small dense tiles,
//   y = A x    and    y = A^T x,
// both from ONE tile set.  A is cut into T x T tiles (T = 8, 16 or 32) and
// only the tiles that hold an entry are stored, contiguous in tile-row order
// and row-major inside (tiles[k][i][j] = A[r*T + i, c*T + j]), beside
//   row_ptr[T_rows + 1], tile_col[n_tiles]                      (A x),
//   col_ptr[T_cols + 1], tile_of[n_tiles], tile_row[n_tiles]    (A^T y):
// the second index lists every tile once, tile-column by tile-column, by its
// position in `tiles` and its tile-row.  The last tile-row and tile-column are
// zero inside their tiles (ops/bsr_spmv.py::build_tile_csr).
//
// Replaces pysparselp_tpu/ops/bsr_pallas.py::_pallas_spmv (K6; kernel body
// _make_spmv_kernel, :105; entry _tiled_apply, :213).  There a sequential grid
// streams 128 x 128 tiles of a block-ELL (every tile-row padded to the longest)
// into VMEM, x resident, one MXU dot per tile, and A^T gets a second tile set.
// On Hopper that format streams its padding (on the RCM-permuted CLIME matrix
// at p = 150: 4,928 slots for 1,798 nonzero tiles at 23% fill) and gives A^T
// too few blocks (352 over 132 SMs).  This kernel computes the same function:
// * one warp per tile-row for A x and one warp per tile-column for A^T y,
//   kWarps warps per block, no shared memory and nothing carried between
//   warps;
// * a warp reads each tile it visits as 16-byte loads, neighbouring lanes on
//   neighbouring addresses (a 16 x 16 f32 tile is two loads per lane; an
//   8 x 8 f32 tile is half a warp's load, so half-warps take alternate
//   tiles).  Lane l always holds the same tile positions: rows
//   row0 + j*kRowStep and columns col0 .. col0 + V - 1.  So for A x each lane
//   keeps one sum per row it holds and for A^T y one per column, across all
//   the line's tiles, and a fixed shuffle tree adds the lanes that share a row
//   (A x) or a column (A^T y) once, at the end;
// * each lane loads kSteps tiles' vectors (about 32 values) before it
//   multiplies, so every warp has several tiles in flight;
// * the x slice of a tile is read by scalar loads (x may be a view at any
//   storage offset), past n_in as zero;
// * sums in a fixed order (tile by tile, then the shuffle tree), no atomics:
//   every run of the same inputs gives the same bits.
//
// Bound on the H100 (3.35 TB/s HBM at 700 W): memory.  One call moves the
// stored tiles (n_tiles * T^2 values, zeros inside the nonzero tiles
// included), their int32 ids (one per tile for A x, two for A^T y), the
// pointers, x and y.  The arithmetic is one multiply-add per stored value,
// 67 TFLOP/s in f32 outside the tensor cores, far below the bytes.  Tensor
// cores would not help: one right-hand side, where wgmma / mma.sync need
// N >= 8.  One tile set serving both directions keeps the pair's working set
// at one copy of the tiles (37.7 MB for CLIME at 16 x 16), inside the 50 MB L2.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;               // lines (warps) per block
constexpr int kLaneValues = 32;         // tile values a lane loads per batch
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load16(const double* p, double (&v)[2]) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = q.x;
  v[1] = q.y;
}

__device__ __forceinline__ float mul_add(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double mul_add(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// How a warp covers a T x T tile of T-typed values with 16-byte loads.
template <typename T, int TILE>
struct Geometry {
  static constexpr int kV = 16 / static_cast<int>(sizeof(T));  // per load
  static constexpr int kQ = TILE * TILE / kV;        // 16-byte vectors a tile
  static constexpr int kTileLanes = kQ < 32 ? kQ : 32;  // lanes on one tile
  static constexpr int kTilesPerStep = 32 / kTileLanes;
  static constexpr int kNV = kQ / kTileLanes;        // vectors a lane a tile
  static constexpr int kRowStep = kTileLanes * kV / TILE;  // between them
  static constexpr int kRowLanes = TILE / kV;        // lanes on one tile row
  static constexpr int kSteps =
      kLaneValues / (kNV * kV) > 0 ? kLaneValues / (kNV * kV) : 1;
  static_assert(kTileLanes * kV % TILE == 0, "a lane's rows stride evenly");
  static_assert(kRowLanes <= kTileLanes, "a tile row within one tile's lanes");
};

// y[r*T + i] = sum over the tiles k of tile-row r of
//              sum_j tiles[k][i][j] * x[tile_col[k]*T + j]
template <typename T, int TILE>
__global__ void __launch_bounds__(kWarps * 32)
    bsr_rows_kernel(const T* __restrict__ tiles, const int* __restrict__ ptr,
                    const int* __restrict__ tile_col, int t_rows, int n_in,
                    int n_out, const T* __restrict__ x, T* __restrict__ y) {
  using G = Geometry<T, TILE>;
  const int r = blockIdx.x * kWarps + static_cast<int>(threadIdx.x >> 5);
  if (r >= t_rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int sub = lane / G::kTileLanes;  // which tile of a step
  const int q = lane % G::kTileLanes;    // the lane's first vector
  const int row0 = q * G::kV / TILE;
  const int col0 = q * G::kV % TILE;
  const int begin = ptr[r];
  const int end = ptr[r + 1];
  T acc[G::kNV];
#pragma unroll
  for (int j = 0; j < G::kNV; ++j) acc[j] = T(0);
  for (int k0 = begin; k0 < end; k0 += G::kTilesPerStep * G::kSteps) {
    T v[G::kSteps][G::kNV][G::kV];
    T xv[G::kSteps][G::kV];
#pragma unroll
    for (int s = 0; s < G::kSteps; ++s) {
      const int k = k0 + s * G::kTilesPerStep + sub;
      if (k < end) {
        const T* tile = tiles + static_cast<long long>(k) * TILE * TILE +
                        q * G::kV;
#pragma unroll
        for (int j = 0; j < G::kNV; ++j)
          load16(tile + j * G::kTileLanes * G::kV, v[s][j]);
        const long long c =
            static_cast<long long>(__ldg(tile_col + k)) * TILE + col0;
#pragma unroll
        for (int e = 0; e < G::kV; ++e)
          xv[s][e] = c + e < n_in ? __ldg(x + c + e) : T(0);
      } else {
#pragma unroll
        for (int j = 0; j < G::kNV; ++j)
#pragma unroll
          for (int e = 0; e < G::kV; ++e) v[s][j][e] = T(0);
#pragma unroll
        for (int e = 0; e < G::kV; ++e) xv[s][e] = T(0);
      }
    }
#pragma unroll
    for (int s = 0; s < G::kSteps; ++s)
#pragma unroll
      for (int j = 0; j < G::kNV; ++j)
#pragma unroll
        for (int e = 0; e < G::kV; ++e)
          acc[j] = mul_add(v[s][j][e], xv[s][e], acc[j]);
  }
  // add the lanes of one tile row, then the tiles of one step
#pragma unroll
  for (int j = 0; j < G::kNV; ++j) {
#pragma unroll
    for (int m = 1; m < G::kRowLanes; m <<= 1)
      acc[j] += __shfl_xor_sync(kFull, acc[j], m);
#pragma unroll
    for (int m = G::kTileLanes; m < 32; m <<= 1)
      acc[j] += __shfl_xor_sync(kFull, acc[j], m);
  }
  if (sub == 0 && col0 == 0) {
#pragma unroll
    for (int j = 0; j < G::kNV; ++j) {
      const long long row =
          static_cast<long long>(r) * TILE + row0 + j * G::kRowStep;
      if (row < n_out) y[row] = acc[j];
    }
  }
}

// y[c*T + j] = sum over the tiles k of tile-column c (in col_ptr order) of
//              sum_i tiles[tile_of[k]][i][j] * x[tile_row[k]*T + i]
template <typename T, int TILE>
__global__ void __launch_bounds__(kWarps * 32)
    bsr_cols_kernel(const T* __restrict__ tiles, const int* __restrict__ ptr,
                    const int* __restrict__ tile_row,
                    const int* __restrict__ tile_of, int t_cols, int n_in,
                    int n_out, const T* __restrict__ x, T* __restrict__ y) {
  using G = Geometry<T, TILE>;
  const int c = blockIdx.x * kWarps + static_cast<int>(threadIdx.x >> 5);
  if (c >= t_cols) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int sub = lane / G::kTileLanes;
  const int q = lane % G::kTileLanes;
  const int row0 = q * G::kV / TILE;
  const int col0 = q * G::kV % TILE;
  const int begin = ptr[c];
  const int end = ptr[c + 1];
  T acc[G::kV];
#pragma unroll
  for (int e = 0; e < G::kV; ++e) acc[e] = T(0);
  for (int k0 = begin; k0 < end; k0 += G::kTilesPerStep * G::kSteps) {
    T v[G::kSteps][G::kNV][G::kV];
    T xv[G::kSteps][G::kNV];
#pragma unroll
    for (int s = 0; s < G::kSteps; ++s) {
      const int k = k0 + s * G::kTilesPerStep + sub;
      if (k < end) {
        const T* tile = tiles +
                        static_cast<long long>(__ldg(tile_of + k)) * TILE *
                            TILE +
                        q * G::kV;
#pragma unroll
        for (int j = 0; j < G::kNV; ++j)
          load16(tile + j * G::kTileLanes * G::kV, v[s][j]);
        const long long r0 =
            static_cast<long long>(__ldg(tile_row + k)) * TILE + row0;
#pragma unroll
        for (int j = 0; j < G::kNV; ++j) {
          const long long row = r0 + j * G::kRowStep;
          xv[s][j] = row < n_in ? __ldg(x + row) : T(0);
        }
      } else {
#pragma unroll
        for (int j = 0; j < G::kNV; ++j) {
#pragma unroll
          for (int e = 0; e < G::kV; ++e) v[s][j][e] = T(0);
          xv[s][j] = T(0);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < G::kSteps; ++s)
#pragma unroll
      for (int j = 0; j < G::kNV; ++j)
#pragma unroll
        for (int e = 0; e < G::kV; ++e)
          acc[e] = mul_add(v[s][j][e], xv[s][j], acc[e]);
  }
  // add the lanes that hold the same columns: every lane bit above a row's
  // lanes (the tile's other rows, and the other tiles of a step)
#pragma unroll
  for (int e = 0; e < G::kV; ++e)
#pragma unroll
    for (int m = G::kRowLanes; m < 32; m <<= 1)
      acc[e] += __shfl_xor_sync(kFull, acc[e], m);
  if (lane < G::kRowLanes) {
#pragma unroll
    for (int e = 0; e < G::kV; ++e) {
      const long long col = static_cast<long long>(c) * TILE + col0 + e;
      if (col < n_out) y[col] = acc[e];
    }
  }
}

template <typename T, int TILE>
void launch_tile(const T* tiles, const int* ptr, const int* idx,
                 const int* pos, int lines, int transpose, int n_in,
                 int n_out, const T* x, T* y, cudaStream_t stream) {
  const int blocks = (lines + kWarps - 1) / kWarps;
  if (transpose) {
    bsr_cols_kernel<T, TILE><<<blocks, kWarps * 32, 0, stream>>>(
        tiles, ptr, idx, pos, lines, n_in, n_out, x, y);
  } else {
    bsr_rows_kernel<T, TILE><<<blocks, kWarps * 32, 0, stream>>>(
        tiles, ptr, idx, lines, n_in, n_out, x, y);
  }
}

// transpose == 0: A x with ptr = row_ptr, idx = tile_col (pos unused);
// transpose != 0: A^T x with ptr = col_ptr, idx = tile_row, pos = tile_of.
// `lines` is T_rows or T_cols; every tile of `tiles` is 16-byte aligned.
template <typename T>
int launch(const T* tiles, const int* ptr, const int* idx, const int* pos,
           int lines, int tile, int transpose, int n_in, int n_out,
           const T* x, T* y, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (lines <= 0 || n_out <= 0) return static_cast<int>(cudaGetLastError());
  switch (tile) {
    case 8:
      launch_tile<T, 8>(tiles, ptr, idx, pos, lines, transpose, n_in, n_out,
                        x, y, stream);
      break;
    case 16:
      launch_tile<T, 16>(tiles, ptr, idx, pos, lines, transpose, n_in, n_out,
                         x, y, stream);
      break;
    case 32:
      launch_tile<T, 32>(tiles, ptr, idx, pos, lines, transpose, n_in, n_out,
                         x, y, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

PSLP_EXPORT int pslp_bsr_spmv_f32(const float* tiles, const int* ptr,
                                  const int* idx, const int* pos, int lines,
                                  int tile, int transpose, int n_in,
                                  int n_out, const float* x, float* y,
                                  void* stream) {
  return launch<float>(tiles, ptr, idx, pos, lines, tile, transpose, n_in,
                       n_out, x, y, stream);
}

PSLP_EXPORT int pslp_bsr_spmv_f64(const double* tiles, const int* ptr,
                                  const int* idx, const int* pos, int lines,
                                  int tile, int transpose, int n_in,
                                  int n_out, const double* x, double* y,
                                  void* stream) {
  return launch<double>(tiles, ptr, idx, pos, lines, tile, transpose, n_in,
                        n_out, x, y, stream);
}
