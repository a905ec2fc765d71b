// H-DCA: dual coordinate ascent sweeps over the constraint rows of one
// system, each row taking the exact coordinate step of its dual variable.
//
// No pallas_call stands behind it.  It computes what the JAX package's
// compiled loops compute: _dca_sweep_eq / _dca_sweep_ineq
// (pysparselp_tpu/solvers/dual_ascent.py:323 and :342, a fori_loop over
// every row in order, chained through the reduced costs c_bar) and one
// colour group of _dca_color_sweep (:285).  PyTorch has no device loop, and
// written as tensor operations a row step is some 20 launches; this kernel
// runs a whole sequential sweep in ONE launch, and a colour group in one.
//
// Row i of the padded row view (width K = the longest row; padding slots
// hold value 0 at column 0, as the JAX EllMatrix) takes the step of
// ops/linesearch.py::exact_dual_line_search over its K slots:
//   alpha_j = -c_bar[col_j] / v_j (inf where v_j == 0),
//   lo_j, hi_j = min/max(v_j ub[col_j], v_j lb[col_j]) (0 where v_j == 0),
//   a stable sort by alpha (-0 == 0, NaN last), the suffix sums of hi and
//   prefix sums of lo in the order XLA's CPU backend adds them (rows of 16
//   past 16 entries), derivs[j] = (-b_i + suffix[j]) + prefix[j],
//   jnp.searchsorted's fixed binary search for the first derivs <= 0, the
//   clip of k to [1, K] and the tie rule with the row's uniform draw (its
//   interpolation one fused multiply-add, as XLA contracts it),
// then the active & isfinite guard, the y >= 0 projection for inequality
// rows, y_i += step and c_bar[col_j] += step * v_j.  Every other product
// and sum is rounded separately (built with --fmad=false), as the PyTorch
// twin's separate operations (torch.addcmul for the fused one), so the
// kernel and the twin give the same bits.
//
// The draws: the sequential sweep splits the key once per row, active or
// not (key' = threefry(key, (0, 0)), sub = threefry(key, (0, 1))) and draws
// tie_t = uniform(sub); this is jax.random's stream bit for bit
// (utils/jax_prng.py holds the host copy).  The chain does not depend on
// the data, so a second warp runs it ahead of the rows and hands the draws
// over through a ring in shared memory; the final key comes back to the
// host.  A colour group's row r draws uniform(sub, (rows,))[r] =
// threefry(sub, (0, r)) itself.
//
// Bound on the H100 (3.35 TB/s HBM at 700 W): neither bytes nor operations.
// A sweep reads each row's values and columns, lb, ub and c_bar at its
// columns and writes y and c_bar once per entry (Potts-300: 358,800 rows of
// <= 3 entries, 30.5 MB, 9.1 us of HBM time), but row i + 1 reads the c_bar
// that row i wrote: the sweep is a chain of m dependent steps, and its time
// is m times the latency of one step (a c_bar read, the search, the
// update): ~2 us a row, 0.73 s a Potts-300 sweep on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md).  Design against the latency: one CTA; the rows'
// values, columns and bounds are loaded one row ahead; c_bar lives in shared memory when
// it fits (n * itemsize beside the scratch, within 227 KB: Potts-20/50,
// SC105, the matching LP), in global memory otherwise (Potts-300); the
// searches of a row run across one warp (slots, ranks) and its serial part
// (scans, search, update) on one lane; the key chain runs on another warp.
// A colour group has disjoint columns, so its rows step in parallel, one
// warp each.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxRow = 1024;      // the longest row taken (MAX_ROW)
constexpr int kScanBase = 16;      // XLA CPU's scan rows (SCAN_BASE)
constexpr int kRing = 256;         // draws the key warp runs ahead
constexpr int kScanTmp = 128;      // the recursive scans' row totals
constexpr int kSmemLimit = 232448; // a block's dynamic shared memory
constexpr int kColorWarps = 4;     // rows (warps) per colour block

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// Threefry-2x32 (20 rounds), jax/_src/prng.py::_threefry2x32_lowering.
__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// jax.random.uniform(key, shape)[count]: the top mantissa bits of the hash
// of (0, count), as a float in [0, 1).
template <typename T>
__device__ __forceinline__ T uniform_at(uint32_t k1, uint32_t k2,
                                        uint32_t count);

template <>
__device__ __forceinline__ float uniform_at<float>(uint32_t k1, uint32_t k2,
                                                   uint32_t count) {
  uint32_t x0 = 0, x1 = count;
  threefry(k1, k2, x0, x1);
  return static_cast<float>((x0 ^ x1) >> 9) * 0x1p-23f;
}

template <>
__device__ __forceinline__ double uniform_at<double>(uint32_t k1, uint32_t k2,
                                                     uint32_t count) {
  uint32_t x0 = 0, x1 = count;
  threefry(k1, k2, x0, x1);
  const uint64_t m = (static_cast<uint64_t>(x0) << 20) | (x1 >> 12);
  return static_cast<double>(m) * 0x1p-52;
}

template <typename T>
__device__ __forceinline__ T inf() {
  return static_cast<T>(INFINITY);
}

// torch.minimum / torch.maximum: NaN propagates
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (isnan(a) || isnan(b)) ? a + b : (a < b ? a : b);
}

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (isnan(a) || isnan(b)) ? a + b : (a > b ? a : b);
}

// torch.sort's order: NaN after every number, -0 == 0
template <typename T>
__device__ __forceinline__ bool sort_less(T a, T b) {
  return a < b || (isnan(b) && !isnan(a));
}

// jnp.cumsum on XLA's CPU backend, in place on x[0, n): up to kScanBase
// entries one after the other; longer, rows of kScanBase in order, then
// the rows' totals scanned by the same rule and each row's exclusive
// prefix added to it (zero to the first row).  One thread.
template <typename T, int D>
__device__ void xla_scan(T* x, int n, T* tmp) {
  if constexpr (D == 0) {
    for (int j = 1; j < n; ++j) x[j] = x[j - 1] + x[j];
  } else {
    if (n <= kScanBase) {
      for (int j = 1; j < n; ++j) x[j] = x[j - 1] + x[j];
      return;
    }
    const int nrow = (n + kScanBase - 1) / kScanBase;
    for (int r = 0; r < nrow; ++r) {
      const int b = r * kScanBase, e = min(n, b + kScanBase);
      for (int j = b + 1; j < e; ++j) x[j] = x[j - 1] + x[j];
      tmp[r] = x[e - 1];
    }
    xla_scan<T, D - 1>(tmp, nrow, tmp + nrow);
    for (int r = 0; r < nrow; ++r) {
      const T excl = r ? tmp[r - 1] : T(0);
      const int b = r * kScanBase, e = min(n, b + kScanBase);
      for (int j = b; j < e; ++j) x[j] = x[j] + excl;
    }
  }
}

// One warp's scratch for a row of K slots: 7 K + 1 + kScanTmp entries.
template <typename T>
struct Scratch {
  T *a, *lo, *hi, *as, *ls, *hs, *d, *tmp;
  __device__ Scratch(T* base, int K)
      : a(base), lo(base + K), hi(base + 2 * K), as(base + 3 * K),
        ls(base + 4 * K), hs(base + 5 * K), d(base + 6 * K),
        tmp(base + 7 * K + 1) {}
};

template <typename T>
__host__ __device__ constexpr long long scratch_entries(int K) {
  return 7LL * K + 1 + kScanTmp;
}

// A row's slot j (lane j + 32 q): value, column and the bounds there.
template <typename T>
struct Slot {
  T v, l, u;
  int c;
};

template <typename T>
__device__ __forceinline__ Slot<T> load_slot(const T* __restrict__ vals,
                                             const int* __restrict__ cols,
                                             const T* __restrict__ lb,
                                             const T* __restrict__ ub,
                                             long long off, int j, int K) {
  Slot<T> s{T(0), T(0), T(0), 0};
  if (j < K) {
    s.v = vals[off + j];
    s.c = cols[off + j];
    s.l = lb[s.c];
    s.u = ub[s.c];
  }
  return s;
}

template <typename T>
__device__ __forceinline__ void slot_pieces(const Slot<T>& s, const T* cb,
                                            Scratch<T>& w, int j) {
  const bool m = s.v != T(0);
  const T cbv = cb[s.c];
  const T dau = m ? s.v * s.u : T(0);
  const T dal = m ? s.v * s.l : T(0);
  w.a[j] = m ? (-cbv) / s.v : inf<T>();
  w.lo[j] = nan_min(dau, dal);
  w.hi[j] = nan_max(dau, dal);
}

// The exact step of a row (exact_dual_line_search over its K slots): the
// warp fills the slots' breakpoints (slot `lane` from `first`, which the
// caller loaded, the others here) and their sorted ranks; lane 0 scans,
// searches and returns alpha (other lanes return 0).
template <typename T>
__device__ T row_alpha(const T* __restrict__ vals, const int* __restrict__ cols,
                       const T* __restrict__ lb, const T* __restrict__ ub,
                       long long off, int K, const Slot<T>& first, T b_i,
                       const T* cb, T tie, Scratch<T>& w, int lane) {
  if (lane < K) slot_pieces(first, cb, w, lane);
  for (int j = lane + 32; j < K; j += 32)
    slot_pieces(load_slot(vals, cols, lb, ub, off, j, K), cb, w, j);
  __syncwarp();
  for (int j = lane; j < K; j += 32) {
    const T a = w.a[j];
    int rank = 0;
    for (int q = 0; q < K; ++q) {
      const T o = w.a[q];
      rank += sort_less(o, a) || (q < j && !sort_less(a, o));
    }
    w.as[rank] = a;
    w.ls[rank] = w.lo[j];
    w.hs[rank] = w.hi[j];
  }
  __syncwarp();
  if (lane != 0) return T(0);
  // suffix sums of hs (the scan of the reversed array, read reversed) and
  // prefix sums of ls
  for (int j = 0; j < K; ++j) w.hi[j] = w.hs[K - 1 - j];
  xla_scan<T, 3>(w.hi, K, w.tmp);
  xla_scan<T, 3>(w.ls, K, w.tmp);
  for (int j = 0; j <= K; ++j) {
    const T suf = j < K ? w.hi[K - 1 - j] : T(0);
    const T pre = j > 0 ? w.ls[j - 1] : T(0);
    w.d[j] = ((-b_i) + suf) + pre;
  }
  // jnp.searchsorted(-derivs, 0.0): ceil(log2(L + 1)) halvings of [0, L]
  const int L = K + 1;
  int levels = 0;
  while ((1 << levels) < L + 1) ++levels;
  int low = 0, high = L;
  for (int it = 0; it < levels; ++it) {
    const int mid = (low + high) / 2;
    const T v = -w.d[mid];
    if (v >= T(0) || isnan(v)) high = mid;
    else low = mid;
  }
  const int k = min(max(high, 1), K);
  const T alo = w.as[k - 1];
  const T ahi = w.as[min(k, K - 1)];
  const bool is_tie = w.d[k] == T(0) && k < K && isfinite(ahi);
  // fma(t, alpha_hi, (1 - t) alpha_lo): the contraction XLA's CPU backend
  // makes of the JAX tie rule (an explicit fma survives --fmad=false)
  return is_tie ? fma(tie, ahi, (T(1) - tie) * alo) : alo;
}

// The guarded, projected step of row i: writes y[i], returns the change
// of y (what multiplies the row into c_bar).  Lane 0.
template <typename T>
__device__ __forceinline__ T take_step(T alpha, bool active, T* y, int i,
                                       int project) {
  alpha = (active && isfinite(alpha)) ? alpha : T(0);
  const T yi = y[i];
  if (project) {
    T ynew = yi + alpha;
    ynew = ynew < T(0) ? T(0) : ynew;
    y[i] = ynew;
    return ynew - yi;
  }
  y[i] = yi + alpha;
  return alpha;
}

// The sequential sweep: one CTA of two warps.  Warp 1 runs the key chain
// ahead into the ring; warp 0 walks the rows.
template <typename T>
__global__ void __launch_bounds__(64)
    dca_sweep_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                     const T* __restrict__ b,
                     const uint8_t* __restrict__ active, T* y, T* cbar,
                     const T* __restrict__ lb, const T* __restrict__ ub,
                     int m, int K, int n, uint32_t k1, uint32_t k2,
                     long long* key_out, int project, int cbar_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  volatile T* ring = smem;
  Scratch<T> w(smem + kRing, K);
  T* cb_smem = smem + kRing + scratch_entries<T>(K);
  __shared__ volatile int produced, consumed;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    produced = 0;
    consumed = 0;
  }
  if (cbar_in_smem)
    for (int c = tid; c < n; c += blockDim.x) cb_smem[c] = cbar[c];
  __syncthreads();
  T* cb = cbar_in_smem ? cb_smem : cbar;

  if (warp == 1) {
    if (lane == 0) {
      for (int i = 0; i < m; ++i) {
        uint32_t n0 = 0, n1 = 0, s0 = 0, s1 = 1;
        threefry(k1, k2, n0, n1);
        threefry(k1, k2, s0, s1);
        k1 = n0;
        k2 = n1;
        const T t = uniform_at<T>(s0, s1, 0);
        while (i - consumed >= kRing) {
        }
        ring[i % kRing] = t;
        __threadfence_block();
        produced = i + 1;
      }
      key_out[0] = k1;
      key_out[1] = k2;
    }
  } else {
    Slot<T> next = load_slot(vals, cols, lb, ub, 0, lane, K);
    T b_next = m ? b[0] : T(0);
    bool act_next = m ? active[0] != 0 : false;
    for (int i = 0; i < m; ++i) {
      const long long off = static_cast<long long>(i) * K;
      const Slot<T> cur = next;
      const T b_i = b_next;
      const bool act = act_next;
      if (i + 1 < m) {  // the next row's loads, ahead of this row's chain
        next = load_slot(vals, cols, lb, ub, off + K, lane, K);
        b_next = b[i + 1];
        act_next = active[i + 1] != 0;
      }
      T tie = T(0);
      if (lane == 0) {
        while (produced <= i) {
        }
        __threadfence_block();
        tie = ring[i % kRing];
        consumed = i + 1;
      }
      const T alpha =
          row_alpha(vals, cols, lb, ub, off, K, cur, b_i, cb, tie, w, lane);
      if (lane == 0) {
        const T diff = take_step(alpha, act, y, i, project);
        // slot by slot in order, padding included (the twin's index_add_)
        for (int j = 0; j < K; ++j) {
          const int c = cols[off + j];
          cb[c] = cb[c] + diff * vals[off + j];
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (cbar_in_smem)
    for (int c = tid; c < n; c += blockDim.x) cbar[c] = cb_smem[c];
}

// One colour group: one warp per row (the rows' columns are disjoint, so
// no two warps write one c_bar entry; padding slots, value 0, write
// nothing).
template <typename T>
__global__ void __launch_bounds__(32 * kColorWarps)
    dca_color_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                     const T* __restrict__ b,
                     const uint8_t* __restrict__ active, T* y, T* cbar,
                     const T* __restrict__ lb, const T* __restrict__ ub,
                     const int* __restrict__ rows, int n_rows, int K,
                     uint32_t s1, uint32_t s2, int project) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= n_rows) return;
  Scratch<T> w(reinterpret_cast<T*>(smem_raw) + warp * scratch_entries<T>(K),
               K);
  const int i = rows[r];
  const long long off = static_cast<long long>(i) * K;
  const Slot<T> first = load_slot(vals, cols, lb, ub, off, lane, K);
  const T tie = lane == 0 ? uniform_at<T>(s1, s2, static_cast<uint32_t>(r))
                          : T(0);
  const T alpha =
      row_alpha(vals, cols, lb, ub, off, K, first, b[i], cbar, tie, w, lane);
  T diff = T(0);
  if (lane == 0) diff = take_step(alpha, active[i] != 0, y, i, project);
  diff = __shfl_sync(0xffffffffu, diff, 0);
  for (int j = lane; j < K; j += 32) {
    const T v = vals[off + j];
    if (v != T(0)) {
      const int c = cols[off + j];
      cbar[c] = cbar[c] + diff * v;
    }
  }
}

template <typename T>
long long sweep_smem_bytes(int K, int n, bool* cbar_in_smem) {
  const long long base = (kRing + scratch_entries<T>(K)) * sizeof(T);
  const long long with_cbar = base + static_cast<long long>(n) * sizeof(T);
  *cbar_in_smem = with_cbar <= kSmemLimit;
  return *cbar_in_smem ? with_cbar : base;
}

template <typename T>
int launch_sweep(const T* vals, const int* cols, const T* b,
                 const uint8_t* active, T* y, T* cbar, const T* lb,
                 const T* ub, int m, int K, int n, uint32_t k1, uint32_t k2,
                 long long* key_out, int project, void* stream) {
  if (K < 1 || K > kMaxRow) return static_cast<int>(cudaErrorInvalidValue);
  bool in_smem = false;
  const long long smem = sweep_smem_bytes<T>(K, n, &in_smem);
  cudaError_t err = cudaFuncSetAttribute(
      dca_sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dca_sweep_kernel<T><<<1, 64, smem, static_cast<cudaStream_t>(stream)>>>(
      vals, cols, b, active, y, cbar, lb, ub, m, K, n, k1, k2, key_out,
      project, in_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_color(const T* vals, const int* cols, const T* b,
                 const uint8_t* active, T* y, T* cbar, const T* lb,
                 const T* ub, const int* rows, int n_rows, int K, uint32_t s1,
                 uint32_t s2, int project, void* stream) {
  if (K < 1 || K > kMaxRow) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_warp = scratch_entries<T>(K) * sizeof(T);
  const int warps = static_cast<int>(
      min(static_cast<long long>(kColorWarps), kSmemLimit / per_warp));
  const long long smem = per_warp * warps;
  cudaError_t err = cudaFuncSetAttribute(
      dca_color_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n_rows + warps - 1) / warps;
  dca_color_kernel<T><<<grid, 32 * warps, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      vals, cols, b, active, y, cbar, lb, ub, rows, n_rows, K, s1, s2,
      project);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

PSLP_EXPORT int pslp_dca_sweep_f32(const float* vals, const int* cols,
                                   const float* b, const uint8_t* active,
                                   float* y, float* cbar, const float* lb,
                                   const float* ub, int m, int K, int n,
                                   uint32_t k1, uint32_t k2,
                                   long long* key_out, int project,
                                   void* stream) {
  return launch_sweep<float>(vals, cols, b, active, y, cbar, lb, ub, m, K, n,
                             k1, k2, key_out, project, stream);
}

PSLP_EXPORT int pslp_dca_sweep_f64(const double* vals, const int* cols,
                                   const double* b, const uint8_t* active,
                                   double* y, double* cbar, const double* lb,
                                   const double* ub, int m, int K, int n,
                                   uint32_t k1, uint32_t k2,
                                   long long* key_out, int project,
                                   void* stream) {
  return launch_sweep<double>(vals, cols, b, active, y, cbar, lb, ub, m, K,
                              n, k1, k2, key_out, project, stream);
}

PSLP_EXPORT int pslp_dca_color_step_f32(const float* vals, const int* cols,
                                        const float* b, const uint8_t* active,
                                        float* y, float* cbar, const float* lb,
                                        const float* ub, const int* rows,
                                        int n_rows, int K, uint32_t s1,
                                        uint32_t s2, int project,
                                        void* stream) {
  return launch_color<float>(vals, cols, b, active, y, cbar, lb, ub, rows,
                             n_rows, K, s1, s2, project, stream);
}

PSLP_EXPORT int pslp_dca_color_step_f64(const double* vals, const int* cols,
                                        const double* b, const uint8_t* active,
                                        double* y, double* cbar,
                                        const double* lb, const double* ub,
                                        const int* rows, int n_rows, int K,
                                        uint32_t s1, uint32_t s2, int project,
                                        void* stream) {
  return launch_color<double>(vals, cols, b, active, y, cbar, lb, ub, rows,
                              n_rows, K, s1, s2, project, stream);
}
