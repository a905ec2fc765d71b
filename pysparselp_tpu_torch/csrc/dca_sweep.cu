// H-DCA: dual coordinate ascent sweeps over the constraint rows of one
// system, each row taking the exact coordinate step of its dual variable.
//
// No pallas_call stands behind it.  It computes what the JAX package's
// compiled loops compute: _dca_sweep_eq / _dca_sweep_ineq
// (pysparselp_tpu/solvers/dual_ascent.py:323 and :342, a fori_loop over
// every row in order, chained through the reduced costs c_bar) and one
// colour sweep _dca_color_sweep (:285).  PyTorch has no device loop, and
// written as tensor operations a row step is some 20 launches; a sequential
// sweep here is three launches, and a colour sweep one.
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
// The sequential sweep runs on a level schedule (ops/dca_sweep.py,
// LevelSchedule, built once per row view on the host): row i's level is one
// more than the highest level of any earlier row that touches one of its
// columns, a padding slot touching column 0.  Rows of one level share no
// column, so running the levels in order, a level's rows at once, gives
// each row the c_bar the row-by-row sweep gives it and each column its
// updates in the same order: the same bits, in L dependent steps instead
// of m (Potts-300: 602 levels of at most 1,190 rows for 358,800 rows).
//
// The draws: the sequential sweep splits the key once per row, active or
// not (key' = threefry(key, (0, 0)), sub = threefry(key, (0, 1))) and draws
// tie_t = uniform(sub); this is jax.random's stream bit for bit
// (utils/jax_prng.py holds the host copy).  The chain of keys has no jump
// ahead, so one thread runs it (dca_chain_kernel, its own launch) and
// writes each row's key; a grid then hashes every row's sub key and draw
// (dca_stage_kernel); the final key comes back to the host.  A colour
// group's row r draws uniform(sub, (rows,))[r] = threefry(sub, (0, r))
// itself.
//
// Bound on the H100 (3.35 TB/s HBM at 700 W), the largest of three:
// bytes (Potts-300: padded values and columns, b, active, y, c_bar and the
// bounds, 30.5 MB, 9.1 us); the levels, each at least an L2 round trip for
// c_bar, the row's arithmetic and a block barrier; and the key chain, m
// threefry links of ~45 dependent integer operations each.  The chain
// binds: one thread runs nothing else, the other lanes' work (draws,
// levels) is off it.  The levels run in ONE block (a grid-wide barrier per
// level would cost more than a level), so its one SM's L1 takes every
// access of the levels, and a scattered one costs it a transaction per
// lane: the grid that draws also stages the rows of up to 16 slots in
// level order, slot-major (values, columns, the bounds at the columns, b,
// active, the draw), which the level block then reads coalesced; only
// c_bar and y stay gathers.  Such rows take one thread each, their slots,
// ranks, scans and search in registers, the next row's staged data and y
// loaded ahead across the barrier; longer rows take one warp each
// (row_alpha) and read their rows in place.  c_bar lives in shared memory
// when it fits (Potts-20/50, SC105, the matching LP), else in global memory
// (Potts-300: 1.08 MB in float32, L2-resident), read with plain coherent
// loads: __syncthreads orders global memory within the block.
//
// The colour sweep (H-DCA-C) runs every group of a sweep in ONE launch, a
// persistent cooperative grid (as many blocks as can be resident, no more
// than the largest group needs) with a grid barrier between groups: a
// group's rows share no column, so they step at once.  Rows of up to 16
// slots take a thread each, in registers (short_row_alpha, the sequential
// sweep's arithmetic), their static data (values, columns, the bounds at
// the columns, b) staged slot-major in colour order once per system
// (ops/dca_sweep.py::ColorPlan) and loaded ahead across the barrier with
// y_i, the active flag and the draw; longer rows take a warp each
// (row_alpha) and read their rows in place.  Group g's row r draws
// uniform(sub_g, (rows,))[r] = threefry(sub_g, (0, r)) itself; the host
// passes the G sub keys.  Bound (chip_smoke.dca_color_bound): the bytes of
// the staged sweep against G dependent groups, each at least an L2 round
// trip for c_bar, a short row's arithmetic and a grid barrier.  The
// one-group entry of a mesh rank (dca_color_step, a slice of a group from
// its tie_offset) is the same kernel with G = 1, its rows read in place.

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRow = 1024;      // the longest row taken (MAX_ROW)
constexpr int kScanBase = 16;      // XLA CPU's scan rows (SCAN_BASE)
constexpr int kScanTmp = 128;      // the recursive scans' row totals
constexpr int kSmemLimit = 232448; // a block's dynamic shared memory
constexpr int kColorWarps = 4;     // rows (warps) per colour block, long rows
constexpr int kColorThreads = 256; // rows (threads) per colour block, short rows
constexpr int kMaxWarps = 32;      // rows (warps) per level pass, wide rows
constexpr int kStageBlock = 256;   // threads per staging block

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

template <typename T, typename Read>
__device__ __forceinline__ void slot_pieces(const Slot<T>& s, Read cb,
                                            Scratch<T>& w, int j) {
  const bool m = s.v != T(0);
  const T cbv = cb(s.c);
  const T dau = m ? s.v * s.u : T(0);
  const T dal = m ? s.v * s.l : T(0);
  w.a[j] = m ? (-cbv) / s.v : inf<T>();
  w.lo[j] = nan_min(dau, dal);
  w.hi[j] = nan_max(dau, dal);
}

// The exact step of a row (exact_dual_line_search over its K slots): the
// warp fills the slots' breakpoints (slot `lane` from `first`, which the
// caller loaded, the others here; c_bar at column c is cb(c)) and their
// sorted ranks; lane 0 scans, searches and returns alpha (other lanes
// return 0).
template <typename T, typename Read>
__device__ T row_alpha(const T* __restrict__ vals, const int* __restrict__ cols,
                       const T* __restrict__ lb, const T* __restrict__ ub,
                       long long off, int K, const Slot<T>& first, T b_i,
                       Read cb, T tie, Scratch<T>& w, int lane) {
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

// The guarded, projected step of row i from its dual y_i: the new y_i, and
// through `diff` the change of y (what multiplies the row into c_bar).
template <typename T>
__device__ __forceinline__ T step_y(T alpha, bool active, T yi, int project,
                                    T* diff) {
  alpha = (active && isfinite(alpha)) ? alpha : T(0);
  if (project) {
    // jnp.maximum(y + alpha, 0) as XLA computes it: -0 gives +0, NaN stays
    T ynew = yi + alpha;
    ynew = ynew <= T(0) ? T(0) : ynew;
    *diff = ynew - yi;
    return ynew;
  }
  *diff = alpha;
  return yi + alpha;
}

// take_step on y in memory: writes y[i], returns the change.  Lane 0.
template <typename T>
__device__ __forceinline__ T take_step(T alpha, bool active, T* y, int i,
                                       int project) {
  T diff;
  y[i] = step_y(alpha, active, y[i], project, &diff);
  return diff;
}

// ---------------------------------------------------------------------
// the sequential sweep: key chain, draws, levels
// ---------------------------------------------------------------------

// The key chain, one thread: keys[i] = row i's key, key_{i+1} =
// threefry(key_i, (0, 0)); the key after the last row to key_out.
__global__ void __launch_bounds__(1)
    dca_chain_kernel(uint32_t k1, uint32_t k2, int m,
                     uint2* __restrict__ keys,
                     long long* __restrict__ key_out) {
#pragma unroll 4
  for (int i = 0; i < m; ++i) {
    keys[i] = make_uint2(k1, k2);
    uint32_t n0 = 0, n1 = 0;
    threefry(k1, k2, n0, n1);
    k1 = n0;
    k2 = n1;
  }
  key_out[0] = k1;
  key_out[1] = k2;
}

// A sequential sweep's workspace (ops/dca_sweep.py::sweep_work_bytes): each
// row's key, by row; then by position q in level order: the draws and, for
// rows of up to kScanBase slots, the staged rows (slot j of position q at
// j m + q).
template <typename T>
struct Work {
  uint2* keys = nullptr;
  T* draws = nullptr;
  T *sv = nullptr, *sl = nullptr, *su = nullptr, *sb = nullptr;
  int* sc = nullptr;
  uint8_t* sa = nullptr;
};

template <typename T>
Work<T> carve_work(void* base, int m, int K) {
  char* p = static_cast<char*>(base);
  const long long mk = static_cast<long long>(m) * K;
  Work<T> w;
  w.keys = reinterpret_cast<uint2*>(p);
  p += sizeof(uint2) * static_cast<long long>(m);
  w.draws = reinterpret_cast<T*>(p);
  p += sizeof(T) * static_cast<long long>(m);
  if (K <= kScanBase) {
    w.sv = reinterpret_cast<T*>(p);
    w.sl = w.sv + mk;
    w.su = w.sl + mk;
    w.sb = w.su + mk;
    p += sizeof(T) * (3 * mk + m);
    w.sc = reinterpret_cast<int*>(p);
    w.sa = reinterpret_cast<uint8_t*>(w.sc + mk);
  }
  return w;
}

// Position q of the level order (row i = perm[q]): its draw uniform(sub_i)
// with sub_i = threefry(key_i, (0, 1)), and the staged row where the work
// has room for it.
template <typename T>
__global__ void __launch_bounds__(kStageBlock)
    dca_stage_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                     const T* __restrict__ b,
                     const uint8_t* __restrict__ active,
                     const T* __restrict__ lb, const T* __restrict__ ub,
                     const int* __restrict__ perm, int m, int K, Work<T> w) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= m) return;
  const int i = perm[q];
  const uint2 k = w.keys[i];
  uint32_t s0 = 0, s1 = 1;
  threefry(k.x, k.y, s0, s1);
  w.draws[q] = uniform_at<T>(s0, s1, 0);
  if (w.sv == nullptr) return;
  w.sb[q] = b[i];
  w.sa[q] = active[i];
  const long long off = static_cast<long long>(i) * K;
  for (int j = 0; j < K; ++j) {
    const int c = cols[off + j];
    const long long at = static_cast<long long>(j) * m + q;
    w.sv[at] = vals[off + j];
    w.sc[at] = c;
    w.sl[at] = lb[c];
    w.su[at] = ub[c];
  }
}

// arr[idx] for a run-time idx < N, by selects (the array stays in
// registers).
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&arr)[N], int idx) {
  T r = arr[0];
#pragma unroll
  for (int j = 1; j < N; ++j) r = j == idx ? arr[j] : r;
  return r;
}

// The entry of sorted position p: arr[j] where rank[j] == p.
template <typename T, int N>
__device__ __forceinline__ T pick_rank(const T (&arr)[N],
                                       const int (&rank)[N], int p) {
  T r = arr[0];
#pragma unroll
  for (int j = 1; j < N; ++j) r = rank[j] == p ? arr[j] : r;
  return r;
}

// What a row of at most KM slots needs besides c_bar and the bounds at its
// columns: none of it changes during the sweep (y_i only by row i), so it
// is loaded a row ahead, across the level barrier.
template <typename T, int KM>
struct RowIn {
  T v[KM];
  int c[KM];
  T b, y, t;
  int i, q;
  bool act;
};

template <typename T, int KM>
__device__ __forceinline__ void load_row(RowIn<T, KM>& r, int q,
                                         const int* __restrict__ perm,
                                         const Work<T>& w, const T* y, int m,
                                         int K) {
  r.i = perm[q];
  r.q = q;
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    const long long at = static_cast<long long>(j) * m + q;
    r.v[j] = j < K ? w.sv[at] : T(0);
    r.c[j] = j < K ? w.sc[at] : 0;
  }
  r.b = w.sb[q];
  r.y = y[r.i];
  r.t = w.draws[q];
  r.act = w.sa[q] != 0;
}

// The exact step of a row of K <= KM <= kScanBase slots on one thread, in
// registers, from its values v, c_bar cv, lb l and ub u at its columns, b
// and the tie draw t: exact_dual_line_search's steps as row_alpha takes them
// (short scans are plain left-to-right sums).
template <typename T, int KM>
__device__ __forceinline__ T short_row_alpha(const T (&v)[KM],
                                             const T (&cv)[KM],
                                             const T (&l)[KM],
                                             const T (&u)[KM], T b, T t,
                                             int K) {
  T a[KM], lo[KM], hi[KM], d[KM + 1];
  int rank[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    a[j] = lo[j] = hi[j] = T(0);
    if (j < K) {
      const bool nz = v[j] != T(0);
      const T dau = nz ? v[j] * u[j] : T(0);
      const T dal = nz ? v[j] * l[j] : T(0);
      a[j] = nz ? (-cv[j]) / v[j] : inf<T>();
      lo[j] = nan_min(dau, dal);
      hi[j] = nan_max(dau, dal);
    }
  }
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    int rk = 0;
#pragma unroll
    for (int q = 0; q < KM; ++q)
      if (q < K) rk += sort_less(a[q], a[j]) || (q < j && !sort_less(a[j], a[q]));
    rank[j] = j < K ? rk : -1;
  }
  // d[p] = ((-b) + suffix_p) + prefix_p over the sorted slots: suffix_p =
  // hs[K-1] + ... + hs[p] from the last, prefix_p = ls[0] + ... + ls[p-1]
  // from the first, each 0 past its end
  const T nb = -b;
#pragma unroll
  for (int p = 0; p <= KM; ++p) d[p] = p == K ? nb + T(0) : T(0);
  T suf = T(0);
#pragma unroll
  for (int p = KM - 1; p >= 0; --p) {
    if (p < K) {
      const T h = pick_rank(hi, rank, p);
      suf = p == K - 1 ? h : suf + h;
      d[p] = nb + suf;
    }
  }
  T pre = T(0);
#pragma unroll
  for (int p = 0; p <= KM; ++p) {
    if (p <= K) {
      d[p] = d[p] + pre;
      if (p < K) {
        const T lv = pick_rank(lo, rank, p);
        pre = p == 0 ? lv : pre + lv;
      }
    }
  }
  // jnp.searchsorted(-derivs, 0.0), as row_alpha
  const int L = K + 1;
  int levels = 0;
  while ((1 << levels) < L + 1) ++levels;
  int low = 0, high = L;
  for (int it = 0; it < levels; ++it) {
    const int mid = (low + high) / 2;
    const T dv = -pick(d, mid);
    if (dv >= T(0) || isnan(dv)) high = mid;
    else low = mid;
  }
  const int k = min(max(high, 1), K);
  const T alo = pick_rank(a, rank, k - 1);
  const T ahi = pick_rank(a, rank, min(k, K - 1));
  const bool is_tie = pick(d, k) == T(0) && k < K && isfinite(ahi);
  return is_tie ? fma(t, ahi, (T(1) - t) * alo) : alo;
}

// c_bar at a row's columns after its step: slot j adds diff v_j to the
// value before it (c_bar's, or the row's own earlier slot at that column:
// a column met twice, padding, takes its updates in order).
template <typename T, int KM>
__device__ __forceinline__ void chain_updates(const T (&v)[KM],
                                              const int (&c)[KM],
                                              const T (&cv)[KM], T diff,
                                              int K, T (&nv)[KM]) {
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    nv[j] = T(0);
    if (j < K) {
      T base = cv[j];
#pragma unroll
      for (int q = 0; q < j; ++q)
        if (c[q] == c[j]) base = nv[q];
      nv[j] = base + diff * v[j];
    }
  }
}

// One row of K <= KM <= kScanBase slots of a level on one thread, in
// registers (short_row_alpha), then y_i and c_bar at the row's columns,
// slot by slot.
template <typename T, int KM>
__device__ __forceinline__ void thread_row(const RowIn<T, KM>& r, T* cb,
                                           const Work<T>& w, T* y, int m,
                                           int K, int project) {
  T cv[KM], l[KM], u[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    cv[j] = l[j] = u[j] = T(0);
    if (j < K) {
      const long long at = static_cast<long long>(j) * m + r.q;
      cv[j] = cb[r.c[j]];
      l[j] = w.sl[at];
      u[j] = w.su[at];
    }
  }
  const T alpha = short_row_alpha<T, KM>(r.v, cv, l, u, r.b, r.t, K);
  T diff;
  y[r.i] = step_y(alpha, r.act, r.y, project, &diff);
  T nv[KM];
  chain_updates<T, KM>(r.v, r.c, cv, diff, K, nv);
#pragma unroll
  for (int j = 0; j < KM; ++j)
    if (j < K) cb[r.c[j]] = nv[j];
}

// Threads of the level block for rows of up to KM slots: 1,024 for float
// rows of up to 4, fewer where a row's registers are more (64 registers a
// thread at 1,024).
template <typename T, int KM>
__host__ __device__ constexpr int level_threads() {
  return 16384 / (KM * static_cast<int>(sizeof(T))) > 1024
             ? 1024
             : 16384 / (KM * static_cast<int>(sizeof(T)));
}

// The levels, rows of up to KM slots, one thread a row: level l's rows,
// positions [ptr[l], ptr[l + 1]) of the staged level order, in passes of
// blockDim rows, a barrier between levels.  Each thread loads its next row
// (this level's next pass, or the next level's first) before it steps the
// current one.
template <typename T, int KM>
__global__ void __launch_bounds__(level_threads<T, KM>())
    dca_levels_kernel(T* y, T* cbar, const int* __restrict__ perm,
                      const int* __restrict__ ptr, int n_levels, int m, int K,
                      int n, int project, int cbar_in_smem, Work<T> w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cb_smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, nt = blockDim.x;
  if (cbar_in_smem) {
    for (int c = tid; c < n; c += nt) cb_smem[c] = cbar[c];
    __syncthreads();
  }
  T* cb = cbar_in_smem ? cb_smem : cbar;
  // ptr[min(j, n_levels)]: past the last level, empty levels
  int beg = ptr[0], end = ptr[min(1, n_levels)], end2 = ptr[min(2, n_levels)];
  RowIn<T, KM> next;
  if (beg + tid < end) load_row(next, beg + tid, perm, w, y, m, K);
  for (int l = 0; l < n_levels; ++l) {
    const int end3 = ptr[min(l + 3, n_levels)];
    for (int q = beg + tid; q < end; q += nt) {
      const RowIn<T, KM> cur = next;
      if (q + nt < end)
        load_row(next, q + nt, perm, w, y, m, K);
      else if (end + tid < end2)
        load_row(next, end + tid, perm, w, y, m, K);
      thread_row(cur, cb, w, y, m, K, project);
    }
    if (beg + tid >= end && end + tid < end2)
      load_row(next, end + tid, perm, w, y, m, K);
    __syncthreads();
    beg = end;
    end = end2;
    end2 = end3;
  }
  if (cbar_in_smem)
    for (int c = tid; c < n; c += nt) cbar[c] = cb_smem[c];
}

// The levels, rows past kScanBase slots, one warp a row, read in place
// (row_alpha; lane 0 takes the step and updates c_bar slot by slot,
// padding included).
template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps)
    dca_levels_warp_kernel(const T* __restrict__ vals,
                           const int* __restrict__ cols,
                           const T* __restrict__ b,
                           const uint8_t* __restrict__ active, T* y, T* cbar,
                           const T* __restrict__ lb, const T* __restrict__ ub,
                           const T* __restrict__ draws,
                           const int* __restrict__ perm,
                           const int* __restrict__ ptr, int n_levels, int K,
                           int n, int project, int cbar_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  Scratch<T> w(smem + warp * scratch_entries<T>(K), K);
  T* cb_smem = smem + nw * scratch_entries<T>(K);
  if (cbar_in_smem) {
    for (int c = tid; c < n; c += nt) cb_smem[c] = cbar[c];
    __syncthreads();
  }
  T* cb = cbar_in_smem ? cb_smem : cbar;
  for (int l = 0; l < n_levels; ++l) {
    const int end = ptr[l + 1];
    for (int q = ptr[l] + warp; q < end; q += nw) {
      const int i = perm[q];
      const long long off = static_cast<long long>(i) * K;
      const Slot<T> first = load_slot(vals, cols, lb, ub, off, lane, K);
      const T tie = lane == 0 ? draws[q] : T(0);
      const T alpha = row_alpha(vals, cols, lb, ub, off, K, first, b[i],
                                [cb](int c) { return cb[c]; }, tie, w, lane);
      if (lane == 0) {
        const T diff = take_step(alpha, active[i] != 0, y, i, project);
        for (int j = 0; j < K; ++j) {
          const int c = cols[off + j];
          cb[c] = cb[c] + diff * vals[off + j];
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }
  if (cbar_in_smem)
    for (int c = tid; c < n; c += nt) cbar[c] = cb_smem[c];
}

// ---------------------------------------------------------------------
// the colour sweep (H-DCA-C): every colour group of a sweep in one launch
// ---------------------------------------------------------------------

// What one launch of the colour sweep reads.  Group g is positions
// [ptr[g], ptr[g + 1]) of `order` (no ptr: one group of n_rows positions),
// its rows' ties drawn from the key (keys[2 g], keys[2 g + 1]) (no keys:
// (k1, k2)) starting at element tie_offset.  sv, sc, sl, su, sb: the rows
// of up to kScanBase slots staged slot-major in `order` (slot j of position
// q at j n_rows + q; ops/dca_sweep.py::ColorPlan), or null (the rows read
// in place).  flips: a word a group for column 0 (col0_update), set when
// it holds `epoch`.
template <typename T>
struct ColorArgs {
  const T* vals;
  const int* cols;
  const T* b;
  const uint8_t* active;
  T* y;
  T* cb;
  const T* lb;
  const T* ub;
  const int* order;
  const int* ptr;
  int n_groups, n_rows;
  const uint32_t* keys;
  uint32_t k1, k2, tie_offset;
  const T *sv, *sl, *su, *sb;
  const int* sc;
  int* flips;
  int epoch, K, project;
};

template <typename T>
__device__ __forceinline__ int group_lo(const ColorArgs<T>& a, int g) {
  return a.ptr ? a.ptr[g] : 0;
}

template <typename T>
__device__ __forceinline__ int group_hi(const ColorArgs<T>& a, int g) {
  return a.ptr ? a.ptr[g + 1] : a.n_rows;
}

// The tie of position q of group g (lo its first position).
template <typename T>
__device__ __forceinline__ T group_tie(const ColorArgs<T>& a, int g, int q,
                                       int lo) {
  const uint32_t k1 = a.keys ? a.keys[2 * g] : a.k1;
  const uint32_t k2 = a.keys ? a.keys[2 * g + 1] : a.k2;
  return uniform_at<T>(k1, k2, a.tie_offset + static_cast<uint32_t>(q - lo));
}

template <typename T>
__device__ __forceinline__ bool neg_zero(T x) {
  return x == T(0) && signbit(x);
}

template <typename T>
struct Bits;

template <>
struct Bits<float> {
  using U = unsigned int;
  static __device__ __forceinline__ U of(float x) { return __float_as_uint(x); }
  static __device__ __forceinline__ float from(U u) { return __uint_as_float(u); }
};

template <>
struct Bits<double> {
  using U = unsigned long long;
  static __device__ __forceinline__ U of(double x) {
    return static_cast<U>(__double_as_longlong(x));
  }
  static __device__ __forceinline__ double from(U u) {
    return __longlong_as_double(static_cast<long long>(u));
  }
};

// c_bar at column c as group g sees it: read from L2 (other SMs wrote it in
// earlier groups), and at column 0 a -0 that an earlier group's padding
// turned to +0 (fix0; col0_update) read as +0.
template <typename T>
__device__ __forceinline__ T cb_read(const T* cb, int c, bool fix0) {
  const T x = __ldcg(cb + c);
  return (c == 0 && fix0 && neg_zero(x)) ? T(0) : x;
}

// Column 0 in a colour group.  A group's rows share no column, but every
// padding slot is column 0, so many rows may add to c_bar[0]: the twin adds
// z = diff * v of every slot (index_add_), a real row's nonzero z and the
// padding's +-0 (NaN where diff is infinite).  Adding zeros is exact and
// order-free (x + -0 = x; x + +0 = x except -0 + +0 = +0), and at most one
// row of a group has a nonzero z there, so the sum is that row's chain,
// then +0 if some padding gave +0 and the result is -0.  So a row whose z
// there (zs calls f(z) for each, in slot order) are all -0 writes nothing;
// one with only +-0 and a +0 records the flip in flips[g] when c_bar[0] is
// -0 (it stays -0 in memory: cb_read reads it as +0 in later groups, the
// end of the launch writes it); any other row takes its chain by
// compare-and-swap (a NaN padding z and the real row may both write).
template <typename T, typename Zs>
__device__ __forceinline__ void col0_update(T* cb, int* flips, int g,
                                            int epoch, bool fix0, Zs zs) {
  using U = typename Bits<T>::U;
  bool nontrivial = false, pos_zero = false;
  zs([&](T z) {
    if (z != T(0) || isnan(z)) nontrivial = true;
    else if (!signbit(z)) pos_zero = true;
  });
  if (nontrivial) {
    U* at = reinterpret_cast<U*>(cb);
    U cur = Bits<T>::of(__ldcg(cb));
    while (true) {
      T x = Bits<T>::from(cur);
      if (fix0 && neg_zero(x)) x = T(0);
      zs([&](T z) { x = x + z; });
      const U seen = atomicCAS(at, cur, Bits<T>::of(x));
      if (seen == cur) break;
      cur = seen;
    }
  } else if (pos_zero && neg_zero(cb_read(cb, 0, fix0))) {
    flips[g] = epoch;
  }
}

// A row of up to KM slots of a colour group: what its thread loads before
// the group starts (none of it changes in earlier groups: y_i changes only
// in row i's group).
template <typename T, int KM>
struct ColorRow {
  T v[KM], l[KM], u[KM];
  int c[KM];
  T b, y, t;
  int i;
  bool act;
};

template <typename T, int KM>
__device__ __forceinline__ void load_color_row(ColorRow<T, KM>& r,
                                               const ColorArgs<T>& a, int g,
                                               int q, int lo) {
  const int K = a.K;
  const int i = a.order[q];
  r.i = i;
  if (a.sv != nullptr) {
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      const long long at = static_cast<long long>(j) * a.n_rows + q;
      r.v[j] = j < K ? a.sv[at] : T(0);
      r.c[j] = j < K ? a.sc[at] : 0;
      r.l[j] = j < K ? a.sl[at] : T(0);
      r.u[j] = j < K ? a.su[at] : T(0);
    }
    r.b = a.sb[q];
  } else {
    const long long off = static_cast<long long>(i) * K;
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      r.v[j] = j < K ? a.vals[off + j] : T(0);
      r.c[j] = j < K ? a.cols[off + j] : 0;
      r.l[j] = j < K ? a.lb[r.c[j]] : T(0);
      r.u[j] = j < K ? a.ub[r.c[j]] : T(0);
    }
    r.b = a.b[i];
  }
  r.y = a.y[i];
  r.act = a.active[i] != 0;
  r.t = group_tie(a, g, q, lo);
}

// One row of a colour group on one thread: the step (short_row_alpha), y_i,
// c_bar at its columns other than 0 (no other row of the group writes
// them), then column 0 (col0_update).
template <typename T, int KM>
__device__ __forceinline__ void color_row(const ColorRow<T, KM>& r,
                                          const ColorArgs<T>& a, int g,
                                          bool fix0) {
  const int K = a.K;
  T cv[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) cv[j] = j < K ? cb_read(a.cb, r.c[j], fix0) : T(0);
  const T alpha = short_row_alpha<T, KM>(r.v, cv, r.l, r.u, r.b, r.t, K);
  T diff;
  a.y[r.i] = step_y(alpha, r.act, r.y, a.project, &diff);
  T nv[KM];
  chain_updates<T, KM>(r.v, r.c, cv, diff, K, nv);
  bool any0 = false;
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j < K) {
      if (r.c[j] != 0) a.cb[r.c[j]] = nv[j];
      else any0 = true;
    }
  }
  if (any0)
    col0_update(a.cb, a.flips, g, a.epoch, fix0, [&](auto f) {
#pragma unroll
      for (int j = 0; j < KM; ++j)
        if (j < K && r.c[j] == 0) f(diff * r.v[j]);
    });
}

// Before group g: group g - 1's column-0 flip carries into g's word (one
// thread), and whether c_bar[0]'s -0 reads as +0 in g.
template <typename T>
__device__ __forceinline__ bool group_start(const ColorArgs<T>& a, int g) {
  if (g == 0) return false;
  const bool fix0 = __ldcg(a.flips + g - 1) == a.epoch;
  if (fix0 && blockIdx.x == 0 && threadIdx.x == 0) a.flips[g] = a.epoch;
  return fix0;
}

// After the last group's barrier: c_bar[0]'s pending flip, written.
template <typename T>
__device__ __forceinline__ void sweep_end(const ColorArgs<T>& a) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.n_groups > 0 &&
      __ldcg(a.flips + a.n_groups - 1) == a.epoch && neg_zero(__ldcg(a.cb)))
    a.cb[0] = T(0);
}

// The colour sweep, rows of up to KM <= kScanBase slots, one thread a row,
// on a persistent cooperative grid: group g's positions in strides of the
// grid, a grid barrier between groups.  Each thread loads its next row
// (this group's next, or the next group's first) before it steps the
// current one, so a group starts at its gathers of c_bar.
template <typename T, int KM>
__global__ void __launch_bounds__(kColorThreads)
    dca_color_sweep_kernel(ColorArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nt = gridDim.x * blockDim.x;
  ColorRow<T, KM> next;
  int lo = a.n_groups ? group_lo(a, 0) : 0;
  int hi = a.n_groups ? group_hi(a, 0) : 0;
  if (lo + tid < hi) load_color_row(next, a, 0, lo + tid, lo);
  for (int g = 0; g < a.n_groups; ++g) {
    const bool fix0 = group_start(a, g);
    const bool more = g + 1 < a.n_groups;
    const int lo2 = more ? group_lo(a, g + 1) : 0;
    const int hi2 = more ? group_hi(a, g + 1) : 0;
    for (int q = lo + tid; q < hi; q += nt) {
      const ColorRow<T, KM> cur = next;
      if (q + nt < hi)
        load_color_row(next, a, g, q + nt, lo);
      else if (lo2 + tid < hi2)
        load_color_row(next, a, g + 1, lo2 + tid, lo2);
      color_row(cur, a, g, fix0);
    }
    if (lo + tid >= hi && lo2 + tid < hi2)
      load_color_row(next, a, g + 1, lo2 + tid, lo2);
    grid.sync();
    lo = lo2;
    hi = hi2;
  }
  sweep_end(a);
}

// The colour sweep, rows past kScanBase slots, one warp a row read in place
// (row_alpha), on a persistent cooperative grid.  Lane j + 32 s writes c_bar
// at slot j's column (not 0) where j is its first slot there, the row's
// slots at that column chained in order; lane 0 takes column 0.
template <typename T>
__global__ void __launch_bounds__(32 * kColorWarps)
    dca_color_sweep_warp_kernel(ColorArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int K = a.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * (blockDim.x >> 5) + warp;
  const int nw = gridDim.x * (blockDim.x >> 5);
  Scratch<T> w(reinterpret_cast<T*>(smem_raw) + warp * scratch_entries<T>(K),
               K);
  for (int g = 0; g < a.n_groups; ++g) {
    const bool fix0 = group_start(a, g);
    const int lo = group_lo(a, g), hi = group_hi(a, g);
    for (int q = lo + gw; q < hi; q += nw) {
      const int i = a.order[q];
      const long long off = static_cast<long long>(i) * K;
      const T* rv = a.vals + off;
      const int* rc = a.cols + off;
      const Slot<T> first = load_slot(a.vals, a.cols, a.lb, a.ub, off, lane, K);
      const T tie = lane == 0 ? group_tie(a, g, q, lo) : T(0);
      const T* cb = a.cb;
      const T alpha = row_alpha(
          a.vals, a.cols, a.lb, a.ub, off, K, first, a.b[i],
          [cb, fix0](int c) { return cb_read(cb, c, fix0); }, tie, w, lane);
      T diff = T(0);
      if (lane == 0) diff = take_step(alpha, a.active[i] != 0, a.y, i, a.project);
      diff = __shfl_sync(0xffffffffu, diff, 0);
      for (int j = lane; j < K; j += 32) {
        const int c = rc[j];
        bool first_use = c != 0;
        for (int p = 0; p < j && first_use; ++p) first_use = rc[p] != c;
        if (!first_use) continue;
        T nv = cb_read(a.cb, c, false);
        for (int p = j; p < K; ++p)
          if (rc[p] == c) nv = nv + diff * rv[p];
        a.cb[c] = nv;
      }
      if (lane == 0) {
        bool any0 = false;
        for (int j = 0; j < K && !any0; ++j) any0 = rc[j] == 0;
        if (any0)
          col0_update(a.cb, a.flips, g, a.epoch, fix0, [&](auto f) {
            for (int j = 0; j < K; ++j)
              if (rc[j] == 0) f(diff * rv[j]);
          });
      }
      __syncwarp();
    }
    grid.sync();
  }
  sweep_end(a);
}

struct SweepArgs {
  const int* perm;
  const int* ptr;
  int n_levels, m, K, n, project;
  cudaStream_t stream;
};

template <typename T, int KM>
int launch_levels(T* y, T* cbar, const SweepArgs& s, const Work<T>& w) {
  const long long cbytes = static_cast<long long>(s.n) * sizeof(T);
  const bool in_smem = cbytes <= kSmemLimit;
  const int smem = in_smem ? static_cast<int>(cbytes) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      dca_levels_kernel<T, KM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dca_levels_kernel<T, KM><<<1, level_threads<T, KM>(), smem, s.stream>>>(
      y, cbar, s.perm, s.ptr, s.n_levels, s.m, s.K, s.n, s.project,
      in_smem ? 1 : 0, w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_levels_warp(const T* vals, const int* cols, const T* b,
                       const uint8_t* active, T* y, T* cbar, const T* lb,
                       const T* ub, const T* draws, const SweepArgs& s) {
  const long long per_warp = scratch_entries<T>(s.K) * sizeof(T);
  const int warps = static_cast<int>(
      min(static_cast<long long>(kMaxWarps), kSmemLimit / per_warp));
  const long long base = per_warp * warps;
  const long long cbytes = static_cast<long long>(s.n) * sizeof(T);
  const bool in_smem = base + cbytes <= kSmemLimit;
  const int smem = static_cast<int>(base + (in_smem ? cbytes : 0));
  cudaError_t err = cudaFuncSetAttribute(
      dca_levels_warp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dca_levels_warp_kernel<T><<<1, 32 * warps, smem, s.stream>>>(
      vals, cols, b, active, y, cbar, lb, ub, draws, s.perm, s.ptr,
      s.n_levels, s.K, s.n, s.project, in_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// The three launches of a sequential sweep, on one stream.
template <typename T>
int launch_sweep(const T* vals, const int* cols, const T* b,
                 const uint8_t* active, T* y, T* cbar, const T* lb,
                 const T* ub, const SweepArgs& s, uint32_t k1, uint32_t k2,
                 void* work, long long* key_out) {
  if (s.K < 1 || s.K > kMaxRow) return static_cast<int>(cudaErrorInvalidValue);
  const Work<T> w = carve_work<T>(work, s.m, s.K);
  dca_chain_kernel<<<1, 1, 0, s.stream>>>(k1, k2, s.m, w.keys, key_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dca_stage_kernel<T><<<(s.m + kStageBlock - 1) / kStageBlock, kStageBlock, 0,
                        s.stream>>>(vals, cols, b, active, lb, ub, s.perm,
                                    s.m, s.K, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s.K <= 4) return launch_levels<T, 4>(y, cbar, s, w);
  if (s.K <= 8) return launch_levels<T, 8>(y, cbar, s, w);
  if (s.K <= kScanBase) return launch_levels<T, kScanBase>(y, cbar, s, w);
  return launch_levels_warp<T>(vals, cols, b, active, y, cbar, lb, ub,
                               w.draws, s);
}

// A colour sweep kernel on a cooperative grid of the blocks that can be
// resident at once, and no more than the largest group needs
// (rows_per_block rows a block a pass).  A grid the card cannot hold
// resident is refused by the launch, which returns the error.
template <typename T, typename Kernel>
int launch_cooperative(Kernel kernel, int threads, int smem, int max_rows,
                       int rows_per_block, const ColorArgs<T>& a,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int need = max(1, (max_rows + rows_per_block - 1) / rows_per_block);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(min(per_sm * sms, need));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The colour sweep's one launch: a thread a row of up to kScanBase slots,
// a warp a longer row.
template <typename T>
int launch_color_sweep(const ColorArgs<T>& a, int max_rows, void* stream) {
  if (a.K < 1 || a.K > kMaxRow) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.K <= 4)
    return launch_cooperative<T>(dca_color_sweep_kernel<T, 4>, kColorThreads,
                                 0, max_rows, kColorThreads, a, s);
  if (a.K <= 8)
    return launch_cooperative<T>(dca_color_sweep_kernel<T, 8>, kColorThreads,
                                 0, max_rows, kColorThreads, a, s);
  if (a.K <= kScanBase)
    return launch_cooperative<T>(dca_color_sweep_kernel<T, kScanBase>,
                                 kColorThreads, 0, max_rows, kColorThreads, a,
                                 s);
  const long long per_warp = scratch_entries<T>(a.K) * sizeof(T);
  const int warps = static_cast<int>(
      min(static_cast<long long>(kColorWarps), kSmemLimit / per_warp));
  return launch_cooperative<T>(dca_color_sweep_warp_kernel<T>, 32 * warps,
                               static_cast<int>(per_warp * warps), max_rows,
                               warps, a, s);
}

}  // namespace

PSLP_EXPORT int pslp_dca_sweep_f32(const float* vals, const int* cols,
                                   const float* b, const uint8_t* active,
                                   float* y, float* cbar, const float* lb,
                                   const float* ub, const int* perm,
                                   const int* level_ptr, int n_levels, int m,
                                   int K, int n, uint32_t k1, uint32_t k2,
                                   void* work, long long* key_out,
                                   int project, void* stream) {
  const SweepArgs s{perm, level_ptr, n_levels, m, K, n, project,
                    static_cast<cudaStream_t>(stream)};
  return launch_sweep<float>(vals, cols, b, active, y, cbar, lb, ub, s, k1,
                             k2, work, key_out);
}

PSLP_EXPORT int pslp_dca_sweep_f64(const double* vals, const int* cols,
                                   const double* b, const uint8_t* active,
                                   double* y, double* cbar, const double* lb,
                                   const double* ub, const int* perm,
                                   const int* level_ptr, int n_levels, int m,
                                   int K, int n, uint32_t k1, uint32_t k2,
                                   void* work, long long* key_out,
                                   int project, void* stream) {
  const SweepArgs s{perm, level_ptr, n_levels, m, K, n, project,
                    static_cast<cudaStream_t>(stream)};
  return launch_sweep<double>(vals, cols, b, active, y, cbar, lb, ub, s, k1,
                              k2, work, key_out);
}

#define PSLP_DCA_COLOR_SWEEP(NAME, T)                                         \
  PSLP_EXPORT int NAME(                                                       \
      const T* vals, const int* cols, const T* b, const uint8_t* active,     \
      T* y, T* cbar, const T* lb, const T* ub, const int* order,              \
      const int* ptr, int n_groups, int n_rows, int max_rows,                 \
      const uint32_t* keys, uint32_t k1, uint32_t k2, uint32_t tie_offset,    \
      const T* sv, const int* sc, const T* sl, const T* su, const T* sb,      \
      int* flips, int epoch, int K, int project, void* stream) {              \
    const ColorArgs<T> a{vals, cols, b,  active, y,  cbar,     lb,         \
                         ub,   order, ptr, n_groups, n_rows, keys, k1,      \
                         k2,   tie_offset, sv, sl, su, sb, sc,  flips,      \
                         epoch, K, project};                                  \
    return launch_color_sweep<T>(a, max_rows, stream);                        \
  }

PSLP_DCA_COLOR_SWEEP(pslp_dca_color_sweep_f32, float)
PSLP_DCA_COLOR_SWEEP(pslp_dca_color_sweep_f64, double)
