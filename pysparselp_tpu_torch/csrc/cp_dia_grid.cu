// H-CPDIA-G: a whole chunk of Chambolle-Pock iterations on DIA operators in
// ONE cooperative launch of a persistent grid, a CTA an SM, each CTA's slab
// of every value plane held in its shared memory for the whole chunk.
//
// Replaces pysparselp_tpu/ops/cp_windowed.py::build_windowed_call (K3: one
// iteration per launch over row windows with a recomputed halo, eq + ineq)
// at the shapes whose slab fits (ops/cp_dia.py::grid_plan: Potts-100, and
// Potts-300 and the multi-label grids in float32 on bfloat16 planes).  The
// iteration is H-CPDIA's (cp_dia.cu):
//
//   d  = c + A_e^T y_e + A_i^T y_i
//   x2 = clip(x - T*d, l, u);   x3 = (1 + theta) x2 - theta x;   x = x2
//   y_e = y_e + s_e (A_e x3 - b_e)
//   y_i = max(y_i + s_i (A_i x3 - b_i), 0)
//
// with optional running sums of x, y_e and y_i.
//
// Bound on the H100.  The two-launch kernel streams every plane from device
// memory each iteration (at Potts-300, 26 planes of 360k values: 18.7 MB in
// bfloat16, 37.4 MB in float32).  Here the planes are read from device
// memory once a chunk; an iteration costs the shared-memory reads of both
// passes (each tap one plane value and one vector entry) over every SM at
// 128 B a clock, the L2 traffic of x3 and y (each CTA writes its slab and
// reads its halos) and of the vectors left out of shared memory, and two
// grid barriers.
//
// Design (ops/cp_dia.py::grid_plan chooses the CTA count, the slab width W,
// the halos and which vectors stay in shared memory, from the shapes):
// * One cooperative launch per chunk (cudaLaunchKernelEx with the
//   cooperative attribute); a grid the card cannot hold resident at once is
//   refused and the wrapper raises.
// * CTA r owns positions [r W, (r + 1) W) of the columns [0, n) and of the
//   rows [0, max(m, m_e)) for the whole chunk.  It stages its slab of every
//   plane once per chunk, as stored (bfloat16 or the compute type), and
//   widens each value exactly as it reads it (pslp::widen).
// * x3 lives in shared memory with A's halo (hlx entries before the slab,
//   hrx after), y and y_e with A^T's (hly, hry).  Each pass writes its
//   slab's new entries there and to device memory; after the grid barrier
//   that ends the pass, each CTA reads its halos back from device memory
//   (L2, __ldcg), so a halo may span several slabs.  Entries outside
//   [0, n) or [0, rows) hold zero, which a tap reads as pslp::dia_row reads
//   an out-of-range entry.
// * The vectors c, T, l, u, x, b, sigma and the sums keep a slab in shared
//   memory where it fits (the plan's in_smem bits, read and written through
//   generic pointers); the others are read (and x and the sums written) in
//   place in device memory each iteration.
// * Each iteration: the primal pass, a grid barrier, the x3 halos, the dual
//   pass, a grid barrier, the y halos.  The barriers order every write of a
//   slab to device memory before any read of it as a halo, and every halo
//   read before the next write of the same entries (one pass later).
// * Per position, the operations and their order are cp_primal_kernel's and
//   cp_dual_kernel's (--fmad=false: the same taps in dia_row's order, the
//   same clamp, NaN and signed zeros kept), so the outputs equal the
//   two-launch kernel's and the PyTorch twin's bit for bit.
//
// The shard entry (pslp_cp_dia_shard_grid_*, cp_dia_shard_grid_kernel) is
// a kernel of its own that runs the same iteration (the same taps in
// dia_row's order, the same clamp) ONCE on one rank's halo-padded slice of
// the position-sharded mesh solver (parallel/sharded_cp_windowed.py),
// where JAX runs K3 per shard, in one cooperative launch a call: the
// primal pass over the CTA's slab of the widened range [p0, p1), a grid
// barrier, the dual pass and the running sums over the slab's part of the
// interior [i0, i1).  The planes are read in place (they cannot stay in
// shared memory from one call to the next; a quarter shard's stay in L2),
// y and x3 through L1 (the grid barrier orders every x3 write before any
// read of it).  A tap whose global position lies outside the matrix adds
// vals * 0, as the two-launch shard entry's dia_row_local does, so a call
// equals one iteration of the chunk entry on the whole system bit for
// bit.  As it writes x and y it writes the rank's outgoing halo packet
// (parallel/mesh.py::halo_pack's layout), so the mesh issues no packing
// launch.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxDiag = 32;       // offsets a tap set may have (params)
// the vectors, in ops/cp_dia.py GRID_VECTORS order (the in_smem bits)
enum Vector { kX, kSX, kSY, kSYE, kC, kT, kLB, kUB, kB, kS, kBE, kSE,
              kVectors };

template <typename T, typename P>
struct GridArgs {
  int n, m, me;                 // columns, inequality rows, equality rows
  int ndt, nd, ndte, nde;       // diagonals of A_i^T, A_i, A_e^T, A_e
  int width;                    // W positions per CTA
  int hlx, hrx, hly, hry;       // halos of x3 and of y, y_e
  int in_smem;                  // bit v: vector v's slab in shared memory
  const T *c, *t, *lb, *ub, *b, *s, *be, *se;
  const P *vt, *v, *vte, *ve;   // planes as stored
  const T *x_in, *y_in, *ye_in;  // the chunk's start
  T *x, *x3, *y, *ye, *sx, *sy, *sye;   // its outputs, written whole
  T theta;
  int nsteps, with_sums;
  int offs[4][kMaxDiag];        // of A_i^T, A_i, A_e^T, A_e
};

// One tap set of local position l: sum_k vals[k W + l] * ext[l + offs[k]],
// in dia_row's order; ``ext`` points at the slab's first entry of a vector
// held with its halos (zeros outside the vector).
template <typename T, typename P>
__device__ __forceinline__ T taps(const P* vals, const int* offs, int nd,
                                  int width, int l, const T* ext) {
  T acc = T(0);
#pragma unroll 4
  for (int k = 0; k < nd; ++k) {
    acc = acc + pslp::widen<T>(vals[k * width + l]) * ext[l + offs[k]];
  }
  return acc;
}

template <typename P>
__device__ __forceinline__ void stage_planes(P* dst, const P* src, int nd,
                                             int width, int lo, int len) {
  for (int k = 0; k < nd; ++k) {
    const P* row = src + static_cast<long long>(k) * len;
    for (int l = threadIdx.x; l < width; l += blockDim.x) {
      const int p = lo + l;
      dst[k * width + l] = p < len ? row[p] : P(0.0f);
    }
  }
}

// Entries [lo - hl, lo) and [lo + W, lo + W + hr) of a vector of ``len``
// from device memory into its shared copy ``ext`` (ext[i] is position
// lo + i); zero outside [0, len).  A thread issues kHaloBatch loads before
// its first store, so their L2 round trips overlap.
constexpr int kHaloBatch = 4;

template <typename T>
__device__ __forceinline__ void load_halos(T* ext, const T* src, int width,
                                           int hl, int hr, int lo, int len) {
  const int total = hl + hr, step = blockDim.x;
  for (int base = threadIdx.x; base < total; base += kHaloBatch * step) {
    T v[kHaloBatch];
#pragma unroll
    for (int u = 0; u < kHaloBatch; ++u) {
      const int i = base + u * step;
      const int p = lo + (i < hl ? i - hl : width + (i - hl));
      v[u] = (i < total && p >= 0 && p < len) ? __ldcg(src + p) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kHaloBatch; ++u) {
      const int i = base + u * step;
      if (i < total) ext[i < hl ? i - hl : width + (i - hl)] = v[u];
    }
  }
}

template <typename T, typename P>
__global__ void __launch_bounds__(kMaxThreads, 1)
    cp_dia_grid_kernel(const __grid_constant__ GridArgs<T, P> a) {
  cg::grid_group grid = cg::this_grid();
  const int W = a.width, lo = blockIdx.x * W;
  const int n = a.n, m = a.m, me = a.me;
  const int rows = m > me ? m : me;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // each vector's slab: in shared memory, or in place in device memory
  // (ops/cp_dia.py GRID_STATIC_SMEM holds this array)
  __shared__ T* vec[kVectors];

  // the layout of ops/cp_dia.py::grid_smem_bytes
  P* vt_s = reinterpret_cast<P*>(smem_raw);
  P* v_s = vt_s + a.ndt * W;
  P* vte_s = v_s + a.nd * W;
  P* ve_s = vte_s + a.ndte * W;
  const int nplanes = a.ndt + a.nd + a.ndte + a.nde;
  unsigned char* p = smem_raw + (sizeof(P) * W * nplanes + 15) / 16 * 16;
  T* x3_e = reinterpret_cast<T*>(p) + a.hlx;
  p += sizeof(T) * (W + a.hlx + a.hrx);
  T* y_e = reinterpret_cast<T*>(p) + a.hly;
  if (m > 0) p += sizeof(T) * (W + a.hly + a.hry);
  T* ye_e = reinterpret_cast<T*>(p) + a.hly;
  if (me > 0) p += sizeof(T) * (W + a.hly + a.hry);
  if (threadIdx.x == 0) {
    T* const global[kVectors] = {
        a.x, a.sx, a.sy, a.sye, const_cast<T*>(a.c), const_cast<T*>(a.t),
        const_cast<T*>(a.lb), const_cast<T*>(a.ub), const_cast<T*>(a.b),
        const_cast<T*>(a.s), const_cast<T*>(a.be), const_cast<T*>(a.se)};
    for (int k = 0; k < kVectors; ++k) {
      if ((a.in_smem >> k) & 1) {
        vec[k] = reinterpret_cast<T*>(p);
        p += sizeof(T) * W;
      } else {
        vec[k] = global[k] == nullptr ? nullptr : global[k] + lo;
      }
    }
  }
  __syncthreads();
  const bool sums = a.with_sums != 0;

  // the chunk's one read of the planes, and its state: x, y and y_e
  // copied from the inputs and the sums zero, in shared memory where the
  // plan keeps them, else in the outputs (the CTA's slab); x3's copy all
  // zero (its slab is written before it is read, its halos after each
  // primal pass) and its output x (the chunk's x3 after no iteration);
  // y's and y_e's copies with their halos
  stage_planes<P>(vt_s, a.vt, a.ndt, W, lo, n);
  stage_planes<P>(v_s, a.v, a.nd, W, lo, m);
  stage_planes<P>(vte_s, a.vte, a.ndte, W, lo, n);
  stage_planes<P>(ve_s, a.ve, a.nde, W, lo, me);
  const int lens[kVectors] = {n, n, m, me, n, n, n, n, m, m, me, me};
  const T* const src[kVectors] = {a.x_in, nullptr, nullptr, nullptr,
                                  a.c,    a.t,     a.lb,    a.ub,
                                  a.b,    a.s,     a.be,    a.se};
  for (int k = 0; k < kVectors; ++k) {
    const bool here = (a.in_smem >> k) & 1;
    T* dst = vec[k];
    if (dst == nullptr || (!here && k > kSYE)) continue;
    for (int l = threadIdx.x; l < W; l += blockDim.x) {
      const int q = lo + l;
      if (here || q < lens[k])
        dst[l] = (src[k] != nullptr && q < lens[k]) ? src[k][q] : T(0);
    }
  }
  for (int l = threadIdx.x; l < W; l += blockDim.x) {
    const int q = lo + l;
    if (q < n) a.x3[q] = a.x_in[q];
    if (q < m) a.y[q] = a.y_in[q];
    if (q < me) a.ye[q] = a.ye_in[q];
  }
  for (int i = static_cast<int>(threadIdx.x) - a.hlx; i < W + a.hrx;
       i += blockDim.x)
    x3_e[i] = T(0);
  if (m > 0) {
    for (int i = static_cast<int>(threadIdx.x) - a.hly; i < W + a.hry;
         i += blockDim.x) {
      const int q = lo + i;
      y_e[i] = (q >= 0 && q < m) ? a.y_in[q] : T(0);
    }
  }
  if (me > 0) {
    for (int i = static_cast<int>(threadIdx.x) - a.hly; i < W + a.hry;
         i += blockDim.x) {
      const int q = lo + i;
      ye_e[i] = (q >= 0 && q < me) ? a.ye_in[q] : T(0);
    }
  }
  __syncthreads();

  T* const x = vec[kX];
  T* const sx = vec[kSX];
  T* const sy = vec[kSY];
  T* const sye = vec[kSYE];
  const T* const c = vec[kC];
  const T* const t = vec[kT];
  const T* const lb = vec[kLB];
  const T* const ub = vec[kUB];
  const T* const b = vec[kB];
  const T* const s = vec[kS];
  const T* const be = vec[kBE];
  const T* const se = vec[kSE];
  const T theta = a.theta;
  for (int it = 0; it < a.nsteps; ++it) {
    // primal pass: y(it - 1) with its halos -> x3(it) here and to L2
    for (int l = threadIdx.x; l < W; l += blockDim.x) {
      const int j = lo + l;
      if (j >= n) break;
      // the position's vectors first: those in device memory are in
      // flight while the taps run
      const T cj = c[l], tj = t[l], lj = lb[l], uj = ub[l], xo = x[l];
      T d = cj;
      if (me > 0) d = d + taps<T, P>(vte_s, a.offs[2], a.ndte, W, l, ye_e);
      if (m > 0) d = d + taps<T, P>(vt_s, a.offs[0], a.ndt, W, l, y_e);
      const T x2 = pslp::clamp<T>(xo - tj * d, lj, uj);
      const T x3v = (T(1) + theta) * x2 - theta * xo;
      x3_e[l] = x3v;
      a.x3[j] = x3v;
      x[l] = x2;
      if (sums) sx[l] = sx[l] + x2;
    }
    grid.sync();
    load_halos<T>(x3_e, a.x3, W, a.hlx, a.hrx, lo, n);
    __syncthreads();
    // dual pass: x3(it) with its halos -> y(it), y_e(it) here and to L2
    for (int l = threadIdx.x; l < W; l += blockDim.x) {
      const int i = lo + l;
      if (i >= rows) break;
      if (i < me) {
        const T bi = be[l], si = se[l];
        const T r = taps<T, P>(ve_s, a.offs[3], a.nde, W, l, x3_e) - bi;
        const T yn = ye_e[l] + si * r;
        ye_e[l] = yn;
        a.ye[i] = yn;
        if (sums) sye[l] = sye[l] + yn;
      }
      if (i < m) {
        const T bi = b[l], si = s[l];
        const T r = taps<T, P>(v_s, a.offs[1], a.nd, W, l, x3_e) - bi;
        T yn = y_e[l] + si * r;
        yn = pslp::clamp_min0<T>(yn);
        y_e[l] = yn;
        a.y[i] = yn;
        if (sums) sy[l] = sy[l] + yn;
      }
    }
    grid.sync();
    if (m > 0) load_halos<T>(y_e, a.y, W, a.hly, a.hry, lo, m);
    if (me > 0) load_halos<T>(ye_e, a.ye, W, a.hly, a.hry, lo, me);
    __syncthreads();
  }

  // the vectors kept here that the chunk changed, to device memory
  const int changed[4] = {kX, kSX, kSY, kSYE};
  T* const out[4] = {a.x, a.sx, a.sy, a.sye};
  for (int q = 0; q < 4; ++q) {
    const int k = changed[q];
    if (!((a.in_smem >> k) & 1) || out[q] == nullptr) continue;
    if (k != kX && !sums) continue;
    for (int l = threadIdx.x; l < W; l += blockDim.x) {
      if (lo + l < lens[k]) out[q][lo + l] = vec[k][l];
    }
  }
}

// The arguments of a shard entry call (one iteration on a rank's slice):
// local index k holds global position g0 + k, k in [0, len); the primal
// runs over [p0, p1), the dual and the sums over [i0, i1); CTA r owns
// positions [p0 + r W, p0 + (r + 1) W) of [p0, p1).
template <typename T, typename P>
struct ShardArgs {
  int len, g0, p0, p1, i0, i1, n, m, me;
  int ndt, nd, ndte, nde;       // diagonals of A_i^T, A_i, A_e^T, A_e
  int width;                    // W positions per CTA
  int xl, xr, yl, yr;           // the packet's edges of x, and of y, y_e
  const T *c, *t, *lb, *ub, *b, *s, *be, *se;
  const P *vt, *v, *vte, *ve;   // local planes as stored, read in place
  T *x, *x3, *y, *ye, *sx, *sy, *sye;   // the state, updated in place
  T* packet;                    // the outgoing halo packet, or nullptr
  T theta;
  int offs[4][kMaxDiag];        // of A_i^T, A_i, A_e^T, A_e
};

// The shard entry's taps issue their loads in batches of kTapBatch before
// the first of a batch is used, so that their round trips overlap (a tap
// loop unrolled by 4 waits for one round trip every 4 taps); the sum keeps
// dia_row's order.  A larger batch cost more time than it hid.
constexpr int kTapBatch = 8;

// One tap set of local position l (global g) on a slice, in place:
// dia_row_local's arithmetic (cp_dia.cu), a tap whose global position lies
// outside [0, nv) reading zero; the loads in batches of kTapBatch.
template <typename T, typename P>
__device__ __forceinline__ T taps_local(const P* vals, const int* offs,
                                        int nd, int len, const T* v, int nv,
                                        long long g, int l) {
  constexpr int B = kTapBatch;
  T acc = T(0);
  for (int k0 = 0; k0 < nd; k0 += B) {
    P pv[B];
    T xv[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int k = k0 + u;
      if (k < nd) {
        const int o = offs[k];
        const long long c = g + o;
        xv[u] = (c >= 0 && c < nv) ? v[l + o] : T(0);
        pv[u] = vals[static_cast<long long>(k) * len + l];
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (k0 + u < nd) acc = acc + pslp::widen<T>(pv[u]) * xv[u];
    }
  }
  return acc;
}

template <typename T, typename P>
__global__ void __launch_bounds__(kMaxThreads, 1)
    cp_dia_shard_grid_kernel(const __grid_constant__ ShardArgs<T, P> a) {
  cg::grid_group grid = cg::this_grid();
  const int lo = a.p0 + static_cast<int>(blockIdx.x) * a.width;
  const int hi = min(lo + a.width, a.p1);
  const int n = a.n, m = a.m, me = a.me, len = a.len;
  const int i0 = a.i0, i1 = a.i1;
  T* const pk = a.packet;
  // the packet (mesh.py::halo_pack): each item's right edge, then each
  // item's left edge, items x, y, then y_e where present; r*: where an
  // item's right edge ends, l*: where its left edge starts
  const int rx = a.xl, ry = a.xl + a.yl, rye = ry + a.yl;
  const int lx = a.xl + a.yl * (me > 0 ? 2 : 1);
  const int ly = lx + a.xr, lye = ly + a.yr;
  const T theta = a.theta;

  // primal pass over the slab: y (the caller's halos included) -> x, x3
  for (int jl = lo + static_cast<int>(threadIdx.x); jl < hi;
       jl += blockDim.x) {
    const long long g = static_cast<long long>(a.g0) + jl;
    T xn = a.x[jl];
    if (g >= 0 && g < n) {
      // the position's vectors first: in flight while the taps load
      const T cj = a.c[jl], tj = a.t[jl], lj = a.lb[jl], uj = a.ub[jl];
      T d = cj;
      if (me > 0)
        d = d + taps_local<T, P>(a.vte, a.offs[2], a.ndte, len, a.ye, me, g,
                                 jl);
      if (m > 0)
        d = d + taps_local<T, P>(a.vt, a.offs[0], a.ndt, len, a.y, m, g, jl);
      const T xo = xn;
      const T x2 = pslp::clamp<T>(xo - tj * d, lj, uj);
      a.x3[jl] = (T(1) + theta) * x2 - theta * xo;
      a.x[jl] = x2;
      xn = x2;
      if (a.sx != nullptr && jl >= i0 && jl < i1) a.sx[jl] = a.sx[jl] + x2;
    }
    if (pk != nullptr) {
      if (jl >= i1 - a.xl && jl < i1) pk[rx - (i1 - jl)] = xn;
      if (jl >= i0 && jl < i0 + a.xr) pk[lx + (jl - i0)] = xn;
    }
  }
  grid.sync();
  // dual pass over the slab's part of the interior: x3 -> y, y_e
  const int d0 = max(lo, i0), d1 = min(hi, i1);
  for (int il = d0 + static_cast<int>(threadIdx.x); il < d1;
       il += blockDim.x) {
    const long long g = static_cast<long long>(a.g0) + il;
    if (me > 0) {
      T yn = a.ye[il];
      if (g >= 0 && g < me) {
        const T bi = a.be[il], si = a.se[il];
        const T r = taps_local<T, P>(a.ve, a.offs[3], a.nde, len, a.x3, n, g,
                                     il) - bi;
        yn = yn + si * r;
        a.ye[il] = yn;
        if (a.sye != nullptr) a.sye[il] = a.sye[il] + yn;
      }
      if (pk != nullptr) {
        if (il >= i1 - a.yl) pk[rye - (i1 - il)] = yn;
        if (il < i0 + a.yr) pk[lye + (il - i0)] = yn;
      }
    }
    if (m > 0) {
      T yn = a.y[il];
      if (g >= 0 && g < m) {
        const T bi = a.b[il], si = a.s[il];
        const T r = taps_local<T, P>(a.v, a.offs[1], a.nd, len, a.x3, n, g,
                                     il) - bi;
        yn = yn + si * r;
        yn = pslp::clamp_min0<T>(yn);
        a.y[il] = yn;
        if (a.sy != nullptr) a.sy[il] = a.sy[il] + yn;
      }
      if (pk != nullptr) {
        if (il >= i1 - a.yl) pk[ry - (i1 - il)] = yn;
        if (il < i0 + a.yr) pk[ly + (il - i0)] = yn;
      }
    }
  }
}

// Before a plan's first launch (ops/cp_dia.py caches the answer per plan):
// lets ``kernel`` take every byte of dynamic shared memory the card allows
// a block, and returns in *ctas the CTAs of ``threads`` threads and
// ``smem_bytes`` the card holds resident at once (a cooperative launch of
// more is refused).
template <typename K>
int prepare(K kernel, int threads, int smem_bytes, int* ctas) {
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaFuncAttributes attrs;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin - static_cast<int>(attrs.sharedSizeBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *ctas = per_sm * sms;
  return 0;
}

// One cooperative launch of ``ctas`` CTAs of ``threads`` threads (refused
// by the driver when they cannot all be resident; prepare checks first).
template <typename K, typename A>
int launch(K kernel, const A& args, int ctas, int threads, int smem_bytes,
           void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The offsets of the four tap sets (A_i^T, A_i, A_e^T, A_e, in that order,
// ``counts`` of each) into a kernel's parameters.
inline int set_offsets(int (*dst)[kMaxDiag], const int* counts,
                       const int* offs) {
  for (int q = 0, at = 0; q < 4; at += counts[q], ++q) {
    if (counts[q] > kMaxDiag) return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < counts[q]; ++k) dst[q][k] = offs[at + k];
  }
  return 0;
}

// The cost of a grid barrier alone (chip_smoke.py's phase_grid): nsyncs
// grid.sync() in one cooperative launch of ``ctas`` CTAs.
__global__ void grid_sync_loop_kernel(int nsyncs) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < nsyncs; ++i) grid.sync();
}

}  // namespace

PSLP_EXPORT int pslp_grid_sync_loop(int ctas, int threads, int nsyncs,
                                    void* stream) {
  return launch(grid_sync_loop_kernel, nsyncs, ctas, threads, 0, stream);
}

#define PSLP_CP_DIA_GRID(SUFFIX, T, P)                                       \
  PSLP_EXPORT int pslp_cp_dia_grid_##SUFFIX(                                 \
      int n, int m, int me, int ndt, int nd, int ndte, int nde, int width,   \
      int hlx, int hrx, int hly, int hry, int in_smem, const int* offs,      \
      const T* c, const T* t, const T* lb, const T* ub, const T* b,          \
      const T* s, const T* be, const T* se, const P* vt, const P* v,         \
      const P* vte, const P* ve, const T* x_in, const T* y_in,               \
      const T* ye_in, T* x, T* x3, T* y, T* ye, T* sx, T* sy, T* sye,        \
      T theta, int nsteps, int with_sums, int ctas, int threads,             \
      int smem_bytes, void* stream) {                                        \
    GridArgs<T, P> args{n,     m,     me,    ndt,   nd,    ndte,   nde,      \
                        width, hlx,   hrx,   hly,   hry,   in_smem, c,       \
                        t,     lb,    ub,    b,     s,     be,     se,       \
                        vt,    v,     vte,   ve,    x_in,  y_in,   ye_in,    \
                        x,     x3,    y,     ye,    sx,    sy,     sye,      \
                        theta, nsteps, with_sums, {}};                       \
    if (!with_sums) args.sx = args.sy = args.sye = nullptr;                  \
    const int counts[4] = {ndt, nd, ndte, nde};                              \
    const int rc = set_offsets(args.offs, counts, offs);                     \
    if (rc) return rc;                                                       \
    return launch(cp_dia_grid_kernel<T, P>, args, ctas, threads,             \
                  smem_bytes, stream);                                       \
  }                                                                          \
  PSLP_EXPORT int pslp_cp_dia_grid_prepare_##SUFFIX(int threads,             \
                                                    int smem_bytes,          \
                                                    int* ctas) {             \
    return prepare(cp_dia_grid_kernel<T, P>, threads, smem_bytes, ctas);     \
  }

PSLP_CP_DIA_GRID(f32, float, float)
PSLP_CP_DIA_GRID(f64, double, double)
PSLP_CP_DIA_GRID(f32_bf16, float, __nv_bfloat16)

// The shard entry: one iteration on a rank's slice in one cooperative
// launch.  ``packet`` (nullptr: none) receives the rank's outgoing halo
// packet; ``xl, xr`` are the widths of x's edges in it, ``yl, yr`` y's.
#define PSLP_CP_DIA_SHARD_GRID(SUFFIX, T, P)                                  \
  PSLP_EXPORT int pslp_cp_dia_shard_grid_##SUFFIX(                            \
      int len, int g0, int p0, int p1, int i0, int i1, int n, int m, int me,  \
      int ndt, int nd, int ndte, int nde, int width, int xl, int xr, int yl,  \
      int yr, const int* offs, const T* c, const T* lb, const T* ub,          \
      const T* b, const T* be, const P* vt, const P* v, const P* vte,         \
      const P* ve, const T* t, const T* s, const T* se, T* x, T* x3, T* y,    \
      T* ye, T* sx, T* sy, T* sye, T* packet, T theta, int ctas, int threads, \
      void* stream) {                                                         \
    ShardArgs<T, P> args{len, g0,  p0,  p1,  i0,  i1,  n,   m,     me,        \
                         ndt, nd,  ndte, nde, width, xl, xr, yl,   yr,        \
                         c,   t,   lb,  ub,  b,   s,   be,  se,    vt,        \
                         v,   vte, ve,  x,   x3,  y,   ye,  sx,    sy,        \
                         sye, packet, theta, {}};                             \
    const int counts[4] = {ndt, nd, ndte, nde};                               \
    const int rc = set_offsets(args.offs, counts, offs);                      \
    if (rc) return rc;                                                        \
    return launch(cp_dia_shard_grid_kernel<T, P>, args, ctas, threads, 0,     \
                  stream);                                                    \
  }                                                                           \
  PSLP_EXPORT int pslp_cp_dia_shard_grid_prepare_##SUFFIX(int threads,        \
                                                          int* ctas) {        \
    return prepare(cp_dia_shard_grid_kernel<T, P>, threads, 0, ctas);         \
  }

PSLP_CP_DIA_SHARD_GRID(f32, float, float)
PSLP_CP_DIA_SHARD_GRID(f64, double, double)
PSLP_CP_DIA_SHARD_GRID(f32_bf16, float, __nv_bfloat16)
