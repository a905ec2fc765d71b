// H-CPDIA-R: a whole chunk of Chambolle-Pock iterations on DIA operators in
// ONE launch, the chunk's state and operators held in the shared memory of
// one thread-block cluster.
//
// Replaces pysparselp_tpu/ops/cp_fused.py::_cp_fused_call (K2), which ran
// nsteps whole CP iterations of an inequality-only DIA LP in one pallas_call
// with everything resident in one TPU core's VMEM.  Same iteration as
// H-CPDIA (cp_dia.cu), eq + ineq, with the same optional running sums:
//
//   d  = c + A_e^T y_e + A_i^T y_i
//   x2 = clip(x - T*d, l, u);   x3 = (1 + theta) x2 - theta x;   x = x2
//   y_e = y_e + s_e (A_e x3 - b_e)
//   y_i = max(y_i + s_i (A_i x3 - b_i), 0)
//
// Bound on the H100: at the small aligned grids this kernel serves
// (Potts-50: 9,996 positions, 13 + 13 diagonals, ~1.5 MB in f32) the
// two-launch H-CPDIA spends its time launching, not moving its ~1.5 MB an
// iteration.  Held in shared memory, an iteration costs the shared-memory
// traffic of both passes over C SMs (128 B per clock each) and the two
// barriers between the passes; device memory is read once and written once
// per chunk, whatever nsteps is.
//
// Design (ops/cp_dia.py::cp_dia_plan chooses C and the slab width W from
// the shapes alone and mirrors the layout below):
// * One launch per chunk: the grid is ONE cluster of C CTAs (C <= 16;
//   16 is a non-portable cluster size).
// * CTA r owns positions [r W, (r + 1) W) of both the column range [0, n)
//   and the row range [0, max(m, m_e)), and keeps its slab of every value
//   plane, of c, T, l, u, b, sigma, of x, x3, y (and y_e), and of the running
//   sums in its shared memory for the whole chunk.
// * Halos: the plan requires every |offset| <= R <= W, so the taps of a slab
//   reach only its two neighbours.  Each slab holds x3, y and y_e with R
//   entries of halo on each side; a pass that computes an entry within R of
//   a slab edge also stores it into the neighbour's halo, a remote store
//   into its shared memory (distributed shared memory).  Every tap then is
//   a local shared-memory load, branch-free, the mask a select; a tap
//   outside [0, n) or [0, rows) reads zero, as pslp::dia_row does.
// * x3, y and y_e have two buffers, one per iteration parity: iteration t
//   writes x3(t) and y(t) into buffer t & 1 and reads y(t - 1) from the
//   other.
// * Barriers: the halo stores are st.async, whose completion counts their
//   bytes on the receiver's mbarrier of that vector's buffer (x3 or y,
//   buffer t & 1).  At the start of iteration t one thread arrives on its
//   CTA's two mbarriers with the bytes the neighbours will send; a pass
//   ends with __syncthreads() (this slab's own entries) and a wait on the
//   pass's mbarrier (the neighbours' halo entries, acquired at cluster
//   scope).  That is enough:
//   - read after write: the primal pass of t reads y(t - 1), complete
//     after the previous wait; the dual pass of t reads x3(t), complete
//     after this iteration's first wait;
//   - write after read: a neighbour stores x3(t) into buffer t & 1, which
//     this CTA last read in the dual pass of t - 2; the neighbour is in
//     the primal pass of t only after this CTA's y(t - 1) halo entries
//     reached it, and those are stored in the dual pass of t - 1, after
//     this CTA's threads have all left the dual pass of t - 2.  Likewise
//     for y(t) against the primal pass of t - 1;
//   - an mbarrier of buffer k is used by every second iteration; a
//     neighbour's stores for t + 2 need this CTA's y(t + 1), sent only
//     after this CTA's wait of t on that mbarrier, so no phase takes
//     another phase's bytes.
//   A pass ending at cluster.sync() instead waits for all C CTAs and pays
//   the cluster-wide release and acquire (PERF.md, H-CPDIA-R's findings:
//   1.6x slower at Potts-50).  cluster.sync() after the loads lets no CTA
//   store into a neighbour before it is resident and its mbarriers are
//   initialised; one after the loop keeps every CTA's shared memory alive
//   until no neighbour reaches it.
// * Per element, the operations and their order are the two-launch
//   kernel's and the PyTorch twin's (--fmad=false), so the outputs are
//   bit-identical to both.
// * No wgmma or TMA: the planes are a gather-free stream from shared memory;
//   the offsets travel in the kernel's parameters (constant space).
// * Planes stored in bfloat16 (a float32 solve whose values are exact
//   there) are widened exactly as they are staged, so the shared-memory
//   layout is the same on either storage and so is every output.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
// the most dynamic shared memory a block can take on Hopper (227 KB)
constexpr int kSmemMax = 232448;
// diagonals a tap set may have: the offsets travel in the kernel's
// parameters (constant space, read by every thread at once)
constexpr int kMaxDiag = 32;
// four mbarriers ahead of the arrays: x3's and y's, for each buffer
constexpr int kBarrierBytes = 32;

template <typename T, typename P>
struct ResidentArgs {
  int n, m, me;               // columns, inequality rows, equality rows
  int ndt, nd, ndte, nde;     // diagonals of A_i^T, A_i, A_e^T, A_e
  int width, reach;           // W positions per CTA, R halo positions
  const T *c, *t, *lb, *ub;
  const P *vt, *v;            // inequality system: planes as stored,
  const T *b, *s;             // b and sigma
  const P *vte, *ve;          // equality system
  const T *be, *se;
  const T *x_in, *y_in, *ye_in;
  T *x, *x3, *y, *ye, *sx, *sy, *sye;
  T theta;
  int nsteps, with_sums;
  int offs[4][kMaxDiag];      // of A_i^T, A_i, A_e^T, A_e
};

// One tap set of a position: sum_k vals[k W + l] * vec[pos + offs[k]],
// reads outside [0, nv) zero, in dia_row's order.  ``ext`` is the slab of
// the vector with its halo (ext[-R] .. ext[W + R - 1] are held), so every
// read is a local shared-memory load at an address that exists; the mask
// is a select, and the loop has no branch for the loads to wait on.
template <typename T>
__device__ __forceinline__ T taps(const T* vals, const int* offs, int ndiag,
                                  int width, int l, int pos, int nv,
                                  const T* ext) {
  T acc = T(0);
#pragma unroll 4
  for (int k = 0; k < ndiag; ++k) {
    const int o = offs[k];
    const int q = pos + o;
    const T xv = ext[l + o];
    acc = acc + vals[k * width + l] * (q >= 0 && q < nv ? xv : T(0));
  }
  return acc;
}

// A slab of each plane into shared memory, widened exactly to T as it is
// staged (planes stored in bfloat16 take the same layout as in T).
template <typename T, typename P>
__device__ __forceinline__ void load_planes(T* dst, const P* src, int nd,
                                            int stride, int width, int lo,
                                            int len) {
  for (int k = 0; k < nd; ++k) {
    for (int l = threadIdx.x; l < width; l += blockDim.x) {
      const int p = lo + l;
      dst[k * width + l] =
          p < len ? pslp::widen<T>(src[static_cast<long long>(k) * stride + p])
                  : T(0);
    }
  }
}

// A vector with its halo from device memory: ext[i] for i in [-R, W + R)
// is entry lo + i of src (zero outside [0, len)).
template <typename T>
__device__ __forceinline__ void load_ext(T* ext, const T* src, int width,
                                         int reach, int lo, int len) {
  for (int i = static_cast<int>(threadIdx.x) - reach; i < width + reach;
       i += static_cast<int>(blockDim.x)) {
    const int p = lo + i;
    ext[i] = (p >= 0 && p < len) ? src[p] : T(0);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of ``addr`` in CTA ``rank``.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// A remote store whose completion counts its bytes on the receiver's
// mbarrier (release at cluster scope when that mbarrier's phase completes).
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, double v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];" ::"r"(addr),
      "l"(__double_as_longlong(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One vector held with halos (x3, y or y_e): two buffers of W + 2 R
// entries, one per iteration parity; ``own`` is buffer 0's first slab
// entry, buffer k at own + k E.  The neighbours' copies: shared::cluster
// addresses of the same entry and of the neighbour's mbarrier of this
// vector's buffer 0.
template <typename T>
struct Halo {
  T* own;
  uint32_t dsm_l, dsm_r, bar_l, bar_r;
  bool has_l, has_r;
};

template <typename T>
__device__ __forceinline__ Halo<T> make_halo(T* own, uint32_t bar, int rank,
                                             int last) {
  Halo<T> h;
  h.own = own;
  h.has_l = rank > 0;
  h.has_r = rank < last;
  const int l = h.has_l ? rank - 1 : rank, r = h.has_r ? rank + 1 : rank;
  h.dsm_l = mapa(smem_addr(own), l);
  h.dsm_r = mapa(smem_addr(own), r);
  h.bar_l = mapa(bar, l);
  h.bar_r = mapa(bar, r);
  return h;
}

// Position l's new value into buffer k here, and into the halo of each
// neighbour that reads it (the left one holds this slab's first R entries
// after its own W, the right one its last R before its first).
template <typename T>
__device__ __forceinline__ void push(const Halo<T>& h, int k, int ext,
                                     int width, int reach, int l, T v) {
  h.own[k * ext + l] = v;
  if (h.has_l && l < reach) {
    const int i = k * ext + width + l;
    st_async(h.dsm_l + i * static_cast<int>(sizeof(T)), v, h.bar_l + 8 * k);
  }
  if (h.has_r && l >= width - reach) {
    const int i = k * ext + l - width;
    st_async(h.dsm_r + i * static_cast<int>(sizeof(T)), v, h.bar_r + 8 * k);
  }
}

// Entries of a vector of ``len`` the neighbours push into this slab's
// halos each pass: their computed positions within R of it.
__device__ __forceinline__ int halo_entries(int lo, int width, int reach,
                                            int len, bool has_l, bool has_r) {
  int count = 0;
  if (has_l) count += max(0, min(lo, len) - max(lo - reach, 0));
  if (has_r) count += max(0, min(lo + width + reach, len) - (lo + width));
  return count;
}

// The barrier after a pass: this CTA's threads meet at __syncthreads()
// (its own slab), then wait on its mbarrier of the pass's buffer, which
// completes when the neighbours' st.async halo entries have all landed
// (and this CTA's one arrival with their byte count, made at the start of
// the iteration): no CTA waits for slabs it does not read.
__device__ __forceinline__ void pass_barrier(uint32_t bar, uint32_t parity) {
  __syncthreads();
  mbar_wait(bar, parity);
}

template <typename T, typename P>
__global__ void __launch_bounds__(kMaxThreads)
    cp_dia_resident_kernel(const __grid_constant__ ResidentArgs<T, P> a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int last = static_cast<int>(cluster.num_blocks()) - 1;
  const int W = a.width, R = a.reach, E = W + 2 * R, lo = rank * W;
  const int n = a.n, m = a.m, me = a.me;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  // the layout of ops/cp_dia.py::resident_smem_bytes: four mbarriers, then
  // W entries an array, two buffers of W + 2 R for x3, y and y_e
  const uint32_t bar_x3 = smem_addr(smem_raw), bar_y = bar_x3 + 16;
  T* p = reinterpret_cast<T*>(smem_raw + kBarrierBytes);
  T* c_s = p; p += W;
  T* t_s = p; p += W;
  T* lb_s = p; p += W;
  T* ub_s = p; p += W;
  T* x_s = p; p += W;
  T* sx_s = p; p += W;
  T* x3_b = p + R; p += 2 * E;
  T* vt_s = p; p += a.ndt * W;
  T* vte_s = p; p += a.ndte * W;
  T *b_s = p, *s_s = p, *sy_s = p, *y_b = p, *v_s = p;
  if (m > 0) {
    b_s = p; p += W;
    s_s = p; p += W;
    sy_s = p; p += W;
    y_b = p + R; p += 2 * E;
    v_s = p; p += a.nd * W;
  }
  T *be_s = p, *se_s = p, *sye_s = p, *ye_b = p, *ve_s = p;
  if (me > 0) {
    be_s = p; p += W;
    se_s = p; p += W;
    sye_s = p; p += W;
    ye_b = p + R; p += 2 * E;
    ve_s = p; p += a.nde * W;
  }

  // the chunk's one read of device memory; y(-1) and y_e(-1) with their
  // halos into buffer 1, which the first primal pass reads (x3's buffers
  // are written before they are read)
  for (int l = threadIdx.x; l < W; l += blockDim.x) {
    const int j = lo + l;
    const bool col = j < n;
    c_s[l] = col ? a.c[j] : T(0);
    t_s[l] = col ? a.t[j] : T(0);
    lb_s[l] = col ? a.lb[j] : T(0);
    ub_s[l] = col ? a.ub[j] : T(0);
    x_s[l] = col ? a.x_in[j] : T(0);
    sx_s[l] = T(0);
    if (m > 0) {
      const bool row = j < m;
      b_s[l] = row ? a.b[j] : T(0);
      s_s[l] = row ? a.s[j] : T(0);
      sy_s[l] = T(0);
    }
    if (me > 0) {
      const bool row = j < me;
      be_s[l] = row ? a.be[j] : T(0);
      se_s[l] = row ? a.se[j] : T(0);
      sye_s[l] = T(0);
    }
  }
  if (m > 0) load_ext<T>(y_b + E, a.y_in, W, R, lo, m);
  if (me > 0) load_ext<T>(ye_b + E, a.ye_in, W, R, lo, me);
  load_planes<T, P>(vt_s, a.vt, a.ndt, n, W, lo, n);
  load_planes<T, P>(vte_s, a.vte, a.ndte, n, W, lo, n);
  if (m > 0) load_planes<T, P>(v_s, a.v, a.nd, m, W, lo, m);
  if (me > 0) load_planes<T, P>(ve_s, a.ve, a.nde, me, W, lo, me);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) mbar_init(bar_x3 + 8 * k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const Halo<T> hx3 = make_halo<T>(x3_b, bar_x3, rank, last);
  const Halo<T> hy = make_halo<T>(y_b, bar_y, rank, last);
  const Halo<T> hye = make_halo<T>(ye_b, bar_y, rank, last);
  const uint32_t sz = sizeof(T);
  const uint32_t bytes_x3 =
      sz * halo_entries(lo, W, R, n, hx3.has_l, hx3.has_r);
  const uint32_t bytes_y =
      sz * ((m > 0 ? halo_entries(lo, W, R, m, hy.has_l, hy.has_r) : 0) +
            (me > 0 ? halo_entries(lo, W, R, me, hy.has_l, hy.has_r) : 0));
  const T theta = a.theta;
  const bool sums = a.with_sums != 0;
  const int rows = m > me ? m : me;
  // every CTA resident and loaded, its mbarriers initialised, before any
  // remote store
  cluster.sync();

  for (int it = 0; it < a.nsteps; ++it) {
    const int k = it & 1;
    const uint32_t parity = static_cast<uint32_t>((it >> 1) & 1);
    if (threadIdx.x == 0) {
      mbar_arrive_expect(bar_x3 + 8 * k, bytes_x3);
      mbar_arrive_expect(bar_y + 8 * k, bytes_y);
    }
    // primal pass: reads y(it - 1) with its halo (buffer k ^ 1), writes
    // x3(it) into buffer k here and into the neighbours' halos
    const T* y_prev = y_b + (k ^ 1) * E;
    const T* ye_prev = ye_b + (k ^ 1) * E;
    for (int l = threadIdx.x; l < W; l += blockDim.x) {
      const int j = lo + l;
      if (j >= n) break;
      T d = c_s[l];
      if (me > 0)
        d = d + taps<T>(vte_s, a.offs[2], a.ndte, W, l, j, me, ye_prev);
      if (m > 0) d = d + taps<T>(vt_s, a.offs[0], a.ndt, W, l, j, m, y_prev);
      const T xo = x_s[l];
      const T x2 = pslp::clamp<T>(xo - t_s[l] * d, lb_s[l], ub_s[l]);
      push<T>(hx3, k, E, W, R, l, (T(1) + theta) * x2 - theta * xo);
      x_s[l] = x2;
      if (sums) sx_s[l] = sx_s[l] + x2;
    }
    pass_barrier(bar_x3 + 8 * k, parity);
    // dual pass: reads x3(it) (buffer k), writes y(it) into buffer k
    const T* x3_cur = x3_b + k * E;
    for (int l = threadIdx.x; l < W; l += blockDim.x) {
      const int i = lo + l;
      if (i >= rows) break;
      if (i < me) {
        const T r =
            taps<T>(ve_s, a.offs[3], a.nde, W, l, i, n, x3_cur) - be_s[l];
        const T yn = ye_prev[l] + se_s[l] * r;
        push<T>(hye, k, E, W, R, l, yn);
        if (sums) sye_s[l] = sye_s[l] + yn;
      }
      if (i < m) {
        const T r = taps<T>(v_s, a.offs[1], a.nd, W, l, i, n, x3_cur) - b_s[l];
        T yn = y_prev[l] + s_s[l] * r;
        yn = pslp::clamp_min0<T>(yn);
        push<T>(hy, k, E, W, R, l, yn);
        if (sums) sy_s[l] = sy_s[l] + yn;
      }
    }
    pass_barrier(bar_y + 8 * k, parity);
  }
  // no CTA leaves while a neighbour may still reach its shared memory
  cluster.sync();

  // the chunk's one write to device memory (own slab only): the buffers
  // of the last iteration
  const int kl = (a.nsteps + 1) & 1;
  for (int l = threadIdx.x; l < W; l += blockDim.x) {
    const int j = lo + l;
    if (j < n) {
      a.x[j] = x_s[l];
      a.x3[j] = a.nsteps > 0 ? x3_b[kl * E + l] : x_s[l];
      if (sums) a.sx[j] = sx_s[l];
    }
    if (j < m) {
      a.y[j] = y_b[kl * E + l];
      if (sums) a.sy[j] = sy_s[l];
    }
    if (j < me) {
      a.ye[j] = ye_b[kl * E + l];
      if (sums) a.sye[j] = sye_s[l];
    }
  }
}

cudaLaunchConfig_t cluster_config(int cluster, int threads, int smem_bytes,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Once per plan, before its first launch: allow the non-portable cluster
// size and the shared memory, then ask how many such clusters the card can
// hold at once (0: the plan cannot launch; the wrapper raises).
template <typename T, typename P>
int prepare(int cluster, int threads, int smem_bytes, int* clusters) {
  auto kernel = cp_dia_resident_kernel<T, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(cluster, threads, smem_bytes, nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  return static_cast<int>(err);
}

template <typename T, typename P>
int launch(const ResidentArgs<T, P>& args, int cluster, int threads,
           int smem_bytes, void* stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(cluster, threads, smem_bytes,
                     static_cast<cudaStream_t>(stream), &attr);
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, cp_dia_resident_kernel<T, P>, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int entry(ResidentArgs<T, P> args, const int* offs, int cluster, int threads,
          int smem_bytes, void* stream) {
  const int counts[4] = {args.ndt, args.nd, args.ndte, args.nde};
  for (int s = 0, at = 0; s < 4; at += counts[s], ++s) {
    if (counts[s] > kMaxDiag) return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < counts[s]; ++k) args.offs[s][k] = offs[at + k];
  }
  return launch<T, P>(args, cluster, threads, smem_bytes, stream);
}

// The cost of a barrier alone (chip_smoke.py's barrier_times): nsyncs
// barriers in one launch of one cluster, cluster.sync() (mode 0) or this
// kernel's pass barrier once every halo entry has landed (mode 1:
// __syncthreads() and a local mbarrier phase).
__global__ void cluster_sync_loop_kernel(int nsyncs, int mode) {
  __shared__ uint64_t bars[2];
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t bar = smem_addr(bars);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
  }
  cluster.sync();
  for (int i = 0; i < nsyncs; ++i) {
    if (mode == 0) {
      cluster.sync();
    } else {
      const uint32_t b = bar + 8 * (i & 1);
      if (threadIdx.x == 0) mbar_arrive_expect(b, 0);
      pass_barrier(b, static_cast<uint32_t>((i >> 1) & 1));
    }
  }
  cluster.sync();
}

}  // namespace

#define PSLP_CP_DIA_RESIDENT(SUFFIX, T, P)                                    \
  PSLP_EXPORT int pslp_cp_dia_resident_prepare_##SUFFIX(                      \
      int cluster, int threads, int smem_bytes, int* clusters) {              \
    return prepare<T, P>(cluster, threads, smem_bytes, clusters);             \
  }                                                                           \
  PSLP_EXPORT int pslp_cp_dia_resident_##SUFFIX(                              \
      int n, int m, int me, int ndt, int nd, int ndte, int nde, int width,    \
      int reach, const int* offs, const T* c, const T* t, const T* lb,        \
      const T* ub, const P* vt, const P* v, const T* b, const T* s,           \
      const P* vte, const P* ve, const T* be, const T* se, const T* x_in,     \
      const T* y_in, const T* ye_in, T* x, T* x3, T* y, T* ye, T* sx, T* sy,  \
      T* sye, T theta, int nsteps, int with_sums, int cluster, int threads,   \
      int smem_bytes, void* stream) {                                         \
    ResidentArgs<T, P> args{n,     m,     me,    ndt,   nd,    ndte,  nde,  \
                            width, reach, c,     t,     lb,    ub,    vt,   \
                            v,     b,     s,     vte,   ve,    be,    se,   \
                            x_in,  y_in,  ye_in, x,     x3,    y,     ye,   \
                            sx,    sy,    sye,   theta, nsteps, with_sums,  \
                            {}};                                            \
    return entry<T, P>(args, offs, cluster, threads, smem_bytes, stream);     \
  }

PSLP_CP_DIA_RESIDENT(f32, float, float)
PSLP_CP_DIA_RESIDENT(f64, double, double)
PSLP_CP_DIA_RESIDENT(f32_bf16, float, __nv_bfloat16)

PSLP_EXPORT int pslp_cluster_sync_loop(int cluster, int threads, int nsyncs,
                                       int mode, void* stream) {
  auto kernel = cluster_sync_loop_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(
      cluster, threads, 0, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, nsyncs, mode);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
