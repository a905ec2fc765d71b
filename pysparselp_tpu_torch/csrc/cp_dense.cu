// H-CPDENSE: nsteps whole Chambolle-Pock iterations on dense A_e / A_i in one
// launch.
//
// Replaces pysparselp_tpu/ops/cp_fused.py::_cp_dense_fused_call (K1), which
// kept both dense systems and every vector in one TPU core's VMEM for a whole
// chunk.  Same iteration as H-CPDIA (cp_dia.cu) with dense operators, and the
// same optional running sums of x, y_e and y_i.
//
// Bound on the H100: one SM's arithmetic.  At the netlib size this kernel
// serves (SC105: 45 + 60 rows x 103 columns) an iteration is 2 (m n) = 21,630
// multiply-adds with a global dependency between its two halves, so ONE
// persistent thread block runs the chunk and the least time is those
// operations at one SM's share of the f32 rate (67 TFLOP/s / 132 SMs:
// ~0.09 us per iteration); the bytes over the whole card's HBM rate give
// 0.015 us, which no one-block kernel can approach.
//
// Design:
// * The chunk's state lives in shared memory: x, x3, c, t, lb, ub and the
//   x sum, then y = [y_e; y_i] with its b, sigma and sum, loaded once per
//   launch and written back once at the end.
// * Both A = [A_e; A_i] and its transpose are staged row-major, so both
//   products are unit-stride row dot-products of 16-byte vectors.  Phase 1
//   (d = c + A^T y, the primal prox and over-relaxation) gives each column
//   a group of w1 lanes, phase 2 (A x3, the dual steps) each row a group of
//   w2 lanes, and a fixed xor-shuffle tree adds the lanes.  A lane runs two
//   independent chains (a column's equality and inequality parts; a row's
//   even and odd steps), so the loads of one overlap the adds of the other.
//   The wrapper picks w from the dot product's length (a few vector steps
//   a lane) and launches only the warps the groups fill: on a small system
//   the time per iteration is mostly the fixed cost of every warp's
//   instructions, shuffles and two barriers, not the multiply-adds
//   (PERF.md, PR 5).
// * Two __syncthreads() per iteration, one after each phase.
// * Size tiers, chosen by the wrapper (ops/cp_dense.py::dense_layout):
//   everything in shared memory (SC105 in f32: 93 KB of operators, padded);
//   or the state in shared memory and both operators in a global scratch
//   buffer, where within the dense budget (4 MB) they stay in L2; or, past
//   the shared memory, the state there too.  The code is the same, on other
//   base pointers.
// Accumulation is in the working precision (no TF32), as the TPU kernel's
// precision=HIGHEST.  The dot products use fused multiply-adds
// (__fmaf_rn, __fma_rn); every other product and sum rounds separately
// (--fmad=false).
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

// 16-byte vectors of the working type: kVec entries per shared-memory load
template <typename T> struct VecOf;
template <> struct VecOf<float> { using type = float4; static constexpr int n = 4; };
template <> struct VecOf<double> { using type = double2; static constexpr int n = 2; };

__device__ __forceinline__ float dot_step(float acc, float4 a, float4 b) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

__device__ __forceinline__ double dot_step(double acc, double2 a, double2 b) {
  acc = __fma_rn(a.x, b.x, acc);
  return __fma_rn(a.y, b.y, acc);
}

__host__ __device__ __forceinline__ int round_up(int v, int to) {
  return (v + to - 1) / to * to;
}

template <typename T>
struct DenseArgs {
  int n, me, mi;
  const T *c, *t, *lb, *ub;
  const T *ae, *be, *se, *ai, *bi, *si;
  const T *x_in, *ye_in, *yi_in;
  T *x, *x3, *ye, *yi, *sx, *sye, *syi;
  T* scratch;  // [state | A | A^T] where shared memory does not hold them
  T theta;
  int nsteps, with_sums;
  int w1, w2;
  int threads;  // the block: a multiple of 32 and of w1 and w2, <= 1024
};

// The layout (ops/cp_dense.py::dense_layout mirrors it), in entries: a
// column of A^T holds the equality part padded to me_p and the inequality
// part padded to mi_p, multiples of the kVec * w1 entries a group reads per
// step; a row of A is padded to ld_a, a multiple of kVec * w2; the padding
// is zero.  The state, every segment a multiple of kVec: x and x3 (ld_a),
// y = [y_e | y_i] padded as a column of A^T (ld_t), c, t, lb, ub and the x
// sum (n rounded up), b, sigma and the y sum by row (m rounded up).
template <typename T, bool kStateShared, bool kOpsShared>
__global__ void __launch_bounds__(kMaxThreads) cp_dense_kernel(DenseArgs<T> a) {
  using V = typename VecOf<T>::type;
  constexpr int kVec = VecOf<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int n = a.n, me = a.me, mi = a.mi, m = a.me + a.mi;
  const int w1 = a.w1, w2 = a.w2;
  const int me_p = round_up(me, kVec * w1), mi_p = round_up(mi, kVec * w1);
  const int ld_t = me_p + mi_p;
  const int ld_a = round_up(n, kVec * w2);
  const int n_r = round_up(n, kVec), m_r = round_up(m, kVec);
  const int state_len = 2 * ld_a + ld_t + 5 * n_r + 3 * m_r;
  T* st = kStateShared ? sm : a.scratch;
  T* opb = kOpsShared ? sm + state_len : a.scratch + state_len;
  T* x = st;
  T* x3 = x + ld_a;
  T* y = x3 + ld_a;
  T* c = y + ld_t;
  T* t = c + n_r;
  T* lb = t + n_r;
  T* ub = lb + n_r;
  T* sx = ub + n_r;
  T* b = sx + n_r;
  T* sig = b + m_r;
  T* sy = sig + m_r;
  T* A = opb;                                        // m rows of ld_a
  T* AT = opb + static_cast<long long>(m) * ld_a;    // n rows of ld_t
  const int tid = threadIdx.x;
  const int threads = blockDim.x;

  // load the state and the operators, zero in the padding
  for (int j = tid; j < ld_a; j += threads) {
    const T xv = j < n ? a.x_in[j] : T(0);
    x[j] = xv;
    x3[j] = xv;
    if (j < n) {
      c[j] = a.c[j];
      t[j] = a.t[j];
      lb[j] = a.lb[j];
      ub[j] = a.ub[j];
      sx[j] = T(0);
    }
  }
  for (int q = tid; q < ld_t; q += threads) {
    const int r = q - me_p;
    y[q] = q < me ? a.ye_in[q] : (r >= 0 && r < mi ? a.yi_in[r] : T(0));
  }
  for (int i = tid; i < m; i += threads) {
    const bool eq = i < me;
    const int k = eq ? i : i - me;
    b[i] = eq ? a.be[k] : a.bi[k];
    sig[i] = eq ? a.se[k] : a.si[k];
    sy[i] = T(0);
  }
  const long long a_len = static_cast<long long>(m) * ld_a;
  for (long long k = tid; k < a_len; k += threads) {
    const int i = static_cast<int>(k / ld_a);
    const int j = static_cast<int>(k - static_cast<long long>(i) * ld_a);
    T v = T(0);
    if (j < n) v = i < me ? a.ae[static_cast<long long>(i) * n + j]
                          : a.ai[static_cast<long long>(i - me) * n + j];
    A[k] = v;
  }
  const long long t_len = static_cast<long long>(n) * ld_t;
  for (long long k = tid; k < t_len; k += threads) {
    const int j = static_cast<int>(k / ld_t);
    const int q = static_cast<int>(k - static_cast<long long>(j) * ld_t);
    const int r = q - me_p;
    T v = T(0);
    if (q < me) v = a.ae[static_cast<long long>(q) * n + j];
    else if (r >= 0 && r < mi) v = a.ai[static_cast<long long>(r) * n + j];
    AT[k] = v;
  }
  __syncthreads();

  const int ng1 = threads / w1, g1 = tid / w1, l1 = tid % w1;
  const int ng2 = threads / w2, g2 = tid / w2, l2 = tid % w2;
  const int rounds1 = (n + ng1 - 1) / ng1;
  const int rounds2 = (m + ng2 - 1) / ng2;
  // vector steps of a group over the equality and inequality parts of a
  // column, and over a row
  const int s1 = kVec * w1, s2 = kVec * w2;
  const int steps1 = max(me_p, mi_p) / s1;
  const int steps2 = ld_a / s2;
  const V* yv = reinterpret_cast<const V*>(y);
  const V* x3v = reinterpret_cast<const V*>(x3);
  const T theta = a.theta;
  const bool sums = a.with_sums != 0;
  for (int it = 0; it < a.nsteps; ++it) {
    // phase 1: d = c + A_e^T y_e + A_i^T y_i, primal prox, over-relaxation
    for (int r = 0; r < rounds1; ++r) {
      const int j = r * ng1 + g1;
      T de = T(0), di = T(0);
      if (j < n) {
        const V* col = reinterpret_cast<const V*>(
            AT + static_cast<long long>(j) * ld_t);
#pragma unroll 2
        for (int k = 0; k < steps1; ++k) {
          const int qe = (k * s1) / kVec + l1;
          const int qi = (me_p + k * s1) / kVec + l1;
          if (k * s1 < me_p) de = dot_step(de, col[qe], yv[qe]);
          if (k * s1 < mi_p) di = dot_step(di, col[qi], yv[qi]);
        }
      }
      for (int o = w1 >> 1; o > 0; o >>= 1) {
        de = de + __shfl_xor_sync(0xffffffffu, de, o);
        di = di + __shfl_xor_sync(0xffffffffu, di, o);
      }
      if (j < n && l1 == 0) {
        T d = c[j];
        if (me > 0) d = d + de;
        if (mi > 0) d = d + di;
        const T xo = x[j];
        const T x2 = pslp::clamp<T>(xo - t[j] * d, lb[j], ub[j]);
        x3[j] = (T(1) + theta) * x2 - theta * xo;
        x[j] = x2;
        if (sums) sx[j] = sx[j] + x2;
      }
    }
    __syncthreads();
    // phase 2: residuals over x3 and the dual steps; a lane's even and odd
    // steps in two chains
    for (int r = 0; r < rounds2; ++r) {
      const int i = r * ng2 + g2;
      T a0 = T(0), a1 = T(0);
      if (i < m) {
        const V* row = reinterpret_cast<const V*>(
            A + static_cast<long long>(i) * ld_a);
#pragma unroll 2
        for (int k = 0; k + 1 < steps2; k += 2) {
          const int q0 = (k * s2) / kVec + l2, q1 = q0 + w2;
          a0 = dot_step(a0, row[q0], x3v[q0]);
          a1 = dot_step(a1, row[q1], x3v[q1]);
        }
        if (steps2 % 2) {
          const int q = ((steps2 - 1) * s2) / kVec + l2;
          a0 = dot_step(a0, row[q], x3v[q]);
        }
      }
      T acc = a0 + a1;
      for (int o = w2 >> 1; o > 0; o >>= 1)
        acc = acc + __shfl_xor_sync(0xffffffffu, acc, o);
      if (i < m && l2 == 0) {
        const int q = i < me ? i : me_p + (i - me);
        T yn = y[q] + sig[i] * (acc - b[i]);
        if (i >= me) yn = pslp::clamp_min0<T>(yn);
        y[q] = yn;
        if (sums) sy[i] = sy[i] + yn;
      }
    }
    __syncthreads();
  }

  // write the state back
  for (int j = tid; j < n; j += threads) {
    a.x[j] = x[j];
    a.x3[j] = x3[j];
    if (sums) a.sx[j] = sx[j];
  }
  for (int i = tid; i < m; i += threads) {
    if (i < me) {
      a.ye[i] = y[i];
      if (sums) a.sye[i] = sy[i];
    } else {
      a.yi[i - me] = y[me_p + i - me];
      if (sums) a.syi[i - me] = sy[i];
    }
  }
}

template <typename T, bool kStateShared, bool kOpsShared>
int launch(const DenseArgs<T>& args, int smem_bytes, cudaStream_t stream) {
  auto kernel = cp_dense_kernel<T, kStateShared, kOpsShared>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (args.n > 0) kernel<<<1, args.threads, smem_bytes, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int chunk(const DenseArgs<T>& args, int state_smem, int ops_smem,
          int smem_bytes, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (ops_smem) return launch<T, true, true>(args, smem_bytes, stream);
  if (state_smem) return launch<T, true, false>(args, smem_bytes, stream);
  return launch<T, false, false>(args, smem_bytes, stream);
}

}  // namespace

#define PSLP_CP_DENSE(SUFFIX, T)                                              \
  PSLP_EXPORT int pslp_cp_dense_chunk_##SUFFIX(                               \
      int n, int me, int mi, const T* c, const T* t, const T* lb,             \
      const T* ub, const T* ae, const T* be, const T* se, const T* ai,        \
      const T* bi, const T* si, const T* x_in, const T* ye_in,                \
      const T* yi_in, T* x, T* x3, T* ye, T* yi, T* sx, T* sye, T* syi,       \
      T* scratch, T theta, int nsteps, int with_sums, int w1, int w2,         \
      int threads, int state_smem, int ops_smem, int smem_bytes,              \
      void* stream) {                                                         \
    DenseArgs<T> args{n,     me,    mi,    c,       t,     lb,     ub,        \
                      ae,    be,    se,    ai,      bi,    si,     x_in,      \
                      ye_in, yi_in, x,     x3,      ye,    yi,     sx,        \
                      sye,   syi,   scratch, theta, nsteps, with_sums, w1,    \
                      w2,    threads};                                        \
    return chunk<T>(args, state_smem, ops_smem, smem_bytes, stream);          \
  }

PSLP_CP_DENSE(f32, float)
PSLP_CP_DENSE(f64, double)
