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
// (the CSC of A) for A^T y.
//
// Bound on the H100 (3.35 TB/s HBM at 700 W): memory.  One call moves
//   nnz * (value itemsize + 4)      values (2 bytes in bfloat16) and
//                                   column indices,
//   (n_out + 1) * 4                 row pointers,
//   n_out * itemsize                the output,
// plus the gathered x: n_in * itemsize when x stays in the 50 MB L2 (the
// transport LP's x, 1M f32, is 4 MB), more when the gathers miss.  The
// arithmetic is one multiply-add per stored entry.  On the main path's
// matrices the gathers of x are random, and what limits the kernel is how
// many of them each SM keeps in flight.
//
// Design: ONE launch per product, whatever the row lengths, over a plan
// the host builds once with the operator (ops/csr_spmv.py::split_plan):
// * the first blocks give every row a sub-warp of W lanes (W = 2..32 from
//   the mean row length), lanes striding over the row, then a fixed
//   shuffle tree.  Small blocks of independent rows keep the most gathers
//   in flight per SM (the merge-path kernels this replaced, which staged a
//   CTA's entries or scanned them in lockstep, were slower on every large
//   main-path matrix: PERF.md, PR 5);
// * a row longer than kLongStrides * W entries (the k-medians LP's
//   ~5,000-entry used[c] columns of A^T) is skipped there and cut into
//   chunks of equal entries (within one), one block each, in the same
//   launch: threads stride over the chunk, warps reduce by the shuffle
//   tree, the warps' partials are added in order into the chunk's slot of
//   `carries`.  Each chunk block counts itself into its row's integer
//   counter (an acquire-release atomic); the last to arrive sums the row's
//   chunk slots in chunk order (one warp, lane-strided, then the shuffle
//   tree), writes y[row] and resets the counter for the next call.
// * x is read through the read-only data path (__ldg); indices and values
//   by plain loads (the evict-first hint, __ldcs, measured slower on the
//   main path's matrices: PERF.md, PR 5).
// * the values are read as stored: in the compute type T, or in bfloat16
//   (V) for a float32 product whose every value is exact in bfloat16 (the
//   JAX package's routed ELL storage: 2 bytes a value, widened exactly in
//   registers by pslp::widen), so the product is bit for bit the float32
//   values' on the same plan.
// No floating-point atomics: every sum has a fixed order, so the same
// inputs give the same bits (the tests emulate the order).  A plan's carries
// and counters serve one call at a time (calls on one stream).
//
// H-CSR-B, the same product over B right-hand sides stored batch-last,
//   Y[r, b] = sum_k vals[k] * X[indices[k], b],   X (n_in, B), Y (n_out, B),
// serves the batched CP iteration (batch.py), on values stored in T (the
// batch path keeps the dtype, as JAX's does).  It replaces the vmapped
// gather-ELL product of pysparselp_tpu/batch.py:147 (EllMatrix under
// jax.vmap; no pallas_call stands behind it).  Bounds: memory, each entry's
// value and index read once for all B columns, plus X and Y; and the
// gathers, every entry's row of X (B neighbouring values, at B = 8 in f32
// one 32-byte sector) from L2, where X fits: at the rate the card serves
// random 32-byte rows of an L2-resident buffer (chip_smoke.gather_rate,
// ~3.7 TB/s on an H100) the unstructured LP's 1.95M rows take ~17 us, which
// binds, and this kernel runs at ~78% of it.  Kernels that sum each column
// in csr_kernel's order (so that column b equals csr_kernel on X[:, b]),
// and kernels that gather 16 or 32 bytes a thread, all measured slower on
// that LP (PERF.md); this one keeps its own order.  Design, on the same
// plan:
// * a block is S = 256 / min(B, 256) rows by min(B, 256) columns (columns
//   fastest; a thread loops over its columns when B > 256): one thread per
//   (row, b), so the B threads of a row read each entry's value and index
//   together (a broadcast) and gather neighbouring X values; the thread
//   sums its row in entry order.  Rows the plan cuts into chunks are
//   skipped there;
// * a chunk of a long row is one block of the same shape: thread (s, b)
//   sums strand s of the chunk's entries (every S-th) for column b; the
//   strands' sums are added in strand order into the chunk's B carries;
//   the last chunk of the row to arrive adds the row's carries in chunk
//   order for each column.  The carries (n_chunks x B) and the
//   arrival counters are the caller's, separate from the 1-D entry's, so a
//   batched and a 1-D product on one operand never share a slot.
#include "common.cuh"

namespace {

constexpr int kThreads = pslp::kBlock;
constexpr int kWarps = kThreads / 32;
// a row longer than kLongStrides * W entries is cut into chunks
// (LONG_STRIDES in ops/csr_spmv.py)
constexpr int kLongStrides = 32;
constexpr unsigned kFull = 0xffffffffu;

// views into the packed int32 plan of c chunks and m long rows ("tasks")
struct Plan {
  const int* chunk_begin;  // c: the chunk's first entry
  const int* chunk_end;    // c: one past its last entry
  const int* chunk_task;   // c: its row's task
  const int* task_row;     // m
  const int* task_first;   // m: the task's first chunk (its carries slot)
  const int* task_count;   // m: its chunks, consecutive
  int* counter;            // m: chunks arrived (zero between calls)
};

__device__ __forceinline__ Plan plan_view(int* p, int c, int m) {
  Plan v;
  v.chunk_begin = p;
  v.chunk_end = p + c;
  v.chunk_task = p + 2 * c;
  v.task_row = p + 3 * c;
  v.task_first = p + 3 * c + m;
  v.task_count = p + 3 * c + 2 * m;
  v.counter = p + 3 * c + 3 * m;
  return v;
}

// arrival at a task: release this block's carry; the block that arrives
// last then acquires the others' (acquire_fence) before it reads them
__device__ __forceinline__ int arrive(int* counter) {
  int old;
  asm volatile("atom.release.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

__device__ __forceinline__ void acquire_fence() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// sum over entries begin + lane, begin + lane + step, ... below end; the
// values stored as V, widened exactly to T
template <typename T, typename V>
__device__ __forceinline__ T gather_dot(const int* __restrict__ indices,
                                        const V* __restrict__ vals,
                                        const T* __restrict__ x, int begin,
                                        int end, int lane, int step) {
  T acc = T(0);
  for (int k = begin + lane; k < end; k += step) {
    acc = acc + pslp::widen<T>(vals[k]) * __ldg(x + indices[k]);
  }
  return acc;
}

template <typename T, typename V, int W>
__global__ void __launch_bounds__(kThreads)
csr_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
           const V* __restrict__ vals, int* plan_raw, int n_out,
           int row_blocks, int n_chunks, int n_tasks, T* carries,
           const T* __restrict__ x, T* __restrict__ y) {
  __shared__ T partial[kWarps];
  __shared__ int sfinish;
  const int t = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    // a sub-warp per row; every lane of a sub-warp has the same row, so a
    // sub-warp leaves together
    const long long row =
        (static_cast<long long>(blockIdx.x) * kThreads + t) / W;
    if (row >= n_out) return;
    const int lane = t % W;
    const int begin = indptr[row];
    const int end = indptr[row + 1];
    if (end - begin > kLongStrides * W) return;  // cut into chunks
    T acc = gather_dot(indices, vals, x, begin, end, lane, W);
    const unsigned group = (t % 32) / W * W;
    const unsigned mask =
        W == 32 ? kFull : (((1u << (W % 32)) - 1u) << group);
#pragma unroll
    for (int off = 1; off < W; off <<= 1) {
      acc = acc + __shfl_xor_sync(mask, acc, off, W);
    }
    if (lane == 0) y[row] = acc;
    return;
  }

  // a chunk of a long row
  const Plan plan = plan_view(plan_raw, n_chunks, n_tasks);
  const int c = blockIdx.x - row_blocks;
  const int lane = t & 31, warp = t >> 5;
  T acc = gather_dot(indices, vals, x, plan.chunk_begin[c], plan.chunk_end[c],
                     t, kThreads);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    acc = acc + __shfl_xor_sync(kFull, acc, off);
  }
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (t == 0) {
    T sum = T(0);
    for (int w = 0; w < kWarps; ++w) sum = sum + partial[w];
    carries[c] = sum;
    const int task = plan.chunk_task[c];
    const int before = arrive(plan.counter + task);
    sfinish = before == plan.task_count[task] - 1 ? task : -1;
    if (sfinish >= 0) acquire_fence();
  }
  __syncthreads();
  const int task = sfinish;
  if (task < 0 || warp != 0) return;
  // the row's last chunk to arrive: its chunks' sums in chunk order
  const int first = plan.task_first[task], count = plan.task_count[task];
  T sum = T(0);
  for (int k = lane; k < count; k += 32) {
    sum = sum + __ldcg(carries + first + k);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    sum = sum + __shfl_xor_sync(kFull, sum, off);
  }
  if (lane == 0) {
    y[plan.task_row[task]] = sum;
    plan.counter[task] = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_batch_kernel(const int* __restrict__ indptr,
                 const int* __restrict__ indices, const T* __restrict__ vals,
                 int* plan_raw, int* counter, int n_out, int width,
                 int row_blocks, int n_chunks, int n_tasks, T* carries,
                 const T* __restrict__ x, T* __restrict__ y, int nb) {
  // a block is blockDim.y rows (or strands) x blockDim.x columns
  __shared__ T partial[kThreads];
  __shared__ int sfinish;
  const int cols = blockDim.x, strands = blockDim.y;
  const int lane = threadIdx.x, s = threadIdx.y;
  const int t = s * cols + lane;
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    const int row = blockIdx.x * strands + s;
    if (row >= n_out) return;
    const int begin = indptr[row];
    const int end = indptr[row + 1];
    if (end - begin > kLongStrides * width) return;  // cut into chunks
    for (int b = lane; b < nb; b += cols) {
      T acc = T(0);
      for (int k = begin; k < end; ++k) {
        acc = acc + vals[k] * __ldg(x + static_cast<long long>(indices[k])
                                    * nb + b);
      }
      y[static_cast<long long>(row) * nb + b] = acc;
    }
    return;
  }

  // a chunk of a long row, all B columns: strand s of its entries
  const Plan plan = plan_view(plan_raw, n_chunks, n_tasks);
  const int c = blockIdx.x - row_blocks;
  const int begin = plan.chunk_begin[c], end = plan.chunk_end[c];
  for (int b0 = 0; b0 < nb; b0 += cols) {
    const int b = b0 + lane;
    T acc = T(0);
    if (b < nb) {
      for (int k = begin + s; k < end; k += strands) {
        acc = acc + vals[k] * __ldg(x + static_cast<long long>(indices[k])
                                    * nb + b);
      }
    }
    partial[t] = acc;
    __syncthreads();
    if (t < cols && b0 + t < nb) {
      T sum = T(0);
      for (int q = 0; q < strands; ++q) sum = sum + partial[q * cols + t];
      carries[static_cast<long long>(c) * nb + b0 + t] = sum;
      __threadfence();
    }
    __syncthreads();
  }
  if (t == 0) {
    const int task = plan.chunk_task[c];
    const int before = arrive(counter + task);
    sfinish = before == plan.task_count[task] - 1 ? task : -1;
  }
  __syncthreads();
  const int task = sfinish;
  if (task < 0) return;
  acquire_fence();
  // the row's last chunk to arrive: its chunks' carries in chunk order
  const int first = plan.task_first[task], count = plan.task_count[task];
  const long long out = static_cast<long long>(plan.task_row[task]) * nb;
  for (int b = t; b < nb; b += cols * strands) {
    T sum = T(0);
    for (int j = 0; j < count; ++j) {
      sum = sum + __ldcg(carries + static_cast<long long>(first + j) * nb + b);
    }
    y[out + b] = sum;
  }
  if (t == 0) counter[task] = 0;
}

template <typename T>
int launch_batch(const int* indptr, const int* indices, const T* vals,
                 int* plan, int n_out, int width, int n_chunks, int n_tasks,
                 T* carries, int* counters, const T* x, T* y, int nb,
                 void* stream_ptr) {
  if (nb <= 0) return static_cast<int>(cudaSuccess);
  const int cols = nb < kThreads ? nb : kThreads;
  const int strands = kThreads / cols;
  const long long row_blocks = (static_cast<long long>(n_out) + strands - 1)
                               / strands;
  const long long blocks = row_blocks + n_chunks;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  csr_batch_kernel<T><<<static_cast<unsigned>(blocks), dim3(cols, strands),
                        0, static_cast<cudaStream_t>(stream_ptr)>>>(
      indptr, indices, vals, plan, counters, n_out, width,
      static_cast<int>(row_blocks), n_chunks, n_tasks, carries, x, y, nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename V>
int launch(const int* indptr, const int* indices, const V* vals, int* plan,
           int n_out, int width, int n_chunks, int n_tasks, T* carries,
           const T* x, T* y, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long row_blocks =
      (static_cast<long long>(n_out) * width + kThreads - 1) / kThreads;
  const long long blocks = row_blocks + n_chunks;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
#define PSLP_CSR_LAUNCH(W)                                                  \
  csr_kernel<T, V, W><<<static_cast<unsigned>(blocks), kThreads, 0,        \
                        stream>>>(                                          \
      indptr, indices, vals, plan, n_out, static_cast<int>(row_blocks),     \
      n_chunks, n_tasks, carries, x, y)
  switch (width) {
    case 2: PSLP_CSR_LAUNCH(2); break;
    case 4: PSLP_CSR_LAUNCH(4); break;
    case 8: PSLP_CSR_LAUNCH(8); break;
    case 16: PSLP_CSR_LAUNCH(16); break;
    case 32: PSLP_CSR_LAUNCH(32); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PSLP_CSR_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PSLP_CSR(SUFFIX, T, V)                                               \
  PSLP_EXPORT int pslp_csr_spmv_##SUFFIX(                                    \
      const int* indptr, const int* indices, const V* vals, int* plan,       \
      int n_out, int width, int n_chunks, int n_tasks, T* carries,           \
      const T* x, T* y, void* stream) {                                      \
    return launch<T, V>(indptr, indices, vals, plan, n_out, width,           \
                        n_chunks, n_tasks, carries, x, y, stream);           \
  }

PSLP_CSR(f32, float, float)
PSLP_CSR(f64, double, double)
// float32 products on values stored in bfloat16 (exact values), the JAX
// package's routed ELL storage: half the value bytes
PSLP_CSR(f32_bf16, float, __nv_bfloat16)

#define PSLP_CSR_BATCH(SUFFIX, T)                                            \
  PSLP_EXPORT int pslp_csr_spmm_##SUFFIX(                                    \
      const int* indptr, const int* indices, const T* vals, int* plan,       \
      int n_out, int width, int n_chunks, int n_tasks, T* carries,           \
      int* counters, const T* x, T* y, int nb, void* stream) {               \
    return launch_batch<T>(indptr, indices, vals, plan, n_out, width,        \
                           n_chunks, n_tasks, carries, counters, x, y, nb,   \
                           stream);                                          \
  }

PSLP_CSR_BATCH(f32, float)
PSLP_CSR_BATCH(f64, double)
