// Shared helpers of the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define PSLP_EXPORT extern "C" __attribute__((visibility("default")))

namespace pslp {

constexpr int kBlock = 256;

inline int grid_for(long long n) {
  return static_cast<int>((n + kBlock - 1) / kBlock);
}

// A plane value as the compute type T reads it: DIA planes are stored in T,
// or in bfloat16 for a float32 solve where every value is exact in bfloat16
// (the JAX package's allow_bf16="exact" rule); the widening is exact, so a
// product computes bit for bit what it computes on the float32 planes.
template <typename T, typename P>
__device__ __forceinline__ T widen(P v) {
  return static_cast<T>(v);
}

template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One row of a DIA product: sum_k vals[k, r] * v[r + offs[k]], diagonals in
// ascending-offset order, out-of-range reads contributing zero (the JAX
// kernels' zero padding).  Every product and sum is rounded separately
// (built with --fmad=false), exactly as the PyTorch twin's
// ``y = y + vals[k] * v_shifted`` sequence.  P is the planes' storage type.
template <typename T, typename P = T>
__device__ __forceinline__ T dia_row(const P* __restrict__ vals,
                                     const int* __restrict__ offs, int ndiag,
                                     long long stride, const T* v, int nv,
                                     int r) {
  T acc = T(0);
  for (int k = 0; k < ndiag; ++k) {
    const long long c = static_cast<long long>(r) + offs[k];
    const T xv = (c >= 0 && c < nv) ? v[c] : T(0);
    acc = acc + widen<T>(vals[k * stride + r]) * xv;
  }
  return acc;
}

// torch.clamp(v, lo, hi) with tensor bounds as ATen's CUDA kernel computes
// it: a NaN in v, else in lo, else in hi comes out as it is; otherwise
// ::min(::max(v, lo), hi), the same device functions, so a signed zero
// comes out as the twin's does on the card.
template <typename T>
__device__ __forceinline__ T clamp(T v, T lo, T hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return ::min(::max(v, lo), hi);
}

// torch.clamp_min(v, 0.0) as ATen's CUDA kernel computes it: a NaN comes
// out as it is, else ::max(v, 0).
template <typename T>
__device__ __forceinline__ T clamp_min0(T v) {
  return isnan(v) ? v : ::max(v, T(0));
}

}  // namespace pslp
