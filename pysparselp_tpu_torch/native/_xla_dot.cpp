// Dot products in the order XLA's CPU backend computes jnp.dot of two
// vectors (pysparselp_tpu_torch/utils/xla_order.py): a column-major GEMV of
// one row, eight columns a tile.  The first tile's products are rounded and
// summed in turn; every later column is one fused multiply-add into the
// running sum (the backend contracts that tile's multiply and add).  A dot
// of exactly two entries is one product and one fused multiply-add.
// Built with -ffp-contract=off, so only std::fma fuses.
#include <cmath>

namespace {

template <typename T>
T xla_dot(const T* a, const T* b, long n) {
  if (n <= 0) return T(0);
  T acc = a[0] * b[0];
  const long plain = n == 2 ? 1 : (n < 8 ? n : 8);
  for (long c = 1; c < plain; ++c) acc = acc + a[c] * b[c];
  for (long c = plain; c < n; ++c) acc = std::fma(a[c], b[c], acc);
  return acc;
}

}  // namespace

extern "C" {
float pslp_xla_dot_f32(const float* a, const float* b, long n) {
  return xla_dot<float>(a, b, n);
}
double pslp_xla_dot_f64(const double* a, const double* b, long n) {
  return xla_dot<double>(a, b, n);
}
}
