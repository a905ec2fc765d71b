// Sequential SOR / bounded Gauss-Seidel sweeps over a CSR matrix.
//
// Host-side native component of the framework (built with g++, loaded via
// ctypes): the exact sequential sweep is inherently serial and is kept for
// algorithmic parity with first-order ADMM variants whose convergence was
// tuned around Gauss-Seidel inner solves (reference behavior:
// pysparselp/gaussSiedel.pyx:21-153).  The TPU execution path uses the
// damped projected Jacobi analogue instead (solvers/admm.py); this kernel
// is the faithful host-mode twin.
//
// All arrays are caller-owned. Returns 0 on success.

#include <cstdint>

extern "C" {

// Plain SOR sweep: x <- (1-w) x + w D^{-1} (b - (L+U) x), rows visited in
// `order` (or 0..n-1 when order == nullptr), `maxiter` full sweeps.
int gauss_seidel(const double* data, const std::int32_t* indices,
                 const std::int32_t* indptr, std::int32_t nrows,
                 double* x, const double* b, const std::int32_t* order,
                 std::int32_t norder, double w, std::int32_t maxiter) {
    for (std::int32_t it = 0; it < maxiter; ++it) {
        for (std::int32_t k = 0; k < (order ? norder : nrows); ++k) {
            const std::int32_t r = order ? order[k] : k;
            double acc = b[r];
            double diag = 0.0;
            for (std::int32_t p = indptr[r]; p < indptr[r + 1]; ++p) {
                const std::int32_t c = indices[p];
                const double v = data[p];
                if (c == r) {
                    diag = v;
                } else {
                    acc -= v * x[c];
                }
            }
            if (diag != 0.0) {
                x[r] = (1.0 - w) * x[r] + w * acc / diag;
            }
        }
    }
    return 0;
}

// Bounded variant: same sweep with a per-variable box clamp applied inside
// the loop (so later rows see the clamped value).
int bounded_gauss_seidel(const double* data, const std::int32_t* indices,
                         const std::int32_t* indptr, std::int32_t nrows,
                         double* x, const double* b, const double* lb,
                         const double* ub, const std::int32_t* order,
                         std::int32_t norder, double w,
                         std::int32_t maxiter) {
    for (std::int32_t it = 0; it < maxiter; ++it) {
        for (std::int32_t k = 0; k < (order ? norder : nrows); ++k) {
            const std::int32_t r = order ? order[k] : k;
            double acc = b[r];
            double diag = 0.0;
            for (std::int32_t p = indptr[r]; p < indptr[r + 1]; ++p) {
                const std::int32_t c = indices[p];
                const double v = data[p];
                if (c == r) {
                    diag = v;
                } else {
                    acc -= v * x[c];
                }
            }
            if (diag != 0.0) {
                double xi = (1.0 - w) * x[r] + w * acc / diag;
                if (xi < lb[r]) xi = lb[r];
                if (xi > ub[r]) xi = ub[r];
                x[r] = xi;
            }
        }
    }
    return 0;
}

}  // extern "C"
