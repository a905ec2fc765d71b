// Interval constraint-propagation kernel (bound tightening) for integer
// feasibility search.  Native runtime component of pysparselp_tpu: worklist
// propagation is irreducibly sequential-sparse, so it runs on the host CPU
// (the TPU analogue of the reference's Cython extension,
// pysparselp/propagateConstraints.pyx:46-167).
//
// Built as a plain C-ABI shared library (no pybind11 in this image); loaded
// from Python via ctypes (see propagation.py).
//
// Semantics: given variable interval bounds [x_l, x_u], constraint rows
// b_lower <= A x <= b_upper (CSR + CSC index views of A), and a worklist of
// recently-changed variables, repeatedly:
//   * collect the constraints touching any changed variable,
//   * compute each constraint's activity interval [l, u] from the bounds,
//   * declare infeasibility if u < b_lower or l > b_upper,
//   * tighten each participating variable's integer bounds (floor/ceil with
//     tol = 1e-5), logging every change for backtracking.

#include <cmath>
#include <cstdint>
#include <set>
#include <vector>

extern "C" {

// return: 1 = consistent, 0 = infeasible (violated_row set),
//        -1 = backtrack log overflow (caller must retry with larger buffers)
int propagate_constraints(
    const int32_t* changed, int n_changed,
    double* x_l, double* x_u,
    const int32_t* csr_indices, const int32_t* csr_indptr,
    const double* csr_data,
    const int32_t* csc_indices, const int32_t* csc_indptr,
    const double* b_lower, const double* b_upper,
    int n_rows, int n_cols,
    int nb_iter,
    int32_t* back_type, int32_t* back_idx, double* back_val,
    int back_cap, int* back_len,
    int32_t* violated_row) {
  const double tol = 1e-5;
  std::vector<int> worklist(changed, changed + n_changed);
  std::set<int> to_check;
  int nlog = *back_len;
  *violated_row = -1;

  for (int iter = 0; iter < nb_iter; ++iter) {
    if (worklist.empty()) break;

    to_check.clear();
    for (int i : worklist) {
      for (int32_t k = csc_indptr[i]; k < csc_indptr[i + 1]; ++k) {
        to_check.insert(csc_indices[k]);
      }
    }
    worklist.clear();

    for (int j : to_check) {
      const int32_t p0 = csr_indptr[j], p1 = csr_indptr[j + 1];
      double lo = 0.0, hi = 0.0;
      for (int32_t k = p0; k < p1; ++k) {
        const int i = csr_indices[k];
        const double v = csr_data[k];
        if (v > 0) {
          hi += v * x_u[i];
          lo += v * x_l[i];
        } else {
          lo += v * x_u[i];
          hi += v * x_l[i];
        }
      }
      if (hi < b_lower[j] || lo > b_upper[j]) {
        *back_len = nlog;
        *violated_row = j;
        return 0;
      }
      for (int32_t k = p0; k < p1; ++k) {
        const int i = csr_indices[k];
        const double v = csr_data[k];
        double n_u, n_l;
        if (v > 0) {
          n_u = std::floor(tol + (b_upper[j] - lo + v * x_l[i]) / v);
          n_l = std::ceil(-tol + (b_lower[j] - hi + v * x_u[i]) / v);
        } else {
          n_u = std::floor(tol + (b_lower[j] - hi + v * x_l[i]) / v);
          n_l = std::ceil(-tol + (b_upper[j] - lo + v * x_u[i]) / v);
        }
        bool has_changed = false;
        if (n_u < x_u[i]) {
          if (nlog >= back_cap) { *back_len = nlog; return -1; }
          back_type[nlog] = 1;
          back_idx[nlog] = i;
          back_val[nlog] = x_u[i];
          ++nlog;
          x_u[i] = n_u;
          has_changed = true;
        }
        if (n_l > x_l[i]) {
          if (nlog >= back_cap) { *back_len = nlog; return -1; }
          back_type[nlog] = 0;
          back_idx[nlog] = i;
          back_val[nlog] = x_l[i];
          ++nlog;
          x_l[i] = n_l;
          has_changed = true;
        }
        if (has_changed) worklist.push_back(i);
      }
    }
  }
  *back_len = nlog;
  return 1;
}

}  // extern "C"
