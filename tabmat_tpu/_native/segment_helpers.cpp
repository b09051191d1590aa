// Native host helpers for tabmat-tpu (C ABI, loaded via ctypes).
//
// The device kernels need a one-time host-side preprocessing step per matrix:
// the SegmentPlan (stable argsort of an int code vector + segment bounds).
// numpy's comparison argsort is O(n log n); categorical codes are bounded
// ints, so a counting sort gets the plan in O(n + K) with OpenMP-friendly
// memory streams.  This mirrors the role (not the design) of the
// reference's Cython construction helpers (tabmat/ext/split.pyx:157-217).
//
// Build: compiled on first use by the loader in __init__.py.

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Stable counting argsort of int32 keys in [-n_neg_allowed, num_segments).
// Negative keys (missing/dropped codes) are grouped in front so they fall
// outside every [bounds[s], bounds[s+1]) window, matching numpy argsort of
// signed ints.  Outputs: perm (n int32), bounds (num_segments+1 int32).
// Returns 0 on success, -1 if a key >= num_segments is found.
int counting_argsort_i32(const int32_t* keys, int64_t n, int32_t num_segments,
                         int32_t* perm, int32_t* bounds) {
  // counts[0] collects all negative keys; counts[k+1] collects key k
  std::vector<int64_t> counts(static_cast<size_t>(num_segments) + 2, 0);
  for (int64_t i = 0; i < n; ++i) {
    int32_t k = keys[i];
    if (k >= num_segments) return -1;
    counts[k < 0 ? 0 : static_cast<size_t>(k) + 1]++;
  }
  // exclusive prefix sums -> start offsets
  std::vector<int64_t> offsets(counts.size() + 1, 0);
  for (size_t s = 0; s < counts.size(); ++s) offsets[s + 1] = offsets[s] + counts[s];
  for (int32_t s = 0; s <= num_segments; ++s) {
    bounds[s] = static_cast<int32_t>(offsets[static_cast<size_t>(s) + 1]);
  }
  // stable scatter pass
  std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
  for (int64_t i = 0; i < n; ++i) {
    int32_t k = keys[i];
    size_t bucket = k < 0 ? 0 : static_cast<size_t>(k) + 1;
    perm[cursor[bucket]++] = static_cast<int32_t>(i);
  }
  return 0;
}

// 1 if the int64 array is non-decreasing, else 0.
int is_sorted_i64(const int64_t* arr, int64_t n) {
  for (int64_t i = 1; i < n; ++i) {
    if (arr[i] < arr[i - 1]) return 0;
  }
  return 1;
}

// Row-wise nonzero counting for a boolean/filter mask has no native need;
// density scans stay in numpy.  Combined-key builder for categorical
// cross-sandwiches: key = (a>=0 && b>=0) ? a*K2+b : -1.
void combine_codes_i32(const int32_t* a, const int32_t* b, int64_t n,
                       int32_t k2, int32_t* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i) {
    int32_t ai = a[i], bi = b[i];
    out[i] = (ai >= 0 && bi >= 0) ? ai * k2 + bi : -1;
  }
}

// Enumerate all within-row nonzero pairs of a CSR matrix.
// For each row r and each ordered pair (a, b) of its nonzero positions,
// emits (ia, ib, row).  Pair count must be precomputed by the caller as
// sum(nnz_r^2).  This is the construction-time half of the pair-expansion
// sparse sandwich: at op time the device segment-sums
// data[ia]*data[ib]*d[row] by the (col[ia], col[ib]) key.
void expand_pairs_csr_i64(const int64_t* indptr, int64_t n_rows,
                          int32_t* ia, int32_t* ib, int32_t* row) {
  int64_t out = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t start = indptr[r], end = indptr[r + 1];
    for (int64_t a = start; a < end; ++a) {
      for (int64_t b = start; b < end; ++b) {
        ia[out] = static_cast<int32_t>(a);
        ib[out] = static_cast<int32_t>(b);
        row[out] = static_cast<int32_t>(r);
        ++out;
      }
    }
  }
}


// OpenMP CSR walk: out[r] (+)= sum_j data[p] * v[col[p]] over row r.
// Host fast path for numpy-caller sparse matvec below the device
// crossover (the reference's per-call C walk: tabmat/ext/sparse.pyx:
// 129-156).  Rows are independent -> parallel for, no contention.
// accumulate=0 overwrites out, =1 adds into it (the out= contract).
void csr_matvec_f64(const double* data, const int32_t* indices,
                    const int64_t* indptr, int64_t n_rows, const double* v,
                    double* out, int32_t accumulate) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t r = 0; r < n_rows; ++r) {
    double acc = 0.0;
    for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
      acc += data[p] * v[indices[p]];
    }
    out[r] = accumulate ? out[r] + acc : acc;
  }
}

// OpenMP CSC walk: out[c] (+)= sum over column c of data[p] * r[row[p]].
// Host fast path for numpy-caller sparse transpose-matvec (columns are
// independent -> parallel for; counterpart of tabmat/ext/sparse.pyx:
// 159-199 which parallelizes the same loop).
void csc_tmv_f64(const double* data, const int32_t* indices,
                 const int64_t* indptr, int64_t n_cols, const double* r,
                 double* out, int32_t accumulate) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t c = 0; c < n_cols; ++c) {
    double acc = 0.0;
    for (int64_t p = indptr[c]; p < indptr[c + 1]; ++p) {
      acc += data[p] * r[indices[p]];
    }
    out[c] = accumulate ? out[c] + acc : acc;
  }
}

}  // extern "C"
