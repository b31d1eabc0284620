// Native layout engine: single-pass grouped-ELL encoding.
//
// The device layouts (dual-ELL orientations, per-shard re-encodings —
// bsls_tpu/ops/layout.py) all reduce to one primitive: scatter N
// (group, index, value) nonzero triples into a padded (G, W) ELL pair,
// preserving input order within each group.  numpy does this with an
// O(N log N) argsort + searchsorted + two fancy scatters; at the large
// config's 48M nonzeros that is tens of seconds of prepare/ingestion
// latency.  Here it is two O(N) passes (histogram, then fill with
// per-group cursors) — the analog of the reference's C
// extensions, applied where THIS framework's native hot spot actually is:
// host-side instance ingestion, not device compute (XLA/Pallas own that).
//
// Built as a plain shared library (no pybind11 on this image); loaded via
// ctypes with a numpy fallback (bsls_tpu/native/__init__.py).

#include <cstdint>

extern "C" {

// counts[g] = number of i with keys[i] == g.  counts must be zeroed by the
// caller.  Returns the max count (the ELL width W).
int64_t bsls_group_counts(const int64_t* keys, int64_t n, int64_t num_groups,
                          int64_t* counts) {
  for (int64_t i = 0; i < n; ++i) counts[keys[i]]++;
  int64_t w = 0;
  for (int64_t g = 0; g < num_groups; ++g)
    if (counts[g] > w) w = counts[g];
  return w;
}

// Fill (G, W) ELL arrays from triples, stable within each group.
// cursors must be zeroed by the caller; out_cols/out_vals zero-initialised
// (padding slots keep index 0 / value 0, matching the numpy builders).
void bsls_ell_fill(const int64_t* keys, const int32_t* idx, const float* val,
                   int64_t n, int64_t width, int32_t* cursors,
                   int32_t* out_cols, float* out_vals) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t g = keys[i];
    const int64_t p = cursors[g]++;
    out_cols[g * width + p] = idx[i];
    out_vals[g * width + p] = val[i];
  }
}

// float64 variant (dtype=float64 prepare path keeps full precision).
void bsls_ell_fill_f64(const int64_t* keys, const int32_t* idx,
                       const double* val, int64_t n, int64_t width,
                       int32_t* cursors, int32_t* out_cols, double* out_vals) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t g = keys[i];
    const int64_t p = cursors[g]++;
    out_cols[g * width + p] = idx[i];
    out_vals[g * width + p] = val[i];
  }
}

// CSC -> column-ELL fill: one pass over the columns, no key
// materialisation (the 48M-nnz ingestion path would otherwise allocate
// and scan a 48M int64 key vector just to rediscover the group runs the
// CSC indptr already encodes).  out_rows/out_vals zero-initialised by the
// caller (padding slots keep row 0 / value 0).
void bsls_csc_fill(const int64_t* indptr, const int32_t* indices,
                   const float* val, int64_t ncols, int64_t width,
                   int32_t* out_rows, float* out_vals) {
  for (int64_t j = 0; j < ncols; ++j) {
    const int64_t lo = indptr[j], hi = indptr[j + 1];
    int32_t* orow = out_rows + j * width;
    float* oval = out_vals + j * width;
    for (int64_t t = lo; t < hi; ++t) {
      orow[t - lo] = indices[t];
      oval[t - lo] = val[t];
    }
  }
}

void bsls_csc_fill_f64(const int64_t* indptr, const int32_t* indices,
                       const double* val, int64_t ncols, int64_t width,
                       int32_t* out_rows, double* out_vals) {
  for (int64_t j = 0; j < ncols; ++j) {
    const int64_t lo = indptr[j], hi = indptr[j + 1];
    int32_t* orow = out_rows + j * width;
    double* oval = out_vals + j * width;
    for (int64_t t = lo; t < hi; ++t) {
      orow[t - lo] = indices[t];
      oval[t - lo] = val[t];
    }
  }
}

// Y (S, m) = X (S, n) @ A^T for A in CSR (m x n, float64) — i.e. one CSR
// matvec per RHS row.  The host-side SpMM that dominates certified refine
// (refine_tol's f64 Jacobi-PCG does ~hundreds of these per polish;
// scipy's path is single-threaded).  Parallel over (rhs, row-block)
// pairs so both the many-RHS (S=32) and single-RHS shapes use every
// core; each task streams one dense x vector (n doubles, L2-resident)
// against a CSR row range — the cache-friendly orientation (the
// row-parallel S-wide variant was measured 10x SLOWER than scipy: the
// (n, S) operand is random-accessed and falls out of L3).
void bsls_csr_matmat_f64(const int64_t* indptr, const int32_t* indices,
                         const double* data, int64_t m, int64_t n,
                         int64_t S, const double* X, double* Y) {
  const int64_t RB = 8192;  // rows per task
  const int64_t nrb = (m + RB - 1) / RB;
#pragma omp parallel for collapse(2) schedule(dynamic)
  for (int64_t s = 0; s < S; ++s) {
    for (int64_t rb = 0; rb < nrb; ++rb) {
      const double* __restrict__ x = X + s * n;
      double* __restrict__ y = Y + s * m;
      const int64_t hi = (rb + 1) * RB < m ? (rb + 1) * RB : m;
      for (int64_t i = rb * RB; i < hi; ++i) {
        double acc = 0.0;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
          acc += data[p] * x[indices[p]];
        y[i] = acc;
      }
    }
  }
}

}  // extern "C"
