// Native host-side CSR utilities.
//
// This module plays the role the reference's C shim plays for MKL
// (reference: csr/kernels/mkl/mkl_ops.c): the native component of the
// framework.  Device compute belongs to XLA; what remains
// performance-sensitive on the host is *construction* — COO ingestion,
// compaction, row sorting — which runs on numpy buffers before data ships
// to the device.  These are exact ports of the reference algorithms
// (counting sort two-pass COO->CSR, reference: csr/structure.py:12-58;
// count-then-scatter transpose, reference: csr/structure.py:172-237;
// in-place zero compaction, reference: csr/_struct.py:61-79), written as
// cache-friendly single-threaded C++ with optional OpenMP-free threading
// via caller-side row slicing.
//
// Exported C ABI (bound via ctypes, no pybind11 dependency):
//   csrt_from_coo_f{32,64}   COO triple -> CSR triple
//   csrt_from_coo_structure  structure-only variant
//   csrt_transpose_f{32,64}  CSR -> CSC-as-CSR
//   csrt_sort_rows_f{32,64}  in-place per-row column sort
//   csrt_filter_zeros_f{32,64} in-place compaction, returns new nnz
//   csrt_row_ids             rowptr expansion to COO row vector
//
// Build: csr_tpu/native/build.py (g++ -O3 -shared).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

// ---------------------------------------------------------------------------
// COO -> CSR: two-pass counting sort, stable within rows
// (reference: csr/structure.py:12-58)

static void count_rows(int64_t nnz, const int32_t* rows, int64_t nrows,
                       int64_t* rowptrs) {
  std::memset(rowptrs, 0, sizeof(int64_t) * (nrows + 1));
  for (int64_t i = 0; i < nnz; ++i) rowptrs[rows[i] + 1]++;
  for (int64_t r = 0; r < nrows; ++r) rowptrs[r + 1] += rowptrs[r];
}

template <typename T>
static void from_coo_impl(int64_t nnz, const int32_t* rows,
                          const int32_t* cols, const T* vals, int64_t nrows,
                          int64_t* rowptrs, int32_t* out_cols, T* out_vals) {
  count_rows(nnz, rows, nrows, rowptrs);
  std::vector<int64_t> rpos(rowptrs, rowptrs + nrows);
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t p = rpos[rows[i]]++;
    out_cols[p] = cols[i];
    if (vals) out_vals[p] = vals[i];
  }
}

extern "C" void csrt_from_coo_f64(int64_t nnz, const int32_t* rows, const int32_t* cols,
                       const double* vals, int64_t nrows, int64_t* rowptrs,
                       int32_t* out_cols, double* out_vals) {
  from_coo_impl(nnz, rows, cols, vals, nrows, rowptrs, out_cols, out_vals);
}

extern "C" void csrt_from_coo_f32(int64_t nnz, const int32_t* rows, const int32_t* cols,
                       const float* vals, int64_t nrows, int64_t* rowptrs,
                       int32_t* out_cols, float* out_vals) {
  from_coo_impl(nnz, rows, cols, vals, nrows, rowptrs, out_cols, out_vals);
}

extern "C" void csrt_from_coo_structure(int64_t nnz, const int32_t* rows,
                             const int32_t* cols, int64_t nrows,
                             int64_t* rowptrs, int32_t* out_cols) {
  from_coo_impl<double>(nnz, rows, cols, nullptr, nrows, rowptrs, out_cols,
                        nullptr);
}

// ---------------------------------------------------------------------------
// transpose: count-then-scatter (reference: csr/structure.py:172-237)

template <typename T>
static void transpose_impl(int64_t nrows, int64_t ncols,
                           const int64_t* rowptrs, const int32_t* cols,
                           const T* vals, int64_t* t_rowptrs, int32_t* t_cols,
                           T* t_vals) {
  int64_t nnz = rowptrs[nrows];
  std::memset(t_rowptrs, 0, sizeof(int64_t) * (ncols + 1));
  for (int64_t i = 0; i < nnz; ++i) t_rowptrs[cols[i] + 1]++;
  for (int64_t c = 0; c < ncols; ++c) t_rowptrs[c + 1] += t_rowptrs[c];
  std::vector<int64_t> pos(t_rowptrs, t_rowptrs + ncols);
  for (int64_t r = 0; r < nrows; ++r) {
    for (int64_t i = rowptrs[r]; i < rowptrs[r + 1]; ++i) {
      int64_t p = pos[cols[i]]++;
      t_cols[p] = static_cast<int32_t>(r);
      if (vals) t_vals[p] = vals[i];
    }
  }
}

extern "C" void csrt_transpose_f64(int64_t nrows, int64_t ncols, const int64_t* rowptrs,
                        const int32_t* cols, const double* vals,
                        int64_t* t_rowptrs, int32_t* t_cols, double* t_vals) {
  transpose_impl(nrows, ncols, rowptrs, cols, vals, t_rowptrs, t_cols, t_vals);
}

extern "C" void csrt_transpose_f32(int64_t nrows, int64_t ncols, const int64_t* rowptrs,
                        const int32_t* cols, const float* vals,
                        int64_t* t_rowptrs, int32_t* t_cols, float* t_vals) {
  transpose_impl(nrows, ncols, rowptrs, cols, vals, t_rowptrs, t_cols, t_vals);
}

extern "C" void csrt_transpose_structure(int64_t nrows, int64_t ncols,
                              const int64_t* rowptrs, const int32_t* cols,
                              int64_t* t_rowptrs, int32_t* t_cols) {
  transpose_impl<double>(nrows, ncols, rowptrs, cols, nullptr, t_rowptrs,
                         t_cols, nullptr);
}

// ---------------------------------------------------------------------------
// in-place per-row column sort (reference: csr/structure.py:156-169 uses
// bubble sort; here an index sort per row)

template <typename T>
static void sort_rows_impl(int64_t nrows, const int64_t* rowptrs,
                           int32_t* cols, T* vals) {
  std::vector<int32_t> idx;
  std::vector<int32_t> ctmp;
  std::vector<T> vtmp;
  for (int64_t r = 0; r < nrows; ++r) {
    int64_t s = rowptrs[r], e = rowptrs[r + 1];
    int64_t n = e - s;
    if (n <= 1) continue;
    idx.resize(n);
    std::iota(idx.begin(), idx.end(), 0);
    std::stable_sort(idx.begin(), idx.end(), [&](int32_t a, int32_t b) {
      return cols[s + a] < cols[s + b];
    });
    ctmp.assign(cols + s, cols + e);
    for (int64_t i = 0; i < n; ++i) cols[s + i] = ctmp[idx[i]];
    if (vals) {
      vtmp.assign(vals + s, vals + e);
      for (int64_t i = 0; i < n; ++i) vals[s + i] = vtmp[idx[i]];
    }
  }
}

extern "C" void csrt_sort_rows_f64(int64_t nrows, const int64_t* rowptrs, int32_t* cols,
                        double* vals) {
  sort_rows_impl(nrows, rowptrs, cols, vals);
}

extern "C" void csrt_sort_rows_f32(int64_t nrows, const int64_t* rowptrs, int32_t* cols,
                        float* vals) {
  sort_rows_impl(nrows, rowptrs, cols, vals);
}

extern "C" void csrt_sort_rows_structure(int64_t nrows, const int64_t* rowptrs,
                              int32_t* cols) {
  sort_rows_impl<double>(nrows, rowptrs, cols, nullptr);
}

// ---------------------------------------------------------------------------
// in-place zero compaction (reference: csr/_struct.py:61-79)

template <typename T>
static int64_t filter_zeros_impl(int64_t nrows, int64_t* rowptrs,
                                 int32_t* cols, T* vals) {
  int64_t nnz = 0;
  for (int64_t r = 0; r < nrows; ++r) {
    int64_t s = rowptrs[r], e = rowptrs[r + 1];
    rowptrs[r] = nnz;
    for (int64_t i = s; i < e; ++i) {
      if (vals[i] != T(0)) {
        cols[nnz] = cols[i];
        vals[nnz] = vals[i];
        nnz++;
      }
    }
  }
  rowptrs[nrows] = nnz;
  return nnz;
}

extern "C" int64_t csrt_filter_zeros_f64(int64_t nrows, int64_t* rowptrs, int32_t* cols,
                              double* vals) {
  return filter_zeros_impl(nrows, rowptrs, cols, vals);
}

extern "C" int64_t csrt_filter_zeros_f32(int64_t nrows, int64_t* rowptrs, int32_t* cols,
                              float* vals) {
  return filter_zeros_impl(nrows, rowptrs, cols, vals);
}

// ---------------------------------------------------------------------------
// rowptr expansion (reference: csr/_rows.py:122-128)

extern "C" void csrt_row_ids(int64_t nrows, const int64_t* rowptrs, int32_t* out) {
  for (int64_t r = 0; r < nrows; ++r) {
    for (int64_t i = rowptrs[r]; i < rowptrs[r + 1]; ++i) {
      out[i] = static_cast<int32_t>(r);
    }
  }
}
