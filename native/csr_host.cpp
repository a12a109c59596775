// Host-side native runtime for sparse_matrix_mult_tpu.
//
// The reference implements its entire compute core in C++/OpenMP
// (/root/reference/src/*.cpp).  In this framework the compute core is
// XLA on the accelerator; the native layer instead owns the host-side
// runtime work that feeds the device: structure analysis (flop counting for
// partitioning and capacity planning), CSR stitching for the out-of-core
// row-chunked path, and format filtering.  All functions are C-ABI and
// loaded from Python via ctypes (see sparse_matrix_mult_tpu/utils/native.py)
// -- the same FFI style as the reference's loader
// (/root/reference/sparse_matrix_mult/matrix_ops.py:51-184) but with int64
// sizes throughout.
//
// Build: make -C native   (produces libsmmhost.so)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Total number of partial products of A @ B: sum over nnz(A) entries of
// nnz(B_row[col]).  This is both the ESC expand capacity and the flop count
// the scheduler balances -- the quantity the reference's `limits` row
// partitioner approximates with row counts
// (/root/reference/src/workdivision.cpp:16-89).
int64_t smm_expansion_size(
    const int32_t* a_indices,
    int64_t a_nnz,
    const int32_t* b_indptr) {
  int64_t total = 0;
#ifdef _OPENMP
#pragma omp parallel for reduction(+ : total) schedule(static)
#endif
  for (int64_t e = 0; e < a_nnz; ++e) {
    const int32_t j = a_indices[e];
    total += b_indptr[j + 1] - b_indptr[j];
  }
  return total;
}

// Per-row partial-product counts of A @ B (flops per output row).
void smm_row_flops(
    const int32_t* a_indptr,
    const int32_t* a_indices,
    int64_t rows,
    const int32_t* b_indptr,
    double* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t r = 0; r < rows; ++r) {
    double acc = 0;
    for (int32_t p = a_indptr[r]; p < a_indptr[r + 1]; ++p) {
      const int32_t j = a_indices[p];
      acc += b_indptr[j + 1] - b_indptr[j];
    }
    out[r] = acc;
  }
}

// Contiguous row ranges with near-equal total flops: boundary i is placed
// where cumulative flops crosses i/parts of the total.  Returns parts+1
// boundaries in `bounds`.
void smm_flop_balanced_partition(
    const double* flops,
    int64_t rows,
    int64_t parts,
    int64_t* bounds) {
  double total = 0;
  for (int64_t r = 0; r < rows; ++r) total += flops[r] > 0 ? flops[r] : 1e-9;
  bounds[0] = 0;
  double csum = 0;
  int64_t cut = 1;
  for (int64_t r = 0; r < rows && cut < parts; ++r) {
    csum += flops[r] > 0 ? flops[r] : 1e-9;
    while (cut < parts && csum >= total * cut / parts) {
      bounds[cut++] = r + 1;
    }
  }
  for (; cut < parts; ++cut) bounds[cut] = rows;
  bounds[parts] = rows;
}

// Stitch row-chunked CSR results into one CSR matrix.  This is the host
// analogue of the reference orchestrators' serial prefix-sum + copy stitch
// (/root/reference/src/sparse_sparse_sparse.cpp:269-291), parallelized over
// chunks.  Inputs are `n_chunks` CSR pieces covering consecutive row
// ranges; chunk c has chunk_rows[c] rows and its arrays are at offsets
// given by the caller-flattened layout:
//   indptr_cat:  concatenated per-chunk indptr arrays (each chunk_rows[c]+1)
//   indices_cat / values_cat: concatenated per-chunk entry arrays, where
//   chunk c's entries start at entry_offsets[c].
void smm_stitch_csr(
    int64_t n_chunks,
    const int64_t* chunk_rows,
    const int32_t* indptr_cat,
    const int64_t* indptr_offsets,
    const int32_t* indices_cat,
    const double* values_cat,
    const int64_t* entry_offsets,
    int32_t* out_indptr,
    int32_t* out_indices,
    double* out_values) {
  // Pass 1 (serial, cheap): global row-pointer prefix.
  int64_t row_base = 0;
  int64_t nnz_base = 0;
  out_indptr[0] = 0;
  for (int64_t c = 0; c < n_chunks; ++c) {
    const int32_t* ip = indptr_cat + indptr_offsets[c];
    const int64_t rows = chunk_rows[c];
    for (int64_t r = 0; r < rows; ++r) {
      out_indptr[row_base + r + 1] = static_cast<int32_t>(nnz_base + ip[r + 1]);
    }
    row_base += rows;
    nnz_base += ip[rows];
  }
  // Pass 2 (parallel): bulk copies of the entry arrays.
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
  for (int64_t c = 0; c < n_chunks; ++c) {
    const int32_t* ip = indptr_cat + indptr_offsets[c];
    const int64_t count = ip[chunk_rows[c]];
    const int64_t src = entry_offsets[c];
    // Destination offset = global indptr at this chunk's first row.
    int64_t first_row = 0;
    for (int64_t k = 0; k < c; ++k) first_row += chunk_rows[k];
    const int64_t dst = out_indptr[first_row];
    std::memcpy(out_indices + dst, indices_cat + src, count * sizeof(int32_t));
    std::memcpy(out_values + dst, values_cat + src, count * sizeof(double));
  }
}

// Filter a CSR matrix to its upper triangle in place of a scipy.sparse.triu
// round-trip (used by the chunked symmetric path).  Returns the new nnz.
int64_t smm_csr_triu(
    int64_t rows,
    const int32_t* indptr,
    const int32_t* indices,
    const double* values,
    int32_t* out_indptr,
    int32_t* out_indices,
    double* out_values) {
  int64_t w = 0;
  out_indptr[0] = 0;
  for (int64_t r = 0; r < rows; ++r) {
    for (int32_t p = indptr[r]; p < indptr[r + 1]; ++p) {
      if (indices[p] >= r) {
        out_indices[w] = indices[p];
        out_values[w] = values[p];
        ++w;
      }
    }
    out_indptr[r + 1] = static_cast<int32_t>(w);
  }
  return w;
}

// ---------------------------------------------------------------------------
// Host SpGEMM escape hatch: two-phase Gustavson (count -> exact-alloc -> fill).
//
// Tiny problems lose on the accelerator: a device dispatch costs more wall
// time than the whole multiply (the reference makes the same observation
// about its serial mode vs MKL, /root/reference/README.md:16-17).  The API
// layer routes problems below Config.host_compute_limit partial products
// here.  Unlike the reference's single-pass workers with grow-on-demand
// realloc (/root/reference/src/sparsework.cpp:81-103), this uses the same
// two-phase symbolic/numeric shape as the framework's device pipeline:
// phase 1 counts each output row's nnz, the caller prefix-sums and
// allocates exactly, phase 2 fills.  No realloc, no stitch, embarrassingly
// parallel over rows.
// ---------------------------------------------------------------------------


// Phase 1: out_counts[r] = nnz of row r of A@B (upper triangle only when
// `symmetric`).  Thread-local stamp array of size n_cols.
void smm_spgemm_count(
    int64_t m,
    int64_t n_cols,
    const int32_t* a_indptr,
    const int32_t* a_indices,
    const int32_t* b_indptr,
    const int32_t* b_indices,
    int32_t symmetric,
    int32_t use_parallel,
    int32_t* out_counts) {
#ifdef _OPENMP
#pragma omp parallel if (use_parallel)
#endif
  {
    std::vector<int32_t> stamp(n_cols, -1);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
    for (int64_t r = 0; r < m; ++r) {
      const int32_t rid = static_cast<int32_t>(r);
      int32_t count = 0;
      for (int32_t p = a_indptr[r]; p < a_indptr[r + 1]; ++p) {
        const int32_t j = a_indices[p];
        const int32_t qe = b_indptr[j + 1];
        if (symmetric) {
          for (int32_t q = b_indptr[j]; q < qe; ++q) {
            const int32_t k = b_indices[q];
            if (k >= rid && stamp[k] != rid) {
              stamp[k] = rid;
              ++count;
            }
          }
        } else {
          for (int32_t q = b_indptr[j]; q < qe; ++q) {
            const int32_t k = b_indices[q];
            count += (stamp[k] != rid);
            stamp[k] = rid;
          }
        }
      }
      out_counts[r] = count;
    }
  }
}

// Phase 2: fill indices/values; out_indptr is the caller's prefix sum of
// the phase-1 counts.  Column indices are emitted sorted (the packed-CSR
// contract of the device conversion kernels).
void smm_spgemm_fill(
    int64_t m,
    int64_t n_cols,
    const int32_t* a_indptr,
    const int32_t* a_indices,
    const double* a_values,
    const int32_t* b_indptr,
    const int32_t* b_indices,
    const double* b_values,
    int32_t symmetric,
    int32_t use_parallel,
    const int32_t* out_indptr,
    int32_t* out_indices,
    double* out_values) {
#ifdef _OPENMP
#pragma omp parallel if (use_parallel)
#endif
  {
    std::vector<int32_t> stamp(n_cols, -1);
    std::vector<double> acc(n_cols, 0.0);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
    for (int64_t r = 0; r < m; ++r) {
      const int32_t rid = static_cast<int32_t>(r);
      int32_t* cols = out_indices + out_indptr[r];
      int32_t count = 0;
      for (int32_t p = a_indptr[r]; p < a_indptr[r + 1]; ++p) {
        const int32_t j = a_indices[p];
        const double av = a_values[p];
        const int32_t qe = b_indptr[j + 1];
        if (symmetric) {
          for (int32_t q = b_indptr[j]; q < qe; ++q) {
            const int32_t k = b_indices[q];
            if (k < rid) continue;
            if (stamp[k] != rid) {
              stamp[k] = rid;
              acc[k] = av * b_values[q];
              cols[count++] = k;
            } else {
              acc[k] += av * b_values[q];
            }
          }
        } else {
          for (int32_t q = b_indptr[j]; q < qe; ++q) {
            const int32_t k = b_indices[q];
            if (stamp[k] != rid) {
              stamp[k] = rid;
              acc[k] = av * b_values[q];
              cols[count++] = k;
            } else {
              acc[k] += av * b_values[q];
            }
          }
        }
      }
      std::sort(cols, cols + count);
      double* vals = out_values + out_indptr[r];
      for (int32_t i = 0; i < count; ++i) vals[i] = acc[cols[i]];
    }
  }
}

// ---------------------------------------------------------------------------
// Dense (row-major) -> CSR pack.
//
// When the device product is dense-ish, downloading the dense f32 panel is
// fewer bytes than packed CSR (4 B/element vs 8-12 B/entry), so the API
// fetches the panel and packs on host.  scipy's own csr_matrix(dense) is
// serial; this two-phase OpenMP pack is memory-bandwidth bound.  Host
// analogue of the device extraction (ops/convert.py dense_to_csr);
// structurally the same count -> prefix -> fill pipeline.
// ---------------------------------------------------------------------------

// Phase 1: per-row nonzero counts of an (m, n) row-major panel.
void smm_dense_pack_count_f32(
    int64_t m, int64_t n, const float* dense, int32_t* counts) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t r = 0; r < m; ++r) {
    const float* row = dense + r * n;
    int32_t c = 0;
    for (int64_t j = 0; j < n; ++j) c += (row[j] != 0.0f);
    counts[r] = c;
  }
}

// Phase 2: fill int32 indices + f64 values (upcast at pack time -- the
// device computes f32 under the FAST policy; the API returns float64).
void smm_dense_pack_fill_f32(
    int64_t m, int64_t n, const float* dense, const int32_t* indptr,
    int32_t* indices, double* values) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t r = 0; r < m; ++r) {
    const float* row = dense + r * n;
    int64_t w = indptr[r];
    for (int64_t j = 0; j < n; ++j) {
      const float v = row[j];
      if (v != 0.0f) {
        indices[w] = static_cast<int32_t>(j);
        values[w] = static_cast<double>(v);
        ++w;
      }
    }
  }
}

void smm_dense_pack_count_f64(
    int64_t m, int64_t n, const double* dense, int32_t* counts) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t r = 0; r < m; ++r) {
    const double* row = dense + r * n;
    int32_t c = 0;
    for (int64_t j = 0; j < n; ++j) c += (row[j] != 0.0);
    counts[r] = c;
  }
}

void smm_dense_pack_fill_f64(
    int64_t m, int64_t n, const double* dense, const int32_t* indptr,
    int32_t* indices, double* values) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t r = 0; r < m; ++r) {
    const double* row = dense + r * n;
    int64_t w = indptr[r];
    for (int64_t j = 0; j < n; ++j) {
      const double v = row[j];
      if (v != 0.0) {
        indices[w] = static_cast<int32_t>(j);
        values[w] = v;
        ++w;
      }
    }
  }
}

int32_t smm_version() { return 2; }

int32_t smm_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
