// Native Block-ELL assembler: CSR -> (data, cols) block layout.
//
// Host-side runtime tier of the operator layer: converting a 10M-DoF CSR
// operator to the Block-ELL layout is pure pointer-chasing that the numpy
// path does with O(nnz) fancy indexing and multiple temporary arrays; this
// C++ path is a single streaming pass per stage. Loaded via ctypes
// (lightkrylov_tpu_torch/native/__init__.py) with a numpy fallback when the
// shared object is unavailable. The port's own copy of the JAX package's
// lightkrylov_tpu/native/bell_assembler.cpp; only this comment differs.
//
// Layout contract (must match lightkrylov_tpu_torch/ops/spmv.py):
//   data: (nbr, K, bm, bn) row-major; cols: (nbr, K) int32, zero-padded;
//   padding slots point at block-column 0 with all-zero values.

#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

// Pass 1: K = max number of distinct block-columns in any block-row.
int32_t bell_compute_k(const int64_t* indptr, const int32_t* indices,
                       int64_t m, int32_t bm, int32_t bn) {
    const int64_t nbr = (m + bm - 1) / bm;
    int32_t K = 1;
    std::vector<int32_t> bcols;
    for (int64_t br = 0; br < nbr; ++br) {
        bcols.clear();
        const int64_t r0 = br * bm;
        const int64_t r1 = std::min<int64_t>(r0 + bm, m);
        for (int64_t r = r0; r < r1; ++r) {
            for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
                bcols.push_back(indices[p] / bn);
            }
        }
        std::sort(bcols.begin(), bcols.end());
        const int32_t uniq =
            static_cast<int32_t>(std::unique(bcols.begin(), bcols.end()) -
                                 bcols.begin());
        K = std::max(K, uniq);
    }
    return K;
}

// Pass 2: fill caller-allocated data (nbr*K*bm*bn) and cols (nbr*K).
// dtype_code: 0 = float32, 1 = float64 (out buffer matches).
void bell_fill_f32(const int64_t* indptr, const int32_t* indices,
                   const double* values, int64_t m, int32_t bm, int32_t bn,
                   int32_t K, float* out_data, int32_t* out_cols) {
    const int64_t nbr = (m + bm - 1) / bm;
    const int64_t block_elems = static_cast<int64_t>(bm) * bn;
    std::vector<int32_t> bcols;
    for (int64_t br = 0; br < nbr; ++br) {
        bcols.clear();
        const int64_t r0 = br * bm;
        const int64_t r1 = std::min<int64_t>(r0 + bm, m);
        for (int64_t r = r0; r < r1; ++r)
            for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p)
                bcols.push_back(indices[p] / bn);
        std::sort(bcols.begin(), bcols.end());
        bcols.erase(std::unique(bcols.begin(), bcols.end()), bcols.end());
        int32_t* cols_row = out_cols + br * K;
        for (int32_t s = 0; s < K; ++s)
            cols_row[s] = s < static_cast<int32_t>(bcols.size()) ? bcols[s] : 0;
        float* data_row = out_data + br * K * block_elems;
        for (int64_t r = r0; r < r1; ++r) {
            const int64_t lr = r - r0;
            for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
                const int32_t bc = indices[p] / bn;
                const int32_t lc = indices[p] % bn;
                const int32_t slot = static_cast<int32_t>(
                    std::lower_bound(bcols.begin(), bcols.end(), bc) -
                    bcols.begin());
                data_row[slot * block_elems + lr * bn + lc] +=
                    static_cast<float>(values[p]);
            }
        }
    }
}

void bell_fill_f64(const int64_t* indptr, const int32_t* indices,
                   const double* values, int64_t m, int32_t bm, int32_t bn,
                   int32_t K, double* out_data, int32_t* out_cols) {
    const int64_t nbr = (m + bm - 1) / bm;
    const int64_t block_elems = static_cast<int64_t>(bm) * bn;
    std::vector<int32_t> bcols;
    for (int64_t br = 0; br < nbr; ++br) {
        bcols.clear();
        const int64_t r0 = br * bm;
        const int64_t r1 = std::min<int64_t>(r0 + bm, m);
        for (int64_t r = r0; r < r1; ++r)
            for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p)
                bcols.push_back(indices[p] / bn);
        std::sort(bcols.begin(), bcols.end());
        bcols.erase(std::unique(bcols.begin(), bcols.end()), bcols.end());
        int32_t* cols_row = out_cols + br * K;
        for (int32_t s = 0; s < K; ++s)
            cols_row[s] = s < static_cast<int32_t>(bcols.size()) ? bcols[s] : 0;
        double* data_row = out_data + br * K * block_elems;
        for (int64_t r = r0; r < r1; ++r) {
            const int64_t lr = r - r0;
            for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
                const int32_t bc = indices[p] / bn;
                const int32_t lc = indices[p] % bn;
                const int32_t slot = static_cast<int32_t>(
                    std::lower_bound(bcols.begin(), bcols.end(), bc) -
                    bcols.begin());
                data_row[slot * block_elems + lr * bn + lc] += values[p];
            }
        }
    }
}

}  // extern "C"
