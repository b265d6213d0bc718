// Native sparse-format preparation for primate_tpu_torch: the port's own copy
// of primate_tpu/native/sparse_prep.cpp, with the same C ABI and outputs.
//
// The host-side data loader of the port: CSR -> tiled BSR (dense (bm x bn)
// blocks, padded grid, one zero coverage block per empty block row) and CSR ->
// row-aligned DIA bands, in one pass each without scipy's intermediate copies.
// BSROperator.from_scipy drops the coverage blocks (the CUDA kernel writes an
// empty block row's zeros itself), so both engines store the same tiles.
//
// Protocol: two-call. First call sizing functions to get allocation counts,
// then fill preallocated buffers (caller = ctypes wrapper owning numpy
// arrays). All index arrays are int64 for >2B-nnz safety.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CSR -> BSR
// ---------------------------------------------------------------------------

// Count stored blocks per block-row (with one coverage block for empty rows).
// Returns total nnzb. brow_counts must have ceil(n_rows/bm) entries.
int64_t bsr_count(int64_t n_rows, int64_t n_cols, int64_t bm, int64_t bn,
                  const int64_t* indptr, const int32_t* indices,
                  int64_t* brow_counts) {
  const int64_t n_brow = (n_rows + bm - 1) / bm;
  const int64_t n_bcol = (n_cols + bn - 1) / bn;
  std::vector<int64_t> stamp(n_bcol, -1);
  int64_t total = 0;
  for (int64_t br = 0; br < n_brow; ++br) {
    const int64_t r0 = br * bm;
    const int64_t r1 = std::min(r0 + bm, n_rows);
    int64_t cnt = 0;
    for (int64_t r = r0; r < r1; ++r) {
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        const int64_t bc = indices[p] / bn;
        if (stamp[bc] != br) {
          stamp[bc] = br;
          ++cnt;
        }
      }
    }
    if (cnt == 0) cnt = 1;  // coverage block so every output tile is written
    brow_counts[br] = cnt;
    total += cnt;
  }
  return total;
}

// Fill blocks/colids/indptr_b. blocks must be zero-initialised with
// nnzb*bm*bn elements; colids nnzb; indptr_b n_brow+1 (computed here from
// brow_counts). Block-cols within each block-row come out sorted.
#define DEFINE_BSR_FILL(SUFFIX, T)                                            \
  void bsr_fill_##SUFFIX(int64_t n_rows, int64_t n_cols, int64_t bm,          \
                         int64_t bn, const int64_t* indptr,                   \
                         const int32_t* indices, const T* data,               \
                         const int64_t* brow_counts, T* blocks,               \
                         int32_t* colids, int64_t* indptr_b) {                \
    const int64_t n_brow = (n_rows + bm - 1) / bm;                            \
    const int64_t n_bcol = (n_cols + bn - 1) / bn;                            \
    indptr_b[0] = 0;                                                          \
    for (int64_t br = 0; br < n_brow; ++br)                                   \
      indptr_b[br + 1] = indptr_b[br] + brow_counts[br];                      \
    std::vector<int64_t> slot_of(n_bcol, -1);                                 \
    std::vector<int64_t> touched;                                             \
    for (int64_t br = 0; br < n_brow; ++br) {                                 \
      const int64_t r0 = br * bm;                                             \
      const int64_t r1 = std::min(r0 + bm, n_rows);                           \
      touched.clear();                                                        \
      for (int64_t r = r0; r < r1; ++r)                                       \
        for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {                 \
          const int64_t bc = indices[p] / bn;                                 \
          if (slot_of[bc] < 0) {                                              \
            slot_of[bc] = 0; /* mark */                                       \
            touched.push_back(bc);                                            \
          }                                                                   \
        }                                                                     \
      std::sort(touched.begin(), touched.end());                              \
      const int64_t base = indptr_b[br];                                      \
      if (touched.empty()) {                                                  \
        colids[base] = 0; /* zero coverage block */                           \
      } else {                                                                \
        for (size_t s = 0; s < touched.size(); ++s) {                         \
          slot_of[touched[s]] = base + static_cast<int64_t>(s);               \
          colids[base + s] = static_cast<int32_t>(touched[s]);                \
        }                                                                     \
        for (int64_t r = r0; r < r1; ++r)                                     \
          for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {               \
            const int64_t c = indices[p];                                     \
            const int64_t blk = slot_of[c / bn];                              \
            blocks[(blk * bm + (r - r0)) * bn + (c % bn)] += data[p];         \
          }                                                                   \
        for (int64_t bc : touched) slot_of[bc] = -1;                          \
      }                                                                       \
    }                                                                         \
  }

DEFINE_BSR_FILL(f32, float)
DEFINE_BSR_FILL(f64, double)

// ---------------------------------------------------------------------------
// CSR -> DIA (row-aligned bands: band[k][r] = A[r, r + off_k])
// ---------------------------------------------------------------------------

// Discover the distinct diagonals. offsets_out must hold n_rows+n_cols-1
// entries; returns the number of diagonals (sorted ascending).
int64_t dia_count(int64_t n_rows, int64_t n_cols, const int64_t* indptr,
                  const int32_t* indices, int64_t* offsets_out) {
  std::vector<char> seen(n_rows + n_cols - 1, 0);
  for (int64_t r = 0; r < n_rows; ++r)
    for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p)
      seen[indices[p] - r + (n_rows - 1)] = 1;
  int64_t n_d = 0;
  for (int64_t i = 0; i < static_cast<int64_t>(seen.size()); ++i)
    if (seen[i]) offsets_out[n_d++] = i - (n_rows - 1);
  return n_d;
}

// ---------------------------------------------------------------------------
// One-pass structural analysis (format selection, operators/prepare.py):
// distinct diagonals, bandwidth, occupied (bm x bn) tiles, max row nnz.
// The tile stamp works because CSR rows arrive in increasing block-row order.
// ---------------------------------------------------------------------------
void csr_analyze(int64_t n_rows, int64_t n_cols, const int64_t* indptr,
                 const int32_t* indices, int64_t bm, int64_t bn,
                 int64_t* out /* [n_diags, bandwidth, n_tiles, max_row_nnz] */) {
  std::vector<char> seen(n_rows + n_cols - 1, 0);
  const int64_t n_bcol = (n_cols + bn - 1) / bn;
  std::vector<int64_t> stamp(n_bcol, -1);
  int64_t n_d = 0, bw = 0, n_tiles = 0, max_row = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t br = r / bm;
    const int64_t cnt = indptr[r + 1] - indptr[r];
    if (cnt > max_row) max_row = cnt;
    for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
      const int64_t c = indices[p];
      const int64_t off = c - r;
      char& s = seen[off + (n_rows - 1)];
      if (!s) {
        s = 1;
        ++n_d;
      }
      const int64_t a = off < 0 ? -off : off;
      if (a > bw) bw = a;
      const int64_t bc = c / bn;
      if (stamp[bc] != br) {
        stamp[bc] = br;
        ++n_tiles;
      }
    }
  }
  out[0] = n_d;
  out[1] = bw;
  out[2] = n_tiles;
  out[3] = max_row;
}

#define DEFINE_DIA_FILL(SUFFIX, T)                                            \
  void dia_fill_##SUFFIX(int64_t n_rows, int64_t n_cols,                      \
                         const int64_t* indptr, const int32_t* indices,       \
                         const T* data, int64_t n_d, const int64_t* offsets,  \
                         T* bands /* zeroed (n_d, n_rows) */) {               \
    std::vector<int64_t> k_of(n_rows + n_cols - 1, -1);                       \
    for (int64_t k = 0; k < n_d; ++k)                                         \
      k_of[offsets[k] + (n_rows - 1)] = k;                                    \
    for (int64_t r = 0; r < n_rows; ++r)                                      \
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {                   \
        const int64_t k = k_of[indices[p] - r + (n_rows - 1)];                \
        bands[k * n_rows + r] += data[p];                                     \
      }                                                                       \
  }

DEFINE_DIA_FILL(f32, float)
DEFINE_DIA_FILL(f64, double)

}  // extern "C"
