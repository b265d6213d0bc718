// Block-sparse-row (BSR) SpMM for Hopper (sm_90a), float32 and float64.
//
// Replaces the Pallas TPU kernel of primate_tpu/ops/spmm_pallas.py:
//   bsr_spmm  <- bsr_matmat_pallas (_bsr_kernel): out[r*bm:(r+1)*bm, :] = sum over the
//                stored tiles of block row r of tile @ V[col*bn:(col+1)*bn, :]
//
// Layout: tiles (nnzb, bm, bn) row-sorted, indptr (n_brow + 1), indices (nnzb) the
// block-column ids, all as scipy's BSR stores them; V (m, k) and out (n_out, k)
// row-major (node-major probe blocks). Rows of the tile grid past m (the zero
// padding of a logical n that bm/bn does not divide) are skipped by a bounds
// check, so V needs no padded copy; output rows past n_out are not written.
//
// Bound: HBM bytes. Each stored tile reads its bn rows of V, bn*k elements, for
// 2*bm*bn*k flops: 2*bm flops per V element (16 at 8x8), below the card's
// balance point, and V's rows are gathered in random order, so the V traffic
// (nnzb*bn*k elements) dominates the tile traffic (nnzb*bm*bn). The design keeps
// that gather coalesced and every output written once:
//   - one block per block row r walks indptr[r]:indptr[r+1] (the TPU grid's
//     sequential revisits of one output tile become a loop inside the block);
//   - its threads run along the contiguous k axis (up to 1024 columns per
//     block; blockIdx.y takes further column chunks), so each V row segment
//     is one coalesced load;
//   - the block stages a batch of tiles in shared memory (bm rows in passes of
//     kRB, bn columns in slices of kJB), read back as broadcasts;
//   - each thread keeps its kRB output rows in registers and writes them once:
//     no atomics, so the result is deterministic, and an empty block row writes
//     zeros. Register and shared-memory use do not depend on k.
// FP32/FP64 FMAs on the CUDA cores: a TF32 tensor-core product would lose the
// float32 accuracy the JAX package pins with Precision.HIGHEST.
//
// Plain C interface: every entry point returns the cudaError_t of its launch
// (cudaGetLastError()), and the caller raises on anything but cudaSuccess. The
// kernels launch on the caller's stream, allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRB = 8;               // tile rows per pass: output rows held in registers per thread
constexpr int kJB = 256;             // tile columns per staged slice
constexpr int kStage = kRB * kJB;    // staged tile elements
constexpr int kMaxStaged = 256;      // tiles per staged batch
constexpr int kMaxThreads = 1024;    // probe columns per block

// BM, BN > 0 fix the tile shape at compile time (the common 8x8); 0 reads bm/bn.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kMaxThreads) bsr_spmm_kernel(const T* __restrict__ blocks,
                                                               const int64_t* __restrict__ indptr,
                                                               const int64_t* __restrict__ indices,
                                                               const T* __restrict__ V, T* __restrict__ out,
                                                               int bm_rt, int bn_rt, int64_t m, int64_t k,
                                                               int64_t n_out) {
    const int bm = BM ? BM : bm_rt;
    const int bn = BN ? BN : bn_rt;
    __shared__ T stage[kStage];
    __shared__ int64_t cols[kMaxStaged];
    const int64_t r = blockIdx.x;
    const int64_t c = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
    const bool active = c < k;
    const int64_t t0 = indptr[r], t1 = indptr[r + 1];
    for (int i0 = 0; i0 < bm; i0 += kRB) {
        const int rb = bm - i0 < kRB ? bm - i0 : kRB;
        T acc[kRB];
#pragma unroll
        for (int i = 0; i < kRB; ++i) acc[i] = T(0);
        for (int j0 = 0; j0 < bn; j0 += kJB) {
            const int jb = bn - j0 < kJB ? bn - j0 : kJB;
            const int slice = rb * jb;  // staged elements per tile
            const int per_stage = kStage / slice < kMaxStaged ? kStage / slice : kMaxStaged;
            for (int64_t tb = t0; tb < t1; tb += per_stage) {
                const int nt = t1 - tb < per_stage ? static_cast<int>(t1 - tb) : per_stage;
                __syncthreads();  // the previous batch has been read
                for (int e = threadIdx.x; e < nt * slice; e += blockDim.x) {
                    const int t = e / slice, w = e - t * slice, i = w / jb, j = w - i * jb;
                    stage[e] = blocks[((tb + t) * bm + i0 + i) * bn + j0 + j];
                }
                for (int t = threadIdx.x; t < nt; t += blockDim.x) cols[t] = indices[tb + t];
                __syncthreads();
                if (!active) continue;
                for (int t = 0; t < nt; ++t) {
                    const int64_t row0 = cols[t] * bn + j0;  // first V row of this slice
                    const T* s = stage + t * slice;
                    for (int j = 0; j < jb; ++j) {
                        if (row0 + j >= m) break;  // zero padding of the tile grid
                        const T v = V[(row0 + j) * k + c];
#pragma unroll
                        for (int i = 0; i < kRB; ++i) {
                            if (i < rb) acc[i] += s[i * jb + j] * v;
                        }
                    }
                }
            }
        }
        if (active) {
#pragma unroll
            for (int i = 0; i < kRB; ++i) {
                const int64_t row = r * bm + i0 + i;
                if (i < rb && row < n_out) out[row * k + c] = acc[i];
            }
        }
    }
}

template <typename T>
cudaError_t launch_bsr(const T* blocks, const int64_t* indptr, const int64_t* indices, const T* V, T* out,
                       int64_t n_brow, int bm, int bn, int64_t m, int64_t k, int64_t n_out, cudaStream_t stream) {
    if (n_brow == 0 || k == 0 || n_out == 0) return cudaSuccess;
    if (bm <= 0 || bn <= 0) return cudaErrorInvalidValue;
    const int threads = static_cast<int>(k < kMaxThreads ? (k + 31) / 32 * 32 : kMaxThreads);
    const int64_t chunks = (k + threads - 1) / threads;
    if (n_brow > 0x7fffffffLL || chunks > 65535) return cudaErrorInvalidConfiguration;
    const dim3 grid(static_cast<unsigned>(n_brow), static_cast<unsigned>(chunks));
    if (bm == 8 && bn == 8) {
        bsr_spmm_kernel<T, 8, 8><<<grid, threads, 0, stream>>>(blocks, indptr, indices, V, out, bm, bn, m, k, n_out);
    } else {
        bsr_spmm_kernel<T, 0, 0><<<grid, threads, 0, stream>>>(blocks, indptr, indices, V, out, bm, bn, m, k, n_out);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* primate_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

cudaError_t bsr_spmm_f32(const float* blocks, const int64_t* indptr, const int64_t* indices, const float* V,
                         float* out, int64_t n_brow, int bm, int bn, int64_t m, int64_t k, int64_t n_out,
                         cudaStream_t stream) {
    return launch_bsr(blocks, indptr, indices, V, out, n_brow, bm, bn, m, k, n_out, stream);
}

cudaError_t bsr_spmm_f64(const double* blocks, const int64_t* indptr, const int64_t* indices, const double* V,
                         double* out, int64_t n_brow, int bm, int bn, int64_t m, int64_t k, int64_t n_out,
                         cudaStream_t stream) {
    return launch_bsr(blocks, indptr, indices, V, out, n_brow, bm, bn, m, k, n_out, stream);
}

}  // extern "C"
