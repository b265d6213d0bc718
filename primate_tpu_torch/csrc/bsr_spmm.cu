// Block-sparse-row (BSR) SpMM for Hopper (sm_90a), float32, float64 and bfloat16, and
// complex64 and complex128 (Hermitian operators).
//
// Replaces the Pallas TPU kernel of primate_tpu/ops/spmm_pallas.py:
//   bsr_spmm  <- bsr_matmat_pallas (_bsr_kernel): out[r*bm:(r+1)*bm, :] = sum over the
//                stored tiles of block row r of tile @ V[col*bn:(col+1)*bn, :]
//
// Layout: tiles (nnzb, bm, bn) row-sorted, indptr (n_brow + 1), indices (nnzb) the
// block-column ids, all as scipy's BSR stores them; V (m, k) and out (n_out, k)
// row-major (node-major probe blocks). Rows of the tile grid past m (the zero
// padding of a logical n that bm/bn does not divide) read as zeros, so V needs no
// padded copy; output rows past n_out are not written.
//
// Bound: HBM bytes. Each stored tile reads its bn rows of V, bn*k elements, for
// 2*bm*bn*k flops: 2*bm flops per V element (16 at 8x8), below the card's
// balance point. A random block structure gives V no reuse across block rows, so
// the gathered traffic (nnzb*bn*k elements of V, plus the tiles and the output)
// is what the kernel can reach, several times the least traffic. It is a
// latency-bound random gather unless many loads are in flight, so:
//   - a team of L lanes (8, 16 or 32: enough for k in 16-byte vectors, so two or
//     four teams share a warp at small k) owns a column chunk of L*16 bytes and a
//     contiguous range of block rows; the grid is persistent and the ranges are
//     cut by tile count (a binary search of indptr), so the teams get equal work
//     and a block row of many tiles shares no team with other rows (it stays
//     whole with one team, so that its output rows are written once);
//   - each team keeps a ring of kStages units in shared memory, a unit being one
//     tile (or an 8x8 slice of a larger one) with its 8 V row segments, filled
//     by cp.async: 16-byte copies along k (zero-filled past m and past k), the
//     tile as 16-byte copies too at 8x8. kStages - 1 units are in flight while
//     one is consumed, across block-row boundaries as well;
//   - each lane keeps 8 output rows x one vector of columns in registers and
//     writes each output row once with 16-byte stores: no atomics, so the result
//     is deterministic, and an empty block row writes zeros.
// When k is not a whole number of vectors, or V, out or the tiles are not 16-byte
// aligned, the same kernel copies and stores element by element (kVec = false).
// FP32/FP64 FMAs on the CUDA cores: a TF32 tensor-core product would lose the
// float32 accuracy the JAX package pins with Precision.HIGHEST.
//
// Complex: the JAX package applies complex BSR through its jnp segment-sum path
// (primate_tpu/operators/sparse.py:658-672), never the Pallas kernel. Here the same
// kernel is instantiated for common.cuh's Cplx element type. A 16-byte vector holds
// 2 complex64 or 1 complex128, so a lane moves the same bytes and holds the same
// registers as in float32 / float64; each tile entry costs 4 real FMAs a probe where
// a real one costs 1, so the kernel does 4x the arithmetic on 2x the bytes and stays
// bound by the gathered V traffic. The adjoint (A^H V) is this kernel on the tiles
// conjugated and transposed (BSROperator._transpose); the kernel never conjugates.
//
// bfloat16: the Pallas kernel takes bf16 tiles and V and accumulates in
// promote_types(blocks, V, float32). Here the ring holds the bf16 tiles and V rows as
// stored (8 values a 16-byte copy, so a lane covers 8 columns and the teams are half as
// wide as in float32 for the same k), each value is converted once to float32 where
// it is multiplied, the output rows sum in float32 registers and round once to bf16
// (__float2bfloat16_rn) where they are written. The same gather on half the bytes.
//
// Plain C interface: every entry point returns the cudaError_t of its launch
// (cudaGetLastError()), and the caller raises on anything but cudaSuccess. The
// kernels launch on the caller's stream, allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRB = 8;      // tile rows per pass: output rows held in registers per lane
constexpr int kJB = 8;      // tile columns (V rows) per unit
constexpr int kStages = 4;  // ring depth of a team
constexpr int kWarps = 4;   // warps per block
constexpr int kBlockThreads = kWarps * 32;

// Elements of one ring stage: an 8x8 tile slice, then kJB rows of the team's column chunk.
__host__ __device__ constexpr int stage_elems(int lanes, int vl) { return kRB * kJB + kJB * lanes * vl; }

// First r in [0, n_brow] with indptr[r] >= t.
__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ indptr, int64_t n_brow, int64_t t) {
    int64_t lo = 0, hi = n_brow;
    while (lo < hi) {
        const int64_t mid = (lo + hi) / 2;
        if (__ldg(indptr + mid) < t) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// BM, BN > 0 fix the tile shape at compile time (the common 8x8); 0 reads bm/bn.
template <typename T, bool kVec, int BM, int BN>
__global__ void __launch_bounds__(kBlockThreads) bsr_spmm_kernel(
    const T* __restrict__ blocks, const int64_t* __restrict__ indptr, const int64_t* __restrict__ indices,
    const T* __restrict__ V, T* __restrict__ out, int64_t n_brow, int bm_rt, int bn_rt, int64_t m, int64_t k,
    int64_t n_out, int lanes, int n_chunks, int64_t parts) {
    constexpr int VL = Vec<T>::len;
    using A = acc_t<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int bm = BM ? BM : bm_rt;
    const int bn = BN ? BN : bn_rt;
    const int n_pass = (bm + kRB - 1) / kRB;
    const int n_slices = (bn + kJB - 1) / kJB;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int teams_per_warp = 32 / lanes, team = lane / lanes, tl = lane % lanes;
    const unsigned mask = (lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u) << (team * lanes));
    const int se = stage_elems(lanes, VL);
    T* ring = reinterpret_cast<T*>(smem_raw) + static_cast<int64_t>(warp * teams_per_warp + team) * kStages * se;

    // This team's work: a column chunk, a pass of kRB tile rows and a range of block rows.
    const int64_t gteam = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * teams_per_warp + team;
    const int64_t work = static_cast<int64_t>(n_chunks) * n_pass;
    const int64_t part = gteam / work;
    if (part >= parts) return;
    const int chunk = static_cast<int>(gteam % work % n_chunks), pass = static_cast<int>(gteam % work / n_chunks);
    const int i0 = pass * kRB, rb = bm - i0 < kRB ? bm - i0 : kRB;
    const int64_t c = static_cast<int64_t>(chunk) * lanes * VL + tl * VL;  // this lane's first column
    const int64_t nnzb = __ldg(indptr + n_brow);
    const int64_t row_lo = part == 0 ? 0 : lower_bound(indptr, n_brow, nnzb * part / parts);
    const int64_t row_hi = part == parts - 1 ? n_brow : lower_bound(indptr, n_brow, nnzb * (part + 1) / parts);
    const int64_t t_lo = __ldg(indptr + row_lo), t_hi = __ldg(indptr + row_hi);
    const int64_t units = (t_hi - t_lo) * n_slices;

    // Fill stage s with unit u: its tile slice and the V row segments it multiplies.
    auto issue = [&](int64_t u, int s) {
        T* tile_s = ring + s * se;
        T* v_s = tile_s + kRB * kJB + tl * VL;
        const int64_t t = t_lo + u / n_slices;
        const int j0 = static_cast<int>(u % n_slices) * kJB;
        const int jb = bn - j0 < kJB ? bn - j0 : kJB;
        if constexpr (kVec && BM == kRB && BN == kJB) {
            const T* src = blocks + t * (kRB * kJB);
            for (int e = tl; e < kRB * kJB * static_cast<int>(sizeof(T)) / 16; e += lanes)
                cp_async<16>(tile_s + e * VL, src + e * VL, 16);
        } else {
            for (int e = tl; e < kRB * kJB; e += lanes) {
                const int i = e / kJB, j = e % kJB;
                const bool ok = i < rb && j < jb;
                copy_elem(tile_s + e, ok ? blocks + (t * bm + i0 + i) * bn + j0 + j : blocks, ok);
            }
        }
        const int64_t row0 = __ldg(indices + t) * bn + j0;  // first V row of this unit
#pragma unroll
        for (int j = 0; j < kJB; ++j) {
            const bool row_ok = j < jb && row0 + j < m;
            const T* src = V + (row0 + j) * k + c;
            if (kVec) {
                const bool ok = row_ok && c < k;
                cp_async<16>(v_s + j * lanes * VL, ok ? src : V, ok ? 16 : 0);
            } else {
#pragma unroll
                for (int e = 0; e < VL; ++e) {
                    const bool ok = row_ok && c + e < k;
                    copy_elem(v_s + j * lanes * VL + e, ok ? src + e : V, ok);
                }
            }
        }
    };

    A acc[kRB][VL];
    auto zero = [&]() {
#pragma unroll
        for (int i = 0; i < kRB; ++i)
#pragma unroll
            for (int e = 0; e < VL; ++e) acc[i][e] = A(0);
    };
    auto write_row = [&](int64_t r) {
#pragma unroll
        for (int i = 0; i < kRB; ++i) {
            const int64_t row = r * bm + i0 + i;
            if (i >= rb || row >= n_out) continue;
            if (kVec) {
                if (c < k) *reinterpret_cast<typename Vec<T>::type*>(out + row * k + c) = pack(acc[i]);
            } else {
#pragma unroll
                for (int e = 0; e < VL; ++e) {
                    if (c + e < k) out[row * k + c + e] = from_acc<T>(acc[i][e]);
                }
            }
        }
    };

    zero();
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < units) issue(s, s);
        cp_async_commit();
    }
    int64_t r = row_lo;
    int64_t te = r < row_hi ? __ldg(indptr + r + 1) : 0;  // end of row r's tiles
    for (int64_t u = 0; u < units; ++u) {
        const int64_t t = t_lo + u / n_slices;
        while (te <= t) {  // rows before tile t are complete (empty ones write zeros)
            write_row(r);
            zero();
            ++r;
            te = __ldg(indptr + r + 1);
        }
        cp_async_wait<kStages - 2>();  // unit u has landed (this lane's copies)
        __syncwarp(mask);              // ... and every lane's; stage (u - 1) % kStages is free
        if (u + kStages - 1 < units) issue(u + kStages - 1, static_cast<int>((u + kStages - 1) % kStages));
        cp_async_commit();
        const T* tile_s = ring + static_cast<int>(u % kStages) * se;
        const T* v_s = tile_s + kRB * kJB + tl * VL;
#pragma unroll
        for (int j = 0; j < kJB; ++j) {
            A v[VL];
            unpack(*reinterpret_cast<const typename Vec<T>::type*>(v_s + j * lanes * VL), v);
#pragma unroll
            for (int i = 0; i < kRB; ++i) {
                const A a = to_acc(tile_s[i * kJB + j]);
#pragma unroll
                for (int e = 0; e < VL; ++e) acc[i][e] += a * v[e];
            }
        }
    }
    cp_async_wait<0>();
    while (r < row_hi) {
        write_row(r);
        zero();
        ++r;
    }
}

template <typename T, bool kVec, int BM, int BN>
cudaError_t launch_bsr_as(const T* blocks, const int64_t* indptr, const int64_t* indices, const T* V, T* out,
                          int64_t n_brow, int bm, int bn, int64_t m, int64_t k, int64_t n_out, cudaStream_t stream) {
    constexpr int VL = Vec<T>::len;
    const int64_t vecs = (k + VL - 1) / VL;
    const int lanes = vecs <= 8 ? 8 : (vecs <= 16 ? 16 : 32);
    const int64_t n_chunks = (vecs + lanes - 1) / lanes;
    const int64_t work = n_chunks * ((bm + kRB - 1) / kRB);
    const int teams_per_block = kWarps * (32 / lanes);
    const size_t smem = static_cast<size_t>(teams_per_block) * kStages * stage_elems(lanes, VL) * sizeof(T);
    auto kern = bsr_spmm_kernel<T, kVec, BM, BN>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, occ = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kBlockThreads, smem)) != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    // Enough teams for every (chunk, pass) at least once, and at least a full card.
    int64_t blocks_n = static_cast<int64_t>(sms) * occ;
    const int64_t need = (work + teams_per_block - 1) / teams_per_block;
    if (blocks_n < need) blocks_n = need;
    if (n_chunks > 0x7fffffffLL || blocks_n > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    int64_t parts = blocks_n * teams_per_block / work;
    if (parts > n_brow) parts = n_brow;
    kern<<<static_cast<unsigned>(blocks_n), kBlockThreads, smem, stream>>>(
        blocks, indptr, indices, V, out, n_brow, bm, bn, m, k, n_out, lanes, static_cast<int>(n_chunks), parts);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bsr(const T* blocks, const int64_t* indptr, const int64_t* indices, const T* V, T* out,
                       int64_t n_brow, int bm, int bn, int64_t m, int64_t k, int64_t n_out, int vec,
                       cudaStream_t stream) {
    if (n_brow == 0 || k == 0 || n_out == 0) return cudaSuccess;
    if (bm <= 0 || bn <= 0) return cudaErrorInvalidValue;
    const bool t88 = bm == 8 && bn == 8;
    if (vec) {
        return t88 ? launch_bsr_as<T, true, 8, 8>(blocks, indptr, indices, V, out, n_brow, bm, bn, m, k, n_out, stream)
                   : launch_bsr_as<T, true, 0, 0>(blocks, indptr, indices, V, out, n_brow, bm, bn, m, k, n_out, stream);
    }
    return t88 ? launch_bsr_as<T, false, 8, 8>(blocks, indptr, indices, V, out, n_brow, bm, bn, m, k, n_out, stream)
               : launch_bsr_as<T, false, 0, 0>(blocks, indptr, indices, V, out, n_brow, bm, bn, m, k, n_out, stream);
}

}  // namespace

extern "C" {

const char* primate_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

cudaError_t bsr_spmm_f32(const float* blocks, const int64_t* indptr, const int64_t* indices, const float* V,
                         float* out, int64_t n_brow, int bm, int bn, int64_t m, int64_t k, int64_t n_out, int vec,
                         cudaStream_t stream) {
    return launch_bsr(blocks, indptr, indices, V, out, n_brow, bm, bn, m, k, n_out, vec, stream);
}

cudaError_t bsr_spmm_f64(const double* blocks, const int64_t* indptr, const int64_t* indices, const double* V,
                         double* out, int64_t n_brow, int bm, int bn, int64_t m, int64_t k, int64_t n_out, int vec,
                         cudaStream_t stream) {
    return launch_bsr(blocks, indptr, indices, V, out, n_brow, bm, bn, m, k, n_out, vec, stream);
}

cudaError_t bsr_spmm_bf16(const void* blocks, const int64_t* indptr, const int64_t* indices, const void* V, void* out,
                          int64_t n_brow, int bm, int bn, int64_t m, int64_t k, int64_t n_out, int vec,
                          cudaStream_t stream) {
    return launch_bsr(static_cast<const bf16*>(blocks), indptr, indices, static_cast<const bf16*>(V),
                      static_cast<bf16*>(out), n_brow, bm, bn, m, k, n_out, vec, stream);
}

// Complex instantiations (complex64 / complex128 as torch lays them out).
cudaError_t bsr_spmm_c64(const void* blocks, const int64_t* indptr, const int64_t* indices, const void* V, void* out,
                         int64_t n_brow, int bm, int bn, int64_t m, int64_t k, int64_t n_out, int vec,
                         cudaStream_t stream) {
    return launch_bsr(static_cast<const c64*>(blocks), indptr, indices, static_cast<const c64*>(V),
                      static_cast<c64*>(out), n_brow, bm, bn, m, k, n_out, vec, stream);
}

cudaError_t bsr_spmm_c128(const void* blocks, const int64_t* indptr, const int64_t* indices, const void* V, void* out,
                          int64_t n_brow, int bm, int bn, int64_t m, int64_t k, int64_t n_out, int vec,
                          cudaStream_t stream) {
    return launch_bsr(static_cast<const c128*>(blocks), indptr, indices, static_cast<const c128*>(V),
                      static_cast<c128*>(out), n_brow, bm, bn, m, k, n_out, vec, stream);
}

}  // extern "C"
