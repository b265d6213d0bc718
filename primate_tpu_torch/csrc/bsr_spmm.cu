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
// Complex128 with V in L2: where V (m x k) is small enough to stay in the card's 50 MB L2
// (kL2VBytes) and the tiles are 8x8, its gather is L2 traffic and the ring kernel is bound by its own
// machinery instead: a complex128 ring takes 80 KB of shared memory a block (2 blocks, 8 warps an
// SM), and each complex multiply-add costs 4 float64 FMAs and 2 adds on the CUDA cores, whose float64
// rate is half the card's. That case takes bsr_spmm_c128_l2_kernel below: the tile products on the
// tensor cores (float64 mma.sync), the tiles and V read straight through L2 into the MMA fragments,
// no shared memory (see the kernel).
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
#include <atomic>
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

// ---- The L2 path: complex128, 8x8 tiles, V in L2 ----
//
// A warp owns a chunk of kL2Cols complex columns and a range of block rows cut by tile count (the
// persistent grid and the cut of the ring kernel), and sums each output tile in registers as float64
// MMA fragments (mma.sync.m8n8k4: A 8x4 row-major, B 4x8, C 8x8; lane l holds A[l/4][l%4],
// B[l%4][l/4] and C[l/4][2(l%4) .. 2(l%4)+1]). A tile times one group of 8 columns is 8 MMAs: two k
// halves (tile columns 0-3, 4-7) times the four real products, Re += Re A Re V - Im A Im V and
// Im += Re A Im V + Im A Re V, with Im A negated (exact). A lane loads, a tile, its 2 tile entries
// and, a column group, its 2 V entries (one in each k half), by __ldg: the 8 lanes that share a V row
// read its 128-byte segment of the group. The warps of a block take the chunks of one row range, so
// a tile's lines, read once from HBM, serve its chunks from L1 or L2; V's lines come from L2. What
// bounds the kernel is then the L2's delivery of the gathered V rows (8 rows x k columns a tile). The
// next tile's loads are issued before the current tile's MMAs (a fragment set in registers), and its
// block-column id a tile earlier still. Each output row is written once, by its warp, with no
// atomics; an empty block row writes zeros. The MMA's sum order is not the plain version's: the
// result is held to it within complex128's tolerance, not in bits. Two column groups a warp: 94
// registers, 5 blocks an SM; four (154-166 registers, 3 blocks) measured 8% slower (PERF.md).
constexpr int kL2Warps = 4;                // warps per block
constexpr int kL2Groups = 2;               // column groups of 8 a warp holds
constexpr int kL2Cols = 8 * kL2Groups;     // complex columns of a warp's chunk
constexpr int64_t kL2VBytes = 40000000;    // V below this many bytes takes the L2 path (the L2 holds 50 MB)

__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
    asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
        : "+d"(c[0]), "+d"(c[1])
        : "d"(a), "d"(b));
}

// One complex128 entry through the read-only path (0 where !ok): one 16-byte load, or two 8-byte ones
// where a pointer is only 8-byte aligned.
template <bool kVec>
__device__ __forceinline__ c128 ldg_c128(const c128* p, bool ok) {
    if (!ok) return c128(0.0, 0.0);
    if (kVec) {
        const double2 v = __ldg(reinterpret_cast<const double2*>(p));
        return c128(v.x, v.y);
    }
    const double* d = reinterpret_cast<const double*>(p);
    return c128(__ldg(d), __ldg(d + 1));
}

// A lane's operands of one tile: its two tile entries (k halves) and its V entries of each column group.
struct L2Frag {
    c128 a[2];
    c128 v[kL2Groups][2];
};

template <bool kVec>
__global__ void __launch_bounds__(kL2Warps * 32) bsr_spmm_c128_l2_kernel(
    const c128* __restrict__ blocks, const int64_t* __restrict__ indptr, const int64_t* __restrict__ indices,
    const c128* __restrict__ V, c128* __restrict__ out, int64_t n_brow, int64_t m, int64_t k, int64_t n_out, int n_chunks,
    int64_t parts) {
    const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
    const int64_t gwarp = static_cast<int64_t>(blockIdx.x) * kL2Warps + threadIdx.x / 32;
    const int64_t part = gwarp / n_chunks;
    if (part >= parts) return;
    const int64_t col0 = (gwarp % n_chunks) * kL2Cols;
    const int64_t nnzb = __ldg(indptr + n_brow);
    const int64_t row_lo = part == 0 ? 0 : lower_bound(indptr, n_brow, nnzb * part / parts);
    const int64_t row_hi = part == parts - 1 ? n_brow : lower_bound(indptr, n_brow, nnzb * (part + 1) / parts);
    const int64_t t_lo = __ldg(indptr + row_lo), t_hi = __ldg(indptr + row_hi);

    auto load = [&](int64_t t, int64_t bcol, L2Frag& f) {
#pragma unroll
        for (int h = 0; h < 2; ++h) f.a[h] = ldg_c128<kVec>(blocks + t * 64 + g * 8 + 4 * h + q, true);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int64_t row = bcol * 8 + 4 * h + q;
#pragma unroll
            for (int c = 0; c < kL2Groups; ++c) {
                const int64_t col = col0 + 8 * c + g;
                f.v[c][h] = ldg_c128<kVec>(V + row * k + col, row < m && col < k);
            }
        }
    };
    double re[kL2Groups][2], im[kL2Groups][2];
    auto zero = [&]() {
#pragma unroll
        for (int c = 0; c < kL2Groups; ++c) re[c][0] = re[c][1] = im[c][0] = im[c][1] = 0.0;
    };
    auto write_row = [&](int64_t r) {
        const int64_t row = r * 8 + g;
        if (row >= n_out) return;
#pragma unroll
        for (int c = 0; c < kL2Groups; ++c) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int64_t col = col0 + 8 * c + 2 * q + i;
                if (col >= k) continue;
                double* dst = reinterpret_cast<double*>(out + row * k + col);
                if (kVec) {
                    *reinterpret_cast<double2*>(dst) = make_double2(re[c][i], im[c][i]);
                } else {  // 8-byte aligned only
                    dst[0] = re[c][i];
                    dst[1] = im[c][i];
                }
            }
        }
    };

    zero();
    int64_t r = row_lo;
    int64_t te = r < row_hi ? __ldg(indptr + r + 1) : 0;  // end of row r's tiles
    L2Frag cur, nxt;
    int64_t bcol_next = 0;
    if (t_lo < t_hi) {
        load(t_lo, __ldg(indices + t_lo), cur);
        if (t_lo + 1 < t_hi) bcol_next = __ldg(indices + t_lo + 1);
    }
    for (int64_t t = t_lo; t < t_hi; ++t) {
        while (te <= t) {  // rows before tile t are complete (empty ones write zeros)
            write_row(r);
            zero();
            ++r;
            te = __ldg(indptr + r + 1);
        }
        if (t + 1 < t_hi) {
            load(t + 1, bcol_next, nxt);
            if (t + 2 < t_hi) bcol_next = __ldg(indices + t + 2);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const double ar = cur.a[h].re, ai = cur.a[h].im;
#pragma unroll
            for (int c = 0; c < kL2Groups; ++c) {
                dmma(re[c], ar, cur.v[c][h].re);
                dmma(re[c], -ai, cur.v[c][h].im);
                dmma(im[c], ar, cur.v[c][h].im);
                dmma(im[c], ai, cur.v[c][h].re);
            }
        }
        cur = nxt;
    }
    while (r < row_hi) {
        write_row(r);
        zero();
        ++r;
    }
}

// The SM count and a kernel's resident blocks an SM at its block size and dynamic shared memory, for the
// current device: queried once a (kernel, launch variant, device), with the kernel's dynamic shared-memory
// attribute set to smem_max (the most any of its variants launches with: the attribute is the kernel's, not
// the variant's), and kept in the caller's cache (packed, 0 until known). Each query is a host call into the
// runtime, and a launch at a small shape spent about as long on the host as its kernel on the device (PERF.md).
constexpr int kCacheDevices = 64;
using ShapeCache = std::atomic<int64_t>[kCacheDevices];

template <typename K>
cudaError_t launch_shape(ShapeCache& cache, K kern, int threads, size_t smem, size_t smem_max, int& sms, int& occ) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const int64_t known = dev < kCacheDevices ? cache[dev].load(std::memory_order_relaxed) : 0;
    if (known != 0) {
        sms = static_cast<int>(known >> 32);
        occ = static_cast<int>(known & 0xffffffff);
        return cudaSuccess;
    }
    if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_max))) != cudaSuccess)
        return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads, smem)) != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    if (dev < kCacheDevices) cache[dev].store((static_cast<int64_t>(sms) << 32) | occ, std::memory_order_relaxed);
    return cudaSuccess;
}

template <bool kVec>
cudaError_t launch_bsr_l2(const c128* blocks, const int64_t* indptr, const int64_t* indices, const c128* V, c128* out,
                          int64_t n_brow, int64_t m, int64_t k, int64_t n_out, cudaStream_t stream) {
    static ShapeCache cache;
    int sms = 0, occ = 0;
    cudaError_t err = launch_shape(cache, bsr_spmm_c128_l2_kernel<kVec>, kL2Warps * 32, 0, 0, sms, occ);
    if (err != cudaSuccess) return err;
    const int64_t n_chunks = (k + kL2Cols - 1) / kL2Cols;
    int64_t parts = static_cast<int64_t>(sms) * occ * kL2Warps / n_chunks;
    if (parts > n_brow) parts = n_brow;
    if (parts < 1) parts = 1;
    const int64_t blocks_n = (parts * n_chunks + kL2Warps - 1) / kL2Warps;
    if (n_chunks > 0x7fffffffLL || blocks_n > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    bsr_spmm_c128_l2_kernel<kVec><<<static_cast<unsigned>(blocks_n), kL2Warps * 32, 0, stream>>>(
        blocks, indptr, indices, V, out, n_brow, m, k, n_out, static_cast<int>(n_chunks), parts);
    return cudaGetLastError();
}

template <typename T, bool kVec, int BM, int BN>
cudaError_t launch_bsr_as(const T* blocks, const int64_t* indptr, const int64_t* indices, const T* V, T* out,
                          int64_t n_brow, int bm, int bn, int64_t m, int64_t k, int64_t n_out, cudaStream_t stream) {
    constexpr int VL = Vec<T>::len;
    const int64_t vecs = (k + VL - 1) / VL;
    const int lanes = vecs <= 8 ? 8 : (vecs <= 16 ? 16 : 32);
    const int64_t n_chunks = (vecs + lanes - 1) / lanes;
    const int64_t work = n_chunks * ((bm + kRB - 1) / kRB);
    auto smem_of = [](int l) { return static_cast<size_t>(kWarps * (32 / l)) * kStages * stage_elems(l, VL) * sizeof(T); };
    const int teams_per_block = kWarps * (32 / lanes);
    const size_t smem = smem_of(lanes);
    size_t smem_max = smem_of(8);
    if (smem_of(16) > smem_max) smem_max = smem_of(16);
    if (smem_of(32) > smem_max) smem_max = smem_of(32);
    auto kern = bsr_spmm_kernel<T, kVec, BM, BN>;
    static ShapeCache cache[3];  // a team of 8, 16 or 32 lanes: its own shared memory and occupancy
    int sms = 0, occ = 0;
    cudaError_t err = launch_shape(cache[lanes == 8 ? 0 : lanes == 16 ? 1 : 2], kern, kBlockThreads, smem, smem_max, sms, occ);
    if (err != cudaSuccess) return err;
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

// Whether a call takes the L2 path: complex128, 8x8 tiles, V below kL2VBytes.
template <typename T>
bool l2_path_ok(int bm, int bn, int64_t m, int64_t k) {
    return std::is_same<T, c128>::value && bm == 8 && bn == 8 && m * k * static_cast<int64_t>(sizeof(T)) <= kL2VBytes;
}

template <typename T>
cudaError_t launch_bsr(const T* blocks, const int64_t* indptr, const int64_t* indices, const T* V, T* out,
                       int64_t n_brow, int bm, int bn, int64_t m, int64_t k, int64_t n_out, int vec,
                       cudaStream_t stream) {
    if (n_brow == 0 || k == 0 || n_out == 0) return cudaSuccess;
    if (bm <= 0 || bn <= 0) return cudaErrorInvalidValue;
    if constexpr (std::is_same<T, c128>::value) {
        if (l2_path_ok<T>(bm, bn, m, k)) {
            return vec ? launch_bsr_l2<true>(blocks, indptr, indices, V, out, n_brow, m, k, n_out, stream)
                       : launch_bsr_l2<false>(blocks, indptr, indices, V, out, n_brow, m, k, n_out, stream);
        }
    }
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

// Whether a complex128 call with these tiles and V takes the L2 path (the launcher decides; the wrapper
// asks only to count the launch); the other dtypes never do.
int bsr_spmm_l2_path(int bm, int bn, int64_t m, int64_t k) { return l2_path_ok<c128>(bm, bn, m, k) ? 1 : 0; }

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
