// DIA stencil kernels for Hopper (sm_90a), float32, float64 and bfloat16 (pass A of
// the step too, and the bf16 step's round pair); the two stencils and the two passes of
// the Lanczos step also complex64 and complex128 (Hermitian operators).
//
// Replaces the Pallas TPU kernels of primate_tpu/ops/dia_pallas.py:
//   dia_stencil_t        <- dia_matmat_t_pallas (_dia_t_kernel): out = A X, probe-major
//   dia_stencil          <- dia_matmat_pallas (_dia_kernel): out = A V, node-major
//   lanczos_dia_step     <- dia_matmat_t_phys (_dia_t_phys_kernel), the Lanczos sweep's
//   lanczos_dia_residual    stencil on its halo-padded carry; here the whole three-term
//   lanczos_dia_advance     step in two passes, and the finish of a row-sharded step;
//   lanczos_dia_round       for a bfloat16 carry, pass A and this pair of passes
//
// Layout: row-aligned bands (n_d, n) with band[d][r] = A[r, r + offsets[d]];
// probe-major blocks (nv, n) for dia_stencil_t, node-major blocks (n, k) for
// dia_stencil. Out-of-range neighbours (r + off outside [0, n)) are skipped by a
// bounds check, so the offsets may be of any size. The Lanczos step takes the
// carry of JAX's phys_spec in the port's own form: (nv, ld) with the own rows at
// columns [lo, lo + n) and the bands (n_d, ld) in the same columns, ld and lo whole
// 16-byte vectors (the flat carry is ld = n, lo = 0). The columns outside the own
// rows are zero, or hold the neighbour ranks' rows after a halo exchange; the step
// reads them as data and writes zeros there. The TPU's 128-lane HALO, its
// LANE_TILE rounding and the nv % 8 rule have no counterpart.
//
// Bound: HBM bytes. A stencil of a few diagonals does 2 n_d flops per loaded
// element, far below the card's ~20 flop/byte balance point. So the designs aim
// at one pass over the block and the bands, and no tensor cores (TF32 would
// break the float32 parity). The probe-major kernel gives a thread a 16-byte
// vector of rows and all probes: its band values are read once, and the shifted
// neighbour loads of a warp overlap the lines it and its block have just read, so
// they come from L1, or from L2 for far offsets; the TPU kernel's double-buffered
// halo DMA has no counterpart (see below and PERF.md for a shared-memory ring that
// was tried and measured slower). The node-major kernel reads rows r + off of V,
// each k elements away, so a diagonal does not share cache lines with its
// neighbours as in the probe-major layout: a thread takes a 16-byte vector of
// columns through two rows and issues the loads of four diagonals together, and
// the rows its neighbours in the block read come from L1, the far ones from L2
// (shared-memory rings of staged rows measured slower). See the kernels below and
// PERF.md.
//
// Complex: the JAX package sends complex DIA applies to XLA's stencil
// (primate_tpu/operators/sparse.py:816-827), since its Pallas kernels take no
// complex. Here the two stencils are instantiated for a complex element type
// (common.cuh's Cplx, accumulating in its own precision as JAX's
// promote_types(complex64, float32) does): a 16-byte vector holds 2 complex64 or
// 1 complex128, so a thread moves the same bytes and holds the same registers as
// in float32 / float64, and the kernels stay bound by HBM bytes (a complex
// multiply-add is 8 flops on 8 or 16 loaded bytes). The two step passes too: the
// JAX package runs its Hermitian sweep (primate_tpu/lanczos.py:226-227,309-316) through
// XLA, with alpha = Re sum conj(q) w and beta real. Here w and v are complex and the
// per-probe state and every sum are the real type (real_t), so the ticketed reductions
// are the real kernels'; alpha is summed from the parts (q.re w.re + q.im w.im). A
// thread owns 2 rows (complex64) or 1 (complex128); complex pass A keeps its band values
// in registers as dia_stencil_t does (no staged tile). The elementwise steps round as the
// plain version's PyTorch ops do on the card (mul_rn, sub_rn, mac below), so w comes out
// as the plain pass A's bit for bit, and v as the plain step's wherever alpha agrees.
//
// The Lanczos step (primate_tpu/lanczos.py:304-316,378-388 with orth = 0)
//   w = A q - beta q_prev;  alpha = Re sum conj(q) w;  v = w - alpha q;  beta' = |v|;
//   done |= beta' < tol;  q' = v / (beta' > tol ? beta' : inf)
// is two passes over the (nv, n) block, with no host sync and nothing between
// them. The sweep carries the residuals v unnormalised together with their
// guarded divisors (a per-probe state, rows kDivCur...kAlpha below): pass A
// divides on the fly, q = v / div, which rounds exactly as the reference's
// normalising pass and saves that pass's read and write.
//   pass A (lanczos_dia_step): reads v_cur (with its +-offset neighbours) and
//     v_prev, writes w and the alpha partials;
//   pass B (lanczos_dia_residual): reads w and v_cur, writes v = w - alpha q in
//     place of w and the |v|^2 partials.
// 6 nv n elements of traffic a step, plus the bands. Both passes are persistent
// grids that walk row tiles, so a probe has gridDim.x partials (tens: the card's
// resident blocks over the probe groups), not one per 256 rows. Each pass ends
// with a ticket: the last block to finish sums the partials of each probe in a
// fixed order (no floating-point atomics, so the result is deterministic) and
// writes alpha, or beta', the done flags and the next divisors, and alphas[j] /
// betas[j] zeroed where a probe was done. On a row-sharded carry each rank holds
// part of every sum, so in the finishing mode the last block writes only the
// rank's sum of each probe, and the caller all-reduces it between the passes. The
// step's finish (what the last blocks write above, from the reduced sums, so every
// rank's state advances alike) waits for the next kernel of the sweep, which runs
// after the second all-reduce anyway: pass A of the next step takes its divisors and
// beta from the pending sums and its last block writes the finish (Pending), so a
// row-sharded step is two launches, as an unsharded one; the bfloat16 step's B2 does
// the same within the step. lanczos_dia_advance (one thread a probe) runs a finish by
// itself where the sweep reads the state between steps and after its last step: its
// cost is the host's launch, not the device's (PERF.md). Loads and
// stores are 16 bytes along r. The float32 / float64 pass A stages a tile of q with kHalo
// rows on each side in shared memory, so neighbours at offsets up to kHalo come from there,
// larger offsets from direct (L1/L2) loads; the complex and bfloat16 ones hold the band values
// in registers and take every neighbour from their own rows, a neighbouring lane's or a direct
// load. When ld or lo is not a multiple of the vector length, or a pointer is not 16-byte
// aligned, the same kernels take scalar loads.
//
// bfloat16 (JAX's third operator dtype; its Pallas kernels take bf16 and accumulate
// in promote_types(dtype, float32)): the two stencils and pass A read bf16 bands and
// blocks, convert each element once to float32, sum in float32 registers, and the
// stencils round once to bf16 where they write (common.cuh's Acc, to_acc, from_acc).
// A 16-byte vector holds 8 bf16, so a thread owns 8 rows (the probe-major stencil, pass
// A) or 8 columns (the node-major one) and issues the same 16-byte loads as in float32
// on half the bytes of a row; the kernels stay bound by HBM bytes. (A node-major lane of
// 8-byte vectors, 4 columns as in float32, measured slower at the FEM cell, with 8 lanes
// a row and with 16: PERF.md.) The probe-major stencil and pass A have register kernels of
// their own for bf16 (below), which keep the band values packed as stored. Pass A writes w and the
// alpha partials in float32, as dia_matmat_t_phys writes its f32 output for a bf16
// carry, and takes a switch (round): round the stencil sum to bf16 before the
// beta-axpy, as JAX's flat and sharded applies do (matmat_t returns the operator's
// dtype), or not, as dia_matmat_t_phys does. The bf16 sweep rounds and normalises q
// every step (JAX's lanczos.py:388), so its pass A reads q as stored and takes no
// divisors, and the rest of its step is the round pair below (B1 the norm, B2 the
// rounded q_next) in place of pass B.
// With more diagonals than one chunk of band slots, the probe-major stencil keeps the
// float32 partial sums of the chunks in a float32 scratch block (mid) and rounds once.
//
// Plain C interface: every entry point returns the cudaError_t of its launch
// (cudaGetLastError()), and the caller raises on anything but cudaSuccess. The
// kernels launch on the caller's stream, allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

// ---- The probe-major stencil (dia_stencil_t) ----
//
// out[b, r] = sum_d band[d, r] x[b, r + off_d] on a row-major (nv, n) block.
// Each thread owns VL consecutive rows (one 16-byte vector) and takes them through
// every probe, so each band value is read from memory once and kept in a register
// for all nv probes. It issues the loads of kTProbes probes of a diagonal together:
// one 16-byte load a probe where the offset is a whole number of vectors and the
// neighbours lie inside [0, n) (0, +-100 and +-10,000 on the FEM cell), element
// loads otherwise (+-1). A warp's loads and stores cover whole
// 128-byte lines, and the stores are marked streaming so that they do not push
// x's rows out of L2. The nearby diagonals find the lines that the warp and its
// block have just loaded in L1; the far ones (+-10,000) find rows that another
// resident block reads at about the same probe in L2, since blocks are handed out
// in row order and each walks the probes in order. Diagonals past kTChunk are taken
// kTChunk at a time, each further chunk adding its sum to out. PERF.md lists the
// designs that measured slower (a cp.async ring of staged tiles, more loads in
// flight, band values in shared memory, prefetches). This kernel serves float32,
// float64 and complex; bfloat16 takes dia_stencil_t_bf16_kernel below.
constexpr int kTThreads = 256;
constexpr int kTBlocks = 2;  // resident blocks an SM it is compiled for: 128 registers a thread
constexpr int kTProbes = 4;  // probes whose loads a thread issues together
constexpr int kTChunk = 8;   // diagonals whose band values a thread holds
// One bit per (diagonal, row) of a chunk.
using TBits = unsigned;

// Rows r .. r + rows - 1 of kNP probes, from xb and ob at row r of the first probe:
// ob[k n + e] = (ob[k n + e] if add) + sum_j w[j][e] xb[k n + e + off[j]] over the
// chunk's nd diagonals. Bit j * VL + e of `in`: row r + e's neighbour on diagonal j
// lies in [0, n); bit j of `whole`: all of them do and one 16-byte load reads them.
template <typename T, bool kVec, int kNP>
__device__ __forceinline__ void stencil_group(const T (&w)[kTChunk][Vec<T>::len], const int64_t (&off)[kTChunk], int nd,
                                              TBits in, unsigned whole, const T* __restrict__ xb, T* __restrict__ ob,
                                              int64_t n, int rows, bool add) {
    constexpr int VL = Vec<T>::len;
    static_assert(kTChunk * VL <= 32, "a chunk's bits fit one word");
    using V = typename Vec<T>::type;
    T acc[kNP][VL];
#pragma unroll
    for (int k = 0; k < kNP; ++k)
#pragma unroll
        for (int e = 0; e < VL; ++e) acc[k][e] = add && e < rows ? ob[k * n + e] : T(0);
#pragma unroll
    for (int j = 0; j < kTChunk; ++j) {
        if (j >= nd) break;
        const T* src = xb + off[j];
        T v[kNP][VL];
        if (kVec && ((whole >> j) & 1u)) {
#pragma unroll
            for (int k = 0; k < kNP; ++k) unpack(__ldg(reinterpret_cast<const V*>(src + k * n)), v[k]);
        } else {
#pragma unroll
            for (int k = 0; k < kNP; ++k)
#pragma unroll
                for (int e = 0; e < VL; ++e) v[k][e] = (in >> (j * VL + e)) & 1u ? ldg(src + k * n + e) : T(0);
        }
#pragma unroll
        for (int k = 0; k < kNP; ++k)
#pragma unroll
            for (int e = 0; e < VL; ++e) acc[k][e] += w[j][e] * v[k][e];
    }
#pragma unroll
    for (int k = 0; k < kNP; ++k) {
        if (kVec) {
            __stcs(reinterpret_cast<V*>(ob + k * n), pack(acc[k]));
        } else {
#pragma unroll
            for (int e = 0; e < VL; ++e) {
                if (e < rows) stcs(ob + k * n + e, acc[k][e]);
            }
        }
    }
}

// kVec: n is a multiple of VL and x, out are 16-byte aligned, so a thread's rows
// are one aligned vector of every probe, wholly inside [0, n).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kTThreads, kTBlocks) dia_stencil_t_kernel(const T* __restrict__ bands,
                                                                           const int64_t* __restrict__ offsets,
                                                                           int n_d, const T* __restrict__ x,
                                                                           T* __restrict__ out, int64_t nv,
                                                                           int64_t n) {
    static_assert(!kNarrow<T>, "bfloat16 takes dia_stencil_t_bf16_kernel");
    constexpr int VL = Vec<T>::len;
    const int64_t r = (static_cast<int64_t>(blockIdx.x) * kTThreads + threadIdx.x) * VL;  // this thread's first row
    if (r >= n) return;
    const int rows = n - r < VL ? static_cast<int>(n - r) : VL;
    const int chunks = n_d > 0 ? (n_d + kTChunk - 1) / kTChunk : 1;  // no diagonal: one chunk that writes zeros
    for (int c = 0; c < chunks; ++c) {
        const int d0 = c * kTChunk, nd = n_d - d0 < kTChunk ? n_d - d0 : kTChunk;
        T w[kTChunk][VL];
        int64_t off[kTChunk];
        TBits in = 0;
        unsigned whole = 0;
#pragma unroll
        for (int j = 0; j < kTChunk; ++j) {
            off[j] = j < nd ? __ldg(offsets + d0 + j) : 0;
            unsigned bits = 0;
#pragma unroll
            for (int e = 0; e < VL; ++e) {  // the band value, 0 where the row or its neighbour lies outside [0, n)
                const int64_t rr = r + e;
                const bool ok = j < nd && e < rows && off[j] >= -rr && off[j] < n - rr;
                w[j][e] = ok ? ldg(bands + static_cast<int64_t>(d0 + j) * n + rr) : T(0);
                bits |= ok ? 1u << e : 0u;
            }
            in |= bits << (j * VL);
            if (kVec && bits == (1u << VL) - 1 && off[j] % VL == 0) whole |= 1u << j;
            if (bits == 0) off[j] = 0;  // no neighbour in range: nothing is loaded, keep the address in the block
        }
        const bool add = c > 0;
        int64_t b = 0;
        for (; b + kTProbes <= nv; b += kTProbes)
            stencil_group<T, kVec, kTProbes>(w, off, nd, in, whole, x + b * n + r, out + b * n + r, n, rows, add);
        for (; b < nv; ++b) stencil_group<T, kVec, 1>(w, off, nd, in, whole, x + b * n + r, out + b * n + r, n, rows, add);
    }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
    return v;
}

// ---- The Lanczos step: pass A (lanczos_dia_step) and pass B (lanczos_dia_residual) ----

// Rows of the per-probe state (kStateRows, nv) the step reads and updates.
constexpr int kDivCur = 0, kDivPrev = 1, kBeta = 2, kDone = 3, kAlpha = 4;
constexpr int kStepThreads = 256;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kStepProbes = 8;  // probes per block (blockIdx.y)
constexpr int kHalo = 16;       // rows staged on each side of a tile; a multiple of every vector length

// The step's elementwise arithmetic on a carry element x (real, or complex with a real
// divisor and real coefficients). Real: as written, the compiler free to contract. Complex:
// rounded as the plain version's PyTorch ops round on the card, each product once before the
// difference: x / div is PyTorch's complex division by (div, 0), which multiplies each part
// by the correctly rounded reciprocal inv = 1 / div (0 where div is inf, so a done probe's q
// is 0), and w - a x is a product tensor, then a difference.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename R>
__device__ __forceinline__ R quot(R x, R div, R) { return x / div; }
template <typename R>
__device__ __forceinline__ Cplx<R> quot(Cplx<R> x, R, R inv) { return Cplx<R>(mul_rn(x.re, inv), mul_rn(x.im, inv)); }
// w - a x
template <typename R>
__device__ __forceinline__ R minus_scaled(R w, R a, R x) { return w - a * x; }
template <typename R>
__device__ __forceinline__ Cplx<R> minus_scaled(Cplx<R> w, R a, Cplx<R> x) {
    return Cplx<R>(sub_rn(w.re, mul_rn(a, x.re)), sub_rn(w.im, mul_rn(a, x.im)));
}
// Re(conj(q) w), from the parts (the bra conjugated; real for a Hermitian operator's alpha).
template <typename R>
__device__ __forceinline__ R re_dot(R q, R w) { return w * q; }
template <typename R>
__device__ __forceinline__ R re_dot(Cplx<R> q, Cplx<R> w) { return q.re * w.re + q.im * w.im; }
// |v|^2
template <typename R>
__device__ __forceinline__ R sq_abs(R v) { return v * v; }
template <typename R>
__device__ __forceinline__ R sq_abs(Cplx<R> v) { return v.re * v.re + v.im * v.im; }

// Elements r .. r + len - 1 of a carry row, in the accumulation type; those outside
// [lo_b, hi_b) read as 0. kVec: one 16-byte load (the bounds and r are multiples of
// len, so a vector lies wholly inside or wholly outside them).
template <typename T, bool kVec>
__device__ __forceinline__ void load_seg(const T* row, int64_t r, int64_t lo_b, int64_t hi_b,
                                         acc_t<T> (&o)[Vec<T>::len]) {
    constexpr int VL = Vec<T>::len;
    if (kVec) {
        if (r >= lo_b && r < hi_b) {
            unpack(*reinterpret_cast<const typename Vec<T>::type*>(row + r), o);
        } else {
#pragma unroll
            for (int i = 0; i < VL; ++i) o[i] = acc_t<T>(0);
        }
    } else {
#pragma unroll
        for (int i = 0; i < VL; ++i) o[i] = (r + i >= lo_b && r + i < hi_b) ? to_acc(row[r + i]) : acc_t<T>(0);
    }
}

// N elements E at row + r. kVec: whole 16-byte vectors of E (the carry's columns past
// the own rows are inside the row's ld and take the zeros the caller computed); else
// the elements before n.
template <bool kVec, typename E, int N>
__device__ __forceinline__ void store_seg(E* row, int64_t r, int64_t n, const E (&o)[N]) {
    constexpr int VE = Vec<E>::len;
    static_assert(N % VE == 0, "a segment is whole vectors");
    if (kVec) {
#pragma unroll
        for (int h = 0; h < N / VE; ++h) {
            E part[VE];
#pragma unroll
            for (int i = 0; i < VE; ++i) part[i] = o[h * VE + i];
            *reinterpret_cast<typename Vec<E>::type*>(row + r + h * VE) = pack(part);
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) {
            if (r + i < n) row[r + i] = o[i];
        }
    }
}

// Block-reduce dot[p] over the block's threads in a fixed order and write it to
// partial[(b0 + p) * gridDim.x + blockIdx.x]. Then, if a ticket is given, the
// last block to finish returns true, after every other block's partials are visible.
template <typename T>
__device__ bool reduce_and_take_ticket(T (&dot)[kStepProbes], int np, int64_t b0, T* partial, unsigned* ticket) {
    __shared__ T red[kStepProbes][kStepWarps];
    __shared__ bool last;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int p = 0; p < kStepProbes; ++p) {
        const T s = warp_sum(dot[p]);
        if (lane == 0) red[p][warp] = s;
    }
    __syncthreads();
    if (threadIdx.x < np) {
        T s = T(0);
#pragma unroll
        for (int w = 0; w < kStepWarps; ++w) s += red[threadIdx.x][w];
        partial[(b0 + threadIdx.x) * gridDim.x + blockIdx.x] = s;
    }
    if (ticket == nullptr) return false;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
    __syncthreads();
    if (last) __threadfence();
    return last;
}

// Sum of partial[b, :] (gridDim.x values) in a fixed order, by one warp; lane 0 holds it.
template <typename T>
__device__ __forceinline__ T probe_total(const T* partial, int64_t b) {
    T s = T(0);
    for (int x = threadIdx.x % 32; x < static_cast<int>(gridDim.x); x += 32) s += __ldcg(partial + b * gridDim.x + x);
    return warp_sum(s);
}

// The finish of a row-sharded step for probe b, from the step's sums after their all-reduce (sums[b] = alpha,
// sums[nv + b] = |v|^2 over every rank's rows): what the two passes' last blocks write in the unsharded step.
// The standalone advance kernel, pass A of the next step (a pending finish) and B2 of a bfloat16 step all
// finish through these two functions, so they write the same bits.
template <typename R>
__device__ __forceinline__ R guarded_divisor(R beta, R tol) {
    return beta > tol ? beta : R(INFINITY);
}

template <typename R>
__device__ __forceinline__ void advance_probe(const R* sums, R* state, R* alpha_out, R* beta_out, int64_t nv, int64_t b,
                                              R tol) {
    const R alpha = sums[b], beta = sqrt(sums[nv + b]);
    const bool done = state[kDone * nv + b] != R(0);
    state[kAlpha * nv + b] = alpha;
    alpha_out[b] = done ? R(0) : alpha;
    beta_out[b] = done ? R(0) : beta;
    state[kDivPrev * nv + b] = state[kDivCur * nv + b];
    state[kDivCur * nv + b] = guarded_divisor(beta, tol);
    state[kBeta * nv + b] = beta;
    state[kDone * nv + b] = (done || beta < tol) ? R(1) : R(0);
}

// A row-sharded step's finish left pending for pass A of the next step (float32 / float64): the step's
// reduced sums (2, nv), the sweep's output rows it writes and the residual tolerance; sums null: none.
// Every block of that pass A takes its divisors and beta from it (what the finish would write), and
// the pass's last block writes it (advance_probe) once every block has read the state.
template <typename R>
struct Pending {
    const R* sums;
    R* alpha_out;
    R* beta_out;
    R tol;
};

// The end of pass A: the block's alpha partials (dot) reduced in a fixed order; the last block to finish sums
// each probe's partials and writes state[kAlpha] and alpha_out if given (zero where state[kDone]), or, in the
// finishing mode (sums given), only the rank's sums[b], and then the pending finish of the step before, if any.
template <typename R>
__device__ __forceinline__ void finish_pass_a(R (&dot)[kStepProbes], int np, int64_t b0, R* partial, unsigned* ticket,
                                              R* state, R* alpha_out, R* sums, int64_t nv, Pending<R> pend = {}) {
    if (!reduce_and_take_ticket(dot, np, b0, partial, ticket)) return;
    for (int64_t b = threadIdx.x / 32; b < nv; b += kStepWarps) {
        const R s = probe_total(partial, b);
        if (threadIdx.x % 32 == 0) {
            if (sums != nullptr) {
                sums[b] = s;
            } else {
                state[kAlpha * nv + b] = s;
                if (alpha_out != nullptr) alpha_out[b] = state[kDone * nv + b] != R(0) ? R(0) : s;
            }
        }
    }
    if (pend.sums != nullptr) {
        for (int64_t b = threadIdx.x; b < nv; b += kStepThreads)
            advance_probe(pend.sums, state, pend.alpha_out, pend.beta_out, nv, b, pend.tol);
    }
    if (threadIdx.x == 0) *ticket = 0u;
}

// The staged kernel's resident blocks an SM without a pending finish (48 / 64 registers at 256 threads: 5 / 4 blocks).
template <typename T>
constexpr int kStagedBlocks = sizeof(T) == 4 ? 5 : 4;

// The carry layout of both passes: probe b's row starts at b * ld, its own rows are
// columns [lo, lo + n), and the bands are (n_d, ld) in the same columns. The columns
// outside the own rows are the zero margins of a padded carry, or, on a row-sharded
// carry, the neighbour ranks' rows after a halo exchange: pass A reads them as data
// and both passes write zeros there. The flat carry is ld = n, lo = 0.
//
// Pass A: w[b, r] = sum_d band[d, r] q[b, r + off_d] - beta[b] q_prev[b, r] with
// q = v_cur / div_cur, q_prev = v_prev / div_prev, and the partials of
// alpha[b] = Re sum_r conj(q) w over the own rows. With a ticket, the last block writes
// state[kAlpha] and alpha_out if given (zero where state[kDone]); in the finishing mode
// (sums given) it writes only the rank's local sums[b] and leaves the state alone, but for a
// pending finish (pend.sums given): then div_cur, div_prev and beta come from it and the state as
// it stands (the divisors and beta the finish writes), and the last block writes the finish. The
// finish's prologue and epilogue raised the float32 kernel from 48 to 56 registers, 5 blocks an SM
// to 4, and a row-sharded step's pass A took 8% longer at 64 x 10M (PERF.md): the kernel is held to
// the occupancy it had without them (kStagedBlocks).
// This staged kernel serves float32 and float64 carries; a complex carry (w complex, the
// state, the partials and the sums real) takes the register kernel below, a bfloat16 one
// lanczos_pass_a_bf16_kernel.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kStepThreads, kStagedBlocks<T>) lanczos_pass_a_staged_kernel(
    const T* __restrict__ bands, const int64_t* __restrict__ offsets, int n_d, const T* __restrict__ v_cur,
    const T* __restrict__ v_prev, T* __restrict__ state, T* __restrict__ w, T* __restrict__ partial,
    unsigned* __restrict__ ticket, T* __restrict__ alpha_out, T* __restrict__ sums, int64_t nv, int64_t ld, int64_t lo,
    int64_t n, Pending<T> pend) {
    static_assert(!kNarrow<T> && !kCplx<T>, "the staged pass A is float32 / float64 only");
    constexpr int VL = Vec<T>::len;
    constexpr int kTile = kStepThreads * VL;
    constexpr int kSpan = kTile + 2 * kHalo;
    __shared__ __align__(16) T q_s[kStepProbes][kSpan];
    __shared__ T div_s[kStepProbes], divp_s[kStepProbes], beta_s[kStepProbes];
    const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kStepProbes;
    const int np = nv - b0 < kStepProbes ? static_cast<int>(nv - b0) : kStepProbes;
    const int64_t lo_b = -lo, hi_b = ld - lo;  // the carry's columns, counted from the first own row
    if (threadIdx.x < np) {
        const int64_t b = b0 + threadIdx.x;
        if (pend.sums != nullptr) {  // the step before's finish: its beta', and div_cur moves to div_prev
            const T beta = sqrt(pend.sums[nv + b]);
            div_s[threadIdx.x] = guarded_divisor(beta, pend.tol);
            divp_s[threadIdx.x] = state[kDivCur * nv + b];
            beta_s[threadIdx.x] = beta;
        } else {
            div_s[threadIdx.x] = state[kDivCur * nv + b];
            divp_s[threadIdx.x] = state[kDivPrev * nv + b];
            beta_s[threadIdx.x] = state[kBeta * nv + b];
        }
    }
    if (blockIdx.x == 0 && ld > n) {  // the margins of w: zero
        for (int p = 0; p < np; ++p) {
            T* row = w + (b0 + p) * ld;
            for (int64_t c = threadIdx.x; c < lo; c += kStepThreads) row[c] = T(0);
            for (int64_t c = lo + n + threadIdx.x; c < ld; c += kStepThreads) row[c] = T(0);
        }
    }
    T dot[kStepProbes];
#pragma unroll
    for (int p = 0; p < kStepProbes; ++p) dot[p] = T(0);
    const int64_t n_tiles = (n + kTile - 1) / kTile;
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int64_t r0 = t * kTile;
        __syncthreads();  // the previous tile's reads of q_s are done (and div_s is written)
#pragma unroll
        for (int p = 0; p < kStepProbes; ++p) {
            if (p >= np) break;
            const T* row = v_cur + (b0 + p) * ld + lo;
            const T div = div_s[p];
            for (int e = threadIdx.x; e < kSpan / VL; e += kStepThreads) {
                T o[VL];
                load_seg<T, kVec>(row, r0 - kHalo + e * VL, lo_b, hi_b, o);
#pragma unroll
                for (int i = 0; i < VL; ++i) q_s[p][e * VL + i] = o[i] / div;
            }
        }
        __syncthreads();
        const int64_t r = r0 + threadIdx.x * VL;
        if (r >= n) continue;
        const int loc = kHalo + threadIdx.x * VL;  // this thread's first row in q_s
#pragma unroll
        for (int p = 0; p < kStepProbes; ++p) {
            if (p >= np) break;
            const int64_t b = b0 + p;
            const T* row = v_cur + b * ld + lo;
            T acc[VL];
#pragma unroll
            for (int i = 0; i < VL; ++i) acc[i] = T(0);
            for (int d = 0; d < n_d; ++d) {
                const int64_t off = offsets[d];
                T band[VL];
                load_seg<T, kVec>(bands + d * ld + lo, r, lo_b, n, band);
                if (off >= -kHalo && off <= kHalo) {  // staged: q_s is 0 outside the carry
#pragma unroll
                    for (int i = 0; i < VL; ++i) acc[i] += band[i] * q_s[p][loc + i + off];
                } else {
                    const T div = div_s[p];
#pragma unroll
                    for (int i = 0; i < VL; ++i) {
                        const int64_t c = r + i + off;
                        if (c >= lo_b && c < hi_b) acc[i] += band[i] * (row[c] / div);
                    }
                }
            }
            T vp[VL], out[VL];
            load_seg<T, kVec>(v_prev + b * ld + lo, r, lo_b, hi_b, vp);
            const T beta = beta_s[p], divp = divp_s[p];
#pragma unroll
            for (int i = 0; i < VL; ++i) {
                out[i] = r + i < n ? acc[i] - beta * (vp[i] / divp) : T(0);  // a margin column: 0
                dot[p] += re_dot(q_s[p][loc + i], out[i]);
            }
            store_seg<kVec>(w + b * ld + lo, r, n, out);
        }
    }
    finish_pass_a(dot, np, b0, partial, ticket, state, alpha_out, sums, nv, pend);
}

// Pass A with the band values in registers (complex64, complex128): dia_stencil_t's structure
// on the step, in place of the staged kernel above. Each thread owns VL rows (one 16-byte
// vector) of a row tile and takes them through the block's probes. It reads the band values of
// a chunk of up to kTChunk diagonals once a tile and keeps them in registers with their
// in-range bits (with more diagonals than a chunk, each chunk is read again for each group of
// probes, so one chunk is live at a time), and issues the neighbour loads of kAProbes probes
// together: one 16-byte load a probe where the offset is a whole number of vectors and every
// neighbour lies in the carry, element loads otherwise, and none on a diagonal with no
// neighbour in the carry (the wrap diagonals of a periodic lattice). Every loaded element is
// divided as the staged kernel divides it (quot), the diagonals are summed in their order and
// each complex product is rounded before its sum (mac), as PyTorch's ops round on the card: w is
// the plain pass A's bit for bit (the staged kernel's complex128 w differed from it in the last
// bit of a few imaginary parts); the alpha partials take another order. No shared memory but the
// per-probe scalars and the block's reduction, and no barrier in the row loop: the nearby
// diagonals find their lines in L1, the far ones in L2. Complex only: the staged kernel measured
// faster for float32 and float64, whose threads hold 4 and 2 rows, and bfloat16 has its own
// register kernel with packed band values (PERF.md).
constexpr int kAProbes = 4;  // probes whose neighbour loads a thread issues together

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// acc + b x, the stencil's multiply-add: the product (re = b.re x.re - b.im x.im with one FMA,
// im = b.re x.im + b.im x.re with one FMA), then the sum, as PyTorch's product and sum tensors round
// on the card; written out, so that no other contraction of the compiler moves a bit.
template <typename R>
__device__ __forceinline__ void mac(Cplx<R>& acc, const Cplx<R>& b, const Cplx<R>& x) {
    acc.re = add_rn(acc.re, fma_rn(b.re, x.re, -mul_rn(b.im, x.im)));
    acc.im = add_rn(acc.im, fma_rn(b.re, x.im, mul_rn(b.im, x.re)));
}

// ---- The node-major stencil (dia_stencil) ----
//
// out[r, c] = sum_d band[d, r] V[r + off_d, c] on a row-major (n, k) block. A thread takes one
// 16-byte vector of columns through kNmRows consecutive rows; the `lanes` threads of a row group
// cover up to 512 bytes of each row (a chunk: lanes = the row's vectors rounded up to a power of
// two, at most 32, so a warp's loads of one diagonal are whole 128-byte lines of one to 32 rows).
// For each batch of kNmDiags diagonals it issues the band values and the neighbour loads of all its
// rows together (a thread holds kNmDiags x kNmRows 16-byte vectors in flight), then sums them: no
// shared memory and no barrier. The nearby diagonals find in L1 the lines that the same warp and
// block load for the other rows (the rows r - 1, r, r + 1 of a group overlap those of its
// neighbours); far ones (the FEM cell's +-10,000, the lattice's +-2047/+-2048, whose two loads of
// a pair overlap in L1 too) find in L2 the rows that the blocks sweeping that part of V read at
// about the same time, since blocks are handed out in row order. Rings of rows staged in shared
// memory, one step or several ahead, with their reach set from the offsets or with every window of
// rows and the band values staged, measured slower at every cell (PERF.md): a step's work is small
// beside its barrier and its index arithmetic, and fewer blocks fit an SM. The sum runs over the
// diagonals in their order, one multiply-add each: real types contracted (the float32 / float64
// bits of the ring kernel this one replaced), complex by mac (complex64 equals the plain version
// bit for bit). Every in-range neighbour is loaded whatever its band value, so 0 * inf stays NaN.
// kVec false (k or a pointer off 16 bytes): element loads and stores.
constexpr int kNmThreads = 128;
constexpr int kNmRows = 2;   // consecutive rows a thread takes
constexpr int kNmDiags = 4;  // diagonals whose loads a thread issues together

// acc + w x: a real type's multiply-add as written (the compiler contracts it), complex's mac.
template <typename A>
__device__ __forceinline__ void nm_mac(A& acc, const A& w, const A& x) {
    if constexpr (kCplx<A>) {
        mac(acc, w, x);
    } else {
        acc += w * x;
    }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kNmThreads) dia_stencil_kernel(const T* __restrict__ bands,
                                                                 const int64_t* __restrict__ offsets, int n_d,
                                                                 const T* __restrict__ V, T* __restrict__ out,
                                                                 int64_t n, int64_t k, int lanes) {
    constexpr int VL = Vec<T>::len;
    using Vv = typename Vec<T>::type;
    using A = acc_t<T>;
    const int lane = threadIdx.x % lanes, groups = kNmThreads / lanes;
    const int64_t c = (static_cast<int64_t>(blockIdx.y) * lanes + lane) * VL;  // this thread's first column
    const int64_t r = (static_cast<int64_t>(blockIdx.x) * groups + threadIdx.x / lanes) * kNmRows;  // first row
    if (r >= n || c >= k) return;
    const int rows = n - r < kNmRows ? static_cast<int>(n - r) : kNmRows;
    A acc[kNmRows][VL];
#pragma unroll
    for (int i = 0; i < kNmRows; ++i)
#pragma unroll
        for (int e = 0; e < VL; ++e) acc[i][e] = A(0);
    for (int d0 = 0; d0 < n_d; d0 += kNmDiags) {
        A w[kNmDiags][kNmRows];
        Vv x[kNmDiags][kNmRows];        // the vector path: packed until the multiply
        A xs[kNmDiags][kNmRows][VL];    // the element path
#pragma unroll
        for (int j = 0; j < kNmDiags; ++j) {
            const bool dj = d0 + j < n_d;
            const int64_t off = dj ? __ldg(offsets + d0 + j) : 0;
#pragma unroll
            for (int i = 0; i < kNmRows; ++i) {
                const int64_t rr = r + i + off;
                const bool ok = dj && i < rows && rr >= 0 && rr < n;
                w[j][i] = ok ? to_acc(ldg(bands + (d0 + j) * n + r + i)) : A(0);
                if constexpr (kVec) {
                    x[j][i] = ok ? __ldg(reinterpret_cast<const Vv*>(V + rr * k + c)) : Vv{};
                } else {
#pragma unroll
                    for (int e = 0; e < VL; ++e) xs[j][i][e] = ok && c + e < k ? to_acc(ldg(V + rr * k + c + e)) : A(0);
                }
            }
        }
#pragma unroll
        for (int j = 0; j < kNmDiags; ++j)
#pragma unroll
            for (int i = 0; i < kNmRows; ++i) {
                if constexpr (kVec) unpack(x[j][i], xs[j][i]);
#pragma unroll
                for (int e = 0; e < VL; ++e) nm_mac(acc[i][e], w[j][i], xs[j][i][e]);
            }
    }
#pragma unroll
    for (int i = 0; i < kNmRows; ++i) {
        if (i >= rows) break;
        if constexpr (kVec) {
            *reinterpret_cast<Vv*>(out + (r + i) * k + c) = pack(acc[i]);
        } else {
#pragma unroll
            for (int e = 0; e < VL; ++e) {
                if (c + e < k) out[(r + i) * k + c + e] = from_acc<T>(acc[i][e]);
            }
        }
    }
}

// Up to kTChunk diagonals at a thread's rows: the band values (0 where the row lies past the own
// rows or its neighbour outside the carry); bit j * VL + e of `in`: row e's neighbour on diagonal
// j lies in the carry; bit j of `whole`: all of them do and one 16-byte load reads them.
template <typename T>
struct BandChunk {
    T w[kTChunk][Vec<T>::len];
    TBits in;
    unsigned whole;
};

// The nd diagonals from offsets[0] (bands[0]: their first band row) at rows r .. r + rows - 1.
template <typename T, bool kVec>
__device__ __forceinline__ void load_band_chunk(BandChunk<T>& c, const T* __restrict__ bands,
                                                const int64_t* __restrict__ offsets, int nd, int64_t ld, int64_t lo,
                                                int64_t r, int rows, int64_t lo_b, int64_t hi_b) {
    constexpr int VL = Vec<T>::len;
    c.in = 0;
    c.whole = 0;
#pragma unroll
    for (int j = 0; j < kTChunk; ++j) {
        const int64_t off = j < nd ? __ldg(offsets + j) : 0;
        const T* row = bands + static_cast<int64_t>(j) * ld + lo + r;
        T band[VL];
        if (kVec && j < nd) {
            unpack(__ldg(reinterpret_cast<const typename Vec<T>::type*>(row)), band);
        } else {
#pragma unroll
            for (int e = 0; e < VL; ++e) band[e] = j < nd && e < rows ? ldg(row + e) : T(0);
        }
        unsigned bits = 0;
#pragma unroll
        for (int e = 0; e < VL; ++e) {
            const int64_t rr = r + e;
            const bool ok = j < nd && e < rows && off >= lo_b - rr && off < hi_b - rr;
            c.w[j][e] = ok ? band[e] : T(0);
            bits |= ok ? 1u << e : 0u;
        }
        c.in |= bits << (j * VL);
        if (kVec && bits == (1u << VL) - 1 && off % VL == 0) c.whole |= 1u << j;
    }
}

// acc[k] += the chunk's stencil sum at probe k's rows (vb: the first probe's row r, probes ld
// apart), each neighbour divided by its probe's divisor.
template <typename T, bool kVec, int kNP, typename R = real_t<T>>
__device__ __forceinline__ void accumulate_chunk(const BandChunk<T>& c, const int64_t* __restrict__ offsets, int nd,
                                                 const T* __restrict__ vb, int64_t ld, const R* div_s, const R* inv_s,
                                                 T (&acc)[kNP][Vec<T>::len]) {
    constexpr int VL = Vec<T>::len;
#pragma unroll
    for (int j = 0; j < kTChunk; ++j) {
        if (j >= nd) break;
        if (((c.in >> (j * VL)) & ((1u << VL) - 1)) == 0) continue;  // no neighbour in the carry
        const T* src = vb + __ldg(offsets + j);
        T x[kNP][VL];
        if (kVec && ((c.whole >> j) & 1u)) {
#pragma unroll
            for (int k = 0; k < kNP; ++k) unpack(__ldg(reinterpret_cast<const typename Vec<T>::type*>(src + k * ld)), x[k]);
        } else {
#pragma unroll
            for (int k = 0; k < kNP; ++k)
#pragma unroll
                for (int e = 0; e < VL; ++e) x[k][e] = (c.in >> (j * VL + e)) & 1u ? ldg(src + k * ld + e) : T(0);
        }
#pragma unroll
        for (int k = 0; k < kNP; ++k)
#pragma unroll
            for (int e = 0; e < VL; ++e) mac(acc[k][e], c.w[j][e], quot(x[k][e], div_s[k], inv_s[k]));
    }
}

// Probes p .. p + kNP - 1 of the block's group (b: the first one's index) at a thread's rows
// r .. r + rows - 1: the stencil sum over the chunks (c: the first chunk, loaded by the caller, if
// it is the only one; else each chunk is loaded into c here), then w = sum - beta q_prev, its
// store, and dot[p + k] += Re(conj(q) w).
template <typename T, bool kVec, int kNP, typename R = real_t<T>>
__device__ __forceinline__ void pass_a_probes(BandChunk<T>& c, const T* __restrict__ bands,
                                              const int64_t* __restrict__ offsets, int n_d,
                                              const T* __restrict__ v_cur, const T* __restrict__ v_prev,
                                              T* __restrict__ w, int64_t b, int p, const R* div_s, const R* inv_s,
                                              const R* divp_s, const R* invp_s, const R* beta_s, int64_t ld, int64_t lo,
                                              int64_t n, int64_t r, int rows, int64_t lo_b, int64_t hi_b,
                                              R (&dot)[kStepProbes]) {
    constexpr int VL = Vec<T>::len;
    T acc[kNP][VL];
#pragma unroll
    for (int k = 0; k < kNP; ++k)
#pragma unroll
        for (int e = 0; e < VL; ++e) acc[k][e] = T(0);
    const T* vb = v_cur + b * ld + lo + r;
    for (int d0 = 0; d0 < n_d; d0 += kTChunk) {
        const int nd = n_d - d0 < kTChunk ? n_d - d0 : kTChunk;
        if (n_d > kTChunk) load_band_chunk<T, kVec>(c, bands + d0 * ld, offsets + d0, nd, ld, lo, r, rows, lo_b, hi_b);
        accumulate_chunk<T, kVec, kNP>(c, offsets + d0, nd, vb, ld, div_s + p, inv_s + p, acc);
    }
#pragma unroll
    for (int k = 0; k < kNP; ++k) {
        const int64_t bk = b + k;
        using V = typename Vec<T>::type;
        T q[VL], vp[VL], out[VL];
        load_seg<T, kVec>(v_cur + bk * ld + lo, r, lo_b, hi_b, q);
        if constexpr (kVec && sizeof(T) == 8) {
            // complex64: v_prev's only read, evict-first (16 x 4,096,000, H100 80GB HBM3 at 700 W: 0.875 ->
            // 0.855 ms; complex128 took 1.483 -> 1.587 ms with it, so it reads through the cache).
            unpack(__ldcs(reinterpret_cast<const V*>(v_prev + bk * ld + lo + r)), vp);
        } else {
            load_seg<T, kVec>(v_prev + bk * ld + lo, r, lo_b, hi_b, vp);
        }
        const R div = div_s[p + k], inv = inv_s[p + k], divp = divp_s[p + k], invp = invp_s[p + k], beta = beta_s[p + k];
#pragma unroll
        for (int i = 0; i < VL; ++i) {
            out[i] = r + i < n ? minus_scaled(acc[k][i], beta, quot(vp[i], divp, invp)) : T(0);  // a margin column: 0
            dot[p + k] += re_dot(quot(q[i], div, inv), out[i]);
        }
        if constexpr (kVec) {
            __stcs(reinterpret_cast<V*>(w + bk * ld + lo + r), pack(out));  // streaming: keep v_cur's rows in L2
        } else {
            store_seg<kVec>(w + bk * ld + lo, r, n, out);
        }
    }
}

// The kernel's arguments are the staged kernel's; `round` has no effect on a complex carry.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kStepThreads, kTBlocks) lanczos_pass_a_kernel(
    const T* __restrict__ bands, const int64_t* __restrict__ offsets, int n_d, const T* __restrict__ v_cur,
    const T* __restrict__ v_prev, real_t<T>* __restrict__ state, T* __restrict__ w, real_t<T>* __restrict__ partial,
    unsigned* __restrict__ ticket, real_t<T>* __restrict__ alpha_out, real_t<T>* __restrict__ sums, int64_t nv,
    int64_t ld, int64_t lo, int64_t n, int) {
    static_assert(kCplx<T>, "the register pass A is complex only");
    using R = real_t<T>;
    constexpr int VL = Vec<T>::len;
    constexpr int kTile = kStepThreads * VL;
    __shared__ R div_s[kStepProbes], divp_s[kStepProbes], beta_s[kStepProbes], inv_s[kStepProbes], invp_s[kStepProbes];
    const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kStepProbes;
    const int np = nv - b0 < kStepProbes ? static_cast<int>(nv - b0) : kStepProbes;
    const int64_t lo_b = -lo, hi_b = ld - lo;  // the carry's columns, counted from the first own row
    if (threadIdx.x < kStepProbes) {  // slots past np: divisors 1, so no quotient there is inf or NaN
        const bool own = threadIdx.x < np;
        const R div = own ? state[kDivCur * nv + b0 + threadIdx.x] : R(1);
        const R divp = own ? state[kDivPrev * nv + b0 + threadIdx.x] : R(1);
        div_s[threadIdx.x] = div;
        divp_s[threadIdx.x] = divp;
        inv_s[threadIdx.x] = R(1) / div;  // the complex quotient multiplies by the reciprocal
        invp_s[threadIdx.x] = R(1) / divp;
        beta_s[threadIdx.x] = own ? state[kBeta * nv + b0 + threadIdx.x] : R(0);
    }
    if (blockIdx.x == 0 && ld > n) {  // the margins of w: zero
        for (int p = 0; p < np; ++p) {
            T* row = w + (b0 + p) * ld;
            for (int64_t c = threadIdx.x; c < lo; c += kStepThreads) row[c] = T(0);
            for (int64_t c = lo + n + threadIdx.x; c < ld; c += kStepThreads) row[c] = T(0);
        }
    }
    __syncthreads();
    R dot[kStepProbes];
#pragma unroll
    for (int p = 0; p < kStepProbes; ++p) dot[p] = R(0);
    const int64_t n_tiles = (n + kTile - 1) / kTile;
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int64_t r = t * kTile + threadIdx.x * VL;
        if (r >= n) break;
        const int rows = n - r < VL ? static_cast<int>(n - r) : VL;
        BandChunk<T> c;
        if (n_d <= kTChunk) load_band_chunk<T, kVec>(c, bands, offsets, n_d, ld, lo, r, rows, lo_b, hi_b);
#pragma unroll
        for (int p = 0; p < kStepProbes; p += kAProbes) {
            if (p >= np) break;
            if (p + kAProbes <= np) {
                pass_a_probes<T, kVec, kAProbes>(c, bands, offsets, n_d, v_cur, v_prev, w, b0 + p, p, div_s, inv_s, divp_s,
                                                 invp_s, beta_s, ld, lo, n, r, rows, lo_b, hi_b, dot);
            } else {
#pragma unroll
                for (int q = p; q < p + kAProbes; ++q) {
                    if (q >= np) break;
                    pass_a_probes<T, kVec, 1>(c, bands, offsets, n_d, v_cur, v_prev, w, b0 + q, q, div_s, inv_s, divp_s,
                                              invp_s, beta_s, ld, lo, n, r, rows, lo_b, hi_b, dot);
                }
            }
        }
    }
    finish_pass_a(dot, np, b0, partial, ticket, state, alpha_out, sums, nv);
}

// ---- bfloat16: the probe-major stencil and pass A in registers ----
//
// Both bf16 kernels give a thread one 16-byte vector (8 rows) of every probe, as the kernels above do, and keep what it
// reads packed as it is stored until the multiply (Bf8: 8 rows in 4 registers); each bf16 value becomes float32 at its
// multiply (exactly: its bits shifted up), and the sums are float32. Where a neighbour comes from depends on the
// diagonal's offset (the same in every lane, so no lane diverges):
//   0: the thread's own rows;
//   +-1, +-2: the own rows and one 32-bit word of the neighbouring lane's, by __shfl_down_sync / __shfl_up_sync; the
//     lanes at a warp's edges (0 and 31) take that word from memory instead, loaded with their own rows (it is the
//     next warp's first or the previous warp's last rows, in L1);
//   a whole number of vectors: one 16-byte load;
//   any other offset: the two aligned 16-byte vectors that hold its rows and a byte permute (__byte_perm).
// No shared memory but pass A's per-probe scalars and its reduction, and no barrier in the row loop. The diagonals are
// summed in their order with one multiply-add each, as the earlier bf16 kernels summed them (a staged pass A, and a
// probe-major kernel that held float32 band values), so w and out keep those kernels' bits. The two kernels hold the
// band values differently, each as it measured faster (PERF.md): the stencil keeps a chunk of them for all nv probes,
// pass A loads each where it multiplies.
constexpr int kBfProbes = 4;   // pass A: probes whose q and q_prev loads a thread issues together
constexpr int kBfTProbes = 2;  // dia_stencil_t: probes whose loads of a diagonal a thread issues together

// 8 bf16 rows packed as a 16-byte vector holds them: row e in word e / 2, the low half for even e.
struct Bf8 {
    unsigned w[4];
};

// Row e of a packed vector in float32 (exact).
__device__ __forceinline__ float bf8_at(const Bf8& v, int e) {
    return __uint_as_float(e & 1 ? v.w[e >> 1] & 0xffff0000u : v.w[e >> 1] << 16);
}

// acc[e] += w[e] x[e], one multiply-add a row.
__device__ __forceinline__ void bf8_fma(float (&acc)[8], const Bf8& w, const Bf8& x) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += bf8_at(w, e) * bf8_at(x, e);
}

// Rows c .. c + 7 of row (counted from its column 0), zero outside [lo_b, hi_b). kVec: c, lo_b and hi_b are
// multiples of 8 and row is 16-byte aligned, so the vector lies wholly inside or outside and one load reads it.
template <bool kVec>
__device__ __forceinline__ Bf8 bf8_load(const bf16* row, int64_t c, int64_t lo_b, int64_t hi_b) {
    Bf8 v = {{0u, 0u, 0u, 0u}};
    if constexpr (kVec) {
        if (c >= lo_b && c < hi_b) {
            const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + c));
            v = {{u.x, u.y, u.z, u.w}};
        }
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            if (c + e >= lo_b && c + e < hi_b) {
                v.w[e >> 1] |= static_cast<unsigned>(__bfloat16_as_ushort(ldg(row + c + e))) << (16 * (e & 1));
            }
        }
    }
    return v;
}

// Rows c, c + 1 as one word (c even), zero outside [lo_b, hi_b).
template <bool kVec>
__device__ __forceinline__ unsigned bf2_load(const bf16* row, int64_t c, int64_t lo_b, int64_t hi_b) {
    if constexpr (kVec) {
        return c >= lo_b && c < hi_b ? __ldg(reinterpret_cast<const unsigned*>(row + c)) : 0u;
    } else {
        unsigned v = 0u;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            if (c + e >= lo_b && c + e < hi_b) {
                v |= static_cast<unsigned>(__bfloat16_as_ushort(ldg(row + c + e))) << (16 * e);
            }
        }
        return v;
    }
}

// Rows k .. k + 7 of the 16 rows a, b (0 < k < 8, the same in every lane): whole words where k is even, a half-word
// shift by byte permutes where it is odd.
__device__ __forceinline__ Bf8 bf8_window(const Bf8& a, const Bf8& b, int k) {
    const unsigned x[8] = {a.w[0], a.w[1], a.w[2], a.w[3], b.w[0], b.w[1], b.w[2], b.w[3]};
    const int m = k >> 1;
    const unsigned sel = k & 1 ? 0x5432u : 0x3210u;
    Bf8 o;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const unsigned lo = m == 0 ? x[j] : m == 1 ? x[j + 1] : m == 2 ? x[j + 2] : x[j + 3];
        const unsigned hi = m == 0 ? x[j + 1] : m == 1 ? x[j + 2] : m == 2 ? x[j + 3] : x[j + 4];
        o.w[j] = __byte_perm(lo, hi, sel);
    }
    return o;
}

// Rows r + off .. r + off + 7 for 0 < |off| <= 2, from the own rows r .. r + 7 and one word of the neighbouring
// vector: `side` holds rows r + 8, r + 9 (off > 0) or r - 2, r - 1 (off < 0).
__device__ __forceinline__ Bf8 bf8_near(const Bf8& own, unsigned side, int off) {
    const unsigned sel = off & 1 ? 0x5432u : 0x3210u;
    Bf8 o;
    if (off > 0) {
        const unsigned x[5] = {own.w[0], own.w[1], own.w[2], own.w[3], side};
#pragma unroll
        for (int j = 0; j < 4; ++j) o.w[j] = __byte_perm(off == 1 ? x[j] : x[j + 1], x[j + 1], sel);
    } else {
        const unsigned x[5] = {side, own.w[0], own.w[1], own.w[2], own.w[3]};
#pragma unroll
        for (int j = 0; j < 4; ++j) o.w[j] = __byte_perm(x[j], x[j + 1], sel);
    }
    return o;
}

// The band values of the diagonal at `off` (band: its band row, counted from row 0) at rows r .. r + 7, zero where the
// row lies at or past `rows` or its neighbour outside [lo_b, hi_b). Loaded where they are used (a 16-byte load that
// the warp's earlier probes brought into L1), so no thread holds a chunk of them; masked only at an edge.
template <bool kVec>
__device__ __forceinline__ Bf8 bf8_band(const bf16* __restrict__ band, int64_t off, int64_t r, int rows, int64_t lo_b,
                                        int64_t hi_b) {
    Bf8 b = bf8_load<kVec>(band, r, r, r + rows);
    if (rows < 8 || r + off < lo_b || r + off + 8 > hi_b) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int64_t rr = r + e;
            if (!(e < rows && off >= lo_b - rr && off < hi_b - rr)) b.w[e >> 1] &= ~(0xffffu << (16 * (e & 1)));
        }
    }
    return b;
}

// Rows r + off .. r + off + 7 of the probe row x (counted from its row 0), zero outside [lo_b, hi_b): the own rows (own),
// a neighbouring lane's word (lanes 0 and 31: prv, rows r - 2, r - 1, and nxt, rows r + 8, r + 9), one load, or two
// aligned loads and a byte permute. Every lane of the warp calls it (the shuffles).
template <bool kVec>
__device__ __forceinline__ Bf8 bf8_neighbours(const bf16* __restrict__ x, int64_t off, int64_t r, int64_t lo_b,
                                              int64_t hi_b, const Bf8& own, unsigned prv, unsigned nxt) {
    if (off == 0) return own;
    if (off >= -2 && off <= 2) {
        const int lane = threadIdx.x % 32;
        unsigned side;
        if (off > 0) {
            side = __shfl_down_sync(0xffffffffu, own.w[0], 1);
            if (lane == 31) side = nxt;
        } else {
            side = __shfl_up_sync(0xffffffffu, own.w[3], 1);
            if (lane == 0) side = prv;
        }
        return bf8_near(own, side, static_cast<int>(off));
    }
    if (!kVec || (off & 7) == 0) return bf8_load<kVec>(x, r + off, lo_b, hi_b);  // the element path: 8 element loads
    const int64_t a = r + (off & ~static_cast<int64_t>(7));  // the aligned vector that holds row r + off
    return bf8_window(bf8_load<kVec>(x, a, lo_b, hi_b), bf8_load<kVec>(x, a + 8, lo_b, hi_b), static_cast<int>(off & 7));
}

// The own rows r .. r + 7 of kNP probes (x: the first probe's row, counted from its row 0, probes `stride` apart), zero
// outside [lo_b, hi_b), and in lanes 0 and 31 the word beside them.
template <bool kVec, int kNP>
__device__ __forceinline__ void bf8_own(const bf16* __restrict__ x, int64_t stride, int64_t r, int64_t lo_b, int64_t hi_b,
                                        Bf8 (&own)[kNP], unsigned (&prv)[kNP], unsigned (&nxt)[kNP]) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int k = 0; k < kNP; ++k) {
        own[k] = bf8_load<kVec>(x + k * stride, r, lo_b, hi_b);
        prv[k] = lane == 0 ? bf2_load<kVec>(x + k * stride, r - 2, lo_b, hi_b) : 0u;
        nxt[k] = lane == 31 ? bf2_load<kVec>(x + k * stride, r + 8, lo_b, hi_b) : 0u;
    }
}

// ---- dia_stencil_t, bfloat16 ----
//
// A thread holds the band values of a chunk of up to kTChunk diagonals (packed, 4 registers a diagonal) for all nv
// probes, and takes kBfTProbes probes at a time through the chunk diagonal by diagonal, the loads of the probes issued
// together. Two probes: with three or four in flight it spilled at its 128 registers (2 blocks of 256 an SM), and
// 128-thread blocks with room for them cost the 500k block its single wave (PERF.md).

// Up to kTChunk diagonals at a thread's rows r .. r + 7 (bf8_band each).
struct Bf8Chunk {
    Bf8 w[kTChunk];
};

// The nd diagonals from offsets[0] (bands: their first band row, rows n apart).
template <bool kVec>
__device__ __forceinline__ void load_bf8_chunk(Bf8Chunk& c, const bf16* __restrict__ bands,
                                               const int64_t* __restrict__ offsets, int nd, int64_t n, int64_t r, int rows) {
#pragma unroll
    for (int j = 0; j < kTChunk; ++j)
        c.w[j] = j < nd ? bf8_band<kVec>(bands + j * n, __ldg(offsets + j), r, rows, 0, n) : Bf8{{0u, 0u, 0u, 0u}};
}

// acc[k] += the chunk's sum at rows r .. r + 7 of probe k, in the chunk's order of diagonals. x: the first probe's
// row (counted from its row 0), probes n apart; own[k]: probe k's rows r .. r + 7, zero outside [0, n); prv[k],
// nxt[k]: its rows r - 2, r - 1 and r + 8, r + 9 in lanes 0 and 31. Every lane of the warp takes part (the shuffles),
// also one whose rows lie past n. bf8_neighbours' cases written out for kNP probes, each case's loads issued before
// its arithmetic: taking each probe's neighbours through bf8_neighbours measured 5-17% slower (PERF.md).
template <bool kVec, int kNP>
__device__ __forceinline__ void bf8_chunk_sum(const Bf8Chunk& c, const int64_t* __restrict__ offsets, int nd,
                                              const bf16* __restrict__ x, int64_t n, int64_t r, const Bf8 (&own)[kNP],
                                              const unsigned (&prv)[kNP], const unsigned (&nxt)[kNP],
                                              float (&acc)[kNP][8]) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < kTChunk; ++j) {
        if (j >= nd) break;
        const int64_t off = __ldg(offsets + j);
        if (off == 0) {
#pragma unroll
            for (int k = 0; k < kNP; ++k) bf8_fma(acc[k], c.w[j], own[k]);
        } else if (off >= -2 && off <= 2) {
#pragma unroll
            for (int k = 0; k < kNP; ++k) {
                unsigned side;
                if (off > 0) {
                    side = __shfl_down_sync(0xffffffffu, own[k].w[0], 1);
                    if (lane == 31) side = nxt[k];
                } else {
                    side = __shfl_up_sync(0xffffffffu, own[k].w[3], 1);
                    if (lane == 0) side = prv[k];
                }
                bf8_fma(acc[k], c.w[j], bf8_near(own[k], side, static_cast<int>(off)));
            }
        } else if (!kVec || (off & 7) == 0) {  // one load a probe (the element path: 8 element loads)
            Bf8 v[kNP];
#pragma unroll
            for (int k = 0; k < kNP; ++k) v[k] = bf8_load<kVec>(x + k * n, r + off, 0, n);
#pragma unroll
            for (int k = 0; k < kNP; ++k) bf8_fma(acc[k], c.w[j], v[k]);
        } else {
            const int64_t a = r + (off & ~static_cast<int64_t>(7));  // the aligned vector that holds row r + off
            Bf8 lo_v[kNP], hi_v[kNP];
#pragma unroll
            for (int k = 0; k < kNP; ++k) {
                lo_v[k] = bf8_load<kVec>(x + k * n, a, 0, n);
                hi_v[k] = bf8_load<kVec>(x + k * n, a + 8, 0, n);
            }
#pragma unroll
            for (int k = 0; k < kNP; ++k) bf8_fma(acc[k], c.w[j], bf8_window(lo_v[k], hi_v[k], static_cast<int>(off & 7)));
        }
    }
}

// The probe-major stencil for bfloat16: out = A X rounded once to bf16. Rows r .. r + 7 of kNP probes from xb, ob, mb
// (row 0 of the first probe, probes n apart); the chunks before the last keep their float32 sums in mb (the (nv, n)
// scratch `mid`), and a later chunk starts from them.
template <bool kVec, int kNP>
__device__ __forceinline__ void stencil_t_bf16_group(const Bf8Chunk& c, const int64_t* __restrict__ offsets, int nd,
                                                     const bf16* __restrict__ xb, bf16* __restrict__ ob,
                                                     float* __restrict__ mb, int64_t n, int64_t r, int rows, bool add,
                                                     bool last) {
    Bf8 own[kNP];
    unsigned prv[kNP], nxt[kNP];
    bf8_own<kVec, kNP>(xb, n, r, 0, n, own, prv, nxt);
    float acc[kNP][8];
#pragma unroll
    for (int k = 0; k < kNP; ++k) {
        float* m = mb + k * n + r;
        if (kVec && add && rows > 0) {
            const float4 u = *reinterpret_cast<const float4*>(m), v = *reinterpret_cast<const float4*>(m + 4);
            acc[k][0] = u.x, acc[k][1] = u.y, acc[k][2] = u.z, acc[k][3] = u.w;
            acc[k][4] = v.x, acc[k][5] = v.y, acc[k][6] = v.z, acc[k][7] = v.w;
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[k][e] = add && e < rows ? m[e] : 0.0f;
        }
    }
    bf8_chunk_sum<kVec, kNP>(c, offsets, nd, xb, n, r, own, prv, nxt, acc);
    if (rows <= 0) return;  // a lane past the rows: it lent its (zero) rows to the shuffles
#pragma unroll
    for (int k = 0; k < kNP; ++k) {
        if (!last) {
            float* m = mb + k * n + r;
            if (kVec) {
                *reinterpret_cast<float4*>(m) = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
                *reinterpret_cast<float4*>(m + 4) = make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    if (e < rows) m[e] = acc[k][e];
                }
            }
        } else if (kVec) {
            *reinterpret_cast<uint4*>(ob + k * n + r) = pack(acc[k]);
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                if (e < rows) ob[k * n + r + e] = from_acc<bf16>(acc[k][e]);
            }
        }
    }
}

// kVec: n is a multiple of 8 and bands, x, out and mid are 16-byte aligned. A warp's lanes hold 32 consecutive
// vectors; a warp whose rows all lie past n leaves, the others keep every lane for the shuffles.
template <bool kVec>
__global__ void __launch_bounds__(kTThreads, kTBlocks) dia_stencil_t_bf16_kernel(const bf16* __restrict__ bands,
                                                                                const int64_t* __restrict__ offsets,
                                                                                int n_d, const bf16* __restrict__ x,
                                                                                bf16* __restrict__ out,
                                                                                float* __restrict__ mid, int64_t nv,
                                                                                int64_t n) {
    const int64_t r = (static_cast<int64_t>(blockIdx.x) * kTThreads + threadIdx.x) * 8;  // this thread's first row
    if (r - (threadIdx.x % 32) * 8 >= n) return;
    const int rows = n - r >= 8 ? 8 : n > r ? static_cast<int>(n - r) : 0;
    const int chunks = n_d > 0 ? (n_d + kTChunk - 1) / kTChunk : 1;  // no diagonal: one chunk that writes zeros
    for (int ci = 0; ci < chunks; ++ci) {
        const int d0 = ci * kTChunk, nd = n_d - d0 < kTChunk ? n_d - d0 : kTChunk;
        Bf8Chunk c;
        load_bf8_chunk<kVec>(c, bands + static_cast<int64_t>(d0) * n, offsets + d0, nd, n, r, rows);
        const bool add = ci > 0, last = ci == chunks - 1;
        int64_t b = 0;
        for (; b + kBfTProbes <= nv; b += kBfTProbes)
            stencil_t_bf16_group<kVec, kBfTProbes>(c, offsets + d0, nd, x + b * n, out + b * n, mid + b * n, n, r, rows, add,
                                                   last);
        for (; b < nv; ++b)
            stencil_t_bf16_group<kVec, 1>(c, offsets + d0, nd, x + b * n, out + b * n, mid + b * n, n, r, rows, add, last);
    }
}

// ---- Pass A, bfloat16 ----
//
// A thread loads the q and q_prev rows of kBfProbes probes together, then takes the probes one at a time through the
// diagonals (a runtime loop), each band vector loaded where it multiplies (an L1 hit after the tile's first probe): a
// chunk of band values held across the tile's probes measured 50% slower here though it did not spill, and a ring of
// cp.async copies kept in flight ahead of the arithmetic 18% slower (PERF.md). w goes out in streaming stores.

// acc += the sum over the nd diagonals from offsets[0] (bands: the first one's band row, band rows ld apart) at rows
// r .. r + 7 of the probe row x, in their order, one multiply-add each.
template <bool kVec>
__device__ __forceinline__ void bf8_probe_sum(const bf16* __restrict__ bands, const int64_t* __restrict__ offsets, int nd,
                                              int64_t ld, const bf16* __restrict__ x, int64_t r, int rows, int64_t lo_b,
                                              int64_t hi_b, const Bf8& own, unsigned prv, unsigned nxt, float (&acc)[8]) {
    for (int j = 0; j < nd; ++j) {
        const int64_t off = __ldg(offsets + j);
        bf8_fma(acc, bf8_band<kVec>(bands + j * ld, off, r, rows, lo_b, hi_b),
                bf8_neighbours<kVec>(x, off, r, lo_b, hi_b, own, prv, nxt));
    }
}

// Pass A of a bfloat16 step: w = (round ? bf16(A q) : A q) - beta q_prev in float32, zero in the margin columns, and
// alpha = sum q w; q and q_prev read as stored (the bf16 sweep normalises q every step, so there are no divisors).
// Probes b .. b + kNP - 1 (the block's p ..) at a thread's rows: their q and q_prev rows loaded together, then probe by
// probe the stencil sum, the beta-axpy, w's store and dot[p + k] += q w, in the staged kernel's order.
template <bool kVec, int kNP>
__device__ __forceinline__ void pass_a_bf16_probes(const bf16* __restrict__ bands, const int64_t* __restrict__ offsets,
                                                   int n_d, const bf16* __restrict__ v_cur, const bf16* __restrict__ v_prev,
                                                   float* __restrict__ w, int64_t b, int p, const float* beta_s, int64_t ld,
                                                   int64_t lo, int64_t n, int64_t r, int rows, int64_t lo_b, int64_t hi_b,
                                                   int round, float (&dot)[kStepProbes]) {
    Bf8 own[kNP], pv[kNP];
    unsigned prv[kNP], nxt[kNP];
    const bf16* q = v_cur + b * ld + lo;
    bf8_own<kVec, kNP>(q, ld, r, lo_b, hi_b, own, prv, nxt);
#pragma unroll
    for (int k = 0; k < kNP; ++k) {
        pv[k] = rows > 0 ? bf8_load<kVec>(v_prev + (b + k) * ld + lo, r, lo_b, hi_b) : Bf8{{0u, 0u, 0u, 0u}};
    }
#pragma unroll
    for (int k = 0; k < kNP; ++k) {
        float acc[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
        bf8_probe_sum<kVec>(bands + lo, offsets, n_d, ld, q + k * ld, r, rows, lo_b, hi_b, own[k], prv[k], nxt[k], acc);
        if (rows <= 0) continue;  // a lane past the own rows: it lent its rows to the shuffles
        const float beta = beta_s[p + k];
        float out[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float s = round ? to_acc(from_acc<bf16>(acc[i])) : acc[i];
            out[i] = i < rows ? s - beta * bf8_at(pv[k], i) : 0.0f;  // a margin column: 0
            dot[p + k] += out[i] * bf8_at(own[k], i);
        }
        float* row = w + (b + k) * ld + lo;
        if constexpr (kVec) {  // streaming: keep q's rows in L2 for the round pair
            __stcs(reinterpret_cast<float4*>(row + r), make_float4(out[0], out[1], out[2], out[3]));
            __stcs(reinterpret_cast<float4*>(row + r + 4), make_float4(out[4], out[5], out[6], out[7]));
        } else {
            store_seg<false>(row, r, n, out);
        }
    }
}

// The staged kernel's arguments; no divisors (state[kDivCur], state[kDivPrev] are not read).
template <bool kVec>
__global__ void __launch_bounds__(kStepThreads, kTBlocks) lanczos_pass_a_bf16_kernel(
    const bf16* __restrict__ bands, const int64_t* __restrict__ offsets, int n_d, const bf16* __restrict__ v_cur,
    const bf16* __restrict__ v_prev, float* __restrict__ state, float* __restrict__ w, float* __restrict__ partial,
    unsigned* __restrict__ ticket, float* __restrict__ alpha_out, float* __restrict__ sums, int64_t nv, int64_t ld,
    int64_t lo, int64_t n, int round) {
    constexpr int kTile = kStepThreads * 8;
    __shared__ float beta_s[kStepProbes];
    const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kStepProbes;
    const int np = nv - b0 < kStepProbes ? static_cast<int>(nv - b0) : kStepProbes;
    const int64_t lo_b = -lo, hi_b = ld - lo;  // the carry's columns, counted from the first own row
    if (threadIdx.x < kStepProbes) beta_s[threadIdx.x] = threadIdx.x < np ? state[kBeta * nv + b0 + threadIdx.x] : 0.0f;
    if (blockIdx.x == 0 && ld > n) {  // the margins of w: zero
        for (int p = 0; p < np; ++p) {
            float* row = w + (b0 + p) * ld;
            for (int64_t c = threadIdx.x; c < lo; c += kStepThreads) row[c] = 0.0f;
            for (int64_t c = lo + n + threadIdx.x; c < ld; c += kStepThreads) row[c] = 0.0f;
        }
    }
    __syncthreads();
    float dot[kStepProbes];
#pragma unroll
    for (int p = 0; p < kStepProbes; ++p) dot[p] = 0.0f;
    const int64_t n_tiles = (n + kTile - 1) / kTile;
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int64_t r = t * kTile + threadIdx.x * 8;
        if (r - (threadIdx.x % 32) * 8 >= n) break;  // this warp's rows, and those of its later tiles, lie past the own rows
        const int rows = n - r >= 8 ? 8 : n > r ? static_cast<int>(n - r) : 0;
#pragma unroll
        for (int p = 0; p < kStepProbes; p += kBfProbes) {
            if (p >= np) break;
            if (p + kBfProbes <= np) {
                pass_a_bf16_probes<kVec, kBfProbes>(bands, offsets, n_d, v_cur, v_prev, w, b0 + p, p, beta_s, ld, lo, n, r, rows,
                                                    lo_b, hi_b, round, dot);
            } else {
#pragma unroll
                for (int q = p; q < p + kBfProbes; ++q) {
                    if (q >= np) break;
                    pass_a_bf16_probes<kVec, 1>(bands, offsets, n_d, v_cur, v_prev, w, b0 + q, q, beta_s, ld, lo, n, r, rows, lo_b,
                                                hi_b, round, dot);
                }
            }
        }
    }
    finish_pass_a(dot, np, b0, partial, ticket, state, alpha_out, sums, nv);
}

// Pass B: v = w - alpha q in place of w over the own rows (zero in the margins), with
// q = v_cur / div_cur and alpha from alpha_src (state[kAlpha], or the reduced sums of
// pass A), and the partials of |v|^2. The last block either writes beta_out (zero
// where done) and advances the state: div_prev = div_cur, div_cur = beta' > tol ?
// beta' : inf, beta = beta', done |= beta' < tol; or, in the finishing mode, writes
// only the rank's local sums[b].
template <typename T, bool kVec>
__global__ void __launch_bounds__(kStepThreads) lanczos_pass_b_kernel(const T* __restrict__ v_cur, T* w,
                                                                      real_t<T>* state, const real_t<T>* alpha_src,
                                                                      real_t<T>* partial, unsigned* ticket,
                                                                      real_t<T>* beta_out, real_t<T>* sums, int64_t nv,
                                                                      int64_t ld, int64_t lo, int64_t n, real_t<T> tol) {
    using R = real_t<T>;  // the state and the sums: real for complex blocks too
    constexpr int VL = Vec<T>::len;
    constexpr int kTile = kStepThreads * VL;
    __shared__ R div_s[kStepProbes], inv_s[kStepProbes], alpha_s[kStepProbes];
    const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kStepProbes;
    const int np = nv - b0 < kStepProbes ? static_cast<int>(nv - b0) : kStepProbes;
    if (threadIdx.x < np) {
        const R div = state[kDivCur * nv + b0 + threadIdx.x];
        div_s[threadIdx.x] = div;
        if constexpr (kCplx<T>) inv_s[threadIdx.x] = R(1) / div;  // a real quotient divides
        alpha_s[threadIdx.x] = alpha_src[b0 + threadIdx.x];
    }
    __syncthreads();
    R ss[kStepProbes];
#pragma unroll
    for (int p = 0; p < kStepProbes; ++p) ss[p] = R(0);
    const int64_t n_tiles = (n + kTile - 1) / kTile;
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int64_t r = t * kTile + threadIdx.x * VL;
        if (r >= n) continue;
#pragma unroll
        for (int p = 0; p < kStepProbes; ++p) {
            if (p >= np) break;
            const int64_t b = b0 + p;
            T wv[VL], vc[VL];
            load_seg<T, kVec>(w + b * ld + lo, r, -lo, ld - lo, wv);
            load_seg<T, kVec>(v_cur + b * ld + lo, r, -lo, ld - lo, vc);
            const R div = div_s[p], inv = inv_s[p], alpha = alpha_s[p];
#pragma unroll
            for (int i = 0; i < VL; ++i) {
                wv[i] = r + i < n ? minus_scaled(wv[i], alpha, quot(vc[i], div, inv)) : T(0);
                ss[p] += sq_abs(wv[i]);
            }
            store_seg<kVec>(w + b * ld + lo, r, n, wv);
        }
    }
    if (!reduce_and_take_ticket(ss, np, b0, partial, ticket)) return;
    for (int64_t b = threadIdx.x / 32; b < nv; b += kStepWarps) {
        const R s = probe_total(partial, b);
        if (threadIdx.x % 32 == 0) {
            if (sums != nullptr) {
                sums[b] = s;
            } else {
                const R beta = sqrt(s);
                const bool done = state[kDone * nv + b] != R(0);
                beta_out[b] = done ? R(0) : beta;
                state[kDivPrev * nv + b] = state[kDivCur * nv + b];
                state[kDivCur * nv + b] = beta > tol ? beta : R(INFINITY);
                state[kBeta * nv + b] = beta;
                state[kDone * nv + b] = (done || beta < tol) ? R(1) : R(0);
            }
        }
    }
    if (threadIdx.x == 0) *ticket = 0u;
}

// The step's finish on a row-sharded carry by itself, one thread a probe (advance_probe): for a sweep that
// reads the state between steps, and for the last step of a sweep. Every other step's finish runs in the
// kernel after the step's second all-reduce: pass A of the next step (float32 / float64) or B2 (bfloat16).
template <typename T>
__global__ void lanczos_advance_kernel(const T* __restrict__ sums, T* __restrict__ state, T* __restrict__ alpha_out,
                                       T* __restrict__ beta_out, int64_t nv, T tol) {
    const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (b < nv) advance_probe(sums, state, alpha_out, beta_out, nv, b, tol);
}

// ---- The rest of a bfloat16 step: the round pair (lanczos_dia_round) ----
//
// The bf16 sweep rounds q to bf16 every step (JAX's lanczos.py:388), so the unnormalised
// carry of pass B cannot serve it: q_next = bf16(v / beta') needs beta' = |v| before any
// element of it is written. After pass A (w = A q - beta q_prev and alpha, float32) two
// launches finish the step, each reading w (float32) and q (bf16) over the own rows and
// recomputing v = w - alpha q in float32 the same way:
//   B1 (norm): the partials of |v|^2; its last block (ticket) writes alpha_out and
//     beta_out (zero where a probe was done) and advances the state: div_prev = div_cur,
//     div_cur = beta' > tol ? beta' : inf, beta = beta', done |= beta' < tol. In the
//     finishing mode (sums given) it writes only the rank's sums, and the caller
//     all-reduces them for B2, which finishes the step.
//   B2 (write): q_next = bf16_rn(v / div_cur) over the own rows, zero in the margins. In the
//     finishing mode (sums given, after the all-reduce of B1's) every block takes alpha from
//     sums[0] and computes div_cur from sums[1] itself, and the first block of each probe group
//     writes the step's finish for its probes (advance_probe): so a row-sharded step takes three
//     launches, as the unsharded one.
// Neither reads what its own launch writes: B1's blocks read alpha (written by pass A or
// the all-reduce), B2's the state that B1's last block left behind, or in the finishing mode
// only the sums (its first blocks write state rows that no block of B2 reads).
// 6 bytes an element for B1, 8 for B2 (with pass A's 8: 22 a step, against float32's 24).

// v = w - alpha q for the rows r .. r + 7 of a carry row (zero past the own rows' end n):
// w as two 16-byte vectors of float32, q as one of bf16 (kVec), else element by element.
// The product is rounded before the difference (no FMA), as PyTorch's addcmul_ computes it
// in the step's plain version: fused, q_next moved by more than one bf16 ulp where the
// difference cancels (w close to alpha q).
template <bool kVec>
__device__ __forceinline__ void round_residual(const float* w_row, const bf16* q_row, int64_t r, int64_t lo_b,
                                               int64_t hi_b, int64_t n, float alpha, float (&v)[Vec<bf16>::len]) {
    constexpr int VF = Vec<float>::len;
    float wv[2][VF], q[Vec<bf16>::len];
    load_seg<float, kVec>(w_row, r, lo_b, hi_b, wv[0]);
    load_seg<float, kVec>(w_row, r + VF, lo_b, hi_b, wv[1]);
    load_seg<bf16, kVec>(q_row, r, lo_b, hi_b, q);
#pragma unroll
    for (int i = 0; i < Vec<bf16>::len; ++i) v[i] = r + i < n ? __fsub_rn(wv[i / VF][i % VF], __fmul_rn(alpha, q[i])) : 0.0f;
}

template <bool kVec>
__global__ void __launch_bounds__(kStepThreads) lanczos_round_norm_kernel(
    const float* __restrict__ w, const bf16* __restrict__ q, float* state, const float* alpha_src, float* partial,
    unsigned* ticket, float* alpha_out, float* beta_out, float* sums, int64_t nv, int64_t ld, int64_t lo, int64_t n,
    float tol) {
    constexpr int VL = Vec<bf16>::len;
    constexpr int kTile = kStepThreads * VL;
    __shared__ float alpha_s[kStepProbes];
    const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kStepProbes;
    const int np = nv - b0 < kStepProbes ? static_cast<int>(nv - b0) : kStepProbes;
    if (threadIdx.x < np) alpha_s[threadIdx.x] = alpha_src[b0 + threadIdx.x];
    __syncthreads();
    float ss[kStepProbes];
#pragma unroll
    for (int p = 0; p < kStepProbes; ++p) ss[p] = 0.0f;
    const int64_t n_tiles = (n + kTile - 1) / kTile;
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int64_t r = t * kTile + threadIdx.x * VL;
        if (r >= n) continue;
#pragma unroll
        for (int p = 0; p < kStepProbes; ++p) {
            if (p >= np) break;
            const int64_t b = b0 + p;
            float v[VL];
            round_residual<kVec>(w + b * ld + lo, q + b * ld + lo, r, -lo, ld - lo, n, alpha_s[p], v);
#pragma unroll
            for (int i = 0; i < VL; ++i) ss[p] += v[i] * v[i];
        }
    }
    if (!reduce_and_take_ticket(ss, np, b0, partial, ticket)) return;
    for (int64_t b = threadIdx.x / 32; b < nv; b += kStepWarps) {
        const float s = probe_total(partial, b);
        if (threadIdx.x % 32 == 0) {
            if (sums != nullptr) {
                sums[b] = s;
            } else {
                const float beta = sqrtf(s);
                const bool done = state[kDone * nv + b] != 0.0f;
                alpha_out[b] = done ? 0.0f : alpha_src[b];
                beta_out[b] = done ? 0.0f : beta;
                state[kDivPrev * nv + b] = state[kDivCur * nv + b];
                state[kDivCur * nv + b] = beta > tol ? beta : INFINITY;
                state[kBeta * nv + b] = beta;
                state[kDone * nv + b] = (done || beta < tol) ? 1.0f : 0.0f;
            }
        }
    }
    if (threadIdx.x == 0) *ticket = 0u;
}

template <bool kVec>
__global__ void __launch_bounds__(kStepThreads) lanczos_round_write_kernel(
    const float* __restrict__ w, const bf16* __restrict__ q, float* __restrict__ state, const float* __restrict__ sums,
    float* __restrict__ alpha_out, float* __restrict__ beta_out, bf16* __restrict__ q_next, int64_t nv, int64_t ld,
    int64_t lo, int64_t n, float tol) {
    constexpr int VL = Vec<bf16>::len;
    constexpr int kTile = kStepThreads * VL;
    __shared__ float alpha_s[kStepProbes], div_s[kStepProbes];
    const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kStepProbes;
    const int np = nv - b0 < kStepProbes ? static_cast<int>(nv - b0) : kStepProbes;
    if (threadIdx.x < np) {
        const int64_t b = b0 + threadIdx.x;
        if (sums != nullptr) {  // the finishing mode: the step's scalars from the reduced sums
            alpha_s[threadIdx.x] = sums[b];
            div_s[threadIdx.x] = guarded_divisor(sqrtf(sums[nv + b]), tol);
            if (blockIdx.x == 0) advance_probe(sums, state, alpha_out, beta_out, nv, b, tol);
        } else {
            alpha_s[threadIdx.x] = state[kAlpha * nv + b];
            div_s[threadIdx.x] = state[kDivCur * nv + b];
        }
    }
    if (blockIdx.x == 0 && ld > n) {  // the margins of q_next: zero
        for (int p = 0; p < np; ++p) {
            bf16* row = q_next + (b0 + p) * ld;
            for (int64_t c = threadIdx.x; c < lo; c += kStepThreads) row[c] = zero<bf16>();
            for (int64_t c = lo + n + threadIdx.x; c < ld; c += kStepThreads) row[c] = zero<bf16>();
        }
    }
    __syncthreads();
    const int64_t n_tiles = (n + kTile - 1) / kTile;
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int64_t r = t * kTile + threadIdx.x * VL;
        if (r >= n) continue;
#pragma unroll
        for (int p = 0; p < kStepProbes; ++p) {
            if (p >= np) break;
            const int64_t b = b0 + p;
            float v[VL];
            round_residual<kVec>(w + b * ld + lo, q + b * ld + lo, r, -lo, ld - lo, n, alpha_s[p], v);
            const float div = div_s[p];
#pragma unroll
            for (int i = 0; i < VL; ++i) v[i] = v[i] / div;  // 0 past n; 0 where div is inf (a done probe)
            bf16* row = q_next + b * ld + lo;
            if (kVec) {
                *reinterpret_cast<uint4*>(row + r) = pack(v);
            } else {
#pragma unroll
                for (int i = 0; i < VL; ++i) {
                    if (r + i < n) row[r + i] = __float2bfloat16_rn(v[i]);
                }
            }
        }
    }
}

// mid: an (nv, n) float32 scratch block, needed by bfloat16 with more diagonals than one chunk (kTChunk), ignored
// by the other types.
template <typename T>
cudaError_t launch_stencil_t(const T* bands, const int64_t* offsets, int n_d, const T* x, T* out, float* mid, int64_t nv,
                             int64_t n, int vec, cudaStream_t stream) {
    if (nv == 0 || n == 0) return cudaSuccess;
    if (kNarrow<T> && n_d > kTChunk && mid == nullptr) return cudaErrorInvalidValue;
    const int64_t blocks = (n + kTThreads * Vec<T>::len - 1) / (kTThreads * Vec<T>::len);  // a vector a thread
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const unsigned grid = static_cast<unsigned>(blocks);
    if constexpr (kNarrow<T>) {
        if (vec) {
            dia_stencil_t_bf16_kernel<true><<<grid, kTThreads, 0, stream>>>(bands, offsets, n_d, x, out, mid, nv, n);
        } else {
            dia_stencil_t_bf16_kernel<false><<<grid, kTThreads, 0, stream>>>(bands, offsets, n_d, x, out, mid, nv, n);
        }
    } else if (vec) {
        dia_stencil_t_kernel<T, true><<<grid, kTThreads, 0, stream>>>(bands, offsets, n_d, x, out, nv, n);
    } else {
        dia_stencil_t_kernel<T, false><<<grid, kTThreads, 0, stream>>>(bands, offsets, n_d, x, out, nv, n);
    }
    return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t launch_stencil_nm_as(const T* bands, const int64_t* offsets, int n_d, const T* V, T* out, int64_t n,
                                 int64_t k, cudaStream_t stream) {
    constexpr int VL = Vec<T>::len;
    const int64_t vecs = (k + VL - 1) / VL;  // 16-byte vectors of a row
    int lanes = 1;
    while (lanes < 32 && lanes < vecs) lanes *= 2;
    const int64_t rows = static_cast<int64_t>(kNmThreads / lanes) * kNmRows;  // rows of a block
    const int64_t bx = (n + rows - 1) / rows, by = (vecs + lanes - 1) / lanes;
    if (bx > 0x7fffffffLL || by > 65535) return cudaErrorInvalidConfiguration;
    const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
    dia_stencil_kernel<T, kVec><<<grid, kNmThreads, 0, stream>>>(bands, offsets, n_d, V, out, n, k, lanes);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stencil_nm(const T* bands, const int64_t* offsets, int n_d, const T* V, T* out, int64_t n,
                              int64_t k, int vec, cudaStream_t stream) {
    if (n == 0 || k == 0) return cudaSuccess;
    return vec ? launch_stencil_nm_as<T, true>(bands, offsets, n_d, V, out, n, k, stream)
               : launch_stencil_nm_as<T, false>(bands, offsets, n_d, V, out, n, k, stream);
}

// The pass A kernel of a carry of element type T: the register kernels for complex and bfloat16, else the staged one.
template <typename T, bool kVec>
auto pass_a_kernel() {
    if constexpr (kCplx<T>) {
        return lanczos_pass_a_kernel<T, kVec>;
    } else if constexpr (kNarrow<T>) {
        return lanczos_pass_a_bf16_kernel<kVec>;
    } else {
        return lanczos_pass_a_staged_kernel<T, kVec>;
    }
}

// Row-tile walkers per probe group of a step kernel's persistent grid: enough blocks to fill every SM at the kernel's
// occupancy, at most one per row tile of vl-element vectors.
template <typename K>
int64_t grid_blocks(K kernel, int64_t nv, int64_t n, int vl) {
    int dev = 0, sms = 0, occ = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kStepThreads, 0) != cudaSuccess) {
        return -1;
    }
    const int64_t groups = (nv + kStepProbes - 1) / kStepProbes;
    const int64_t tiles = (n + kStepThreads * vl - 1) / (kStepThreads * vl);
    int64_t gx = static_cast<int64_t>(sms) * (occ > 0 ? occ : 1) / (groups > 0 ? groups : 1);
    if (gx > tiles) gx = tiles;
    return gx > 0 ? gx : 1;
}

// The grid of both passes at the pass-A kernel's occupancy.
template <typename T>
int64_t step_blocks(int64_t nv, int64_t n) {
    return grid_blocks(pass_a_kernel<T, true>(), nv, n, Vec<T>::len);
}

inline bool step_grid_ok(int64_t nv, int64_t ld, int64_t lo, int64_t n, int64_t gx) {
    return nv > 0 && n > 0 && lo >= 0 && ld >= lo + n && gx > 0 && gx <= 0x7fffffffLL &&
           (nv + kStepProbes - 1) / kStepProbes <= 65535;
}

// pend: a row-sharded step's finish for pass A to run (float32 / float64, in the finishing mode), or none.
template <typename T, typename A = acc_t<T>, typename R = real_t<A>>
cudaError_t launch_pass_a(const T* bands, const int64_t* offsets, int n_d, const T* v_cur, const T* v_prev, R* state,
                          A* w, R* partial, unsigned* ticket, R* alpha_out, R* sums, int64_t nv, int64_t ld, int64_t lo,
                          int64_t n, int64_t gx, int round, int vec, cudaStream_t stream, Pending<R> pend = {}) {
    if (!step_grid_ok(nv, ld, lo, n, gx)) return cudaErrorInvalidConfiguration;
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>((nv + kStepProbes - 1) / kStepProbes));
    auto kern = vec ? pass_a_kernel<T, true>() : pass_a_kernel<T, false>();
    if constexpr (kCplx<T> || kNarrow<T>) {
        if (pend.sums != nullptr) return cudaErrorInvalidValue;  // only the staged kernel runs a pending finish
        kern<<<grid, kStepThreads, 0, stream>>>(bands, offsets, n_d, v_cur, v_prev, state, w, partial, ticket, alpha_out,
                                                sums, nv, ld, lo, n, round);
    } else {
        if (pend.sums != nullptr && (ticket == nullptr || sums == nullptr || pend.alpha_out == nullptr || pend.beta_out == nullptr))
            return cudaErrorInvalidValue;
        kern<<<grid, kStepThreads, 0, stream>>>(bands, offsets, n_d, v_cur, v_prev, state, w, partial, ticket, alpha_out,
                                                sums, nv, ld, lo, n, pend);
    }
    return cudaGetLastError();
}

template <typename T, typename R = real_t<T>>
cudaError_t launch_pass_b(const T* v_cur, T* w, R* state, const R* alpha_src, R* partial, unsigned* ticket, R* beta_out,
                          R* sums, int64_t nv, int64_t ld, int64_t lo, int64_t n, double tol, int64_t gx, int vec,
                          cudaStream_t stream) {
    if (!step_grid_ok(nv, ld, lo, n, gx)) return cudaErrorInvalidConfiguration;
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>((nv + kStepProbes - 1) / kStepProbes));
    if (vec) {
        lanczos_pass_b_kernel<T, true><<<grid, kStepThreads, 0, stream>>>(v_cur, w, state, alpha_src, partial, ticket,
                                                                          beta_out, sums, nv, ld, lo, n, static_cast<R>(tol));
    } else {
        lanczos_pass_b_kernel<T, false><<<grid, kStepThreads, 0, stream>>>(v_cur, w, state, alpha_src, partial, ticket,
                                                                           beta_out, sums, nv, ld, lo, n, static_cast<R>(tol));
    }
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_advance(const T* sums, T* state, T* alpha_out, T* beta_out, int64_t nv, double tol,
                           cudaStream_t stream) {
    if (nv <= 0) return cudaErrorInvalidConfiguration;
    constexpr int kThreads = 128;
    const int64_t blocks = (nv + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    lanczos_advance_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(sums, state, alpha_out, beta_out,
                                                                                     nv, static_cast<T>(tol));
    return cudaGetLastError();
}

inline dim3 step_grid(int64_t nv, int64_t gx) {
    return dim3(static_cast<unsigned>(gx), static_cast<unsigned>((nv + kStepProbes - 1) / kStepProbes));
}

cudaError_t launch_round_norm(const float* w, const bf16* q, float* state, const float* alpha_src, float* partial,
                              unsigned* ticket, float* alpha_out, float* beta_out, float* sums, int64_t nv, int64_t ld,
                              int64_t lo, int64_t n, double tol, int64_t gx, int vec, cudaStream_t stream) {
    if (!step_grid_ok(nv, ld, lo, n, gx) || ticket == nullptr || (sums == nullptr && (alpha_out == nullptr || beta_out == nullptr)))
        return cudaErrorInvalidConfiguration;
    const float t = static_cast<float>(tol);
    if (vec) {
        lanczos_round_norm_kernel<true><<<step_grid(nv, gx), kStepThreads, 0, stream>>>(
            w, q, state, alpha_src, partial, ticket, alpha_out, beta_out, sums, nv, ld, lo, n, t);
    } else {
        lanczos_round_norm_kernel<false><<<step_grid(nv, gx), kStepThreads, 0, stream>>>(
            w, q, state, alpha_src, partial, ticket, alpha_out, beta_out, sums, nv, ld, lo, n, t);
    }
    return cudaGetLastError();
}

cudaError_t launch_round_write(const float* w, const bf16* q, float* state, const float* sums, float* alpha_out,
                               float* beta_out, bf16* q_next, int64_t nv, int64_t ld, int64_t lo, int64_t n, double tol,
                               int64_t gx, int vec, cudaStream_t stream) {
    if (!step_grid_ok(nv, ld, lo, n, gx) || (sums != nullptr && (alpha_out == nullptr || beta_out == nullptr)))
        return cudaErrorInvalidConfiguration;
    const float t = static_cast<float>(tol);
    if (vec) {
        lanczos_round_write_kernel<true><<<step_grid(nv, gx), kStepThreads, 0, stream>>>(w, q, state, sums, alpha_out,
                                                                                        beta_out, q_next, nv, ld, lo, n, t);
    } else {
        lanczos_round_write_kernel<false><<<step_grid(nv, gx), kStepThreads, 0, stream>>>(w, q, state, sums, alpha_out,
                                                                                         beta_out, q_next, nv, ld, lo, n, t);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Columns of the (nv, columns) partials buffer that both step passes fill, and the
// gridDim.x to launch them with, for a carry of elem_bytes-byte elements (cplx: complex);
// -1 if the device cannot be queried.
int64_t lanczos_step_blocks(int64_t nv, int64_t n, int elem_bytes, int cplx) {
    if (cplx) return elem_bytes == 16 ? step_blocks<c128>(nv, n) : step_blocks<c64>(nv, n);
    return elem_bytes == 8 ? step_blocks<double>(nv, n) : elem_bytes == 2 ? step_blocks<bf16>(nv, n) : step_blocks<float>(nv, n);
}

// The same for the bfloat16 round pair (lanczos_dia_round), at B1's occupancy: its own grid, whatever pass A's is.
int64_t lanczos_round_blocks(int64_t nv, int64_t n) {
    return grid_blocks(lanczos_round_norm_kernel<true>, nv, n, Vec<bf16>::len);
}

const char* primate_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// The probe-major stencil; mid is the float32 scratch of a bfloat16 call with more
// than 8 diagonals (null otherwise, and ignored by the other types).
cudaError_t dia_stencil_t_f32(const float* bands, const int64_t* offsets, int n_d, const float* x, float* out,
                              void* mid, int64_t nv, int64_t n, int vec, cudaStream_t stream) {
    return launch_stencil_t(bands, offsets, n_d, x, out, static_cast<float*>(mid), nv, n, vec, stream);
}

cudaError_t dia_stencil_t_f64(const double* bands, const int64_t* offsets, int n_d, const double* x, double* out,
                              void* mid, int64_t nv, int64_t n, int vec, cudaStream_t stream) {
    return launch_stencil_t(bands, offsets, n_d, x, out, static_cast<float*>(mid), nv, n, vec, stream);
}

cudaError_t dia_stencil_t_bf16(const void* bands, const int64_t* offsets, int n_d, const void* x, void* out, void* mid,
                               int64_t nv, int64_t n, int vec, cudaStream_t stream) {
    return launch_stencil_t(static_cast<const bf16*>(bands), offsets, n_d, static_cast<const bf16*>(x),
                            static_cast<bf16*>(out), static_cast<float*>(mid), nv, n, vec, stream);
}

// Complex instantiations of the two stencils (complex64 / complex128 as torch
// lays them out), for Hermitian operators; the step passes' are below.
cudaError_t dia_stencil_t_c64(const void* bands, const int64_t* offsets, int n_d, const void* x, void* out, void* mid,
                              int64_t nv, int64_t n, int vec, cudaStream_t stream) {
    return launch_stencil_t(static_cast<const c64*>(bands), offsets, n_d, static_cast<const c64*>(x),
                            static_cast<c64*>(out), static_cast<float*>(mid), nv, n, vec, stream);
}

cudaError_t dia_stencil_t_c128(const void* bands, const int64_t* offsets, int n_d, const void* x, void* out, void* mid,
                               int64_t nv, int64_t n, int vec, cudaStream_t stream) {
    return launch_stencil_t(static_cast<const c128*>(bands), offsets, n_d, static_cast<const c128*>(x),
                            static_cast<c128*>(out), static_cast<float*>(mid), nv, n, vec, stream);
}

cudaError_t dia_stencil_c64(const void* bands, const int64_t* offsets, int n_d, const void* V, void* out, int64_t n,
                            int64_t k, int vec, cudaStream_t stream) {
    return launch_stencil_nm(static_cast<const c64*>(bands), offsets, n_d, static_cast<const c64*>(V),
                             static_cast<c64*>(out), n, k, vec, stream);
}

cudaError_t dia_stencil_c128(const void* bands, const int64_t* offsets, int n_d, const void* V, void* out, int64_t n,
                             int64_t k, int vec, cudaStream_t stream) {
    return launch_stencil_nm(static_cast<const c128*>(bands), offsets, n_d, static_cast<const c128*>(V),
                             static_cast<c128*>(out), n, k, vec, stream);
}

cudaError_t dia_stencil_f32(const float* bands, const int64_t* offsets, int n_d, const float* V, float* out,
                            int64_t n, int64_t k, int vec, cudaStream_t stream) {
    return launch_stencil_nm(bands, offsets, n_d, V, out, n, k, vec, stream);
}

cudaError_t dia_stencil_f64(const double* bands, const int64_t* offsets, int n_d, const double* V, double* out,
                            int64_t n, int64_t k, int vec, cudaStream_t stream) {
    return launch_stencil_nm(bands, offsets, n_d, V, out, n, k, vec, stream);
}

cudaError_t dia_stencil_bf16(const void* bands, const int64_t* offsets, int n_d, const void* V, void* out, int64_t n,
                             int64_t k, int vec, cudaStream_t stream) {
    return launch_stencil_nm(static_cast<const bf16*>(bands), offsets, n_d, static_cast<const bf16*>(V),
                             static_cast<bf16*>(out), n, k, vec, stream);
}

// The step passes on a carry of row stride ld with its own rows at [lo, lo + n) (the flat
// carry: ld = n, lo = 0); sums (nv,) non-null selects the finishing mode (the rank's local
// sum of each probe, for an all-reduce; the step's finish then runs in a later kernel). Pass A's round: round the
// stencil sum to the carry's dtype before the beta-axpy (only bfloat16 rounds).
cudaError_t lanczos_dia_step_f32(const float* bands, const int64_t* offsets, int n_d, const float* v_cur,
                                 const float* v_prev, float* state, float* w, float* partial, unsigned* ticket,
                                 float* alpha_out, float* sums, int64_t nv, int64_t ld, int64_t lo, int64_t n,
                                 int64_t gx, int round, int vec, cudaStream_t stream) {
    return launch_pass_a(bands, offsets, n_d, v_cur, v_prev, state, w, partial, ticket, alpha_out, sums, nv, ld, lo, n,
                         gx, round, vec, stream);
}

cudaError_t lanczos_dia_step_f64(const double* bands, const int64_t* offsets, int n_d, const double* v_cur,
                                 const double* v_prev, double* state, double* w, double* partial, unsigned* ticket,
                                 double* alpha_out, double* sums, int64_t nv, int64_t ld, int64_t lo, int64_t n,
                                 int64_t gx, int round, int vec, cudaStream_t stream) {
    return launch_pass_a(bands, offsets, n_d, v_cur, v_prev, state, w, partial, ticket, alpha_out, sums, nv, ld, lo, n,
                         gx, round, vec, stream);
}

// bfloat16 bands and carries; the state, w, the partials and the sums in float32.
cudaError_t lanczos_dia_step_bf16(const void* bands, const int64_t* offsets, int n_d, const void* v_cur,
                                  const void* v_prev, float* state, float* w, float* partial, unsigned* ticket,
                                  float* alpha_out, float* sums, int64_t nv, int64_t ld, int64_t lo, int64_t n,
                                  int64_t gx, int round, int vec, cudaStream_t stream) {
    return launch_pass_a(static_cast<const bf16*>(bands), offsets, n_d, static_cast<const bf16*>(v_cur),
                         static_cast<const bf16*>(v_prev), state, w, partial, ticket, alpha_out, sums, nv, ld, lo, n, gx,
                         round, vec, stream);
}

// Pass A of a row-sharded step in the finishing mode (sums non-null) that first runs the pending finish
// of the step before from its reduced sums pend_sums (2, nv): each block takes its divisors and beta from
// it, and the last block writes it to the state, pend_alpha_out and pend_beta_out (see Pending).
cudaError_t lanczos_dia_step_finish_f32(const float* bands, const int64_t* offsets, int n_d, const float* v_cur,
                                        const float* v_prev, float* state, float* w, float* partial, unsigned* ticket,
                                        float* sums, const float* pend_sums, float* pend_alpha_out, float* pend_beta_out,
                                        double tol, int64_t nv, int64_t ld, int64_t lo, int64_t n, int64_t gx, int vec,
                                        cudaStream_t stream) {
    if (pend_sums == nullptr) return cudaErrorInvalidValue;
    return launch_pass_a(bands, offsets, n_d, v_cur, v_prev, state, w, partial, ticket, static_cast<float*>(nullptr), sums, nv, ld,
                         lo, n, gx, 0, vec, stream, Pending<float>{pend_sums, pend_alpha_out, pend_beta_out, static_cast<float>(tol)});
}

cudaError_t lanczos_dia_step_finish_f64(const double* bands, const int64_t* offsets, int n_d, const double* v_cur,
                                        const double* v_prev, double* state, double* w, double* partial, unsigned* ticket,
                                        double* sums, const double* pend_sums, double* pend_alpha_out,
                                        double* pend_beta_out, double tol, int64_t nv, int64_t ld, int64_t lo, int64_t n,
                                        int64_t gx, int vec, cudaStream_t stream) {
    if (pend_sums == nullptr) return cudaErrorInvalidValue;
    return launch_pass_a(bands, offsets, n_d, v_cur, v_prev, state, w, partial, ticket, static_cast<double*>(nullptr), sums, nv, ld,
                         lo, n, gx, 0, vec, stream, Pending<double>{pend_sums, pend_alpha_out, pend_beta_out, tol});
}

cudaError_t lanczos_dia_residual_f32(const float* v_cur, float* w, float* state, const float* alpha_src,
                                     float* partial, unsigned* ticket, float* beta_out, float* sums, int64_t nv,
                                     int64_t ld, int64_t lo, int64_t n, double tol, int64_t gx, int vec,
                                     cudaStream_t stream) {
    return launch_pass_b(v_cur, w, state, alpha_src, partial, ticket, beta_out, sums, nv, ld, lo, n, tol, gx, vec,
                         stream);
}

cudaError_t lanczos_dia_residual_f64(const double* v_cur, double* w, double* state, const double* alpha_src,
                                     double* partial, unsigned* ticket, double* beta_out, double* sums, int64_t nv,
                                     int64_t ld, int64_t lo, int64_t n, double tol, int64_t gx, int vec,
                                     cudaStream_t stream) {
    return launch_pass_b(v_cur, w, state, alpha_src, partial, ticket, beta_out, sums, nv, ld, lo, n, tol, gx, vec,
                         stream);
}

// Complex64 / complex128 carries and bands (Hermitian operators): w complex, the state, the
// partials, alpha_src, the outputs and the sums real (float32 / float64). Pass A's round has no
// effect; alpha = Re sum conj(q) w.
cudaError_t lanczos_dia_step_c64(const void* bands, const int64_t* offsets, int n_d, const void* v_cur, const void* v_prev,
                                 float* state, void* w, float* partial, unsigned* ticket, float* alpha_out, float* sums,
                                 int64_t nv, int64_t ld, int64_t lo, int64_t n, int64_t gx, int round, int vec,
                                 cudaStream_t stream) {
    return launch_pass_a(static_cast<const c64*>(bands), offsets, n_d, static_cast<const c64*>(v_cur),
                         static_cast<const c64*>(v_prev), state, static_cast<c64*>(w), partial, ticket, alpha_out, sums, nv,
                         ld, lo, n, gx, round, vec, stream);
}

cudaError_t lanczos_dia_step_c128(const void* bands, const int64_t* offsets, int n_d, const void* v_cur,
                                  const void* v_prev, double* state, void* w, double* partial, unsigned* ticket,
                                  double* alpha_out, double* sums, int64_t nv, int64_t ld, int64_t lo, int64_t n,
                                  int64_t gx, int round, int vec, cudaStream_t stream) {
    return launch_pass_a(static_cast<const c128*>(bands), offsets, n_d, static_cast<const c128*>(v_cur),
                         static_cast<const c128*>(v_prev), state, static_cast<c128*>(w), partial, ticket, alpha_out, sums,
                         nv, ld, lo, n, gx, round, vec, stream);
}

cudaError_t lanczos_dia_residual_c64(const void* v_cur, void* w, float* state, const float* alpha_src, float* partial,
                                     unsigned* ticket, float* beta_out, float* sums, int64_t nv, int64_t ld, int64_t lo,
                                     int64_t n, double tol, int64_t gx, int vec, cudaStream_t stream) {
    return launch_pass_b(static_cast<const c64*>(v_cur), static_cast<c64*>(w), state, alpha_src, partial, ticket, beta_out,
                         sums, nv, ld, lo, n, tol, gx, vec, stream);
}

cudaError_t lanczos_dia_residual_c128(const void* v_cur, void* w, double* state, const double* alpha_src,
                                      double* partial, unsigned* ticket, double* beta_out, double* sums, int64_t nv,
                                      int64_t ld, int64_t lo, int64_t n, double tol, int64_t gx, int vec,
                                      cudaStream_t stream) {
    return launch_pass_b(static_cast<const c128*>(v_cur), static_cast<c128*>(w), state, alpha_src, partial, ticket,
                         beta_out, sums, nv, ld, lo, n, tol, gx, vec, stream);
}

// The round pair of a bfloat16 step (after pass A): w, the state, alpha_src, the partials, the
// outputs and the sums in float32, q and q_next bf16 on the carry (ld, lo, n). B1 (norm) with
// sums (nv,) non-null writes the rank's sums of |v|^2 (the finishing mode); else its last block
// writes alpha_out, beta_out and the state. B2 (write) reads alpha and the divisor from the state,
// or, with sums (2, nv) non-null (the finishing mode, after the all-reduce), from the sums, and
// writes the step's finish (the state, alpha_out, beta_out) beside q_next.
cudaError_t lanczos_dia_round_norm_bf16(const float* w, const void* q, float* state, const float* alpha_src,
                                        float* partial, unsigned* ticket, float* alpha_out, float* beta_out, float* sums,
                                        int64_t nv, int64_t ld, int64_t lo, int64_t n, double tol, int64_t gx, int vec,
                                        cudaStream_t stream) {
    return launch_round_norm(w, static_cast<const bf16*>(q), state, alpha_src, partial, ticket, alpha_out, beta_out, sums,
                             nv, ld, lo, n, tol, gx, vec, stream);
}

cudaError_t lanczos_dia_round_write_bf16(const float* w, const void* q, float* state, const float* sums, float* alpha_out,
                                         float* beta_out, void* q_next, int64_t nv, int64_t ld, int64_t lo, int64_t n,
                                         double tol, int64_t gx, int vec, cudaStream_t stream) {
    return launch_round_write(w, static_cast<const bf16*>(q), state, sums, alpha_out, beta_out, static_cast<bf16*>(q_next), nv,
                              ld, lo, n, tol, gx, vec, stream);
}

cudaError_t lanczos_dia_advance_f32(const float* sums, float* state, float* alpha_out, float* beta_out, int64_t nv,
                                    double tol, cudaStream_t stream) {
    return launch_advance(sums, state, alpha_out, beta_out, nv, tol, stream);
}

cudaError_t lanczos_dia_advance_f64(const double* sums, double* state, double* alpha_out, double* beta_out, int64_t nv,
                                    double tol, cudaStream_t stream) {
    return launch_advance(sums, state, alpha_out, beta_out, nv, tol, stream);
}

}  // extern "C"
