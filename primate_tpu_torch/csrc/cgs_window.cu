// The CGS window of the re-orthogonalised Lanczos step for Hopper (sm_90a): the step's tail after pass A,
// as a chain of streaming kernels, float32, float64, complex64 and complex128 carries, with windows stored in
// the carry's dtype, another width, or bfloat16 or float16 (basis_dtype; summed in float32).
//
// Replaces no Pallas kernel: the JAX package writes this window as broadcasts and sums that XLA fuses
// (primate_tpu/lanczos.py:294-301, _cgs_window). Eagerly, PyTorch ran the same broadcasts as they are written:
// each pass formed two (ncv, nv, n) temporaries (Q^H * v, then Q * proj) and summed them, about 35 block
// reads and writes a pass where the least is the valid slots and v once, and the temporaries held as much
// device memory as the window itself.
//
// The tail (ops/cgs.py, cgs_window_ref, the PyTorch ops it replaces on the card):
//   v -= alpha q_cur;  reorth_passes times { proj = Q^H v over the valid slots;  v -= Q proj };  |v|^2
// The chain at r passes: r + 1 kernels over row tiles x probes, each reading v and the valid slots once:
//   K1        v -= alpha q (q taken from the window's slot j % ncv where it holds q_cur exactly), the dots of pass 1
//   K2 .. Kr  v -= Q proj_{i-1} and, in the same read of Q, the dots of pass i on the updated v
//   K(r+1)    v -= Q proj_r and the sums of |v|^2 that beta needs
// Between kernels the sums go through the caller's reduce (the identity, or an all-reduce on a row-sharded
// carry). A launch takes at most kHold slots, given as a bitmask by age: bit b is the slot top - b (mod ncv), so
// a window's valid slots, the newest orth of them, are the low bits from the newest (top = j % ncv), and q_cur's
// slot, where the chain takes q_cur from the window, is the first held one. A window with more valid slots (a long
// full window, selective re-orthogonalisation) splits each kernel into launches of kHold slots, the update and the
// dots then in separate launches (ops/cgs.py plans them).
//
// Rounding: the alpha step rounds the product before the difference, as addcmul_ does on the card (never an
// FMA), so v equals PyTorch's bit for bit there. The update sums the rounded slot products in slot order in
// promote(carry, window) and rounds the difference to the carry's dtype, as PyTorch's sub_ of the slot sum does;
// the projections are rounded to the carry's dtype first, as proj.to(acc) is. The dots and |v|^2 are sums in
// another order than PyTorch's, so they agree to a tolerance (tests/test_torch_cuda_kernels.py states it); the
// sums across blocks are finished by the last block in a fixed order (no floating-point atomics), so two runs
// give the same bits.
//
// Bound: HBM bytes. At 64 probes x 10M rows float32 a block is 2.56 GB and the window of 5 slots 12.8 GB,
// against a few flops a loaded element. Each thread takes one 16-byte vector of rows (or 8 rows where the
// window or q is bfloat16) of one probe, loads the launch's slots into registers once, and uses them for the
// update and the dots; blockIdx.y walks the probes, blockIdx.x is a persistent walker over row tiles. Rows are
// read at the carry's row stride, so the padded carry's rows need no copy. Where a length, a stride or a
// pointer rules out 16-byte accesses the same kernel takes element loads (kVec false).
//
// Plain C interface: every entry point returns the cudaError_t of its launch; the kernels launch on the
// caller's stream, allocate nothing and do not synchronise.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace {

// float16 windows (a real sweep's basis_dtype): held as float32, as bfloat16 is; 8 values a 16-byte vector, in
// a vector type of their own so that their unpacking is not bfloat16's.
using f16 = __half;
struct alignas(16) Half8 {
    __half2 h[4];
};
template <> struct Acc<f16> { using type = float; };
template <> struct Vec<f16> { using type = Half8; static constexpr int len = 8; };
__device__ __forceinline__ float to_acc(f16 v) { return __half2float(v); }
__device__ __forceinline__ void unpack(const Half8& v, float (&o)[8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __half22float2(v.h[i]);
        o[2 * i] = f.x;
        o[2 * i + 1] = f.y;
    }
}
// A 16-byte vector through the read-only cache.
template <typename V>
__device__ __forceinline__ V ldg_vec(const V* p) { return __ldg(p); }
template <>
__device__ __forceinline__ Half8 ldg_vec<Half8>(const Half8* p) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    Half8 v;
    static_assert(sizeof(Half8) == sizeof(uint4), "a 16-byte vector");
    memcpy(&v, &u, sizeof(v));
    return v;
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHold = 8;               // slots a launch takes (ops/cgs.py's KHOLD)
constexpr int kSums = 2 * kHold + 1;   // real sums a probe at most: complex dots and |v|^2

// Conversions between the accumulation types (bfloat16 is converted to float32 as it is loaded).
template <typename To> struct Cvt;
template <> struct Cvt<float> {
    __device__ static float f(float x) { return x; }
    __device__ static float f(double x) { return static_cast<float>(x); }
};
template <> struct Cvt<double> {
    __device__ static double f(float x) { return x; }
    __device__ static double f(double x) { return x; }
};
template <typename R> struct Cvt<Cplx<R>> {
    template <typename S>
    __device__ static Cplx<R> f(Cplx<S> x) { return Cplx<R>(static_cast<R>(x.re), static_cast<R>(x.im)); }
};
template <typename To, typename From>
__device__ __forceinline__ To cvt(From x) { return Cvt<To>::f(x); }

// The type the window's products and sums are taken in: promote(carry, window), where bfloat16 and float16
// count as narrower than either.
template <typename T, typename W>
using wide_t = std::conditional_t<(sizeof(real_t<W>) > sizeof(real_t<T>)), W, T>;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// x - a y, a real: the product rounded, then the difference (addcmul_ with value -1).
template <typename R>
__device__ __forceinline__ R minus_scaled(R x, R a, R y) { return sub_rn(x, mul_rn(a, y)); }
template <typename R>
__device__ __forceinline__ Cplx<R> minus_scaled(Cplx<R> x, R a, Cplx<R> y) {
    return Cplx<R>(sub_rn(x.re, mul_rn(a, y.re)), sub_rn(x.im, mul_rn(a, y.im)));
}
// A slot's product Q p of the update, rounded as a product tensor is; the sum of two; a difference.
template <typename R>
__device__ __forceinline__ R prod(R q, R p) { return mul_rn(q, p); }
template <typename R>
__device__ __forceinline__ Cplx<R> prod(Cplx<R> q, Cplx<R> p) { return q * p; }
template <typename R>
__device__ __forceinline__ R plus(R a, R b) { return add_rn(a, b); }
template <typename R>
__device__ __forceinline__ Cplx<R> plus(Cplx<R> a, Cplx<R> b) { return Cplx<R>(add_rn(a.re, b.re), add_rn(a.im, b.im)); }
template <typename R>
__device__ __forceinline__ R minus(R a, R b) { return sub_rn(a, b); }
template <typename R>
__device__ __forceinline__ Cplx<R> minus(Cplx<R> a, Cplx<R> b) { return Cplx<R>(sub_rn(a.re, b.re), sub_rn(a.im, b.im)); }
// d += conj(q) x (the bra conjugated).
template <typename R>
__device__ __forceinline__ void dot_add(R& d, R q, R x) { d += q * x; }
template <typename R>
__device__ __forceinline__ void dot_add(Cplx<R>& d, Cplx<R> q, Cplx<R> x) {
    d.re += q.re * x.re + q.im * x.im;
    d.im += q.re * x.im - q.im * x.re;
}
template <typename R>
__device__ __forceinline__ R sq_abs(R x) { return x * x; }
template <typename R>
__device__ __forceinline__ R sq_abs(Cplx<R> x) { return x.re * x.re + x.im * x.im; }
template <typename R>
__device__ __forceinline__ R part(R x, int) { return x; }
template <typename R>
__device__ __forceinline__ R part(Cplx<R> x, int k) { return k == 0 ? x.re : x.im; }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
    return v;
}

// E elements of a row of X at r, converted to To; kVec: whole 16-byte vectors (read-only loads where kNc),
// else element loads, those at or past n reading 0.
template <typename X, typename To, int E, bool kVec, bool kNc>
__device__ __forceinline__ void load_as(const X* row, int64_t r, int64_t n, To (&o)[E]) {
    constexpr int VL = Vec<X>::len;
    static_assert(E % VL == 0, "a thread's rows are whole vectors of each type");
    if constexpr (kVec) {
        using V = typename Vec<X>::type;
#pragma unroll
        for (int h = 0; h < E / VL; ++h) {
            const V* p = reinterpret_cast<const V*>(row + r + h * VL);
            acc_t<X> e[VL];
            if constexpr (kNc) {
                unpack(ldg_vec(p), e);
            } else {
                unpack(*p, e);
            }
#pragma unroll
            for (int i = 0; i < VL; ++i) o[h * VL + i] = cvt<To>(e[i]);
        }
    } else {
#pragma unroll
        for (int i = 0; i < E; ++i) o[i] = r + i < n ? cvt<To>(to_acc(row[r + i])) : To(0);
    }
}

template <typename T, int E, bool kVec>
__device__ __forceinline__ void store_as(T* row, int64_t r, int64_t n, const T (&o)[E]) {
    constexpr int VL = Vec<T>::len;
    if constexpr (kVec) {
#pragma unroll
        for (int h = 0; h < E / VL; ++h) {
            T e[VL];
#pragma unroll
            for (int i = 0; i < VL; ++i) e[i] = o[h * VL + i];
            *reinterpret_cast<typename Vec<T>::type*>(row + r + h * VL) = pack(e);
        }
    } else {
#pragma unroll
        for (int i = 0; i < E; ++i) {
            if (r + i < n) row[r + i] = o[i];
        }
    }
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// One launch of the chain. The carry's rows v (probe p's at v + p ld_v) are updated in place where alpha or
// proj_in is given. T the carry's type, W the window's, Q q_cur's; C = promote(T, W).
template <typename T, typename W, typename Q>
struct Args {
    using R = real_t<T>;
    using C = wide_t<T, W>;
    T* v;
    int64_t ld_v;
    const Q* q;            // q_cur's rows (probe p's at q + p ld_q), or null: q is the first held slot, or no alpha step
    int64_t ld_q;
    const R* alpha;        // (nv,): v -= alpha q first; null: no alpha step
    const W* win;          // the window (ncv, nv, n): slot s of probe p at win + (s nv + p) n
    uint64_t mask;         // the launch's slots by age: bit b is slot top - b (mod ncv), at most kHold bits
    int64_t top;
    int64_t ncv;
    const C* proj_in;      // (ncv, nv): v -= sum_s Q[s] proj_in[s] over the slots; null: no update
    C* proj_out;           // (ncv, nv): the dots sum_r conj(Q[s]) v over the slots, on the updated v; null: none
    R* sq_out;             // (nv,): sum_r |v|^2 of the updated v; null: none
    real_t<C>* partial;    // (nv, kSums, gridDim.x) the blocks' sums, in C's real type
    unsigned* ticket;      // 0 between launches; finds the last block
    int64_t nv;
    int64_t n;
};

template <typename T, typename W, typename Q>
constexpr int kElems = cmax(Vec<T>::len, cmax(Vec<W>::len, Vec<Q>::len));

// The window slot of age bit b of a launch: top - b (mod ncv).
template <typename A>
__device__ __forceinline__ int64_t slot_of(const A& a, int b) {
    const int64_t s = a.top - b;
    return s < 0 ? s + a.ncv : s;
}

template <typename T, typename W, typename Q, bool kVec>
__global__ void __launch_bounds__(kThreads) cgs_window_kernel(const Args<T, W, Q> a) {
    using R = real_t<T>;
    using C = wide_t<T, W>;
    using RC = real_t<C>;  // the sums' type: the dots are taken in C, |v|^2 in R and summed in RC
    using H = acc_t<W>;    // a held window element: bfloat16 held as float32
    constexpr int E = kElems<T, W, Q>;
    constexpr int kTile = kThreads * E;
    constexpr int kParts = kCplx<C> ? 2 : 1;
    __shared__ RC red[kSums][kWarps];
    __shared__ bool last;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // The launch's slots, newest first, as offsets into the window.
    const int64_t nvn = a.nv * a.n;
    int64_t off[kHold];
    const int S = __popcll(a.mask);
    {
        uint64_t m = a.mask;
#pragma unroll
        for (int k = 0; k < kHold; ++k) {
            off[k] = m ? slot_of(a, __ffsll(static_cast<long long>(m)) - 1) * nvn : 0;
            m &= m - 1;
        }
    }
    const bool alpha = a.alpha != nullptr, upd = a.proj_in != nullptr && S > 0, dots = a.proj_out != nullptr;
    const bool norm = a.sq_out != nullptr, write = alpha || upd;
    const int n_sums = (dots ? S * kParts : 0) + (norm ? 1 : 0);
    const int64_t n_tiles = (a.n + kTile - 1) / kTile;
    for (int64_t p = blockIdx.y; p < a.nv; p += gridDim.y) {
        T* vp = a.v + p * a.ld_v;
        const Q* qp = a.q != nullptr ? a.q + p * a.ld_q : nullptr;
        const W* wp = a.win + p * a.n;
        const R ap = alpha ? a.alpha[p] : R(0);
        C pu[kHold], dot[kHold];
#pragma unroll
        for (int k = 0; k < kHold; ++k) {
            pu[k] = upd && k < S ? cvt<C>(cvt<T>(a.proj_in[off[k] / nvn * a.nv + p])) : C(0);
            dot[k] = C(0);
        }
        R ss = R(0);
        for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
            const int64_t r = t * kTile + threadIdx.x * E;
            if (r < a.n) {
                H held[kHold][E];
#pragma unroll
                for (int k = 0; k < kHold; ++k) {
                    if (k < S) load_as<W, H, E, kVec, true>(wp + off[k], r, a.n, held[k]);
                }
                T x[E];
                load_as<T, T, E, kVec, false>(vp, r, a.n, x);
                if (alpha) {
                    T qv[E];
                    if (qp != nullptr) {
                        load_as<Q, T, E, kVec, true>(qp, r, a.n, qv);
                    } else {
#pragma unroll
                        for (int i = 0; i < E; ++i) qv[i] = cvt<T>(held[0][i]);
                    }
#pragma unroll
                    for (int i = 0; i < E; ++i) x[i] = minus_scaled(x[i], ap, qv[i]);
                }
                if (upd) {
#pragma unroll
                    for (int i = 0; i < E; ++i) {
                        C s = prod(cvt<C>(held[0][i]), pu[0]);
#pragma unroll
                        for (int k = 1; k < kHold; ++k) {
                            if (k < S) s = plus(s, prod(cvt<C>(held[k][i]), pu[k]));
                        }
                        x[i] = cvt<T>(minus(cvt<C>(x[i]), s));
                    }
                }
                if (write) store_as<T, E, kVec>(vp, r, a.n, x);
                if (dots) {
#pragma unroll
                    for (int k = 0; k < kHold; ++k) {
                        if (k < S) {
#pragma unroll
                            for (int i = 0; i < E; ++i) dot_add(dot[k], cvt<C>(held[k][i]), cvt<C>(x[i]));
                        }
                    }
                }
                if (norm) {
#pragma unroll
                    for (int i = 0; i < E; ++i) ss += sq_abs(x[i]);
                }
            }
        }
        if (n_sums == 0) continue;
        // The block's sums of this probe, each over its threads in a fixed order: the dots' parts, then |v|^2.
#pragma unroll
        for (int k = 0; k < kHold; ++k) {
#pragma unroll
            for (int h = 0; h < kParts; ++h) {
                if (dots && k < S) {
                    const RC s = warp_sum(part(dot[k], h));
                    if (lane == 0) red[k * kParts + h][warp] = s;
                }
            }
        }
        if (norm) {
            const RC s = warp_sum(static_cast<RC>(ss));
            if (lane == 0) red[n_sums - 1][warp] = s;
        }
        __syncthreads();
        if (threadIdx.x < n_sums) {
            RC s = RC(0);
#pragma unroll
            for (int w = 0; w < kWarps; ++w) s += red[threadIdx.x][w];
            a.partial[(p * kSums + threadIdx.x) * gridDim.x + blockIdx.x] = s;
        }
        __syncthreads();
    }
    if (n_sums == 0) return;
    // The last block to finish sums each probe's partials in a fixed order and writes the outputs.
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x * gridDim.y - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    RC* proj = reinterpret_cast<RC*>(a.proj_out);
    for (int64_t e = warp; e < a.nv * n_sums; e += kWarps) {
        const int64_t p = e / n_sums;
        const int j = static_cast<int>(e % n_sums);
        RC s = RC(0);
        for (int x = lane; x < static_cast<int>(gridDim.x); x += 32) s += __ldcg(a.partial + (p * kSums + j) * gridDim.x + x);
        s = warp_sum(s);
        if (lane == 0) {
            if (norm && j == n_sums - 1) {
                a.sq_out[p] = static_cast<R>(s);
            } else {
                uint64_t m = a.mask;  // the (j / kParts)-th slot of the launch
                for (int k = 0; k < j / kParts; ++k) m &= m - 1;
                const int64_t sl = slot_of(a, __ffsll(static_cast<long long>(m)) - 1);
                proj[(sl * a.nv + p) * kParts + j % kParts] = s;
            }
        }
    }
    if (threadIdx.x == 0) *a.ticket = 0u;
}

template <typename T, typename W, typename Q>
int64_t window_blocks(int64_t nv, int64_t n) {
    int dev = 0, sms = 0, occ = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, cgs_window_kernel<T, W, Q, true>, kThreads, 0) != cudaSuccess) {
        return -1;
    }
    const int64_t gy = nv < 65535 ? nv : 65535;
    const int64_t tiles = (n + kThreads * kElems<T, W, Q> - 1) / (kThreads * kElems<T, W, Q>);
    int64_t gx = static_cast<int64_t>(sms) * (occ > 0 ? occ : 1) / (gy > 0 ? gy : 1);
    if (gx > tiles) gx = tiles;
    return gx > 0 ? gx : 1;
}

template <typename T, typename W, typename Q>
cudaError_t launch_window(void* v, int64_t ld_v, const void* q, int64_t ld_q, const void* alpha, const void* win,
                          uint64_t mask, int64_t top, int64_t ncv, const void* proj_in, void* proj_out,
                          void* sq_out, void* partial, unsigned* ticket, int64_t nv, int64_t n, int64_t gx, int vec,
                          cudaStream_t stream) {
    using A = Args<T, W, Q>;
    const int S = __builtin_popcountll(mask);
    const bool sums = proj_out != nullptr || sq_out != nullptr;
    if (nv <= 0 || n <= 0 || gx <= 0 || gx > 0x7fffffffLL || S > kHold || top < 0 || top >= ncv || (ncv < 64 && (mask >> ncv) != 0) ||
        (alpha != nullptr && q == nullptr && (mask & 1) == 0) || (sums && (partial == nullptr || ticket == nullptr)) ||
        (S > 0 && win == nullptr))
        return cudaErrorInvalidValue;
    const A a{static_cast<T*>(v), ld_v, static_cast<const Q*>(q), ld_q, static_cast<const typename A::R*>(alpha),
              static_cast<const W*>(win), mask, top, ncv, static_cast<const typename A::C*>(proj_in),
              static_cast<typename A::C*>(proj_out), static_cast<typename A::R*>(sq_out),
              static_cast<real_t<typename A::C>*>(partial), ticket, nv, n};
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(nv < 65535 ? nv : 65535));
    if (vec) {
        cgs_window_kernel<T, W, Q, true><<<grid, kThreads, 0, stream>>>(a);
    } else {
        cgs_window_kernel<T, W, Q, false><<<grid, kThreads, 0, stream>>>(a);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* primate_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// One launch of the chain for a carry of type T, a window of type W and q_cur of type Q (suffixes as
// ops/_common.SUFFIX): v (ld_v) the carry's rows; q (ld_q) q_cur's rows, or null (with alpha: q_cur is the
// slot of mask's bit 0, top); alpha (nv,) or null; win the window (ncv, nv, n); mask, top and ncv the launch's
// slots (bit b: slot top - b mod ncv); proj_in, proj_out (ncv, nv) in promote(T, W), sq_out (nv,) in
// T's real type, each or null; partial (nv, 17, gx) in promote(T, W)'s real type and ticket the blocks' sums;
// gx from cgs_window_blocks_*.
#define PRIMATE_CGS_WINDOW(NAME, T, W, Q)                                                                              \
    cudaError_t cgs_window_##NAME(void* v, int64_t ld_v, const void* q, int64_t ld_q, const void* alpha,              \
                                  const void* win, uint64_t mask, int64_t top, int64_t ncv,                           \
                                  const void* proj_in, void* proj_out, void* sq_out, void* partial, unsigned* ticket, \
                                  int64_t nv, int64_t n, int64_t gx, int vec, cudaStream_t stream) {                   \
        return launch_window<T, W, Q>(v, ld_v, q, ld_q, alpha, win, mask, top, ncv, proj_in, proj_out,                \
                                      sq_out, partial, ticket, nv, n, gx, vec, stream);                               \
    }                                                                                                                  \
    int64_t cgs_window_blocks_##NAME(int64_t nv, int64_t n) { return window_blocks<T, W, Q>(nv, n); }

PRIMATE_CGS_WINDOW(f32_f32_f32, float, float, float)
PRIMATE_CGS_WINDOW(f32_bf16_bf16, float, bf16, bf16)
PRIMATE_CGS_WINDOW(f32_bf16_f32, float, bf16, float)
PRIMATE_CGS_WINDOW(f32_f32_bf16, float, float, bf16)
PRIMATE_CGS_WINDOW(f32_f64_f32, float, double, float)
PRIMATE_CGS_WINDOW(f32_f64_bf16, float, double, bf16)
PRIMATE_CGS_WINDOW(f32_f16_f32, float, f16, float)
PRIMATE_CGS_WINDOW(f32_f16_bf16, float, f16, bf16)
PRIMATE_CGS_WINDOW(f64_f64_f64, double, double, double)
PRIMATE_CGS_WINDOW(f64_f32_f64, double, float, double)
PRIMATE_CGS_WINDOW(f64_bf16_f64, double, bf16, double)
PRIMATE_CGS_WINDOW(f64_f16_f64, double, f16, double)
PRIMATE_CGS_WINDOW(c64_c64_c64, c64, c64, c64)
PRIMATE_CGS_WINDOW(c64_c128_c64, c64, c128, c64)
PRIMATE_CGS_WINDOW(c128_c128_c128, c128, c128, c128)
PRIMATE_CGS_WINDOW(c128_c64_c128, c128, c64, c128)

}  // extern "C"
