// Low-level helpers shared by the kernels of csrc/: a complex element type,
// bfloat16 storage with its float32 accumulation type, 16-byte vector types,
// read-only and streaming element accesses, and cp.async copies from global to
// shared memory (sm_80 and later).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// A complex number laid out as torch's complex64 / complex128 (real, imaginary),
// aligned to its size so that a 16-byte vector holds a whole number of them.
// Only what the stencils need: zero, +=, and the product.
template <typename R>
struct alignas(2 * sizeof(R)) Cplx {
    R re, im;
    Cplx() = default;
    __device__ __forceinline__ constexpr Cplx(int z) : re(R(z)), im(R(0)) {}
    __device__ __forceinline__ constexpr Cplx(R r, R i) : re(r), im(i) {}
    __device__ __forceinline__ Cplx& operator+=(const Cplx& o) {
        re += o.re;
        im += o.im;
        return *this;
    }
};
template <typename R>
__device__ __forceinline__ Cplx<R> operator*(const Cplx<R>& a, const Cplx<R>& b) {
    return Cplx<R>(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}
using c64 = Cplx<float>;
using c128 = Cplx<double>;
static_assert(sizeof(c64) == 8 && alignof(c64) == 8 && sizeof(c128) == 16 && alignof(c128) == 16, "torch's complex layout");

// The real type of each element type: the type itself, and R for Cplx<R>. The Lanczos step's
// per-probe state and its sums (alpha, |v|^2) are real for complex (Hermitian) blocks too.
template <typename T> struct RealOf { using type = T; };
template <typename R> struct RealOf<Cplx<R>> { using type = R; };
template <typename T> using real_t = typename RealOf<T>::type;
template <typename T> constexpr bool kCplx = !std::is_same<T, real_t<T>>::value;

using bf16 = __nv_bfloat16;

// The type a kernel sums in for each storage type: the type itself, and float32 for
// bfloat16 (JAX's promote_types(dtype, float32)). A bfloat16 kernel reads bf16, converts
// each element once with __bfloat162float, sums in float32 registers and rounds once
// with __float2bfloat16_rn (round to nearest even, as XLA's convert) where it writes bf16.
template <typename T> struct Acc { using type = T; };
template <> struct Acc<bf16> { using type = float; };
template <typename T> using acc_t = typename Acc<T>::type;
// Whether T is stored narrower than it is summed (bfloat16).
template <typename T> constexpr bool kNarrow = !std::is_same<T, acc_t<T>>::value;

template <typename T> __device__ __forceinline__ acc_t<T> to_acc(T v) { return v; }
__device__ __forceinline__ float to_acc(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_acc(acc_t<T> v) { return v; }
template <> __device__ __forceinline__ bf16 from_acc<bf16>(float v) { return __float2bfloat16_rn(v); }
template <typename T> __device__ __forceinline__ T zero() { return from_acc<T>(acc_t<T>(0)); }

// A 16-byte vector of each element type: its register type and its length in elements.
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int len = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int len = 2; };
template <> struct Vec<c64> { using type = float4; static constexpr int len = 2; };
template <> struct Vec<c128> { using type = double2; static constexpr int len = 1; };
template <> struct Vec<bf16> { using type = uint4; static constexpr int len = 8; };

__device__ __forceinline__ void unpack(const float4& v, float (&o)[4]) { o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w; }
__device__ __forceinline__ void unpack(const double2& v, double (&o)[2]) { o[0] = v.x; o[1] = v.y; }
__device__ __forceinline__ void unpack(const float4& v, c64 (&o)[2]) { o[0] = c64(v.x, v.y); o[1] = c64(v.z, v.w); }
__device__ __forceinline__ void unpack(const double2& v, c128 (&o)[1]) { o[0] = c128(v.x, v.y); }
__device__ __forceinline__ float4 pack(const float (&o)[4]) { return make_float4(o[0], o[1], o[2], o[3]); }
__device__ __forceinline__ double2 pack(const double (&o)[2]) { return make_double2(o[0], o[1]); }
__device__ __forceinline__ float4 pack(const c64 (&o)[2]) { return make_float4(o[0].re, o[0].im, o[1].re, o[1].im); }
__device__ __forceinline__ double2 pack(const c128 (&o)[1]) { return make_double2(o[0].re, o[0].im); }
// bfloat16: 8 values, unpacked to float32 and packed from it with one rounding each.
__device__ __forceinline__ void unpack(const uint4& v, float (&o)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        o[2 * i] = f.x;
        o[2 * i + 1] = f.y;
    }
}
__device__ __forceinline__ uint4 pack(const float (&o)[8]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
    return v;
}

// One element through the read-only cache (__ldg), and one streaming store (__stcs).
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ double ldg(const double* p) { return __ldg(p); }
__device__ __forceinline__ c64 ldg(const c64* p) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    return c64(v.x, v.y);
}
__device__ __forceinline__ c128 ldg(const c128* p) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    return c128(v.x, v.y);
}
__device__ __forceinline__ bf16 ldg(const bf16* p) {
    return __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void stcs(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void stcs(double* p, double v) { __stcs(p, v); }
__device__ __forceinline__ void stcs(c64* p, c64 v) { __stcs(reinterpret_cast<float2*>(p), make_float2(v.re, v.im)); }
__device__ __forceinline__ void stcs(c128* p, c128 v) { __stcs(reinterpret_cast<double2*>(p), make_double2(v.re, v.im)); }
__device__ __forceinline__ void stcs(bf16* p, bf16 v) { __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v)); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of N bytes (4, 8 or 16) to shared memory; src_bytes = 0 reads
// nothing and writes zeros.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
    if constexpr (N == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
                     : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)), "l"(src), "n"(N),
                     "r"(src_bytes)
                     : "memory");
    }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// One element to shared memory, zero where !ok (src must then still be a valid address):
// cp.async where it takes the element's size (4, 8 or 16 bytes), else (a 2-byte bfloat16)
// a plain load and store, visible to the other threads after the same barrier.
template <typename T>
__device__ __forceinline__ void copy_elem(T* dst, const T* src, bool ok) {
    if constexpr (sizeof(T) >= 4) {
        cp_async<sizeof(T)>(dst, src, ok ? static_cast<int>(sizeof(T)) : 0);
    } else {
        *dst = ok ? *src : zero<T>();
    }
}

}  // namespace
