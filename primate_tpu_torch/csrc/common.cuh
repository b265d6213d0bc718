// Low-level helpers shared by the kernels of csrc/: a complex element type,
// 16-byte vector types, read-only and streaming element accesses, and cp.async
// copies from global to shared memory (sm_80 and later).
#pragma once

#include <cuda_runtime.h>

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

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int len = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int len = 2; };
template <> struct Vec<c64> { using type = float4; static constexpr int len = 2; };
template <> struct Vec<c128> { using type = double2; static constexpr int len = 1; };

__device__ __forceinline__ void unpack(const float4& v, float (&o)[4]) { o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w; }
__device__ __forceinline__ void unpack(const double2& v, double (&o)[2]) { o[0] = v.x; o[1] = v.y; }
__device__ __forceinline__ void unpack(const float4& v, c64 (&o)[2]) { o[0] = c64(v.x, v.y); o[1] = c64(v.z, v.w); }
__device__ __forceinline__ void unpack(const double2& v, c128 (&o)[1]) { o[0] = c128(v.x, v.y); }
__device__ __forceinline__ float4 pack(const float (&o)[4]) { return make_float4(o[0], o[1], o[2], o[3]); }
__device__ __forceinline__ double2 pack(const double (&o)[2]) { return make_double2(o[0], o[1]); }
__device__ __forceinline__ float4 pack(const c64 (&o)[2]) { return make_float4(o[0].re, o[0].im, o[1].re, o[1].im); }
__device__ __forceinline__ double2 pack(const c128 (&o)[1]) { return make_double2(o[0].re, o[0].im); }

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
__device__ __forceinline__ void stcs(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void stcs(double* p, double v) { __stcs(p, v); }
__device__ __forceinline__ void stcs(c64* p, c64 v) { __stcs(reinterpret_cast<float2*>(p), make_float2(v.re, v.im)); }
__device__ __forceinline__ void stcs(c128* p, c128 v) { __stcs(reinterpret_cast<double2*>(p), make_double2(v.re, v.im)); }

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

}  // namespace
