// Low-level helpers shared by the kernels of csrc/: 16-byte vector types, and
// cp.async copies from global to shared memory (sm_80 and later).
#pragma once

#include <cuda_runtime.h>

namespace {

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int len = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int len = 2; };

__device__ __forceinline__ void unpack(const float4& v, float (&o)[4]) { o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w; }
__device__ __forceinline__ void unpack(const double2& v, double (&o)[2]) { o[0] = v.x; o[1] = v.y; }
__device__ __forceinline__ float4 pack(const float (&o)[4]) { return make_float4(o[0], o[1], o[2], o[3]); }
__device__ __forceinline__ double2 pack(const double (&o)[2]) { return make_double2(o[0], o[1]); }

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
