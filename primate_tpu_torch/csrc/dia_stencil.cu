// DIA stencil kernels for Hopper (sm_90a), float32 and float64.
//
// Replaces the Pallas TPU kernels of primate_tpu/ops/dia_pallas.py:
//   dia_stencil_t     <- dia_matmat_t_pallas (_dia_t_kernel): out = A X, probe-major
//   dia_stencil       <- dia_matmat_pallas (_dia_kernel): out = A V, node-major
//   lanczos_dia_step  <- dia_matmat_t_phys (_dia_t_phys_kernel), the Lanczos sweep's
//                        stencil, fused here with the beta-axpy and the alpha reduction
//
// Layout: row-aligned bands (n_d, n) with band[d][r] = A[r, r + offsets[d]];
// probe-major blocks (nv, n) for dia_stencil_t and the Lanczos step, node-major
// blocks (n, k) for dia_stencil. Out-of-range neighbours (r + off outside
// [0, n)) are skipped by a bounds check, so no zero-padded halo copy of the block
// is needed and the offsets may be of any size.
//
// Bound: HBM bytes. A stencil of a few diagonals does 2 n_d flops per loaded
// element, far below the card's ~20 flop/byte balance point. So the design only
// keeps traffic at one pass: one thread per row r and kProbes probes, consecutive
// threads on consecutive r (coalesced loads of X[b, r + off]; the shifted
// neighbour loads of one warp overlap and hit L1), each band value read once per
// kProbes outputs. The TPU kernel's manual double-buffered DMA has no counterpart:
// enough resident warps hide the load latency. The node-major kernel walks the
// row-major (n, k) block in flat order instead: consecutive threads take
// consecutive (row, column) elements, so both the output and each shifted
// neighbour row V[r + off, :] are read and written in contiguous runs for any k
// (no k % 128 rule), and a band value is shared by the k threads of its row.
// Each thread keeps kNmEl outputs so every diagonal has kNmEl loads in flight.
// Unlike the probe-major kernel's, its time grows with the number of diagonals
// (a shifted row is k elements away, not one), so it sits well below the HBM
// roofline; PERF.md has the measurements.
//
// Plain C interface: every entry point returns the cudaError_t of its launch
// (cudaGetLastError()), and the caller raises on anything but cudaSuccess. The
// kernels launch on the caller's stream, allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // rows per block
constexpr int kProbes = 8;     // probes per thread (and per blockIdx.y)
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ void stencil_rows(const T* __restrict__ bands, const int64_t* __restrict__ offsets,
                                             int n_d, const T* __restrict__ x, int64_t nv, int64_t n, int64_t r,
                                             int64_t b0, T (&acc)[kProbes]) {
#pragma unroll
    for (int p = 0; p < kProbes; ++p) acc[p] = T(0);
    for (int d = 0; d < n_d; ++d) {
        const int64_t c = r + offsets[d];
        if (c < 0 || c >= n) continue;
        const T w = bands[d * n + r];
#pragma unroll
        for (int p = 0; p < kProbes; ++p) {
            if (b0 + p < nv) acc[p] += w * x[(b0 + p) * n + c];
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dia_stencil_t_kernel(const T* __restrict__ bands,
                                                                 const int64_t* __restrict__ offsets, int n_d,
                                                                 const T* __restrict__ x, T* __restrict__ out,
                                                                 int64_t nv, int64_t n) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kProbes;
    if (r >= n) return;
    T acc[kProbes];
    stencil_rows(bands, offsets, n_d, x, nv, n, r, b0, acc);
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
        if (b0 + p < nv) out[(b0 + p) * n + r] = acc[p];
    }
}

constexpr int kNmThreads = 256;  // threads per block of the node-major kernel
constexpr int kNmEl = 8;         // output elements per thread of the node-major kernel
constexpr int kNmElems = kNmThreads * kNmEl;  // output elements per block

// out[r, c] = sum_d band[d, r] V[r + off_d, c] on a row-major (n, k) block. Block
// (blockIdx.x, blockIdx.y) covers rows [x * rows, (x + 1) * rows) and columns
// [y * kc, (y + 1) * kc), rows * kc <= kNmElems, walked in flat row-major order;
// each thread takes kNmEl elements kNmThreads apart, so every diagonal issues
// kNmEl independent loads per thread.
template <typename T>
__global__ void __launch_bounds__(kNmThreads) dia_stencil_kernel(const T* __restrict__ bands,
                                                                 const int64_t* __restrict__ offsets, int n_d,
                                                                 const T* __restrict__ V, T* __restrict__ out,
                                                                 int64_t n, int64_t k, int rows, int kc) {
    const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
    const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kc;
    int64_t r[kNmEl], c[kNmEl];
    bool ok[kNmEl];
    T acc[kNmEl];
#pragma unroll
    for (int j = 0; j < kNmEl; ++j) {
        const int e = threadIdx.x + j * kNmThreads;
        const int dr = e / kc;
        r[j] = r0 + dr;
        c[j] = c0 + (e - dr * kc);
        ok[j] = e < rows * kc && r[j] < n && c[j] < k;
        acc[j] = T(0);
    }
    for (int d = 0; d < n_d; ++d) {
        const int64_t off = offsets[d];
#pragma unroll
        for (int j = 0; j < kNmEl; ++j) {
            const int64_t rr = r[j] + off;
            if (ok[j] && rr >= 0 && rr < n) acc[j] += bands[d * n + r[j]] * V[rr * k + c[j]];
        }
    }
#pragma unroll
    for (int j = 0; j < kNmEl; ++j) {
        if (ok[j]) out[r[j] * k + c[j]] = acc[j];
    }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
    return v;
}

// v[b, r] = sum_d band[d, r] q_cur[b, r + off_d] - beta[b] q_prev[b, r], and
// partial[b, blockIdx.x] = sum over this block's rows of v[b, r] q_cur[b, r].
// The partials are summed by the caller: no atomics, so alpha is deterministic.
template <typename T>
__global__ void __launch_bounds__(kThreads) lanczos_dia_step_kernel(
    const T* __restrict__ bands, const int64_t* __restrict__ offsets, int n_d, const T* __restrict__ q_cur,
    const T* __restrict__ q_prev, const T* __restrict__ beta, T* __restrict__ v, T* __restrict__ partial,
    int64_t nv, int64_t n) {
    __shared__ T red[kProbes][kWarps];
    const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kProbes;
    T dot[kProbes];
#pragma unroll
    for (int p = 0; p < kProbes; ++p) dot[p] = T(0);
    if (r < n) {  // no early return: every thread reaches the __syncthreads below
        T acc[kProbes];
        stencil_rows(bands, offsets, n_d, q_cur, nv, n, r, b0, acc);
#pragma unroll
        for (int p = 0; p < kProbes; ++p) {
            const int64_t b = b0 + p;
            if (b < nv) {
                const T val = acc[p] - beta[b] * q_prev[b * n + r];
                v[b * n + r] = val;
                dot[p] = val * q_cur[b * n + r];
            }
        }
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
        const T s = warp_sum(dot[p]);
        if (lane == 0) red[p][warp] = s;
    }
    __syncthreads();
    if (threadIdx.x < kProbes && b0 + threadIdx.x < nv) {
        T s = T(0);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[threadIdx.x][w];
        partial[(b0 + threadIdx.x) * gridDim.x + blockIdx.x] = s;
    }
}

inline int64_t row_blocks(int64_t n) { return (n + kThreads - 1) / kThreads; }

// gridDim.y holds the probe groups (at most 65535 of them); gridDim.x the row blocks.
inline bool grid_ok(int64_t nv, int64_t n) {
    return (nv + kProbes - 1) / kProbes <= 65535 && row_blocks(n) <= 0x7fffffffLL;
}

template <typename T>
cudaError_t launch_stencil(const T* bands, const int64_t* offsets, int n_d, const T* x, T* out, int64_t nv,
                           int64_t n, cudaStream_t stream) {
    if (nv == 0 || n == 0) return cudaSuccess;
    if (!grid_ok(nv, n)) return cudaErrorInvalidConfiguration;
    const dim3 grid(static_cast<unsigned>(row_blocks(n)), static_cast<unsigned>((nv + kProbes - 1) / kProbes));
    dia_stencil_t_kernel<T><<<grid, kThreads, 0, stream>>>(bands, offsets, n_d, x, out, nv, n);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stencil_nm(const T* bands, const int64_t* offsets, int n_d, const T* V, T* out, int64_t n,
                              int64_t k, cudaStream_t stream) {
    if (n == 0 || k == 0) return cudaSuccess;
    const int kc = static_cast<int>(k < kNmElems ? k : kNmElems);
    const int rows = kNmElems / kc;
    const int64_t gx = (n + rows - 1) / rows, gy = (k + kc - 1) / kc;
    if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidConfiguration;
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
    dia_stencil_kernel<T><<<grid, kNmThreads, 0, stream>>>(bands, offsets, n_d, V, out, n, k, rows, kc);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_step(const T* bands, const int64_t* offsets, int n_d, const T* q_cur, const T* q_prev,
                        const T* beta, T* v, T* partial, int64_t nv, int64_t n, cudaStream_t stream) {
    if (nv == 0 || n == 0) return cudaSuccess;
    if (!grid_ok(nv, n)) return cudaErrorInvalidConfiguration;
    const dim3 grid(static_cast<unsigned>(row_blocks(n)), static_cast<unsigned>((nv + kProbes - 1) / kProbes));
    lanczos_dia_step_kernel<T><<<grid, kThreads, 0, stream>>>(bands, offsets, n_d, q_cur, q_prev, beta, v,
                                                              partial, nv, n);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Columns of the (nv, n_partials) buffer that lanczos_dia_step_* fills.
int64_t lanczos_dia_step_partials(int64_t n) { return row_blocks(n); }

const char* primate_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

cudaError_t dia_stencil_t_f32(const float* bands, const int64_t* offsets, int n_d, const float* x, float* out,
                              int64_t nv, int64_t n, cudaStream_t stream) {
    return launch_stencil(bands, offsets, n_d, x, out, nv, n, stream);
}

cudaError_t dia_stencil_t_f64(const double* bands, const int64_t* offsets, int n_d, const double* x, double* out,
                              int64_t nv, int64_t n, cudaStream_t stream) {
    return launch_stencil(bands, offsets, n_d, x, out, nv, n, stream);
}

cudaError_t dia_stencil_f32(const float* bands, const int64_t* offsets, int n_d, const float* V, float* out,
                            int64_t n, int64_t k, cudaStream_t stream) {
    return launch_stencil_nm(bands, offsets, n_d, V, out, n, k, stream);
}

cudaError_t dia_stencil_f64(const double* bands, const int64_t* offsets, int n_d, const double* V, double* out,
                            int64_t n, int64_t k, cudaStream_t stream) {
    return launch_stencil_nm(bands, offsets, n_d, V, out, n, k, stream);
}

cudaError_t lanczos_dia_step_f32(const float* bands, const int64_t* offsets, int n_d, const float* q_cur,
                                 const float* q_prev, const float* beta, float* v, float* partial, int64_t nv,
                                 int64_t n, cudaStream_t stream) {
    return launch_step(bands, offsets, n_d, q_cur, q_prev, beta, v, partial, nv, n, stream);
}

cudaError_t lanczos_dia_step_f64(const double* bands, const int64_t* offsets, int n_d, const double* q_cur,
                                 const double* q_prev, const double* beta, double* v, double* partial, int64_t nv,
                                 int64_t n, cudaStream_t stream) {
    return launch_step(bands, offsets, n_d, q_cur, q_prev, beta, v, partial, nv, n, stream);
}

}  // extern "C"
