// One-pass row RMSNorm on (T, D), written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rmsnorm/kernel.py::rmsnorm_2d
//   (its pallas_call at kernel.py:34).
//
// For every row t, in f32:
//   var     = sum_d x[t, d]^2 / D
//   inv     = 1 / sqrt(var + eps)
//   out[t]  = (x[t] * inv) * (1 + scale)          cast to x's dtype
// x and scale are f32 or bf16 (one dtype), widened to f32 on load.
//
// What bounds it on an H100: memory.  The function reads x once and writes
// out once (the (D,) scale is noise): at (8192, 768) f32 that is 50.3 MB,
// 0.0150 ms at 3.35 TB/s, against about 4 flops an element.
//
// What the design does about it: one warp per row, eight rows per CTA.  A
// warp's 32 lanes walk the row at consecutive addresses (coalesced 128-byte
// accesses at f32), reduce the sum of squares with shuffles, then walk the
// row again to scale it; the second read of the row comes from L1/L2, not
// device memory, so each byte of x crosses the memory bus once.  No shared
// memory, no second kernel.  Vector loads are later work.
//
// Rounding: the sum of squares is an FMA chain per lane and a shuffle tree
// (its order differs from the plain version's); inv is 1 / sqrt, each
// correctly rounded (__fsqrt_rn, __fdiv_rn), where rsqrtf would be
// approximate; the scaling uses the _rn intrinsics in the JAX kernel's
// order, (x * inv) * (1 + scale).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librmsnorm_2d.so rmsnorm_2d.cu
// Entry point: rmsnorm_2d_launch (plain C, loaded with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows per CTA

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float v, float *o) { *o = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16 *o) {
    *o = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_2d_kernel(const T *__restrict__ x, const T *__restrict__ scale,
                  T *__restrict__ out, long long rows, int d, float eps) {
    const int lane = threadIdx.x % 32;
    const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
    if (row >= rows) return;
    const T *xr = x + row * d;
    T *orow = out + row * d;
    float ss = 0.0f;
    for (int i = lane; i < d; i += 32) {
        const float v = widen(xr[i]);
        ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
    const float var = __fdiv_rn(ss, (float)d);
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    for (int i = lane; i < d; i += 32) {
        const float v = widen(xr[i]);
        narrow(__fmul_rn(__fmul_rn(v, inv), __fadd_rn(1.0f, widen(scale[i]))),
               &orow[i]);
    }
}

template <typename T>
int launch(const void *x, const void *scale, void *out, long long rows, int d,
           float eps, cudaStream_t stream) {
    const long long blocks = (rows + kWarps - 1) / kWarps;
    rmsnorm_2d_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
        static_cast<const T *>(x), static_cast<const T *>(scale),
        static_cast<T *>(out), rows, d, eps);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (x, scale and out alike).  x and out
// (rows, d) contiguous, scale (d,).  The caller checks shapes, dtypes,
// contiguity, rows >= 1 and d >= 1.  Returns the CUDA error of the launch
// (0 = launched).
extern "C" int rmsnorm_2d_launch(int dtype_code, const void *x,
                                 const void *scale, void *out, long long rows,
                                 int d, float eps, void *stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype_code == 0) return launch<float>(x, scale, out, rows, d, eps, s);
    if (dtype_code == 1)
        return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
    return (int)cudaErrorInvalidValue;
}
