// One coalesced A2CiD2 gossip batch on worker-stacked (W, D) flat buffers,
// p2p then mix, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/a2cid2_mixing/kernel.py::mixing_gossip_stacked
//   (its pallas_call at kernel.py:265).
//
// For every worker row w, with p = partner[w] (p == w for an idle worker):
//   m      = x[w]  - x[p]
//   x1     = x[w]  - alpha   * m
//   xt1    = xt[w] - alpha_t * m
//   c      = 0.5f * (1.0f - expf(neg2eta * dt_next[w]))   in f32, then cast
//   d      = xt1 - x1
//   out_x[w] = x1  + c * d
//   xt[w]    = xt1 - c * d          (x~ is updated in place)
// out_x is a separate buffer: another row may still read row w as its
// partner after w has been written.
//
// What bounds it on an H100: memory.  The function must read x and x~ once
// and write two (W, D) outputs, 4 * W * D * itemsize bytes (the partner rows
// come out of x itself and count once).  At (16, 11,171,328) f32 that is
// 2.86 GB, 0.85 ms at 3.35 TB/s, against 9 f32 operations an element
// (1.6 GFLOP, about 24 us at 67 TFLOP/s).
//
// What the design does about it: every byte moves once per launch except
// the partner row, which is read again from device memory (an idle row
// reuses its own registers).  blockIdx.y is the worker row; each block loads
// partner[w] and dt_next[w] itself (there is no scalar prefetch on the
// card).  blockIdx.x strides along the row in 16-byte vectors, so a warp
// issues fully coalesced 512-byte accesses; LANE padding of D to 128
// elements keeps every row 16-byte aligned.  Keeping the partner row out of
// the second read (L2 residency or a cluster exchange) and pipelining the
// loads with cp.async or TMA are later work.
//
// Rounding: the per-element arithmetic lives in gossip_common.cuh, shared
// with the other three gossip kernels (the _rn intrinsics, no FMA, a bf16
// rounding of every intermediate), so the kernel rounds where the plain
// PyTorch version (ref.py) does.  alpha and alpha_t arrive already rounded
// to the buffer dtype.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmixing_gossip_stacked.so mixing_gossip_stacked.cu
// Entry point: mixing_gossip_stacked_launch (plain C, loaded with ctypes).

#include "gossip_common.cuh"

namespace {

using namespace gossip;

template <typename T>
__global__ void __launch_bounds__(kThreads)
mixing_gossip_stacked_kernel(const typename T::vec_t *__restrict__ x,
                             typename T::vec_t *x_tilde,
                             typename T::vec_t *__restrict__ out_x,
                             const int *__restrict__ partner,
                             const float *__restrict__ dt_next,
                             long long row_vecs, float neg2eta, float alpha,
                             float alpha_t) {
    constexpr int L = T::kLanes;
    const int w = blockIdx.y;
    const int p = partner[w];
    const float c = mix_coeff<T>(neg2eta, dt_next[w]);
    const long long row = (long long)w * row_vecs;
    const long long prow = (long long)p * row_vecs;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < row_vecs; i += stride) {
        float xv[L], xp[L], xt[L], ox[L], oxt[L];
        T::unpack(x[row + i], xv);
        if (p == w) {
#pragma unroll
            for (int k = 0; k < L; ++k) xp[k] = xv[k];
        } else {
            T::unpack(x[prow + i], xp);
        }
        T::unpack(x_tilde[row + i], xt);
#pragma unroll
        for (int k = 0; k < L; ++k) {
            p2p_mix<T>(xv[k], xt[k], clean_m<T>(xv[k], xp[k]), alpha,
                       alpha_t, c, ox[k], oxt[k]);
        }
        out_x[row + i] = T::pack(ox);
        x_tilde[row + i] = T::pack(oxt);
    }
}

template <typename T>
void launch(const void *x, void *x_tilde, void *out_x, const void *partner,
            const void *dt_next, long long w, long long d, float neg2eta,
            float alpha, float alpha_t, cudaStream_t stream) {
    const long long row_vecs = d / T::kLanes;
    const dim3 grid(blocks_x(row_vecs), (unsigned)w);
    mixing_gossip_stacked_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const typename T::vec_t *>(x),
        static_cast<typename T::vec_t *>(x_tilde),
        static_cast<typename T::vec_t *>(out_x),
        static_cast<const int *>(partner),
        static_cast<const float *>(dt_next), row_vecs, neg2eta, alpha,
        alpha_t);
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16; alpha and alpha_t are values of
// that dtype.  The caller checks shapes, dtypes,
// contiguity, 16-byte alignment, d % 128 == 0 and 1 <= w <= 65535.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int mixing_gossip_stacked_launch(
    int dtype_code, const void *x, void *x_tilde, void *out_x,
    const void *partner, const void *dt_next, long long w, long long d,
    float neg2eta, float alpha, float alpha_t, void *stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype_code == 0) {
        launch<F32>(x, x_tilde, out_x, partner, dt_next, w, d, neg2eta, alpha,
                    alpha_t, s);
    } else if (dtype_code == 1) {
        launch<BF16>(x, x_tilde, out_x, partner, dt_next, w, d, neg2eta,
                     alpha, alpha_t, s);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
