// One coalesced A2CiD2 gossip batch over B worlds' worker-stacked flat
// buffers at once, (B, W, D), p2p then mix, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/a2cid2_mixing/kernel.py::mixing_gossip_worlds
//   (its pallas_call at kernel.py:357).
//
// For every world b and worker row w, with p = partner[b, w] (local to the
// world; p == w for an idle worker) and the world's own dynamics:
//   alpha_b = dtype(alpha[b]), alpha_t_b = dtype(alpha_t[b])
//   c       = 0.5f * (1.0f - expf((-2 * eta[b]) * dt_next[b, w])), then cast
//   m       = x[b, w] - x[b, p]
//   x1      = x[b, w]  - alpha_b   * m
//   xt1     = xt[b, w] - alpha_t_b * m
//   d       = xt1 - x1
//   out_x[b, w] = x1  + c * d
//   xt[b, w]    = xt1 - c * d          (x~ is updated in place)
// This is mixing_gossip_stacked on world b with that world's scalars, bit
// for bit: the per-element arithmetic is the shared gossip_common.cuh, and
// -2 * eta[b] in f32 equals the stacked kernel's f32(-2 * eta) (the factor
// -2 commutes with rounding).  There is no eta == 0 shortcut: a baseline
// world computes c = 0 exactly.  out_x is a separate buffer, since another
// row may still read row w as its partner after w has been written.
//
// What bounds it on an H100: memory.  The function must read x and x~ once
// and write two (B, W, D) outputs, 4 * B * W * D * itemsize bytes.  At
// (4, 16, 11,171,328) f32 that is 11.44 GB, 3.415 ms at 3.35 TB/s, against
// 9 f32 operations an element (6.4 GFLOP, about 96 us at 67 TFLOP/s).
//
// What the design does about it: it is the stacked kernel's design with the
// world folded into the row index.  blockIdx.y is the global row b * W + w
// (B * W <= 65535); each block loads its partner, dt and the world's three
// scalars from device memory itself (no host round trip, no scalar
// prefetch on the card).  blockIdx.x strides along the row in 16-byte
// vectors, so a warp issues fully coalesced 512-byte accesses; LANE padding
// of D to 128 elements keeps every row 16-byte aligned.  As in the stacked
// kernel, a matched partner row is read again from device memory; keeping
// it on chip and pipelining the loads are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmixing_gossip_worlds.so mixing_gossip_worlds.cu
// Entry point: mixing_gossip_worlds_launch (plain C, loaded with ctypes).

#include "gossip_common.cuh"

namespace {

using namespace gossip;

template <typename T>
__global__ void __launch_bounds__(kThreads)
mixing_gossip_worlds_kernel(const typename T::vec_t *__restrict__ x,
                            typename T::vec_t *x_tilde,
                            typename T::vec_t *__restrict__ out_x,
                            const int *__restrict__ partner,
                            const float *__restrict__ dt_next,
                            const float *__restrict__ eta,
                            const float *__restrict__ alpha,
                            const float *__restrict__ alpha_t, int w_dim,
                            long long row_vecs) {
    constexpr int L = T::kLanes;
    const int r = blockIdx.y;          // global row b * W + w
    const int b = r / w_dim;
    const int p = b * w_dim + partner[r];
    const float a = T::round(alpha[b]);
    const float at = T::round(alpha_t[b]);
    const float c = mix_coeff<T>(__fmul_rn(-2.0f, eta[b]), dt_next[r]);
    const long long row = (long long)r * row_vecs;
    const long long prow = (long long)p * row_vecs;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < row_vecs; i += stride) {
        float xv[L], xp[L], xt[L], ox[L], oxt[L];
        T::unpack(x[row + i], xv);
        if (p == r) {
#pragma unroll
            for (int k = 0; k < L; ++k) xp[k] = xv[k];
        } else {
            T::unpack(x[prow + i], xp);
        }
        T::unpack(x_tilde[row + i], xt);
#pragma unroll
        for (int k = 0; k < L; ++k) {
            p2p_mix<T>(xv[k], xt[k], clean_m<T>(xv[k], xp[k]), a, at, c,
                       ox[k], oxt[k]);
        }
        out_x[row + i] = T::pack(ox);
        x_tilde[row + i] = T::pack(oxt);
    }
}

template <typename T>
void launch(const void *x, void *x_tilde, void *out_x, const void *partner,
            const void *dt_next, const void *eta, const void *alpha,
            const void *alpha_t, long long b, long long w, long long d,
            cudaStream_t stream) {
    const long long row_vecs = d / T::kLanes;
    const dim3 grid(blocks_x(row_vecs), (unsigned)(b * w));
    mixing_gossip_worlds_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const typename T::vec_t *>(x),
        static_cast<typename T::vec_t *>(x_tilde),
        static_cast<typename T::vec_t *>(out_x),
        static_cast<const int *>(partner),
        static_cast<const float *>(dt_next),
        static_cast<const float *>(eta), static_cast<const float *>(alpha),
        static_cast<const float *>(alpha_t), (int)w, row_vecs);
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16.  partner (B, W) int32 with values
// in [0, W); dt_next (B, W) f32; eta, alpha, alpha_t (B,) f32, all on the
// card.  The caller checks shapes, dtypes, contiguity, 16-byte alignment,
// d % 128 == 0 and 1 <= b * w <= 65535.  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int mixing_gossip_worlds_launch(
    int dtype_code, const void *x, void *x_tilde, void *out_x,
    const void *partner, const void *dt_next, const void *eta,
    const void *alpha, const void *alpha_t, long long b, long long w,
    long long d, void *stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype_code == 0) {
        launch<F32>(x, x_tilde, out_x, partner, dt_next, eta, alpha, alpha_t,
                    b, w, d, s);
    } else if (dtype_code == 1) {
        launch<BF16>(x, x_tilde, out_x, partner, dt_next, eta, alpha,
                     alpha_t, b, w, d, s);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
