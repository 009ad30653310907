// One unreliable-channel A2CiD2 gossip batch on worker-stacked (W, D) flat
// buffers, p2p then mix, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/a2cid2_mixing/kernel.py::channel_gossip_stacked
//   (its pallas_call at kernel.py:584).
//
// The partner values arrive PRE-GATHERED in xp (fresh rows or snapshot-ring
// rows, resolved by the caller), so every operand streams by its own row and
// the kernel does no partner gather.  For every worker row w:
//   cadv   = (1 + corrupt[w])            in f32, then rounded to the dtype
//   m      = (x[w] - cadv * xp[w]) * dtype(mscale[w])
//   m      = clamp(m, -clip, +clip)      only with a clip; NaN propagates
//   x1     = x[w]  - alpha   * m
//   xt1    = xt[w] - alpha_t * m
//   c      = 0.5f * (1.0f - expf(neg2eta * dt_next[w]))   in f32, then cast
//   d      = xt1 - x1
//   out_x[w] = x1  + c * d
//   xt[w]    = xt1 - c * d              (x~ is updated in place)
//   rej[w]   = (mscale[w] == 0) ? 1 : 0 (only when rej is not null)
// With corrupt = 0, mscale = 1 and no clip, m = x - xp exactly, so the
// output equals mixing_gossip_stacked's bit for bit when xp = x[partner].
//
// What bounds it on an H100: memory.  The function must read x, xp and x~
// once and write two (W, D) outputs, 5 * W * D * itemsize bytes.  At
// (16, 11,171,328) f32 that is 3.575 GB, 1.067 ms at 3.35 TB/s, against
// about 12 f32 operations an element (2.1 GFLOP, about 32 us at
// 67 TFLOP/s).
//
// What the design does about it: every byte moves exactly once per launch.
// blockIdx.y is the worker row; each block loads corrupt[w], mscale[w] and
// dt_next[w] itself (there is no scalar prefetch on the card).  blockIdx.x
// strides along the row in 16-byte vectors, so a warp issues fully
// coalesced 512-byte accesses; LANE padding of D to 128 elements keeps every
// row 16-byte aligned.  Fusing the caller's partner gather and delta-norm
// reduce into this pass, and pipelining the loads, are later work.
//
// Rounding: the per-element arithmetic lives in gossip_common.cuh, shared
// with the other three gossip kernels; for bf16 it rounds cadv, mscale and
// every intermediate to bf16, so the kernel rounds where the plain PyTorch
// version (ref.py) does.  The clip, alpha and alpha_t arrive already
// rounded to the dtype.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libchannel_gossip_stacked.so channel_gossip_stacked.cu
// Entry point: channel_gossip_stacked_launch (plain C, loaded with ctypes).

#include "gossip_common.cuh"

namespace {

using namespace gossip;

template <typename T, bool kClip>
__global__ void __launch_bounds__(kThreads)
channel_gossip_stacked_kernel(const typename T::vec_t *__restrict__ x,
                              const typename T::vec_t *__restrict__ xp,
                              typename T::vec_t *x_tilde,
                              typename T::vec_t *__restrict__ out_x,
                              const float *__restrict__ corrupt,
                              const float *__restrict__ mscale,
                              const float *__restrict__ dt_next,
                              float *__restrict__ rej, long long row_vecs,
                              float neg2eta, float alpha, float alpha_t,
                              float clip) {
    constexpr int L = T::kLanes;
    const int w = blockIdx.y;
    const float ms32 = mscale[w];
    const float cadv = T::round(__fadd_rn(1.0f, corrupt[w]));
    const float ms = T::round(ms32);
    const float c = mix_coeff<T>(neg2eta, dt_next[w]);
    if (rej != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
        rej[w] = ms32 == 0.0f ? 1.0f : 0.0f;
    }
    const long long row = (long long)w * row_vecs;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < row_vecs; i += stride) {
        float xv[L], pv[L], xt[L], ox[L], oxt[L];
        T::unpack(x[row + i], xv);
        T::unpack(xp[row + i], pv);
        T::unpack(x_tilde[row + i], xt);
#pragma unroll
        for (int k = 0; k < L; ++k) {
            p2p_mix<T>(xv[k], xt[k],
                       channel_m<T, kClip>(xv[k], pv[k], cadv, ms, clip),
                       alpha, alpha_t, c, ox[k], oxt[k]);
        }
        out_x[row + i] = T::pack(ox);
        x_tilde[row + i] = T::pack(oxt);
    }
}

template <typename T, bool kClip>
void launch(const void *x, const void *xp, void *x_tilde, void *out_x,
            const void *corrupt, const void *mscale, const void *dt_next,
            void *rej, long long w, long long d, float neg2eta, float alpha,
            float alpha_t, float clip, cudaStream_t stream) {
    const long long row_vecs = d / T::kLanes;
    const dim3 grid(blocks_x(row_vecs), (unsigned)w);
    channel_gossip_stacked_kernel<T, kClip><<<grid, kThreads, 0, stream>>>(
        static_cast<const typename T::vec_t *>(x),
        static_cast<const typename T::vec_t *>(xp),
        static_cast<typename T::vec_t *>(x_tilde),
        static_cast<typename T::vec_t *>(out_x),
        static_cast<const float *>(corrupt),
        static_cast<const float *>(mscale),
        static_cast<const float *>(dt_next), static_cast<float *>(rej),
        row_vecs, neg2eta, alpha, alpha_t, clip);
}

template <typename T>
void launch_clip(int has_clip, const void *x, const void *xp, void *x_tilde,
                 void *out_x, const void *corrupt, const void *mscale,
                 const void *dt_next, void *rej, long long w, long long d,
                 float neg2eta, float alpha, float alpha_t, float clip,
                 cudaStream_t stream) {
    if (has_clip) {
        launch<T, true>(x, xp, x_tilde, out_x, corrupt, mscale, dt_next, rej,
                        w, d, neg2eta, alpha, alpha_t, clip, stream);
    } else {
        launch<T, false>(x, xp, x_tilde, out_x, corrupt, mscale, dt_next,
                         rej, w, d, neg2eta, alpha, alpha_t, clip, stream);
    }
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16.  has_clip: 0 = no coordinate clip
// (clip is ignored), 1 = clamp m to [-clip, clip], with clip already rounded
// to the buffer dtype.  rej may be null (no rejection mask).  The caller
// checks shapes, dtypes, contiguity, 16-byte alignment, d % 128 == 0 and
// 1 <= w <= 65535.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int channel_gossip_stacked_launch(
    int dtype_code, const void *x, const void *xp, void *x_tilde,
    void *out_x, const void *corrupt, const void *mscale,
    const void *dt_next, void *rej, long long w, long long d, float neg2eta,
    float alpha, float alpha_t, int has_clip, float clip, void *stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype_code == 0) {
        launch_clip<F32>(has_clip, x, xp, x_tilde, out_x, corrupt, mscale,
                         dt_next, rej, w, d, neg2eta, alpha, alpha_t, clip, s);
    } else if (dtype_code == 1) {
        launch_clip<BF16>(has_clip, x, xp, x_tilde, out_x, corrupt, mscale,
                          dt_next, rej, w, d, neg2eta, alpha, alpha_t, clip,
                          s);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
