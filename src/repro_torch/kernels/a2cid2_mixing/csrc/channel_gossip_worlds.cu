// One unreliable-channel A2CiD2 gossip batch over B worlds' worker-stacked
// flat buffers at once, (B, W, D), p2p then mix, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/a2cid2_mixing/kernel.py::channel_gossip_worlds
//   (its pallas_call at kernel.py:469).
//
// The partner values arrive PRE-GATHERED in xp (fresh rows or snapshot-ring
// rows of the same world, resolved by the caller), so every operand streams
// by its own row.  For every world b and worker row w:
//   cadv   = (1 + corrupt[b, w])         in f32, then rounded to the dtype
//   m      = (x[b, w] - cadv * xp[b, w]) * dtype(mscale[b, w])
//   m      = clamp(m, -clip, +clip)      only with a clip; NaN propagates
//   x1     = x[b, w]  - dtype(alpha[b])   * m
//   xt1    = xt[b, w] - dtype(alpha_t[b]) * m
//   c      = 0.5f * (1.0f - expf((-2 * eta[b]) * dt_next[b, w])), then cast
//   d      = xt1 - x1
//   out_x[b, w] = x1  + c * d
//   xt[b, w]    = xt1 - c * d            (x~ is updated in place)
//   rej[b, w]   = (mscale[b, w] == 0) ? 1 : 0  (only when rej is not null)
// This is channel_gossip_stacked on world b with that world's scalars, bit
// for bit (the shared gossip_common.cuh arithmetic; -2 * eta[b] in f32
// equals the stacked kernel's f32(-2 * eta)).  The coordinate clip is one
// value for every world, as the JAX kernel's static clip is.
//
// What bounds it on an H100: memory.  The function must read x, xp and x~
// once and write two (B, W, D) outputs, 5 * B * W * D * itemsize bytes.  At
// (4, 16, 11,171,328) f32 that is 14.30 GB, 4.268 ms at 3.35 TB/s, against
// 11 f32 operations an element (7.9 GFLOP, about 117 us at 67 TFLOP/s).
//
// What the design does about it: every byte moves exactly once per launch.
// blockIdx.y is the global row b * W + w (B * W <= 65535); each block loads
// its corrupt, mscale and dt and the world's eta, alpha and alpha_t from
// device memory itself.  blockIdx.x strides along the row in 16-byte
// vectors (fully coalesced 512-byte warp accesses; LANE padding keeps every
// row 16-byte aligned).  Fusing the caller's partner gather and delta-norm
// reduce into this pass is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libchannel_gossip_worlds.so channel_gossip_worlds.cu
// Entry point: channel_gossip_worlds_launch (plain C, loaded with ctypes).

#include "gossip_common.cuh"

namespace {

using namespace gossip;

template <typename T, bool kClip>
__global__ void __launch_bounds__(kThreads)
channel_gossip_worlds_kernel(const typename T::vec_t *__restrict__ x,
                             const typename T::vec_t *__restrict__ xp,
                             typename T::vec_t *x_tilde,
                             typename T::vec_t *__restrict__ out_x,
                             const float *__restrict__ corrupt,
                             const float *__restrict__ mscale,
                             const float *__restrict__ dt_next,
                             const float *__restrict__ eta,
                             const float *__restrict__ alpha,
                             const float *__restrict__ alpha_t,
                             float *__restrict__ rej, int w_dim,
                             long long row_vecs, float clip) {
    constexpr int L = T::kLanes;
    const int r = blockIdx.y;          // global row b * W + w
    const int b = r / w_dim;
    const float ms32 = mscale[r];
    const float cadv = T::round(__fadd_rn(1.0f, corrupt[r]));
    const float ms = T::round(ms32);
    const float a = T::round(alpha[b]);
    const float at = T::round(alpha_t[b]);
    const float c = mix_coeff<T>(__fmul_rn(-2.0f, eta[b]), dt_next[r]);
    if (rej != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
        rej[r] = ms32 == 0.0f ? 1.0f : 0.0f;
    }
    const long long row = (long long)r * row_vecs;
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
                       channel_m<T, kClip>(xv[k], pv[k], cadv, ms, clip), a,
                       at, c, ox[k], oxt[k]);
        }
        out_x[row + i] = T::pack(ox);
        x_tilde[row + i] = T::pack(oxt);
    }
}

struct Args {
    const void *x, *xp;
    void *x_tilde, *out_x;
    const void *corrupt, *mscale, *dt_next, *eta, *alpha, *alpha_t;
    void *rej;
    long long b, w, d;
    float clip;
};

template <typename T, bool kClip>
void launch(const Args &a, cudaStream_t stream) {
    const long long row_vecs = a.d / T::kLanes;
    const dim3 grid(blocks_x(row_vecs), (unsigned)(a.b * a.w));
    channel_gossip_worlds_kernel<T, kClip><<<grid, kThreads, 0, stream>>>(
        static_cast<const typename T::vec_t *>(a.x),
        static_cast<const typename T::vec_t *>(a.xp),
        static_cast<typename T::vec_t *>(a.x_tilde),
        static_cast<typename T::vec_t *>(a.out_x),
        static_cast<const float *>(a.corrupt),
        static_cast<const float *>(a.mscale),
        static_cast<const float *>(a.dt_next),
        static_cast<const float *>(a.eta),
        static_cast<const float *>(a.alpha),
        static_cast<const float *>(a.alpha_t), static_cast<float *>(a.rej),
        (int)a.w, row_vecs, a.clip);
}

template <typename T>
void launch_clip(int has_clip, const Args &a, cudaStream_t stream) {
    if (has_clip) {
        launch<T, true>(a, stream);
    } else {
        launch<T, false>(a, stream);
    }
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16.  corrupt, mscale, dt_next (B, W)
// f32; eta, alpha, alpha_t (B,) f32, all on the card.  has_clip: 0 = no
// coordinate clip (clip is ignored), 1 = clamp m to [-clip, clip], with
// clip already rounded to the buffer dtype.  rej may be null (no rejection
// mask), else (B, W) f32.  The caller checks shapes, dtypes, contiguity,
// 16-byte alignment, d % 128 == 0 and 1 <= b * w <= 65535.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int channel_gossip_worlds_launch(
    int dtype_code, const void *x, const void *xp, void *x_tilde,
    void *out_x, const void *corrupt, const void *mscale,
    const void *dt_next, const void *eta, const void *alpha,
    const void *alpha_t, void *rej, long long b, long long w, long long d,
    int has_clip, float clip, void *stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Args a{x, xp, x_tilde, out_x, corrupt, mscale, dt_next, eta, alpha,
                 alpha_t, rej, b, w, d, clip};
    if (dtype_code == 0) {
        launch_clip<F32>(has_clip, a, s);
    } else if (dtype_code == 1) {
        launch_clip<BF16>(has_clip, a, s);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
