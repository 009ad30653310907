// One A2CiD2 gossip event on ONE worker's flat (D,) vectors, p2p then mix,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/a2cid2_mixing/kernel.py::p2p_mixing
//   (its pallas_call at kernel.py:174).
//
// It carries the per-worker (SPMD) trainer path: in each event every worker
// launches it once on its own vectors, with the partner's payload (its
// current x, or a snapshot from its delay ring) as xp.  Element by element:
//   m      = x  - xp
//   x1     = x  - alpha   * m
//   xt1    = xt - alpha_t * m
//   c      = 0.5f * (1.0f - expf(neg2eta * dt_next[0]))   in f32, then cast
//   d      = xt1 - x1
//   out_x  = x1  + c * d
//   xt     = xt1 - c * d          (x~ is updated in place)
// out_x is a separate buffer: a later worker of the same event may still
// read this worker's x as its partner value.  An idle or dropped worker
// passes its own x as xp (m = 0), so its launch is a pure mixing step.
// dt_next is a pointer into the event-gap tensor on the card, so the
// caller never waits for the card to read it.
//
// What bounds it on an H100: memory.  The function must read x, x~ and xp
// once and write two (D,) outputs, 5 * D * itemsize bytes.  At D =
// 11,171,328 f32 that is 223.4 MB, 0.0667 ms at 3.35 TB/s, against 9 f32
// operations an element (0.1 GFLOP, 1.5 us at 67 TFLOP/s).
//
// What the design does about it: every byte moves once.  The grid strides
// over the vector in 16-byte vectors, so a warp issues fully coalesced
// 512-byte accesses; LANE padding of D to 128 elements keeps the vectors
// 16-byte aligned and whole.  The per-element arithmetic is
// gossip_common.cuh's (clean_m, p2p_mix, mix_coeff), so each worker's result
// is bit for bit the row that mixing_gossip_stacked computes for it.
// Fusing the W launches of an event into one (the stacked kernel) is what
// the single-card stacked trainer does; this kernel keeps the per-chip work
// of the TPU path.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libp2p_mixing.so p2p_mixing.cu
// Entry point: p2p_mixing_launch (plain C, loaded with ctypes).

#include "gossip_common.cuh"

namespace {

using namespace gossip;

template <typename T>
__global__ void __launch_bounds__(kThreads)
p2p_mixing_kernel(const typename T::vec_t *__restrict__ x,
                  typename T::vec_t *x_tilde,
                  const typename T::vec_t *__restrict__ xp,
                  typename T::vec_t *__restrict__ out_x,
                  const float *__restrict__ dt_next, long long vecs,
                  float neg2eta, float alpha, float alpha_t) {
    constexpr int L = T::kLanes;
    const float c = mix_coeff<T>(neg2eta, dt_next[0]);
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < vecs; i += stride) {
        float xv[L], pv[L], xt[L], ox[L], oxt[L];
        T::unpack(x[i], xv);
        T::unpack(xp[i], pv);
        T::unpack(x_tilde[i], xt);
#pragma unroll
        for (int k = 0; k < L; ++k) {
            p2p_mix<T>(xv[k], xt[k], clean_m<T>(xv[k], pv[k]), alpha,
                       alpha_t, c, ox[k], oxt[k]);
        }
        out_x[i] = T::pack(ox);
        x_tilde[i] = T::pack(oxt);
    }
}

template <typename T>
void launch(const void *x, void *x_tilde, const void *xp, void *out_x,
            const void *dt_next, long long d, float neg2eta, float alpha,
            float alpha_t, cudaStream_t stream) {
    const long long vecs = d / T::kLanes;
    p2p_mixing_kernel<T><<<blocks_x(vecs), kThreads, 0, stream>>>(
        static_cast<const typename T::vec_t *>(x),
        static_cast<typename T::vec_t *>(x_tilde),
        static_cast<const typename T::vec_t *>(xp),
        static_cast<typename T::vec_t *>(out_x),
        static_cast<const float *>(dt_next), vecs, neg2eta, alpha, alpha_t);
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16; alpha and alpha_t are values of
// that dtype; dt_next points at one float32 on the card.  The caller checks
// shapes, dtypes, contiguity, 16-byte alignment and d % 128 == 0.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int p2p_mixing_launch(int dtype_code, const void *x,
                                 void *x_tilde, const void *xp, void *out_x,
                                 const void *dt_next, long long d,
                                 float neg2eta, float alpha, float alpha_t,
                                 void *stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype_code == 0) {
        launch<F32>(x, x_tilde, xp, out_x, dt_next, d, neg2eta, alpha,
                    alpha_t, s);
    } else if (dtype_code == 1) {
        launch<BF16>(x, x_tilde, xp, out_x, dt_next, d, neg2eta, alpha,
                     alpha_t, s);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
