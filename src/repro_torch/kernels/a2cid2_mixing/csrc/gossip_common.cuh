// Per-element arithmetic shared by the four fused A2CiD2 gossip kernels
// (mixing_gossip_stacked, channel_gossip_stacked, mixing_gossip_worlds,
// channel_gossip_worlds), so that the serial and the world-batched kernels
// cannot drift apart: per world, a worlds kernel computes exactly what its
// stacked twin computes with that world's scalars.
//
// Rounding: every product, sum and difference uses the _rn intrinsics, which
// nvcc never contracts into an FMA, and for bf16 every intermediate is
// rounded to bf16 (T::round), so the kernels round where the plain PyTorch
// versions (ref.py) do.  alpha and alpha~ must arrive as values of the
// buffer dtype (the stacked wrappers round them on the host, the worlds
// kernels with T::round on the card); the mixing coefficient is computed in
// f32 from -2 * eta and rounded once to the buffer dtype.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gossip {

constexpr int kThreads = 256;
// grid-stride cap on blocks along a row: enough blocks in flight to cover
// the 132 SMs many times over, few enough to amortise each block's scalar
// loads over several vectors per thread
constexpr long long kMaxBlocksX = 2048;

struct F32 {
    using vec_t = float4;
    static constexpr int kLanes = 4;
    __device__ static __forceinline__ float round(float v) { return v; }
    __device__ static __forceinline__ void unpack(const float4 &v, float *o) {
        o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    }
    __device__ static __forceinline__ float4 pack(const float *i) {
        return make_float4(i[0], i[1], i[2], i[3]);
    }
};

struct BF16 {
    using vec_t = uint4;  // 8 bf16 values, little-endian pairs per word
    static constexpr int kLanes = 8;
    __device__ static __forceinline__ float round(float v) {
        return __bfloat162float(__float2bfloat16_rn(v));
    }
    __device__ static __forceinline__ void unpack(const uint4 &v, float *o) {
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            o[2 * k] = __uint_as_float(w[k] << 16);
            o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
        }
    }
    // inputs are already bf16 values (see round), so keeping the high
    // half of each f32 pattern is exact
    __device__ static __forceinline__ uint4 pack(const float *i) {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            w[k] = (__float_as_uint(i[2 * k]) >> 16)
                 | (__float_as_uint(i[2 * k + 1]) & 0xffff0000u);
        }
        return make_uint4(w[0], w[1], w[2], w[3]);
    }
};

// blocks along a row of row_vecs 16-byte vectors
inline unsigned blocks_x(long long row_vecs) {
    long long bx = (row_vecs + kThreads - 1) / kThreads;
    if (bx > kMaxBlocksX) bx = kMaxBlocksX;
    if (bx < 1) bx = 1;
    return (unsigned)bx;
}

// the off-diagonal mixing weight 0.5 * (1 - exp(-2 eta dt)) in f32, then
// rounded to the buffer dtype
template <typename T>
__device__ __forceinline__ float mix_coeff(float neg2eta, float dt) {
    return T::round(__fmul_rn(
        0.5f, __fsub_rn(1.0f, expf(__fmul_rn(neg2eta, dt)))));
}

// clean m-term: x - x[partner]
template <typename T>
__device__ __forceinline__ float clean_m(float x, float xp) {
    return T::round(__fsub_rn(x, xp));
}

// clamp to [-c, c] that lets NaN through (fminf/fmaxf would drop it, and
// jnp.clip / torch.clamp keep it): every comparison with NaN is false
__device__ __forceinline__ float clamp_nan(float v, float c) {
    return v < -c ? -c : (v > c ? c : v);
}

// channel m-term: (x - cadv * xp) * ms, clamped to [-clip, clip] with a
// clip; cadv = dtype(1 + corrupt), ms = dtype(mscale), clip of the dtype
template <typename T, bool kClip>
__device__ __forceinline__ float channel_m(float x, float xp, float cadv,
                                           float ms, float clip) {
    const float recv = T::round(__fmul_rn(cadv, xp));
    float m = T::round(__fmul_rn(T::round(__fsub_rn(x, recv)), ms));
    if (kClip) m = clamp_nan(m, clip);
    return m;
}

// the p2p update from m, then the mixing step with coefficient c
template <typename T>
__device__ __forceinline__ void p2p_mix(float x, float xt, float m,
                                        float alpha, float alpha_t, float c,
                                        float &out_x, float &out_xt) {
    const float x1 = T::round(__fsub_rn(x, T::round(__fmul_rn(alpha, m))));
    const float xt1 = T::round(
        __fsub_rn(xt, T::round(__fmul_rn(alpha_t, m))));
    const float d = T::round(__fsub_rn(xt1, x1));
    const float cd = T::round(__fmul_rn(c, d));
    out_x = T::round(__fadd_rn(x1, cd));
    out_xt = T::round(__fsub_rn(xt1, cd));
}

}  // namespace gossip
