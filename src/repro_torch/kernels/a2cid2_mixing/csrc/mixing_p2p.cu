// One A2CiD2 gossip event on flat tensors of any length, mix then p2p,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/a2cid2_mixing/kernel.py::mixing_p2p
//   (its pallas_call at kernel.py:109).
//
// It carries the per-leaf event API (ops.gossip_event_pytree): one launch
// per leaf of a parameter tree, the partner's leaf already mixed.  Element
// by element:
//   c      = 0.5f * (1.0f - expf(neg2eta * dt[0]))   in f32, then cast
//   d      = xt - x
//   xm     = x  + c * d
//   xtm    = xt - c * d
//   m      = xm - xp
//   out_x  = xm  - alpha   * m
//   out_xt = xtm - alpha_t * m
// Both outputs are fresh buffers (the Pallas kernel aliases nothing).  The
// Pallas kernel casts 1 - exp(...) to the dtype before it halves; this
// kernel halves in f32 first, as the plain versions do.  The two agree bit
// for bit: 1 - exp(...) is 0 or at least 2^-24 in f32, far above bf16's
// smallest normal, so halving it is exact at either width.
//
// What bounds it on an H100: memory, or at small leaves the launch itself.
// The function must read x, x~ and xp once and write two outputs, 5 * N *
// itemsize bytes, against 9 f32 operations an element.  On ResNet-18-CIFAR
// the 56 leaves range from 10 to 2,359,296 elements: most launches are far
// below a microsecond of memory traffic.
//
// What the design does about it: the leaves have any length and the five
// pointers any 4- or 2-byte alignment, and the kernel makes no padded copy
// (JAX's jnp.pad would be one on the card).  When the five pointers share
// their offset within 16 bytes, a scalar head brings them to a 16-byte
// boundary, the body streams 16-byte vectors (grid-stride, fully coalesced)
// and a scalar tail finishes the last < 16 bytes; otherwise every element
// is scalar.  Batching all leaves of a tree into one launch is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmixing_p2p.so mixing_p2p.cu
// Entry point: mixing_p2p_launch (plain C, loaded with ctypes).

#include "gossip_common.cuh"

namespace {

using namespace gossip;

template <typename T>
__global__ void __launch_bounds__(kThreads)
mixing_p2p_kernel(const typename T::elem_t *__restrict__ x,
                  const typename T::elem_t *__restrict__ x_tilde,
                  const typename T::elem_t *__restrict__ xp,
                  typename T::elem_t *__restrict__ out_x,
                  typename T::elem_t *__restrict__ out_xt,
                  const float *__restrict__ dt, long long n, long long head,
                  long long vecs, float neg2eta, float alpha,
                  float alpha_t) {
    using V = typename T::vec_t;
    constexpr int L = T::kLanes;
    const float c = mix_coeff<T>(neg2eta, dt[0]);
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    // scalar head [0, head) and tail [head + vecs * L, n)
    const long long body_end = head + vecs * L;
    const long long scalars = head + (n - body_end);
    for (long long i = tid; i < scalars; i += stride) {
        const long long e = i < head ? i : body_end + (i - head);
        float ox, oxt;
        mix_p2p<T>(T::load(x[e]), T::load(x_tilde[e]), T::load(xp[e]),
                   alpha, alpha_t, c, ox, oxt);
        out_x[e] = T::store(ox);
        out_xt[e] = T::store(oxt);
    }
    // 16-byte vector body
    const V *xv = reinterpret_cast<const V *>(x + head);
    const V *tv = reinterpret_cast<const V *>(x_tilde + head);
    const V *pv = reinterpret_cast<const V *>(xp + head);
    V *oxv = reinterpret_cast<V *>(out_x + head);
    V *otv = reinterpret_cast<V *>(out_xt + head);
    for (long long i = tid; i < vecs; i += stride) {
        float a[L], t[L], p[L], ox[L], oxt[L];
        T::unpack(xv[i], a);
        T::unpack(tv[i], t);
        T::unpack(pv[i], p);
#pragma unroll
        for (int k = 0; k < L; ++k) {
            mix_p2p<T>(a[k], t[k], p[k], alpha, alpha_t, c, ox[k], oxt[k]);
        }
        oxv[i] = T::pack(ox);
        otv[i] = T::pack(oxt);
    }
}

template <typename T>
void launch(const void *x, const void *x_tilde, const void *xp, void *out_x,
            void *out_xt, const void *dt, long long n, float neg2eta,
            float alpha, float alpha_t, cudaStream_t stream) {
    using E = typename T::elem_t;
    constexpr long long L = T::kLanes;
    // the vector body needs the five pointers at one offset within 16 bytes
    const uintptr_t off = (uintptr_t)x % 16;
    const bool same = (uintptr_t)x_tilde % 16 == off
        && (uintptr_t)xp % 16 == off && (uintptr_t)out_x % 16 == off
        && (uintptr_t)out_xt % 16 == off && off % sizeof(E) == 0;
    long long head = n, vecs = 0;
    if (same) {
        head = (long long)((16 - off) % 16 / sizeof(E));
        if (head > n) head = n;
        vecs = (n - head) / L;
    }
    mixing_p2p_kernel<T><<<blocks_x(vecs > 0 ? vecs : n), kThreads, 0,
                           stream>>>(
        static_cast<const E *>(x), static_cast<const E *>(x_tilde),
        static_cast<const E *>(xp), static_cast<E *>(out_x),
        static_cast<E *>(out_xt), static_cast<const float *>(dt), n, head,
        vecs, neg2eta, alpha, alpha_t);
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16; alpha and alpha_t are values of
// that dtype; dt points at one float32 on the card.  The five buffers hold
// n >= 1 elements each, contiguous, the outputs distinct from the inputs.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int mixing_p2p_launch(int dtype_code, const void *x,
                                 const void *x_tilde, const void *xp,
                                 void *out_x, void *out_xt, const void *dt,
                                 long long n, float neg2eta, float alpha,
                                 float alpha_t, void *stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype_code == 0) {
        launch<F32>(x, x_tilde, xp, out_x, out_xt, dt, n, neg2eta, alpha,
                    alpha_t, s);
    } else if (dtype_code == 1) {
        launch<BF16>(x, x_tilde, xp, out_x, out_xt, dt, n, neg2eta, alpha,
                     alpha_t, s);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
