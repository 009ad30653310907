// One A2CiD2 gossip event on every leaf of a parameter tree, mix then p2p,
// in ONE launch, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/a2cid2_mixing/kernel.py::mixing_p2p
//   (its pallas_call at kernel.py:109), which the JAX package launches once
//   per leaf.
//
// It carries the per-leaf event API (ops.gossip_event_pytree), the
// partner's leaves already mixed.  Element by element, on every leaf:
//   c      = 0.5f * (1.0f - expf(neg2eta * dt[0]))   in f32, then cast
//   d      = xt - x
//   xm     = x  + c * d
//   xtm    = xt - c * d
//   m      = xm - xp
//   out_x  = xm  - alpha   * m
//   out_xt = xtm - alpha_t * m
// The outputs are fresh buffers (the Pallas kernel aliases nothing).  The
// Pallas kernel casts 1 - exp(...) to the dtype before it halves; this
// kernel halves in f32 first, as the plain versions do.  The two agree bit
// for bit: 1 - exp(...) is 0 or at least 2^-24 in f32, far above bf16's
// smallest normal, so halving it is exact at either width.
//
// What bounds it on an H100: memory, and the launches.  The function must
// read x, x~ and xp once and write two outputs, 5 * N * itemsize bytes,
// against 9 f32 operations an element.  ResNet-18-CIFAR's tree is 56 leaves
// of 10 to 2,359,296 elements (44.7 MB a tree at f32, 0.0667 ms at 3.35
// TB/s); 34 of them hold at most 512 elements, far below a microsecond of
// memory traffic, so one launch a leaf spends its time launching.
//
// What the design does about it: one launch takes a table of up to
// kMaxSegments leaves ("segments") BY VALUE, as a __grid_constant__ kernel
// parameter: no copy to the card, no extra stream operation, and a CUDA
// graph captures the table with the launch.  A segment holds its five
// pointers, its length and its split into a scalar head, a body of 16-byte
// vectors and a scalar tail (when the five pointers share their offset
// within 16 bytes; otherwise every element is scalar), and its first block.
// Each block takes one chunk of kChunk elements of one segment, found by a
// binary search over the first blocks (the table sits in the constant bank,
// the search is uniform across the block), and streams it in 16-byte
// vectors with kValues values per array and thread in flight (all loads of
// a trip issued before the arithmetic); the head and tail, fewer than 16
// bytes each, go to the segment's first block.  The wrapper orders the
// segments longest first, so the one-block leaves fill the last wave.
//
// Rounding: the per-element arithmetic is gossip_common.cuh's mix_p2p,
// shared with the other gossip kernels (the _rn intrinsics, no FMA, a bf16
// rounding of every intermediate), so the kernel rounds where the plain
// PyTorch version (ref.py) does.  alpha and alpha_t arrive already rounded
// to the buffer dtype.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmixing_p2p.so mixing_p2p.cu
// Entry point: mixing_p2p_launch (plain C, loaded with ctypes).

#include "gossip_common.cuh"

#include <limits.h>
#include <string.h>

namespace {

using namespace gossip;

// One leaf of the tree, laid out as kernel.py's SEGMENT: elements [0, head)
// scalar, then `body` 16-byte vectors, then the scalar tail up to n
// (head = body = 0 when the five pointers do not share their offset within
// 16 bytes: every element scalar).
struct Segment {
    const void *x;
    const void *x_tilde;
    const void *xp;
    void *out_x;
    void *out_xt;
    long long n;
    long long body;
    int head;
    int first_block;  // the segment's first block in the launch
};
static_assert(sizeof(Segment) == 64, "kernel.py's SEGMENT is 64 bytes");

// Leaves a launch (kernel.py's MAX_SEGMENTS), elements a block (CHUNK), and
// values per array and thread in flight (chosen on the card, PERF.md
// section 6).
constexpr int kMaxSegments = 63;
constexpr long long kChunk = 4096;
constexpr int kValues = 16;

struct Params {
    Segment seg[kMaxSegments];
    const float *dt;
    int count;
    float neg2eta;
    float alpha;
    float alpha_t;
};
// the classic 4 KB limit of a kernel's parameters, which any CUDA 12 build
// and card take
static_assert(sizeof(Params) <= 4096, "the table must fit 4 KB of params");

// 16-byte vectors in flight per array and thread (one at least)
template <typename T>
__host__ __device__ constexpr int vec_unroll() {
    return kValues / T::kLanes > 0 ? kValues / T::kLanes : 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mixing_p2p_kernel(const __grid_constant__ Params p) {
    using E = typename T::elem_t;
    using V = typename T::vec_t;
    constexpr int L = T::kLanes;
    constexpr int U = vec_unroll<T>();
    constexpr long long kChunkVecs = kChunk / L;
    static_assert(kChunk % L == 0, "a chunk holds whole vectors");
    // the segment of this block: the last whose first block is <= it
    const int b = (int)blockIdx.x;
    int lo = 0, hi = p.count - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (p.seg[mid].first_block <= b) {
            lo = mid;
        } else {
            hi = mid - 1;
        }
    }
    const Segment &s = p.seg[lo];
    const long long j = b - s.first_block;
    const E *x = static_cast<const E *>(s.x);
    const E *xt = static_cast<const E *>(s.x_tilde);
    const E *xp = static_cast<const E *>(s.xp);
    E *ox = static_cast<E *>(s.out_x);
    E *oxt = static_cast<E *>(s.out_xt);
    const float c = mix_coeff<T>(p.neg2eta, p.dt[0]);
    // this block's vectors [v0, v1) of the body
    const V *xv = reinterpret_cast<const V *>(x + s.head);
    const V *tv = reinterpret_cast<const V *>(xt + s.head);
    const V *pv = reinterpret_cast<const V *>(xp + s.head);
    V *oxv = reinterpret_cast<V *>(ox + s.head);
    V *otv = reinterpret_cast<V *>(oxt + s.head);
    const long long v0 = j * kChunkVecs;
    const long long v1 = v0 + kChunkVecs < s.body ? v0 + kChunkVecs : s.body;
    for (long long base = v0 + threadIdx.x; base < v1;
         base += (long long)kThreads * U) {
        V a[U], t[U], q[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long i = base + u * kThreads;
            if (i < v1) {
                a[u] = xv[i];
                t[u] = tv[i];
                q[u] = pv[i];
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long i = base + u * kThreads;
            if (i < v1) {
                float fa[L], ft[L], fp[L], fo[L], fot[L];
                T::unpack(a[u], fa);
                T::unpack(t[u], ft);
                T::unpack(q[u], fp);
#pragma unroll
                for (int k = 0; k < L; ++k) {
                    mix_p2p<T>(fa[k], ft[k], fp[k], p.alpha, p.alpha_t, c,
                               fo[k], fot[k]);
                }
                oxv[i] = T::pack(fo);
                otv[i] = T::pack(fot);
            }
        }
    }
    // this block's scalars [e0, e1) of the head and the tail together
    const long long body_end = s.head + s.body * L;
    const long long scalars = s.n - s.body * L;
    const long long e0 = j * kChunk;
    const long long e1 = e0 + kChunk < scalars ? e0 + kChunk : scalars;
    for (long long i = e0 + threadIdx.x; i < e1; i += kThreads) {
        const long long e = i < s.head ? i : body_end + (i - s.head);
        float fo, fot;
        mix_p2p<T>(T::load(x[e]), T::load(xt[e]), T::load(xp[e]), p.alpha,
                   p.alpha_t, c, fo, fot);
        ox[e] = T::store(fo);
        oxt[e] = T::store(fot);
    }
}

template <typename T>
int launch(const Segment *segs, int count, long long blocks, const void *dt,
           float neg2eta, float alpha, float alpha_t, cudaStream_t stream) {
    Params p{};
    memcpy(p.seg, segs, (size_t)count * sizeof(Segment));
    p.dt = static_cast<const float *>(dt);
    p.count = count;
    p.neg2eta = neg2eta;
    p.alpha = alpha;
    p.alpha_t = alpha_t;
    mixing_p2p_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16.  segments points at `count` rows
// of kernel.py's SEGMENT on the host (copied into the launch's parameters
// before this returns), longest first, their first blocks ascending from 0
// and `blocks` blocks in all; chunk must equal kChunk, the elements a block
// that the table was planned with.  alpha and alpha_t are values of the
// dtype; dt points at one float32 on the card.  Every segment holds n >= 1
// elements, its outputs distinct from its inputs.  Returns
// cudaErrorInvalidValue for a table this build cannot take, else
// cudaGetLastError() after the launch (0 = launched).
extern "C" int mixing_p2p_launch(int dtype_code, const void *segments,
                                 int count, long long blocks,
                                 long long chunk, const void *dt,
                                 float neg2eta, float alpha, float alpha_t,
                                 void *stream) {
    if (count < 1 || count > kMaxSegments || chunk != kChunk || blocks < 1
        || blocks > INT_MAX) {
        return (int)cudaErrorInvalidValue;
    }
    const Segment *segs = static_cast<const Segment *>(segments);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype_code == 0) {
        return launch<F32>(segs, count, blocks, dt, neg2eta, alpha, alpha_t,
                           s);
    }
    if (dtype_code == 1) {
        return launch<BF16>(segs, count, blocks, dt, neg2eta, alpha, alpha_t,
                            s);
    }
    return (int)cudaErrorInvalidValue;
}
