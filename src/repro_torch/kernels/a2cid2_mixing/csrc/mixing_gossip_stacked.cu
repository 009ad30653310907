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
// What the design does about it: the two rows of a pair are read once,
// together.  blockIdx.y is a worker row w and blockIdx.x strides along it
// in 16-byte vectors (a warp issues fully coalesced 512-byte accesses;
// LANE padding of D to 128 elements keeps every row 16-byte aligned).  Each
// block loads partner[w], partner[partner[w]] and the dt_next it needs
// itself (no scalar prefetch on the card, no synchronisation with the
// host), and takes one of three paths:
//   - pair (p = partner[w] != w and partner[p] == w): the blocks of rows
//     min(w, p) and max(w, p) share the pair's columns, the first half and
//     the second.  A block reads x[w], x[p], x~[w] and x~[p] at its columns
//     once and writes out_x and x~ of both rows, so every row's blocks stay
//     busy and the pair's bytes move once: 4 * 2 * D * itemsize a pair;
//   - idle (p == w): the row alone, its own x standing in for the partner's
//     (2 reads, 2 writes a row);
//   - a row outside the contract (partner[p] != w: the map is not an
//     involution there): the row alone, reading x[p] once more, as the
//     first design did, so any partner map gives the plain version's
//     answer (3 reads, 2 writes a row).
// Partner maps come from matchings (involutions), so the pair and idle
// paths move exactly the bound's bytes.  Each thread keeps 16 values per
// array in flight per loop trip (4 f32 or 2 bf16 16-byte vectors, all
// loads issued before the arithmetic; 4 arrays in a pair), and the blocks
// along a row (at least two trips each, at most 16384 blocks) all make the
// same number of trips.
//
// Rounding: the per-element arithmetic lives in gossip_common.cuh, shared
// with the other five gossip kernels (the _rn intrinsics, no FMA, a bf16
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

// 16-byte vectors in flight per array per thread and loop trip: 16 values,
// 4 f32 vectors or 2 bf16 ones (chosen on the card, PERF.md section 6)
template <typename T>
__host__ __device__ constexpr int unroll() {
    return 16 / T::kLanes;
}

// Blocks along a row: each block makes at least two loop trips (so its
// prologue, the partner, dt_next and expf loads, is paid for twice over),
// and at most kMaxBlocks blocks share a row (fewer trips a block keep the
// blocks in flight on a narrower window of a long row); every block makes
// the same number of trips.  Chosen on the card, PERF.md section 6.
constexpr long long kMaxBlocks = 16384;
constexpr long long kMinTrips = 2;

template <typename T>
unsigned row_blocks(long long row_vecs) {
    const long long per_trip = (long long)kThreads * unroll<T>();
    long long trips = (row_vecs + per_trip * kMaxBlocks - 1)
                    / (per_trip * kMaxBlocks);
    if (trips < kMinTrips) trips = kMinTrips;
    const long long blocks = (row_vecs + per_trip * trips - 1)
                           / (per_trip * trips);
    return (unsigned)(blocks > 0 ? blocks : 1);
}

enum Path { kIdle, kPair, kRow };

// One block's columns [begin, end) of row a (vectors from row offset ra),
// against row b (offset rb) as its partner: kIdle reads only row a, kPair
// updates both rows, kRow reads x[b] and updates row a only.
template <typename T, int kPath>
__device__ __forceinline__ void gossip_pass(
    const typename T::vec_t *__restrict__ x, typename T::vec_t *x_tilde,
    typename T::vec_t *__restrict__ out_x, long long ra, long long rb,
    long long begin, long long end, float alpha, float alpha_t, float ca,
    float cb) {
    using vec_t = typename T::vec_t;
    constexpr int L = T::kLanes;
    constexpr int U = unroll<T>();
    const long long step = (long long)gridDim.x * kThreads * U;
    for (long long base = begin + (long long)blockIdx.x * kThreads * U
                          + threadIdx.x;
         base < end; base += step) {
        vec_t xa[U], xb[U], ta[U], tb[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long i = base + u * kThreads;
            if (i < end) {
                xa[u] = x[ra + i];
                if (kPath != kIdle) xb[u] = x[rb + i];
                ta[u] = x_tilde[ra + i];
                if (kPath == kPair) tb[u] = x_tilde[rb + i];
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long i = base + u * kThreads;
            if (i < end) {
                float fa[L], fb[L], fta[L], ox[L], oxt[L];
                T::unpack(xa[u], fa);
                if (kPath == kIdle) {
#pragma unroll
                    for (int k = 0; k < L; ++k) fb[k] = fa[k];
                } else {
                    T::unpack(xb[u], fb);
                }
                T::unpack(ta[u], fta);
#pragma unroll
                for (int k = 0; k < L; ++k) {
                    p2p_mix<T>(fa[k], fta[k], clean_m<T>(fa[k], fb[k]),
                               alpha, alpha_t, ca, ox[k], oxt[k]);
                }
                out_x[ra + i] = T::pack(ox);
                x_tilde[ra + i] = T::pack(oxt);
                if (kPath == kPair) {
                    float ftb[L];
                    T::unpack(tb[u], ftb);
#pragma unroll
                    for (int k = 0; k < L; ++k) {
                        p2p_mix<T>(fb[k], ftb[k], clean_m<T>(fb[k], fa[k]),
                                   alpha, alpha_t, cb, ox[k], oxt[k]);
                    }
                    out_x[rb + i] = T::pack(ox);
                    x_tilde[rb + i] = T::pack(oxt);
                }
            }
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mixing_gossip_stacked_kernel(const typename T::vec_t *__restrict__ x,
                             typename T::vec_t *x_tilde,
                             typename T::vec_t *__restrict__ out_x,
                             const int *__restrict__ partner,
                             const float *__restrict__ dt_next,
                             long long row_vecs, float neg2eta, float alpha,
                             float alpha_t) {
    const int w = blockIdx.y;
    const int p = partner[w];
    const float c = mix_coeff<T>(neg2eta, dt_next[w]);
    const long long row = (long long)w * row_vecs;
    const long long prow = (long long)p * row_vecs;
    if (p == w) {
        gossip_pass<T, kIdle>(x, x_tilde, out_x, row, row, 0, row_vecs,
                              alpha, alpha_t, c, c);
    } else if (partner[p] == w) {
        const long long half = (row_vecs + 1) / 2;
        gossip_pass<T, kPair>(x, x_tilde, out_x, row, prow,
                              w < p ? 0 : half, w < p ? half : row_vecs,
                              alpha, alpha_t, c,
                              mix_coeff<T>(neg2eta, dt_next[p]));
    } else {
        gossip_pass<T, kRow>(x, x_tilde, out_x, row, prow, 0, row_vecs,
                             alpha, alpha_t, c, c);
    }
}

template <typename T>
void launch(const void *x, void *x_tilde, void *out_x, const void *partner,
            const void *dt_next, long long w, long long d, float neg2eta,
            float alpha, float alpha_t, cudaStream_t stream) {
    const long long row_vecs = d / T::kLanes;
    const dim3 grid(row_blocks<T>(row_vecs), (unsigned)w);
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
