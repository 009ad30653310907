// The tail of a gradient tick of the clean replay in ONE pass over
// worker-stacked (W, D) flat buffers, written by hand for Hopper (sm_90a):
// the descent on both buffers, the round's metrics row and the trailing
// mixing segment.
//
// Replaces no TPU kernel: the JAX package leaves this tail to XLA, which
// fuses it.  The port ran it as some 25 eager PyTorch launches a tick
// (Simulator._descend with FlatLayout.pack of the gradients, the metrics
// row, a2cid2.apply_mixing): 31 passes over a (W, D) buffer where the
// arithmetic needs 5.
//
// Element by element, for every worker row w and column j of a leaf (g the
// leaf's value, read in place and cast to the buffer dtype as pack casts
// it; s = dtype(gscale[w]), gamma a value of the buffer dtype, c =
// dtype(coeff[w])):
//   t   = s * g
//   u   = gamma * t
//   x'  = x  - u                      (Simulator._descend)
//   x~' = x~ - u
//   d   = x~' - x'                    (a2cid2.apply_mixing, compiled out
//   x   = x'  + c * d                  when eta == 0: no coeff)
//   x~  = x~' - c * d
// and, over the W rows of x', the metrics row of the tick:
//   mean_j    = dtype(f32 sum_w x'[w, j] * factor)     (torch.mean)
//   consensus = dtype(dtype(sum_{w, j} (x'[w, j] - mean_j)^2) * (1 / W))
//   mean_sq   = dtype(sum_j dtype(mean_j^2))
// x and x~ are written IN PLACE.  Every product, sum and difference of the
// state uses the _rn intrinsics (no FMA contraction) and a bf16 rounding of
// every intermediate, so x and x~ are bit for bit the eager ops' results.
// The row is not: each column's squares are summed as
// sum (x' - k)^2 - 2 (mean - k) sum (x' - k) + W (mean - k)^2 in double,
// k the column's row-0 value, so one pass over the rows suffices; the
// columns' sums meet in per-block partials and a second, one-block launch
// adds them in a fixed order (no atomics: the row repeats bit for bit).
//
// What bounds it on an H100: memory.  The tick must read each gradient
// leaf once at its dtype, read x and x~ once and write them once: at
// (16, 11,171,328) f32 3.57 GB, 1.07 ms at 3.35 TB/s; at the LM cell's
// (4, 313,024,000) f32 25.0 GB, 7.48 ms; against some 12 f32 operations
// and 4 double ones an element.
//
// What the design does about it: ONE launch reads the leaves where the
// gradient function left them, through a table of up to kMaxSegments
// leaves passed BY VALUE as a __grid_constant__ parameter (mixing_p2p's
// scheme, at the 32 KB of parameters that CUDA 12.1 and later allow: one
// launch for each kind of leaf a model has, so each grid has one tail; the
// wrapper issues one more per kMaxSegments leaves of a kind).  A block
// takes a chunk of
// one leaf's columns for all W rows, so the column's statistics stay in
// registers; what bounds the pass is then the bytes each SM keeps in
// flight.  Two kinds of leaf, each launched on its own (the table holds a
// launch's leaves of one kind) so that each takes the registers it needs:
//   - kKindVec, rows contiguous at the buffer dtype with a row stride and a
//     16-byte offset that line up with the buffer's columns: a scalar head
//     up to a 16-byte column boundary, a body of 16-byte vectors, a scalar
//     tail; kRows rows of a vector's three loads in flight per thread,
//     kVecBlocks blocks an SM;
//   - kKindRuns, any other leaf whose per-worker dims merge to at most
//     three, (A, B, C) with C the fastest logical dim, at any strides and
//     of a dtype the buffer embeds: a block takes a (Ta, Tb, Tc) tile whose
//     Ta * Tb elements of one column lie in one run of memory (an HWIO
//     view of an OIHW convolution gradient, (kh kw, I, O) at strides (1,
//     kh kw, kh kw I): Ta = kh kw, Tb = 32 / Ta input channels; a
//     transposed matrix: Tb = 32; else Ta = Tb = 1, a run of one, with
//     1,024 columns of C), and, kRunRows rows at a time, reads the tile's
//     runs with coalesced loads into shared memory (two buffers, one
//     barrier a step) while each warp loads x and x~ at its 32 consecutive
//     columns of C; the warp then takes its leaf values from shared
//     memory; kRunBlocks blocks an SM.  Rows that are contiguous but off
//     the 16-byte grid (leaves after one of odd length) read as runs of
//     one.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtick_tail_stacked.so tick_tail_stacked.cu
// Entry point: tick_tail_stacked_launch (plain C, loaded with ctypes).

#include "gossip_common.cuh"

#include <cuda_fp16.h>
#include <limits.h>
#include <string.h>

namespace {

using namespace gossip;

// One leaf, laid out as kernel.py's TICK_SEGMENT.  Row w's element of
// (a, b, c) is g[w * rs + a * s[0] + b * s[1] + c * s[2]], its buffer
// column off + (a * n[1] + b) * n[2] + c.  kKindVec leaves have n = (1, 1,
// columns), s = (0, 0, 1): head scalars, then `body` 16-byte vectors, then
// the scalar tail.  kKindRuns leaves have the tile t = (Ta, Tb, Tc): a
// tile's element (a0 + r % Ta, b0 + r / Ta, c) lies at a0 s[0] + b0 s[1] +
// c s[2] + r.
struct Segment {
    const void *g;
    long long rs;
    long long off;
    long long s[3];
    long long body;
    int n[3];
    int t[3];
    int head;
    int first_block;  // the segment's first block in the launch
    int kind;
    int gdt;          // the leaf's dtype: kLeafF32, kLeafBF16, kLeafF16
};
static_assert(sizeof(Segment) == 96, "kernel.py's TICK_SEGMENT is 96 bytes");

// leaves a launch (kernel.py's TICK_MAX_SEGMENTS), columns a kKindVec
// block (TICK_CHUNK), rows of a column in flight per thread
constexpr int kMaxSegments = 320;
constexpr long long kChunk = 4096;
constexpr int kRows = 4;
constexpr int kKindVec = 0;
constexpr int kKindRuns = 1;
// a kKindRuns tile: at most 32 elements of a column in a run (kernel.py's
// RUN_MAX), at most 1,024 elements a row (32 * (32 / R) columns of R),
// 32 * 33 floats of shared memory with the run's pitch made odd, and at
// most 32 (run element, 32-column group) pairs: 4 a thread
constexpr int kRunMax = 32;
constexpr int kTileFloats = 32 * (kRunMax + 1);
constexpr int kPairsPerThread = kRunMax / (kThreads / 32);
constexpr int kFillPerThread = 32 * kRunMax / kThreads;
// rows of a kKindRuns tile between two barriers
constexpr int kRunRows = 2;
// blocks an SM keeps (chosen on the card, PERF.md section 6): a kKindVec
// launch takes the registers it wants (kRows rows of three vectors in
// flight and 8 bf16 columns' statistics), a kKindRuns launch 80 a thread
constexpr int kVecBlocks = 1;
constexpr int kRunBlocks = 3;
constexpr int kLeafF32 = 0;
constexpr int kLeafBF16 = 1;

struct Params {
    Segment seg[kMaxSegments];
    void *x;
    void *x_tilde;
    const float *gscale;
    const float *coeff;   // null: eta == 0, no mixing
    double2 *partials;    // one (squares, mean squares) pair a block
    long long w;
    long long d;
    long long block_base;  // this launch's first block among all launches
    int count;
    float gamma;
    float factor;          // torch.mean's factor: float(D) / float(W * D)
};
// the 32,764 bytes of kernel parameters that CUDA 12.1 and later take on
// Volta and later cards (the classic limit was 4 KB)
static_assert(sizeof(Params) <= 32764, "the table must fit 32 KB of params");

__device__ __forceinline__ float load_leaf(const void *g, int gdt,
                                           long long i) {
    if (gdt == kLeafF32) return __ldg(static_cast<const float *>(g) + i);
    const unsigned short bits =
        __ldg(static_cast<const unsigned short *>(g) + i);
    if (gdt == kLeafBF16) return __uint_as_float((unsigned)bits << 16);
    return __half2float(__ushort_as_half(bits));
}

// One column's statistics over the rows: k its row-0 value, sum the f32
// sum of the rows (the mean's), s1 and s2 the sums of (x' - k) and its
// square in double.
struct Col {
    float k;
    float sum;
    double s1;
    double s2;
};

__device__ __forceinline__ void col_add(Col &c, float v, bool first) {
    if (first) {
        c.k = v;
        c.sum = v;
        c.s1 = 0.0;
        c.s2 = 0.0;
        return;
    }
    c.sum = __fadd_rn(c.sum, v);
    const double dv = (double)v - (double)c.k;
    c.s1 += dv;
    c.s2 += dv * dv;
}

// the column's squares about its mean, and its mean squared, into the
// thread's sums
template <typename T>
__device__ __forceinline__ void col_finish(const Col &c, float factor,
                                           long long w, double &sq,
                                           double &msq) {
    const float m = T::round(__fmul_rn(c.sum, factor));
    const double dm = (double)m - (double)c.k;
    sq += c.s2 - 2.0 * dm * c.s1 + (double)w * dm * dm;
    msq += (double)T::round(__fmul_rn(m, m));
}

// the descent of one element on both buffers, the row's statistics, then
// the mixing step
template <typename T, bool kMix>
__device__ __forceinline__ void elem(float g, float s, float gamma, float c,
                                     float &x, float &xt, Col &col,
                                     bool first) {
    const float u = T::round(__fmul_rn(gamma, T::round(__fmul_rn(s, g))));
    x = T::round(__fsub_rn(x, u));
    xt = T::round(__fsub_rn(xt, u));
    col_add(col, x, first);
    if (kMix) {
        const float d = T::round(__fsub_rn(xt, x));
        const float cd = T::round(__fmul_rn(c, d));
        x = T::round(__fadd_rn(x, cd));
        xt = T::round(__fsub_rn(xt, cd));
    }
}

// kLanes columns of a kKindVec body for every row: g points at row 0's
// vector, rows rs_vec vectors apart; col is the first column
template <typename T, bool kMix>
__device__ __forceinline__ void vec_columns(const Params &p,
                                            const typename T::vec_t *g,
                                            long long rs_vec, long long col,
                                            double &sq, double &msq) {
    using E = typename T::elem_t;
    using V = typename T::vec_t;
    constexpr int L = T::kLanes;
    E *x = static_cast<E *>(p.x) + col;
    E *xt = static_cast<E *>(p.x_tilde) + col;
    Col cols[L];
    for (long long w0 = 0; w0 < p.w; w0 += kRows) {
        V gv[kRows], xv[kRows], tv[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
            const long long w = w0 + u;
            if (w < p.w) {
                gv[u] = __ldg(g + w * rs_vec);
                xv[u] = *reinterpret_cast<const V *>(x + w * p.d);
                tv[u] = *reinterpret_cast<const V *>(xt + w * p.d);
            }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
            const long long w = w0 + u;
            if (w < p.w) {
                const float s = T::round(p.gscale[w]);
                const float c = kMix ? T::round(p.coeff[w]) : 0.0f;
                float fg[L], fx[L], ft[L];
                T::unpack(gv[u], fg);
                T::unpack(xv[u], fx);
                T::unpack(tv[u], ft);
#pragma unroll
                for (int l = 0; l < L; ++l) {
                    elem<T, kMix>(fg[l], s, p.gamma, c, fx[l], ft[l],
                                  cols[l], w == 0);
                }
                *reinterpret_cast<V *>(x + w * p.d) = T::pack(fx);
                *reinterpret_cast<V *>(xt + w * p.d) = T::pack(ft);
            }
        }
    }
#pragma unroll
    for (int l = 0; l < L; ++l) col_finish<T>(cols[l], p.factor, p.w, sq, msq);
}

// one column for every row: row w's leaf element is g[gi + w * rs]
template <typename T, bool kMix>
__device__ __forceinline__ void scalar_column(const Params &p, const void *g,
                                              int gdt, long long gi,
                                              long long rs, long long col,
                                              double &sq, double &msq) {
    using E = typename T::elem_t;
    E *x = static_cast<E *>(p.x) + col;
    E *xt = static_cast<E *>(p.x_tilde) + col;
    Col c1;
    for (long long w0 = 0; w0 < p.w; w0 += kRows) {
        float gv[kRows], xv[kRows], tv[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
            const long long w = w0 + u;
            if (w < p.w) {
                gv[u] = load_leaf(g, gdt, gi + w * rs);
                xv[u] = T::load(x[w * p.d]);
                tv[u] = T::load(xt[w * p.d]);
            }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
            const long long w = w0 + u;
            if (w < p.w) {
                const float s = T::round(p.gscale[w]);
                const float c = kMix ? T::round(p.coeff[w]) : 0.0f;
                elem<T, kMix>(gv[u], s, p.gamma, c, xv[u], tv[u], c1,
                              w == 0);
                x[w * p.d] = T::store(xv[u]);
                xt[w * p.d] = T::store(tv[u]);
            }
        }
    }
    col_finish<T>(c1, p.factor, p.w, sq, msq);
}

// tile j of a kKindRuns leaf for every row, kRunRows rows a step: the
// tile's runs (rv elements of each of its cv columns) go through shared
// memory, each warp takes its (run element, 32 consecutive columns) pairs.
// A step's run loads and its x, x~ loads are all issued before its barrier.
template <typename T, bool kMix>
__device__ __forceinline__ void runs_tile(const Params &p, const Segment &s,
                                          long long j, double &sq,
                                          double &msq) {
    using E = typename T::elem_t;
    constexpr int U = kRunRows;
    __shared__ float tile[2][U][kTileFloats];
    const long long A = s.n[0], B = s.n[1], C = s.n[2];
    const int Ta = s.t[0], Tb = s.t[1], Tc = s.t[2];
    const int R = Ta * Tb, pitch = R | 1;
    const long long nta = (A + Ta - 1) / Ta, ntb = (B + Tb - 1) / Tb;
    const long long a0 = j % nta * Ta;
    const long long b0 = j / nta % ntb * Tb;
    const long long c0 = j / (nta * ntb) * Tc;
    // the run's live elements: a tile of one b is cut at A's edge, a
    // tile of whole runs of A at B's
    const int rv = Tb == 1 ? (int)(A - a0 < Ta ? A - a0 : Ta)
                           : (int)((B - b0 < Tb ? B - b0 : Tb) * Ta);
    const int cv = (int)(C - c0 < Tc ? C - c0 : Tc);
    const long long base = a0 * s.s[0] + b0 * s.s[1] + c0 * s.s[2];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int pairs = R * (Tc / 32);
    E *x = static_cast<E *>(p.x);
    E *xt = static_cast<E *>(p.x_tilde);
    // this thread's pairs: their buffer columns and tile slots (-1: none)
    long long col[kPairsPerThread];
    int slot[kPairsPerThread];
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
        const int q = warp + k * (kThreads / 32);
        const int r = q % R, cl = q / R * 32 + lane;
        const bool live = q < pairs && r < rv && cl < cv;
        slot[k] = live ? cl * pitch + r : -1;
        col[k] = s.off + ((a0 + r % Ta) * B + b0 + r / Ta) * C + c0 + cl;
    }
    Col cols[kPairsPerThread];
    for (long long w0 = 0; w0 < p.w; w0 += U) {
        float gv[U][kFillPerThread], xv[U][kPairsPerThread],
            tv[U][kPairsPerThread];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long gw = base + (w0 + u) * s.rs;
#pragma unroll
            for (int f = 0; f < kFillPerThread; ++f) {
                const int i = threadIdx.x + f * kThreads;
                const int cl = i / R, r = i - cl * R;
                gv[u][f] = w0 + u < p.w && i < cv * R && r < rv
                               ? load_leaf(s.g, s.gdt, gw + cl * s.s[2] + r)
                               : 0.0f;
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int k = 0; k < kPairsPerThread; ++k) {
                if (w0 + u < p.w && slot[k] >= 0) {
                    const long long e = (w0 + u) * p.d + col[k];
                    xv[u][k] = T::load(x[e]);
                    tv[u][k] = T::load(xt[e]);
                }
            }
        }
        // the buffer written here was last read two steps ago, before the
        // barrier of the step between
        float(*t)[kTileFloats] = tile[(w0 / U) & 1];
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int f = 0; f < kFillPerThread; ++f) {
                const int i = threadIdx.x + f * kThreads;
                const int cl = i / R;
                if (i < cv * R) t[u][cl * pitch + (i - cl * R)] = gv[u][f];
            }
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long w = w0 + u;
            if (w < p.w) {
                const float sw = T::round(p.gscale[w]);
                const float cw = kMix ? T::round(p.coeff[w]) : 0.0f;
#pragma unroll
                for (int k = 0; k < kPairsPerThread; ++k) {
                    if (slot[k] >= 0) {
                        elem<T, kMix>(t[u][slot[k]], sw, p.gamma, cw,
                                      xv[u][k], tv[u][k], cols[k], w == 0);
                        const long long e = w * p.d + col[k];
                        x[e] = T::store(xv[u][k]);
                        xt[e] = T::store(tv[u][k]);
                    }
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
        if (slot[k] >= 0) col_finish<T>(cols[k], p.factor, p.w, sq, msq);
    }
}

// the block's (squares, mean squares) into its partial, in a fixed order
__device__ __forceinline__ void block_partial(double sq, double msq,
                                              double2 *out) {
    __shared__ double2 warp_sums[kThreads / 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        sq += __shfl_down_sync(0xffffffffu, sq, o);
        msq += __shfl_down_sync(0xffffffffu, msq, o);
    }
    if ((threadIdx.x & 31) == 0) {
        warp_sums[threadIdx.x >> 5] = make_double2(sq, msq);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        double2 t = warp_sums[0];
        for (int i = 1; i < kThreads / 32; ++i) {
            t.x += warp_sums[i].x;
            t.y += warp_sums[i].y;
        }
        *out = t;
    }
}

template <typename T, bool kMix, int kKind>
__global__ void __launch_bounds__(kThreads, kKind == kKindVec ? kVecBlocks
                                                              : kRunBlocks)
tick_tail_kernel(const __grid_constant__ Params p) {
    using E = typename T::elem_t;
    using V = typename T::vec_t;
    constexpr int L = T::kLanes;
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
    double sq = 0.0, msq = 0.0;
    if constexpr (kKind == kKindVec) {
        // this block's vectors [v0, v1) of the body
        const V *gv = reinterpret_cast<const V *>(
            static_cast<const E *>(s.g) + s.head);
        const long long col0 = s.off + s.head;
        const long long v0 = j * kChunkVecs;
        const long long v1 =
            v0 + kChunkVecs < s.body ? v0 + kChunkVecs : s.body;
        for (long long v = v0 + threadIdx.x; v < v1; v += kThreads) {
            vec_columns<T, kMix>(p, gv + v, s.rs / L, col0 + v * L, sq, msq);
        }
        // this block's scalars [e0, e1) of the head and the tail together
        const long long n = s.n[2];
        const long long body_end = s.head + s.body * L;
        const long long scalars = n - s.body * L;
        const long long e0 = j * kChunk;
        const long long e1 = e0 + kChunk < scalars ? e0 + kChunk : scalars;
        for (long long i = e0 + threadIdx.x; i < e1; i += kThreads) {
            const long long e = i < s.head ? i : body_end + (i - s.head);
            scalar_column<T, kMix>(p, s.g, s.gdt, e, s.rs, s.off + e, sq,
                                   msq);
        }
    } else {
        runs_tile<T, kMix>(p, s, j, sq, msq);
    }
    block_partial(sq, msq, p.partials + p.block_base + b);
}

constexpr int kRowThreads = 1024;

// the partials' sums in a fixed order, then the row as the eager ops round
// it: consensus = dtype(dtype(squares) * inv_w), mean_sq = dtype(...)
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
row_kernel(const double2 *partials, long long n, float inv_w, float *row) {
    __shared__ double2 warp_sums[kRowThreads / 32];
    double sq = 0.0, msq = 0.0;
    for (long long i = threadIdx.x; i < n; i += kRowThreads) {
        sq += partials[i].x;
        msq += partials[i].y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        sq += __shfl_down_sync(0xffffffffu, sq, o);
        msq += __shfl_down_sync(0xffffffffu, msq, o);
    }
    if ((threadIdx.x & 31) == 0) {
        warp_sums[threadIdx.x >> 5] = make_double2(sq, msq);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        double2 t = warp_sums[0];
        for (int i = 1; i < kRowThreads / 32; ++i) {
            t.x += warp_sums[i].x;
            t.y += warp_sums[i].y;
        }
        row[0] = T::round(__fmul_rn(T::round((float)t.x), inv_w));
        row[1] = T::round((float)t.y);
    }
}

template <typename T, bool kMix>
int launch_kind(int kind, unsigned blocks, const Params &p,
                cudaStream_t stream) {
    if (kind == kKindVec) {
        tick_tail_kernel<T, kMix, kKindVec><<<blocks, kThreads, 0, stream>>>(
            p);
    } else {
        tick_tail_kernel<T, kMix, kKindRuns>
            <<<blocks, kThreads, 0, stream>>>(p);
    }
    return (int)cudaGetLastError();
}

template <typename T>
int launch(void *x, void *x_tilde, long long w, long long d,
           const Segment *segs, int launches, const int *counts,
           const int *kinds, const long long *blocks, const void *gscale,
           const void *coeff, float gamma, float factor, float inv_w,
           void *partials, void *row, cudaStream_t stream) {
    Params p{};
    p.x = x;
    p.x_tilde = x_tilde;
    p.gscale = static_cast<const float *>(gscale);
    p.coeff = static_cast<const float *>(coeff);
    p.partials = static_cast<double2 *>(partials);
    p.w = w;
    p.d = d;
    p.gamma = gamma;
    p.factor = factor;
    long long base = 0;
    int first = 0;
    for (int k = 0; k < launches; ++k) {
        p.count = counts[k];
        memcpy(p.seg, segs + first, (size_t)p.count * sizeof(Segment));
        p.block_base = base;
        const int err =
            coeff != nullptr
                ? launch_kind<T, true>(kinds[k], (unsigned)blocks[k], p,
                                       stream)
                : launch_kind<T, false>(kinds[k], (unsigned)blocks[k], p,
                                        stream);
        if (err != 0) return err;
        first += counts[k];
        base += blocks[k];
    }
    row_kernel<T><<<1, kRowThreads, 0, stream>>>(
        static_cast<const double2 *>(partials), base, inv_w,
        static_cast<float *>(row));
    return (int)cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16, the buffers' dtype.  x, x_tilde:
// (w, d) contiguous buffers, 16-byte aligned, d % 128 == 0, written in
// place.  segments points at the rows of kernel.py's TICK_SEGMENT on the
// host, launch after launch: launch k takes the next counts[k] rows (1 to
// kMaxSegments), all of kind kinds[k], their first blocks ascending from 0,
// and blocks[k] blocks.  gscale, coeff: (w,) float32 on the card (coeff
// null: no mixing); gamma a value of the dtype; partials: sum(blocks)
// double pairs; row: two float32, consensus and mean_sq.  Returns
// cudaErrorInvalidValue for arguments this build cannot take, else
// cudaGetLastError() after the launches (0 = launched).
extern "C" int tick_tail_stacked_launch(
    int dtype_code, void *x, void *x_tilde, long long w, long long d,
    const void *segments, int launches, const int *counts, const int *kinds,
    const long long *blocks, const void *gscale, const void *coeff,
    float gamma, float factor, float inv_w, void *partials, void *row,
    void *stream) {
    if (launches < 0 || w < 1 || d < 1 || d % 128 != 0) {
        return (int)cudaErrorInvalidValue;
    }
    for (int k = 0; k < launches; ++k) {
        if (counts[k] < 1 || counts[k] > kMaxSegments || blocks[k] < 1
            || blocks[k] > INT_MAX
            || (kinds[k] != kKindVec && kinds[k] != kKindRuns)) {
            return (int)cudaErrorInvalidValue;
        }
    }
    const Segment *segs = static_cast<const Segment *>(segments);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype_code == 0) {
        return launch<F32>(x, x_tilde, w, d, segs, launches, counts, kinds,
                           blocks, gscale, coeff, gamma, factor, inv_w,
                           partials, row, s);
    }
    if (dtype_code == 1) {
        return launch<BF16>(x, x_tilde, w, d, segs, launches, counts, kinds,
                            blocks, gscale, coeff, gamma, factor, inv_w,
                            partials, row, s);
    }
    return (int)cudaErrorInvalidValue;
}
