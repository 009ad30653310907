// Causal and sliding-window attention with an online softmax, written by
// hand for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd
//   (its pallas_call at kernel.py:102).
//
// For each of BH heads, q (S, hd) against k, v (T, hd), row r and column c:
//   s[r, c] = (q[r] . k[c]) * scale                       (f32)
//   live    = c < T  [&& c <= r if causal]  [&& c > r - window if windowed]
//   out[r]  = sum_c softmax_c(s[r, c] over live c) * v[c]
// computed as the Pallas kernel does it, tile by tile along c with the f32
// running state (m, l, acc): masked scores are NEG_INF = -1e30, a row that
// has seen no live column yet is not "alive" (m <= -5e29) and adds nothing,
// and a row with no live column at all (l == 0, possible only with a window
// and no causal mask) is written as 0.  The causal mask is absolute (c <= r,
// no offset when T != S).  The output takes q's dtype.
//
// What bounds it on an H100: operations.  A live (r, c) pair costs 4 * hd
// flops (2 * hd for q.k, 2 * hd for p * v): 12.90 GFLOP at (96, 1024, 64)
// causal.  bf16 runs them at the dense bf16 tensor-core rate (989 TFLOP/s,
// 0.0130 ms there), which puts the bytes (50.3 MB, 0.0150 ms at 3.35 TB/s)
// just above the products.  f32 runs three TF32 products for each f32
// product (3xTF32 below) at 494.7 TFLOP/s: 0.0782 ms there.
//
// The design.  One CTA per (head, q tile of 64 rows per consumer
// warpgroup); the grid takes the last q tiles (the longest causal rows)
// first, so the triangle's tail is short.  The last warp is the producer:
// one thread copies the q tile once and streams k and v tiles through a
// ring of shared-memory stages with TMA (the Tensor Memory Accelerator: one
// instruction a box of 128 bytes of columns by up to 192 rows, zero-filled
// past S and T, written in the 128-byte swizzle), each stage with a "full"
// mbarrier (the bytes arrived) and an "empty" one (every consumer warp is
// done with it).  The consumer warps own 16 rows each and wait only for
// their stages (and, at f32, for each other once a tile, below), so that
// one warpgroup's softmax runs while another's products keep the tensor
// cores busy.  The score tile and the output accumulator stay in registers
// in the tensor cores' accumulator layout (thread (g = lane / 4, t = lane %
// 4) holds rows g and g + 8, columns 8j + 2t and 8j + 2t + 1 of every
// 8-column block j), so the mask, the row max (over the four threads of a
// row, by shuffles) and the rescale run on registers and no score goes
// through shared memory; each thread sums its own columns of l and the
// four are added once, at the end.  Tiles wholly above the diagonal or
// outside the window are not loaded, and a warpgroup whose rows see none
// of a loaded tile skips it; tiles that need no mask skip the compares.
//
// bf16: wgmma.  S = Q K^T is wgmma.m64n64k16 (bf16 in, f32 accumulate) with
// Q and K read from shared memory, both K-major in the layout TMA writes
// (16-byte chunk c of row r at chunk c ^ (r % 8), one 64-column block per
// 128-byte row).  P is rounded to bf16 in registers and fed to O += P V
// (wgmma.m64n{hd}k16; two of m64n128k16 at hd 256) as the register A
// operand, whose fragment layout is the accumulator's; V is the
// shared-memory B operand, read transposed (MN-major) from the same
// layout.  As in FlashAttention-3, a warpgroup starts S_j = Q K_j^T and
// O += P_{j-1} V_{j-1} together and runs the softmax of S_j while P V is
// still on the tensor cores.  The rounding of P to bf16 is the one rounding
// the plain version does not do; l sums the unrounded f32 p.
//
// f32: 3xTF32.  Each operand x is split into hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna), and a.b is taken as lo.hi + hi.lo + hi.hi
// with f32 accumulation: about 21 bits of each product, against TF32's 10,
// which alone could not meet the f32 gate.  S = Q K^T runs on TF32 wgmma
// (m64n{64,32}k8), which reads both operands K-major from shared memory:
// the consumer warps split the q tile once and each k tile as it lands, in
// place into its hi parts with the lo parts in a tile beside it (the split
// is elementwise, so TMA's swizzle stays), then meet at a named barrier.
// O += P V stays on mma.sync.m16n8k8.tf32 from registers: TF32 wgmma takes
// no MN-major B, so P V on wgmma would need V transposed and split into two
// more tiles a stage, which shared memory (already holding q twice) has no
// room for.  Each warp splits P and its v fragments in registers.  Within
// each 8-deep block of P V, logical k = t and t + 4 are taken as physical
// columns 2t and 2t + 1, exactly where the score accumulator holds them,
// so P needs no shuffle; the swizzle keeps the v loads free of bank
// conflicts.
//
// Rounding: the scale is a multiply after the product, folded with log2(e)
// into one f32 constant, and 2^x is the special-function unit's
// ex2.approx.ftz (the f32 gate, atol 2e-5 / rtol 1e-4, holds at every
// shape); the softmax bookkeeping uses the _rn intrinsics, which nvcc does
// not contract; the final acc / l is a correctly rounded division.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bhsd.so flash_attention_bhsd.cu
// Entry point: flash_attention_bhsd_launch (plain C, loaded with ctypes).
// cuTensorMapEncodeTiled lives in libcuda: it is looked up through the
// runtime (cudaGetDriverEntryPoint), so the library does not link libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------- mbarriers and TMA
__device__ __forceinline__ uint32_t smem_u32(const void *p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(count)
                 : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}
// Waits for the phase of parity `parity` to complete.  A wait that never
// ends (a bug, not a slow copy) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    for (uint32_t n = 0;; ++n) {
        uint32_t done;
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
        if (done) return;
        if (n > (1u << 26)) __trap();
    }
}
// One box of a 3-D tensor map (column, row, head) into shared memory; the
// copy credits its bytes to `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap *map,
                                         uint32_t bar, int col, int row,
                                         int head) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
        "r"(head)
        : "memory");
}

// ---------------------------------------------------- the tile's range
// The columns [c_lo, c_hi) any row of q tile q0 can see, c_lo a multiple of
// BK; returns the number of BK tiles.
template <int BK, int BQ>
__device__ __forceinline__ int tile_range(int q0, int t_len, int causal,
                                          int has_window, int window,
                                          int *c_lo) {
    int hi = t_len;
    if (causal) hi = min(hi, q0 + BQ);
    int lo = has_window ? max(0, q0 - window + 1) : 0;
    lo = lo / BK * BK;
    *c_lo = lo;
    return hi > lo ? (hi - lo + BK - 1) / BK : 0;
}

// Rows [r0, r1] against tile columns [k0, k0 + BK): whether no pair is live
// (skip) and whether some pair is dead (mask).
struct TileView {
    bool skip, mask;
};
template <int BK>
__device__ __forceinline__ TileView view(int r0, int r1, int k0, int t_len,
                                         int causal, int has_window,
                                         int window) {
    const int k1 = k0 + BK - 1;
    TileView tv;
    tv.skip = (causal && k0 > r1) || (has_window && k1 <= r0 - window);
    tv.mask = k1 >= t_len || (causal && k1 > r0) ||
              (has_window && k0 <= r1 - window);
    return tv;
}

// Shared memory of one CTA: the q tile, then NST stages of (k, v), each a
// tile of `rows` rows in 128-byte blocks of columns (64 bf16 or 32 f32),
// every block 1024-byte aligned as the swizzle needs.  At f32, q and k are
// split in place into their TF32 hi parts and each has a lo tile beside it
// (q, q lo; k, v, k lo).  The barriers live in static shared memory.
template <typename T, int HD, int BK, int NST, int CWG>
struct Smem {
    static constexpr int kBQ = 64 * CWG;           // q rows: 16 a warp
    static constexpr int kConsumers = 4 * CWG;     // consumer warps
    static constexpr int kThreads = 32 * (kConsumers + 1);  // + producer
    static constexpr bool kSplit = sizeof(T) == 4;
    static constexpr int kPerRow = 128 / sizeof(T);  // elements a block row
    static constexpr int kBlocks = HD / kPerRow;
    static constexpr int kQ = kBQ * HD * sizeof(T);
    static constexpr int kKV = BK * HD * sizeof(T);  // one of k or v
    static constexpr int kStage = (kSplit ? 3 : 2) * kKV;
    static constexpr int kQAll = (kSplit ? 2 : 1) * kQ;
    static constexpr int kBytes = kQAll + NST * kStage + 1024;  // + align
};

// The producer: q once, then every k/v tile of the CTA's range.
template <typename T, int HD, int BK, int NST, int CWG>
__device__ __forceinline__ void produce(const CUtensorMap *tq,
                                        const CUtensorMap *tk,
                                        const CUtensorMap *tv, uint32_t qs,
                                        uint32_t ks, uint32_t qbar,
                                        uint32_t full,
                                        uint32_t empty, int q0, int head,
                                        int c_lo, int n_tiles) {
    using L = Smem<T, HD, BK, NST, CWG>;
    mbar_expect_tx(qbar, L::kQ);
#pragma unroll
    for (int b = 0; b < L::kBlocks; ++b)
        tma_load(qs + b * L::kBQ * 128, tq, qbar, b * L::kPerRow, q0, head);
    for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NST;
        mbar_wait(empty + 8 * s, ((j / NST) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * L::kKV);
        const int k0 = c_lo + j * BK;
#pragma unroll
        for (int b = 0; b < L::kBlocks; ++b) {
            const uint32_t kt = ks + s * L::kStage + b * BK * 128;
            tma_load(kt, tk, full + 8 * s, b * L::kPerRow, k0, head);
            tma_load(kt + L::kKV, tv, full + 8 * s, b * L::kPerRow, k0,
                     head);
        }
    }
}

// A consumer warp is done with stage s.
__device__ __forceinline__ void release(uint32_t empty, int s) {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + 8 * s);
}

// ------------------------------------------ online softmax on fragments
// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// v[0] = max (or sum) of v[0 .. 2W), as a tree: depth log2 2W, not 2W
// (W a power of two; recursion, so that every index is a constant)
template <int W, int N>
__device__ __forceinline__ void tree_max(float (&v)[N]) {
    if constexpr (W >= 1) {
#pragma unroll
        for (int i = 0; i < W; ++i) v[i] = fmaxf(v[i], v[i + W]);
        tree_max<W / 2>(v);
    }
}
template <int W, int N>
__device__ __forceinline__ void tree_sum(float (&v)[N]) {
    if constexpr (W >= 1) {
#pragma unroll
        for (int i = 0; i < W; ++i) v[i] = __fadd_rn(v[i], v[i + W]);
        tree_sum<W / 2>(v);
    }
}

// s: NB 8-column blocks of the score accumulator (rows row0 and row0 + 8,
// columns col0 + 8j + 2t + {0, 1}), scaled, masked and turned into p in
// place; m and l updated; corr[h] is what the output rows must be
// multiplied by.  Scores are kept in log2 units (scale * log2 e).  A row
// that has seen no live column is not alive: it subtracts 0 instead of
// its max, so its masked scores give p = 2^-1e30 = 0 and corr = 0, which
// leaves its l and output at 0 as the guard of the Pallas kernel does.
// Both rows go together and the reductions are trees, so that the
// dependent chains are short.
template <int NB>
__device__ __forceinline__ void online_softmax(
    float (&s)[NB][4], float (&m)[2], float (&l)[2], float (&corr)[2],
    int row0, int col0, bool mask, int t_len, int causal, int has_window,
    int window, float scale2) {
    const int t = threadIdx.x % 4;
    float red[2][2 * NB];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float &x = s[j][e];
            bool live = true;
            if (mask) {
                const int row = row0 + 8 * (e / 2);
                const int col = col0 + 8 * j + 2 * t + e % 2;
                live = col < t_len;
                if (causal) live = live && col <= row;
                if (has_window) live = live && col > row - window;
            }
            x = live ? __fmul_rn(x, scale2) : kNegInf;
            red[e / 2][2 * j + e % 2] = x;
        }
    tree_max<NB>(red[0]);
    tree_max<NB>(red[1]);
    float mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
        red[h][0] = fmaxf(red[h][0], __shfl_xor_sync(0xffffffffu, red[h][0], 1));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        red[h][0] = fmaxf(red[h][0], __shfl_xor_sync(0xffffffffu, red[h][0], 2));
        const float m_cur = fmaxf(m[h], red[h][0]);
        mu[h] = m_cur > kNegInf * 0.5f ? m_cur : 0.0f;
        corr[h] = ex2(__fsub_rn(m[h], mu[h]));
        m[h] = m_cur;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float &x = s[j][e];
            x = ex2(__fsub_rn(x, mu[e / 2]));
            red[e / 2][2 * j + e % 2] = x;
        }
    tree_sum<NB>(red[0]);
    tree_sum<NB>(red[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
        l[h] = __fadd_rn(__fmul_rn(l[h], corr[h]), red[h][0]);
}

// l holds each thread's share of its rows' sums (its own columns, all
// rescaled alike); the epilogue adds the four threads of a row
__device__ __forceinline__ void row_sums(float (&l)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], 1));
        l[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], 2));
    }
}

template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO][4],
                                        const float (&corr)[2]) {
#pragma unroll
    for (int d = 0; d < NO; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[d][e] = __fmul_rn(o[d][e], corr[e / 2]);
}

// ================================================== f32: 3xTF32 helpers
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}
__device__ __forceinline__ void split(float x, uint32_t &hi, uint32_t &lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a b on one m16n8k8 TF32 tile, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the small products first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
    mma_tf32(d, alo, bhi);
    mma_tf32(d, ahi, blo);
    mma_tf32(d, ahi, bhi);
}

// Byte offset of f32 element (r, c) in a swizzled tile of `rows` rows: the
// 32-column block, the row, the 16-byte chunk XOR (r % 8), the word.
__device__ __forceinline__ uint32_t f32_at(int r, int c, int rows) {
    return (uint32_t)((c / 32) * rows * 128 + r * 128 +
                      ((((c % 32) / 4) ^ (r % 8)) << 4) + (c % 4) * 4);
}
__device__ __forceinline__ float lds1(uint32_t a) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
    return v;
}

// ================================================================ wgmma
// Shared-memory matrix descriptor for the 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses to r across the async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}

#define WG_F4(d, i) \
    "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
#define WG_F16(d, i) WG_F4(d, i), WG_F4(d, i + 1), WG_F4(d, i + 2), \
    WG_F4(d, i + 3)
#define WG_F32(d, i) WG_F16(d, i), WG_F16(d, i + 4)
#define WG_D16                                                            \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
    "%15}"
#define WG_D32                                                            \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
    "%28, %29, %30, %31}"
#define WG_D64                                                            \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
    "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
    "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
    "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 64) (+)= A B^T, A and B K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_F32(d, 0)
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N) += A B, A bf16 in registers, B MN-major (transposed) in
// shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_F32(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// the same at N = 128 into the 16 blocks d[OFF ..  OFF + 15]: hd 256 takes
// its 256 output columns as two of these
template <int NO, int OFF>
__device__ __forceinline__ void wgmma_rs128(float (&d)[NO][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_F32(d, OFF), WG_F32(d, OFF + 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t *>(&p);
}

// S = Q K^T for one warpgroup: its 64 q rows at qa, the stage's k at kt
template <int HD, int BK, int BQ>
__device__ __forceinline__ void mma_qk(float (&s)[BK / 8][4], uint32_t qa,
                                         uint32_t kt) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(s,
                 sw128_desc(qa + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16,
                            1024),
                 sw128_desc(kt + (kk / 4) * BK * 128 + (kk % 4) * 32, 16,
                            1024),
                 kk > 0);
}
// O += P V: rows 16kk.. of v; its 64-column blocks lie BK * 128 bytes apart.
// A wgmma takes at most 128 columns here: hd 256 is two, the second starting
// two blocks on.
template <int HD, int BK>
__device__ __forceinline__ void mma_pv(float (&o)[HD / 8][4],
                                         const uint32_t (&p)[BK / 16][4],
                                         uint32_t vt) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t vk = vt + kk * 16 * 128;
        if constexpr (HD == 64) {
            wgmma_rs(o, p[kk], sw128_desc(vk, BK * 128, 1024));
        } else {
            wgmma_rs128<HD / 8, 0>(o, p[kk], sw128_desc(vk, BK * 128, 1024));
            if constexpr (HD == 256)
                wgmma_rs128<HD / 8, 16>(
                    o, p[kk], sw128_desc(vk + 2 * BK * 128, BK * 128, 1024));
        }
    }
}

// ======================================================= f32 consumer
// The NC consumer warps meet at named barrier 1 (0 is __syncthreads).
template <int NC>
__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * NC) : "memory");
}
// Split the f32 tile at `hi` in place into its TF32 hi parts and write the
// lo parts at the same offsets from `lo` (elementwise, so the swizzle stays
// as TMA wrote it), then make the writes visible to wgmma (the async proxy)
// and wait for every consumer thread.
template <int NC>
__device__ __forceinline__ void split_tile(uint32_t hi, uint32_t lo,
                                           int bytes) {
    for (int off = threadIdx.x * 16; off < bytes; off += 32 * NC * 16) {
        float x[4];
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                     : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
                     : "r"(hi + off));
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(x[e], h[e], l[e]);
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         hi + off),
                     "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3])
                     : "memory");
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         lo + off),
                     "r"(l[0]), "r"(l[1]), "r"(l[2]), "r"(l[3])
                     : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync<NC>();
}

// d (64 x N) (+)= A B^T, A and B K-major TF32 in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], uint64_t da,
                                           uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_D32
        ", %32, %33, p, 1, 1;\n}\n"
        : WG_F32(d, 0)
        : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[4][4], uint64_t da,
                                           uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WG_D16
        ", %16, %17, p, 1, 1;\n}\n"
        : WG_F16(d, 0)
        : "l"(da), "l"(db), "r"(accumulate));
}

// S = Q K^T in 3xTF32 for one warpgroup: per 8-deep step lo.hi, hi.lo,
// hi.hi.  q (hi, lo) hold its 64 rows, k (hi, lo) the stage's BK rows.
template <int HD, int BK, int BQ>
__device__ __forceinline__ void mma_qk_3xtf32(float (&s)[BK / 8][4],
                                                uint32_t qhi, uint32_t qlo,
                                                uint32_t khi, uint32_t klo) {
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
        const uint32_t a = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        const uint32_t b = (kk / 4) * BK * 128 + (kk % 4) * 32;
        wgmma_tf32(s, sw128_desc(qlo + a, 16, 1024),
                   sw128_desc(khi + b, 16, 1024), kk > 0);
        wgmma_tf32(s, sw128_desc(qhi + a, 16, 1024),
                   sw128_desc(klo + b, 16, 1024), 1);
        wgmma_tf32(s, sw128_desc(qhi + a, 16, 1024),
                   sw128_desc(khi + b, 16, 1024), 1);
    }
}

// One consumer warp (rows q0 + 16 warp ..  + 15): its warpgroup takes
// S = Q K^T on wgmma, the warp its softmax and O += P V on mma.sync.
template <int HD, int BK, int NST, int CWG>
__device__ __forceinline__ void consume_f32(
    float *out, uint32_t qs, uint32_t ks, uint32_t qbar, uint32_t full,
    uint32_t empty, long long head, int q0, int c_lo, int n_tiles, int s_len,
    int t_len, int causal, int has_window, int window, float scale2) {
    using L = Smem<float, HD, BK, NST, CWG>;
    constexpr int NB = BK / 8, NO = HD / 8;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int wr = warp * 16, gr = (warp / 4) * 64;  // warp's, group's rows
    float o[NO][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int d = 0; d < NO; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;
    const uint32_t qlo = qs + L::kQ;
    mbar_wait(qbar, 0);
    split_tile<L::kConsumers>(qs, qlo, L::kQ);
    for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NST;
        const uint32_t kt = ks + st * L::kStage, vt = kt + L::kKV;
        const uint32_t klo = kt + 2 * L::kKV;
        mbar_wait(full + 8 * st, (j / NST) & 1);
        split_tile<L::kConsumers>(kt, klo, L::kKV);
        const int k0 = c_lo + j * BK;
        if (!view<BK>(q0 + gr, q0 + gr + 63, k0, t_len, causal, has_window,
                      window).skip) {
            float s[NB][4];
            fence_regs(s);
            wgmma_fence();
            mma_qk_3xtf32<HD, BK, L::kBQ>(s, qs + gr * 128,
                                            qlo + gr * 128, kt, klo);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(s);
            float corr[2];
            online_softmax(s, m, l, corr, q0 + wr + g, k0,
                           view<BK>(q0 + wr, q0 + wr + 15, k0, t_len, causal,
                                    has_window, window).mask,
                           t_len, causal, has_window, window, scale2);
            rescale(o, corr);
            // O += P V; column 8kb + 2t + {0, 1} of P is depth t, t + 4
#pragma unroll
            for (int kb = 0; kb < NB; ++kb) {
                uint32_t ahi[4], alo[4];
                split(s[kb][0], ahi[0], alo[0]);
                split(s[kb][2], ahi[1], alo[1]);
                split(s[kb][1], ahi[2], alo[2]);
                split(s[kb][3], ahi[3], alo[3]);
#pragma unroll
                for (int nd = 0; nd < NO; ++nd) {
                    uint32_t bhi[2], blo[2];
                    split(lds1(vt + f32_at(8 * kb + 2 * t, 8 * nd + g, BK)),
                          bhi[0], blo[0]);
                    split(lds1(vt + f32_at(8 * kb + 2 * t + 1, 8 * nd + g,
                                           BK)),
                          bhi[1], blo[1]);
                    mma_3xtf32(o[nd], ahi, alo, bhi, blo);
                }
            }
        }
        release(empty, st);
    }
    row_sums(l);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = q0 + wr + g + 8 * h;
        if (row >= s_len) continue;
        const float safe = l[h] > 0.0f ? l[h] : 1.0f;
        float *orow = out + (head * s_len + row) * HD + 2 * t;
#pragma unroll
        for (int nd = 0; nd < NO; ++nd)
            *reinterpret_cast<float2 *>(orow + nd * 8) =
                make_float2(__fdiv_rn(o[nd][2 * h], safe),
                            __fdiv_rn(o[nd][2 * h + 1], safe));
    }
}

// ====================================================== bf16 consumer
// One consumer warp of a warpgroup whose rows are q0 + wr .. q0 + wr + 63.
// The warpgroup's live tiles [jb, je) are contiguous; the others are only
// waited for and released, so that every warp releases every stage in
// order.
template <int HD, int BK, int NST, int CWG>
__device__ __forceinline__ void consume_bf16(
    __nv_bfloat16 *out, uint32_t qs, uint32_t ks, uint32_t qbar,
    uint32_t full, uint32_t empty, long long head, int q0, int wr,
    int c_lo, int n_tiles, int s_len, int t_len, int causal, int has_window,
    int window, float scale2) {
    using L = Smem<__nv_bfloat16, HD, BK, NST, CWG>;
    constexpr int NO = HD / 8;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + wr + (warp % 4) * 16 + g;
    const uint32_t qa = qs + wr * 128;
    int jb = 0, je = n_tiles;
    while (jb < je && view<BK>(q0 + wr, q0 + wr + 63, c_lo + jb * BK, t_len,
                               causal, has_window, window).skip)
        ++jb;
    while (je > jb && view<BK>(q0 + wr, q0 + wr + 63, c_lo + (je - 1) * BK,
                               t_len, causal, has_window, window).skip)
        --je;

    float o[NO][4], s[BK / 8][4], m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};
    float corr[2];
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int d = 0; d < NO; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;
#pragma unroll
    for (int d = 0; d < BK / 8; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[d][e] = 0.0f;
    auto softmax = [&](int j) {
        const int k0 = c_lo + j * BK;
        const bool mask = view<BK>(q0 + wr, q0 + wr + 63, k0, t_len, causal,
                                   has_window, window).mask;
        online_softmax(s, m, l, corr, row0, k0, mask, t_len, causal,
                       has_window, window, scale2);
    };
    // P's registers are an operand of the P V in flight: repack them only
    // once it is done
    auto pack_p = [&] {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            p[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            p[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            p[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            p[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
    };

    mbar_wait(qbar, 0);
    for (int j = 0; j < jb; ++j) {
        mbar_wait(full + 8 * (j % NST), (j / NST) & 1);
        release(empty, j % NST);
    }
    if (jb < je) {
        mbar_wait(full + 8 * (jb % NST), (jb / NST) & 1);
        fence_regs(s);
        wgmma_fence();
        mma_qk<HD, BK, L::kBQ>(s, qa, ks + (jb % NST) * L::kStage);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        softmax(jb);
        pack_p();
        for (int j = jb + 1; j < je; ++j) {
            const int st = j % NST, sp = (j - 1) % NST;
            mbar_wait(full + 8 * st, (j / NST) & 1);
            fence_regs(s);
            fence_regs(o);
            wgmma_fence();
            mma_qk<HD, BK, L::kBQ>(s, qa, ks + st * L::kStage);
            wgmma_commit();
            mma_pv<HD, BK>(o, p, ks + sp * L::kStage + L::kKV);
            wgmma_commit();
            wgmma_wait<1>();  // S_j is in; P_{j-1} V_{j-1} may still run
            fence_regs(s);
            softmax(j);
            wgmma_wait<0>();
            fence_regs(o);
            release(empty, sp);
            rescale(o, corr);
            pack_p();
        }
        fence_regs(o);
        wgmma_fence();
        mma_pv<HD, BK>(o, p, ks + ((je - 1) % NST) * L::kStage + L::kKV);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        release(empty, (je - 1) % NST);
    }
    for (int j = je; j < n_tiles; ++j) {
        mbar_wait(full + 8 * (j % NST), (j / NST) & 1);
        release(empty, j % NST);
    }

    row_sums(l);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= s_len) continue;
        const float safe = l[h] > 0.0f ? l[h] : 1.0f;
        __nv_bfloat16 *orow = out + (head * s_len + row) * HD + 2 * t;
#pragma unroll
        for (int nd = 0; nd < NO; ++nd)
            *reinterpret_cast<__nv_bfloat162 *>(orow + nd * 8) =
                __floats2bfloat162_rn(__fdiv_rn(o[nd][2 * h], safe),
                                      __fdiv_rn(o[nd][2 * h + 1], safe));
    }
}

// ============================================================ the kernel
template <typename T, int HD, int BK, int NST, int CWG>
__global__ void __launch_bounds__(Smem<T, HD, BK, NST, CWG>::kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, T *__restrict__ out,
             int s_len, int t_len, int causal, int has_window, int window,
             float scale2) {
    __shared__ uint64_t bars[2 * NST + 1];
    extern __shared__ float4 smem4[];
    using L = Smem<T, HD, BK, NST, CWG>;
    const uint32_t qs = (smem_u32(smem4) + 1023) & ~1023u;
    const uint32_t ks = qs + L::kQAll;
    const uint32_t full = smem_u32(bars), empty = full + 8 * NST;
    const uint32_t qbar = full + 16 * NST;

    const int warp = threadIdx.x / 32;
    const long long head = blockIdx.x;
    // longest rows first
    const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kBQ;
    int c_lo;
    const int n_tiles = tile_range<BK, L::kBQ>(q0, t_len, causal, has_window,
                                               window, &c_lo);
    if (threadIdx.x == 0) {
        for (int i = 0; i < NST; ++i) {
            mbar_init(full + 8 * i, 1);
            mbar_init(empty + 8 * i, L::kConsumers);
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == L::kConsumers) {
        if (threadIdx.x % 32 == 0)
            produce<T, HD, BK, NST, CWG>(&tq, &tk, &tv, qs, ks, qbar, full, empty,
                                    q0, (int)head, c_lo, n_tiles);
        return;
    }
    if constexpr (sizeof(T) == 4)
        consume_f32<HD, BK, NST, CWG>(out, qs, ks, qbar, full, empty, head, q0,
                                 c_lo, n_tiles, s_len, t_len, causal,
                                 has_window, window, scale2);
    else
        consume_bf16<HD, BK, NST, CWG>(out, qs, ks, qbar, full, empty, head,
                                  q0, (warp / 4) * 64, c_lo, n_tiles, s_len,
                                  t_len, causal, has_window, window, scale2);
}

// ------------------------------------------------------------- host side
using EncodeTiled = CUresult (*)(CUtensorMap *, CUtensorMapDataType,
                                 cuuint32_t, void *, const cuuint64_t *,
                                 const cuuint64_t *, const cuuint32_t *,
                                 const cuuint32_t *, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = [] {
        void *p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                    cudaEnableDefault,
                                    &found) != cudaSuccess ||
            found != cudaDriverEntryPointSuccess)
            return EncodeTiled(nullptr);
        return reinterpret_cast<EncodeTiled>(p);
    }();
    return fn;
}

// (hd, len, bh) of one input, boxes of (128 bytes of columns, rows, 1),
// 128-byte swizzle, zeros past the end
template <typename T>
bool tensor_map(CUtensorMap *map, const void *ptr, int bh, int len, int hd,
                int rows) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)len,
                                (cuuint64_t)bh};
    const cuuint64_t strides[2] = {(cuuint64_t)hd * sizeof(T),
                                   (cuuint64_t)len * hd * sizeof(T)};
    const cuuint32_t box[3] = {(cuuint32_t)(128 / sizeof(T)),
                               (cuuint32_t)rows, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return encode(map,
                  sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  3, const_cast<void *>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD, int BK, int NST, int CWG>
int launch(const void *q, const void *k, const void *v, void *out, int bh,
           int s_len, int t_len, int causal, int has_window, int window,
           float scale, cudaStream_t stream) {
    CUtensorMap tq, tk, tv;
    using L = Smem<T, HD, BK, NST, CWG>;
    if (!tensor_map<T>(&tq, q, bh, s_len, HD, L::kBQ) ||
        !tensor_map<T>(&tk, k, bh, t_len, HD, BK) ||
        !tensor_map<T>(&tv, v, bh, t_len, HD, BK))
        return (int)cudaErrorInvalidValue;
    auto kern = flash_kernel<T, HD, BK, NST, CWG>;
    const int smem = L::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(bh, (s_len + L::kBQ - 1) / L::kBQ);
    kern<<<grid, L::kThreads, smem, stream>>>(tq, tk, tv, static_cast<T *>(out),
                                           s_len, t_len, causal, has_window,
                                           window, scale * kLog2e);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32 (3xTF32), 1 = bfloat16 (wgmma).
// q (bh, s_len, hd), k and v (bh, t_len, hd), out like q, all contiguous
// and 16-byte aligned; hd is 64, 128 or 256.  The caller checks shapes,
// dtypes, contiguity, alignment, 1 <= bh <= 65535 and 1 <= s_len, t_len.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int flash_attention_bhsd_launch(
    int dtype_code, const void *q, const void *k, const void *v, void *out,
    int bh, int s_len, int t_len, int hd, int causal, int has_window,
    int window, float scale, void *stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    using bf16 = __nv_bfloat16;
    // <dtype, hd, k tile, stages, consumer warpgroups>: at f32 the split q
    // (hi and lo) takes half of shared memory, so hd 128 takes 32-column k
    // tiles in 2 stages, and hd 256 one warpgroup (q and q lo 128 KB) and
    // one stage of 32 columns (96 KB); bf16 hd 64 has the registers for a
    // third warpgroup (192 q rows), hd 128 has not.  hd 256 (an output
    // accumulator of 128 registers a thread) takes one warpgroup: beside
    // the producer warp, two are budgeted as 384 threads, 168 registers a
    // thread, and the accumulator spills; one may hold 255, and its 64 q
    // rows leave room for 3 stages of 64 columns (224 KB).  Measured by
    // tools/kernel_sweep.py (PERF.md, section 6).
    if (dtype_code == 0 && hd == 64)
        return launch<float, 64, 64, 3, 2>(q, k, v, out, bh, s_len, t_len,
                                           causal, has_window, window, scale,
                                           s);
    if (dtype_code == 0 && hd == 128)
        return launch<float, 128, 32, 2, 2>(q, k, v, out, bh, s_len, t_len,
                                            causal, has_window, window,
                                            scale, s);
    if (dtype_code == 1 && hd == 64)
        return launch<bf16, 64, 64, 4, 3>(q, k, v, out, bh, s_len, t_len,
                                          causal, has_window, window, scale,
                                          s);
    if (dtype_code == 1 && hd == 128)
        return launch<bf16, 128, 64, 3, 2>(q, k, v, out, bh, s_len, t_len,
                                           causal, has_window, window, scale,
                                           s);
    if (dtype_code == 0 && hd == 256)
        return launch<float, 256, 32, 1, 1>(q, k, v, out, bh, s_len, t_len,
                                            causal, has_window, window,
                                            scale, s);
    if (dtype_code == 1 && hd == 256)
        return launch<bf16, 256, 64, 3, 1>(q, k, v, out, bh, s_len, t_len,
                                           causal, has_window, window, scale,
                                           s);
    return (int)cudaErrorInvalidValue;
}
