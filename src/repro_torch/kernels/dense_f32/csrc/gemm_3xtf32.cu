// Batched f32 matrix product C[b] = A[b] B[b] on the tensor cores, as
// 3xTF32, written by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: port-only.  The JAX package leaves the model's
// weight products to XLA; on this card PyTorch's f32 product (TF32 off)
// runs on the CUDA cores, at most 66.9 TFLOP/s.  This kernel takes the
// f32 route on the tensor cores instead.  Each operand x is split into
// hi = tf32(x) (round to nearest, ties away: (bits + 0x1000) & ~0x1fff)
// and lo = x - hi (exact in f32, read by the tensor cores as tf32 with its
// low 13 bits dropped), and a.b is taken as lo.hi + hi.lo + hi.hi with f32
// accumulation: about 21 bits of each product where TF32 alone keeps 10.
//
// Shapes: A[b] (M, K), B[b] (K, N), C[b] (M, N) row-major and contiguous.
// A and B are each read where they lie, K-major (the K stride is 1) or
// MN-major (the M or N stride is 1), by their batch stride (0: one matrix
// for every b) and their leading stride, all in elements; ragged M, N and
// K are read as zeros past the edge (TMA) and masked at the store.
//
// What bounds it on an H100: operations.  Three TF32 products for each
// f32 product at the dense TF32 rate (494.7 TFLOP/s) give 164.9 TFLOP/s
// of f32 work; the bytes (each input read once, C written once) bound
// only the thinnest shapes.  Beside the products, every element of every
// A and B tile is split once, and the split B has to reach shared memory
// K-major, the only layout TF32 wgmma reads.
//
// The design.  A persistent grid (one CTA an SM) walks 128 x 128 output
// tiles, M-tiles fastest within groups of 8, so that the CTAs of one wave
// share B tiles through L2.  A producer warpgroup (one thread issues; its
// registers given to the consumers with setmaxnreg) streams the raw f32 A
// and B tiles of 32-deep K steps through a ring of 4 shared-memory stages
// with TMA (128-byte swizzle; an MN-major operand as four 32 x 32 boxes),
// each stage with a "full" and an "empty" mbarrier, across tile
// boundaries, so one tile's epilogue overlaps the next tile's loads.  Two
// consumer warpgroups own 64 rows each.  A K step: the 256 consumer
// threads split the stage's B tile into hi and lo tiles, K-major whatever
// B's layout (an MN-major B is transposed on the way, a 4 x 4 block a
// thread through registers, with no bank conflict on either side), while
// each warp loads its A fragments (the register layout of wgmma's A
// operand) from the raw stage and splits them in registers; the stage is
// released at once.  A named barrier makes the split tile visible to both
// warpgroups; each then waits for its step before, adds that step's
// partial sum into its f32 accumulator (64 registers a thread) with
// rounded adds, and issues 12 wgmma.m64n128k8 (4 depth steps of lo.hi,
// hi.lo, hi.hi) into a fresh partial sum (64 more): the next step's split
// runs on the CUDA cores while this step's products run on the tensor
// cores.  The tensor cores' own adds truncate; a whole tile summed by them
// parts from f32 by ~6x cuBLAS's error at K = 1,000, a K step at a time by
// 0.2-0.5x (PERF.md).  The split tiles cycle through 3 buffers (one is
// rewritten only after the barrier that follows both warpgroups' waits for
// its products) and the A fragments through 2 register sets.  Shared
// memory: 4 stages x 32 KB + 3 split tiles x 32 KB = 224 KB.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libgemm_3xtf32.so gemm_3xtf32.cu
// Entry point: gemm_3xtf32_launch (plain C, loaded with ctypes).
// cuTensorMapEncodeTiled is looked up through the runtime
// (cudaGetDriverEntryPoint), so the library does not link libcuda.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128, BN = 128, BK = 32;  // output tile, K step
constexpr int NST = 4;                       // raw stages
constexpr int NSPLIT = 3;                    // split B tiles
constexpr int GROUP_M = 8;                   // M tiles of a raster group
constexpr int CONSUMERS = 8;                 // consumer warps
constexpr int THREADS = 32 * (CONSUMERS + 4);  // + a producer warpgroup
// registers a thread (setmaxnreg): 128 x 40 + 256 x 232 <= 65,536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int TILE_BYTES = BM * BK * 4;      // 16 KB: A (or B) of a stage
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // raw A + raw B
constexpr int SPLIT_BYTES = 2 * TILE_BYTES;  // B hi + B lo
constexpr int SMEM_BYTES = NST * STAGE_BYTES + NSPLIT * SPLIT_BYTES + 1024;
static_assert(BM == BN, "one tile size for A and B boxes");

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
// One box of a 3-D tensor map (inner, outer, batch) into shared memory; the
// copy credits its bytes to `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap *map,
                                         uint32_t bar, int inner, int outer,
                                         int batch) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner),
        "r"(outer), "r"(batch)
        : "memory");
}

// ------------------------------------------------------------- layouts
// Byte offset of element (r, c) of a tile stored as 128-byte rows of 32
// f32 columns in TMA's 128-byte swizzle (16-byte chunk c / 4 of row r at
// chunk (c / 4) ^ (r % 8)).  A K-major tile is 128 rows (M or N) of its
// 32 K columns; an MN-major one is four 32 x 32 boxes (K rows of 32 M or N
// columns), box i holding columns 32i ..  32i + 31.
__device__ __forceinline__ uint32_t kmajor_at(int mn, int k) {
    return (uint32_t)(mn * 128 + ((((k >> 2) ^ (mn & 7))) << 4) + (k & 3) * 4);
}
__device__ __forceinline__ uint32_t mnmajor_at(int mn, int k) {
    return (uint32_t)((mn >> 5) * 4096 + k * 128 +
                      ((((mn & 31) >> 2) ^ (k & 7)) << 4) + (mn & 3) * 4);
}
template <bool KMAJOR>
__device__ __forceinline__ uint32_t raw_at(int mn, int k) {
    return KMAJOR ? kmajor_at(mn, k) : mnmajor_at(mn, k);
}
__device__ __forceinline__ float lds(uint32_t a) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
    return v;
}

// ------------------------------------------------------------ 3xTF32
// hi = x rounded to TF32 (nearest, ties away from zero); lo = x - hi, exact
// in f32, whose low 13 bits the tensor cores drop.  A NaN keeps a NaN lo.
__device__ __forceinline__ void split(float x, uint32_t &hi, uint32_t &lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// The split parts of 4 values, each 16 bytes into shared memory.
__device__ __forceinline__ void store_split(uint32_t hi, uint32_t lo,
                                            const float (&x)[4]) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(x[e], h[e], l[e]);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi),
                 "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3])
                 : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo),
                 "r"(l[0]), "r"(l[1]), "r"(l[2]), "r"(l[3])
                 : "memory");
}

// ================================================================ wgmma
// Shared-memory matrix descriptor for the 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
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
// keep the compiler from moving accesses to r across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

#define WG_F4(d, i) \
    "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
#define WG_F16(d, i) WG_F4(d, i), WG_F4(d, i + 1), WG_F4(d, i + 2), \
    WG_F4(d, i + 3)
#define WG_F32(d, i) WG_F16(d, i), WG_F16(d, i + 4)
#define WG_D64                                                            \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
    "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
    "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
    "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128) (+)= A B, A TF32 in registers (the m64k8 fragment), B K-major
// TF32 in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : WG_F32(d, 0), WG_F32(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
}

// The consumer warps meet at named barrier 1 (0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * CONSUMERS) : "memory");
}

// ============================================================ tiles
struct Shape {
    int m, n, k, batch, tiles_m, tiles_n, n_k;
};
// Output tile t of the grid's walk: batch outermost, then groups of
// GROUP_M M-tiles, M fastest inside a group.
__device__ __forceinline__ void tile_of(const Shape &s, int t, int &bz,
                                        int &m0, int &n0) {
    const int per_batch = s.tiles_m * s.tiles_n;
    bz = t / per_batch;
    t -= bz * per_batch;
    const int group = GROUP_M * s.tiles_n;
    const int first_m = (t / group) * GROUP_M;
    const int rows = min(s.tiles_m - first_m, GROUP_M);
    const int in_group = t % group;
    m0 = (first_m + in_group % rows) * BM;
    n0 = (in_group / rows) * BN;
}

template <bool AK, bool BKM>
__device__ __forceinline__ void produce(const CUtensorMap *ta,
                                        const CUtensorMap *tb, uint32_t raw,
                                        uint32_t full, uint32_t empty,
                                        const Shape &s, int a_batched,
                                        int b_batched) {
    const int n_tiles = s.tiles_m * s.tiles_n * s.batch;
    uint32_t it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int bz, m0, n0;
        tile_of(s, t, bz, m0, n0);
        const int za = a_batched ? bz : 0, zb = b_batched ? bz : 0;
        for (int kt = 0; kt < s.n_k; ++kt, ++it) {
            const uint32_t st = it % NST;
            mbar_wait(empty + 8 * st, ((it / NST) & 1) ^ 1);
            const uint32_t bar = full + 8 * st;
            mbar_expect_tx(bar, STAGE_BYTES);
            const uint32_t da = raw + st * STAGE_BYTES;
            const uint32_t db = da + TILE_BYTES;
            const int k0 = kt * BK;
            if (AK) {
                tma_load(da, ta, bar, k0, m0, za);
            } else {
#pragma unroll
                for (int i = 0; i < BM / 32; ++i)
                    tma_load(da + i * 4096, ta, bar, m0 + 32 * i, k0, za);
            }
            if (BKM) {
                tma_load(db, tb, bar, k0, n0, zb);
            } else {
#pragma unroll
                for (int i = 0; i < BN / 32; ++i)
                    tma_load(db + i * 4096, tb, bar, n0 + 32 * i, k0, zb);
            }
        }
    }
}

// One consumer thread: its warpgroup's 64 rows of each tile.
template <bool AK, bool BKM>
struct Consumer {
    float acc[16][4];                     // the tile's sum, f32 adds
    float part[16][4];                    // one K step on the tensor cores
    uint32_t ahi[2][4][4], alo[2][4][4];  // [register set][depth step][]
    uint32_t raw, split_base, full, empty;
    int wg, warp, lane;

    // K step `it` of the CTA's walk, into register set P; `first` is the
    // tile's first step (no partial sum before it).
    template <int P>
    __device__ __forceinline__ void step(uint32_t it, bool first) {
        const uint32_t st = it % NST;
        const uint32_t sa = raw + st * STAGE_BYTES, sb = sa + TILE_BYTES;
        const uint32_t hi = split_base + (it % NSPLIT) * SPLIT_BYTES;
        const uint32_t lo = hi + TILE_BYTES;
        mbar_wait(full + 8 * st, (it / NST) & 1);

        // B: hi and lo tiles, K-major, each thread 16-byte chunks of 4 K
        // values, read and written without bank conflicts
        const int tid = threadIdx.x;
        if (BKM) {  // thread c: column c % 128, chunk c / 128, in place
#pragma unroll
            for (int r = 0; r < BN * BK / (4 * 32 * CONSUMERS); ++r) {
                const int c = tid + r * 32 * CONSUMERS;
                const uint32_t off = kmajor_at(c % BN, 4 * (c / BN));
                float x[4];
                asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                             : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
                             : "r"(sb + off));
                store_split(hi + off, lo + off, x);
            }
        } else {  // a 4 x 4 block a thread, transposed in registers: columns
                  // 4j .. 4j + 3, depths 4q .. 4q + 3; the 8 threads of a
                  // quarter warp take 8 distinct chunk positions both ways
            static_assert(BN * BK == 16 * 32 * CONSUMERS, "one block each");
            const int l = tid & 7;
            const int j = 8 * ((tid >> 3) & 3) + l, q = l ^ (tid >> 5);
            float x[4][4];  // [depth][column]
#pragma unroll
            for (int e = 0; e < 4; ++e)
                asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                             : "=f"(x[e][0]), "=f"(x[e][1]), "=f"(x[e][2]),
                               "=f"(x[e][3])
                             : "r"(sb + mnmajor_at(4 * j, 4 * q + e)));
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float col[4] = {x[0][i], x[1][i], x[2][i], x[3][i]};
                const uint32_t off = kmajor_at(4 * j + i, 4 * q);
                store_split(hi + off, lo + off, col);
            }
        }
        // A: the warp's 16 rows, fragment (g, t), (g + 8, t), (g, t + 4),
        // (g + 8, t + 4) of each 8-deep step.  MN-major, the threads of
        // rows g >= 4 read depth t + 4 first: no bank conflict.
        const int g = lane / 4, t = lane % 4;
        const int r0 = wg * 64 + warp * 16 + g;
        const bool swap = !AK && g >= 4;
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
            const int k0 = 8 * kk + t + (swap ? 4 : 0);
            const int k1 = 8 * kk + t + (swap ? 0 : 4);
            float x[4] = {lds(sa + raw_at<AK>(r0, k0)),
                          lds(sa + raw_at<AK>(r0 + 8, k0)),
                          lds(sa + raw_at<AK>(r0, k1)),
                          lds(sa + raw_at<AK>(r0 + 8, k1))};
            if (swap) {
                const float x0 = x[0], x1 = x[1];
                x[0] = x[2];
                x[1] = x[3];
                x[2] = x0;
                x[3] = x1;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
                split(x[e], ahi[P][kk][e], alo[P][kk][e]);
        }
        // the raw stage is free; the split tile is for wgmma (async proxy)
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * st);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumers_sync();

        // the step before is done (its register set is free): add its
        // partial sum, then start this one's
        wgmma_wait<0>();
        fence_regs(part);
        fence_regs(ahi[P ^ 1]);
        fence_regs(alo[P ^ 1]);
        if (!first) add_part();
        fence_regs(part);
        fence_regs(ahi[P]);
        fence_regs(alo[P]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
            const uint32_t off = (uint32_t)(kk * 32);
            wgmma_rs(part, alo[P][kk], sw128_desc(hi + off), kk > 0);
            wgmma_rs(part, ahi[P][kk], sw128_desc(lo + off), 1);
            wgmma_rs(part, ahi[P][kk], sw128_desc(hi + off), 1);
        }
        wgmma_commit();
        fence_regs(part);
        fence_regs(ahi[P]);
        fence_regs(alo[P]);
    }

    // acc += part, rounded to nearest (the tensor cores' own adds within a
    // step truncate; a tile's sum of K / 32 steps here does not)
    __device__ __forceinline__ void add_part() {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
    }

    __device__ __forceinline__ void store(float *c, const Shape &s, int bz,
                                          int m0, int n0) {
        const int g = lane / 4, t = lane % 4;
        const bool pairs = (s.n % 2) == 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
            if (row >= s.m) continue;
            float *crow = c + ((long long)bz * s.m + row) * s.n;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                const int col = n0 + 8 * j + 2 * t;
                const float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
                if (pairs && col + 1 < s.n) {
                    *reinterpret_cast<float2 *>(crow + col) =
                        make_float2(v0, v1);
                } else {
                    if (col < s.n) crow[col] = v0;
                    if (col + 1 < s.n) crow[col + 1] = v1;
                }
            }
        }
    }
};

template <bool AK, bool BKM>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb, float *__restrict__ c,
            Shape s, int a_batched, int b_batched) {
    __shared__ uint64_t bars[2 * NST];
    extern __shared__ float4 smem4[];
    const uint32_t raw = (smem_u32(smem4) + 1023) & ~1023u;
    const uint32_t split_base = raw + NST * STAGE_BYTES;
    const uint32_t full = smem_u32(bars), empty = full + 8 * NST;
    const int warp = threadIdx.x / 32;
    if (threadIdx.x == 0) {
        for (int i = 0; i < NST; ++i) {
            mbar_init(full + 8 * i, 1);
            mbar_init(empty + 8 * i, CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp >= CONSUMERS) {  // the producer warpgroup: one thread works
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
        if (threadIdx.x == 32 * CONSUMERS)
            produce<AK, BKM>(&ta, &tb, raw, full, empty, s, a_batched,
                             b_batched);
        return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    Consumer<AK, BKM> cons;
    cons.raw = raw;
    cons.split_base = split_base;
    cons.full = full;
    cons.empty = empty;
    cons.wg = warp / 4;
    cons.warp = warp % 4;
    cons.lane = threadIdx.x % 32;
    const int n_tiles = s.tiles_m * s.tiles_n * s.batch;
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int bz, m0, n0;
        tile_of(s, tile, bz, m0, n0);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) cons.acc[j][e] = 0.0f;
        for (int kt = 0; kt < s.n_k; kt += 2) {
            cons.template step<0>(it++, kt == 0);
            if (kt + 1 < s.n_k) cons.template step<1>(it++, false);
        }
        wgmma_wait<0>();
        fence_regs(cons.part);
        cons.add_part();
        cons.store(c, s, bz, m0, n0);
    }
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

// An operand (inner, outer, batch) with strides (ld, bs) in elements: boxes
// of 32 inner by `rows` outer, 128-byte swizzle, zeros past the edges.  An
// operand shared by every batch (bs 0) is one matrix (batch extent 1).
bool tensor_map(CUtensorMap *map, const void *ptr, long long inner,
                long long outer, int batch, long long ld, long long bs,
                int rows) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return false;
    const long long extent = ((ld * outer * 4) + 15) / 16 * 16;
    const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer,
                                (cuuint64_t)(bs ? batch : 1)};
    const cuuint64_t strides[2] = {(cuuint64_t)(ld * 4),
                                   (cuuint64_t)(bs ? bs * 4 : extent)};
    const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                  const_cast<void *>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool AK, bool BKM>
int launch(const CUtensorMap &ta, const CUtensorMap &tb, float *c,
           const Shape &s, int a_batched, int b_batched, cudaStream_t stream) {
    auto kern = gemm_kernel<AK, BKM>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return (int)err;
    const long long n_tiles = (long long)s.tiles_m * s.tiles_n * s.batch;
    const int grid = (int)(n_tiles < sms ? n_tiles : sms);
    kern<<<grid, THREADS, SMEM_BYTES, stream>>>(ta, tb, c, s, a_batched,
                                                b_batched);
    return (int)cudaGetLastError();
}

}  // namespace

// C[b] (m, n), row-major and contiguous, = A[b] (m, k) B[b] (k, n) for b <
// batch.  Element (i, kk) of A[b] is at a + b * a_bs + (a_kmajor ? i * a_ld
// + kk : kk * a_ld + i), element (kk, j) of B[b] at b + b * b_bs +
// (b_kmajor ? j * b_ld + kk : kk * b_ld + j), all in f32 elements; a batch
// stride of 0 reads one matrix for every b.  The caller checks: pointers
// 16-byte aligned, leading and batch strides multiples of 4 elements,
// 1 <= m, n, k < 2^31, the tile count < 2^31.  Returns the CUDA error of
// the launch (0 = launched).
extern "C" int gemm_3xtf32_launch(const void *a, const void *b, void *c,
                                  int batch, int m, int n, int k,
                                  long long a_bs, long long a_ld,
                                  int a_kmajor, long long b_bs,
                                  long long b_ld, int b_kmajor,
                                  void *stream) {
    CUtensorMap ta, tb;
    const bool ok_a = a_kmajor
        ? tensor_map(&ta, a, k, m, batch, a_ld, a_bs, BM)
        : tensor_map(&ta, a, m, k, batch, a_ld, a_bs, BK);
    const bool ok_b = b_kmajor
        ? tensor_map(&tb, b, k, n, batch, b_ld, b_bs, BN)
        : tensor_map(&tb, b, n, k, batch, b_ld, b_bs, BK);
    if (!ok_a || !ok_b) return (int)cudaErrorInvalidValue;
    Shape s;
    s.m = m;
    s.n = n;
    s.k = k;
    s.batch = batch;
    s.tiles_m = (m + BM - 1) / BM;
    s.tiles_n = (n + BN - 1) / BN;
    s.n_k = (k + BK - 1) / BK;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float *cf = static_cast<float *>(c);
    const int za = a_bs != 0, zb = b_bs != 0;
    if (a_kmajor && b_kmajor) return launch<true, true>(ta, tb, cf, s, za, zb, st);
    if (a_kmajor) return launch<true, false>(ta, tb, cf, s, za, zb, st);
    if (b_kmajor) return launch<false, true>(ta, tb, cf, s, za, zb, st);
    return launch<false, false>(ta, tb, cf, s, za, zb, st);
}
