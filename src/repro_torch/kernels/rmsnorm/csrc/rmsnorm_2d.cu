// Row RMSNorm on (T, D), written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rmsnorm/kernel.py::rmsnorm_2d
//   (its pallas_call at kernel.py:34).
//
// For every row t, in f32:
//   var     = sum_d x[t, d]^2 / D
//   inv     = 1 / sqrt(var + eps)
//   out[t]  = (x[t] * inv) * (1 + scale)          cast to x's dtype
// x and scale are f32 or bf16 (one dtype), widened to f32 on load.
//
// What bounds it on an H100: memory.  The function reads x once and writes
// out once, 2 * T * D * itemsize bytes (the (D,) scale is noise): at
// (8192, 768) that is 50.3 MB f32 and 25.2 MB bf16, 0.0150 and 0.0075 ms
// at 3.35 TB/s, against about 4 flops an element.
//
// What the design does about it: every byte of x crosses the memory bus
// once, in 16-byte vectors (4 f32 or 8 bf16 values a lane), so the kernel
// moves 2 * T * D * itemsize bytes from and to device memory, plus 1 + scale
// once a thread from L2.  A row is cut into D / L "slots" of L = 16 /
// itemsize elements; slot s of a row goes to thread s % G of the G threads
// that own the row, which keep x's slots (packed, as loaded) and the f32
// values of 1 + scale for their columns in registers.  All of a row's
// loads are issued before its sum of squares is reduced, and the next
// row's before this row's sum, so two rows are in flight a thread.  The
// row threads walk rows in a grid-stride loop over one wave of blocks,
// each block the same number of rows, so 1 + scale is read once a thread,
// not once a row.  Three size classes, chosen at launch from D:
//   - warp:  one warp a row, 4 rows a block, V <= 8 slots a lane
//            (D <= 1024 at f32, 2048 at bf16): shuffles reduce the row;
//   - block: one block of G <= 1024 threads a row, 8 slots a thread, up to
//            D = 8192: shuffles, then the warps' partial sums through
//            shared memory (added in a fixed order, so every thread gets
//            the same sum);
//   - long:  above D = 8192 one block a row walks the row twice, with the
//            same vector loads, 4 slots in flight a thread; the second
//            read of the row, and 1 + scale, come from L2 (a 16384-wide
//            f32 row is 64 KB), so device memory still sees x once.
// A D that is a multiple of L, with x starting off a 16-byte boundary by
// e elements (a view: ops.rmsnorm flattens views), has the same shift on
// every row; the wrapper gives out the same shift, so the row's head
// (L - e elements) and tail (e) together form one more slot, read and
// written element by element, and the rest stays vectorised.  A D that is
// not a multiple of L shifts every row differently: then a slot is one
// element (coalesced 4- or 2-byte lanes), in the same classes.
//
// Rounding: the sum of squares is an FMA chain per thread, then a shuffle
// tree, then (block classes) the warps' sums in order: its order differs
// from the plain version's; inv is 1 / sqrt, each correctly rounded
// (__fsqrt_rn, __fdiv_rn), where rsqrtf would be approximate; the scaling
// uses the _rn intrinsics in the JAX kernel's order, (x * inv) * (1 + scale).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librmsnorm_2d.so rmsnorm_2d.cu
// Entry point: rmsnorm_2d_launch (plain C, loaded with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpRows = 4;       // rows (warps) a block in the warp class
constexpr int kWarpMaxSlots = 8;   // slots a lane in the warp class
constexpr int kBlockSlots = 8;     // slots a thread in the block class
constexpr int kBlockMaxD = 8192;   // the block class's largest D
constexpr int kLongThreads = 512;  // threads a row in the long class
constexpr int kLongUnroll = 4;     // slots in flight a thread, long class

struct F32 {
    using bits_t = float;
    using vec_t = float4;
    static constexpr int kLanes = 4;
    __device__ static __forceinline__ float widen(float v) { return v; }
    __device__ static __forceinline__ float round(float v) { return v; }
    __device__ static __forceinline__ float bits(float v) { return v; }
    __device__ static __forceinline__ void unpack(const float4 &v, float *o) {
        o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    }
    __device__ static __forceinline__ float4 pack(const float *i) {
        return make_float4(i[0], i[1], i[2], i[3]);
    }
};

struct BF16 {
    using bits_t = uint16_t;  // one bf16 value's bits
    using vec_t = uint4;      // 8 bf16 values, little-endian pairs a word
    static constexpr int kLanes = 8;
    __device__ static __forceinline__ float widen(uint16_t v) {
        return __uint_as_float((uint32_t)v << 16);
    }
    __device__ static __forceinline__ float round(float v) {
        return __bfloat162float(__float2bfloat16_rn(v));
    }
    // v is already a bf16 value (see round), so its high half is exact
    __device__ static __forceinline__ uint16_t bits(float v) {
        return (uint16_t)(__float_as_uint(v) >> 16);
    }
    __device__ static __forceinline__ void unpack(const uint4 &v, float *o) {
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            o[2 * k] = __uint_as_float(w[k] << 16);
            o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
        }
    }
    // inputs are already bf16 values, so keeping the high halves is exact
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

// One row's layout in slots of N elements: N == T::kLanes (vectors) or 1
// (elements).  With vectors, the row's first `head` elements lie before a
// 16-byte boundary; then slots 0 .. slots - 2 are the aligned vectors from
// column head on, and the last slot gathers the head and the tail.  A slot
// is held as raw_t, the dtype's bits (packed: 4 registers for 8 bf16
// values).
template <typename T, int N>
struct Row {
    using raw_t = std::conditional_t<N == 1, typename T::bits_t,
                                     typename T::vec_t>;
    int d, slots, head;

    __device__ __forceinline__ bool split(int s) const {
        return N > 1 && head != 0 && s == slots - 1;
    }
    // column of element j of the split slot
    __device__ __forceinline__ int split_col(int j) const {
        return j < head ? j : d - N + j;
    }
    __device__ __forceinline__ raw_t load(const typename T::bits_t *r,
                                          int s) const {
        if constexpr (N == 1) {
            return r[s];
        } else {
            if (split(s)) {  // widening and packing bf16 values is exact
                float v[N];
#pragma unroll
                for (int j = 0; j < N; ++j) v[j] = T::widen(r[split_col(j)]);
                return T::pack(v);
            }
            return *reinterpret_cast<const typename T::vec_t *>(
                r + head + s * N);
        }
    }
    __device__ static __forceinline__ void unpack(const raw_t &raw,
                                                  float *v) {
        if constexpr (N == 1) {
            v[0] = T::widen(raw);
        } else {
            T::unpack(raw, v);
        }
    }
    // v holds values of the dtype (rounded)
    __device__ __forceinline__ void store(typename T::bits_t *r, int s,
                                          const float *v) const {
        if constexpr (N == 1) {
            r[s] = T::bits(v[0]);
        } else if (split(s)) {
#pragma unroll
            for (int j = 0; j < N; ++j) r[split_col(j)] = T::bits(v[j]);
        } else {
            *reinterpret_cast<typename T::vec_t *>(r + head + s * N) =
                T::pack(v);
        }
    }
    // 1 + scale at slot s's columns, element by element (scale's own
    // alignment does not matter)
    __device__ __forceinline__ void scale(const typename T::bits_t *sc, int s,
                                          float *v) const {
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const int c = N == 1 ? s : (split(s) ? split_col(j)
                                                 : head + s * N + j);
            v[j] = __fadd_rn(1.0f, T::widen(sc[c]));
        }
    }
};

// sum of squares of a slot's values, continuing the FMA chain ss
template <typename T, int N>
__device__ __forceinline__ float sum_sq(const typename Row<T, N>::raw_t &raw,
                                        float ss) {
    float v[N];
    Row<T, N>::unpack(raw, v);
#pragma unroll
    for (int j = 0; j < N; ++j) ss = fmaf(v[j], v[j], ss);
    return ss;
}

// (x * inv) * (1 + scale) of a slot, rounded to the dtype
template <typename T, int N>
__device__ __forceinline__ void scaled(const typename Row<T, N>::raw_t &raw,
                                       float inv, const float *sc, float *o) {
    float v[N];
    Row<T, N>::unpack(raw, v);
#pragma unroll
    for (int j = 0; j < N; ++j)
        o[j] = T::round(__fmul_rn(__fmul_rn(v[j], inv), sc[j]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

__device__ __forceinline__ float inv_rms(float ss, int d, float eps) {
    const float var = __fdiv_rn(ss, (float)d);
    return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// Warp and block classes: V slots a thread held in registers.  kBlock:
// one block (blockDim.x threads) a row, else one warp a row.
template <typename T, int N, int V, bool kBlock>
__global__ void __launch_bounds__(kBlock ? (N == 1 ? 1024 : 256)
                                         : 32 * kWarpRows)
rmsnorm_regs_kernel(const typename T::bits_t *__restrict__ x,
                    const typename T::bits_t *__restrict__ scale,
                    typename T::bits_t *__restrict__ out, long long rows,
                    int d, int head, float eps) {
    __shared__ float partial[2][32];
    const Row<T, N> row{d, d / N, head};
    const int g = kBlock ? blockDim.x : 32;
    const int tid = kBlock ? threadIdx.x : threadIdx.x % 32;
    const long long first = kBlock ? blockIdx.x
        : (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
    const long long stride = kBlock ? gridDim.x
        : (long long)gridDim.x * (blockDim.x / 32);
    if (first >= rows) return;  // whole warps or blocks only
    float sc[V][N];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const int s = tid + k * g;
        if (s < row.slots) row.scale(scale, s, sc[k]);
    }
    using raw_t = typename Row<T, N>::raw_t;
    auto load_row = [&](raw_t *v, long long t) {
        const typename T::bits_t *xr = x + t * d;
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const int s = tid + k * g;
            if (s < row.slots) v[k] = row.load(xr, s);
        }
    };
    raw_t v[V];
    load_row(v, first);
    int parity = 0;
    for (long long t = first; t < rows; t += stride) {
        // the next row's loads go out before this row's sum (PERF.md
        // section 6 times this against loading it after the stores)
        const long long next = t + stride;
        raw_t nv[V];
        if (next < rows) load_row(nv, next);
        float ss = 0.0f;
#pragma unroll
        for (int k = 0; k < V; ++k) {
            if (tid + k * g < row.slots) ss = sum_sq<T, N>(v[k], ss);
        }
        ss = warp_sum(ss);
        if (kBlock) {
            const int warps = blockDim.x / 32;
            if (threadIdx.x % 32 == 0) partial[parity][threadIdx.x / 32] = ss;
            __syncthreads();
            ss = 0.0f;
            for (int i = 0; i < warps; ++i)
                ss = __fadd_rn(ss, partial[parity][i]);
            parity ^= 1;  // the next row writes the other buffer
        }
        const float inv = inv_rms(ss, d, eps);
        typename T::bits_t *orow = out + t * d;
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const int s = tid + k * g;
            if (s < row.slots) {
                float o[N];
                scaled<T, N>(v[k], inv, sc[k], o);
                row.store(orow, s, o);
            }
        }
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = nv[k];
    }
}

// Long class: one block a row, the row read twice (the second time from
// L2), kLongUnroll slots in flight a thread.
template <typename T, int N>
__global__ void __launch_bounds__(kLongThreads)
rmsnorm_long_kernel(const typename T::bits_t *__restrict__ x,
                    const typename T::bits_t *__restrict__ scale,
                    typename T::bits_t *__restrict__ out, long long rows,
                    int d, int head, float eps) {
    __shared__ float partial[2][32];
    const Row<T, N> row{d, d / N, head};
    constexpr int U = kLongUnroll;
    const int g = blockDim.x;
    int parity = 0;
    for (long long t = blockIdx.x; t < rows; t += gridDim.x) {
        const typename T::bits_t *xr = x + t * d;
        float ss = 0.0f;
        for (int s0 = threadIdx.x; s0 < row.slots; s0 += U * g) {
            typename Row<T, N>::raw_t v[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (s0 + u * g < row.slots) v[u] = row.load(xr, s0 + u * g);
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (s0 + u * g < row.slots) ss = sum_sq<T, N>(v[u], ss);
            }
        }
        ss = warp_sum(ss);
        if (threadIdx.x % 32 == 0) partial[parity][threadIdx.x / 32] = ss;
        __syncthreads();
        ss = 0.0f;
        for (int i = 0; i < g / 32; ++i) ss = __fadd_rn(ss, partial[parity][i]);
        parity ^= 1;
        const float inv = inv_rms(ss, d, eps);
        typename T::bits_t *orow = out + t * d;
        for (int s0 = threadIdx.x; s0 < row.slots; s0 += U * g) {
            typename Row<T, N>::raw_t v[U];
            float sc[U][N];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (s0 + u * g < row.slots) {
                    v[u] = row.load(xr, s0 + u * g);
                    row.scale(scale, s0 + u * g, sc[u]);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (s0 + u * g < row.slots) {
                    float o[N];
                    scaled<T, N>(v[u], inv, sc[u], o);
                    row.store(orow, s0 + u * g, o);
                }
            }
        }
    }
}

// Blocks for `needed` units of work (a row, or kWarpRows rows), at most
// one wave of blocks of `threads` threads, with the units spread evenly:
// every block walks the same number of units (the last maybe fewer), so no
// few blocks run a last round alone.  per_sm caches the occupancy of this
// kernel at this block size (0: not asked yet), so a launch asks the
// runtime only once.
template <typename K>
long long wave(K kernel, int threads, int &per_sm, long long needed) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (per_sm == 0) {
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
    }
    const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const long long rounds = (needed + full - 1) / full;
    return (needed + rounds - 1) / rounds;
}

template <typename T, int N, int V, bool kBlock>
void launch_regs(const void *x, const void *scale, void *out, long long rows,
                 int d, int head, float eps, cudaStream_t stream) {
    auto kernel = rmsnorm_regs_kernel<T, N, V, kBlock>;
    static int per_sm[1024 / 32 + 1];  // by threads / 32
    int threads;
    long long needed;
    if (kBlock) {
        const int per_thread = (d / N + V - 1) / V;
        threads = (per_thread + 31) / 32 * 32;
        needed = rows;
    } else {
        threads = 32 * kWarpRows;
        needed = (rows + kWarpRows - 1) / kWarpRows;
    }
    const long long blocks = wave(kernel, threads, per_sm[threads / 32],
                                  needed);
    kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const typename T::bits_t *>(x),
        static_cast<const typename T::bits_t *>(scale),
        static_cast<typename T::bits_t *>(out), rows, d, head, eps);
}

template <typename T, int N>
void launch_class(const void *x, const void *scale, void *out, long long rows,
                  int d, int head, float eps, cudaStream_t s) {
    const int slots = d / N;
    if (slots <= 32 * 1)
        launch_regs<T, N, 1, false>(x, scale, out, rows, d, head, eps, s);
    else if (slots <= 32 * 2)
        launch_regs<T, N, 2, false>(x, scale, out, rows, d, head, eps, s);
    else if (slots <= 32 * 3)
        launch_regs<T, N, 3, false>(x, scale, out, rows, d, head, eps, s);
    else if (slots <= 32 * 4)
        launch_regs<T, N, 4, false>(x, scale, out, rows, d, head, eps, s);
    else if (slots <= 32 * 6)
        launch_regs<T, N, 6, false>(x, scale, out, rows, d, head, eps, s);
    else if (slots <= 32 * kWarpMaxSlots)
        launch_regs<T, N, kWarpMaxSlots, false>(x, scale, out, rows, d, head,
                                                eps, s);
    else if (d <= kBlockMaxD)
        launch_regs<T, N, kBlockSlots, true>(x, scale, out, rows, d, head,
                                             eps, s);
    else {
        auto kernel = rmsnorm_long_kernel<T, N>;
        static int per_sm = 0;
        const long long blocks = wave(kernel, kLongThreads, per_sm, rows);
        kernel<<<(unsigned)blocks, kLongThreads, 0, s>>>(
            static_cast<const typename T::bits_t *>(x),
            static_cast<const typename T::bits_t *>(scale),
            static_cast<typename T::bits_t *>(out), rows, d, head, eps);
    }
}

template <typename T>
int launch(const void *x, const void *scale, void *out, long long rows, int d,
           float eps, cudaStream_t stream) {
    constexpr int L = T::kLanes;
    const uintptr_t xa = reinterpret_cast<uintptr_t>(x) % 16;
    if (d % L == 0 && xa == reinterpret_cast<uintptr_t>(out) % 16) {
        // elements before x's first 16-byte boundary, the same on every row
        const int head = (int)((16 - xa) % 16 / sizeof(typename T::bits_t));
        launch_class<T, L>(x, scale, out, rows, d, head, eps, stream);
    } else {
        launch_class<T, 1>(x, scale, out, rows, d, 0, eps, stream);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (x, scale and out alike).  x and out
// (rows, d) contiguous, scale (d,); out should start at the same offset
// from a 16-byte boundary as x (else the rows go element by element).  The
// caller checks shapes, dtypes, contiguity, rows >= 1 and d >= 1.  Returns
// the CUDA error of the launch (0 = launched).
extern "C" int rmsnorm_2d_launch(int dtype_code, const void *x,
                                 const void *scale, void *out, long long rows,
                                 int d, float eps, void *stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype_code == 0) return launch<F32>(x, scale, out, rows, d, eps, s);
    if (dtype_code == 1) return launch<BF16>(x, scale, out, rows, d, eps, s);
    return (int)cudaErrorInvalidValue;
}
