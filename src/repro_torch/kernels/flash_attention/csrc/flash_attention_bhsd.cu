// Causal and sliding-window attention with an online softmax, written by
// hand for Hopper (sm_90a).
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
// no offset when T != S).  Inputs are f32 or bf16, widened to f32 on load;
// the output takes q's dtype.
//
// What bounds it on an H100: operations.  A live (r, c) pair costs 4 * hd
// flops (2 * hd for q.k, 2 * hd for p * v): at (96, 1024, 64) causal f32
// that is 12.90 GFLOP, 0.193 ms at 67 TFLOP/s f32, against 100.7 MB of
// q, k, v and out (0.030 ms at 3.35 TB/s).  No TF32 and no tensor core: the
// JAX kernel and both plain versions take f32 products.
//
// What the design does about it: one CTA of 256 threads per (head, 64-row
// q tile).  The q tile stays in shared memory, transposed; each step stages
// a 64-column k tile (transposed) and v tile in shared memory.  Every
// thread owns a 4 x 4 block of the 64 x 64 score tile (rows ty*4.., columns
// tx*4..), so each k or q value loaded feeds 4 FMAs and a step's 16 scores
// take two 16-byte shared loads per head-dim element; the row max and sum
// reduce over the 16 threads of a half-warp with shuffles.  The score tile
// goes back to shared memory (transposed, in the k tile's space) for p * v,
// where each thread owns the same 4 rows and hd / 16 output columns.  Tiles
// wholly above the diagonal or wholly outside the window are skipped: they
// would add exactly nothing.  wgmma, TMA and a pipelined k/v ring are later
// work.
//
// Rounding: the dot products are explicit FMAs (their order differs from
// any matmul's anyway); the softmax bookkeeping and the scale use the _rn
// intrinsics, which nvcc does not contract, and expf (not __expf); the final
// acc / l is a correctly rounded division.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bhsd.so flash_attention_bhsd.cu
// Entry point: flash_attention_bhsd_launch (plain C, loaded with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // q rows per CTA
constexpr int kBK = 64;        // k columns per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kLD = kBQ + 4;   // transposed tiles' row stride: keeps float4
                               // alignment and spreads the stores
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float v, float *o) { *o = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16 *o) {
    *o = __float2bfloat16_rn(v);
}

template <int HD>
constexpr int smem_bytes() {
    // q^T [HD][kLD], k^T [HD][kLD] (later p^T [kBK][kLD]), v [kBK][HD]
    return (2 * HD * kLD + kBK * HD) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T *__restrict__ q, const T *__restrict__ k,
                       const T *__restrict__ v, T *__restrict__ out, int s_len,
                       int t_len, int causal, int has_window, int window,
                       float scale) {
    constexpr int NG = HD / 64;  // 64-wide column groups of the output
    extern __shared__ float4 smem4[];
    float *qT = reinterpret_cast<float *>(smem4);  // [HD][kLD]
    float *kT = qT + HD * kLD;                     // [HD][kLD]
    float *pT = kT;                                // [kBK][kLD], reuses kT
    float *vs = kT + HD * kLD;                     // [kBK][HD]

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    const int q0 = blockIdx.x * kBQ;
    const long long head = blockIdx.y;
    const T *qb = q + head * s_len * HD;
    const T *kb = k + head * t_len * HD;
    const T *vb = v + head * t_len * HD;

    for (int e = tid; e < kBQ * HD; e += kThreads) {
        const int r = e / HD, d = e % HD;
        qT[d * kLD + r] =
            q0 + r < s_len ? widen(qb[(long long)(q0 + r) * HD + d]) : 0.0f;
    }

    float m[4], l[4], acc[4][4 * NG];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = kNegInf;
        l[i] = 0.0f;
#pragma unroll
        for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.0f;
    }

    // the columns any row of this tile can see
    int c_hi = t_len;
    if (causal) c_hi = min(c_hi, q0 + kBQ);
    int c_lo = 0;
    if (has_window) c_lo = max(0, q0 - window + 1);
    c_lo = c_lo / kBK * kBK;

    for (int k0 = c_lo; k0 < c_hi; k0 += kBK) {
        __syncthreads();  // the last step's readers of p^T and v are done
        for (int e = tid; e < kBK * HD; e += kThreads) {
            const int j = e / HD, d = e % HD;
            const bool in = k0 + j < t_len;
            const long long at = (long long)(k0 + j) * HD + d;
            kT[d * kLD + j] = in ? widen(kb[at]) : 0.0f;
            vs[j * HD + d] = in ? widen(vb[at]) : 0.0f;
        }
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            const float4 a = *reinterpret_cast<const float4 *>(
                &qT[d * kLD + ty * 4]);
            const float4 b = *reinterpret_cast<const float4 *>(
                &kT[d * kLD + tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = q0 + ty * 4 + i;
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = k0 + tx * 4 + j;
                bool live = col < t_len;
                if (causal) live = live && col <= row;
                if (has_window) live = live && col > row - window;
                sc[i][j] = live ? __fmul_rn(sc[i][j], scale) : kNegInf;
                mx = fmaxf(mx, sc[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_cur = fmaxf(m[i], mx);
            // a row that has seen no live column: exp(NEG_INF - NEG_INF)
            // would be 1, so it adds nothing and keeps its state
            const bool alive = m_cur > kNegInf * 0.5f;
            const float corr = alive ? expf(__fsub_rn(m[i], m_cur)) : 1.0f;
            float rs = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                sc[i][j] = alive ? expf(__fsub_rn(sc[i][j], m_cur)) : 0.0f;
                rs = __fadd_rn(rs, sc[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
            l[i] = __fadd_rn(__fmul_rn(l[i], corr), rs);
            m[i] = m_cur;
#pragma unroll
            for (int c = 0; c < 4 * NG; ++c)
                acc[i][c] = __fmul_rn(acc[i][c], corr);
        }

        __syncthreads();  // every thread is done reading k^T
#pragma unroll
        for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float4 *>(&pT[(tx * 4 + j) * kLD + ty * 4]) =
                make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
        __syncthreads();

#pragma unroll 4
        for (int j = 0; j < kBK; ++j) {
            const float4 p = *reinterpret_cast<const float4 *>(
                &pT[j * kLD + ty * 4]);
            const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int g = 0; g < NG; ++g) {
                const float4 w = *reinterpret_cast<const float4 *>(
                    &vs[j * HD + g * 64 + tx * 4]);
                const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        acc[i][g * 4 + c] =
                            fmaf(pv[i], wv[c], acc[i][g * 4 + c]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        if (row >= s_len) continue;
        const float safe = l[i] > 0.0f ? l[i] : 1.0f;
        T *o = out + (head * s_len + row) * HD;
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                narrow(__fdiv_rn(acc[i][g * 4 + c], safe),
                       &o[g * 64 + tx * 4 + c]);
    }
}

template <typename T, int HD>
int launch(const void *q, const void *k, const void *v, void *out, int bh,
           int s_len, int t_len, int causal, int has_window, int window,
           float scale, cudaStream_t stream) {
    auto kern = flash_attention_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<HD>());
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((s_len + kBQ - 1) / kBQ, bh);
    kern<<<grid, kThreads, smem_bytes<HD>(), stream>>>(
        static_cast<const T *>(q), static_cast<const T *>(k),
        static_cast<const T *>(v), static_cast<T *>(out), s_len, t_len, causal,
        has_window, window, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16.  q (bh, s_len, hd), k and v
// (bh, t_len, hd), out like q, all contiguous; hd is 64 or 128.  The caller
// checks shapes, dtypes, contiguity and 1 <= bh <= 65535.  Returns the CUDA
// error of the launch (0 = launched).
extern "C" int flash_attention_bhsd_launch(
    int dtype_code, const void *q, const void *k, const void *v, void *out,
    int bh, int s_len, int t_len, int hd, int causal, int has_window,
    int window, float scale, void *stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype_code == 0 && hd == 64)
        return launch<float, 64>(q, k, v, out, bh, s_len, t_len, causal,
                                 has_window, window, scale, s);
    if (dtype_code == 0 && hd == 128)
        return launch<float, 128>(q, k, v, out, bh, s_len, t_len, causal,
                                  has_window, window, scale, s);
    if (dtype_code == 1 && hd == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, out, bh, s_len, t_len,
                                         causal, has_window, window, scale, s);
    if (dtype_code == 1 && hd == 128)
        return launch<__nv_bfloat16, 128>(q, k, v, out, bh, s_len, t_len,
                                          causal, has_window, window, scale,
                                          s);
    return (int)cudaErrorInvalidValue;
}
