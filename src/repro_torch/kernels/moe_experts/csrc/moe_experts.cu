// Dropless grouped SwiGLU experts for a chip's share of a MoE layer,
// written by hand for Hopper (sm_90a).  No TPU kernel of the JAX package
// corresponds: the JAX package dispatches into capacity buffers.
//
// The layer's inputs, with the worker axis W in front (the replay's vmap
// folds its workers there):
//   x (W, T, D) f32, ids (W, T, K) int64 global expert ids, gates (W, T, K)
//   f32, and the held experts e0 .. e0 + n - 1 of every worker:
//   w_gate / w_up (W, n, D, F), w_down (W, n, F, D), f32.
// A pick (w, t, k) is held when e0 <= ids[w, t, k] < e0 + n; its group is
// g = w * n + (id - e0).  For every token
//   out[w, t] = sum over held k of gates[w, t, k] *
//               (silu(x[w, t] Wg[g]) * (x[w, t] Wu[g])) Wd[g].
//
// What bounds it: nothing stays on the card but the real rows.  A held
// pick is a row of a packed buffer sized for the worst case, W * T *
// min(K, n) rows, in group order; the products run over the real rows
// only, so the work is the held picks' (about W * T * K * n / E rows), not
// n * T rows a worker as a dense product over every token would be.  No
// host synchronisation: the group offsets stay on the card and every
// product kernel finds its group and rows there.
//
// Launches (op codes of moe_experts_launch):
//   0 route:  one block.  Each warp takes a worker and walks its picks in
//             (t, k) order, 32 at a time: __match_any_sync groups a step's
//             lanes by expert, the leader bumps the expert's cursor in
//             shared memory, so a pick's rank in its group is the number
//             of earlier picks of that group (stable, deterministic).
//             Then the exclusive prefix of the W * n counts (meta[w, 0:n]
//             the group's first row, meta[w, n:2n] its count) and each
//             held pick's packed row: row[w, t, k] (-1 where not held) and
//             pick[row] = (w * T + t) * K + k.
//   1 up:     hg = X Wg, hu = X Wu over every group's rows in one launch
//             (a 64-row tile of one group a block, both products on the
//             same rows of X, gathered through pick).
//   2 down:   y = (silu(hg) * hu) Wd, the activation made as it is loaded.
//   3 combine: out[w, t] = sum over k (in order) of gate * y[row]; one
//             block a token: a gather, not an atomic scatter, so the sum
//             is deterministic.  With gates null (op 9): dx.
//   4 dy:     dgates[w, t, k] = <dout[w, t], y[row]> (0 where not held)
//             and dy[row] = gate * dout[w, t].
//   5 da:     da = dy Wd^T, with dhg = da * hu * silu'(hg) and dhu = da *
//             silu(hg) in the epilogue.
//   6 dwd:    dWd[g] = (silu(hg) * hu)^T dy over the group's rows.
//   7 dwgu:   dWg[g] = X^T dhg and dWu[g] = X^T dhu in one launch.
//   8 dxp:    dxp = dhg Wg^T + dhu Wu^T (one product over 2F).
//   9 combine of dxp into dx (no gate: dy carries it).
// A product kernel is launched over the worst case's tiles; a block past
// the real tiles returns at once.  The products are FFMA on the CUDA
// cores, in f32: a 64 x 64 tile a block, 16-deep slices of the reduction
// through shared memory, 4 x 4 outputs a thread; the reduction of each
// output runs in order of its index.  Groups whose rows are empty write
// zero weight gradients.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmoe_experts.so moe_experts.cu
// Entry point: moe_experts_launch (plain C, loaded with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, NT = 256, TM = 4, TN = 4;
constexpr int PAD = 4;

enum Op {
  ROUTE = 0, UP = 1, DOWN = 2, COMBINE = 3, DY = 4, DA = 5, DWD = 6,
  DWGU = 7, DXP = 8, COMBINE_DX = 9
};

}  // namespace

// Mirrored field for field by the ctypes structure in ../kernel.py.
struct MoeArgs {
  const int64_t* ids;
  const float* x;
  const float* gates;
  const float* wg;
  const float* wu;
  const float* wd;
  long long w_stride_gu, e_stride_gu, w_stride_d, e_stride_d;
  int* meta;
  int* row;
  int* pick;
  float* hg;
  float* hu;
  float* y;
  float* out;
  const float* dout;
  float* dgates;
  float* dy;
  float* dhg;
  float* dhu;
  float* dxp;
  float* dx;
  float* dwg;
  float* dwu;
  float* dwd;
  long long W, T, K, D, F, n, e0;
};

namespace {

__device__ __forceinline__ float sigmoid_f(float h) {
  return 1.0f / (1.0f + expf(-h));
}

__device__ __forceinline__ float act_f(float hg, float hu) {
  return hg * sigmoid_f(hg) * hu;
}

// ------------------------------------------------------------------ route

constexpr int ROUTE_UNROLL = 8;

__global__ void __launch_bounds__(1024) route_kernel(MoeArgs a) {
  extern __shared__ int cursor[];  // [warps][n]
  const int n = (int)a.n;
  const long long TK = a.T * a.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  int* cur = cursor + warp * n;
  for (long long w = warp; w < a.W; w += warps) {
    for (int j = lane; j < n; j += 32) cur[j] = 0;
    __syncwarp();
    const int64_t* wid = a.ids + w * TK;
    int* wrow = a.row + w * TK;
    for (long long base = 0; base < TK; base += 32 * ROUTE_UNROLL) {
      int key[ROUTE_UNROLL];
#pragma unroll
      for (int u = 0; u < ROUTE_UNROLL; ++u) {
        const long long p = base + u * 32 + lane;
        key[u] = -1;
        if (p < TK) {
          const long long j = wid[p] - a.e0;
          if (j >= 0 && j < n) key[u] = (int)j;
        }
      }
#pragma unroll
      for (int u = 0; u < ROUTE_UNROLL; ++u) {
        const long long p = base + u * 32 + lane;
        const unsigned peers = __match_any_sync(0xffffffffu, key[u]);
        const int leader = __ffs(peers) - 1;
        const int below = __popc(peers & ((1u << lane) - 1u));
        int first = 0;
        if (key[u] >= 0 && lane == leader) {
          first = cur[key[u]];
          cur[key[u]] = first + __popc(peers);
        }
        first = __shfl_sync(0xffffffffu, first, leader);
        __syncwarp();
        if (p < TK) wrow[p] = key[u] >= 0 ? first + below : -1;
      }
    }
    for (int j = lane; j < n; j += 32) a.meta[w * 2 * n + n + j] = cur[j];
    __syncwarp();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (long long w = 0; w < a.W; ++w)
      for (int j = 0; j < n; ++j) {
        a.meta[w * 2 * n + j] = s;
        s += a.meta[w * 2 * n + n + j];
      }
  }
  __syncthreads();
  const long long picks = a.W * TK;
  for (long long p = threadIdx.x; p < picks; p += blockDim.x) {
    const int r = a.row[p];
    if (r < 0) continue;
    const long long w = p / TK;
    const long long j = a.ids[p] - a.e0;
    const int at = a.meta[w * 2 * n + j] + r;
    a.row[p] = at;
    a.pick[at] = (int)p;
  }
}

// ------------------------------------------------------- the product core

__device__ __forceinline__ void mma(float (*As)[BM + PAD],
                                    float (*Bs)[BN + PAD],
                                    float acc[TM][TN], int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
    const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
    const float ar[TM] = {av.x, av.y, av.z, av.w};
    const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

__device__ __forceinline__ int group_first(const MoeArgs& a, long long g) {
  return a.meta[(g / a.n) * 2 * a.n + g % a.n];
}

__device__ __forceinline__ int group_count(const MoeArgs& a, long long g) {
  return a.meta[(g / a.n) * 2 * a.n + a.n + g % a.n];
}

// Products whose rows are a group's packed rows (ops UP, DOWN, DA, DXP):
// blockIdx.y is the tile's index in the list of every group's 64-row
// tiles, blockIdx.x the column tile.
template <int OP>
__global__ void __launch_bounds__(NT) rows_kernel(MoeArgs a) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  __shared__ __align__(16) float Bs2[BK][BN + PAD];
  __shared__ int sg, sfirst, srows;
  const int tid = threadIdx.x;
  if (tid == 0) {
    const long long G = a.W * a.n;
    long long tiles = 0;
    sg = -1;
    for (long long g = 0; g < G; ++g) {
      const int c = group_count(a, g);
      const long long t = (c + BM - 1) / BM;
      if (blockIdx.y < tiles + t) {
        const long long first = group_first(a, g) + (blockIdx.y - tiles) * BM;
        sg = (int)g;
        sfirst = (int)first;
        srows = (int)min((long long)BM, group_first(a, g) + c - first);
        break;
      }
      tiles += t;
    }
  }
  __syncthreads();
  if (sg < 0) return;
  const long long g = sg, w = g / a.n, e = g % a.n;
  const long long r0 = sfirst;
  const int rows = srows;
  const long long D = a.D, F = a.F, K = a.K;
  // the reduction's length and the output's width
  constexpr bool DUAL = OP == UP;
  const long long KD = OP == UP ? D : OP == DOWN ? F : OP == DA ? D : 2 * F;
  const long long N = (OP == UP || OP == DA) ? F : D;
  const float* wg = a.wg + w * a.w_stride_gu + e * a.e_stride_gu;
  const float* wu = a.wu + w * a.w_stride_gu + e * a.e_stride_gu;
  const float* wd = a.wd + w * a.w_stride_d + e * a.e_stride_d;
  const long long n0 = (long long)blockIdx.x * BN;
  const int tx = tid % 16, ty = tid / 16;
  float acc[TM][TN] = {};
  float acc2[TM][TN] = {};
  for (long long k0 = 0; k0 < KD; k0 += BK) {
    // A: rows x reduction, contiguous along the reduction
#pragma unroll
    for (int q = 0; q < BM * BK / NT; ++q) {
      const int idx = tid + q * NT;
      const int i = idx / BK, kk = idx % BK;
      const long long k = k0 + kk;
      float v = 0.0f;
      if (i < rows && k < KD) {
        const long long r = r0 + i;
        if (OP == UP) {
          v = a.x[(long long)(a.pick[r] / K) * D + k];
        } else if (OP == DOWN) {
          v = act_f(a.hg[r * F + k], a.hu[r * F + k]);
        } else if (OP == DA) {
          v = a.dy[r * D + k];
        } else {  // DXP
          v = k < F ? a.dhg[r * F + k] : a.dhu[r * F + k - F];
        }
      }
      As[kk][i] = v;
    }
    // B: reduction x columns
#pragma unroll
    for (int q = 0; q < BK * BN / NT; ++q) {
      const int idx = tid + q * NT;
      if (OP == UP || OP == DOWN) {  // weights contiguous along the columns
        const int j = idx % BN, kk = idx / BN;
        const long long k = k0 + kk, c = n0 + j;
        const bool in = k < KD && c < N;
        if (OP == UP) {
          Bs[kk][j] = in ? wg[k * F + c] : 0.0f;
          Bs2[kk][j] = in ? wu[k * F + c] : 0.0f;
        } else {
          Bs[kk][j] = in ? wd[k * D + c] : 0.0f;
        }
      } else {  // transposed weights: contiguous along the reduction
        const int kk = idx % BK, j = idx / BK;
        const long long k = k0 + kk, c = n0 + j;
        float v = 0.0f;
        if (k < KD && c < N) {
          if (OP == DA) v = wd[c * D + k];
          else v = k < F ? wg[c * F + k] : wu[c * F + k - F];
        }
        Bs[kk][j] = v;
      }
    }
    __syncthreads();
    mma(As, Bs, acc, ty, tx);
    if (DUAL) mma(As, Bs2, acc2, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int li = ty * TM + i;
    if (li >= rows) continue;
    const long long r = r0 + li;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long c = n0 + tx * TN + j;
      if (c >= N) continue;
      if (OP == UP) {
        a.hg[r * F + c] = acc[i][j];
        a.hu[r * F + c] = acc2[i][j];
      } else if (OP == DOWN) {
        a.y[r * D + c] = acc[i][j];
      } else if (OP == DA) {
        const float hg = a.hg[r * F + c], hu = a.hu[r * F + c];
        const float s = sigmoid_f(hg);
        a.dhg[r * F + c] = acc[i][j] * hu * (s * (1.0f + hg * (1.0f - s)));
        a.dhu[r * F + c] = acc[i][j] * (hg * s);
      } else {
        a.dxp[r * D + c] = acc[i][j];
      }
    }
  }
}

// Weight gradients (ops DWD, DWGU): the reduction runs over a group's
// rows; blockIdx.z is the group, (y, x) the output tile.
template <int OP>
__global__ void __launch_bounds__(NT) weights_kernel(MoeArgs a) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  __shared__ __align__(16) float Bs2[BK][BN + PAD];
  const int tid = threadIdx.x;
  const long long g = blockIdx.z;
  const long long D = a.D, F = a.F, K = a.K;
  const long long r0 = group_first(a, g);
  const long long rows = group_count(a, g);
  constexpr bool DUAL = OP == DWGU;
  const long long M = OP == DWD ? F : D;
  const long long N = OP == DWD ? D : F;
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  const int tx = tid % 16, ty = tid / 16;
  float acc[TM][TN] = {};
  float acc2[TM][TN] = {};
  for (long long k0 = 0; k0 < rows; k0 += BK) {
    // A (output rows x packed rows), contiguous along the output rows
#pragma unroll
    for (int q = 0; q < BM * BK / NT; ++q) {
      const int idx = tid + q * NT;
      const int i = idx % BM, kk = idx / BM;
      const long long m = m0 + i, k = k0 + kk;
      float v = 0.0f;
      if (m < M && k < rows) {
        const long long r = r0 + k;
        if (OP == DWD) v = act_f(a.hg[r * F + m], a.hu[r * F + m]);
        else v = a.x[(long long)(a.pick[r] / K) * D + m];
      }
      As[kk][i] = v;
    }
    // B (packed rows x columns), contiguous along the columns
#pragma unroll
    for (int q = 0; q < BK * BN / NT; ++q) {
      const int idx = tid + q * NT;
      const int j = idx % BN, kk = idx / BN;
      const long long c = n0 + j, k = k0 + kk;
      const bool in = c < N && k < rows;
      const long long r = r0 + k;
      if (OP == DWD) {
        Bs[kk][j] = in ? a.dy[r * D + c] : 0.0f;
      } else {
        Bs[kk][j] = in ? a.dhg[r * F + c] : 0.0f;
        Bs2[kk][j] = in ? a.dhu[r * F + c] : 0.0f;
      }
    }
    __syncthreads();
    mma(As, Bs, acc, ty, tx);
    if (DUAL) mma(As, Bs2, acc2, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long c = n0 + tx * TN + j;
      if (c >= N) continue;
      const long long at = g * M * N + m * N + c;
      if (OP == DWD) {
        a.dwd[at] = acc[i][j];
      } else {
        a.dwg[at] = acc[i][j];
        a.dwu[at] = acc2[i][j];
      }
    }
  }
}

// ------------------------------------------------------ per-token passes

constexpr int MAX_K = 32;

// out[tok] = sum over k of gate * src[row] (ops COMBINE, COMBINE_DX)
__global__ void __launch_bounds__(NT) combine_kernel(MoeArgs a, bool dx) {
  __shared__ int srow[MAX_K];
  __shared__ float sgate[MAX_K];
  const long long tok = blockIdx.x, K = a.K, D = a.D;
  if (threadIdx.x < K) {
    srow[threadIdx.x] = a.row[tok * K + threadIdx.x];
    sgate[threadIdx.x] = dx ? 1.0f : a.gates[tok * K + threadIdx.x];
  }
  __syncthreads();
  const float* src = dx ? a.dxp : a.y;
  float* dst = dx ? a.dx : a.out;
  for (long long d = threadIdx.x; d < D; d += NT) {
    float s = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int r = srow[k];
      if (r >= 0) s = fmaf(sgate[k], src[(long long)r * D + d], s);
    }
    dst[tok * D + d] = s;
  }
}

// dgates[tok, k] = <dout[tok], y[row]>, dy[row] = gate * dout[tok] (op DY)
__global__ void __launch_bounds__(NT) dy_kernel(MoeArgs a) {
  __shared__ float part[NT / 32];
  const long long tok = blockIdx.x, K = a.K, D = a.D;
  const float* g = a.dout + tok * D;
  for (int k = 0; k < K; ++k) {
    const int r = a.row[tok * K + k];
    if (r < 0) {
      if (threadIdx.x == 0) a.dgates[tok * K + k] = 0.0f;
      continue;
    }
    const float gate = a.gates[tok * K + k];
    const float* yr = a.y + (long long)r * D;
    float* dyr = a.dy + (long long)r * D;
    float s = 0.0f;
    for (long long d = threadIdx.x; d < D; d += NT) {
      const float gd = g[d];
      s = fmaf(gd, yr[d], s);
      dyr[d] = gate * gd;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.0f;
      for (int i = 0; i < NT / 32; ++i) t += part[i];
      a.dgates[tok * K + k] = t;
    }
    __syncthreads();
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" int moe_experts_launch(int op, const MoeArgs* args, void* stream) {
  const MoeArgs a = *args;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long G = a.W * a.n;
  const long long tokens = a.W * a.T;
  const long long rows_max = a.W * a.T * (a.K < a.n ? a.K : a.n);
  // every group's tiles fit in this many: sum ceil(c / BM) <= R / BM + G
  const long long row_tiles = cdiv(rows_max, BM) + G;
  if (a.K > MAX_K || a.n > 256 || a.n < 1) return (int)cudaErrorInvalidValue;
  switch (op) {
    case ROUTE: {
      const int threads = 1024;
      route_kernel<<<1, threads, (threads / 32) * a.n * sizeof(int), s>>>(a);
      break;
    }
    case UP:
      rows_kernel<UP><<<dim3(cdiv(a.F, BN), row_tiles), NT, 0, s>>>(a);
      break;
    case DOWN:
      rows_kernel<DOWN><<<dim3(cdiv(a.D, BN), row_tiles), NT, 0, s>>>(a);
      break;
    case DA:
      rows_kernel<DA><<<dim3(cdiv(a.F, BN), row_tiles), NT, 0, s>>>(a);
      break;
    case DXP:
      rows_kernel<DXP><<<dim3(cdiv(a.D, BN), row_tiles), NT, 0, s>>>(a);
      break;
    case COMBINE:
    case COMBINE_DX:
      combine_kernel<<<tokens, NT, 0, s>>>(a, op == COMBINE_DX);
      break;
    case DY:
      dy_kernel<<<tokens, NT, 0, s>>>(a);
      break;
    case DWD:
      weights_kernel<DWD><<<dim3(cdiv(a.D, BN), cdiv(a.F, BM), G), NT, 0,
                            s>>>(a);
      break;
    case DWGU:
      weights_kernel<DWGU><<<dim3(cdiv(a.F, BN), cdiv(a.D, BM), G), NT, 0,
                             s>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
