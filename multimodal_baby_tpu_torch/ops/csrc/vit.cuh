// Device code shared by the port's ViT kernels (sm_90a): K5 and K6
// (vit.cu) and K7 (vit_block.cu). Every routine is
// the one place its arithmetic is written, so that K7, which runs K5's and
// K6's phases in one launch, computes the same bits as the two of them.
//
// - a LayerNorm row (one warp): statistics in f32 with var = E[x^2] -
//   mean^2, the result rounded to bf16, as the TPU kernels;
// - GEMM epilogues for gemm.cuh: qkv (product rounded, then the bf16 bias
//   added and the sum rounded again), the residual sum (rounded once),
//   and bias + GELU (erf, tanh or sigmoid, the sum kept in f32);
// - attention for one warp and 16 query rows of one head (a "slab"),
//   against K and V of all N keys in shared memory, scores recomputed per
//   pass on the tensor cores (wmma 16x16x16, bf16 in, f32 sums):
//     slab_max + slab_defer: K5's deferred softmax, p = exp(s - max) in
//       f32, z summed from the unrounded p, p rounded to bf16 before the
//       value contraction, the output scaled by 1 / z (K8a-c run the
//       register-resident core of attn_mma.cuh instead).
//   Key columns >= kv_valid get p = 0 (the TPU kernels add -1e9, whose exp
//   is exactly 0).
// Every load of data another block may have written in the same launch
// goes through L2 (__ldcg, cp.async.cg), as K7's grid barrier needs.

#pragma once

#include <math.h>

#include "gemm.cuh"

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 bf16 through L2
__device__ __forceinline__ uint4 ldcg8(const __nv_bfloat16* p) {
  return __ldcg(reinterpret_cast<const uint4*>(p));
}

// one warp: orow = bf16(((x - mean) * rsqrt(var + eps)) * g + b); C % 8 == 0
__device__ __forceinline__ void layer_norm_row(
    const __nv_bfloat16* __restrict__ xr, const __nv_bfloat16* __restrict__ g,
    const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ orow,
    int C, float eps) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f, s2 = 0.0f;
  for (int c = lane * 8; c < C; c += 256) {
    float f[8];
    unpack8(ldcg8(xr + c), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s += f[e];
      s2 += f[e] * f[e];
    }
  }
  const float mean = warp_sum(s) / C;
  const float var = warp_sum(s2) / C - mean * mean;
  const float rstd = rsqrtf(var + eps);
  for (int c = lane * 8; c < C; c += 256) {
    float f[8], gf[8], bf[8];
    unpack8(ldcg8(xr + c), f);
    unpack8(*reinterpret_cast<const uint4*>(g + c), gf);
    unpack8(*reinterpret_cast<const uint4*>(b + c), bf);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = ((f[e] - mean) * rstd) * gf[e] + bf[e];
    *reinterpret_cast<uint4*>(orow + c) = pack8(f);
  }
}

// ------------------------------------------------------ GEMM epilogues

// qkv: out = bf16(bf16(acc) + bias), two roundings as nn.Dense in bf16
struct RoundThenBias {
  const __nv_bfloat16* bias;  // [N] bf16
  __nv_bfloat16* out;         // [M, N]
  int N;

  __device__ void operator()(int m, int n, float (&v)[8]) const {
    float bf[8];
    unpack8(*reinterpret_cast<const uint4*>(bias + n), bf);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __bfloat162float(__float2bfloat16(v[e])) + bf[e];
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * N + n) =
        pack8(v);
  }
};

// proj and fc2: out = bf16((residual + acc) + bias), one rounding
struct ResidualBias {
  const __nv_bfloat16* residual;  // [M, N]
  const __nv_bfloat16* bias;      // [N] bf16
  __nv_bfloat16* out;             // [M, N]
  int N;

  __device__ void operator()(int m, int n, float (&v)[8]) const {
    const size_t off = static_cast<size_t>(m) * N + n;
    float rf[8], bf[8];
    unpack8(ldcg8(residual + off), rf);
    unpack8(*reinterpret_cast<const uint4*>(bias + n), bf);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (rf[e] + v[e]) + bf[e];
    *reinterpret_cast<uint4*>(out + off) = pack8(v);
  }
};

// the MLP activation, in the order of ops/vit_common.py's GELU_MODES
enum GeluMode { GELU_ERF = 0, GELU_TANH = 1, GELU_SIGMOID = 2 };

__device__ __forceinline__ float gelu(float h, int mode) {
  if (mode == GELU_TANH)
    return 0.5f * h *
           (1.0f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  if (mode == GELU_SIGMOID) return h / (1.0f + expf(-1.702f * h));
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
}

// fc1: out = bf16(gelu(acc + bias)), the sum kept in f32
struct BiasGelu {
  const __nv_bfloat16* bias;  // [N] bf16
  __nv_bfloat16* out;         // [M, N]
  int N;
  int mode;  // GeluMode

  __device__ void operator()(int m, int n, float (&v)[8]) const {
    float bf[8];
    unpack8(*reinterpret_cast<const uint4*>(bias + n), bf);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = gelu(v[e] + bf[e], mode);
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * N + n) =
        pack8(v);
  }
};

__host__ __device__ inline GemmArgs dense(const void* a, const void* w, int M,
                                          int K, int N) {
  GemmArgs g{};
  g.a1 = static_cast<const __nv_bfloat16*>(a);
  g.b1 = static_cast<const __nv_bfloat16*>(w);
  g.k1 = K;
  g.M = M;
  g.N = N;
  return g;
}

// ---------------------------------------------------------------- attention

constexpr int HD = 64;         // head dim
constexpr int KV_LD = HD + 8;  // bf16 pitch of K, V and Q rows in shared
                               // memory (the skew keeps wmma off one bank)
constexpr int AT_BQ = 64;      // query rows per block of K5
constexpr int AT_THREADS = 128;

using QFrag = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16,
                                     __nv_bfloat16, nvcuda::wmma::row_major>;
using AccFrag =
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// K5: K and V of N keys (rows padded to np, a multiple of 16),
// the tile's 64 query rows, and per warp a 16 x 16 f32 s tile and bf16 p
// tile; the 227 KB a block may use caps N at 752
inline size_t attention_smem(int np) {
  return (2 * static_cast<size_t>(np) + AT_BQ) * KV_LD * 2  // K, V, Q
         + AT_THREADS / 32 * 16 * 16 * (4 + 2);             // s, p tiles
}

// rows [0, rows) of one head's 64 columns at src (row pitch rs elements)
// into dst (pitch KV_LD), rows >= valid zero-filled; threads tid of
// nthreads share the copies (cp.async through L2, not committed)
__device__ __forceinline__ void load_head_rows(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               size_t rs, int valid, int rows,
                                               int tid, int nthreads) {
  for (int v = tid; v < rows * 8; v += nthreads) {
    const int row = v >> 3;
    const int col = (v & 7) * 8;
    const bool ok = row < valid;
    cp_async16(dst + row * KV_LD + col, (ok ? src + row * rs : src) + col,
               ok);
  }
}

// the warp's 16 query rows (pitch KV_LD) as A fragments
__device__ __forceinline__ void load_q(QFrag (&qf)[HD / 16],
                                       const __nv_bfloat16* q) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    nvcuda::wmma::load_matrix_sync(qf[kk], q + kk * 16, KV_LD);
}

// st = (Q . K_j^T) for the warp's rows and keys 16j .. 16j + 15; a lane then
// owns 8 columns of one row (row lane / 2, columns (lane & 1) * 8 ..)
__device__ __forceinline__ void slab_scores(const QFrag (&qf)[HD / 16],
                                            const __nv_bfloat16* Ks, int j,
                                            float* st) {
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    // K^T as a column-major 16x16 tile: (d, key) at Ks[key][d]
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::col_major>
        kf;
    wmma::load_matrix_sync(kf, Ks + j * 16 * KV_LD + kk * 16, KV_LD);
    wmma::mma_sync(acc, qf[kk], kf, acc);
  }
  wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
  __syncwarp();
}

// o += P_j . V_j for the bf16 16 x 16 tile P_j in pt
__device__ __forceinline__ void slab_pv(const __nv_bfloat16* pt,
                                        const __nv_bfloat16* Vs, int j,
                                        AccFrag (&o)[HD / 16]) {
  using namespace nvcuda;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      pf;
  wmma::load_matrix_sync(pf, pt, 16);
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major>
        vf;
    wmma::load_matrix_sync(vf, Vs + j * 16 * KV_LD + jj * 16, KV_LD);
    wmma::mma_sync(o[jj], pf, vf, o[jj]);
  }
}

// K5 pass 1: the row max of s * scale over the valid keys (both lanes of
// the row hold it)
__device__ __forceinline__ float slab_max(const QFrag (&qf)[HD / 16],
                                          const __nv_bfloat16* Ks, int np,
                                          int kv_valid, float scale,
                                          float* st) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1;
  const int c8 = (lane & 1) * 8;
  float m = -INFINITY;
  for (int j = 0; j < np / 16; ++j) {
    slab_scores(qf, Ks, j, st);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (j * 16 + c8 + e < kv_valid) m = fmaxf(m, st[r * 16 + c8 + e] * scale);
    __syncwarp();
  }
  return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
}

// K5 pass 2: o = bf16(exp(s - m)) . V; returns z, the sum of the unrounded
// p of the row
__device__ __forceinline__ float slab_defer(const QFrag (&qf)[HD / 16],
                                            const __nv_bfloat16* Ks,
                                            const __nv_bfloat16* Vs, int np,
                                            int kv_valid, float scale,
                                            float m, float* st,
                                            __nv_bfloat16* pt,
                                            AccFrag (&o)[HD / 16]) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1;
  const int c8 = (lane & 1) * 8;
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) nvcuda::wmma::fill_fragment(o[jj], 0.0f);
  float z = 0.0f;
  for (int j = 0; j < np / 16; ++j) {
    slab_scores(qf, Ks, j, st);
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      p[e] = j * 16 + c8 + e < kv_valid
                 ? expf(st[r * 16 + c8 + e] * scale - m)
                 : 0.0f;
      z += p[e];
    }
    *reinterpret_cast<uint4*>(pt + r * 16 + c8) = pack8(p);
    __syncwarp();
    slab_pv(pt, Vs, j, o);
    __syncwarp();  // the next tile overwrites st and pt
  }
  return z + __shfl_xor_sync(0xffffffffu, z, 1);
}

// rows [0, valid) of the warp's 16: out[row * rs + c] = bf16(o * mul), each
// 16 x 16 tile through the warp's s tile
__device__ __forceinline__ void slab_store(AccFrag (&o)[HD / 16], float mul,
                                           float* st, __nv_bfloat16* out,
                                           size_t rs, int valid) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1;
  const int c8 = (lane & 1) * 8;
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) {
    nvcuda::wmma::store_matrix_sync(st, o[jj], 16,
                                    nvcuda::wmma::mem_row_major);
    __syncwarp();
    if (r < valid) {
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = st[r * 16 + c8 + e] * mul;
      *reinterpret_cast<uint4*>(out + r * rs + jj * 16 + c8) = pack8(f);
    }
    __syncwarp();
  }
}

}  // namespace
