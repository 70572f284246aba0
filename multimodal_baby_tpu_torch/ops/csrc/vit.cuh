// Device code shared by the port's ViT kernels (sm_90a): K5
// (vit_attention.cu), K6 (vit.cu) and K7 (vit_block.cu). Every routine is
// the one place its arithmetic is written, so that K7, which runs K5's and
// K6's phases in one launch, computes the same bits as the two of them.
//
// - a LayerNorm row (one warp): statistics in f32 with var = E[x^2] -
//   mean^2, the result rounded to bf16, as the TPU kernels; and its
//   launch, one warp a row (K5, K6);
// - GEMM epilogues for vit_gemm.cuh's tile (K5, K7) and vit_pingpong.cuh's
//   (K6): qkv (product rounded, then the bf16 bias added and the sum
//   rounded again), the residual sum (rounded once), and bias + GELU (erf,
//   tanh or sigmoid, the sum kept in f32).
// The attention is attn_mma.cuh's register-resident core in its deferred
// mode. Every load of data another block may have written in the same
// launch goes through L2 (__ldcg, cp.async.cg), as K7's grid barrier needs.

#pragma once

#include <math.h>

#include "common.cuh"  // pack8, unpack8

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

// ---------------------------------------------------------------- LayerNorm

// one warp per token row, ROWS rows a block
template <int ROWS = 8>
__global__ void __launch_bounds__(ROWS * 32)
    layer_norm_bf16(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ g,
                    const __nv_bfloat16* __restrict__ b,
                    __nv_bfloat16* __restrict__ out, int M, int C,
                    float eps) {
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= M) return;
  layer_norm_row(x + static_cast<size_t>(row) * C, g, b,
                 out + static_cast<size_t>(row) * C, C, eps);
}

inline cudaError_t launch_layer_norm(const void* x, const void* g,
                                     const void* b, void* out, int M, int C,
                                     float eps, cudaStream_t s) {
  constexpr int ROWS = 8;
  layer_norm_bf16<ROWS><<<(M + ROWS - 1) / ROWS, ROWS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out),
      M, C, eps);
  return cudaGetLastError();
}

}  // namespace
