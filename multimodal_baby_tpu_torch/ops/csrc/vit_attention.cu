// The attention half of a pre-norm ViT block on Hopper (sm_90a), bf16 in
// and out, f32 accumulation (K5):
//
//   out = bf16(x + (attn(qkv(LN1(x))) . Wproj) + bproj)
//
// Replaces the TPU kernel multimodal_baby_tpu/ops/attention.py::
// fused_block_attention (body `_attn_half_f32`), which runs one image per
// program with every intermediate in VMEM. Rounding points follow that
// body:
//   - LayerNorm statistics in f32 with var = E[x^2] - mean^2; xn rounded to
//     bf16; gamma and beta arrive in bf16;
//   - q, k, v = bf16(bf16(xn . Wqkv) + bqkv): the product is rounded, then
//     the bf16 bias is added and the sum rounded again;
//   - scores s = (q . k) * scale in f32; key columns >= kv_valid get no
//     weight (the TPU kernel adds -1e9, whose exp is exactly 0);
//   - deferred softmax: e = exp(s - max) in f32, z = sum(e) from the
//     unrounded e, e rounded to bf16, y = bf16((e . v) * (1 / z));
//   - the residual sums x_f32 + acc_f32 + bias and rounds once.
//
// What bounds it on an H100: at ViT-B/14 and B = 128 (C = 768, N = 257, 12
// heads of 64) one call does 181 GFLOP on 106 MB, ~1,700 FLOPs a byte:
// tensor-core throughput (the card's balance point is ~295 FLOPs a byte).
//
// Four launches, each on the part of the card made for it:
//   1 LayerNorm, one warp per token row (vit.cuh)            x   -> xn
//   2 the qkv Dense on vit_gemm.cuh's wgmma tile,
//     RoundThenBias                                          xn  -> qkv
//   3 the attention on attn_mma.cuh's register-resident core in its
//     deferred mode (P_DEFER), one block per (head, image): K and V loaded
//     once a head, q, k and v read in place as the column slices of the
//     qkv tensor (row stride 3C), the launch geometry from
//     ops/attention.py::attention_geometry                  qkv -> y
//   4 the proj Dense on the same tile, ResidualBias (+ x)    y   -> out
// xn, qkv and y pass through device memory in bf16 (at B = 128: 50, 151
// and 50 MB, most of it in L2 between neighbouring launches).

#include "attn_mma.cuh"
#include "vit_gemm.cuh"

namespace {

// K5's attention: the column slices of qkv [B, N, 3C] in, y [B, N, C] out
AttnIO qkv_slices(const void* qkv, void* y, int N, int C) {
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const long long bs = static_cast<long long>(N) * 3 * C;
  return AttnIO{q, q + C, q + 2 * C, static_cast<__nv_bfloat16*>(y),
                bs, bs, bs, static_cast<long long>(N) * C,
                3 * C, 3 * C, 3 * C, C};
}

}  // namespace

// Shapes and alignment are checked by the Python wrapper
// (multimodal_baby_tpu_torch/ops/attention.py): bf16 everywhere, C % 128 ==
// 0, heads of 64, 1 <= kv_valid <= N <= 752, every pointer 16-byte
// aligned. Weights are [in, out] row-major. xn [B*N, C], qkv [B*N, 3C] and
// y [B*N, C] are scratch; (np, kc, nchunks, rows, threads, smem) the
// attention's launch geometry (attention_geometry). Each returns the first
// CUDA error, or 0.
extern "C" int mmb_vit_attention_bf16(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, void* xn,
    void* qkv, void* y, void* out, int B, int N, int C, int kv_valid,
    float scale, float eps, int np, int kc, int nchunks, int rows,
    int threads, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const auto in = [](const void* p) {
    return static_cast<const __nv_bfloat16*>(p);
  };
  const auto io = [](void* p) { return static_cast<__nv_bfloat16*>(p); };
  cudaError_t err = launch_layer_norm(x, ln_g, ln_b, xn, M, C, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_vit_gemm(xn, wqkv, M, C, 3 * C,
                        RoundThenBias{in(bqkv), io(qkv), 3 * C}, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_attention_mma<P_DEFER>(qkv_slices(qkv, y, N, C), B, C / AM_D,
                                      N, kv_valid, scale,
                                      AttnGeom{np, kc, nchunks, rows},
                                      threads, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_vit_gemm(y, wproj, M, C, C,
                      ResidualBias{in(x), in(bproj), io(out), C}, s));
}

// Two of K5's launches alone, for scripts/probe_vit.py: the Dense on the
// wgmma tile, out = epi(a [M, K] . w [K, N]) with epi 0 RoundThenBias
// (bias), 1 ResidualBias (residual [M, N], bias), 2 BiasGelu (bias, the
// GELU form gelu); and the deferred attention on qkv [B, N, 3C] into y.
extern "C" int mmb_vit_dense_bf16(const void* a, const void* w,
                                  const void* bias, const void* residual,
                                  void* out, int M, int K, int N, int epi,
                                  int gelu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const __nv_bfloat16*>(bias);
  auto* o = static_cast<__nv_bfloat16*>(out);
  switch (epi) {
    case 0: return static_cast<int>(
        launch_vit_gemm(a, w, M, K, N, RoundThenBias{b, o, N}, s));
    case 1: return static_cast<int>(launch_vit_gemm(
        a, w, M, K, N,
        ResidualBias{static_cast<const __nv_bfloat16*>(residual), b, o, N},
        s));
    case 2: {
      const BiasGelu e{b, o, N, gelu};
      if (gelu == GELU_ERF)
        return static_cast<int>(launch_vit_gemm(
            a, w, M, K, N, BiasGeluForm<GELU_ERF>{e}, s));
      if (gelu == GELU_TANH)
        return static_cast<int>(launch_vit_gemm(
            a, w, M, K, N, BiasGeluForm<GELU_TANH>{e}, s));
      return static_cast<int>(launch_vit_gemm(
          a, w, M, K, N, BiasGeluForm<GELU_SIGMOID>{e}, s));
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int mmb_vit_attention_core_bf16(const void* qkv, void* y, int B,
                                           int N, int C, int kv_valid,
                                           float scale, int np, int kc,
                                           int nchunks, int rows, int threads,
                                           int smem, void* stream) {
  return static_cast<int>(launch_attention_mma<P_DEFER>(
      qkv_slices(qkv, y, N, C), B, C / AM_D, N, kv_valid, scale,
      AttnGeom{np, kc, nchunks, rows}, threads, smem,
      static_cast<cudaStream_t>(stream)));
}
