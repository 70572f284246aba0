// The MLP half of a pre-norm ViT block on Hopper (sm_90a), bf16 in and
// out, f32 accumulation (K6):
//
//   out = bf16(x + (gelu(LN2(x) . W1 + b1) . W2) + b2)
//
// Replaces the TPU kernel multimodal_baby_tpu/ops/vit_mlp.py::fused_mlp
// (body `_mlp_half_f32`), which runs one image per program with every
// intermediate in VMEM. Rounding points follow that body:
//   - LayerNorm statistics in f32 with var = E[x^2] - mean^2; xn rounded to
//     bf16; gamma and beta arrive in bf16;
//   - h = xn . W1 + b1 stays f32 into the GELU (erf by default, CUDA erff;
//     the TPU kernel uses a rational erfc because Mosaic has no erf; or
//     the tanh or sigmoid form), rounded once;
//   - the residual sums x_f32 + acc_f32 + bias and rounds once.
//
// What bounds it on an H100: at ViT-B/14 (C = 768, N = 257, F = 3072) K6
// does ~2,800 FLOPs per byte of its input, weights and output, so it is
// bound by tensor-core throughput (the card's balance point is ~295 FLOPs
// per byte). This version is three launches: a LayerNorm (one warp per
// token row, vit.cuh), and two GEMMs on gemm.cuh's wmma tile with fused
// epilogues; xn and the [M, F] hidden pass through device memory in bf16.
// The attention half (K5) is vit_attention.cu; the next step for K6 is
// vit_gemm.cuh's wgmma tile with the hidden kept on chip (PERF.md).

#include "vit.cuh"

// Shapes and alignment are checked by the Python wrapper
// (multimodal_baby_tpu_torch/ops/vit_mlp.py): bf16 everywhere, C % 128 ==
// 0, F % 128 == 0, every pointer 16-byte aligned. Weights are [in, out]
// row-major; xn [M, C] and h [M, F] are scratch; gelu is a GeluMode.
// Returns the first CUDA error, or 0.
extern "C" int mmb_vit_mlp_bf16(const void* x, const void* ln_g,
                                const void* ln_b, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                void* xn, void* h, void* out, int M, int C,
                                int F, int gelu, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_layer_norm(x, ln_g, ln_b, xn, M, C, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BiasGelu e1{static_cast<const __nv_bfloat16*>(b1),
                    static_cast<__nv_bfloat16*>(h), F, gelu};
  err = launch_gemm(dense(xn, w1, M, C, F), e1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ResidualBias e2{static_cast<const __nv_bfloat16*>(x),
                        static_cast<const __nv_bfloat16*>(b2),
                        static_cast<__nv_bfloat16*>(out), C};
  return static_cast<int>(launch_gemm(dense(h, w2, M, F, C), e2, s));
}
