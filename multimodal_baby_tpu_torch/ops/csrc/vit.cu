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
// What bounds it on an H100: at ViT-B/14 and B = 128 (M = 32,896 token
// rows, C = 768, F = 3072) each Dense is 155 GFLOP, 0.157 ms at 989
// TFLOP/s, on ~260-300 MB in and out (0.08-0.09 ms at 3.35 TB/s): tensor-
// core throughput. Three launches:
//   1 LayerNorm, one warp per token row (vit.cuh)                x -> xn
//   2 fc1 on vit_pingpong.cuh's ping-pong wgmma tile, bias and
//     GELU (BiasGelu's arithmetic)                               xn -> h
//   3 fc2 on the same tile, the residual sum (+ x)               h -> out
// The ping-pong schedule gives each consumer warpgroup whole 128 x 128
// tiles in turns, so one warpgroup's epilogue (fc1: an erff a hidden
// value and a 202 MB hidden written; fc2: the residual read) runs while
// the other's products keep the tensor cores busy; fc1's tiles are short
// in K (12 slices of 64), so its epilogue weighs four times fc2's. The
// epilogue stages its tile in shared memory and stores it by TMA, and
// fc2's residual arrives the same way (vit_pingpong.cuh). Per call at B =
// 128 on an H100 (PERF.md): fc1 ~0.30 ms (~520 TFLOP/s), fc2 ~0.25
// (~610), the LayerNorm 0.04: ~0.60 ms against 0.69 for LayerNorm,
// Linear, GELU, Linear and the residual in PyTorch.
// xn and the [M, F] hidden pass through device memory in bf16: keeping
// the hidden on chip per row band would need R x 768 f32 accumulators for
// a band of R rows (196 KB of registers at R = 64) and stream W1 and W2
// from L2 once a band, to save ~0.12 ms of HBM traffic that already hides
// under the products (PERF.md). The LayerNorm stays its own launch (0.04
// ms a call): folded into fc1's A path it would cost the consumers more.
// The GELU form is fixed at compile time per launch (PingPongGelu).

#include "vit_pingpong.cuh"

namespace {

// fc1: h = bf16(gelu(a . w + bias)) in the GELU form `gelu`
cudaError_t mlp_fc1(const void* a, const void* w, const void* bias, void* h,
                    int M, int K, int N, int gelu, int grid,
                    cudaStream_t s) {
  const auto* b = static_cast<const __nv_bfloat16*>(bias);
  switch (gelu) {
    case GELU_ERF:
      return launch_vit_pingpong(a, w, h, nullptr, M, K, N,
                                 PingPongGelu<GELU_ERF>{b}, grid, s);
    case GELU_TANH:
      return launch_vit_pingpong(a, w, h, nullptr, M, K, N,
                                 PingPongGelu<GELU_TANH>{b}, grid, s);
    case GELU_SIGMOID:
      return launch_vit_pingpong(a, w, h, nullptr, M, K, N,
                                 PingPongGelu<GELU_SIGMOID>{b}, grid, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// fc2: out = bf16((residual + a . w) + bias)
cudaError_t mlp_fc2(const void* a, const void* w, const void* bias,
                    const void* residual, void* out, int M, int K, int N,
                    int grid, cudaStream_t s) {
  return launch_vit_pingpong(
      a, w, out, residual, M, K, N,
      PingPongResidual{static_cast<const __nv_bfloat16*>(bias)}, grid, s);
}

}  // namespace

// Shapes and alignment are checked by the Python wrapper
// (multimodal_baby_tpu_torch/ops/vit_mlp.py): bf16 everywhere, C % 128 ==
// 0, F % 128 == 0, every pointer 16-byte aligned. Weights are [in, out]
// row-major; xn [M, C] and h [M, F] are scratch; gelu is a GeluMode. grid1
// and grid2 are fc1's and fc2's blocks (ops/vit_mlp.py::mlp_geometry).
// Returns the first CUDA error, or 0.
extern "C" int mmb_vit_mlp_bf16(const void* x, const void* ln_g,
                                const void* ln_b, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                void* xn, void* h, void* out, int M, int C,
                                int F, int gelu, float eps, int grid1,
                                int grid2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_layer_norm(x, ln_g, ln_b, xn, M, C, eps, s);
  if (err == cudaSuccess)
    err = mlp_fc1(xn, w1, b1, h, M, C, F, gelu, grid1, s);
  if (err == cudaSuccess) err = mlp_fc2(h, w2, b2, x, out, M, F, C, grid2, s);
  return static_cast<int>(err);
}

// One of K6's Denses alone, for scripts/probe_vit.py and chip_smoke.py: out
// = epi(a [M, K] . w [K, N]) with epi 1 the residual sum (residual [M, N],
// bias) or 2 bias and GELU (bias, the GELU form gelu), on mlp_geometry's
// grid.
extern "C" int mmb_vit_mlp_dense_bf16(const void* a, const void* w,
                                      const void* bias, const void* residual,
                                      void* out, int M, int K, int N, int epi,
                                      int gelu, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epi == 1)
    return static_cast<int>(
        mlp_fc2(a, w, bias, residual, out, M, K, N, grid, s));
  if (epi == 2)
    return static_cast<int>(mlp_fc1(a, w, bias, out, M, K, N, gelu, grid, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
