// K11: a 1x1 convolution with its BatchNorm, residual and ReLU on Hopper
// (sm_90a), over NHWC pixels flattened to rows:
//
//   out = bf16(relu((x . w) * mul + add + residual))
//         x [M, cin], w [cin, cout], residual and out [M, cout] bf16;
//         mul, add [cout] f32 (the running BatchNorm); f32 sums
//
// Replaces the TPU kernel multimodal_baby_tpu/ops/conv_epilogue.py::
// conv1x1_bn_residual_relu (Pallas body `_epilogue_kernel`), which tiles M
// by its largest power-of-two divisor up to 2048 and leaves M without a
// divisor of 8 to XLA (a TPU layout rule). Here any M runs: the rows are
// described to the TMA as the pixels of one image row, so the rows past M
// read as zeros and their stores are clipped. The multiply and the adds
// are each rounded once (no fused multiply-add), in the plain version's
// order.
//
// What bounds it on an H100: 2 * cin operations per output element against
// (cin + 2 * cout) * 2 bytes per row, so at the trunk's widths (cin 128 to
// 1024) it sits near the card's ridge: layer 1's shape (cin 128, cout 256)
// is bound by its bytes, layer 4's (cin 1024, cout 2048) by its
// operations. One launch of K1's 1x1 tile (conv_gemm.cuh: TMA-fed wgmma,
// ping-pong consumers, the residual brought in by TMA beside the products)
// with the epilogue ConvEpilogueMul: the product never leaves the block
// before its BatchNorm, residual and ReLU are applied, and each warpgroup's
// stores overlap the other's products.

#include "conv_gemm.cuh"

// Shapes and alignment are checked by the Python wrapper
// (multimodal_baby_tpu_torch/ops/conv_epilogue.py): M >= 1, cin % 32 == 0,
// cout % 128 == 0, every pointer 16-byte aligned. Returns the first CUDA
// error, or 0.
extern "C" int mmb_conv1x1_bn_residual_relu_bf16(
    const void* x, const void* w, const void* mul, const void* add,
    const void* residual, void* out, int M, int cin, int cout,
    void* stream) {
  ConvGemm g;
  const cudaError_t err = rows_gemm(
      &g, x, w, static_cast<const float*>(mul),
      static_cast<const float*>(add), residual, out, M, cin, cout);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_conv_gemm<ConvEpilogueMul>(
      g, static_cast<cudaStream_t>(stream)));
}
