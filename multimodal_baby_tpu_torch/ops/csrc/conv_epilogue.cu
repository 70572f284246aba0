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
// divisor of 8 to XLA (a TPU layout rule). Here any M runs: the GEMM masks
// the rows past M. The multiply and the adds are each rounded once (no
// fused multiply-add), in the plain version's order.
//
// What bounds it on an H100: 2 * cin operations per output element against
// (cin + 2 * cout) * 2 bytes per row, so at the trunk's widths (cin 128 to
// 1024) it sits near the card's ridge: layer 1's shape (cin 128, cout 256)
// is bound by its bytes, layer 4's (cin 1024, cout 2048) by its
// operations. One launch of the bf16 GEMM tile of gemm.cuh (128 x 128 x 32,
// wmma, two cp.async stages) with the epilogue below: the product never
// leaves the block before its BatchNorm, residual and ReLU are applied.

#include "gemm.cuh"

namespace {

struct MulAddResidualRelu {
  const float* mul;               // [N]
  const float* add;               // [N]
  const __nv_bfloat16* residual;  // [M, N]
  __nv_bfloat16* out;             // [M, N]
  int N;

  __device__ void operator()(int p, int n, float (&v)[8]) const {
    const size_t off = static_cast<size_t>(p) * N + n;
    float r[8];
    unpack8(*reinterpret_cast<const uint4*>(residual + off), r);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(v[e], mul[n + e]),
                                       add[n + e]),
                             r[e]),
                   0.0f);
    *reinterpret_cast<uint4*>(out + off) = pack8(v);
  }
};

}  // namespace

// Shapes and alignment are checked by the Python wrapper
// (multimodal_baby_tpu_torch/ops/conv_epilogue.py): M >= 1, cin % 32 == 0,
// cout % 128 == 0, every pointer 16-byte aligned. Returns the first CUDA
// error, or 0.
extern "C" int mmb_conv1x1_bn_residual_relu_bf16(
    const void* x, const void* w, const void* mul, const void* add,
    const void* residual, void* out, int M, int cin, int cout,
    void* stream) {
  GemmArgs g{};
  g.a1 = static_cast<const __nv_bfloat16*>(x);
  g.b1 = static_cast<const __nv_bfloat16*>(w);
  g.k1 = cin;
  g.M = M;
  g.N = cout;
  const MulAddResidualRelu epi{static_cast<const float*>(mul),
                               static_cast<const float*>(add),
                               static_cast<const __nv_bfloat16*>(residual),
                               static_cast<__nv_bfloat16*>(out), cout};
  return static_cast<int>(
      launch_gemm(g, epi, static_cast<cudaStream_t>(stream)));
}
