// One ResNeXt-50 bottleneck block on Hopper (sm_90a), running BatchNorm
// folded into the weights, in bf16 (K1) or int8 (K2):
//
//   K1  h1  = bf16(relu(x . w1 + b1))                      1x1 conv, GEMM
//       h2  = bf16(relu(grouped3x3(h1, w2, stride) + b2))  32 groups, pad 1
//       out = bf16(relu(h2 . w3 + b3 + identity))
//             identity = x[:, ::s, ::s] . wd + bd   (head blocks)
//                      = x                          (other blocks)
//   K2  the same chain on int8 codes in [0, 127] with per-output-channel
//       int8 weights, every dot summed exactly in int32:
//       h1  = clip(rint(acc1 * a1 + b1), 0, 127)
//       h2  = clip(rint(acc2 * a2 + b2), 0, 127)
//       out = clip(rint((acc3 * a3 + b3) + identity), 0, 127)
//             identity = accd * ad + bd  (head blocks) or x * ai
//   K10a  int8 transport: int8 codes in and out, K1's bf16 chain between
//       (the input scale folded into w1 and wd, h1 and h2 in bf16):
//       out = clip(rint((acc3 * a3 + b3) + identity), 0, 127)
//             identity = accd * ad + bd  (head blocks) or x * ai
//   K10b  K1 on one band of output rows of one batch chunk (the TPU
//       package's tile mode)
//
// Replaces the TPU kernel multimodal_baby_tpu/ops/bottleneck_hwbc.py::
// fused_bottleneck_hwbc (Pallas body `_kernel`; its int8 "q" mode takes the
// weights of ops/quant.py::fold_block_params_q, its transport mode those of
// ::fold_block_params_t, and ::fused_bottleneck_tiles calls the same body
// once per tile), which runs the whole chain
// per (batch tile, row band) with h1 and h2 in VMEM, reading the block input
// once and writing its output once. It rounds at the places above; the
// int8 epilogues here round the product and then the sum (no fused
// multiply-add) and round half to even, as the plain version does, so the
// two agree code for code.
//
// What bounds it on an H100: the two 1x1 convolutions carry ~90% of the
// block's operations, so at the trunk's batch sizes the block is bound by
// tensor-core throughput (about 10-40 operations per byte of activation
// moved, depending on the stage; int8 halves the bytes and doubles the
// peak rate). This first version is three launches (gemm.cuh and the tile
// routines of bottleneck.cuh):
//   - conv1 and conv3 as tiled GEMMs with fused epilogues (bf16 on wmma,
//     int8 on mma.sync m16n8k32 with output-major [N, K] weights: the
//     int8 rate needs k32 steps, and their B fragments read each output
//     channel's K bytes contiguously). In bf16 conv3 takes the downsample
//     as extra K: [h2 | x[:, ::s, ::s]] . [w3; wd], so the f32 sum
//     y + identity is one accumulator; in int8 the downsample has its own
//     int32 accumulator (its scale differs). In transport the int8 input
//     is read into registers and converted to bf16 on its way into shared
//     memory (conv1, the downsample), and the downsample's f32 sums are
//     kept apart (held in shared memory while conv3's accumulate), so the
//     epilogue applies ad and a3 as the plain version does.
//   - the grouped 3x3 as an implicit GEMM on the tensor cores (wmma) over
//     the 9 taps, with the 32 groups as 16-wide block-diagonal tiles (the
//     TPU kernel packs them 128 wide for its matrix unit).
// h1 and h2 round-trip through device memory. Restoring the TPU kernel's
// single read and single write (one persistent launch per block with TMA
// loads and wgmma, h1 and h2 kept in shared memory) is later work.

#include <algorithm>

#include "bottleneck.cuh"

namespace {

constexpr int GC_BM = 128;  // output pixels per grouped-conv block

template <int CG>
__global__ void __launch_bounds__(GC_BM)
    gconv_bf16(const ConvArgs c) {
  extern __shared__ __align__(128) unsigned char smem[];
  gconv_bf16_tile<CG, GC_BM>(c, blockIdx.y * GC_BM, blockIdx.x * GC_BN,
                             smem);
}

template <int CG>
__global__ void __launch_bounds__(GC_BM)
    gconv_s8(const ConvArgsS8 c) {
  extern __shared__ __align__(128) unsigned char smem[];
  gconv_s8_tile<CG, GC_BM>(c, blockIdx.y * GC_BM, blockIdx.x * GC_BN, smem);
}

template <class Kernel, class Args>
cudaError_t launch_conv(Kernel kernel, int smem, const Args& c,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(c.C / GC_BN, (c.M + GC_BM - 1) / GC_BM);
  kernel<<<grid, GC_BM, smem, stream>>>(c);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_grouped_conv(const ConvArgsT<T>& c, int cg,
                                cudaStream_t stream) {
  constexpr bool S8 = sizeof(T) == 1;
  constexpr int smem =
      S8 ? gconv_s8_smem<GC_BM>() : gconv_bf16_smem<GC_BM>();
  switch (cg) {
#define MMB_CG_CASE(CG)                                                     \
  case CG:                                                                  \
    if constexpr (S8)                                                       \
      return launch_conv(gconv_s8<CG>, smem, c, stream);                    \
    else                                                                    \
      return launch_conv(gconv_bf16<CG>, smem, c, stream);
    MMB_CG_CASE(4)
    MMB_CG_CASE(8)
    MMB_CG_CASE(16)
    MMB_CG_CASE(32)
#undef MMB_CG_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// K1 on output rows [lo, lo + ext) of every image (ext = 0: all rows):
// conv1 runs on the input rows those need (one halo row on each side per
// stride-1 row, clipped to the image), the grouped 3x3 reads zeros outside
// the image, and each output's sums run in the same order as in the
// whole-image launch, so the band's values are the whole launch's.
cudaError_t bottleneck_bf16(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, const void* w3,
                            const void* b3, const void* wd, const void* bd,
                            void* h1, void* h2, void* out, int B, int H,
                            int W, int cin, int width, int cout, int stride,
                            int lo, int ext, cudaStream_t s) {
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const int out_rows = ext ? ext : Ho;
  const int in_lo = ext ? std::max(0, lo * stride - 1) : 0;
  const int in_rows =
      ext ? std::min(H, (lo + ext - 1) * stride + 2) - in_lo : 0;

  GemmArgs g1{};
  g1.a1 = xb;
  g1.b1 = static_cast<const __nv_bfloat16*>(w1);
  g1.k1 = cin;
  g1.rows = RowMap{H, W, in_lo, in_rows};
  g1.M = B * (ext ? in_rows : H) * W;
  g1.N = width;
  const BiasResidualRelu e1{static_cast<const float*>(b1), nullptr, nullptr,
                            static_cast<__nv_bfloat16*>(h1), width};
  cudaError_t err = launch_gemm(g1, e1, s);
  if (err != cudaSuccess) return err;

  ConvArgs c{};
  c.h = static_cast<const __nv_bfloat16*>(h1);
  c.w = static_cast<const __nv_bfloat16*>(w2);
  c.bias = static_cast<const float*>(b2);
  c.out = static_cast<__nv_bfloat16*>(h2);
  c.H = H;
  c.W = W;
  c.C = width;
  c.stride = stride;
  c.rows = RowMap{Ho, Wo, lo, ext};
  c.M = B * out_rows * Wo;
  err = launch_grouped_conv(c, width / 32, s);
  if (err != cudaSuccess) return err;

  GemmArgs g3{};
  g3.a1 = static_cast<const __nv_bfloat16*>(h2);
  g3.b1 = static_cast<const __nv_bfloat16*>(w3);
  g3.k1 = width;
  g3.rows = RowMap{Ho, Wo, lo, ext};
  g3.M = B * out_rows * Wo;
  g3.N = cout;
  BiasResidualRelu e3{static_cast<const float*>(b3), nullptr, nullptr,
                      static_cast<__nv_bfloat16*>(out), cout};
  if (wd != nullptr) {
    g3.a2 = xb;
    g3.b2 = static_cast<const __nv_bfloat16*>(wd);
    g3.k2 = cin;
    g3.H = H;
    g3.W = W;
    g3.stride = stride;
    e3.bias2 = static_cast<const float*>(bd);
  } else {
    e3.residual = xb;
  }
  return launch_gemm(g3, e3, s);
}

}  // namespace

// Shapes and alignment are checked by the Python wrapper
// (multimodal_baby_tpu_torch/ops/bottleneck.py): cin % 32 == 0 (bf16) or
// cin % 64 == 0 (int8), width in {128, 256, 512, 1024} (cg = width / 32 in
// {4, 8, 16, 32}), cout % 128 == 0, every pointer 16-byte aligned, wd and bd
// both null exactly when the block has no downsample (then stride == 1 and
// cin == cout). h1 [B, H, W, width] and h2 [B, Ho, Wo, width] are scratch.
// Returns the first CUDA error, or 0.
extern "C" int mmb_bottleneck_bf16(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, const void* w3,
                                   const void* b3, const void* wd,
                                   const void* bd, void* h1, void* h2,
                                   void* out, int B, int H, int W, int cin,
                                   int width, int cout, int stride,
                                   void* stream) {
  return static_cast<int>(bottleneck_bf16(
      x, w1, b1, w2, b2, w3, b3, wd, bd, h1, h2, out, B, H, W, cin, width,
      cout, stride, 0, 0, static_cast<cudaStream_t>(stream)));
}

// K10b: K1 on the band of `rows` output rows from `row_lo` of every image
// of x [B, H, W, cin] (a batch chunk), the rest of out untouched; one
// launch per (batch chunk, band) as the TPU kernel's tile mode calls its
// kernel once per tile. Arguments as mmb_bottleneck_bf16.
extern "C" int mmb_bottleneck_band_bf16(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, const void* wd,
    const void* bd, void* h1, void* h2, void* out, int B, int H, int W,
    int cin, int width, int cout, int stride, int row_lo, int rows,
    void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bottleneck_bf16(
      x, w1, b1, w2, b2, w3, b3, wd, bd, h1, h2, out, B, H, W, cin, width,
      cout, stride, row_lo, rows, static_cast<cudaStream_t>(stream)));
}

// K10a: the int8-transport block. x and out int8 codes; w1 [cin, width],
// w2 [3, 3, cg, width], w3 [width, cout], wd [cin, cout] bf16 (the input
// scale folded into w1 and wd); b1, b2 [width], a3, b3 [cout] f32; ad, bd
// [cout] f32 with a downsample, else ai [cout]. h1, h2 bf16 scratch. cin %
// 32 == 0, the rest as mmb_bottleneck_bf16.
extern "C" int mmb_bottleneck_t(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* a3, const void* b3,
    const void* wd, const void* ad, const void* bd, const void* ai,
    void* h1, void* h2, void* out, int B, int H, int W, int cin, int width,
    int cout, int stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  // the int8 codes ride in GemmArgs' A pointers (Q1 / Q2 segments)
  const auto* xq = static_cast<const __nv_bfloat16*>(x);

  GemmArgs g1{};
  g1.a1 = xq;
  g1.b1 = static_cast<const __nv_bfloat16*>(w1);
  g1.k1 = cin;
  g1.M = B * H * W;
  g1.N = width;
  cudaError_t err = launch_gemm_x<true, false, false>(
      g1,
      BiasResidualRelu{f(b1), nullptr, nullptr,
                       static_cast<__nv_bfloat16*>(h1), width},
      s);
  if (err != cudaSuccess) return static_cast<int>(err);

  ConvArgs c{};
  c.h = static_cast<const __nv_bfloat16*>(h1);
  c.w = static_cast<const __nv_bfloat16*>(w2);
  c.bias = f(b2);
  c.out = static_cast<__nv_bfloat16*>(h2);
  c.H = H;
  c.W = W;
  c.C = width;
  c.stride = stride;
  c.rows = RowMap{Ho, Wo, 0, 0};
  c.M = B * Ho * Wo;
  err = launch_grouped_conv(c, width / 32, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmArgs g3{};
  g3.a1 = static_cast<const __nv_bfloat16*>(h2);
  g3.b1 = static_cast<const __nv_bfloat16*>(w3);
  g3.k1 = width;
  g3.rows = RowMap{Ho, Wo, 0, 0};
  g3.M = B * Ho * Wo;
  g3.N = cout;
  const TransportOut e3{f(a3), f(b3), f(ad), f(bd), f(ai),
                        static_cast<const int8_t*>(x),
                        static_cast<int8_t*>(out), cout};
  if (wd == nullptr)
    return static_cast<int>(launch_gemm(g3, e3, s));
  g3.a2 = xq;
  g3.b2 = static_cast<const __nv_bfloat16*>(wd);
  g3.k2 = cin;
  g3.H = H;
  g3.W = W;
  g3.stride = stride;
  return static_cast<int>(launch_gemm_x<false, true, true>(g3, e3, s));
}

// K2: the int8 block. w1 [width, cin], w3 [cout, width], wd [cout, cin]
// int8, output-major; w2 int8 [3, 3, cg, width]; a*/b* f32 [channels]; ai
// f32 [cout] when there is no downsample (ad, bd null), else null.
extern "C" int mmb_bottleneck_s8(
    const void* x, const void* w1, const void* a1, const void* b1,
    const void* w2, const void* a2, const void* b2, const void* w3,
    const void* a3, const void* b3, const void* wd, const void* ad,
    const void* bd, const void* ai, void* h1, void* h2, void* out, int B,
    int H, int W, int cin, int width, int cout, int stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  const auto* xq = static_cast<const int8_t*>(x);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };

  GemmArgsS8 g1{};
  g1.a1 = xq;
  g1.b1 = static_cast<const int8_t*>(w1);
  g1.k1 = cin;
  g1.M = B * H * W;
  g1.N = width;
  cudaError_t err = launch_gemm_s8(
      g1, Requant{f(a1), f(b1), static_cast<int8_t*>(h1), width}, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  ConvArgsS8 c{};
  c.h = static_cast<const int8_t*>(h1);
  c.w = static_cast<const int8_t*>(w2);
  c.a = f(a2);
  c.bias = f(b2);
  c.out = static_cast<int8_t*>(h2);
  c.H = H;
  c.W = W;
  c.C = width;
  c.stride = stride;
  c.rows = RowMap{Ho, Wo, 0, 0};
  c.M = B * Ho * Wo;
  err = launch_grouped_conv(c, width / 32, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmArgsS8 g3{};
  g3.a1 = static_cast<const int8_t*>(h2);
  g3.b1 = static_cast<const int8_t*>(w3);
  g3.k1 = width;
  g3.rows = RowMap{Ho, Wo, 0, 0};
  g3.M = B * Ho * Wo;
  g3.N = cout;
  RequantResidual e3{f(a3), f(b3), f(ad), f(bd), f(ai), xq,
                     static_cast<int8_t*>(out), cout};
  if (wd != nullptr) {
    g3.a2 = xq;
    g3.b2 = static_cast<const int8_t*>(wd);
    g3.k2 = cin;
    g3.H = H;
    g3.W = W;
    g3.stride = stride;
  }
  return static_cast<int>(launch_gemm_s8(g3, e3, s));
}

extern "C" const char* mmb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
