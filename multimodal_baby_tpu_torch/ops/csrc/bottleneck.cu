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
// (K10b, the same bf16 chain in one launch with h1 and h2 in shared
// memory, is bottleneck_fused.cu.)
//
// Replaces the TPU kernel multimodal_baby_tpu/ops/bottleneck_hwbc.py::
// fused_bottleneck_hwbc (Pallas body `_kernel`; its int8 "q" mode takes the
// weights of ops/quant.py::fold_block_params_q, its transport mode those of
// ::fold_block_params_t), which runs the whole chain
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
// peak rate); layer 1's blocks are bound by device memory. Three launches:
//   - conv1 and conv3 as GEMMs with fused epilogues. In bf16 (K1) both run
//     on conv_gemm.cuh's TMA-fed wgmma ping-pong tile, conv3 taking the
//     downsample as a second K segment, [h2 | x[:, ::s, ::s]] . [w3; wd],
//     so the f32 sum y + identity is one accumulator (the strided rows
//     come by the TMA's im2col mode inside the kernel). int8 (K2) runs
//     the same schedule's int8 sibling, conv_gemm_s8.cuh (wgmma m64n128k32
//     .s8 with both operands K-major: the NHWC codes and the output-major
//     [N, K] weights), the downsample in its own int32 accumulators (its
//     scale differs) on 64-row tiles. Transport (K10a) runs K1's tile with
//     the int8 codes as conv1's A (the TMA's 64-byte boxes, rewritten in
//     place as the bf16 slice by the consumer) and conv3 as K2's walk on
//     f32 sums: h2 . w3 on K1's bf16 slices, the downsample over
//     the codes in its own accumulators on 64-row tiles, K2's epilogue (ad
//     and a3 applied apart, as the plain version does), the codes stored
//     and the residual codes read by TMA (conv_gemm_s8.cuh).
//   - the grouped 3x3 as an implicit GEMM on the tensor cores over the 9
//     taps, with the 32 groups as 16-wide block-diagonal tiles (the TPU
//     kernel packs them 128 wide for its matrix unit) on halo tiles
//     (bottleneck.cuh::gconv_halo_walk, gconv_halo_walk_s8: a tile's input
//     rows copied to shared memory once, mma.sync from there, the weights'
//     fragments built once a worker); K10a's h1 and h2 are bf16, so it
//     runs K1's launch as it is.
// h1 and h2 round-trip through device memory here; K10b
// (bottleneck_fused.cu) keeps them in shared memory in one launch, and
// lost to the weights' L2 stream that costs (PERF.md).

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "bottleneck.cuh"
#include "conv_gemm_s8.cuh"

namespace {

// K1's and K2's grouped 3x3: a worker a block, as many on each SM as fit
// (gconv_halo_walk, gconv_halo_walk_s8); at 128 threads ptxas would stop
// at 128 registers and spill at cg 32 without the explicit one-block bound
template <int CG>
__global__ void __launch_bounds__(GH_THREADS, 1)
    gconv_halo(const ConvArgs c, const HaloTiles ht) {
  extern __shared__ __align__(128) unsigned char smem[];
  gconv_halo_walk<CG>(c, ht, blockIdx.x, gridDim.x, smem, threadIdx.x, 0);
}

template <int CG>
__global__ void __launch_bounds__(GH_THREADS, 1)
    gconv_halo_s8(const ConvArgsS8 c, const HaloTiles ht) {
  extern __shared__ __align__(128) unsigned char smem[];
  gconv_halo_walk_s8<CG>(c, ht, blockIdx.x, gridDim.x, smem, threadIdx.x,
                         0);
}

// the blocks of `kernel` (its dynamic shared memory allowed up to
// GH_SMEM) with `smem` bytes that fit on the card at once, asked once per
// kernel and size (the occupancy query costs more than the launch)
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, int smem, int* blocks) {
  static std::mutex lock;
  static std::map<std::tuple<int, const void*, int>, int> known;
  const std::lock_guard<std::mutex> hold(lock);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GH_SMEM);
  if (err != cudaSuccess) return err;
  const auto key =
      std::make_tuple(device, reinterpret_cast<const void*>(kernel), smem);
  const auto it = known.find(key);
  if (it != known.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      GH_THREADS, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  *blocks = known[key] = per_sm * sms;
  return cudaSuccess;
}

// the halo walk's kernel for group width cg (bf16 or int8)
template <class T>
auto halo_kernel(int cg) {
  if constexpr (sizeof(T) == 1)
    return cg == 4 ? gconv_halo_s8<4> : cg == 8 ? gconv_halo_s8<8>
         : cg == 16 ? gconv_halo_s8<16> : gconv_halo_s8<32>;
  else
    return cg == 4 ? gconv_halo<4> : cg == 8 ? gconv_halo<8>
         : cg == 16 ? gconv_halo<16> : gconv_halo<32>;
}

template <class T>
cudaError_t launch_gconv_halo(const ConvArgsT<T>& c, cudaStream_t stream) {
  if (c.C % 128 || c.C > 1024) return cudaErrorInvalidValue;
  const HaloTiles ht = halo_tiles(c.M / (c.rows.H * c.rows.W), c.W, c.C,
                                  c.stride, c.rows.H, sizeof(T));
  const auto kernel = halo_kernel<T>(c.C / 32);
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, ht.smem, &resident);
  if (err != cudaSuccess) return err;
  // whole rounds of the channel tiles, at most one row tile a worker
  const int rounds = resident / ht.ncb < ht.per_cb ? resident / ht.ncb
                                                   : ht.per_cb;
  if (rounds < 1) return cudaErrorLaunchOutOfResources;
  kernel<<<rounds * ht.ncb, GH_THREADS, ht.smem, stream>>>(c, ht);
  return cudaGetLastError();
}

// K1's and K10a's grouped 3x3 (bf16 h1 and h2) on the output rows of a
// whole block
cudaError_t grouped_bf16(const void* h1, const void* w2, const void* b2,
                         void* h2, int B, int H, int W, int width,
                         int stride, cudaStream_t s) {
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  ConvArgs c{};
  c.h = static_cast<const __nv_bfloat16*>(h1);
  c.w = static_cast<const __nv_bfloat16*>(w2);
  c.bias = static_cast<const float*>(b2);
  c.out = static_cast<__nv_bfloat16*>(h2);
  c.H = H;
  c.W = W;
  c.C = width;
  c.stride = stride;
  c.rows = RowMap{Ho, Wo, 0, 0};
  c.M = B * Ho * Wo;
  return launch_gconv_halo(c, s);
}

// K1: the block's three launches, or one of them (part 1: conv1, 2: the
// grouped 3x3, 3: conv3; 0: all three)
cudaError_t bottleneck_bf16(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, const void* w3,
                            const void* b3, const void* wd, const void* bd,
                            void* h1, void* h2, void* out, int B, int H,
                            int W, int cin, int width, int cout, int stride,
                            int part, cudaStream_t s) {
  const int Ho = (H - 1) / stride + 1;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err = cudaSuccess;
  if (part == 0 || part == 1) {
    ConvGemm g1;
    err = conv1_gemm(&g1, x, w1, f(b1), h1, B, H, W, cin, width, 0, H);
    if (err == cudaSuccess)
      err = launch_conv_gemm<ConvEpilogue<false, false>>(g1, s);
    if (err != cudaSuccess) return err;
  }

  if (part == 0 || part == 2) {
    err = grouped_bf16(h1, w2, b2, h2, B, H, W, width, stride, s);
    if (err != cudaSuccess) return err;
  }

  if (part == 0 || part == 3) {
    ConvGemm g3;
    err = conv3_gemm(&g3, h2, w3, f(b3), x, wd, f(bd), out, B, H, W, cin,
                     width, cout, stride, 0, Ho);
    if (err != cudaSuccess) return err;
    if (wd != nullptr)
      return launch_conv_gemm<ConvEpilogue<true, false>>(g3, s);
    return launch_conv_gemm<ConvEpilogue<false, true>>(g3, s);
  }
  return cudaSuccess;
}

// K2: the block's three launches, or one of them (part 1: conv1, 2: the
// grouped 3x3, 3: conv3; 0: all three)
cudaError_t bottleneck_s8(const void* x, const void* w1, const void* a1,
                          const void* b1, const void* w2, const void* a2,
                          const void* b2, const void* w3, const void* a3,
                          const void* b3, const void* wd, const void* ad,
                          const void* bd, const void* ai, void* h1, void* h2,
                          void* out, int B, int H, int W, int cin, int width,
                          int cout, int stride, int part, cudaStream_t s) {
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err = cudaSuccess;
  if (part == 0 || part == 1) {
    ConvGemmS8 g1;
    err = conv1_gemm_s8(&g1, x, w1, f(a1), f(b1), h1, B, H, W, cin, width,
                        0, H);
    if (err == cudaSuccess) err = launch_conv_gemm_s8<S8_CONV1>(g1, s);
    if (err != cudaSuccess) return err;
  }

  if (part == 0 || part == 2) {
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
    err = launch_gconv_halo(c, s);
    if (err != cudaSuccess) return err;
  }

  if (part == 0 || part == 3) {
    ConvGemmS8 g3;
    err = conv3_gemm_s8(&g3, h2, w3, f(a3), f(b3), x, wd, f(ad), f(bd),
                        f(ai), out, B, H, W, cin, width, cout, stride, 0,
                        Ho);
    if (err != cudaSuccess) return err;
    if (wd != nullptr) return launch_conv_gemm_s8<S8_DOWNSAMPLE>(g3, s);
    return launch_conv_gemm_s8<S8_RESIDUAL>(g3, s);
  }
  return cudaSuccess;
}

// K10a: the block's three launches, or one of them (part 1: conv1, 2: the
// grouped 3x3, 3: conv3; 0: all three)
cudaError_t bottleneck_t(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, const void* w3,
                         const void* a3, const void* b3, const void* wd,
                         const void* ad, const void* bd, const void* ai,
                         void* h1, void* h2, void* out, int B, int H, int W,
                         int cin, int width, int cout, int stride, int part,
                         cudaStream_t s) {
  const int Ho = (H - 1) / stride + 1;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err = cudaSuccess;
  if (part == 0 || part == 1) {
    ConvGemmS8 g1;
    err = conv1_gemm_t(&g1, x, w1, f(b1), h1, B, H, W, cin, width, 0, H);
    if (err == cudaSuccess) err = launch_conv_gemm_t<S8_CONV1>(g1, s);
    if (err != cudaSuccess) return err;
  }

  if (part == 0 || part == 2) {
    err = grouped_bf16(h1, w2, b2, h2, B, H, W, width, stride, s);
    if (err != cudaSuccess) return err;
  }

  if (part == 0 || part == 3) {
    ConvGemmS8 g3;
    err = conv3_gemm_t(&g3, h2, w3, f(a3), f(b3), x, wd, f(ad), f(bd),
                       f(ai), out, B, H, W, cin, width, cout, stride, 0, Ho);
    if (err != cudaSuccess) return err;
    if (wd != nullptr) return launch_conv_gemm_t<S8_DOWNSAMPLE>(g3, s);
    return launch_conv_gemm_t<S8_RESIDUAL>(g3, s);
  }
  return cudaSuccess;
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
      cout, stride, 0, static_cast<cudaStream_t>(stream)));
}

// One of K1's three launches alone (part 1 conv1, 2 the grouped 3x3, 3
// conv3), with mmb_bottleneck_bf16's arguments, for scripts/
// probe_conv_tile.py: conv1 reads x and writes h1, the grouped 3x3 h1 and
// h2, conv3 h2 (and x) and out.
extern "C" int mmb_bottleneck_bf16_part(
    int part, const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, const void* wd,
    const void* bd, void* h1, void* h2, void* out, int B, int H, int W,
    int cin, int width, int cout, int stride, void* stream) {
  if (part < 1 || part > 3) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bottleneck_bf16(
      x, w1, b1, w2, b2, w3, b3, wd, bd, h1, h2, out, B, H, W, cin, width,
      cout, stride, part, static_cast<cudaStream_t>(stream)));
}

// K10a: the int8-transport block. x and out int8 codes in [0, 127]; w1
// [cin, width], w2 [3, 3, cg, width], w3 [width, cout], wd [cin, cout]
// bf16 (the input scale folded into w1 and wd); b1, b2 [width], a3, b3
// [cout] f32; ad, bd [cout] f32 with a downsample, else ai [cout]. h1, h2
// bf16 scratch. cin % 32 == 0, the rest as mmb_bottleneck_bf16.
extern "C" int mmb_bottleneck_t(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* a3, const void* b3,
    const void* wd, const void* ad, const void* bd, const void* ai,
    void* h1, void* h2, void* out, int B, int H, int W, int cin, int width,
    int cout, int stride, void* stream) {
  return static_cast<int>(bottleneck_t(
      x, w1, b1, w2, b2, w3, a3, b3, wd, ad, bd, ai, h1, h2, out, B, H, W,
      cin, width, cout, stride, 0, static_cast<cudaStream_t>(stream)));
}

// One of K10a's three launches alone (part 1 conv1, 2 the grouped 3x3, 3
// conv3), with mmb_bottleneck_t's arguments, for scripts/
// probe_conv_tile.py --transport and the card tests: conv1 reads x and
// writes h1, the grouped 3x3 h1 and h2, conv3 h2 (and x) and out.
extern "C" int mmb_bottleneck_t_part(
    int part, const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* a3, const void* b3,
    const void* wd, const void* ad, const void* bd, const void* ai,
    void* h1, void* h2, void* out, int B, int H, int W, int cin, int width,
    int cout, int stride, void* stream) {
  if (part < 1 || part > 3) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bottleneck_t(
      x, w1, b1, w2, b2, w3, a3, b3, wd, ad, bd, ai, h1, h2, out, B, H, W,
      cin, width, cout, stride, part, static_cast<cudaStream_t>(stream)));
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
  return static_cast<int>(bottleneck_s8(
      x, w1, a1, b1, w2, a2, b2, w3, a3, b3, wd, ad, bd, ai, h1, h2, out, B,
      H, W, cin, width, cout, stride, 0, static_cast<cudaStream_t>(stream)));
}

// One of K2's three launches alone (part 1 conv1, 2 the grouped 3x3, 3
// conv3), with mmb_bottleneck_s8's arguments, for scripts/
// probe_conv_tile.py --int8: conv1 reads x and writes h1, the grouped 3x3
// h1 and h2, conv3 h2 (and x) and out.
extern "C" int mmb_bottleneck_s8_part(
    int part, const void* x, const void* w1, const void* a1, const void* b1,
    const void* w2, const void* a2, const void* b2, const void* w3,
    const void* a3, const void* b3, const void* wd, const void* ad,
    const void* bd, const void* ai, void* h1, void* h2, void* out, int B,
    int H, int W, int cin, int width, int cout, int stride, void* stream) {
  if (part < 1 || part > 3) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bottleneck_s8(
      x, w1, a1, b1, w2, a2, b2, w3, a3, b3, wd, ad, bd, ai, h1, h2, out, B,
      H, W, cin, width, cout, stride, part,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* mmb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
