// One ResNeXt-50 bottleneck block on Hopper (sm_90a), bf16 in and out,
// f32 accumulation, running BatchNorm folded into the weights:
//
//   h1  = bf16(relu(x . w1 + b1))                      1x1 conv, GEMM
//   h2  = bf16(relu(grouped3x3(h1, w2, stride) + b2))  32 groups, pad 1
//   out = bf16(relu(h2 . w3 + b3 + identity))
//         identity = x[:, ::s, ::s] . wd + bd   (head blocks: downsample)
//                  = x                          (other blocks)
//
// Replaces the TPU kernel multimodal_baby_tpu/ops/bottleneck_hwbc.py::
// fused_bottleneck_hwbc (Pallas body `_kernel`), which runs the whole chain
// per (batch tile, row band) with h1 and h2 in VMEM, reading the block input
// once and writing its output once. It rounds h1 and h2 to bf16 and adds the
// residual in f32 before the last rounding; this file rounds at the same
// places.
//
// What bounds it on an H100: the two 1x1 convolutions carry ~90% of the
// block's FLOPs, so at the trunk's batch sizes the block is bound by
// tensor-core throughput (about 10-40 FLOPs per byte of activation moved
// at bf16, depending on the stage). This first version is three launches:
//   - gemm_bf16 (gemm.cuh: 128x128x32 tiles, 8 warps, wmma 16x16x16 on
//     mma.sync, two-stage cp.async pipeline) with the BiasResidualRelu
//     epilogue (bias, optional residual, ReLU, round to bf16). conv3 takes
//     the downsample as extra K: [h2 | x[:, ::s, ::s]] . [w3; wd], so the
//     f32 sum y + identity is one accumulator.
//   - grouped_conv3x3_bias_relu: an implicit GEMM on the tensor cores over
//     the 9 taps, with the 32 groups as 16-wide block-diagonal tiles (the
//     TPU kernel packs them 128 wide for its matrix unit).
// h1 and h2 round-trip through device memory in bf16. Restoring the TPU
// kernel's single read and single write (one persistent launch per block
// with TMA loads and wgmma, h1 and h2 kept in shared memory) is later work.

#include "gemm.cuh"

using namespace nvcuda;

namespace {

// conv1 and conv3: out = bf16(relu(acc + bias1 [+ bias2] [+ residual]))
struct BiasResidualRelu {
  const float* bias1;              // [N]
  const float* bias2;              // [N] or null (the downsample's)
  const __nv_bfloat16* residual;   // [M, N] or null
  __nv_bfloat16* out;              // [M, N]
  int N;

  __device__ void operator()(int m, int n, float (&v)[8]) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += bias1[n + e];
    if (bias2 != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += bias2[n + e];
    }
    const size_t off = static_cast<size_t>(m) * N + n;
    if (residual != nullptr) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(residual + off), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += f[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.0f);
    *reinterpret_cast<uint4*>(out + off) = pack8(v);
  }
};

// The grouped 3x3 as an implicit GEMM on the tensor cores. For one tap, the
// block's GC_BM output pixels read a [GC_BM, 64] tile of h (the tap-shifted
// input pixels, zero outside the image) and the tap's weights form a
// [64, 64] block-diagonal matrix (input channel x output channel, zero
// across groups). Only its diagonal 16x16 tiles (32x32 when CG = 32) are
// filled and multiplied: a group of 4 channels costs a 16-wide product (4x
// the useful multiplies at CG = 4, 2x at CG = 8, none wasted at CG >= 16).
// h: [B, H, W, C] NHWC; w: [3, 3, CG, C] (tap, input channel within the
// group, output channel); out: [B, Ho, Wo, C]. Zero padding of 1 at the
// image edge; output pixel (ho, wo) reads rows ho*stride-1 .. ho*stride+1.
constexpr int GC_BM = 128;       // output pixels per block
constexpr int GC_BN = 64;        // channels per block (a multiple of CG)
constexpr int GC_LD = GC_BN + 8;
constexpr int GC_THREADS = 128;  // 4 warps, 32 pixels x 64 channels each
constexpr int GC_SMEM =
    (2 * GC_BM * GC_LD + 2 * GC_BN * GC_LD) * 2 + 4 * 16 * 16 * 4;

template <int CG>
__global__ void __launch_bounds__(GC_THREADS)
    grouped_conv3x3_bias_relu(const __nv_bfloat16* __restrict__ h,
                              const __nv_bfloat16* __restrict__ w,
                              const float* __restrict__ bias,
                              __nv_bfloat16* __restrict__ out, int B, int H,
                              int W, int C, int stride, int Ho, int Wo) {
  constexpr int SPAN = CG > 16 ? CG : 16;  // width of a filled diagonal tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + 2 * GC_BM * GC_LD;
  float* scratch = reinterpret_cast<float*>(Bs + 2 * GC_BN * GC_LD);

  const int c0 = blockIdx.x * GC_BN;
  const int m0 = blockIdx.y * GC_BM;
  const int M = B * Ho * Wo;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the 8 A vectors this thread loads at every tap: image (-1 past M) and
  // the top-left input pixel of the 3x3 window
  int a_b[8], a_h[8], a_w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ((tid + i * GC_THREADS) >> 3);
    a_b[i] = -1;
    a_h[i] = 0;
    a_w[i] = 0;
    if (m < M) {
      const int hw = Ho * Wo;
      const int b = m / hw;
      const int r = m - b * hw;
      const int ho = r / Wo;
      a_b[i] = b;
      a_h[i] = ho * stride - 1;
      a_w[i] = (r - ho * Wo) * stride - 1;
    }
  }

  auto load_tap = [&](int t, int stage) {
    const int ky = t / 3;
    const int kx = t - 3 * ky;
    __nv_bfloat16* as = As + stage * GC_BM * GC_LD;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int v = tid + i * GC_THREADS;
      const int row = v >> 3;
      const int col = (v & 7) * 8;
      const int hi = a_h[i] + ky;
      const int wi = a_w[i] + kx;
      const bool ok = a_b[i] >= 0 && hi >= 0 && hi < H && wi >= 0 && wi < W;
      const __nv_bfloat16* src =
          ok ? h + ((static_cast<size_t>(a_b[i]) * H + hi) * W + wi) * C +
                   c0 + col
             : h;
      cp_async16(as + row * GC_LD + col, src, ok);
    }
    // B: row k (input channel c0 + k) over the columns of its diagonal
    // tile, two threads per row; w[t][k % CG][c0 + g*CG + n'] for the
    // columns of k's own group g, zero for the others
    __nv_bfloat16* bs = Bs + stage * GC_BN * GC_LD;
    const int k = tid >> 1;
    const int g = k / CG;
    const int col0 = (k / SPAN) * SPAN + (tid & 1) * (SPAN / 2);
    const __nv_bfloat16* wrow =
        w + static_cast<size_t>(t * CG + (k - g * CG)) * C + c0 + g * CG;
#pragma unroll
    for (int e = 0; e < SPAN / 2; ++e) {
      const int n = col0 + e;
      bs[k * GC_LD + n] =
          n / CG == g ? wrow[n - g * CG] : __float2bfloat16(0.0f);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_tap(0, 0);
  cp_async_commit();
  for (int t = 0; t < 9; ++t) {
    if (t + 1 < 9) load_tap(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* as = As + (t & 1) * GC_BM * GC_LD;
    const __nv_bfloat16* bs = Bs + (t & 1) * GC_BN * GC_LD;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int kk = 0; kk < SPAN / 16; ++kk) {
        const int ks = (j * 16 / SPAN) * (SPAN / 16) + kk;  // k-subtile
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            bf;
        wmma::load_matrix_sync(bf, bs + ks * 16 * GC_LD + j * 16, GC_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              af;
          wmma::load_matrix_sync(af, as + (warp * 32 + i * 16) * GC_LD +
                                         ks * 16,
                                 GC_LD);
          wmma::mma_sync(acc[i][j], af, bf, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next iteration overwrites this stage
  }

  float* sc = scratch + warp * 256;
  const int r = lane >> 1;
  const int c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + warp * 32 + i * 16 + r;
      const int n = c0 + j * 16 + c8;
      if (m < M) {
        uint4 packed;
        __nv_bfloat162* pp = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pp[e] = __floats2bfloat162_rn(
              fmaxf(sc[r * 16 + c8 + 2 * e] + bias[n + 2 * e], 0.0f),
              fmaxf(sc[r * 16 + c8 + 2 * e + 1] + bias[n + 2 * e + 1], 0.0f));
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * C + n) =
            packed;
      }
      __syncwarp();
    }
  }
}

template <int CG>
cudaError_t launch_grouped_conv_cg(const __nv_bfloat16* h,
                                   const __nv_bfloat16* w, const float* bias,
                                   __nv_bfloat16* out, int B, int H, int W,
                                   int C, int stride, int Ho, int Wo,
                                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      grouped_conv3x3_bias_relu<CG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, GC_SMEM);
  if (err != cudaSuccess) return err;
  const int M = B * Ho * Wo;
  const dim3 grid(C / GC_BN, (M + GC_BM - 1) / GC_BM);
  grouped_conv3x3_bias_relu<CG><<<grid, GC_THREADS, GC_SMEM, stream>>>(
      h, w, bias, out, B, H, W, C, stride, Ho, Wo);
  return cudaGetLastError();
}

cudaError_t launch_grouped_conv(const __nv_bfloat16* h,
                                const __nv_bfloat16* w, const float* bias,
                                __nv_bfloat16* out, int B, int H, int W,
                                int C, int cg, int stride, int Ho, int Wo,
                                cudaStream_t stream) {
  switch (cg) {
    case 4:
      return launch_grouped_conv_cg<4>(h, w, bias, out, B, H, W, C, stride,
                                       Ho, Wo, stream);
    case 8:
      return launch_grouped_conv_cg<8>(h, w, bias, out, B, H, W, C, stride,
                                       Ho, Wo, stream);
    case 16:
      return launch_grouped_conv_cg<16>(h, w, bias, out, B, H, W, C, stride,
                                        Ho, Wo, stream);
    case 32:
      return launch_grouped_conv_cg<32>(h, w, bias, out, B, H, W, C, stride,
                                        Ho, Wo, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shapes and alignment are checked by the Python wrapper
// (multimodal_baby_tpu_torch/ops/bottleneck.py): cin % 32 == 0,
// width in {128, 256, 512, 1024} (cg = width / 32 in {4, 8, 16, 32}),
// cout % 128 == 0, every pointer
// 16-byte aligned, wd and bd both null exactly when the block has no
// downsample (then stride == 1 and cin == cout). h1 [B, H, W, width] and
// h2 [B, Ho, Wo, width] are scratch. Returns the first CUDA error, or 0.
extern "C" int mmb_bottleneck_bf16(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, const void* w3,
                                   const void* b3, const void* wd,
                                   const void* bd, void* h1, void* h2,
                                   void* out, int B, int H, int W, int cin,
                                   int width, int cout, int stride,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);

  GemmArgs g1{};
  g1.a1 = xb;
  g1.b1 = static_cast<const __nv_bfloat16*>(w1);
  g1.k1 = cin;
  g1.M = B * H * W;
  g1.N = width;
  const BiasResidualRelu e1{static_cast<const float*>(b1), nullptr, nullptr,
                            static_cast<__nv_bfloat16*>(h1), width};
  cudaError_t err = launch_gemm(g1, e1, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = launch_grouped_conv(
      static_cast<const __nv_bfloat16*>(h1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(h2), B, H, W, width, width / 32, stride, Ho,
      Wo, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmArgs g3{};
  g3.a1 = static_cast<const __nv_bfloat16*>(h2);
  g3.b1 = static_cast<const __nv_bfloat16*>(w3);
  g3.k1 = width;
  g3.M = B * Ho * Wo;
  g3.N = cout;
  BiasResidualRelu e3{static_cast<const float*>(b3), nullptr, nullptr,
                      static_cast<__nv_bfloat16*>(out), cout};
  if (wd != nullptr) {
    g3.a2 = xb;
    g3.b2 = static_cast<const __nv_bfloat16*>(wd);
    g3.k2 = cin;
    g3.H = H;
    g3.W = W;
    g3.Ho = Ho;
    g3.Wo = Wo;
    g3.stride = stride;
    e3.bias2 = static_cast<const float*>(bd);
  } else {
    e3.residual = xb;
  }
  return static_cast<int>(launch_gemm(g3, e3, s));
}

extern "C" const char* mmb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
