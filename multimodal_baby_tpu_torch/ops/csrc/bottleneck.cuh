// The pieces of one ResNeXt-50 bottleneck block on Hopper (sm_90a), shared
// by the per-block kernels (bottleneck.cu: K1 in bf16, K2 in int8, K10a in
// int8 transport) and the whole-stage kernel (stage.cu: K3a, K3b, and their
// transport mode):
//
//   - the epilogue functors of the two 1x1 GEMMs (gemm.cuh);
//   - the grouped 3x3 (32 groups, pad 1, stride 1 or 2) as an implicit GEMM
//     on the tensor cores, one tile routine for bf16 and one for int8.
//
// The grouped 3x3: for one tap, the tile's CBM output pixels read a
// [CBM, 64] tile of h (the tap-shifted input pixels, zero outside the
// image) and the tap's weights form a [64, 64] block-diagonal matrix (input
// channel x output channel, zero across groups). Only its diagonal 16x16
// tiles (32x32 when CG = 32) are filled and multiplied: a group of 4
// channels costs a 16-wide product (4x the useful multiplies at CG = 4, 2x
// at CG = 8, none wasted at CG >= 16). h: [*, H, W, C] NHWC;
// w: [3, 3, CG, C] (tap, input channel within the group, output channel);
// out: the output grid of `rows`, [*, Ho, Wo, C]. Output pixel (ho, wo)
// reads input rows ho*stride-1 .. ho*stride+1. CBM threads, one warp per 32
// pixels x 64 channels; two tap stages in flight with cp.async.

#pragma once

#include "gemm.cuh"

namespace {

// ------------------------------------------------------ GEMM epilogues

// bf16 conv1 and conv3: out = bf16(relu(acc + bias1 [+ bias2] [+ residual]))
struct BiasResidualRelu {
  const float* bias1;              // [N]
  const float* bias2;              // [N] or null (the downsample's)
  const __nv_bfloat16* residual;   // [pixels, N] or null
  __nv_bfloat16* out;              // [pixels, N]
  int N;

  __device__ void operator()(int p, int n, float (&v)[8]) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += bias1[n + e];
    if (bias2 != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += bias2[n + e];
    }
    const size_t off = static_cast<size_t>(p) * N + n;
    if (residual != nullptr) {
      // L2, not L1: in the stage kernel another block wrote it
      float f[8];
      unpack8(__ldcg(reinterpret_cast<const uint4*>(residual + off)), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += f[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.0f);
    *reinterpret_cast<uint4*>(out + off) = pack8(v);
  }
};

// int8 conv1: out = clip(rint(acc * a + b), 0, 127)
struct Requant {
  const float* a;  // [N]
  const float* b;  // [N]
  int8_t* out;     // [pixels, N]
  int N;

  __device__ void operator()(int p, int n, const int (&v)[8],
                             const int (&)[8]) const {
    int8_t c[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      c[e] = clip_code(madd_rn(__int2float_rn(v[e]), a[n + e], b[n + e]));
    *reinterpret_cast<uint2*>(out + static_cast<size_t>(p) * N + n) =
        pack8_s8(c);
  }
};

// int8 conv3: out = clip(rint((acc * a3 + b3) + identity), 0, 127) with
// identity = accd * ad + bd (downsample) or x * ai
struct RequantResidual {
  const float* a3;
  const float* b3;
  const float* ad;  // null without a downsample
  const float* bd;
  const float* ai;  // with no downsample
  const int8_t* x;  // block input [pixels, N], with no downsample
  int8_t* out;
  int N;

  __device__ void operator()(int p, int n, const int (&v)[8],
                             const int (&vd)[8]) const {
    const size_t off = static_cast<size_t>(p) * N + n;
    float id[8];
    if (ad != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        id[e] = madd_rn(__int2float_rn(vd[e]), ad[n + e], bd[n + e]);
    } else {
      unpack8_s8(__ldcg(reinterpret_cast<const uint2*>(x + off)), id);
#pragma unroll
      for (int e = 0; e < 8; ++e) id[e] = __fmul_rn(id[e], ai[n + e]);
    }
    int8_t c[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      c[e] = clip_code(__fadd_rn(
          madd_rn(__int2float_rn(v[e]), a3[n + e], b3[n + e]), id[e]));
    *reinterpret_cast<uint2*>(out + off) = pack8_s8(c);
  }
};

// int8-transport conv3 (f32 sums of bf16 products, int8 codes out):
// out = clip(rint((acc3 * a3 + b3) + identity), 0, 127) with
// identity = accd * ad + bd (downsample: the split GEMM's second segment)
// or x * ai (the block's int8 input codes)
struct TransportOut {
  const float* a3;
  const float* b3;
  const float* ad;  // null without a downsample
  const float* bd;
  const float* ai;  // with no downsample
  const int8_t* x;  // block input [pixels, N], with no downsample
  int8_t* out;
  int N;

  __device__ void operator()(int p, int n, float (&v)[8]) const {
    const size_t off = static_cast<size_t>(p) * N + n;
    float id[8];
    unpack8_s8(__ldcg(reinterpret_cast<const uint2*>(x + off)), id);
#pragma unroll
    for (int e = 0; e < 8; ++e) id[e] = __fmul_rn(id[e], ai[n + e]);
    store(off, n, v, id);
  }

  __device__ void operator()(int p, int n, const float (&v)[8],
                             const float (&vd)[8]) const {
    float id[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) id[e] = madd_rn(vd[e], ad[n + e], bd[n + e]);
    store(static_cast<size_t>(p) * N + n, n, v, id);
  }

  __device__ void store(size_t off, int n, const float (&v)[8],
                        const float (&id)[8]) const {
    int8_t c[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      c[e] = clip_code(__fadd_rn(madd_rn(v[e], a3[n + e], b3[n + e]), id[e]));
    *reinterpret_cast<uint2*>(out + off) = pack8_s8(c);
  }
};

// ------------------------------------------------------------ grouped 3x3

template <class T>
struct ConvArgsT {
  const T* h;         // [*, H, W, C]
  const T* w;         // [3, 3, CG, C]
  const float* a;     // [C] requantisation scale (int8 only)
  const float* bias;  // [C]
  T* out;             // [*, Ho, Wo, C]
  int H, W, C, stride;
  RowMap rows;  // output rows: rows.H = Ho, rows.W = Wo; M = B * ext * Wo
  int M;
};
using ConvArgs = ConvArgsT<__nv_bfloat16>;
using ConvArgsS8 = ConvArgsT<int8_t>;

constexpr int GC_BN = 64;        // channels per tile (a multiple of CG)
constexpr int GC_LD = GC_BN + 8;  // bf16 pitch

template <int CBM>
constexpr int gconv_bf16_smem() {
  return (2 * CBM * GC_LD + 2 * GC_BN * GC_LD) * 2 + (CBM / 32) * 256 * 4;
}

template <int CBM>
constexpr int gconv_s8_smem() {
  return 2 * CBM * GC_BN + 2 * GC_BN * GC_BN + (CBM / 32) * 256 * 4;
}

// output row m of the tile -> (image, top-left input row and column of its
// window); image -1 past M
template <class T>
__device__ __forceinline__ void conv_window(const ConvArgsT<T>& c, int m,
                                            int& b, int& hi, int& wi) {
  b = -1;
  hi = 0;
  wi = 0;
  if (m < c.M) {
    const int Wo = c.rows.W;
    const int per = (c.rows.ext ? c.rows.ext : c.rows.H) * Wo;
    b = m / per;
    const int rem = m - b * per;
    const int r = rem / Wo;
    hi = (c.rows.lo + r) * c.stride - 1;
    wi = (rem - r * Wo) * c.stride - 1;
  }
}

template <int CG, int CBM>
__device__ __forceinline__ void gconv_bf16_tile(const ConvArgs& c, int m0,
                                                int c0,
                                                unsigned char* smem) {
  using namespace nvcuda;
  constexpr int SPAN = CG > 16 ? CG : 16;  // width of a filled diagonal tile
  constexpr int TPR = CBM / GC_BN;         // threads per weight row
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + 2 * CBM * GC_LD;
  float* scratch = reinterpret_cast<float*>(Bs + 2 * GC_BN * GC_LD);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the 8 A vectors this thread loads at every tap
  int a_b[8], a_h[8], a_w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    conv_window(c, m0 + ((tid + i * CBM) >> 3), a_b[i], a_h[i], a_w[i]);

  auto load_tap = [&](int t, int stage) {
    const int ky = t / 3;
    const int kx = t - 3 * ky;
    __nv_bfloat16* as = As + stage * CBM * GC_LD;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int v = tid + i * CBM;
      const int row = v >> 3;
      const int col = (v & 7) * 8;
      const int hi = a_h[i] + ky;
      const int wi = a_w[i] + kx;
      const bool ok =
          a_b[i] >= 0 && hi >= 0 && hi < c.H && wi >= 0 && wi < c.W;
      const __nv_bfloat16* src =
          ok ? c.h + ((static_cast<size_t>(a_b[i]) * c.H + hi) * c.W + wi) *
                         c.C +
                   c0 + col
             : c.h;
      cp_async16(as + row * GC_LD + col, src, ok);
    }
    // B: row k (input channel c0 + k) over the columns of its diagonal
    // tile, TPR threads per row; w[t][k % CG][c0 + n] for the columns of
    // k's own group, zero for the others
    __nv_bfloat16* bs = Bs + stage * GC_BN * GC_LD;
    const int k = tid / TPR;
    const int g = k / CG;
    const int col0 = (k / SPAN) * SPAN + (tid % TPR) * (SPAN / TPR);
    const __nv_bfloat16* wrow =
        c.w + static_cast<size_t>(t * CG + (k - g * CG)) * c.C + c0;
#pragma unroll
    for (int e = 0; e < SPAN / TPR; ++e) {
      const int n = col0 + e;
      bs[k * GC_LD + n] = n / CG == g ? wrow[n] : __float2bfloat16(0.0f);
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
    const __nv_bfloat16* as = As + (t & 1) * CBM * GC_LD;
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
      if (m < c.M) {
        uint4 packed;
        __nv_bfloat162* pp = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pp[e] = __floats2bfloat162_rn(
              fmaxf(sc[r * 16 + c8 + 2 * e] + c.bias[n + 2 * e], 0.0f),
              fmaxf(sc[r * 16 + c8 + 2 * e + 1] + c.bias[n + 2 * e + 1],
                    0.0f));
        *reinterpret_cast<uint4*>(
            c.out + static_cast<size_t>(map_row(c.rows, m)) * c.C + n) =
            packed;
      }
      __syncwarp();
    }
  }
}

// int8: the same tiles as 16-byte channel chunks ([chunk][row][16]), int32
// sums, epilogue clip(rint(acc * a + bias), 0, 127)
template <int CG, int CBM>
__device__ __forceinline__ void gconv_s8_tile(const ConvArgsS8& c, int m0,
                                              int c0, unsigned char* smem) {
  using namespace nvcuda;
  constexpr int SPAN = CG > 16 ? CG : 16;
  constexpr int TPR = CBM / GC_BN;
  int8_t* As = reinterpret_cast<int8_t*>(smem);  // [2][4][CBM][16]
  int8_t* Bs = As + 2 * CBM * GC_BN;             // [2][4][64][16]
  int* scratch = reinterpret_cast<int*>(Bs + 2 * GC_BN * GC_BN);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the 4 A vectors (16 channels each) this thread loads at every tap
  int a_b[4], a_h[4], a_w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    conv_window(c, m0 + ((tid + i * CBM) >> 2), a_b[i], a_h[i], a_w[i]);

  auto load_tap = [&](int t, int stage) {
    const int ky = t / 3;
    const int kx = t - 3 * ky;
    int8_t* as = As + stage * CBM * GC_BN;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = tid + i * CBM;
      const int row = v >> 2;
      const int chunk = v & 3;
      const int hi = a_h[i] + ky;
      const int wi = a_w[i] + kx;
      const bool ok =
          a_b[i] >= 0 && hi >= 0 && hi < c.H && wi >= 0 && wi < c.W;
      const int8_t* src =
          ok ? c.h + ((static_cast<size_t>(a_b[i]) * c.H + hi) * c.W + wi) *
                         c.C +
                   c0 + chunk * 16
             : c.h;
      cp_async16(as + (chunk * CBM + row) * 16, src, ok);
    }
    int8_t* bs = Bs + stage * GC_BN * GC_BN;
    const int k = tid / TPR;
    const int g = k / CG;
    const int col0 = (k / SPAN) * SPAN + (tid % TPR) * (SPAN / TPR);
    const int8_t* wrow =
        c.w + static_cast<size_t>(t * CG + (k - g * CG)) * c.C + c0;
#pragma unroll
    for (int e = 0; e < SPAN / TPR; ++e) {
      const int n = col0 + e;
      bs[((n >> 4) * GC_BN + k) * 16 + (n & 15)] =
          n / CG == g ? wrow[n] : static_cast<int8_t>(0);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);

  load_tap(0, 0);
  cp_async_commit();
  for (int t = 0; t < 9; ++t) {
    if (t + 1 < 9) load_tap(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int8_t* as = As + (t & 1) * CBM * GC_BN;
    const int8_t* bs = Bs + (t & 1) * GC_BN * GC_BN;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int kk = 0; kk < SPAN / 16; ++kk) {
        const int ks = (j * 16 / SPAN) * (SPAN / 16) + kk;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::row_major>
            bf;
        wmma::load_matrix_sync(
            bf,
            reinterpret_cast<const signed char*>(
                bs + (j * GC_BN + ks * 16) * 16),
            16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                         wmma::row_major>
              af;
          wmma::load_matrix_sync(
              af,
              reinterpret_cast<const signed char*>(
                  as + (ks * CBM + warp * 32 + i * 16) * 16),
              16);
          wmma::mma_sync(acc[i][j], af, bf, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  int* sc = scratch + warp * 256;
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
      if (m < c.M) {
        int8_t q[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          q[e] = clip_code(madd_rn(__int2float_rn(sc[r * 16 + c8 + e]),
                                   c.a[n + e], c.bias[n + e]));
        *reinterpret_cast<uint2*>(
            c.out + static_cast<size_t>(map_row(c.rows, m)) * c.C + n) =
            pack8_s8(q);
      }
      __syncwarp();
    }
  }
}

}  // namespace
