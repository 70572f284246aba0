// The bottleneck block's two 1x1 convolutions on Hopper (sm_90a): a
// ping-pong warp-specialized wgmma tile fed by the Tensor Memory
// Accelerator (TMA), shared by K1 (bottleneck.cu: conv1 and conv3 in
// bf16), the bf16 mode of the stage kernel (stage.cu: K3a and K3b), K11
// (conv_epilogue.cu) and, with int8 codes as an A operand, K10a
// (bottleneck.cu, stage.cu; its conv3 epilogue is conv_gemm_s8.cuh's):
//
//   out = bf16(relu(A1 . W1 [+ A2 . W2] + b1 [+ b2] [+ residual]))
//   K11: out = bf16(relu(((A1 . W1) * mul + b1) + residual))
//
// with f32 sums. The GEMM rows are the pixels of a band of image rows of
// NHWC tensors [B, H, W, C]: row m is pixel (b, r, c) of the output band
// (per = ext x Wo pixels an image), and an operand reads the pixel (b, lo +
// r s, c s) of its own tensor (its first row lo and stride s: conv1 reads
// the block input's rows, conv3 h2's rows and, for the downsample, the
// block input at stride 2). Each operand is loaded by TMA in im2col mode
// (4D maps whose bounding box is the band's rows, traversed at the stride):
// a 128-row A box is one copy, whether its rows cross image rows, images
// or the band's edges, and no torch op gathers x[:, ::s, ::s] ahead of the
// kernel. Rows past the last image read as zeros. W [K, N] comes by 2D
// tile copies; the K tail of a segment (K % 64) reads as zeros, so its
// extra k16 steps add exact zeros. The output goes through a 3D store map
// (C, rows, parts): the rows of the whole output when the band is every
// row of the image (K1, K3a: one part of M rows), else one part of per
// rows an image. The row bands of 128 are cut within a part, so a tile
// never crosses one, and its store is clipped at the part's end by the TMA
// unit (a store at a negative coordinate is an illegal instruction, so a
// tile crossing into the next image could not be stored by TMA): the M
// tail and the band edges need no masked path. A banded stage pays at most
// one ragged tile an image for it (layer 1's bands of 28: 13 tiles where
// 12.3 would do).
//
// Bits. Every output's sum runs over segment 1's k16 steps in order, then
// segment 2's, into one f32 accumulator, and the epilogue adds b1, then
// b2, then the residual, then takes the ReLU and rounds once: the earlier
// wmma tile did the same, so K1 kept its values, K10b (bottleneck_fused.cu,
// also k16 steps in order) still equals K1, and a pixel's value does not
// depend on the tile or band that computes it (the stage's band counts
// agree bit for bit).
//
// int8 codes as A (K10a's conv1 and its downsample: the block's input
// codes, in [0, 127]). The TMA copies a box of BM pixels x 64 codes (64
// bytes a pixel, the 64-byte swizzle) into the slice's A place; the
// consumer warpgroup rewrites it in place as the bf16 slice the TMA would
// have written (each code pair turned into a bf16 pair exactly: 0x43XX is
// the bf16 128 + XX, less 128) and multiplies it as above, so the sums are
// those of bf16 A, k16 steps in order. The conversion of a slice runs
// while the previous slice's products do. wgmma with A from registers, fed
// by 16-bit shared loads of the codes in its fragment layout, measured
// slower: with a step's fragments defined under the previous slice's last
// step ptxas serialized every wgmma (C7513), and with a wait at each
// slice's end conv1 took 8% longer (PERF.md).
//
// Schedule. vit_pingpong.cuh's (K6), whose pieces it reuses: two consumer
// warpgroups, each a whole 128 x 128 output tile at a time (two
// m64n128k16 products a k16 step), taking the block's tiles in turns, the
// ordering barriers (named barriers 1 and 2) letting one warpgroup's
// epilogue run under the other's products; a producer warpgroup one
// thread of which issues the copies into a six-stage ring of 32 KB (A
// [128][64] and two W atoms [64][64], all in the 128-byte swizzle);
// setmaxnreg 232 / 40 (each role's whole walk inside its branch); the
// epilogue staged a 64-row half at a time with stmatrix and stored by TMA,
// the residual half brought in by TMA and read with ldmatrix. The slice
// counter runs on across the calls of one launch (the stage kernel's
// phases), so the barriers' phases need no reset.
//
// What bounds it on an H100: at B = 128 the 1x1 convolutions of layers 2-4
// are bound by tensor-core throughput (conv3 of layer 4's tail: 2 x 6272 x
// 1024 x 2048 = 26 GFLOP on 38 MB), those of layer 1 by device memory
// (conv1 of layer 1.1: 26 GFLOP on 308 MB, 0.092 ms at 3.35 TB/s against
// 0.027 ms of products), where the overlap of one warpgroup's stores with
// the other's products matters more than the products.

#pragma once

#include "vit_pingpong.cuh"

namespace {

constexpr int CV_BK = PP_BK;  // depth of a ring slice: 64 channels

// One GEMM of the tile: its operands' TMA maps, the walk and the
// operands' rows. Lives in kernel parameter space (K1) or in device memory
// (the stage kernel: one a band, block and convolution).
struct ConvGemm {
  CUtensorMap a1;   // im2col: segment 1's A, boxes of BM pixels x 64 ch.
  CUtensorMap w1;   // tile: W1 [k1, N], boxes of 64 x 64
  CUtensorMap a2;   // im2col: segment 2's A (the downsample), when nk2 > 0
  CUtensorMap w2;   // tile: W2 [k2, N]
  CUtensorMap res;  // im2col: the residual, boxes of 64 pixels x 64 ch.
  CUtensorMap out;  // tile (N, part, parts): boxes of 64 x 64 x 1
  int M, N;         // GEMM rows (B x per) and columns
  int nk1, nk2;     // 64-deep slices of each segment
  int codes1, codes2;  // the segment's A is int8 codes (64-byte boxes)
  int per, wo;      // rows an image, pixels an image row
  int part, parts;  // the store's parts: rows of each, and how many
  int lo1, s1, lo2, s2, lo_res;  // each operand's first row and stride
  const float* b1;  // [N] the epilogue's biases: conv's, and the
  const float* b2;  // downsample's (null without one)
  const float* mul;  // [N] K11's multiply (null elsewhere)
};

// ------------------------------------------------------------ host side

// a cuTensorMapEncode* function, found through the runtime (no link to
// libcuda)
template <class Fn>
inline cudaError_t entry_point(const char* name, Fn* fn) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, &p, 12000, cudaEnableDefault, &found);
  if (err != cudaSuccess) return err;
  if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
  *fn = reinterpret_cast<Fn>(p);
  return cudaSuccess;
}

// an im2col map of the NHWC tensor [B, H, W, C] of bf16 (esize 2) or int8
// codes (esize 1): boxes of `pixels` pixels x `bytes` bytes of channels
// (128: the 128-byte swizzle; 64: the 64-byte one), traversing the rows
// lo, lo + s, ... < hi and the columns 0, s, ... < W of every image in
// turn. The box corners are relative to the tensor's first and last rows
// (a 4D map holds them in [-128, 127]).
inline cudaError_t im2col_map(CUtensorMap* map, const void* base, int B,
                              int H, int W, int C, int lo, int hi, int s,
                              int pixels, int esize = 2, int bytes = 128) {
  static decltype(&cuTensorMapEncodeIm2col) encode = nullptr;
  if (encode == nullptr) {
    const cudaError_t err = entry_point("cuTensorMapEncodeIm2col", &encode);
    if (err != cudaSuccess) return err;
  }
  if (lo < 0 || hi > H || lo >= hi || lo > 127 || hi - H < -128)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(C) * esize;
  const cuuint64_t strides[3] = {row, row * W, row * W * H};
  const int lower[2] = {0, lo};      // (W, H) from the first pixel
  const int upper[2] = {0, hi - H};  // (W, H) from the last
  const cuuint32_t steps[4] = {1, static_cast<cuuint32_t>(s),
                               static_cast<cuuint32_t>(s), 1};
  const CUresult r = encode(
      map, esize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, lower, upper,
      static_cast<cuuint32_t>(bytes / esize),
      static_cast<cuuint32_t>(pixels), steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the store map of the rows [lo, lo + ext) of every image of the NHWC
// tensor [B, H, W, C] of bf16 (esize 2) or int8 codes (esize 1): boxes of
// 128 bytes of channels x 64 rows x 1 (the 128-byte swizzle), and its
// parts: one of all B H W rows when the band is the whole image, else one
// of ext W rows an image
inline cudaError_t band_store_map(ConvGemm* g, void* base, int B, int H,
                                  int W, int C, int lo, int ext,
                                  int esize = 2) {
  static decltype(&cuTensorMapEncodeTiled) encode = nullptr;
  if (encode == nullptr) {
    const cudaError_t err = entry_point("cuTensorMapEncodeTiled", &encode);
    if (err != cudaSuccess) return err;
  }
  const bool whole = ext == H;
  g->part = whole ? B * H * W : ext * W;
  g->parts = whole ? 1 : B;
  const cuuint64_t row = static_cast<cuuint64_t>(C) * esize;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(g->part),
                              static_cast<cuuint64_t>(g->parts)};
  const cuuint64_t strides[2] = {row, row * W * H};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / esize), 64, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  void* first = static_cast<char*>(base) + row * W * lo;
  const CUresult r = encode(
      &g->out,
      esize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, first, dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// conv1 of a block on its input rows [lo, hi): x [B, H, W, cin] . w1 [cin,
// width] -> the same rows of h1 [B, H, W, width]
inline cudaError_t conv1_gemm(ConvGemm* g, const void* x, const void* w1,
                              const float* b1, void* h1, int B, int H, int W,
                              int cin, int width, int lo, int hi) {
  *g = ConvGemm{};
  g->b1 = b1;
  g->M = B * (hi - lo) * W;
  g->N = width;
  g->nk1 = (cin + CV_BK - 1) / CV_BK;
  g->per = (hi - lo) * W;
  g->wo = W;
  g->lo1 = lo;
  g->s1 = 1;
  cudaError_t err = im2col_map(&g->a1, x, B, H, W, cin, lo, hi, 1, PP_BM);
  if (err == cudaSuccess) err = bf16_map(&g->w1, w1, cin, width, CV_BK);
  if (err == cudaSuccess)
    err = band_store_map(g, h1, B, H, W, width, lo, hi - lo);
  return err;
}

// conv3 of a block on its output rows [lo, hi): h2 [B, Ho, Wo, width] .
// w3 [width, cout] (+ b3) and, with a downsample (wd [cin, cout] and bd
// not null), x [B, H, W, cin] at stride s . wd (+ bd), else the residual x
// (cin == cout, stride 1) -> the same rows of out [B, Ho, Wo, cout]
inline cudaError_t conv3_gemm(ConvGemm* g, const void* h2, const void* w3,
                              const float* b3, const void* x, const void* wd,
                              const float* bd, void* out, int B, int H,
                              int W, int cin, int width, int cout, int s,
                              int lo, int hi) {
  const int Ho = (H - 1) / s + 1;
  const int Wo = (W - 1) / s + 1;
  *g = ConvGemm{};
  g->b1 = b3;
  g->b2 = wd != nullptr ? bd : nullptr;
  g->M = B * (hi - lo) * Wo;
  g->N = cout;
  g->nk1 = (width + CV_BK - 1) / CV_BK;
  g->per = (hi - lo) * Wo;
  g->wo = Wo;
  g->lo1 = lo;
  g->s1 = 1;
  cudaError_t err =
      im2col_map(&g->a1, h2, B, Ho, Wo, width, lo, hi, 1, PP_BM);
  if (err == cudaSuccess) err = bf16_map(&g->w1, w3, width, cout, CV_BK);
  if (err == cudaSuccess && wd != nullptr) {
    g->nk2 = (cin + CV_BK - 1) / CV_BK;
    g->lo2 = lo * s;
    g->s2 = s;
    err = im2col_map(&g->a2, x, B, H, W, cin, lo * s, (hi - 1) * s + 1, s,
                     PP_BM);
    if (err == cudaSuccess) err = bf16_map(&g->w2, wd, cin, cout, CV_BK);
  } else if (err == cudaSuccess) {
    g->lo_res = lo;
    err = im2col_map(&g->res, x, B, H, W, cout, lo, hi, 1, 64);
  }
  if (err == cudaSuccess)
    err = band_store_map(g, out, B, Ho, Wo, cout, lo, hi - lo);
  return err;
}

// K11's GEMM: the rows x [M, cin] . w [cin, cout], the residual [M, cout]
// and out [M, cout], all bf16, as the pixels of one image row [1, 1, M, C]
// (a box of 128 rows is one im2col copy; the rows past M read as zeros,
// and their stores are clipped at M)
inline cudaError_t rows_gemm(ConvGemm* g, const void* x, const void* w,
                             const float* mul, const float* add,
                             const void* residual, void* out, int M, int cin,
                             int cout) {
  *g = ConvGemm{};
  g->mul = mul;
  g->b1 = add;
  g->M = M;
  g->N = cout;
  g->nk1 = (cin + CV_BK - 1) / CV_BK;
  g->per = M;
  g->wo = M;
  g->s1 = 1;
  cudaError_t err = im2col_map(&g->a1, x, 1, 1, M, cin, 0, 1, 1, PP_BM);
  if (err == cudaSuccess) err = bf16_map(&g->w1, w, cin, cout, CV_BK);
  if (err == cudaSuccess)
    err = im2col_map(&g->res, residual, 1, 1, M, cout, 0, 1, 1, 64);
  if (err == cudaSuccess)
    err = band_store_map(g, out, 1, 1, M, cout, 0, 1);
  return err;
}

// ---------------------------------------------------------- device side

// a TMA map (a kernel parameter, or one the host wrote to device memory)
// made visible to this thread's copies through it (the tensormap proxy),
// by the threads with p set
__device__ __forceinline__ void tensormap_acquire_if(bool p,
                                                     const CUtensorMap* map) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %1, 0;\n"
      "@q fence.proxy.tensormap::generic.acquire.sys [%0], 128;\n}\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(static_cast<int>(p))
      : "memory");
}

// a box at channel c and GEMM row m of an im2col operand (first row lo,
// stride s) into dst, counted on bar, by the threads with p set (the
// predicate in PTX, so that a warpgroup calling it keeps one path)
__device__ __forceinline__ void im2col_load_if(bool p, void* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar,
                                               const ConvGemm& g, int c,
                                               int m, int lo, int s) {
  const int b = m / g.per;
  const int rem = m - b * g.per;
  const int r = rem / g.wo;
  const int w = (rem - r * g.wo) * s;
  const int h = lo + r * s;
  const unsigned short zero = 0;
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %9, 0;\n"
      "@q cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n}"
      "\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c),
      "r"(w), "r"(h), "r"(b), "h"(zero), "h"(zero), "r"(static_cast<int>(p))
      : "memory");
}

// by the threads with p set: the [64][64] box at src to (column c, row r
// of part t) of a store map, rows past the part's end dropped; committed
// as this thread's bulk group
__device__ __forceinline__ void tma_store3_if(bool p, const CUtensorMap* map,
                                              const void* src, int c, int r,
                                              int t) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %5, 0;\n"
      "@q cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, "
      "%3, %4}], [%1];\n}\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c), "r"(r), "r"(t), "r"(static_cast<int>(p))
      : "memory");
}

// out = bf16(relu(acc + b1 [+ b2] [+ residual])) on columns n, n + 1:
// BiasResidualRelu's arithmetic (bottleneck.cuh) on a pair, b2 and the
// residual fixed at compile time; the biases are the GEMM's (ConvGemm)
template <bool B2, bool RES>
struct ConvEpilogue {
  static constexpr bool kResidual = RES;

  struct Cols {
    float2 c1, c2;
  };

  __device__ __forceinline__ static Cols cols(const ConvGemm& g, int n) {
    Cols c;
    c.c1 = __ldg(reinterpret_cast<const float2*>(g.b1 + n));
    c.c2 = B2 ? __ldg(reinterpret_cast<const float2*>(g.b2 + n))
              : make_float2(0.0f, 0.0f);
    return c;
  }

  __device__ __forceinline__ static uint32_t apply(float a0, float a1,
                                                   const Cols& c,
                                                   uint32_t r) {
    float v0 = a0 + c.c1.x;
    float v1 = a1 + c.c1.y;
    if (B2) {
      v0 += c.c2.x;
      v1 += c.c2.y;
    }
    if (RES) {
      const float2 rf = unpack2(r);
      v0 += rf.x;
      v1 += rf.y;
    }
    return pack2(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
  }
};

// K11: out = bf16(relu(((acc * mul) + add) + residual)) on columns n,
// n + 1, each product and sum rounded once (no fused multiply-add), in the
// plain version's order; mul and add are the GEMM's mul and b1
struct ConvEpilogueMul {
  static constexpr bool kResidual = true;

  struct Cols {
    float2 mul, add;
  };

  __device__ __forceinline__ static Cols cols(const ConvGemm& g, int n) {
    return Cols{__ldg(reinterpret_cast<const float2*>(g.mul + n)),
                __ldg(reinterpret_cast<const float2*>(g.b1 + n))};
  }

  __device__ __forceinline__ static float one(float a, float mul, float add,
                                              float r) {
    return fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(a, mul), add), r), 0.0f);
  }

  __device__ __forceinline__ static uint32_t apply(float a0, float a1,
                                                   const Cols& c,
                                                   uint32_t r) {
    const float2 rf = unpack2(r);
    return pack2(one(a0, c.mul.x, c.add.x, rf.x),
                 one(a1, c.mul.y, c.add.y, rf.y));
  }
};

// a block's tiles of g: the row bands of BM are cut within each store
// part (bands of them a part), tile u is row band u / nt and column tile
// u % nt; block b takes tiles b, b + grid, ...
template <int BM>
struct TileWalk {
  int nt, nk, bands, tiles;

  __device__ __forceinline__ explicit TileWalk(const ConvGemm& g) {
    nt = g.N / PP_BN;
    nk = g.nk1 + g.nk2;
    bands = (g.part + BM - 1) / BM;
    const int total = bands * g.parts * nt;
    tiles = static_cast<int>(blockIdx.x) < total
                ? (total - blockIdx.x + gridDim.x - 1) / gridDim.x
                : 0;
  }

  // tile j's store part, its first row in the part and its first GEMM row
  __device__ __forceinline__ int part(int j) const {
    return (blockIdx.x + j * gridDim.x) / nt / bands;
  }

  __device__ __forceinline__ int row_in_part(int j) const {
    return (blockIdx.x + j * gridDim.x) / nt % bands * BM;
  }

  __device__ __forceinline__ int row(const ConvGemm& g, int j) const {
    return part(j) * g.part + row_in_part(j);
  }

  __device__ __forceinline__ int column(int j) const {
    return (blockIdx.x + j * gridDim.x) % nt * PP_BN;
  }

  // the ring slices the block takes
  __device__ __forceinline__ int slices() const { return tiles * nk; }
};

using ConvWalk = TileWalk<PP_BM>;

// by one thread, before the first walk of the launch (a block barrier
// publishes it)
__device__ __forceinline__ void conv_ring_init(PingPongRing& ring) {
#pragma unroll
  for (int s = 0; s < PP_STAGES; ++s) {
    mbar_init(&ring.full[s], 1);
    mbar_init(&ring.empty[s], 1);
  }
  mbar_init(&ring.residual[0], 1);
  mbar_init(&ring.residual[1], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the producer: every slice of the block's tiles of g (tiles of BM rows),
// in order, from ring slice q: segment 1's, then segment 2's (SEG2_FIRST:
// segment 2's, then segment 1's), a slice of int8 codes BM x 64 bytes of
// A. The whole producer warpgroup walks the ring, so that its warps keep
// one path up to a block barrier after it, and its thread `issuer` issues
// the copies in a branch of its own: with the copies only predicated in
// PTX, ptxas turned them into elect loops under uniform predicates, and
// K1's conv3 with the downsample stalled in some launches (a build that
// differed from a stable one only in this walk's arithmetic; PERF.md).
template <int BM = PP_BM, bool SEG2_FIRST = false>
__device__ __forceinline__ void conv_produce(const ConvGemm& g,
                                             unsigned char* stages,
                                             PingPongRing& ring, int q,
                                             bool issuer) {
  const TileWalk<BM> w(g);
  constexpr int W_BYTES = 2 * PP_ATOM_ELEMS * 2;
  const int bytes1 = BM * CV_BK * (g.codes1 ? 1 : 2) + W_BYTES;
  const int bytes2 = BM * CV_BK * (g.codes2 ? 1 : 2) + W_BYTES;
  int i = q;
  for (int j = 0; j < w.tiles; ++j) {
    const int m0 = w.row(g, j);
    const int n0 = w.column(j);
    for (int kt = 0; kt < w.nk; ++kt, ++i) {
      const int s = i % PP_STAGES;
      mbar_wait(&ring.empty[s], ((i / PP_STAGES) & 1) ^ 1);
      const bool first = SEG2_FIRST ? kt >= g.nk2 : kt < g.nk1;
      const int k =
          (SEG2_FIRST ? (first ? kt - g.nk2 : kt) : (first ? kt : kt - g.nk1))
          * CV_BK;
      if (issuer) {
        mbar_expect(&ring.full[s], first ? bytes1 : bytes2);
        unsigned char* st = stages + s * PP_STAGE_BYTES;
        const CUtensorMap* wmap = first ? &g.w1 : &g.w2;
        im2col_load_if(true, st, first ? &g.a1 : &g.a2, &ring.full[s], g,
                       k, m0, first ? g.lo1 : g.lo2, first ? g.s1 : g.s2);
        tma_load(st + 2 * PP_A_ELEMS, wmap, &ring.full[s], n0, k);
        tma_load(st + 2 * (PP_A_ELEMS + PP_ATOM_ELEMS), wmap, &ring.full[s],
                 n0 + 64, k);
      }
    }
  }
}

// a consumer warpgroup's products of the bf16 A slice [BM][64] (HALVES =
// BM / 64 halves of 64 rows) and W slice at st into d (acc: add to it),
// committed as one wgmma group
template <int HALVES>
__device__ __forceinline__ void bf16_products(const unsigned char* st,
                                              float (&d)[HALVES][64],
                                              bool acc) {
  const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(st);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < CV_BK / 16; ++kk) {
    // W: LBO one atom (8 KB), SBO 8 rows x 128 bytes; k16 step kk is 16
    // rows down
    const uint64_t db =
        wg_desc(sb + PP_A_ELEMS + 16 * kk * 64, PP_ATOM_ELEMS * 2, 1024, 1);
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      // A: rows 64 h ..; SBO 8 rows x 128 bytes; k16 step kk is 32 bytes
      // into the rows
      const uint64_t da = wg_desc(sb + 64 * h * CV_BK + 16 * kk, 16, 1024, 1);
      wgmma_128(d[h], da, db, acc || kk > 0);
    }
  }
  wg_commit();
}

// the products of ring slice i (the tile's first slice: `first`), a bf16
// A slice, into d, then the release of slice i - 1 unless i is the first
template <int HALVES>
__device__ __forceinline__ void bf16_slice(PingPongRing& ring,
                                           const unsigned char* stages,
                                           int i, int first,
                                           float (&d)[HALVES][64], bool acc) {
  const int s = i % PP_STAGES;
  mbar_wait(&ring.full[s], (i / PP_STAGES) & 1);
  bf16_products(stages + s * PP_STAGE_BYTES, d, acc);
  wg_wait<1>();  // the products of the previous slice are done
  if (i > first) pingpong_release(ring, (i - 1) % PP_STAGES);
}

// byte (r, c) of an int8 A slice [BM][64]: 64-byte rows, their 16-byte
// chunks in the TMA's 64-byte swizzle
__device__ __forceinline__ int codes_byte(int r, int c) {
  return r * 64 + ((((c >> 4) ^ (r >> 1)) & 3) << 4) + (c & 15);
}

// two codes in [0, 127] (the low 16 bits of w, the lower column in the low
// byte) as a bf16 pair, exactly: 0x43XX is the bf16 128 + XX, and 1 x it -
// 128 rounds nothing
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t w) {
  const uint32_t biased = __byte_perm(w, 0x43434343u, 0x4140);
  uint32_t v;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(v)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC300C300u));
  return v;
}

// The int8 codes of the A slice at st, [64 HALVES][64] (64-byte rows in the
// 64-byte swizzle, as the TMA wrote them), rewritten in place by the
// consumer warpgroup as the bf16 A slice [64 HALVES][64] (128-byte rows in
// the 128-byte swizzle, as the TMA writes bf16): each thread reads its
// 16-byte chunks of codes (a row's four are four threads'), the warpgroup
// syncs on its epilogue barrier (the bf16 rows overwrite the codes), each
// thread writes its chunks as 32 bytes of bf16, and the writes are made
// visible to the wgmma (the async proxy) before a second sync. A quarter
// warp's 8 chunks fall on 8 distinct 16-byte bank groups, read or written.
template <int HALVES>
__device__ __forceinline__ void codes_to_bf16(unsigned char* st) {
  const int t = threadIdx.x % PP_WG;
  const int bar = 3 + static_cast<int>(threadIdx.x) / PP_WG;
  uint32_t q[2 * HALVES][4];
#pragma unroll
  for (int j = 0; j < 2 * HALVES; ++j) {
    const int r = (t + PP_WG * j) >> 2, c = (t + PP_WG * j) & 3;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(q[j][0]), "=r"(q[j][1]), "=r"(q[j][2]), "=r"(q[j][3])
                 : "r"(smem_addr(st + codes_byte(r, 16 * c)))
                 : "memory");
  }
  named_sync(bar, PP_WG);
#pragma unroll
  for (int j = 0; j < 2 * HALVES; ++j) {
    const int r = (t + PP_WG * j) >> 2, c = (t + PP_WG * j) & 3;
    uint32_t v[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = codes_bf16x2(q[j][e]);
      v[2 * e + 1] = codes_bf16x2(q[j][e] >> 16);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half)
      asm volatile(
          "st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_addr(
              st + r * 128 + (((2 * c + half) ^ (r & 7)) << 4))),
          "r"(v[4 * half]), "r"(v[4 * half + 1]), "r"(v[4 * half + 2]),
          "r"(v[4 * half + 3])
          : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(bar, PP_WG);
}

// bf16_slice with A int8 codes [BM][64]: converted in place into the bf16
// slice, then multiplied as one
template <int HALVES>
__device__ __forceinline__ void codes_slice(PingPongRing& ring,
                                            unsigned char* stages, int i,
                                            int first, float (&d)[HALVES][64],
                                            bool acc) {
  const int s = i % PP_STAGES;
  mbar_wait(&ring.full[s], (i / PP_STAGES) & 1);
  unsigned char* st = stages + s * PP_STAGE_BYTES;
  codes_to_bf16<HALVES>(st);
  bf16_products(st, d, acc);
  wg_wait<1>();  // the products of the previous slice are done
  if (i > first) pingpong_release(ring, (i - 1) % PP_STAGES);
}

// warpgroup wg's tiles j = wg, wg + CONSUMERS, ... of g (tiles of BM
// rows) from ring slice q: the products of each (with two consumers, after
// the other warpgroup has issued those of tile j - 1; CODES1: segment 1's
// A is int8 codes), then its epilogue (with two, while the other's
// products run)
template <class Epilogue, int CONSUMERS = 2, bool CODES1 = false,
          int BM = PP_BM>
__device__ __forceinline__ void conv_consume(const ConvGemm& g,
                                             __nv_bfloat16* stages,
                                             PingPongRing& ring, int wg,
                                             int q) {
  constexpr int HALVES = BM / 64;
  static_assert(HALVES == 2 || !Epilogue::kResidual,
                "the residual takes two phases of its barrier a tile");
  const TileWalk<BM> w(g);
  unsigned char* bytes = reinterpret_cast<unsigned char*>(stages);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // thread 0 of the warpgroup issues its copies and stores (predicated)
  const bool issuer = threadIdx.x % PP_WG == 0;
  __nv_bfloat16* out =
      stages + PP_STAGES * PP_STAGE_ELEMS + wg * PP_OUT_ELEMS;
  // by the issuer, once its last store has read the staging buffer: the
  // residual rows m .. m + 63 of columns n0 .. n0 + 127 into it
  const auto stage_residual = [&](int m, int n0) {
    bulk_wait<true>();
    mbar_expect_if(issuer, &ring.residual[wg], PP_OUT_BYTES);
    im2col_load_if(issuer, out, &g.res, &ring.residual[wg], g, n0, m,
                   g.lo_res, 1);
    im2col_load_if(issuer, out + PP_BOX_ELEMS, &g.res, &ring.residual[wg],
                   g, n0 + 64, m, g.lo_res, 1);
  };
  // ldmatrix / stmatrix addressing as vit_pingpong.cuh's
  const int row = 16 * (warp & 3) + 8 * ((lane >> 3) & 1) + (lane & 7);
  const int col = 8 * (lane >> 4);
  float acc[HALVES][64];
  for (int j = wg; j < w.tiles; j += CONSUMERS) {
    if (CONSUMERS == 2 && j > 0) named_sync(1 + wg, 2 * PP_WG);
    const int m0 = w.row(g, j);
    const int n0 = w.column(j);
    if (Epilogue::kResidual) stage_residual(m0, n0);
    const int first = q + j * w.nk;
    for (int kt = 0; kt < w.nk; ++kt) {
      if (CODES1 && kt < g.nk1)
        codes_slice(ring, bytes, first + kt, first, acc, kt > 0);
      else
        bf16_slice(ring, bytes, first + kt, first, acc, kt > 0);
    }
    // the other warpgroup may issue its next tile's products
    if (CONSUMERS == 2 && j + 1 < w.tiles) named_arrive(2 - wg, 2 * PP_WG);
    wg_wait<0>();
    pingpong_release(ring, (first + w.nk - 1) % PP_STAGES);
    // the epilogue, a 64-row half h at a time through the staging buffer
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      if (Epilogue::kResidual) {
        // the residual half staged (the second once the first's store has
        // read the buffer)
        if (h == 1) stage_residual(m0 + 64, n0);
        mbar_wait(&ring.residual[wg], h);
      } else {
        // the buffer free: its last store has read it
        bulk_wait<true>();
        named_sync(3 + wg, PP_WG);
      }
#pragma unroll
      for (int tp = 0; tp < 8; ++tp) {
        const int t = 2 * tp;
        const auto c0 = Epilogue::cols(g, n0 + 8 * t + 2 * (lane & 3));
        const auto c1 = Epilogue::cols(g, n0 + 8 * t + 8 + 2 * (lane & 3));
        __nv_bfloat16* p = out + staged(row, 16 * tp + col);
        uint32_t r[4] = {0, 0, 0, 0};
        if (Epilogue::kResidual) ldsm_x4(r, p);
        const uint32_t o[4] = {
            Epilogue::apply(acc[h][4 * t], acc[h][4 * t + 1], c0, r[0]),
            Epilogue::apply(acc[h][4 * t + 2], acc[h][4 * t + 3], c0, r[1]),
            Epilogue::apply(acc[h][4 * t + 4], acc[h][4 * t + 5], c1, r[2]),
            Epilogue::apply(acc[h][4 * t + 6], acc[h][4 * t + 7], c1, r[3])};
        stsm_x4(p, o);
      }
      // the half by TMA, once every thread's writes are visible to it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(3 + wg, PP_WG);
      const int r = w.row_in_part(j) + 64 * h;
      tma_store3_if(issuer, &g.out, out, n0, r, w.part(j));
      tma_store3_if(issuer, &g.out, out + PP_BOX_ELEMS, n0 + 64, r,
                    w.part(j));
      bulk_commit();
    }
  }
  bulk_wait<false>();  // the stores are done before the walk ends
}

// one GEMM in its own launch (K1's conv1 and conv3, K11), its
// kernel-parameter maps acquired as K2's are (conv_gemm_s8.cuh)
template <class Epilogue>
__global__ void __launch_bounds__(PP_THREADS, 1)
    conv_gemm(const __grid_constant__ ConvGemm g) {
  extern __shared__ __align__(128) unsigned char conv_gemm_smem[];
  __shared__ PingPongRing ring;
  unsigned char* stages = align_atoms(conv_gemm_smem);
  if (threadIdx.x == 0) conv_ring_init(ring);
  __syncthreads();
  // the consumers take 232 registers a thread, the producer warpgroup
  // (one thread of which issues the copies) keeps 40
  const int wg = warpgroup();
  if (wg < 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const bool issuer = threadIdx.x % PP_WG == 0;
    tensormap_acquire_if(issuer, &g.out);
    tensormap_acquire_if(issuer && Epilogue::kResidual, &g.res);
    conv_consume<Epilogue>(g, reinterpret_cast<__nv_bfloat16*>(stages),
                           ring, wg, 0);
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const bool issuer = threadIdx.x == 2 * PP_WG;
    tensormap_acquire_if(issuer, &g.a1);
    tensormap_acquire_if(issuer, &g.w1);
    tensormap_acquire_if(issuer && g.nk2 > 0, &g.a2);
    tensormap_acquire_if(issuer && g.nk2 > 0, &g.w2);
    conv_produce(g, stages, ring, 0, issuer);
  }
}

// the persistent grid of a GEMM on tiles of bm rows: one block an SM, at
// most one a tile (ops/bottleneck.py::conv_geometry)
inline cudaError_t conv_grid(const ConvGemm& g, int* grid, int bm = PP_BM) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tiles = (g.part + bm - 1) / bm * g.parts * (g.N / PP_BN);
  *grid = tiles < sms ? tiles : sms;
  return cudaSuccess;
}

template <class Epilogue>
cudaError_t launch_conv_gemm(const ConvGemm& g, cudaStream_t stream) {
  if (g.M < 1 || g.N % PP_BN || g.nk1 < 1) return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = conv_grid(g, &grid);
  if (err != cudaSuccess) return err;
  const auto kernel = conv_gemm<Epilogue>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PP_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, PP_THREADS, PP_SMEM, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace
