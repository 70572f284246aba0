// The int8 bottleneck block's 1x1 convolutions on Hopper (sm_90a): the
// int8 sibling of conv_gemm.cuh's tile, shared by K2 (bottleneck.cu: conv1
// and conv3 of the int8 block) and the int8 mode of the stage kernel
// (stage.cu: K3a, and the banded int8 stage); and the int8-transport
// block's GEMMs (K10a, bottleneck.cu and stage.cu's transport mode), which
// run conv_gemm.cuh's bf16 slices (conv1 with int8 codes as its A) and
// this file's conv3 walk and epilogue on f32 sums (below).
//
//   conv1: h1  = clip(rint(float(A . W1) * a1 + b1), 0, 127)
//   conv3: out = clip(rint((float(A . W3) * a3 + b3) + identity), 0, 127)
//          identity = float(x[:, ::s, ::s] . Wd) * ad + bd  (downsample)
//                   = x * ai                                (otherwise)
//
// int8 codes in, exact int32 sums, every product and sum of the epilogue
// rounded once (no fused multiply-add), round half to even: the
// arithmetic of the plain version (ops/quant.py::bottleneck_reference_q)
// and of K2's earlier mma.sync tile, operation for operation, so the codes
// equal the plain version's. The sums are exact, so the order of k changes
// nothing.
//
// The product is wgmma m64n128k32 .s32.s8.s8, whose int8 operands are
// both K-major in shared memory: A, the NHWC activations [M, K], and W,
// the fold's output-major 1x1 weights [N, K] (ops/quant.py::
// fold_block_params_q), so neither is transposed. A ring slice is 128
// channels deep (a 128-byte swizzle row), A [128][128] and W [128][128]:
// 32 KB a stage, as the bf16 tile's, in the same six-stage ring. K is
// taken in slices of 128; a K of 64 (or any K % 128) reads its tail as
// zeros from the TMA, which add exact zeros.
//
// Reuses conv_gemm.cuh's pieces: the im2col and store maps (element size
// 1), the walk (row bands cut within store parts), the ring and its
// barriers, and K6's ping-pong schedule (two consumer warpgroups in turns,
// a producer warpgroup, setmaxnreg 232 / 40). The epilogue writes each
// code pair (columns n, n + 1 of a row) into a staging buffer in the
// TMA's 128-byte swizzle (a 64-row x 128-channel half tile is one 8 KB
// box) and stores it by TMA; conv3's residual codes come by TMA into the
// same buffer while the tile's products run (one phase of the
// warpgroup's residual barrier a tile) and are read in place. The
// epilogue loads a column pair's scales where it uses them, for both
// halves: with every pair's scales held at once, conv1's and the
// residual's spilled.
//
// The downsample. Its sums and conv3's have different scales, so they are
// kept apart: two int32 accumulator sets. A warpgroup's 128 x 128 tile
// holds 128 accumulators a thread; two sets of that would spill, so a
// GEMM with a second segment takes tiles of 64 x 128 (one m64n128k32 a
// k32 step into each set: 128 accumulators in all). Its A slice is
// [64][128], its stage 24 KB. The stage kernel (one consumer, 64-row
// tiles in every GEMM) still spilled with the two sets: there the
// downsample's segment runs first, its identity (ad, bd applied) goes to
// a scratch in the ring's unwritten bytes, and conv3's sums reuse its
// registers (ID_SMEM; the values are the same).
//
// The transport GEMMs (K10a: int8 codes in and out, bf16 products; the plain
// version is ops/quant.py::bottleneck_reference_t). conv1 is conv_gemm.cuh's
// bf16 GEMM with the codes as A (converted into the bf16 slice in shared
// memory) and K1's epilogue (+ b1, ReLU, bf16 h1). conv3 is the walk below on
// f32 sums: segment 1, h2 . w3, over bf16 slices as K1's, segment 2, the
// downsample x[:, ::s, ::s] . wd, over code slices into its own sums, and the
// epilogue above, clip(rint((acc3 a3 + b3) + identity), 0, 127) with identity
// = accd ad + bd or x ai: the plain version's arithmetic, the two scales
// applied apart. Its tiles are K2's: 128 rows with the residual, 64 with the
// downsample (two sets of 64 accumulators), 64 everywhere in the stage kernel
// (the downsample first, its identity parked, ID_SMEM). Slices are 64 channels
// deep (a bf16 A [BM][64] or codes [BM][64 bytes], the bf16 weights' two
// atoms), so a Cin % 64 reads its tail as zeros.
//
// What bounds it on an H100: at B = 128 tensor-core throughput (1979 TOP/s
// int8; conv3 of layer 4's tail: 2 x 6272 x 1024 x 2048 = 26 GOP on 21 MB,
// 0.013 ms against 0.006 ms of bytes). By count, a 128 x 128 tile's
// products read A and W from shared memory at 96 bytes a cycle at the
// full rate, as the bf16 tile's do at its full rate.

#pragma once

#include <type_traits>

#include "conv_gemm.cuh"

namespace {

constexpr int C8_BK = 128;                  // channels of a ring slice
constexpr int C8_A_BYTES = PP_BM * C8_BK;   // an A slice [128][128]
constexpr int C8_HALF_BYTES = 64 * C8_BK;   // a [64][128] half: one box
static_assert(C8_A_BYTES + PP_BN * C8_BK == PP_STAGE_BYTES,
              "the int8 stage is the bf16 one's 32 KB");
static_assert(2 * C8_HALF_BYTES <= PP_OUT_BYTES,
              "two staged halves fit a warpgroup's staging buffer");

// The three GEMMs of an int8 block: conv1, conv3 with the residual x * ai,
// conv3 with the downsample as a second segment (its own sums).
constexpr int S8_CONV1 = 0;
constexpr int S8_RESIDUAL = 1;
constexpr int S8_DOWNSAMPLE = 2;

// rows of a warpgroup's tile in K2: 128 (two m64 halves), 64 with a
// downsample; the stage kernel takes 64 in every mode (S8_STAGE_ROWS)
__host__ __device__ constexpr int s8_tile_rows(int mode) {
  return mode == S8_DOWNSAMPLE ? 64 : 128;
}
constexpr int S8_STAGE_ROWS = 64;

// One int8 GEMM: conv_gemm.cuh's maps, walk and operand rows (ConvGemm:
// b1 and b2 the biases of the segments), and the scales.
struct ConvGemmS8 : ConvGemm {
  const float* scale1;    // [N] segment 1's scale (conv1's, or conv3's)
  const float* scale2;    // [N] segment 2's (the downsample's), or null
  const float* scale_id;  // [N] the residual's factor, or null
};

// ------------------------------------------------------------ host side

// a TMA map of the row-major int8 [rows, cols] tensor in boxes of
// box_rows x 128 columns (the 128-byte swizzle); columns past cols read
// as zeros
inline cudaError_t s8_map(CUtensorMap* map, const void* base, int rows,
                          int cols, int box_rows) {
  static decltype(&cuTensorMapEncodeTiled) encode = nullptr;
  if (encode == nullptr) {
    const cudaError_t err = entry_point("cuTensorMapEncodeTiled", &encode);
    if (err != cudaSuccess) return err;
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {C8_BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// conv1 of an int8 block on its input rows [lo, hi): x [B, H, W, cin] .
// w1 [width, cin] -> the same rows of h1 [B, H, W, width], on tiles of
// `rows` rows
inline cudaError_t conv1_gemm_s8(ConvGemmS8* g, const void* x,
                                 const void* w1, const float* a1,
                                 const float* b1, void* h1, int B, int H,
                                 int W, int cin, int width, int lo, int hi,
                                 int rows = s8_tile_rows(S8_CONV1)) {
  *g = ConvGemmS8{};
  g->scale1 = a1;
  g->b1 = b1;
  g->M = B * (hi - lo) * W;
  g->N = width;
  g->nk1 = (cin + C8_BK - 1) / C8_BK;
  g->per = (hi - lo) * W;
  g->wo = W;
  g->lo1 = lo;
  g->s1 = 1;
  cudaError_t err =
      im2col_map(&g->a1, x, B, H, W, cin, lo, hi, 1, rows, 1);
  if (err == cudaSuccess) err = s8_map(&g->w1, w1, width, cin, PP_BN);
  if (err == cudaSuccess)
    err = band_store_map(g, h1, B, H, W, width, lo, hi - lo, 1);
  return err;
}

// conv3 of an int8 block on its output rows [lo, hi): h2 [B, Ho, Wo,
// width] . w3 [cout, width] and, with a downsample (wd [cout, cin] not
// null), x [B, H, W, cin] at stride s . wd in its own sums, else the
// residual x (cin == cout, stride 1) -> the same rows of out [B, Ho, Wo,
// cout], on tiles of `rows` rows (0: K2's, s8_tile_rows)
inline cudaError_t conv3_gemm_s8(ConvGemmS8* g, const void* h2,
                                 const void* w3, const float* a3,
                                 const float* b3, const void* x,
                                 const void* wd, const float* ad,
                                 const float* bd, const float* ai, void* out,
                                 int B, int H, int W, int cin, int width,
                                 int cout, int s, int lo, int hi,
                                 int rows = 0) {
  const int Ho = (H - 1) / s + 1;
  const int Wo = (W - 1) / s + 1;
  const bool ds = wd != nullptr;
  if (rows == 0) rows = s8_tile_rows(ds ? S8_DOWNSAMPLE : S8_RESIDUAL);
  *g = ConvGemmS8{};
  g->scale1 = a3;
  g->b1 = b3;
  g->M = B * (hi - lo) * Wo;
  g->N = cout;
  g->nk1 = (width + C8_BK - 1) / C8_BK;
  g->per = (hi - lo) * Wo;
  g->wo = Wo;
  g->lo1 = lo;
  g->s1 = 1;
  cudaError_t err =
      im2col_map(&g->a1, h2, B, Ho, Wo, width, lo, hi, 1, rows, 1);
  if (err == cudaSuccess) err = s8_map(&g->w1, w3, cout, width, PP_BN);
  if (err == cudaSuccess && ds) {
    g->scale2 = ad;
    g->b2 = bd;
    g->nk2 = (cin + C8_BK - 1) / C8_BK;
    g->lo2 = lo * s;
    g->s2 = s;
    err = im2col_map(&g->a2, x, B, H, W, cin, lo * s, (hi - 1) * s + 1, s,
                     rows, 1);
    if (err == cudaSuccess) err = s8_map(&g->w2, wd, cout, cin, PP_BN);
  } else if (err == cudaSuccess) {
    g->scale_id = ai;
    g->lo_res = lo;
    err = im2col_map(&g->res, x, B, H, W, cout, lo, hi, 1, 64, 1);
  }
  if (err == cudaSuccess)
    err = band_store_map(g, out, B, Ho, Wo, cout, lo, hi - lo, 1);
  return err;
}

// K10a's conv1 on its input rows [lo, hi): the codes x [B, H, W, cin] .
// w1 [cin, width] (bf16) -> the same rows of h1 [B, H, W, width] (bf16), on
// tiles of `rows` rows
inline cudaError_t conv1_gemm_t(ConvGemmS8* g, const void* x, const void* w1,
                                const float* b1, void* h1, int B, int H,
                                int W, int cin, int width, int lo, int hi,
                                int rows = PP_BM) {
  *g = ConvGemmS8{};
  g->b1 = b1;
  g->M = B * (hi - lo) * W;
  g->N = width;
  g->nk1 = (cin + CV_BK - 1) / CV_BK;
  g->codes1 = 1;
  g->per = (hi - lo) * W;
  g->wo = W;
  g->lo1 = lo;
  g->s1 = 1;
  cudaError_t err =
      im2col_map(&g->a1, x, B, H, W, cin, lo, hi, 1, rows, 1, 64);
  if (err == cudaSuccess) err = bf16_map(&g->w1, w1, cin, width, CV_BK);
  if (err == cudaSuccess)
    err = band_store_map(g, h1, B, H, W, width, lo, hi - lo);
  return err;
}

// K10a's conv3 on its output rows [lo, hi): h2 [B, Ho, Wo, width] . w3
// [width, cout] (bf16) and, with a downsample (wd [cin, cout] bf16 not
// null), the codes x [B, H, W, cin] at stride s . wd in their own sums,
// else the residual codes x (cin == cout, stride 1) -> the same rows of
// the codes out [B, Ho, Wo, cout], on tiles of `rows` rows (0: K2's,
// s8_tile_rows)
inline cudaError_t conv3_gemm_t(ConvGemmS8* g, const void* h2,
                                const void* w3, const float* a3,
                                const float* b3, const void* x,
                                const void* wd, const float* ad,
                                const float* bd, const float* ai, void* out,
                                int B, int H, int W, int cin, int width,
                                int cout, int s, int lo, int hi,
                                int rows = 0) {
  const int Ho = (H - 1) / s + 1;
  const int Wo = (W - 1) / s + 1;
  const bool ds = wd != nullptr;
  if (rows == 0) rows = s8_tile_rows(ds ? S8_DOWNSAMPLE : S8_RESIDUAL);
  *g = ConvGemmS8{};
  g->scale1 = a3;
  g->b1 = b3;
  g->M = B * (hi - lo) * Wo;
  g->N = cout;
  g->nk1 = (width + CV_BK - 1) / CV_BK;
  g->per = (hi - lo) * Wo;
  g->wo = Wo;
  g->lo1 = lo;
  g->s1 = 1;
  cudaError_t err =
      im2col_map(&g->a1, h2, B, Ho, Wo, width, lo, hi, 1, rows);
  if (err == cudaSuccess) err = bf16_map(&g->w1, w3, width, cout, CV_BK);
  if (err == cudaSuccess && ds) {
    g->scale2 = ad;
    g->b2 = bd;
    g->nk2 = (cin + CV_BK - 1) / CV_BK;
    g->codes2 = 1;
    g->lo2 = lo * s;
    g->s2 = s;
    err = im2col_map(&g->a2, x, B, H, W, cin, lo * s, (hi - 1) * s + 1, s,
                     rows, 1, 64);
    if (err == cudaSuccess) err = bf16_map(&g->w2, wd, cin, cout, CV_BK);
  } else if (err == cudaSuccess) {
    g->scale_id = ai;
    g->lo_res = lo;
    err = im2col_map(&g->res, x, B, H, W, cout, lo, hi, 1, 64, 1);
  }
  if (err == cudaSuccess)
    err = band_store_map(g, out, B, Ho, Wo, cout, lo, hi - lo, 1);
  return err;
}

// ---------------------------------------------------------- device side

// d (+)= A . B on a 64 x 128 x 32 tile by the warpgroup, int8 in, int32
// sums: A and B K-major in shared memory through their descriptors; acc
// false: d = A . B
__device__ __forceinline__ void wgmma_s8_128(int (&d)[64], uint64_t da,
                                            uint64_t db, bool acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(static_cast<int>(acc)));
}

// byte (r, c) of a staged [64][128] half: 128-byte rows, their 16-byte
// chunks in the TMA's 128-byte swizzle
__device__ __forceinline__ int staged_s8(int r, int c) {
  return r * C8_BK + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

__device__ __forceinline__ uint32_t ld_shared_u16(const void* p) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n"
               : "=h"(v)
               : "r"(smem_addr(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_u16(void* p, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(smem_addr(p)),
               "h"(static_cast<unsigned short>(v))
               : "memory");
}

// an accumulator as a float: K2's int32 sums (rounded as the plain
// version converts them), K10a's f32 sums as they are
__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// the code pair of columns n, n + 1 as one 16-bit word
__device__ __forceinline__ uint32_t code_pair(float v0, float v1) {
  return static_cast<uint32_t>(static_cast<uint8_t>(clip_code(v0))) |
         static_cast<uint32_t>(static_cast<uint8_t>(clip_code(v1))) << 8;
}

// two floats at p (8-byte aligned) through the read-only cache; volatile,
// so that the compiler keeps each load beside its use instead of hoisting
// all sixteen column pairs' scales above the epilogue (which then spills)
__device__ __forceinline__ float2 ldg_pair(const float* p) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "l"(p));
  return v;
}

// The epilogue of columns n, n + 1 of a row, clip(rint(...), 0, 127) of
// (conv1) v a1 + b1 or (conv3) (v a3 + b3) + the identity, vd ad + bd
// (the downsample's sums vd) or x ai (the residual code pair x); with
// ID_SMEM the identity comes computed (the scales ad, bd are not loaded).
template <int MODE, bool ID_SMEM = false>
struct ConvEpilogueS8 {
  struct Cols {
    float2 a, b, ad, bd;
  };

  __device__ __forceinline__ static Cols cols(const ConvGemmS8& g, int n) {
    Cols c;
    c.a = ldg_pair(g.scale1 + n);
    c.b = ldg_pair(g.b1 + n);
    if (MODE == S8_DOWNSAMPLE && !ID_SMEM) {
      c.ad = ldg_pair(g.scale2 + n);
      c.bd = ldg_pair(g.b2 + n);
    } else if (MODE == S8_RESIDUAL) {
      c.ad = ldg_pair(g.scale_id + n);
    }
    return c;
  }

  // the identity of the pair: vd ad + bd, or x ai
  template <class Acc>
  __device__ __forceinline__ static float2 identity(Acc vd0, Acc vd1,
                                                    const Cols& c,
                                                    uint32_t r) {
    if (MODE == S8_DOWNSAMPLE)
      return make_float2(madd_rn(to_f32(vd0), c.ad.x, c.bd.x),
                         madd_rn(to_f32(vd1), c.ad.y, c.bd.y));
    return make_float2(
        __fmul_rn(static_cast<float>(static_cast<int8_t>(r & 0xff)), c.ad.x),
        __fmul_rn(static_cast<float>(static_cast<int8_t>(r >> 8)), c.ad.y));
  }

  template <class Acc>
  __device__ __forceinline__ static uint32_t apply(Acc v0, Acc v1,
                                                   float2 id,
                                                   const Cols& c) {
    const float y0 = madd_rn(to_f32(v0), c.a.x, c.b.x);
    const float y1 = madd_rn(to_f32(v1), c.a.y, c.b.y);
    if (MODE == S8_CONV1) return code_pair(y0, y1);
    return code_pair(__fadd_rn(y0, id.x), __fadd_rn(y1, id.y));
  }
};

// the producer: every slice of the block's tiles of g, in order, from ring
// slice q: segment 1's, then segment 2's (SEG2_FIRST: segment 2's, then
// segment 1's). The whole producer warpgroup walks the ring, so that its
// warps keep one path up to a block barrier after it, and its thread
// `issuer` issues the copies in a branch of its own, as conv_produce does.
template <int MODE, int BM = s8_tile_rows(MODE), bool SEG2_FIRST = false>
__device__ __forceinline__ void conv_produce_s8(const ConvGemmS8& g,
                                                unsigned char* stages,
                                                PingPongRing& ring, int q,
                                                bool issuer) {
  const TileWalk<BM> w(g);
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
          * C8_BK;
      if (issuer) {
        mbar_expect(&ring.full[s], (BM + PP_BN) * C8_BK);
        unsigned char* st = stages + s * PP_STAGE_BYTES;
        im2col_load_if(true, st, first ? &g.a1 : &g.a2, &ring.full[s], g, k,
                       m0, first ? g.lo1 : g.lo2, first ? g.s1 : g.s2);
        tma_load(st + C8_A_BYTES, first ? &g.w1 : &g.w2, &ring.full[s], k,
                 n0);
      }
    }
  }
}

// The downsample's identity of row r, columns 8 t + 2 (lane % 4) and + 1
// of a 64 x 128 tile, as two floats in the scratch of a stage kernel's one
// consumer: the second 8 KB of ring stages 0-3, which 64-row A slices
// leave unwritten, 16 rows of 512 bytes a stage, the 8-byte pairs of a
// row in an XOR swizzle (no bank conflicts)
__device__ __forceinline__ unsigned char* id_scratch(unsigned char* stages,
                                                     int r, int t,
                                                     int lane) {
  const int pair = (4 * t + (lane & 3)) ^ ((r & 7) << 2);
  return stages + (r >> 4) * PP_STAGE_BYTES + C8_HALF_BYTES +
         (r & 15) * 512 + pair * 8;
}

__device__ __forceinline__ void st_shared_f2(void* p, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(smem_addr(p)),
               "f"(x), "f"(y)
               : "memory");
}

__device__ __forceinline__ float2 ld_shared_f2(const void* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(smem_addr(p))
               : "memory");
  return v;
}

// a consumer warpgroup's products of ring slice i (the tile's first
// slice: `first`) into d (acc: add to it), then its release of slice i - 1
// unless i is the first
template <int HALVES>
__device__ __forceinline__ void s8_slice(PingPongRing& ring,
                                         const unsigned char* stages, int i,
                                         int first, int (&d)[HALVES][64],
                                         bool acc) {
  const int s = i % PP_STAGES;
  mbar_wait(&ring.full[s], (i / PP_STAGES) & 1);
  const unsigned char* st = stages + s * PP_STAGE_BYTES;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < C8_BK / 32; ++kk) {
    // W [128][128] and A rows 64 h ..: SBO 8 rows x 128 bytes; k32 step kk
    // is 32 bytes into the rows
    const uint64_t db = wg_desc(st + C8_A_BYTES + 32 * kk, 16, 1024, 1);
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      const uint64_t da = wg_desc(st + 64 * h * C8_BK + 32 * kk, 16, 1024, 1);
      wgmma_s8_128(d[h], da, db, acc || kk > 0);
    }
  }
  wg_commit();
  wg_wait<1>();  // the products of the previous slice are done
  if (i > first) pingpong_release(ring, (i - 1) % PP_STAGES);
}

// a slice of conv3's segment 1 (h2: int8 codes in K2, bf16 in K10a) and
// of its segment 2 (the downsample over the block input's int8 codes: K2's
// int8 products, or K10a's codes converted to bf16)
template <bool T, int HALVES, class Acc>
__device__ __forceinline__ void seg1_slice(PingPongRing& ring,
                                           const unsigned char* stages,
                                           int i, int first,
                                           Acc (&d)[HALVES][64], bool acc) {
  if constexpr (T)
    bf16_slice(ring, stages, i, first, d, acc);
  else
    s8_slice(ring, stages, i, first, d, acc);
}

template <bool T, int HALVES, class Acc>
__device__ __forceinline__ void seg2_slice(PingPongRing& ring,
                                           unsigned char* stages,
                                           int i, int first,
                                           Acc (&d)[HALVES][64], bool acc) {
  if constexpr (T)
    codes_slice(ring, stages, i, first, d, acc);
  else
    s8_slice(ring, stages, i, first, d, acc);
}

// warpgroup wg's tiles j = wg, wg + CONSUMERS, ... of g from ring slice
// q: the products of each (with two consumers, after the other warpgroup
// has issued those of tile j - 1), then its epilogue (with two, while the
// other's products run). `parity`: the phase parity of the warpgroup's
// residual barrier, one phase a residual tile, carried across the GEMMs of
// a launch. T: K10a's conv3 (f32 sums of bf16 products, 64-deep slices of
// conv_gemm.cuh's kind), else K2's.
template <int MODE, int CONSUMERS = 2, int BM = s8_tile_rows(MODE),
          bool ID_SMEM = false, bool T = false>
__device__ __forceinline__ void conv_consume_s8(const ConvGemmS8& g,
                                                unsigned char* stages,
                                                PingPongRing& ring, int wg,
                                                int q, int& parity) {
  static_assert(BM == 64 || (BM == 128 && MODE != S8_DOWNSAMPLE),
                "a tile of 128 rows holds one set of sums");
  static_assert(!ID_SMEM || (MODE == S8_DOWNSAMPLE && BM == 64 &&
                             CONSUMERS == 1),
                "the identity's scratch is the one consumer's, beside "
                "64-row A slices");
  static_assert(!T || MODE != S8_CONV1,
                "K10a's conv1 is conv_gemm.cuh's bf16 GEMM");
  constexpr int HALVES = BM / 64;
  using Epi = ConvEpilogueS8<MODE, ID_SMEM>;
  using Acc = std::conditional_t<T, float, int>;
  const TileWalk<BM> w(g);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // thread 0 of the warpgroup issues its copies and stores (predicated)
  const bool issuer = threadIdx.x % PP_WG == 0;
  unsigned char* out = stages + PP_STAGES * PP_STAGE_BYTES + wg * PP_OUT_BYTES;
  // this lane's rows of a 64-row half, and its column in each n8 tile
  const int row = 16 * (warp & 3) + (lane >> 2);
  const int col = 2 * (lane & 3);
  Acc acc[HALVES][64];
  Acc accd[1][64];  // the downsample's sums (S8_DOWNSAMPLE only)
  for (int j = wg; j < w.tiles; j += CONSUMERS) {
    if (CONSUMERS == 2 && j > 0) named_sync(1 + wg, 2 * PP_WG);
    const int m0 = w.row(g, j);
    const int n0 = w.column(j);
    if (MODE == S8_RESIDUAL) {
      // by the issuer, once its last stores have read the buffer: the
      // tile's residual codes (rows m0 .., columns n0 .. n0 + 127), a half
      // a box, into it
      bulk_wait<true>();
      mbar_expect_if(issuer, &ring.residual[wg], HALVES * C8_HALF_BYTES);
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
        im2col_load_if(issuer, out + h * C8_HALF_BYTES, &g.res,
                       &ring.residual[wg], g, n0, m0 + 64 * h, g.lo_res, 1);
    }
    const int first = q + j * w.nk;
    if constexpr (ID_SMEM) {
      // the downsample's sums first, their identity (ad, bd applied) into
      // the scratch, then conv3's sums in the same registers
      for (int kt = 0; kt < g.nk2; ++kt)
        seg2_slice<T>(ring, stages, first + kt, first, acc, kt > 0);
      wg_wait<0>();
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const float2 ad = ldg_pair(g.scale2 + n0 + 8 * t + col);
        const float2 bd = ldg_pair(g.b2 + n0 + 8 * t + col);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = 4 * t + 2 * e;
          st_shared_f2(id_scratch(stages, row + 8 * e, t, lane),
                       madd_rn(to_f32(acc[0][v]), ad.x, bd.x),
                       madd_rn(to_f32(acc[0][v + 1]), ad.y, bd.y));
        }
      }
      for (int kt = 0; kt < g.nk1; ++kt)
        seg1_slice<T>(ring, stages, first + g.nk2 + kt, first, acc, kt > 0);
    } else {
      for (int kt = 0; kt < g.nk1; ++kt)
        seg1_slice<T>(ring, stages, first + kt, first, acc, kt > 0);
      if constexpr (MODE == S8_DOWNSAMPLE) {
        for (int kt = g.nk1; kt < w.nk; ++kt)
          seg2_slice<T>(ring, stages, first + kt, first, accd, kt > g.nk1);
      }
    }
    // the other warpgroup may issue its next tile's products
    if (CONSUMERS == 2 && j + 1 < w.tiles) named_arrive(2 - wg, 2 * PP_WG);
    wg_wait<0>();
    pingpong_release(ring, (first + w.nk - 1) % PP_STAGES);
    if (MODE == S8_RESIDUAL) {
      mbar_wait(&ring.residual[wg], parity);  // the residual codes staged
      parity ^= 1;
    } else {
      // the buffer free: its last stores have read it
      bulk_wait<true>();
      named_sync(3 + wg, PP_WG);
    }
    // the epilogue: the codes into the staging buffer (in place of the
    // residual codes), a column pair's scales at a time
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const auto c = Epi::cols(g, n0 + 8 * t + col);
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          unsigned char* p =
              out + h * C8_HALF_BYTES + staged_s8(row + 8 * e, 8 * t + col);
          const int v = 4 * t + 2 * e;
          float2 id = make_float2(0.0f, 0.0f);
          if constexpr (ID_SMEM)
            id = ld_shared_f2(id_scratch(stages, row + 8 * e, t, lane));
          else if constexpr (MODE == S8_DOWNSAMPLE)
            id = Epi::identity(accd[0][v], accd[0][v + 1], c, 0u);
          else if constexpr (MODE == S8_RESIDUAL)
            id = Epi::identity(0, 0, c, ld_shared_u16(p));
          st_shared_u16(p, Epi::apply(acc[h][v], acc[h][v + 1], id, c));
        }
      }
    }
    // the halves by TMA, once every thread's writes are visible to it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(3 + wg, PP_WG);
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
      tma_store3_if(issuer, &g.out, out + h * C8_HALF_BYTES, n0,
                    w.row_in_part(j) + 64 * h, w.part(j));
    bulk_commit();
  }
  bulk_wait<false>();  // the stores are done before the walk ends
}

// one GEMM in its own launch (K2's conv1 and conv3). The threads that
// copy through the kernel-parameter maps acquire them first: without the
// fence, K2's launches right after cuBLAS's int8 GEMM (torch._int_mm)
// stalled in 3 of 5 runs of the probe's timing loop, with it in none of 7
// (PERF.md)
template <int MODE>
__global__ void __launch_bounds__(PP_THREADS, 1)
    conv_gemm_s8(const __grid_constant__ ConvGemmS8 g) {
  extern __shared__ __align__(128) unsigned char conv_gemm_s8_smem[];
  __shared__ PingPongRing ring;
  unsigned char* stages = align_atoms(conv_gemm_s8_smem);
  if (threadIdx.x == 0) conv_ring_init(ring);
  __syncthreads();
  // the consumers take 232 registers a thread, the producer warpgroup
  // (one thread of which issues the copies) keeps 40
  const int wg = warpgroup();
  if (wg < 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const bool issuer = threadIdx.x % PP_WG == 0;
    tensormap_acquire_if(issuer, &g.out);
    tensormap_acquire_if(issuer && MODE == S8_RESIDUAL, &g.res);
    int parity = 0;
    conv_consume_s8<MODE>(g, stages, ring, wg, 0, parity);
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const bool issuer = threadIdx.x == 2 * PP_WG;
    tensormap_acquire_if(issuer, &g.a1);
    tensormap_acquire_if(issuer, &g.w1);
    tensormap_acquire_if(issuer && MODE == S8_DOWNSAMPLE, &g.a2);
    tensormap_acquire_if(issuer && MODE == S8_DOWNSAMPLE, &g.w2);
    conv_produce_s8<MODE>(g, stages, ring, 0, issuer);
  }
}

// K10a's three GEMMs in their own launches (MODE: S8_CONV1, the codes in
// and bf16 h1 out on conv_gemm.cuh's tile; S8_RESIDUAL, S8_DOWNSAMPLE,
// conv3 with the residual codes or the downsample's own sums), the
// schedule and map acquisition of conv_gemm_s8
template <int MODE>
__global__ void __launch_bounds__(PP_THREADS, 1)
    conv_gemm_t(const __grid_constant__ ConvGemmS8 g) {
  extern __shared__ __align__(128) unsigned char conv_gemm_t_smem[];
  __shared__ PingPongRing ring;
  unsigned char* stages = align_atoms(conv_gemm_t_smem);
  if (threadIdx.x == 0) conv_ring_init(ring);
  __syncthreads();
  constexpr int BM = s8_tile_rows(MODE);
  const int wg = warpgroup();
  if (wg < 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const bool issuer = threadIdx.x % PP_WG == 0;
    tensormap_acquire_if(issuer, &g.out);
    tensormap_acquire_if(issuer && MODE == S8_RESIDUAL, &g.res);
    if constexpr (MODE == S8_CONV1) {
      conv_consume<ConvEpilogue<false, false>, 2, true>(
          g, reinterpret_cast<__nv_bfloat16*>(stages), ring, wg, 0);
    } else {
      int parity = 0;
      conv_consume_s8<MODE, 2, BM, false, true>(g, stages, ring, wg, 0,
                                                parity);
    }
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const bool issuer = threadIdx.x == 2 * PP_WG;
    tensormap_acquire_if(issuer, &g.a1);
    tensormap_acquire_if(issuer, &g.w1);
    tensormap_acquire_if(issuer && MODE == S8_DOWNSAMPLE, &g.a2);
    tensormap_acquire_if(issuer && MODE == S8_DOWNSAMPLE, &g.w2);
    conv_produce<BM>(g, stages, ring, 0, issuer);
  }
}

template <int MODE>
cudaError_t launch_conv_gemm_t(const ConvGemmS8& g, cudaStream_t stream) {
  if (g.M < 1 || g.N % PP_BN || g.nk1 < 1 ||
      (MODE == S8_DOWNSAMPLE) != (g.nk2 > 0))
    return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = conv_grid(g, &grid, s8_tile_rows(MODE));
  if (err != cudaSuccess) return err;
  const auto kernel = conv_gemm_t<MODE>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PP_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, PP_THREADS, PP_SMEM, stream>>>(g);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_conv_gemm_s8(const ConvGemmS8& g, cudaStream_t stream) {
  if (g.M < 1 || g.N % PP_BN || g.nk1 < 1 ||
      (MODE == S8_DOWNSAMPLE) != (g.nk2 > 0))
    return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = conv_grid(g, &grid, s8_tile_rows(MODE));
  if (err != cudaSuccess) return err;
  const auto kernel = conv_gemm_s8<MODE>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PP_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, PP_THREADS, PP_SMEM, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace
