// The grouped 3x3 of one ResNeXt-50 bottleneck block on Hopper (sm_90a),
// shared by the per-block kernels (bottleneck.cu: K1 in bf16, K2 in int8,
// K10a in int8 transport, whose h1 and h2 are bf16) and the whole-stage
// kernel (stage.cu: K3a, K3b, and their transport mode): 32 groups, pad 1,
// stride 1 or 2, as an implicit GEMM on the tensor cores over halo tiles
// (gconv_halo_walk in bf16, gconv_halo_walk_s8 in int8, below).
//
// For one tap, a tile's output pixels read a [pixels, 64] tile of h (the
// tap-shifted input pixels, zero outside the image) and the tap's weights
// form a [64, 64] block-diagonal matrix (input channel x output channel,
// zero across groups). Only its diagonal 16x16 tiles (32x32 when CG = 32)
// are filled and multiplied: a group of 4 channels costs a 16-wide product
// (4x the useful multiplies at CG = 4, 2x at CG = 8, none wasted at CG >=
// 16). h: [*, H, W, C] NHWC; w: [3, 3, CG, C] (tap, input channel within
// the group, output channel); out: the output grid of `rows`, [*, Ho, Wo,
// C]. Output pixel (ho, wo) reads input rows ho*stride-1 .. ho*stride+1.

#pragma once

#include "common.cuh"

namespace {

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

// ------------------------------------------- grouped 3x3 on a halo tile

// four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4_gh(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
      : "memory");
}

// d += a . b on a 16x8x16 tile (bf16 in, f32 sums; the fragments of PTX's
// mma.m16n8k16)
__device__ __forceinline__ void mma_16816_gh(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


// The grouped 3x3 of K1, K10a and the bf16 and transport stages. A worker of
// 128 threads (4 warps, 16 output channels each) keeps one 64-channel tile: it
// builds the block-diagonal B fragments of its channels for all 9 taps once,
// into shared memory, then walks its images' row tiles. A row tile is R output
// rows x cols output columns of one image: the worker copies its input window
// (rows_in x cols_in pixels, zeros outside the image: the halo) into shared
// memory once, and each warp walks the tile's 16-pixel slabs tap by tap, the A
// fragments read from the halo with ldmatrix (chunk c of pixel p at chunk c ^
// (p % 8): no bank conflicts at stride 1), its B fragments from shared memory
// (a lane's own words, no conflicts). Every output's sum runs over the taps in
// order, each tap's k16 step(s) over its group's input channels with the
// others' weights zero (mma.sync m16n8k16): the sums of the earlier wmma tile
// and of K10b's phase 2, so the values are theirs bit for bit. h1 is read once
// a row tile (plus its halo rows) instead of once a tap, and w2 once a worker
// instead of once a tile.
constexpr int GH_THREADS = 128;
constexpr int GH_BN = 64;            // channels of a tile
constexpr int GH_MAX_PIXELS = 128;   // output pixels of a row tile: 8 slabs
constexpr int GH_MAX_HALO = 65536;   // the halo's bytes at most
// the B fragments: 9 taps x up to 2 k16 steps x 2 n8 tiles x 2 registers
// x 32 lanes x 4 warps
constexpr int GH_B_BYTES = 9 * 2 * 2 * 2 * 32 * 4 * 4;
constexpr int GH_SMEM = GH_MAX_HALO + GH_B_BYTES;  // a worker's at most

// The row tiles of one grouped 3x3 over the output rows [lo, lo + ext) of
// every image (ConvArgs::rows), and its channel tiles.
struct HaloTiles {
  int R, cols;          // output rows and columns of a row tile
  int rows_in, cols_in; // its input window
  int nrt, nct;         // row and column tiles an image
  int per_cb, ncb;      // row tiles of a channel tile (B nrt nct), and those
  int smem;             // a worker's bytes: B fragments, then the halo
};

// the B fragments of the int8 walk: 9 taps x up to 2 k16 steps x 2 n8
// tiles x 1 register x 32 lanes x 4 warps
constexpr int GH8_B_BYTES = 9 * 2 * 2 * 32 * 4 * 4;

// the largest R (rows of cols = min(Wo, 128) columns, at most 128 pixels)
// whose halo of 64 channels of esize bytes fits GH_MAX_HALO
inline HaloTiles halo_tiles(int B, int W, int C, int stride, int ext,
                            int esize = 2) {
  HaloTiles t{};
  const int Wo = (W - 1) / stride + 1;
  t.cols = Wo < GH_MAX_PIXELS ? Wo : GH_MAX_PIXELS;
  t.cols_in = (t.cols - 1) * stride + 3;
  t.R = 1;
  for (int R = 2; R <= ext && R * t.cols <= GH_MAX_PIXELS; ++R)
    if (((R - 1) * stride + 3) * t.cols_in * GH_BN * esize <= GH_MAX_HALO)
      t.R = R;
  t.rows_in = (t.R - 1) * stride + 3;
  t.nrt = (ext + t.R - 1) / t.R;
  t.nct = (Wo + t.cols - 1) / t.cols;
  t.per_cb = B * t.nrt * t.nct;
  t.ncb = C / GH_BN;
  t.smem = (esize == 1 ? GH8_B_BYTES : GH_B_BYTES) +
           t.rows_in * t.cols_in * GH_BN * esize;
  return t;
}

// The walk of worker w of n (n >= ncb) by GH_THREADS threads (tid) and
// their named barrier bar (0 when they are the whole block) in smem: the
// channel tile w % ncb, its row tiles w / ncb, + n / ncb, ...
template <int CG>
__device__ __forceinline__ void gconv_halo_walk(const ConvArgs& c,
                                                const HaloTiles& ht, int w,
                                                int n, unsigned char* smem,
                                                int tid, int bar) {
  constexpr int KK = CG > 16 ? 2 : 1;  // k16 steps a tap
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t2 = 2 * (lane & 3);
  const int c0 = (w % ht.ncb) * GH_BN;
  const int stride_w = n / ht.ncb;
  if (w >= stride_w * ht.ncb) return;  // the workers past a whole round
  uint32_t* bsm = reinterpret_cast<uint32_t*>(smem);
  unsigned char* halo = smem + GH_B_BYTES;
  const auto sync = [&] {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(GH_THREADS)
                 : "memory");
  };

  // this warp's 16 output channels and its group's input channels; the
  // block-diagonal B fragments of all 9 taps: rows (input channels) t2,
  // t2 + 1 and + 8, column (output channel) g of each n8 tile, at
  // bsm[(((warp * 9 + tap) * KK + kk) * 2 + nt) * 2 + h][lane]
  const int co0 = c0 + 16 * warp;
  const int kin = CG > 16 ? (warp >> 1) * 32 : 16 * warp;  // in the tile
  const unsigned short* w2 = reinterpret_cast<const unsigned short*>(c.w);
  for (int f = 0; f < 9 * KK * 4; ++f) {
    const int h = f & 1;
    const int nt = (f >> 1) & 1;
    const int kk = (f >> 2) % KK;
    const int tap = (f >> 2) / KK;
    const int co = co0 + nt * 8 + g;
    uint32_t pair = 0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ci = c0 + kin + kk * 16 + t2 + 8 * h + e;
      const uint32_t wv = ci / CG == co / CG
                              ? __ldg(w2 + (tap * CG + ci % CG) * c.C + co)
                              : 0u;
      pair |= wv << (16 * e);
    }
    bsm[(warp * 9 * KK * 4 + f) * 32 + lane] = pair;
  }

  const int Wo = c.rows.W;
  const int s = c.stride;
  const int ext = c.rows.ext ? c.rows.ext : c.rows.H;
  for (int u = w / ht.ncb; u < ht.per_cb; u += stride_w) {
    const int ct = u % ht.nct;
    const int rt = (u / ht.nct) % ht.nrt;
    const int b = u / (ht.nct * ht.nrt);
    const int orow0 = c.rows.lo + rt * ht.R;  // the tile's first output row
    const int ocol0 = ct * ht.cols;
    const int R = min(ht.R, c.rows.lo + ext - orow0);
    const int cols = min(ht.cols, Wo - ocol0);
    const int P = R * cols;

    // the halo: input rows orow0 s - 1 .., columns ocol0 s - 1 .., 8
    // chunks of 8 channels a pixel
    const int ir0 = orow0 * s - 1;
    const int ic0 = ocol0 * s - 1;
    for (int v = tid; v < ht.rows_in * ht.cols_in * 8; v += GH_THREADS) {
      const int px = v >> 3;
      const int ch = v & 7;
      const int ir = ir0 + px / ht.cols_in;
      const int ic = ic0 + px % ht.cols_in;
      const bool ok = ir >= 0 && ir < c.H && ic >= 0 && ic < c.W;
      const __nv_bfloat16* src =
          ok ? c.h + ((static_cast<size_t>(b) * c.H + ir) * c.W + ic) * c.C +
                   c0 + 8 * ch
             : c.h;
      cp_async16(halo + px * 128 + ((ch ^ (px & 7)) << 4), src, ok);
    }
    cp_async_commit();

    // this lane's window pixel at tap (0, 0) for each slab (its row of the
    // slab: lane % 16); pixels past P repeat pixel 0 (their sums are not
    // stored)
    int p0[GH_MAX_PIXELS / 16];
#pragma unroll
    for (int mt = 0; mt < GH_MAX_PIXELS / 16; ++mt) {
      const int m = mt * 16 + (lane & 15);
      const int r = m / cols;
      p0[mt] = m < P ? r * s * ht.cols_in + (m - r * cols) * s : 0;
    }
    float acc[GH_MAX_PIXELS / 16][2][4];
#pragma unroll
    for (int mt = 0; mt < GH_MAX_PIXELS / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
            acc[mt][nt][3] = 0.0f;
    const int MT = (P + 15) / 16;
    cp_async_wait<0>();
    sync();  // the halo (and, the first time, the B fragments) in place

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * ht.cols_in + tap % 3;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const int ch = (kin + kk * 16) / 8 + (lane >> 4);
        const uint32_t* bf =
            bsm + (warp * 9 * KK * 4 + (tap * KK + kk) * 4) * 32 + lane;
        const uint32_t b00 = bf[0], b01 = bf[32], b10 = bf[64],
                       b11 = bf[96];
#pragma unroll
        for (int mt = 0; mt < GH_MAX_PIXELS / 16; ++mt) {
          if (mt >= MT) continue;
          const int px = p0[mt] + shift;
          uint32_t a[4];
          ldsm_x4_gh(a, halo + px * 128 + ((ch ^ (px & 7)) << 4));
          mma_16816_gh(acc[mt][0], a, b00, b01);
          mma_16816_gh(acc[mt][1], a, b10, b11);
        }
      }
    }

    // h2 = bf16(relu(acc + b2)) at the tile's output pixels
#pragma unroll
    for (int mt = 0; mt < GH_MAX_PIXELS / 16; ++mt) {
      if (mt >= MT) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int co = co0 + nt * 8 + t2;
        const float bb0 = __ldg(c.bias + co);
        const float bb1 = __ldg(c.bias + co + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g + 8 * h;
          if (m >= P) continue;
          const int r = m / cols;
          const size_t px =
              (static_cast<size_t>(b) * c.rows.H + orow0 + r) * Wo + ocol0 +
              (m - r * cols);
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              fmaxf(acc[mt][nt][2 * h] + bb0, 0.0f),
              fmaxf(acc[mt][nt][2 * h + 1] + bb1, 0.0f));
          *reinterpret_cast<__nv_bfloat162*>(c.out + px * c.C + co) = v;
        }
      }
    }
    sync();  // the next tile's halo overwrites this one's
  }
}

// two 8x8 b16 matrices from shared memory (16 rows of 16 int8 channels);
// lanes 0-15 give the addresses of rows 0-15
__device__ __forceinline__ void ldsm_x2_gh(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
      : "memory");
}

// d += a . b on a 16x8x16 tile (int8 in, int32 sums; the fragments of
// PTX's mma.m16n8k16 .s8: a rows g and g + 8, channels 4 (lane % 4) ..
// + 3; b channels 4 (lane % 4) .. + 3 of column g)
__device__ __forceinline__ void mma_s8_16816_gh(int (&d)[4],
                                                const uint32_t (&a)[2],
                                                uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// K2's and the int8 stage's grouped 3x3: gconv_halo_walk's tiles, workers
// and order on int8 codes. A pixel of the halo is 64 bytes, its four
// 16-byte chunks at chunk ^ (pixel / 2 % 4) (no bank conflicts at stride
// 1); each warp's B fragments (one register a k16 step and n8 tile) are
// built once into shared memory. int32 sums over the taps, each tap's
// k16 step(s) over the group's input channels (mma.sync m16n8k16 .s8:
// at CG = 16 a step is one group, with no zero products); the epilogue
// clip(rint(acc * a + bias), 0, 127), product and sum each rounded once.
// The sums are exact, so the codes are those of any order.
template <int CG>
__device__ __forceinline__ void gconv_halo_walk_s8(const ConvArgsS8& c,
                                                   const HaloTiles& ht,
                                                   int w, int n,
                                                   unsigned char* smem,
                                                   int tid, int bar) {
  constexpr int KK = CG > 16 ? 2 : 1;  // k16 steps a tap
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int c0 = (w % ht.ncb) * GH_BN;
  const int stride_w = n / ht.ncb;
  if (w >= stride_w * ht.ncb) return;  // the workers past a whole round
  uint32_t* bsm = reinterpret_cast<uint32_t*>(smem);
  unsigned char* halo = smem + GH8_B_BYTES;
  const auto sync = [&] {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(GH_THREADS)
                 : "memory");
  };

  // this warp's 16 output channels and its group's input channels; the
  // block-diagonal B fragments of all 9 taps: channels 4 t4 .. + 3 of the
  // k16 step (rows), output channel g of each n8 tile, at
  // bsm[((warp * 9 + tap) * KK + kk) * 2 + nt][lane]
  const int co0 = c0 + 16 * warp;
  const int kin = CG > 16 ? (warp >> 1) * 32 : 16 * warp;  // in the tile
  const unsigned char* w2 = reinterpret_cast<const unsigned char*>(c.w);
  for (int f = 0; f < 9 * KK * 2; ++f) {
    const int nt = f & 1;
    const int kk = (f >> 1) % KK;
    const int tap = (f >> 1) / KK;
    const int co = co0 + nt * 8 + g;
    uint32_t quad = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = c0 + kin + kk * 16 + 4 * t4 + e;
      const uint32_t wv = ci / CG == co / CG
                              ? __ldg(w2 + (tap * CG + ci % CG) * c.C + co)
                              : 0u;
      quad |= wv << (8 * e);
    }
    bsm[(warp * 9 * KK * 2 + f) * 32 + lane] = quad;
  }

  const int Wo = c.rows.W;
  const int s = c.stride;
  const int ext = c.rows.ext ? c.rows.ext : c.rows.H;
  for (int u = w / ht.ncb; u < ht.per_cb; u += stride_w) {
    const int ct = u % ht.nct;
    const int rt = (u / ht.nct) % ht.nrt;
    const int b = u / (ht.nct * ht.nrt);
    const int orow0 = c.rows.lo + rt * ht.R;  // the tile's first output row
    const int ocol0 = ct * ht.cols;
    const int R = min(ht.R, c.rows.lo + ext - orow0);
    const int cols = min(ht.cols, Wo - ocol0);
    const int P = R * cols;

    // the halo: input rows orow0 s - 1 .., columns ocol0 s - 1 .., 4
    // chunks of 16 channels a pixel
    const int ir0 = orow0 * s - 1;
    const int ic0 = ocol0 * s - 1;
    for (int v = tid; v < ht.rows_in * ht.cols_in * 4; v += GH_THREADS) {
      const int px = v >> 2;
      const int ch = v & 3;
      const int ir = ir0 + px / ht.cols_in;
      const int ic = ic0 + px % ht.cols_in;
      const bool ok = ir >= 0 && ir < c.H && ic >= 0 && ic < c.W;
      const int8_t* src =
          ok ? c.h + ((static_cast<size_t>(b) * c.H + ir) * c.W + ic) * c.C +
                   c0 + 16 * ch
             : c.h;
      cp_async16(halo + px * 64 + ((ch ^ ((px >> 1) & 3)) << 4), src, ok);
    }
    cp_async_commit();

    // this lane's window pixel at tap (0, 0) for each slab (its row of the
    // slab: lane % 16); pixels past P repeat pixel 0 (their sums are not
    // stored)
    int p0[GH_MAX_PIXELS / 16];
#pragma unroll
    for (int mt = 0; mt < GH_MAX_PIXELS / 16; ++mt) {
      const int m = mt * 16 + (lane & 15);
      const int r = m / cols;
      p0[mt] = m < P ? r * s * ht.cols_in + (m - r * cols) * s : 0;
    }
    int acc[GH_MAX_PIXELS / 16][2][4];
#pragma unroll
    for (int mt = 0; mt < GH_MAX_PIXELS / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] =
            0;
    const int MT = (P + 15) / 16;
    cp_async_wait<0>();
    sync();  // the halo (and, the first time, the B fragments) in place

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * ht.cols_in + tap % 3;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const int ch = (kin + kk * 16) / 16;
        const uint32_t* bf =
            bsm + (warp * 9 * KK * 2 + (tap * KK + kk) * 2) * 32 + lane;
        const uint32_t b0 = bf[0], b1 = bf[32];
#pragma unroll
        for (int mt = 0; mt < GH_MAX_PIXELS / 16; ++mt) {
          if (mt >= MT) continue;
          const int px = p0[mt] + shift;
          uint32_t a[2];
          ldsm_x2_gh(a, halo + px * 64 + ((ch ^ ((px >> 1) & 3)) << 4));
          mma_s8_16816_gh(acc[mt][0], a, b0);
          mma_s8_16816_gh(acc[mt][1], a, b1);
        }
      }
    }

    // h2 = clip(rint(acc * a + b2), 0, 127) at the tile's output pixels
#pragma unroll
    for (int mt = 0; mt < GH_MAX_PIXELS / 16; ++mt) {
      if (mt >= MT) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int co = co0 + nt * 8 + 2 * t4;
        const float a0 = __ldg(c.a + co), a1 = __ldg(c.a + co + 1);
        const float bb0 = __ldg(c.bias + co), bb1 = __ldg(c.bias + co + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g + 8 * h;
          if (m >= P) continue;
          const int r = m / cols;
          const size_t px =
              (static_cast<size_t>(b) * c.rows.H + orow0 + r) * Wo + ocol0 +
              (m - r * cols);
          const uint32_t q0 = static_cast<uint8_t>(clip_code(
              madd_rn(__int2float_rn(acc[mt][nt][2 * h]), a0, bb0)));
          const uint32_t q1 = static_cast<uint8_t>(clip_code(
              madd_rn(__int2float_rn(acc[mt][nt][2 * h + 1]), a1, bb1)));
          *reinterpret_cast<uint16_t*>(c.out + px * c.C + co) =
              static_cast<uint16_t>(q0 | q1 << 8);
        }
      }
    }
    sync();  // the next tile's halo overwrites this one's
  }
}

}  // namespace
