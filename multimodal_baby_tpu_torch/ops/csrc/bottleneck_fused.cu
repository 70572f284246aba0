// K10b: one ResNeXt-50 bottleneck block in bf16 (K1's function) as ONE
// launch on Hopper (sm_90a), with h1 and h2 in shared memory:
//
//   h1  = bf16(relu(x . w1 + b1))
//   h2  = bf16(relu(grouped3x3(h1, w2, stride) + b2))   32 groups, pad 1
//   out = bf16(relu(h2 . w3 + b3 + identity))
//         identity = x[:, ::s, ::s] . wd + bd (head blocks), x (others)
//
// Replaces the TPU kernel multimodal_baby_tpu/ops/bottleneck_hwbc.py::
// fused_bottleneck_tiles (Pallas body `_kernel`, called once per batch
// chunk and band of an XLA scan only because of XLA's VMEM budget), which
// runs the chain per tile with h1 and h2 in VMEM, reading x once and
// writing the output once. Here a block takes one (image, band of R output
// rows): it computes h1 on the band's input window (R - 1) s + 3 rows high
// (the halo rows are recomputed by the neighbouring band, 1.25x conv1 at
// layer 2's head), the grouped 3x3 into h2, then conv3 and the downsample
// straight to the output. h1 and h2 never leave shared memory.
//
// What bounds it on an H100: by its work, operations (layer 2's head at B
// = 128: 108.9 GFLOP, 0.110 ms at 989 TFLOP/s, against 308 MB of
// activations, 0.092 ms at 3.35 TB/s). As built, the L2 stream of the
// weights: a block of 2 output rows reads w1 once per 64-row pass of its
// window (5 at layer 2's head) and w3 and wd once, ~1.4 MB a block, ~2.4 GB
// a call from L2 (scripts/probe_tiles.py takes the time apart; PERF.md).
//
// Design. 256 threads: 8 warps, two warpgroups, one block per SM (the
// shared memory). The two 1x1 products (conv1 on the window's pixels;
// conv3 with the downsample as extra depth, [h2 | x[::s, ::s]] . [w3; wd],
// one f32 accumulator) run on wgmma in passes of 64 rows x 256 columns,
// each warpgroup a m64n128k16 tile (64 f32 accumulators a thread), fed by
// a four-stage cp.async ring of 32-deep slices: the x rows of the pass
// ([64][32] K-major, 64-byte swizzle) and the weight slice (four [32][64]
// MN-major atoms, 128-byte swizzle: the layouts of K8c's projection,
// attention.cu). The slices of all of a phase's passes stream through the
// ring as one sequence, the copies two slices ahead, one wgmma group in
// flight. conv3's h2 operand is read by wgmma from shared memory in place:
// h2 is written in the same K-major layout ([width / 32][rows][32]).
// conv3's epilogue transposes packed pairs within each quad of lanes so
// that a lane stores 16 contiguous bytes of the output. The grouped 3x3
// runs on mma.sync m16n8k16: a warp owns 16 output channels (their
// diagonal block, 16 or 32 input channels) and walks the band's 16-pixel
// tiles, each tap's A fragment gathered by ldmatrix with one address a
// lane (the tap-shifted window pixel; h1 keeps a zero column each side and
// zero rows outside the image), its block-diagonal B fragments built in
// registers from the compact [3, 3, cg, W] weight (copied into the free
// shared memory first where it fits: width <= 256). h1 is [rows_in][W +
// 2][width] (chunk c of pixel p at c ^ (p ^ p / 8) % 8, so that stride-1
// and stride-2 gathers hit 8 bank groups).
// Shared memory (1 KB aligned for the swizzle atoms): h1, then h2; conv1's
// ring sits where h2 will be, conv3's where h1 was
// (ops/bottleneck.py::tiles_geometry places them and picks R). Layer 2's
// head (56 x 56 x 256 -> 28 x 28 x 512, width 256): R = 2, a 5 x 58 pixel
// window (148,480 bytes of h1), h2 32,768 bytes, the ring 81,920: 231,424
// bytes with the alignment slack, 1,792 blocks at B = 128. ptxas
// (chip_smoke.py phase 1): 255 registers, 32 bytes of spill stores (cg <=
// 16), 204 (cg 32).
//
// Each output's sums run in K1's order (conv1 and conv3 over k16 steps in
// order, the downsample after h2; the grouped 3x3 tap by tap; the same
// bias, residual and rounding steps): its values are K1's, bit for bit at
// every ResNeXt-50 block shape on the card (tests/test_torch_cuda.py).

#include "wgmma.cuh"

namespace {

constexpr int FB_THREADS = 256;  // two warpgroups
constexpr int FB_BM = 64;        // rows of a GEMM pass
constexpr int FB_BN = 256;       // columns of a pass: 128 a warpgroup
constexpr int FB_BK = 32;        // depth of a ring slice
constexpr int FB_STAGES = 4;     // ring depth: copies 2 slices ahead, one
                                 // wgmma group in flight
constexpr int FB_A_ELEMS = FB_BM * FB_BK;  // an x slice [64][32]
constexpr int FB_STAGE_ELEMS = FB_A_ELEMS + FB_BK * FB_BN;

struct FusedArgs {
  const __nv_bfloat16* x;   // [B, H, W, cin]
  const __nv_bfloat16* w1;  // [cin, width]
  const float* b1;
  const __nv_bfloat16* w2;  // [3, 3, cg, width]
  const float* b2;
  const __nv_bfloat16* w3;  // [width, cout]
  const float* b3;
  const __nv_bfloat16* wd;  // [cin, cout], or null
  const float* bd;
  __nv_bfloat16* out;       // [B, Ho, Wo, cout]
  int H, W, cin, width, cout, stride, Ho, Wo;
  int R, rows_in;                    // output rows a band; window rows
  int h2_off, ring1_off, ring3_off;  // bytes into shared memory
  int w2_off;  // w2's copy for the grouped 3x3, or -1: read in place
};

// element (r, c) of a K-major [rows][32] tile with the 64-byte swizzle
// (the 16-byte chunk c / 8 of row r at c / 8 ^ r / 2 % 4), as wgmma reads
// it: a ring A slice, and each 32-column block of h2
__device__ __forceinline__ int fa(int r, int c) {
  return r * FB_BK + ((((c >> 3) ^ (r >> 1)) & 3) << 3) + (c & 7);
}

// element (k, n) of a ring B slice: four MN-major [32][64] atoms with the
// 128-byte swizzle
__device__ __forceinline__ int fb(int k, int n) {
  return (n >> 6) * (FB_BK * 64) + sw64(k, n & 63);
}

// chunk ch of window pixel p of h1
__device__ __forceinline__ int fh1(int p, int ch, int width) {
  return p * width + ((ch ^ ((p ^ (p >> 3)) & 7)) << 3);
}


// The GEMM passes of one phase: npm row passes (64 rows; rows past the
// valid ones are computed and not stored) x npn column passes (256
// columns, n_valid in all; warpgroup wg takes columns 128 wg .. on a
// m64n128k16 tile), row pass outer, nk 32-deep slices a pass, as one
// stream of slices through the ring, across pass boundaries. Step i waits
// for slice i, lets one wgmma group stay in flight (slice i - 1's), refills
// the stage of slice i - 2 with slice i + 2 and issues slice i's products.
// load(pm, pn, kt, stage) issues a slice's copies (not committed);
// adesc(pm, kt, kk, stage) is the A descriptor of k16 step kk;
// epi(pm, pn, acc) takes the warpgroup's finished 64 x 128 tile (a
// warpgroup whose columns are past n_valid skips both). Every thread of
// the block calls it; it ends with the ring free again.
template <class Load, class ADesc, class Epi>
__device__ __forceinline__ void gemm_phase(int npm, int npn, int nk,
                                           int n_valid, __nv_bfloat16* ring,
                                           const Load& load,
                                           const ADesc& adesc,
                                           const Epi& epi) {
  const int wg = threadIdx.x >> 7;
  const int steps = npm * npn * nk;
  const auto stage = [&](int i) {
    return ring + (i % FB_STAGES) * FB_STAGE_ELEMS;
  };
  const auto issue = [&](int i) {
    if (i < steps) {
      const int pass = i / nk;
      load(pass / npn, pass % npn, i - pass * nk, stage(i));
    }
    cp_async_commit();
  };
  float acc[64];
#pragma unroll
  for (int s = 0; s < FB_STAGES - 2; ++s) issue(s);
  for (int i = 0; i < steps; ++i) {
    const int pass = i / nk;
    const int kt = i - pass * nk;
    const int pm = pass / npn;
    const int pn = pass - pm * npn;
    cp_async_wait<FB_STAGES - 3>();  // slice i has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_wait<1>();     // this warpgroup's products of slice i - 2 are done
    __syncthreads();  // and every warpgroup's: that stage may be refilled
    issue(i + FB_STAGES - 2);
    if (pn * FB_BN + wg * 128 >= n_valid) continue;
    const __nv_bfloat16* st = stage(i);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < FB_BK / 16; ++kk)
      // B: LBO one atom (4 KB), SBO 8 rows x 128 bytes
      wgmma_128(acc, adesc(pm, kt, kk, st),
                wg_desc(st + FB_A_ELEMS + fb(16 * kk, 128 * wg), FB_BK * 128,
                        1024, 1),
                kt > 0 || kk > 0);
    wg_commit();
    if (kt == nk - 1) {
      wg_wait<0>();
      epi(pm, pn, acc);
    }
  }
  cp_async_wait<0>();
  wg_wait<0>();
  __syncthreads();  // the ring is free again
}

// a ring weight slice: rows k0 .. k0 + 31 of w [K, N], columns n0 .. n0 +
// 255 (zeros past N)
__device__ __forceinline__ void load_b(__nv_bfloat16* stage,
                                       const __nv_bfloat16* w, int N, int k0,
                                       int n0) {
  __nv_bfloat16* bs = stage + FB_A_ELEMS;
#pragma unroll
  for (int i = 0; i < FB_BK * FB_BN / 8 / FB_THREADS; ++i) {
    const int v = threadIdx.x + i * FB_THREADS;
    const int k = v >> 5;
    const int c = (v & 31) * 8;
    const bool ok = n0 + c < N;
    cp_async16(bs + fb(k, c),
               ok ? w + static_cast<size_t>(k0 + k) * N + n0 + c : w, ok);
  }
}

template <int CG>
__global__ void __launch_bounds__(FB_THREADS, 1)
    bottleneck_fused(const FusedArgs p) {
  extern __shared__ __align__(128) unsigned char fused_smem[];
  // the swizzle atoms need 1024-byte alignment (the geometry adds the slack)
  unsigned char* base =
      fused_smem + ((1024 - (smem_addr(fused_smem) & 1023)) & 1023);
  __nv_bfloat16* h1 = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* h2 = reinterpret_cast<__nv_bfloat16*>(base + p.h2_off);
  __nv_bfloat16* ring1 =
      reinterpret_cast<__nv_bfloat16*>(base + p.ring1_off);
  __nv_bfloat16* ring3 =
      reinterpret_cast<__nv_bfloat16*>(base + p.ring3_off);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;        // warpgroup: columns 128 wg .. of a pass
  const int wrow = 16 * (warp & 3);  // its warp's first row of a pass
  const int g = lane >> 2;
  const int t2 = 2 * (lane & 3);
  const int b = blockIdx.y;
  const int ro0 = blockIdx.x * p.R;
  const int rows_out = min(p.R, p.Ho - ro0);
  const int M = rows_out * p.Wo;                   // output pixels
  const int Mr = (M + 15) & ~15;                   // h2 rows
  const int rows_eff = (rows_out - 1) * p.stride + 3;
  const int P1 = rows_eff * p.W;                   // window pixels
  const int ri0 = ro0 * p.stride - 1;              // window row 0
  const int Wp = p.W + 2;
  const int width = p.width;

  // h1's zero columns (window columns -1 and W)
  for (int v = tid; v < p.rows_in * 2 * (width / 8); v += FB_THREADS) {
    const int ch = v % (width / 8);
    const int rc = v / (width / 8);
    const int px = (rc >> 1) * Wp + (rc & 1) * (p.W + 1);
    *reinterpret_cast<uint4*>(h1 + fh1(px, ch, width)) =
        make_uint4(0, 0, 0, 0);
  }

  // ---- phase 1: h1 = bf16(relu(x . w1 + b1)) on the window's pixels;
  // thread tid copies 16 bytes of x row tid / 4 of a pass at every slice
  const int ar = tid >> 2;
  const int ac = tid & 3;
  gemm_phase(
      (P1 + FB_BM - 1) / FB_BM, (width + FB_BN - 1) / FB_BN, p.cin / FB_BK,
      width, ring1,
      [&](int pm, int pn, int kt, __nv_bfloat16* st) {
        const int am = pm * FB_BM + ar;
        const int j = am / p.W;
        const int ri = ri0 + j;
        const bool ok = am < P1 && ri >= 0 && ri < p.H;
        cp_async16(st + fa(ar, ac * 8),
                   ok ? p.x + ((static_cast<size_t>(b) * p.H + ri) * p.W +
                               am - j * p.W) * p.cin + kt * FB_BK + ac * 8
                      : p.x,
                   ok);
        load_b(st, p.w1, width, kt * FB_BK, pn * FB_BN);
      },
      [&](int, int, int kk, const __nv_bfloat16* st) {
        // SBO 8 rows x 64 bytes; k16 step kk 32 bytes into the rows
        return wg_desc(st + 16 * kk, 16, 8 * FB_BK * 2, 2);
      },
      [&](int pm, int pn, const float(&acc)[64]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = pm * FB_BM + wrow + g + 8 * h;
          if (m >= P1) continue;
          const int j = m / p.W;
          const int ri = ri0 + j;
          const bool in = ri >= 0 && ri < p.H;
          const int px = j * Wp + m - j * p.W + 1;
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            const int n = pn * FB_BN + wg * 128 + 8 * t + t2;
            const float v0 = fmaxf(acc[4 * t + 2 * h] + p.b1[n], 0.0f);
            const float v1 = fmaxf(acc[4 * t + 2 * h + 1] + p.b1[n + 1], 0.0f);
            *reinterpret_cast<uint32_t*>(h1 + fh1(px, n >> 3, width) +
                                         (n & 7)) =
                in ? pack_bf16(v0, v1) : 0u;
          }
        }
      });
  __syncthreads();  // h1 complete

  // ---- phase 2: h2 = bf16(relu(grouped3x3(h1) + b2)); a warp owns 16
  // output channels and walks the band's 16-pixel tiles (at most 8)
  {
    constexpr int KK = CG > 16 ? 2 : 1;  // k16 steps a tap
    const int MT = (M + 15) / 16;
    int p0[8];  // this lane's window pixel at tap (0, 0), per tile
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      const int m = mt * 16 + (lane & 15);
      const int orow = m / p.Wo;
      p0[mt] = m < M ? orow * p.stride * Wp + (m - orow * p.Wo) * p.stride
                     : 0;
    }
    // w2 [3, 3, cg, width] copied once into the shared memory that is free
    // during this phase where it fits, else read in place
    const unsigned short* w2 =
        reinterpret_cast<const unsigned short*>(p.w2);
    if (p.w2_off >= 0) {
      unsigned char* ws = base + p.w2_off;
      for (int v = tid; v < 9 * CG * width / 8; v += FB_THREADS)
        cp_async16(ws + 16 * v, p.w2 + 8 * v, true);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      w2 = reinterpret_cast<const unsigned short*>(ws);
    }
    for (int cb = warp; cb < width / 16; cb += FB_THREADS / 32) {
      const int kbase = CG > 16 ? (cb >> 1) * 32 : cb * 16;
      float c2[8][2][4];
#pragma unroll
      for (int mt = 0; mt < 8; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          c2[mt][nt][0] = c2[mt][nt][1] = c2[mt][nt][2] = c2[mt][nt][3] =
              0.0f;
      // the block-diagonal B fragments of all 9 taps, loaded before the
      // products (their loads in flight together): rows (input channels)
      // 2t, 2t + 1 and + 8, column (output channel) g of each n8 tile
      uint32_t bw[9][KK][2][2];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int co = cb * 16 + nt * 8 + g;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t pair = 0;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int ci = kbase + kk * 16 + t2 + 8 * h + e;
                const uint32_t wv =
                    ci / CG == co / CG
                        ? w2[(tap * CG + ci % CG) * width + co]
                        : 0u;
                pair |= wv << (16 * e);
              }
              bw[tap][kk][nt][h] = pair;
            }
          }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int shift = (tap / 3) * Wp + tap % 3;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          const int ch = (kbase + kk * 16) / 8 + (lane >> 4);
#pragma unroll
          for (int mt = 0; mt < 8; ++mt) {
            if (mt >= MT) continue;
            uint32_t a[4];
            ldsm_x4(a, h1 + fh1(p0[mt] + shift, ch, width));
            mma_bf16(c2[mt][0], a, bw[tap][kk][0][0], bw[tap][kk][0][1]);
            mma_bf16(c2[mt][1], a, bw[tap][kk][1][0], bw[tap][kk][1][1]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        if (mt >= MT) continue;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int co = cb * 16 + nt * 8 + t2;
          const float bb0 = p.b2[co], bb1 = p.b2[co + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = mt * 16 + g + 8 * h;
            if (m >= M) continue;
            *reinterpret_cast<uint32_t*>(h2 + (co >> 5) * Mr * FB_BK +
                                         fa(m, co & 31)) =
                pack_bf16(fmaxf(c2[mt][nt][2 * h] + bb0, 0.0f),
                          fmaxf(c2[mt][nt][2 * h + 1] + bb1, 0.0f));
          }
        }
      }
    }
  }
  __syncthreads();  // h2 complete, h1 free (conv3's ring may take it)

  // ---- phase 3: out = bf16(relu(h2 . w3 + b3 [+ x_s . wd + bd | + x]))
  const int kw = width / FB_BK;  // slices of the h2 segment
  const int nk = kw + (p.wd != nullptr ? p.cin / FB_BK : 0);
  gemm_phase(
      (M + FB_BM - 1) / FB_BM, (p.cout + FB_BN - 1) / FB_BN, nk, p.cout,
      ring3,
      [&](int pm, int pn, int kt, __nv_bfloat16* st) {
        if (kt < kw) {
          load_b(st, p.w3, p.cout, kt * FB_BK, pn * FB_BN);
          return;
        }
        // the downsample's x row at output pixel am (stride s)
        const int am = pm * FB_BM + ar;
        const int orow = am / p.Wo;
        const bool ok = am < M;
        cp_async16(st + fa(ar, ac * 8),
                   ok ? p.x + ((static_cast<size_t>(b) * p.H +
                                (ro0 + orow) * p.stride) * p.W +
                               (am - orow * p.Wo) * p.stride) * p.cin +
                            (kt - kw) * FB_BK + ac * 8
                      : p.x,
                   ok);
        load_b(st, p.wd, p.cout, (kt - kw) * FB_BK, pn * FB_BN);
      },
      [&](int pm, int kt, int kk, const __nv_bfloat16* a) {
        // h2's column block kt, rows 64 pm .. (rows past Mr read the next
        // block or the memory after h2: their outputs are not stored)
        if (kt < kw) a = h2 + (kt * Mr + pm * FB_BM) * FB_BK;
        return wg_desc(a + 16 * kk, 16, 8 * FB_BK * 2, 2);
      },
      [&](int pm, int pn, const float(&acc)[64]) {
        // each quad of lanes holds 2 columns of every n8 tile of its rows;
        // a 4 x 4 transpose of packed pairs in the quad gives lane q all 8
        // columns of tile 4 jg + q, stored as 16 bytes
        const int q = lane & 3;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = pm * FB_BM + wrow + g + 8 * h;
          const bool ok = m < M;
          const int orow = m / p.Wo;
          const size_t pix =
              (static_cast<size_t>(b) * p.Ho + ro0 + orow) * p.Wo +
              (m - orow * p.Wo);
#pragma unroll
          for (int jg = 0; jg < 4; ++jg) {
            uint32_t w[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int t = 4 * jg + k;
              const int n = pn * FB_BN + wg * 128 + 8 * t + t2;
              float v0 = acc[4 * t + 2 * h] + p.b3[n];
              float v1 = acc[4 * t + 2 * h + 1] + p.b3[n + 1];
              if (p.wd != nullptr) {
                v0 += p.bd[n];
                v1 += p.bd[n + 1];
              } else if (ok) {  // stride 1, cin == cout: the input pixel
                const __nv_bfloat162 r = *reinterpret_cast<
                    const __nv_bfloat162*>(p.x + pix * p.cout + n);
                v0 += __bfloat162float(r.x);
                v1 += __bfloat162float(r.y);
              }
              w[k] = pack_bf16(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
            }
            uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              // lane q takes from lane (q + r) % 4 its pair of tile 4 jg +
              // q, which that lane sends as w[(its q - r) % 4]
              const int is = (q - r) & 3;
              const uint32_t send = is == 0 ? w[0] : is == 1 ? w[1]
                                  : is == 2 ? w[2] : w[3];
              const uint32_t got = __shfl_sync(
                  0xffffffffu, send, (lane & ~3) | ((q + r) & 3));
              const int ig = (q + r) & 3;
              o[0] = ig == 0 ? got : o[0];
              o[1] = ig == 1 ? got : o[1];
              o[2] = ig == 2 ? got : o[2];
              o[3] = ig == 3 ? got : o[3];
            }
            if (ok)
              *reinterpret_cast<uint4*>(
                  p.out + pix * p.cout + pn * FB_BN + wg * 128 +
                  8 * (4 * jg + q)) = make_uint4(o[0], o[1], o[2], o[3]);
          }
        }
      });
}

}  // namespace

// K10b. x [B, H, W, cin], w1 [cin, width], w2 [3, 3, width / 32, width],
// w3 [width, cout], wd [cin, cout] (or null with bd: then stride 1 and cin
// == cout), b* f32, out [B, Ho, Wo, cout], bf16. The band geometry (R,
// rows_in = (R - 1) stride + 3, the byte offsets of h2, of the two rings
// and of w2's copy (-1: none), smem) comes from
// ops/bottleneck.py::tiles_geometry, which also checks the shapes (cin %
// 32 == 0, width in {128, 256, 512, 1024}, cout % 128 == 0, R x Wo <=
// 128, 16-byte aligned pointers). Returns the first CUDA error, or 0.
extern "C" int mmb_bottleneck_fused_bf16(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, const void* wd,
    const void* bd, void* out, int B, int H, int W, int cin, int width,
    int cout, int stride, int R, int rows_in, int h2_off, int ring1_off,
    int ring3_off, int w2_off, int smem, void* stream) {
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  const FusedArgs a{static_cast<const __nv_bfloat16*>(x),
                    static_cast<const __nv_bfloat16*>(w1),
                    static_cast<const float*>(b1),
                    static_cast<const __nv_bfloat16*>(w2),
                    static_cast<const float*>(b2),
                    static_cast<const __nv_bfloat16*>(w3),
                    static_cast<const float*>(b3),
                    static_cast<const __nv_bfloat16*>(wd),
                    static_cast<const float*>(bd),
                    static_cast<__nv_bfloat16*>(out),
                    H, W, cin, width, cout, stride, Ho, Wo, R, rows_in,
                    h2_off, ring1_off, ring3_off, w2_off};
  void (*kernel)(FusedArgs);
  switch (width / 32) {
    case 4: kernel = bottleneck_fused<4>; break;
    case 8: kernel = bottleneck_fused<8>; break;
    case 16: kernel = bottleneck_fused<16>; break;
    case 32: kernel = bottleneck_fused<32>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((Ho + R - 1) / R, B), FB_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
