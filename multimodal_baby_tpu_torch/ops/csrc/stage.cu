// A whole ResNeXt-50 stage (or the tail of one) in one launch on Hopper
// (sm_90a), bf16, int8 or int8 transport: every block of the chain of
// bottleneck.cu (K1, K2 or K10a) in turn, in one persistent cooperative
// kernel.
//
// Replaces two TPU kernels of multimodal_baby_tpu/ops/bottleneck_hwbc.py,
// which compute the same function, the chain of the stage's blocks:
//   - fused_stage_hwbc (Pallas body `_stage_kernel`, K3a): the stage with
//     its full spatial extent resident in VMEM per batch tile;
//   - fused_stage_banded (`_banded_kernel`, K3b): the stage banded over N
//     output rows, each band carrying the halo rows its 3x3 convolutions
//     need through every block, recomputed per band;
//   and the transport mode of both (K10a: int8 x, weights from
//   ops/quant.py::fold_block_params_t), whose blocks pass int8 codes to
//   each other and run bf16 products inside; the banded form reads its halo
//   rows as int8.
// Here the band is the kernel's `band` argument: the launch walks the
// stage's output band by band (N output rows of every image); for each band
// it runs every block on the rows that band needs (the band widened by one
// row per stride-1 3x3 below it, doubled at a stride-2 block, clipped to
// the image), so the halo rows are recomputed per band as on the TPU.
// band = the stage's output height is K3a: one band, no recompute. Because
// a halo row is computed by the same arithmetic as in a neighbouring band,
// every band count gives the same values bit for bit.
//
// Inside a band, each block runs three phases: conv1 (GEMM, gemm.cuh),
// the grouped 3x3 (bottleneck.cuh) and conv3 with the identity. All blocks
// of the grid share each phase's output tiles, a block taking tiles
// blockIdx.x, blockIdx.x + gridDim.x, ...; a grid-wide barrier separates
// the phases. Intermediates (h1, h2 and two ping-pong block outputs) live in
// workspaces in device memory that the L2 cache (50 MB) may hold: at
// B = 128, layer 3's tail passes 25.7 MB per int8 block output and
// layer 4's 12.8 MB; layer 1 in bf16 passes 205.5 MB per block output
// (102.8 MB per h1), so its bands (N = 28 of 56 rows, 102.8 MB each) do
// not fit and run at device-memory rate.
// The grid is as many blocks as fit on the card at once (the cooperative
// launch guarantees they are resident together, which the barrier needs).
//
// What bounds it on an H100: as K1/K2, tensor-core throughput on the 1x1
// GEMMs; the launch saves the per-block launch gaps and keeps the smaller
// stages' intermediates in L2, but the tiles are the per-block kernels'
// own, and keeping a band's data in shared memory across blocks (TMA,
// wgmma, clusters with distributed shared memory) is later work.

#include <type_traits>

#include "bottleneck.cuh"
#include "grid.cuh"

namespace {

constexpr int STAGE_THREADS = 256;
constexpr int STAGE_CBM = 256;  // grouped-conv tile: one pixel per thread
constexpr int MAX_STAGE_BLOCKS = 6;

struct StageBlock {
  const void* w1;
  const float* a1;  // int8 only (a1, a2); a3, ad, ai int8 and transport
  const float* b1;
  const void* w2;
  const float* a2;
  const float* b2;
  const void* w3;
  const float* a3;
  const float* b3;
  const void* wd;  // null without a downsample (bd, ad too)
  const float* ad;
  const float* bd;
  const float* ai;  // int8 without a downsample
  int cin, stride, H, W;  // input channels and input grid
};

struct StageArgs {
  StageBlock blk[MAX_STAGE_BLOCKS];
  int n_blocks, B, width, cout, band;
  const void* x;  // [B, H, W, cin] stage input
  void* h1;       // [B, H, W, width] (the largest input grid)
  void* h2;       // [B, Ho, Wo, width]
  void* t0;       // [B, Ho, Wo, cout] block outputs, ping-pong
  void* t1;
  void* out;  // [B, Ho, Wo, cout]
  unsigned* bar;  // two zeroed words: arrivals, generation
};

// The kernel's three bodies: bf16 (K1's chain), int8 (K2's) and int8
// transport (K10a's: int8 codes between the blocks, K1's bf16 chain inside
// each).
constexpr int BF16 = 0;
constexpr int S8 = 1;
constexpr int TRANSPORT = 2;

// bf16: two blocks per SM (128 registers a thread), measured 11-13% faster
// on layer 1 and layer 3's tail than one; int8 keeps one: its downsample
// GEMM holds two sets of int32 accumulators, which spill at 128 registers
// (measured 43% slower on layer 4). A/B on an H100 with
// scripts/ab_stage_kernel.sh. Transport runs the bf16 body at two blocks
// per SM: its downsample keeps its sums in shared memory, not registers.
template <int MODE, int CG>
__global__ void __launch_bounds__(STAGE_THREADS, MODE == S8 ? 1 : 2)
    stage_kernel(const StageArgs p) {
  constexpr bool Q = MODE == S8;
  using T = std::conditional_t<Q, int8_t, __nv_bfloat16>;  // h1, h2
  using TIO = std::conditional_t<MODE == BF16, __nv_bfloat16, int8_t>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = p.n_blocks;
  const StageBlock& last = p.blk[n - 1];
  const int n_bands = ((last.H - 1) / last.stride + 1) / p.band;
  T* h1 = static_cast<T*>(p.h1);
  T* h2 = static_cast<T*>(p.h2);

  for (int band = 0; band < n_bands; ++band) {
    // rows of each block's output and input that this band needs
    int out_lo[MAX_STAGE_BLOCKS], out_hi[MAX_STAGE_BLOCKS];
    int in_lo[MAX_STAGE_BLOCKS], in_hi[MAX_STAGE_BLOCKS];
    int lo = band * p.band;
    int hi = lo + p.band;
    for (int j = n - 1; j >= 0; --j) {
      out_lo[j] = lo;
      out_hi[j] = hi;
      const int s = p.blk[j].stride;
      lo = max(0, lo * s - 1);
      hi = min(p.blk[j].H, (hi - 1) * s + 2);
      in_lo[j] = lo;
      in_hi[j] = hi;
    }

    for (int j = 0; j < n; ++j) {
      const StageBlock& b = p.blk[j];
      const TIO* in = static_cast<const TIO*>(
          j == 0 ? p.x : ((j - 1) & 1 ? p.t1 : p.t0));
      TIO* out = static_cast<TIO*>(j == n - 1 ? p.out : (j & 1 ? p.t1 : p.t0));
      // the GEMMs' A operand: transport's int8 codes ride in a bf16 pointer
      const T* in_a = reinterpret_cast<const T*>(in);
      const int Ho = (b.H - 1) / b.stride + 1;
      const int Wo = (b.W - 1) / b.stride + 1;
      const RowMap rin{b.H, b.W, in_lo[j], in_hi[j] - in_lo[j]};
      const RowMap rout{Ho, Wo, out_lo[j], out_hi[j] - out_lo[j]};

      {  // conv1 on the input rows
        GemmArgsT<T> g{};
        g.a1 = in_a;
        g.b1 = static_cast<const T*>(b.w1);
        g.k1 = b.cin;
        g.rows = rin;
        g.M = p.B * rin.ext * b.W;
        g.N = p.width;
        const int nt = p.width / BN;
        const int tiles = nt * ((g.M + BM - 1) / BM);
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          const int m0 = (t / nt) * BM;
          const int n0 = (t % nt) * BN;
          if constexpr (Q) {
            gemm_s8_tile<false>(g, Requant{b.a1, b.b1, h1, p.width}, m0, n0,
                                smem);
          } else {
            const BiasResidualRelu e{b.b1, nullptr, nullptr, h1, p.width};
            gemm_bf16_tile<MODE == TRANSPORT>(g, e, m0, n0, smem);
          }
        }
      }
      grid_sync(p.bar);

      {  // the grouped 3x3 on the output rows
        ConvArgsT<T> c{};
        c.h = h1;
        c.w = static_cast<const T*>(b.w2);
        c.a = b.a2;
        c.bias = b.b2;
        c.out = h2;
        c.H = b.H;
        c.W = b.W;
        c.C = p.width;
        c.stride = b.stride;
        c.rows = rout;
        c.M = p.B * rout.ext * Wo;
        const int nt = p.width / GC_BN;
        const int tiles = nt * ((c.M + STAGE_CBM - 1) / STAGE_CBM);
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          if constexpr (Q)
            gconv_s8_tile<CG, STAGE_CBM>(c, (t / nt) * STAGE_CBM,
                                         (t % nt) * GC_BN, smem);
          else
            gconv_bf16_tile<CG, STAGE_CBM>(c, (t / nt) * STAGE_CBM,
                                           (t % nt) * GC_BN, smem);
        }
      }
      grid_sync(p.bar);

      {  // conv3 + identity on the output rows
        GemmArgsT<T> g{};
        g.a1 = h2;
        g.b1 = static_cast<const T*>(b.w3);
        g.k1 = p.width;
        g.rows = rout;
        g.M = p.B * rout.ext * Wo;
        g.N = p.cout;
        if (b.wd != nullptr) {
          g.a2 = in_a;
          g.b2 = static_cast<const T*>(b.wd);
          g.k2 = b.cin;
          g.H = b.H;
          g.W = b.W;
          g.stride = b.stride;
        }
        const int nt = p.cout / BN;
        const int tiles = nt * ((g.M + BM - 1) / BM);
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          const int m0 = (t / nt) * BM;
          const int n0 = (t % nt) * BN;
          if constexpr (Q) {
            if (b.wd != nullptr)
              gemm_s8_tile<true>(
                  g,
                  RequantResidual{b.a3, b.b3, b.ad, b.bd, nullptr, nullptr,
                                  out, p.cout},
                  m0, n0, smem);
            else
              gemm_s8_tile<false>(
                  g,
                  RequantResidual{b.a3, b.b3, nullptr, nullptr, b.ai, in,
                                  out, p.cout},
                  m0, n0, smem);
          } else if constexpr (MODE == TRANSPORT) {
            if (b.wd != nullptr)
              gemm_bf16_tile<false, true, true>(
                  g,
                  TransportOut{b.a3, b.b3, b.ad, b.bd, nullptr, nullptr, out,
                               p.cout},
                  m0, n0, smem);
            else
              gemm_bf16_tile(g,
                             TransportOut{b.a3, b.b3, nullptr, nullptr, b.ai,
                                          in, out, p.cout},
                             m0, n0, smem);
          } else {
            gemm_bf16_tile(
                g,
                BiasResidualRelu{b.b3, b.wd != nullptr ? b.bd : nullptr,
                                 b.wd != nullptr ? nullptr : in, out,
                                 p.cout},
                m0, n0, smem);
          }
        }
      }
      grid_sync(p.bar);
    }
  }
}

template <int MODE, int CG>
cudaError_t launch_stage(const StageArgs& p, cudaStream_t stream) {
  constexpr int gemm_smem = MODE == S8          ? GEMM8_SMEM
                            : MODE == TRANSPORT ? GEMM_HELD_SMEM
                                                : GEMM_SMEM;
  constexpr int conv_smem = MODE == S8 ? gconv_s8_smem<STAGE_CBM>()
                                       : gconv_bf16_smem<STAGE_CBM>();
  constexpr int smem = gemm_smem > conv_smem ? gemm_smem : conv_smem;
  return launch_persistent(stage_kernel<MODE, CG>, p, STAGE_THREADS, smem,
                           stream);
}

template <int MODE>
cudaError_t launch_stage_cg(const StageArgs& p, int cg, cudaStream_t s) {
  switch (cg) {
    case 4:
      return launch_stage<MODE, 4>(p, s);
    case 8:
      return launch_stage<MODE, 8>(p, s);
    case 16:
      return launch_stage<MODE, 16>(p, s);
    case 32:
      return launch_stage<MODE, 32>(p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: 0 bf16, 1 int8, 2 int8 transport (int8 x, t0, t1 and out; bf16 h1
// and h2). Shapes and alignment are checked by the Python wrapper
// (multimodal_baby_tpu_torch/ops/stage.py): 1 to 6 blocks, a stride only in
// the first, every block of one width and one output width, the first
// block's input cin0 and the rest's cout, the constraints of
// mmb_bottleneck_*, and band dividing the stage's output rows. `ptrs` holds
// 13 pointers per block, in the order of StageBlock (null where absent);
// `strides` one stride per block. Returns the first CUDA error, or 0.
extern "C" int mmb_stage(int mode, int n_blocks, const void* const* ptrs,
                         const int* strides, const void* x, void* h1,
                         void* h2, void* t0, void* t1, void* out, void* bar,
                         int B, int H, int W, int cin0, int width, int cout,
                         int band, void* stream) {
  if (n_blocks < 1 || n_blocks > MAX_STAGE_BLOCKS)
    return static_cast<int>(cudaErrorInvalidValue);
  StageArgs p{};
  p.n_blocks = n_blocks;
  p.B = B;
  p.width = width;
  p.cout = cout;
  p.band = band;
  p.x = x;
  p.h1 = h1;
  p.h2 = h2;
  p.t0 = t0;
  p.t1 = t1;
  p.out = out;
  p.bar = static_cast<unsigned*>(bar);
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  for (int j = 0; j < n_blocks; ++j) {
    const void* const* q = ptrs + 13 * j;
    StageBlock& b = p.blk[j];
    b = StageBlock{q[0], f(q[1]),  f(q[2]),  q[3], f(q[4]), f(q[5]),
                   q[6], f(q[7]),  f(q[8]),  q[9], f(q[10]), f(q[11]),
                   f(q[12]), j == 0 ? cin0 : cout, strides[j], H, W};
    H = (H - 1) / strides[j] + 1;
    W = (W - 1) / strides[j] + 1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case BF16:
      return static_cast<int>(launch_stage_cg<BF16>(p, width / 32, s));
    case S8:
      return static_cast<int>(launch_stage_cg<S8>(p, width / 32, s));
    case TRANSPORT:
      return static_cast<int>(launch_stage_cg<TRANSPORT>(p, width / 32, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
