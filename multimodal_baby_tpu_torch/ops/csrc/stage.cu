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
// Inside a band, each block runs three phases: conv1 (a GEMM), the grouped
// 3x3 (bottleneck.cuh) and conv3 with the identity. All blocks of the grid
// share each phase's output tiles, a block taking tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...; a grid-wide barrier separates the phases.
// Intermediates (h1, h2 and two ping-pong block outputs) live in
// workspaces in device memory that the L2 cache (50 MB) may hold: at
// B = 128, layer 3's tail passes 25.7 MB per int8 block output and
// layer 4's 12.8 MB; layer 1 in bf16 passes 205.5 MB per block output
// (102.8 MB per h1), so its bands (N = 28 of 56 rows, 102.8 MB each) do
// not fit and run at device-memory rate.
// The grid is as many blocks as fit on the card at once (the cooperative
// launch guarantees they are resident together, which the barrier needs).
//
// The three bodies (stage_tile_kernel, one template on the step type:
// StageStep for K3a's and K3b's bf16 stages, StageStepS8 for K3a's int8
// stages and the banded int8 stage, StageStepT for the transport stages)
// run their GEMM phases on the TMA-fed wgmma tiles of K1, K2 and K10a
// (conv_gemm.cuh, conv_gemm_s8.cuh) with one consumer warpgroup (not two
// in turns) and a producer warpgroup, one mbarrier ring across the phases
// (its slice counter runs on), and the grouped 3x3 on both warpgroups,
// each a worker of K1's or K2's halo tiles. 256 threads, one block an SM.
// The TMA maps of every band, block and GEMM (the rows each operand reads,
// in im2col mode, and the output band's store map), with the grouped 3x3's
// arguments, are built on the host once per launch and copied to device
// memory beside the launch (mmb_stage's `plan`). Its values are K1's,
// K2's and K10a's chains' bit for bit (the transport body on 64-row tiles
// where K10a's conv1 and residual conv3 take 128: a pixel's sums are the
// same whatever tile computes it).
//
// What bounds it on an H100: as K1/K2, tensor-core throughput on the 1x1
// GEMMs (layer 1's bf16 band by device memory); the launch saves the
// per-block launch gaps and keeps the smaller stages' intermediates in L2.

#include <algorithm>
#include <type_traits>
#include <vector>

#include "bottleneck.cuh"
#include "conv_gemm_s8.cuh"
#include "grid.cuh"

namespace {

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

// the rows of block j's input and output that a band of the stage's
// output needs (the band widened by one row per stride-1 3x3 below it,
// doubled at a stride-2 block, clipped to the image)
struct BandRows {
  int in_lo, in_hi, out_lo, out_hi;
};

__host__ __device__ inline BandRows band_rows(const StageArgs& p, int band,
                                              int j) {
  BandRows r{0, 0, band * p.band, (band + 1) * p.band};
  for (int i = p.n_blocks - 1;; --i) {
    const int s = p.blk[i].stride;
    r.in_lo = r.out_lo * s - 1 > 0 ? r.out_lo * s - 1 : 0;
    r.in_hi = (r.out_hi - 1) * s + 2 < p.blk[i].H ? (r.out_hi - 1) * s + 2
                                                  : p.blk[i].H;
    if (i == j) return r;
    r.out_lo = r.in_lo;
    r.out_hi = r.in_hi;
  }
}

// The three modes: bf16 (K1's chain), int8 (K2's) and int8 transport
// (K10a's: int8 codes between the blocks, K1's bf16 chain inside each).
constexpr int BF16 = 0;
constexpr int S8 = 1;
constexpr int TRANSPORT = 2;

// the grid barrier between the tile bodies' phases, from each role's own
// code path (the unaligned block barrier): TMA copies and stores (the async
// proxy) and plain loads and stores on either side of it are ordered both
// ways
__device__ __forceinline__ void stage_sync(unsigned* bar) {
  asm volatile("fence.proxy.async;\n" ::: "memory");
  __threadfence();
  asm volatile("barrier.sync 0;\n" ::: "memory");
  grid_arrive_wait(bar);
  asm volatile("barrier.sync 0;\n" ::: "memory");
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// the grouped 3x3's barriers, one a warpgroup (1-4: the 1x1 tile's)
constexpr int STAGE_GC_BAR = 5;
constexpr int STAGE_TILE_THREADS = 2 * PP_WG;
static_assert(2 * GH_SMEM <= PP_SMEM,
              "both warpgroups' grouped-3x3 workers fit the ring's memory");

// One block of one band of a body, built on the host and
// read by the kernel from device memory (no argument is indexed at run
// time in parameter space): conv1's and conv3's TMA maps, walks, biases
// and scales, the grouped 3x3's arguments (and, bf16, its halo tiles).
struct StageStep {  // bf16
  ConvGemm conv1, conv3;
  ConvArgs gconv;  // on the output rows
  HaloTiles halo;  // its tiles
};

struct StageStepS8 {
  ConvGemmS8 conv1, conv3;
  ConvArgsS8 gconv;
  HaloTiles halo;
};

struct StageStepT {  // transport: int8 codes in and out, bf16 h1 and h2
  ConvGemmS8 conv1, conv3;
  ConvArgs gconv;
  HaloTiles halo;
};

template <class Step>
struct StageTileArgs {
  const Step* steps;  // band-major, then block
  int n_steps;
  unsigned* bar;  // two zeroed words: arrivals, generation
};

// A warpgroup's place in the walk of a body.
struct StageWalk {
  unsigned char* smem;  // the ring's stages (aligned)
  PingPongRing* ring;
  int wg;
  bool issuer;  // the warpgroup's first thread: its copies and stores
  int q;        // the ring's slices so far
  int parity;   // the int8 residual barrier's phase
};

// One GEMM of the bf16 body by the consumer (CONSUMER) or the producer.
// The maps of each GEMM are acquired through the tensormap proxy first by
// the threads that copy through them (the host wrote them to device memory
// that earlier launches' maps may have occupied).
template <bool CONSUMER, class Epilogue>
__device__ __forceinline__ void stage_gemm(const ConvGemm& g, StageWalk& s) {
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(s.smem);
  if constexpr (CONSUMER) {
    tensormap_acquire_if(s.issuer, &g.out);
    tensormap_acquire_if(s.issuer && Epilogue::kResidual, &g.res);
    conv_consume<Epilogue, 1>(g, stages, *s.ring, s.wg, s.q);
  } else {
    tensormap_acquire_if(s.issuer, &g.a1);
    tensormap_acquire_if(s.issuer, &g.w1);
    tensormap_acquire_if(s.issuer && g.nk2 > 0, &g.a2);
    tensormap_acquire_if(s.issuer && g.nk2 > 0, &g.w2);
    conv_produce(g, s.smem, *s.ring, s.q, s.issuer);
  }
  s.q += ConvWalk(g).slices();
}

// one GEMM of the int8 body (conv_gemm_s8.cuh's MODE) on 64-row tiles,
// the downsample's identity through shared memory: K2's 128-row tiles, and
// the downsample's two sets of sums in registers, spill in this kernel,
// whose plan's values hold registers (PERF.md)
template <bool CONSUMER, int MODE>
__device__ __forceinline__ void stage_gemm(const ConvGemmS8& g,
                                           StageWalk& s) {
  constexpr int BM = S8_STAGE_ROWS;
  constexpr bool ID_SMEM = MODE == S8_DOWNSAMPLE;
  if constexpr (CONSUMER) {
    tensormap_acquire_if(s.issuer, &g.out);
    tensormap_acquire_if(s.issuer && MODE == S8_RESIDUAL, &g.res);
    conv_consume_s8<MODE, 1, BM, ID_SMEM>(g, s.smem, *s.ring, s.wg, s.q,
                                          s.parity);
  } else {
    tensormap_acquire_if(s.issuer, &g.a1);
    tensormap_acquire_if(s.issuer, &g.w1);
    tensormap_acquire_if(s.issuer && MODE == S8_DOWNSAMPLE, &g.a2);
    tensormap_acquire_if(s.issuer && MODE == S8_DOWNSAMPLE, &g.w2);
    conv_produce_s8<MODE, BM, ID_SMEM>(g, s.smem, *s.ring, s.q, s.issuer);
  }
  s.q += TileWalk<BM>(g).slices();
}

// one GEMM of the transport body on 64-row tiles (MODE: conv1 on the
// codes with K1's epilogue, or conv3 with the residual codes or the
// downsample's identity through shared memory, as the int8 body's)
template <bool CONSUMER, int MODE>
__device__ __forceinline__ void stage_gemm_t(const ConvGemmS8& g,
                                             StageWalk& s) {
  constexpr int BM = S8_STAGE_ROWS;
  constexpr bool ID_SMEM = MODE == S8_DOWNSAMPLE;
  if constexpr (CONSUMER) {
    tensormap_acquire_if(s.issuer, &g.out);
    tensormap_acquire_if(s.issuer && MODE == S8_RESIDUAL, &g.res);
    if constexpr (MODE == S8_CONV1)
      conv_consume<ConvEpilogue<false, false>, 1, true, BM>(
          g, reinterpret_cast<__nv_bfloat16*>(s.smem), *s.ring, s.wg, s.q);
    else
      conv_consume_s8<MODE, 1, BM, ID_SMEM, true>(g, s.smem, *s.ring, s.wg,
                                                  s.q, s.parity);
  } else {
    tensormap_acquire_if(s.issuer, &g.a1);
    tensormap_acquire_if(s.issuer, &g.w1);
    tensormap_acquire_if(s.issuer && MODE == S8_DOWNSAMPLE, &g.a2);
    tensormap_acquire_if(s.issuer && MODE == S8_DOWNSAMPLE, &g.w2);
    conv_produce<BM, ID_SMEM>(g, s.smem, *s.ring, s.q, s.issuer);
  }
  s.q += TileWalk<BM>(g).slices();
}

// conv1, the grouped 3x3 and conv3 of a bf16 step
template <bool CONSUMER>
__device__ __forceinline__ void stage_conv1(const StageStep& st,
                                            StageWalk& s) {
  stage_gemm<CONSUMER, ConvEpilogue<false, false>>(st.conv1, s);
}

template <int CG>
__device__ __forceinline__ void stage_gconv(const StageStep& st,
                                            StageWalk& s) {
  gconv_halo_walk<CG>(st.gconv, st.halo, 2 * blockIdx.x + s.wg,
                      2 * gridDim.x, s.smem + s.wg * GH_SMEM,
                      threadIdx.x % GH_THREADS, STAGE_GC_BAR + s.wg);
}

template <bool CONSUMER>
__device__ __forceinline__ void stage_conv3(const StageStep& st,
                                            StageWalk& s) {
  if (st.conv3.b2 != nullptr)
    stage_gemm<CONSUMER, ConvEpilogue<true, false>>(st.conv3, s);
  else
    stage_gemm<CONSUMER, ConvEpilogue<false, true>>(st.conv3, s);
}

// conv1, the grouped 3x3 (each warpgroup a worker of K2's halo tiles) and
// conv3 of an int8 step
template <bool CONSUMER>
__device__ __forceinline__ void stage_conv1(const StageStepS8& st,
                                            StageWalk& s) {
  stage_gemm<CONSUMER, S8_CONV1>(st.conv1, s);
}

template <int CG>
__device__ __forceinline__ void stage_gconv(const StageStepS8& st,
                                            StageWalk& s) {
  gconv_halo_walk_s8<CG>(st.gconv, st.halo, 2 * blockIdx.x + s.wg,
                         2 * gridDim.x, s.smem + s.wg * GH_SMEM,
                         threadIdx.x % GH_THREADS, STAGE_GC_BAR + s.wg);
}

template <bool CONSUMER>
__device__ __forceinline__ void stage_conv3(const StageStepS8& st,
                                            StageWalk& s) {
  if (st.conv3.nk2 > 0)
    stage_gemm<CONSUMER, S8_DOWNSAMPLE>(st.conv3, s);
  else
    stage_gemm<CONSUMER, S8_RESIDUAL>(st.conv3, s);
}

// conv1, the grouped 3x3 (K1's halo tiles) and conv3 of a transport step
template <bool CONSUMER>
__device__ __forceinline__ void stage_conv1(const StageStepT& st,
                                            StageWalk& s) {
  stage_gemm_t<CONSUMER, S8_CONV1>(st.conv1, s);
}

template <int CG>
__device__ __forceinline__ void stage_gconv(const StageStepT& st,
                                            StageWalk& s) {
  gconv_halo_walk<CG>(st.gconv, st.halo, 2 * blockIdx.x + s.wg,
                      2 * gridDim.x, s.smem + s.wg * GH_SMEM,
                      threadIdx.x % GH_THREADS, STAGE_GC_BAR + s.wg);
}

template <bool CONSUMER>
__device__ __forceinline__ void stage_conv3(const StageStepT& st,
                                            StageWalk& s) {
  if (st.conv3.nk2 > 0)
    stage_gemm_t<CONSUMER, S8_DOWNSAMPLE>(st.conv3, s);
  else
    stage_gemm_t<CONSUMER, S8_RESIDUAL>(st.conv3, s);
}

// One warpgroup's walk of a body (CONSUMER: warpgroup 0,
// else the producer, warpgroup 1, whose first thread issues the copies):
// per step, conv1 and conv3 on the 1x1 tile with the one consumer, between
// them the grouped 3x3 with both warpgroups as its workers, each in its
// half of the ring's shared memory.
template <class Step, int CG, bool CONSUMER>
__device__ __forceinline__ void stage_tile_walk(const StageTileArgs<Step>& p,
                                                unsigned char* smem,
                                                PingPongRing& ring, int wg) {
  StageWalk s{smem, &ring, wg, threadIdx.x % PP_WG == 0, 0, 0};
  for (int i = 0; i < p.n_steps; ++i) {
    const Step& st = p.steps[i];
    stage_conv1<CONSUMER>(st, s);
    stage_sync(p.bar);
    stage_gconv<CG>(st, s);
    stage_sync(p.bar);
    stage_conv3<CONSUMER>(st, s);
    stage_sync(p.bar);
  }
}

// The bodies: 256 threads (a consumer and a producer
// warpgroup), one block an SM, 255 registers a thread: one consumer, not
// K1's two with setmaxnreg 232 / 40, which spill here because the plan's
// values come from device memory and hold registers that K1's kernel
// parameters do not (PERF.md).
template <class Step, int CG>
__global__ void __launch_bounds__(STAGE_TILE_THREADS, 1)
    stage_tile_kernel(const StageTileArgs<Step> p) {
  extern __shared__ __align__(128) unsigned char stage_tile_smem[];
  __shared__ PingPongRing ring;
  unsigned char* smem = align_atoms(stage_tile_smem);
  if (threadIdx.x == 0) conv_ring_init(ring);
  __syncthreads();
  const int wg = warpgroup();
  if (wg == 0)
    stage_tile_walk<Step, CG, true>(p, smem, ring, wg);
  else
    stage_tile_walk<Step, CG, false>(p, smem, ring, wg);
}

// one band's block of the bf16 body
inline cudaError_t stage_step(StageStep* st, const StageArgs& p,
                              const StageBlock& b, const BandRows& r,
                              const void* in, void* out) {
  cudaError_t err = conv1_gemm(&st->conv1, in, b.w1, b.b1, p.h1, p.B, b.H,
                               b.W, b.cin, p.width, r.in_lo, r.in_hi);
  if (err == cudaSuccess)
    err = conv3_gemm(&st->conv3, p.h2, b.w3, b.b3, in, b.wd, b.bd, out, p.B,
                     b.H, b.W, b.cin, p.width, p.cout, b.stride, r.out_lo,
                     r.out_hi);
  if (err != cudaSuccess) return err;
  const int Ho = (b.H - 1) / b.stride + 1;
  const int Wo = (b.W - 1) / b.stride + 1;
  ConvArgs& c = st->gconv;
  c = ConvArgs{};
  c.h = static_cast<const __nv_bfloat16*>(p.h1);
  c.w = static_cast<const __nv_bfloat16*>(b.w2);
  c.bias = b.b2;
  c.out = static_cast<__nv_bfloat16*>(p.h2);
  c.H = b.H;
  c.W = b.W;
  c.C = p.width;
  c.stride = b.stride;
  c.rows = RowMap{Ho, Wo, r.out_lo, r.out_hi - r.out_lo};
  c.M = p.B * c.rows.ext * Wo;
  st->halo = halo_tiles(p.B, b.W, p.width, b.stride, c.rows.ext);
  return cudaSuccess;
}

// one band's block of the int8 body
inline cudaError_t stage_step(StageStepS8* st, const StageArgs& p,
                              const StageBlock& b, const BandRows& r,
                              const void* in, void* out) {
  cudaError_t err =
      conv1_gemm_s8(&st->conv1, in, b.w1, b.a1, b.b1, p.h1, p.B, b.H, b.W,
                    b.cin, p.width, r.in_lo, r.in_hi, S8_STAGE_ROWS);
  if (err == cudaSuccess)
    err = conv3_gemm_s8(&st->conv3, p.h2, b.w3, b.a3, b.b3, in, b.wd, b.ad,
                        b.bd, b.ai, out, p.B, b.H, b.W, b.cin, p.width,
                        p.cout, b.stride, r.out_lo, r.out_hi, S8_STAGE_ROWS);
  if (err != cudaSuccess) return err;
  const int Ho = (b.H - 1) / b.stride + 1;
  const int Wo = (b.W - 1) / b.stride + 1;
  ConvArgsS8& c = st->gconv;
  c = ConvArgsS8{};
  c.h = static_cast<const int8_t*>(p.h1);
  c.w = static_cast<const int8_t*>(b.w2);
  c.a = b.a2;
  c.bias = b.b2;
  c.out = static_cast<int8_t*>(p.h2);
  c.H = b.H;
  c.W = b.W;
  c.C = p.width;
  c.stride = b.stride;
  c.rows = RowMap{Ho, Wo, r.out_lo, r.out_hi - r.out_lo};
  c.M = p.B * c.rows.ext * Wo;
  st->halo = halo_tiles(p.B, b.W, p.width, b.stride, c.rows.ext, 1);
  return cudaSuccess;
}

// one band's block of the transport body: K10a's GEMMs on 64-row tiles,
// K1's grouped 3x3
inline cudaError_t stage_step(StageStepT* st, const StageArgs& p,
                              const StageBlock& b, const BandRows& r,
                              const void* in, void* out) {
  cudaError_t err =
      conv1_gemm_t(&st->conv1, in, b.w1, b.b1, p.h1, p.B, b.H, b.W, b.cin,
                   p.width, r.in_lo, r.in_hi, S8_STAGE_ROWS);
  if (err == cudaSuccess)
    err = conv3_gemm_t(&st->conv3, p.h2, b.w3, b.a3, b.b3, in, b.wd, b.ad,
                       b.bd, b.ai, out, p.B, b.H, b.W, b.cin, p.width,
                       p.cout, b.stride, r.out_lo, r.out_hi, S8_STAGE_ROWS);
  if (err != cudaSuccess) return err;
  const int Ho = (b.H - 1) / b.stride + 1;
  const int Wo = (b.W - 1) / b.stride + 1;
  ConvArgs& c = st->gconv;
  c = ConvArgs{};
  c.h = static_cast<const __nv_bfloat16*>(p.h1);
  c.w = static_cast<const __nv_bfloat16*>(b.w2);
  c.bias = b.b2;
  c.out = static_cast<__nv_bfloat16*>(p.h2);
  c.H = b.H;
  c.W = b.W;
  c.C = p.width;
  c.stride = b.stride;
  c.rows = RowMap{Ho, Wo, r.out_lo, r.out_hi - r.out_lo};
  c.M = p.B * c.rows.ext * Wo;
  st->halo = halo_tiles(p.B, b.W, p.width, b.stride, c.rows.ext);
  return cudaSuccess;
}

// the plan of a body (one Step per band and block, built here and copied
// to `plan` on the stream) and its launch
template <class Step, int CG>
cudaError_t launch_stage_tile(const StageArgs& p, void* plan,
                              cudaStream_t stream) {
  const int n = p.n_blocks;
  const StageBlock& last = p.blk[n - 1];
  const int n_bands = ((last.H - 1) / last.stride + 1) / p.band;
  std::vector<Step> steps(n_bands * n);
  for (int band = 0; band < n_bands; ++band) {
    for (int j = 0; j < n; ++j) {
      const void* in = j == 0 ? p.x : ((j - 1) & 1 ? p.t1 : p.t0);
      void* out = j == n - 1 ? p.out : (j & 1 ? p.t1 : p.t0);
      const cudaError_t err = stage_step(&steps[band * n + j], p, p.blk[j],
                                         band_rows(p, band, j), in, out);
      if (err != cudaSuccess) return err;
    }
  }
  // pageable to device: the call returns once the host bytes are staged
  const cudaError_t err =
      cudaMemcpyAsync(plan, steps.data(), steps.size() * sizeof(Step),
                      cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return err;
  const StageTileArgs<Step> a{static_cast<const Step*>(plan),
                              static_cast<int>(steps.size()), p.bar};
  return launch_persistent(stage_tile_kernel<Step, CG>, a,
                           STAGE_TILE_THREADS, PP_SMEM, stream);
}

template <int MODE, int CG>
cudaError_t launch_stage(const StageArgs& p, void* plan,
                         cudaStream_t stream) {
  if constexpr (MODE == BF16)
    return launch_stage_tile<StageStep, CG>(p, plan, stream);
  else if constexpr (MODE == S8)
    return launch_stage_tile<StageStepS8, CG>(p, plan, stream);
  else
    return launch_stage_tile<StageStepT, CG>(p, plan, stream);
}

template <int MODE>
cudaError_t launch_stage_cg(const StageArgs& p, void* plan, int cg,
                            cudaStream_t s) {
  switch (cg) {
    case 4:
      return launch_stage<MODE, 4>(p, plan, s);
    case 8:
      return launch_stage<MODE, 8>(p, plan, s);
    case 16:
      return launch_stage<MODE, 16>(p, plan, s);
    case 32:
      return launch_stage<MODE, 32>(p, plan, s);
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
// `strides` one stride per block. `plan` is device memory for
// mmb_stage_plan_bytes(n_blocks, bands) bytes (64-byte aligned), which
// takes the launch's plan: the TMA maps and arguments of every band and
// block. Returns the first CUDA error, or 0.
extern "C" int mmb_stage(int mode, int n_blocks, const void* const* ptrs,
                         const int* strides, const void* x, void* h1,
                         void* h2, void* t0, void* t1, void* out, void* bar,
                         void* plan, int B, int H, int W, int cin0,
                         int width, int cout, int band, void* stream) {
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
      return static_cast<int>(launch_stage_cg<BF16>(p, plan, width / 32, s));
    case S8:
      return static_cast<int>(launch_stage_cg<S8>(p, plan, width / 32, s));
    case TRANSPORT:
      return static_cast<int>(
          launch_stage_cg<TRANSPORT>(p, plan, width / 32, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bytes of a stage's plan for n_blocks blocks and `bands` bands: one
// StageStep, StageStepS8 or StageStepT (TMA maps and arguments) per band
// and block.
extern "C" long long mmb_stage_plan_bytes(int n_blocks, int bands) {
  constexpr size_t step =
      std::max({sizeof(StageStep), sizeof(StageStepS8), sizeof(StageStepT)});
  return static_cast<long long>(n_blocks) * bands *
         static_cast<long long>(step);
}
