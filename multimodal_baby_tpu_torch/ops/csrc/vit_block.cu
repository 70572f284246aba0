// A whole pre-norm ViT block in one launch on Hopper (sm_90a), bf16 in and
// out, f32 accumulation:
//
//   y   = bf16(x + (attn(qkv(LN1(x))) . Wproj) + bproj)     (K5)
//   out = bf16(y + (gelu(LN2(y) . W1 + b1) . W2) + b2)       (K6)
//
// Replaces the TPU kernel multimodal_baby_tpu/ops/vit_block.py::
// fused_vit_block (`_vit_block_kernel`), which runs both halves per image
// with every intermediate in VMEM, y rounded to bf16 between them so that
// it equals the two-kernel composition bit for bit.
//
// One image per program cannot work here: the block's weights alone are 14
// MB bf16 at ViT-B, and an SM has 227 KB. So the block is one persistent
// cooperative launch (one 256-thread block per SM, grid.cuh) that runs
// seven phases with a grid barrier between each:
//   1 LN1 (one warp per token row)     x   -> xn
//   2 qkv Dense, RoundThenBias         xn  -> qkv
//   3 attention, one (head, image) item a warpgroup (N <= 272; longer
//     rows one a block): K and V of all N keys in swizzled shared memory,
//     the warps walking the 16-row query slabs on attn_mma.cuh's core in
//     K5's deferred mode                                     qkv -> att
//   4 proj Dense, ResidualBias (+ x)   att -> y
//   5 LN2                              y   -> xn
//   6 fc1 Dense, BiasGelu              xn  -> h
//   7 fc2 Dense, ResidualBias (+ y)    h   -> out
// The Dense phases run vit_gemm.cuh's tile walk (K5's tile, one mbarrier
// ring whose slice count runs on from phase to phase; its sums are
// the wmma tile's bits, which K6 runs) with warpgroup 0 also issuing the TMA
// copies, so that the block needs no producer warp and every thread may
// hold 255 registers (the attention core wants them: a 288- or
// 384-thread block with wgmma gets 168). The LayerNorm rows and
// epilogues are vit.cuh's (fc1's GELU form fixed at compile time, one
// walk per form), and the attention is K5's routine with K5's launch
// geometry (ops/attention.py::attention_geometry, one- or two-pass
// kernels), so K7 equals K5 then K6 on the card bit for bit. Every read
// of an intermediate goes through L2 (TMA, cp.async.cg, __ldcg).
//
// What bounds it on an H100: tensor-core throughput (491.6 GFLOP per call
// at ViT-B/14 and B = 128: 0.497 ms at 989 TFLOP/s). xn, qkv, the
// attention output, y and the [B*N, F] hidden (202 MB at B = 128) pass
// through device memory as in K5 and K6; keeping a row band's hidden on
// chip (fc1 into fc2) is the next step, with K6's.
//
// Shared memory: the larger of the tile's ring (VG_SMEM, 197,632 bytes)
// and the attention's K and V (two items' at N <= 272, 139,264 bytes; one
// item's above, 200,704 at N = 752), plus the alignment slack: one block
// per SM.

#include "attn_mma.cuh"
#include "grid.cuh"
#include "vit_gemm.cuh"

namespace {

constexpr int VB_THREADS = VG_CONSUMERS;  // two warpgroups
constexpr int VB_WARPS = VB_THREADS / 32;

struct BlockArgs {
  VitDense qkv_d, proj_d, fc1_d, fc2_d;  // the Denses' TMA maps and shapes
  const __nv_bfloat16 *x, *g1, *gb1, *bq, *bp, *g2, *gb2, *b1, *b2;
  __nv_bfloat16 *xn, *qkv, *att, *y, *h, *out;
  unsigned* bar;  // two zeroed words
  AttnGeom gm;
  int B, N, C, F, kv_valid, gelu;
  float c, eps;   // c = scale log2(e)
};

// warpgroup wg's 128 threads (named barrier 1 + wg; 0 is __syncthreads')
__device__ __forceinline__ void warpgroup_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void layer_norm_phase(
    const __nv_bfloat16* x, const __nv_bfloat16* g, const __nv_bfloat16* b,
    __nv_bfloat16* out, int M, int C, float eps) {
  const int warp = threadIdx.x >> 5;
  for (int t = blockIdx.x; t * VB_WARPS < M; t += gridDim.x) {
    const int row = t * VB_WARPS + warp;
    if (row < M)
      layer_norm_row(x + static_cast<size_t>(row) * C, g, b,
                     out + static_cast<size_t>(row) * C, C, eps);
  }
}

// K5's attention over the (head, image) items of this block. One-pass
// rows (SINGLE, np <= 272: K and V 69,632 bytes an item) run two items at
// once, one a warpgroup, each walking its slabs with its 4 warps and its
// own barrier; longer rows one item at a time with all 8 warps. K and V
// land whole before the slabs (a short row may have fewer slabs than
// warps, so the core's chunk-by-chunk first round is not used).
template <bool SINGLE>
__device__ __forceinline__ void attention_phase(const BlockArgs& p,
                                                unsigned char* smem) {
  const AttnGeom& gm = p.gm;
  const int N = p.N;
  const int C = p.C;
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  // SINGLE: worker = warpgroup, else the block
  const int lanes = SINGLE ? 128 : VB_THREADS;
  const int tid = SINGLE ? threadIdx.x & 127 : threadIdx.x;
  const int wslab = SINGLE ? warp & 3 : warp;
  const int worker = SINGLE ? 2 * blockIdx.x + wg : blockIdx.x;
  const int workers = SINGLE ? 2 * gridDim.x : gridDim.x;
  const auto sync = [&] {
    if (SINGLE)
      warpgroup_barrier(wg);
    else
      __syncthreads();
  };
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem) +
                      (SINGLE ? wg * 2 * gm.rows * AM_D : 0);
  __nv_bfloat16* Vs = Ks + gm.rows * AM_D;
  const size_t ld3 = 3 * static_cast<size_t>(C);
  const int heads = C / AM_D;
  for (int t = worker; t < heads * p.B; t += workers) {
    const int head = t % heads;
    const int img = t / heads;
    const __nv_bfloat16* q =
        p.qkv + static_cast<size_t>(img) * N * ld3 + head * AM_D;
    load_rows_sw(Ks, q + C, ld3, N, 0, gm.rows, tid, lanes);
    load_rows_sw(Vs, q + 2 * C, ld3, N, 0, gm.rows, tid, lanes);
    cp_async_commit();
    cp_async_wait<0>();
    sync();
    for (int sl = wslab; sl < gm.np / 16; sl += lanes / 32) {
      const int row = sl * 16;
      uint32_t qa[4][4];
      load_q_frags<true>(qa, q + row * ld3, ld3, N - row);
      float o[8][4];
      attention_slab<P_DEFER, SINGLE>(qa, Ks, Vs, gm, p.kv_valid, p.c,
                                      false, o);
      store_slab(o,
                 p.att + (static_cast<size_t>(img) * N + row) * C +
                     head * AM_D,
                 C, N - row);
    }
    sync();  // the next item overwrites K and V
  }
}

// a Dense phase: the tile walk of d, warpgroup 0 also issuing the copies;
// q counts the ring's slices over the launch
template <class Epilogue>
__device__ __forceinline__ void dense_phase(const VitDense& d,
                                            const Epilogue& epi,
                                            __nv_bfloat16* stages,
                                            VitRing& ring, int& q) {
  ring_boundary();
  vit_gemm_consume<true>(d, epi, stages, ring, q);
  q += walk_steps(d);
  ring_boundary();
}

// fc1, with the GELU form fixed at compile time
__device__ __forceinline__ void fc1_phase(const BlockArgs& p,
                                          __nv_bfloat16* stages,
                                          VitRing& ring, int& q) {
  const BiasGelu e{p.b1, p.h, p.F, p.gelu};
  switch (p.gelu) {
    case GELU_ERF:
      dense_phase(p.fc1_d, BiasGeluForm<GELU_ERF>{e}, stages, ring, q);
      break;
    case GELU_TANH:
      dense_phase(p.fc1_d, BiasGeluForm<GELU_TANH>{e}, stages, ring, q);
      break;
    default:
      dense_phase(p.fc1_d, BiasGeluForm<GELU_SIGMOID>{e}, stages, ring, q);
  }
}

template <bool SINGLE>
__global__ void __launch_bounds__(VB_THREADS, 1)
    vit_block_kernel(const __grid_constant__ BlockArgs p) {
  extern __shared__ __align__(128) unsigned char vit_block_smem[];
  __shared__ VitRing ring;
  unsigned char* smem = align_atoms(vit_block_smem);
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  if (threadIdx.x == 0) vit_ring_init(ring);
  const int M = p.B * p.N;
  const int C = p.C;
  int q = 0;  // the ring's slices so far
  layer_norm_phase(p.x, p.g1, p.gb1, p.xn, M, C, p.eps);
  grid_sync(p.bar);
  dense_phase(p.qkv_d, RoundThenBias{p.bq, p.qkv, 3 * C}, stages, ring, q);
  grid_sync(p.bar);
  attention_phase<SINGLE>(p, smem);
  grid_sync(p.bar);
  dense_phase(p.proj_d, ResidualBias{p.x, p.bp, p.y, C}, stages, ring, q);
  grid_sync(p.bar);
  layer_norm_phase(p.y, p.g2, p.gb2, p.xn, M, C, p.eps);
  grid_sync(p.bar);
  fc1_phase(p, stages, ring, q);
  grid_sync(p.bar);
  dense_phase(p.fc2_d, ResidualBias{p.y, p.b2, p.out, C}, stages, ring, q);
}

}  // namespace

// Shapes and alignment are checked by the Python wrapper
// (multimodal_baby_tpu_torch/ops/vit_block.py): bf16 everywhere, C % 128 ==
// 0, heads of 64, F % 128 == 0, 1 <= kv_valid <= N <= 752, every pointer
// 16-byte aligned; weights [in, out] row-major. xn [B*N, C], qkv [B*N, 3C],
// att and y [B*N, C], h [B*N, F] are scratch; bar is two zeroed 32-bit
// words; gelu is a GeluMode; (np, kc, nchunks, rows) the attention's
// geometry, K5's (attention_geometry). Returns the first CUDA error, or 0.
extern "C" int mmb_vit_block_bf16(
    const void* x, const void* g1, const void* gb1, const void* wq,
    const void* bq, const void* wp, const void* bp, const void* g2,
    const void* gb2, const void* w1, const void* b1, const void* w2,
    const void* b2, void* xn, void* qkv, void* att, void* y, void* h,
    void* out, void* bar, int B, int N, int C, int F, int kv_valid, int gelu,
    float scale, float eps, int np, int kc, int nchunks, int rows,
    void* stream) {
  const auto in = [](const void* q) {
    return static_cast<const __nv_bfloat16*>(q);
  };
  const auto io = [](void* q) { return static_cast<__nv_bfloat16*>(q); };
  BlockArgs p;
  const int M = B * N;
  cudaError_t err = vit_dense(&p.qkv_d, xn, wq, M, C, 3 * C);
  if (err == cudaSuccess) err = vit_dense(&p.proj_d, att, wp, M, C, C);
  if (err == cudaSuccess) err = vit_dense(&p.fc1_d, xn, w1, M, C, F);
  if (err == cudaSuccess) err = vit_dense(&p.fc2_d, h, w2, M, F, C);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.x = in(x);
  p.g1 = in(g1);
  p.gb1 = in(gb1);
  p.bq = in(bq);
  p.bp = in(bp);
  p.g2 = in(g2);
  p.gb2 = in(gb2);
  p.b1 = in(b1);
  p.b2 = in(b2);
  p.xn = io(xn);
  p.qkv = io(qkv);
  p.att = io(att);
  p.y = io(y);
  p.h = io(h);
  p.out = io(out);
  p.bar = static_cast<unsigned*>(bar);
  p.gm = AttnGeom{np, kc, nchunks, rows};
  p.B = B;
  p.N = N;
  p.C = C;
  p.F = F;
  p.kv_valid = kv_valid;
  p.gelu = gelu;
  p.c = scale * AM_LOG2E;
  p.eps = eps;
  // K and V of one item, or of one a warpgroup for one-pass rows
  const int attn = (nchunks == 1 ? 2 : 1) * 2 * rows * AM_D * 2 + VG_ALIGN;
  const int smem = attn > VG_SMEM ? attn : VG_SMEM;
  return static_cast<int>(launch_persistent(
      nchunks == 1 ? vit_block_kernel<true> : vit_block_kernel<false>, p,
      VB_THREADS, smem, static_cast<cudaStream_t>(stream)));
}
