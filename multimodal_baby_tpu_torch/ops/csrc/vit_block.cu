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
// cooperative launch (as many 256-thread blocks as fit on the card, grid.cuh)
// that runs seven phases with a grid barrier between each:
//   1 LN1 (one warp per token row)     x   -> xn
//   2 qkv GEMM, RoundThenBias          xn  -> qkv
//   3 attention, one (head, image) per tile: K and V of all N keys in
//     shared memory, each warp walking the 16-row query slabs with K5's
//     deferred softmax (vit.cuh: slab_max, slab_defer)   qkv -> att
//   4 proj GEMM, ResidualBias (+ x)    att -> y
//   5 LN2                              y   -> xn
//   6 fc1 GEMM, BiasGelu               xn  -> h
//   7 fc2 GEMM, ResidualBias (+ y)     h   -> out
// Each phase runs the tile routines of K5 and K6 (gemm.cuh's bf16 tile,
// vit.cuh's LayerNorm row, epilogues and attention slabs) over the same
// tiles, so K7 equals K5 then K6 on the card bit for bit. Blocks take the
// phase's tiles blockIdx.x, blockIdx.x + gridDim.x, ...; every read of an
// intermediate goes through L2.
//
// What bounds it on an H100: tensor-core throughput (491.6 GFLOP per call
// at ViT-B/14 and B = 128: 0.497 ms at 989 TFLOP/s). This first version
// removes launches, not traffic: xn, qkv, the attention output, y and the
// [B*N, F] hidden (202 MB at B = 128) pass through device memory as in K5
// and K6. Keeping a row band's hidden on chip is later work.

#include "grid.cuh"
#include "vit.cuh"

namespace {

constexpr int VB_THREADS = 256;
constexpr int VB_WARPS = VB_THREADS / 32;

struct BlockArgs {
  const __nv_bfloat16 *x, *g1, *gb1, *wq, *bq, *wp, *bp, *g2, *gb2, *w1,
      *b1, *w2, *b2;
  __nv_bfloat16 *xn, *qkv, *att, *y, *h, *out;
  unsigned* bar;  // two zeroed words
  int B, N, C, F, kv_valid, gelu;
  float scale, eps;
};

// the attention phase's K, V, one query slab per warp and the s and p
// tiles; at least the GEMM tile's
size_t vit_block_smem(int np) {
  const size_t attn = (2 * static_cast<size_t>(np) + VB_WARPS * 16) * KV_LD *
                          2 +
                      VB_WARPS * 16 * 16 * (4 + 2);
  return attn > static_cast<size_t>(GEMM_SMEM) ? attn : GEMM_SMEM;
}

// the tiles of launch_gemm's grid, shared among the blocks
template <class Epilogue>
__device__ __forceinline__ void gemm_phase(const GemmArgs& g,
                                           const Epilogue& epi,
                                           unsigned char* smem) {
  const int nt = g.N / BN;
  const int tiles = nt * ((g.M + BM - 1) / BM);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    gemm_bf16_tile(g, epi, (t / nt) * BM, (t % nt) * BN, smem);
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

__device__ __forceinline__ void attention_phase(const BlockArgs& p,
                                                unsigned char* smem) {
  const int N = p.N;
  const int C = p.C;
  const int np = (N + 15) & ~15;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + np * KV_LD;
  __nv_bfloat16* Qw = Vs + np * KV_LD + warp * 16 * KV_LD;
  float* st = reinterpret_cast<float*>(Vs + np * KV_LD +
                                       VB_WARPS * 16 * KV_LD) +
              warp * 256;
  __nv_bfloat16* pt =
      reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<float*>(
          Vs + np * KV_LD + VB_WARPS * 16 * KV_LD) + VB_WARPS * 256) +
      warp * 256;
  const size_t ld3 = 3 * static_cast<size_t>(C);
  const int heads = C / HD;
  for (int t = blockIdx.x; t < heads * p.B; t += gridDim.x) {
    const int head = t % heads;
    const int img = t / heads;
    const __nv_bfloat16* base =
        p.qkv + static_cast<size_t>(img) * N * ld3 + head * HD;
    load_head_rows(Ks, base + C, ld3, N, np, tid, VB_THREADS);
    load_head_rows(Vs, base + 2 * C, ld3, N, np, tid, VB_THREADS);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int sl = warp; sl < np / 16; sl += VB_WARPS) {
      load_head_rows(Qw, base + static_cast<size_t>(sl) * 16 * ld3, ld3,
                     N - sl * 16, 16, lane, 32);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      QFrag qf[HD / 16];
      load_q(qf, Qw);
      const float m = slab_max(qf, Ks, np, p.kv_valid, p.scale, st);
      AccFrag o[HD / 16];
      const float z =
          slab_defer(qf, Ks, Vs, np, p.kv_valid, p.scale, m, st, pt, o);
      slab_store(o, 1.0f / z, st,
                 p.att + (static_cast<size_t>(img) * N + sl * 16) * C +
                     head * HD,
                 C, N - sl * 16);
    }
    __syncthreads();  // the next tile overwrites K and V
  }
}

__global__ void __launch_bounds__(VB_THREADS, 2)
    vit_block_kernel(const BlockArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int M = p.B * p.N;
  const int C = p.C;
  layer_norm_phase(p.x, p.g1, p.gb1, p.xn, M, C, p.eps);
  grid_sync(p.bar);
  gemm_phase(dense(p.xn, p.wq, M, C, 3 * C),
             RoundThenBias{p.bq, p.qkv, 3 * C}, smem);
  grid_sync(p.bar);
  attention_phase(p, smem);
  grid_sync(p.bar);
  gemm_phase(dense(p.att, p.wp, M, C, C), ResidualBias{p.x, p.bp, p.y, C},
             smem);
  grid_sync(p.bar);
  layer_norm_phase(p.y, p.g2, p.gb2, p.xn, M, C, p.eps);
  grid_sync(p.bar);
  gemm_phase(dense(p.xn, p.w1, M, C, p.F), BiasGelu{p.b1, p.h, p.F, p.gelu},
             smem);
  grid_sync(p.bar);
  gemm_phase(dense(p.h, p.w2, M, p.F, C), ResidualBias{p.y, p.b2, p.out, C},
             smem);
}

}  // namespace

// Shapes and alignment are checked by the Python wrapper
// (multimodal_baby_tpu_torch/ops/vit_block.py): bf16 everywhere, C % 128 ==
// 0, heads of 64, F % 128 == 0, 1 <= kv_valid <= N <= 688, every pointer
// 16-byte aligned; weights [in, out] row-major. xn [B*N, C], qkv [B*N, 3C],
// att and y [B*N, C], h [B*N, F] are scratch; bar is two zeroed 32-bit
// words; gelu is a GeluMode. Returns the first CUDA error, or 0.
extern "C" int mmb_vit_block_bf16(
    const void* x, const void* g1, const void* gb1, const void* wq,
    const void* bq, const void* wp, const void* bp, const void* g2,
    const void* gb2, const void* w1, const void* b1, const void* w2,
    const void* b2, void* xn, void* qkv, void* att, void* y, void* h,
    void* out, void* bar, int B, int N, int C, int F, int kv_valid, int gelu,
    float scale, float eps, void* stream) {
  const auto in = [](const void* q) {
    return static_cast<const __nv_bfloat16*>(q);
  };
  const auto io = [](void* q) { return static_cast<__nv_bfloat16*>(q); };
  const BlockArgs p{in(x),   in(g1), in(gb1), in(wq), in(bq),  in(wp),
                    in(bp),  in(g2), in(gb2), in(w1), in(b1),  in(w2),
                    in(b2),  io(xn), io(qkv), io(att), io(y),  io(h),
                    io(out), static_cast<unsigned*>(bar),
                    B,       N,      C,       F,      kv_valid, gelu,
                    scale,   eps};
  const int smem = static_cast<int>(vit_block_smem((N + 15) & ~15));
  return static_cast<int>(launch_persistent(
      vit_block_kernel, p, VB_THREADS, smem,
      static_cast<cudaStream_t>(stream)));
}
