// A grid-wide barrier for the port's persistent cooperative kernels
// (stage.cu, vit_block.cu, lstm.cu, infonce.cu). The launch
// (cudaLaunchCooperativeKernel, as many blocks as fit on the card at once)
// makes every block resident, which the barrier needs. Writes made before
// it are visible to every block after it, as long as the reads after it go
// through L2 (cp.async.cg, __ldcg): a plain load could hit a stale line of
// the reading SM's L1.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// bar: two zeroed words, arrivals and generation
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = load_acquire(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (load_acquire(bar + 1) == gen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// Launch `kernel` cooperatively with as many blocks of `threads` as fit on
// the card at once with `smem` bytes of dynamic shared memory each, and at
// most `max_blocks`.
template <class Kernel, class Args>
cudaError_t launch_persistent(Kernel kernel, const Args& args, int threads,
                              int smem, cudaStream_t stream,
                              int max_blocks = 1 << 30) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  void* params[] = {const_cast<Args*>(&args)};
  const int grid = per_sm * sms < max_blocks ? per_sm * sms : max_blocks;
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(grid), dim3(threads),
                                     params, smem, stream);
}

}  // namespace
