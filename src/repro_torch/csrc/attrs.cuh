// What a kernel asks of the card, read through the runtime: registers a
// thread, local memory a thread (spills), static and dynamic shared memory
// a block, and the blocks that fit on one SM. The tree kernels' C entries
// `fbt_*_attrs` report these for the instantiation a launch would take.
#pragma once

#include <cuda_runtime.h>

namespace fbt {

// out = {registers, local bytes, static shared bytes, dynamic shared bytes,
// blocks per SM}. Returns a CUDA error code.
inline int kernel_attrs(const void* fn, int threads, int dyn_smem, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                    dyn_smem);
  if (e != cudaSuccess) return e;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = dyn_smem;
  out[4] = blocks;
  return cudaSuccess;
}

}  // namespace fbt
