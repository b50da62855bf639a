// What a kernel was built with, as every source's *_kernel_info entry
// point reports it (ops/_build.py's kernel_info reads the six ints).
#pragma once

#include <cuda_runtime.h>

// out[6] = {registers, local bytes a thread (spills), static shared bytes,
// dynamic shared bytes, CTAs an SM holds, threads a CTA} of `kernel`
// launched with `threads` threads and `dynamic_smem` bytes of dynamic
// shared memory (its MaxDynamicSharedMemorySize already raised to that).
template <typename F>
inline int describe_kernel(F kernel, int threads, int dynamic_smem,
                           int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    dynamic_smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = dynamic_smem;
  out[4] = blocks;
  out[5] = threads;
  return 0;
}
