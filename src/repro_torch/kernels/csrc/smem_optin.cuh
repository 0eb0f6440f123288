// Dynamic shared memory beyond the 48 KB a launch may take unasked: the
// opt-in that hop_fused.cu and pq_scan.cu ask for where a query's lookup
// table is wider (64 KB at M = 64, K = 256).
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>

#define SMEM_DEFAULT_BYTES (48 * 1024)  // dynamic smem a launch takes unasked

// Opts `kernel` in to the card's limit of dynamic shared memory a block
// (cudaDevAttrMaxSharedMemoryPerBlockOptin: 227 KB on the H100) and returns
// that limit; 0 where the card refuses. A caller keeps the result in a
// static of its own, so each kernel asks once per process.
static inline size_t smem_optin_limit(const void* kernel) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin) != cudaSuccess)
    return 0;
  return (size_t)optin;
}
