// RobustPrune domination scan of the Vamana build, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/prune_scan.py
// (`prune_scan` / `_prune_scan_kernel`). Plain version:
// repro_torch/kernels/ref.py `prune_scan_ref`.
//
// Per row: candidates arrive sorted by distance to the insert point. Lane i
// is kept if it is not yet pruned, fewer than r lanes are kept and dp[i] is
// finite; a kept lane i prunes every lane j with a2 * dcc[i][j] <= dp[j].
// Returns the (B, C) keep mask.
//
// What bounds it on the card: bytes, and the sequential dependence in i.
// Only the dcc rows of kept lanes are ever read (at most r of C), plus dp
// once and the mask once; the work per row is a chain of C dependent steps.
//
// What the design does about that: one block per row, one thread per lane
// (C <= 1024). dp, the pruned/keep flags and the kept count live in shared
// memory; the i loop runs in the block with two barriers per step, and a
// step whose lane is not kept reads nothing from device memory. When lane i
// is kept, its dcc row is read once, coalesced across the block's threads.
// Many rows (1024 per build batch) fill the card's SMs. The TPU kernel
// pulled scalars out of (1, C) vectors with one-hot sums; here each scalar
// is a plain shared-memory read. The test is the one f32 product a2*dcc
// (__fmul_rn) and comparisons, so the mask is bit-exact with the plain
// version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__global__ void prune_scan_kernel(const float* __restrict__ dp,
                                  const float* __restrict__ dcc,
                                  uint8_t* __restrict__ keep, int C,
                                  float a2, int r) {
  extern __shared__ unsigned char smem[];
  float* s_dp = (float*)smem;                       // C floats
  uint8_t* s_pruned = (uint8_t*)(s_dp + C);         // C flags
  uint8_t* s_keep = s_pruned + C;                   // C flags
  __shared__ int s_nk;

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const float* dpr = dp + (size_t)b * C;
  const float* dccr = dcc + (size_t)b * C * C;
  if (j < C) {
    s_dp[j] = dpr[j];
    s_pruned[j] = 0;
    s_keep[j] = 0;
  }
  if (j == 0) s_nk = 0;
  __syncthreads();

  for (int i = 0; i < C; ++i) {
    const bool act = !s_pruned[i] && s_nk < r && isfinite(s_dp[i]);
    __syncthreads();                      // every thread has read the state
    if (act) {
      if (j < C && __fmul_rn(a2, dccr[(size_t)i * C + j]) <= s_dp[j])
        s_pruned[j] = 1;
      if (j == i) {
        s_pruned[i] = 1;
        s_keep[i] = 1;
      }
      if (j == 0) s_nk += 1;
    }
    __syncthreads();                      // the updates are visible
  }
  if (j < C) keep[(size_t)b * C + j] = s_keep[j];
}

extern "C" int prune_scan_launch(const void* dp, const void* dcc, void* keep,
                                 int B, int C, float a2, int r,
                                 void* stream) {
  if (C > 1024) return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return (int)cudaSuccess;
  const int threads = ((C + 31) / 32) * 32;
  const size_t smem = (size_t)C * sizeof(float) + 2 * (size_t)C;
  prune_scan_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)dp, (const float*)dcc, (uint8_t*)keep, C, a2, r);
  return (int)cudaGetLastError();
}
