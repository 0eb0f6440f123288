// RobustPrune domination scan of the Vamana build, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/prune_scan.py
// (`prune_scan` / `_prune_scan_kernel`). Plain version:
// repro_torch/kernels/ref.py `prune_scan_ref`.
//
// Per row: walking the lanes in index order, lane i is kept if it is not yet
// pruned, fewer than r lanes are kept and dp[i] is finite; a kept lane i
// prunes every lane j with a2 * dcc[i][j] <= dp[j]. Returns the (B, C) keep
// mask. Nothing assumes dp sorted: a non-finite lane is skipped, not an end.
//
// What bounds it on the card: the dependent chain of kept lanes (each kept
// lane's pruning decides the next one), the dcc rows of the kept lanes (at
// most r of the C rows are needed), and at the build's sizes (C <= 96,
// r = 32, 1024 rows) the launch floor.
//
// What the design does about it:
//   * one warp owns one row and a block holds PS_WARPS rows, so the only
//     synchronisation is the warp's own. Lane l owns columns l, l + 32, ...
//     (NT = ceil(C / 32) <= 32 of them): their dp values in registers,
//     their finite, pruned and kept flags as bits of three words;
//   * a step finds the next live column (finite, unpruned) directly: a
//     warp minimum (__reduce_min_sync) of each lane's lowest live bit t,
//     then __ballot_sync/__ffs for the lowest lane at that t. The loop makes
//     about as many steps as lanes are kept, not C;
//   * the dcc rows of the next D live columns (D = min(8, 32 / NT)) are
//     loaded at once, coalesced across the warp, before any of them is
//     applied; the columns are then taken in order, and one that an earlier
//     column of the batch pruned is skipped, so the walk is the sequential
//     one and only its loads are speculative. A row that keeps r of C (the
//     disconnected build's case) waits on r / D batches of loads instead of
//     r; there the kept rows' bytes, not the chain, then bound it. A deeper
//     batch that adapted its depth to the row gained nothing there and took
//     rows that prune heavily twice as long, and a find by one ballot per t
//     cost ~10% at C = 74 and 96 (PERF.md).
// The test is one float32 product a2 * dcc (__fmul_rn) and a comparison, so
// the mask is bit-exact with the plain version and ties break as the
// sequential loop breaks them, by lower index.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PS_WARPS 4
#define PS_MAX_DEPTH 8
#define PS_FULL 0xffffffffu

template <int NT, int D>
__global__ void __launch_bounds__(PS_WARPS * 32)
prune_scan_kernel(const float* __restrict__ dp, const float* __restrict__ dcc,
                  uint8_t* __restrict__ keep, int B, int C, float a2,
                  int r) {
  const int lane = threadIdx.x & 31;
  const int rowi = blockIdx.x * PS_WARPS + (threadIdx.x >> 5);
  if (rowi >= B) return;                    // the whole warp leaves
  const float* dpr = dp + (size_t)rowi * C;
  const float* dccr = dcc + (size_t)rowi * C * C;

  float dpv[NT];
  uint32_t fin = 0;                         // bit t: column lane + 32 t
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int j = lane + 32 * t;
    dpv[t] = j < C ? __ldg(dpr + j) : 0.0f;
    if (j < C && isfinite(dpv[t])) fin |= 1u << t;
  }
  uint32_t pruned = 0, kept = 0;
  int nk = 0;                               // the same in every lane
  while (nk < r) {
    // the next D live columns in index order, and their dcc rows
    uint32_t rem = fin & ~pruned;
    int col[D];
    float row[D][NT];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const unsigned low = rem ? (unsigned)(__ffs(rem) - 1) : 32u;
      const unsigned tmin = __reduce_min_sync(PS_FULL, low);
      col[k] = -1;
      if (tmin < 32) {
        const int owner = __ffs(__ballot_sync(PS_FULL, low == tmin)) - 1;
        if (lane == owner) rem &= ~(1u << tmin);
        col[k] = owner + 32 * (int)tmin;
        const float* rr = dccr + (size_t)col[k] * C;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int j = lane + 32 * t;
          row[k][t] = j < C ? __ldg(rr + j) : 0.0f;
        }
      }
    }
    if (col[0] < 0) break;                  // no live column left
    // take them in order; a column pruned by an earlier one is skipped
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (col[k] < 0 || nk >= r) break;
      const int owner = col[k] & 31, tk = col[k] >> 5;
      if ((__shfl_sync(PS_FULL, pruned, owner) >> tk) & 1u) continue;
#pragma unroll
      for (int t = 0; t < NT; ++t)
        if (__fmul_rn(a2, row[k][t]) <= dpv[t]) pruned |= 1u << t;
      if (lane == owner) {
        pruned |= 1u << tk;
        kept |= 1u << tk;
      }
      ++nk;
    }
  }

  uint8_t* kr = keep + (size_t)rowi * C;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int j = lane + 32 * t;
    if (j < C) kr[j] = (kept >> t) & 1u;
  }
}

template <int NT>
static void prune_scan_nt(const float* dp, const float* dcc, uint8_t* keep,
                          int B, int C, float a2, int r, cudaStream_t st) {
  // D rows of NT floats each in registers: at most 32 a lane
  constexpr int D = 32 / NT < PS_MAX_DEPTH ? 32 / NT : PS_MAX_DEPTH;
  const int blocks = (B + PS_WARPS - 1) / PS_WARPS;
  prune_scan_kernel<NT, D><<<blocks, PS_WARPS * 32, 0, st>>>(dp, dcc, keep,
                                                            B, C, a2, r);
}

extern "C" int prune_scan_launch(const void* dp, const void* dcc, void* keep,
                                 int B, int C, float a2, int r,
                                 void* stream) {
  if (C > 1024) return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return (int)cudaSuccess;
  const float* p = (const float*)dp;
  const float* q = (const float*)dcc;
  uint8_t* k = (uint8_t*)keep;
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = (C + 31) / 32;
  if (nt == 1) prune_scan_nt<1>(p, q, k, B, C, a2, r, st);
  else if (nt == 2) prune_scan_nt<2>(p, q, k, B, C, a2, r, st);
  else if (nt == 3) prune_scan_nt<3>(p, q, k, B, C, a2, r, st);
  else if (nt == 4) prune_scan_nt<4>(p, q, k, B, C, a2, r, st);
  else if (nt <= 8) prune_scan_nt<8>(p, q, k, B, C, a2, r, st);
  else if (nt <= 16) prune_scan_nt<16>(p, q, k, B, C, a2, r, st);
  else prune_scan_nt<32>(p, q, k, B, C, a2, r, st);
  return (int)cudaGetLastError();
}
