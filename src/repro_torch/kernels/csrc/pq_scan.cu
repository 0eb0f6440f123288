// PQ ADC scan of code rows against one query's lookup table, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/pq_scan.py (`pq_scan` /
// `_pq_scan_kernel`). Plain versions: repro_torch/kernels/ref.py
// `pq_scan_ref` (slab entry) and `pq_scan_gather_ref` (gathered entry).
//
// For each entry n it computes out[n] = sum_m table[m, codes[row, m]], with
// codes (rows, M) uint8 or int32 and table (M, K) float32. The slab entry
// reads row n; the gathered entry reads row ids[n], and an id outside
// [0, rows) reads nothing and gives +inf. A code is read the way XLA's
// gather reads the JAX package's reference: a negative code wraps once
// (code + K), then it is clamped to [0, K-1], so no read leaves the table.
// On the search path every code is already in [0, K). The sum runs
// m = 0..M-1 in that order with each addition rounded alone (__fadd_rn, no
// contraction), the plain version's and the JAX package's order, so the
// result is bit-identical to both.
//
// What bounds it on the card. Bytes: per row M code bytes (16 at M = 16)
// and 4 out, 20 MB at 1M rows, 5.98 us at 3.35 TB/s (a scan that finds the
// 16 MB of codes in the 50 MB L2 runs under that). Shared memory: the M
// lookups of a row are random 4-byte reads; with entry c of every subtable
// in bank c mod 32, 32 random codes put ~3.5 reads on a warp's fullest
// bank. Below ~100,000 rows: the latency of staging the table before the
// first lookup. At M = 64 (768-d vectors at 12 dimensions a subspace) a row
// is 64 code bytes and the table 64 KB: four times the bytes a row and the
// lookups, and a table that only three blocks of an SM can hold at once.
//
// The design: blocks of 256 threads, at most 8 on each SM and no more than
// the SM's shared memory holds with each block's table (8 up to 16 KB, 3 at
// 64 KB), stage the (M, K) table in 16-byte copies (one round trip to L2
// for 16 KB, where 4-byte copies took 5.8 us at 50,000 rows against 3.8)
// and take a row a thread in a grid-stride loop, reading it in 16-byte
// loads where the row is a whole number of 16-byte words on an aligned base
// (M = 16 uint8: one load; M = 64: four), else a code at a time. A table
// over the 48 KB a launch may take by default needs the kernel's opt-in to
// the card's limit (227 KB a block on the H100), which each instantiation
// asks for once, at its first launch over 48 KB.
//
// Measured with tools/ab_full_phase.py --phase kernels on NVIDIA H100 80GB
// HBM3, 700.00 W (PERF.md, runs 15b-15e), and dropped:
// * one block per SM in a persistent grid over the (M, K) layout, the
//   first row loaded before or while the table is staged: 12.9-13.5 us at
//   1M rows against 12.9 for the 256-row blocks, 6.2-6.4 at 50,000;
// * a persistent kernel with bank-conflict-free lookups (32/G copies of the
//   table, lanes reading their subtables in a rotated order, the values
//   rotated back with log2(G) stages of selects for the same sum): 10.1 us
//   at 1M rows with the codes in L2 against 11.5 for this kernel, but 18.0
//   against 16.9 with the L2 evicted and 6.1-6.7 against 3.8 at 50,000
//   rows. Which of the two states the scan rung meets between its other
//   calls is not measured, so the second kernel was not kept;
//   G = M = 16 and G = 8 took 14.8 and 12.9 us hot at 1M.
//
// nvcc -Xptxas -v (sm_90a): 31-32 registers, no spills, M*K*4 bytes of
// dynamic shared memory (16 KB at M = 16, 64 KB at M = 64, K = 256).
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_optin.cuh"

#define PQ_THREADS 256
#define PQ_BLOCKS_PER_SM 8

// A code read as XLA's gather reads it: wrap once, then clamp to [0, K-1].
__device__ __forceinline__ int clamp_code(int c, int K) {
  if (c < 0) c += K;
  return c < 0 ? 0 : (c >= K ? K - 1 : c);
}

// The code row of entry n: row n of the slab, or row ids[n] of the store;
// -1 when that id lies outside [0, rows).
template <bool GATHER>
__device__ __forceinline__ long long row_of(const int32_t* __restrict__ ids,
                                            long long n, long long rows) {
  if (!GATHER) return n;
  const long long id = __ldg(ids + n);
  return (id >= 0 && id < rows) ? id : -1;
}

template <typename CodeT, bool GATHER>
__global__ void pq_scan_kernel(const CodeT* __restrict__ codes,
                               const int32_t* __restrict__ ids,
                               const float* __restrict__ table,
                               float* __restrict__ out, long long N,
                               long long rows, int M, int K, bool wide,
                               bool vec_table) {
  extern __shared__ float s_table[];  // M * K floats
  if (vec_table) {  // 16-byte copies: one round trip to L2 at M*K = 4,096
    const float4* t4 = reinterpret_cast<const float4*>(table);
    float4* s4 = reinterpret_cast<float4*>(s_table);
    for (int i = threadIdx.x; i < M * K / 4; i += blockDim.x)
      s4[i] = __ldg(t4 + i);
  } else {
    for (int i = threadIdx.x; i < M * K; i += blockDim.x)
      s_table[i] = table[i];
  }
  __syncthreads();

  constexpr int PER = 16 / sizeof(CodeT);  // codes per 16-byte load
  union Word {
    uint4 v;
    CodeT c[PER];
  };
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    const long long r = row_of<GATHER>(ids, n, rows);
    if (r < 0) {
      out[n] = __int_as_float(0x7f800000);  // +inf
      continue;
    }
    const CodeT* cp = codes + r * M;
    float d = 0.0f;
    if (wide) {
      const uint4* wp = reinterpret_cast<const uint4*>(cp);
      const int words = M / PER;
      for (int w = 0; w < words; ++w) {
        Word u;
        u.v = __ldg(wp + w);
#pragma unroll
        for (int j = 0; j < PER; ++j)
          d = __fadd_rn(d, s_table[(w * PER + j) * K +
                                   clamp_code((int)u.c[j], K)]);
      }
    } else {
      for (int m = 0; m < M; ++m)
        d = __fadd_rn(d, s_table[m * K + clamp_code((int)cp[m], K)]);
    }
    out[n] = d;
  }
}

// The most dynamic shared memory a block of pq_scan_kernel<CodeT, GATHER>
// may take, its opt-in asked for once per instantiation and process.
template <typename CodeT, bool GATHER>
static size_t pq_smem_limit() {
  static const size_t limit =
      smem_optin_limit((const void*)pq_scan_kernel<CodeT, GATHER>);
  return limit;
}

// The SM's shared memory and the per-block reserve, in bytes, read once per
// process; 0 where the card's attributes cannot be read.
struct PqSmemSizes {
  long long per_sm, reserved;
};

static PqSmemSizes pq_smem_sizes(int dev) {
  static const PqSmemSizes sizes = [dev] {
    int per_sm = 0, reserved = 0;
    if (cudaDeviceGetAttribute(&per_sm,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock,
                               dev) != cudaSuccess)
      return PqSmemSizes{0, 0};
    return PqSmemSizes{per_sm, reserved};
  }();
  return sizes;
}

// Blocks of `smem` bytes of dynamic shared memory that one SM holds at
// once, at most PQ_BLOCKS_PER_SM; 0 where the card's attributes cannot be
// read.
static int pq_blocks_per_sm(int dev, size_t smem) {
  const PqSmemSizes sz = pq_smem_sizes(dev);
  if (sz.per_sm == 0) return 0;
  const long long fit = sz.per_sm / ((long long)smem + sz.reserved);
  if (fit < 1) return 1;
  return fit > PQ_BLOCKS_PER_SM ? PQ_BLOCKS_PER_SM : (int)fit;
}

template <typename CodeT, bool GATHER>
static int pq_scan_launch(const void* codes, const void* ids,
                          const void* table, void* out, long long N,
                          long long rows, int M, int K, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wide = ((size_t)M * sizeof(CodeT)) % 16 == 0 &&
                    ((uintptr_t)codes) % 16 == 0;
  const size_t smem = (size_t)M * K * sizeof(float);
  if (smem > SMEM_DEFAULT_BYTES && smem > pq_smem_limit<CodeT, GATHER>())
    return (int)cudaErrorInvalidValue;
  const int per_sm = pq_blocks_per_sm(dev, smem);
  if (per_sm == 0) return (int)cudaErrorInvalidValue;
  long long blocks = (N + PQ_THREADS - 1) / PQ_THREADS;
  const long long cap = (long long)sms * per_sm;
  if (blocks > cap) blocks = cap;
  pq_scan_kernel<CodeT, GATHER><<<(unsigned)blocks, PQ_THREADS, smem, s>>>(
      (const CodeT*)codes, (const int32_t*)ids, (const float*)table,
      (float*)out, N, rows, M, K, wide,
      (M * K) % 4 == 0 && ((uintptr_t)table) % 16 == 0);
  return (int)cudaGetLastError();
}

extern "C" int pq_scan_u8_launch(const void* codes, const void* table,
                                 void* out, long long N, int M, int K,
                                 void* stream) {
  return pq_scan_launch<uint8_t, false>(codes, nullptr, table, out, N, N, M,
                                        K, stream);
}

extern "C" int pq_scan_i32_launch(const void* codes, const void* table,
                                  void* out, long long N, int M, int K,
                                  void* stream) {
  return pq_scan_launch<int32_t, false>(codes, nullptr, table, out, N, N, M,
                                        K, stream);
}

extern "C" int pq_scan_gather_u8_launch(const void* codes, const void* ids,
                                        const void* table, void* out,
                                        long long C, long long rows, int M,
                                        int K, void* stream) {
  return pq_scan_launch<uint8_t, true>(codes, ids, table, out, C, rows, M, K,
                                       stream);
}

extern "C" int pq_scan_gather_i32_launch(const void* codes, const void* ids,
                                         const void* table, void* out,
                                         long long C, long long rows, int M,
                                         int K, void* stream) {
  return pq_scan_launch<int32_t, true>(codes, ids, table, out, C, rows, M, K,
                                       stream);
}
