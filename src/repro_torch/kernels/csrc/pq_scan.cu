// PQ ADC scan of N code rows against one query's lookup table, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/pq_scan.py (`pq_scan` /
// `_pq_scan_kernel`). Plain version: repro_torch/kernels/ref.py
// `pq_scan_ref`.
//
// For each row n it computes out[n] = sum_m table[m, codes[n, m]], with
// codes (N, M) uint8 or int32 and table (M, K) float32. A code is read the
// way XLA's gather reads the JAX package's reference: a negative code wraps
// once (code + K), then it is clamped to [0, K-1], so no read leaves the
// table. On the search path every code is already in [0, K).
//
// What bounds it on the card: bytes. Per row it reads M code bytes (16 at
// M=16) and writes 4; the M table lookups hit shared memory and the M
// additions are far under the card's float32 rate.
//
// What the design does about that: a block of 256 threads stages the
// (M, K) table in shared memory once (16 KB at M=16, K=256) and then each
// thread takes one code row at a time, in a grid-stride loop over a grid
// capped at 8 blocks per SM, so the table is staged ~1,000 times and not
// once per 256 rows. The TPU kernel's one-hot compare + lane reduction (a
// gather rephrased for the vector unit) becomes a direct shared-memory
// gather. A thread reads its row as 16-byte loads where the row is a whole
// number of 16-byte words and the base is aligned (M=16 uint8: one load),
// so a warp reads 512 contiguous bytes per instruction. The sum runs
// m = 0..M-1 in that order with each addition rounded alone (__fadd_rn, no
// contraction), the plain version's and the JAX package's order, so the
// result is bit-identical to both. Shared-memory bank conflicts of the
// random gather and TMA staging of code tiles are left for later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define PQ_THREADS 256
#define PQ_BLOCKS_PER_SM 8

template <typename CodeT>
__device__ __forceinline__ float add_code(float d, CodeT raw, int m, int K,
                                          const float* s_table) {
  int c = (int)raw;
  if (c < 0) c += K;
  c = c < 0 ? 0 : (c >= K ? K - 1 : c);
  return __fadd_rn(d, s_table[m * K + c]);
}

template <typename CodeT>
__global__ void pq_scan_kernel(const CodeT* __restrict__ codes,
                               const float* __restrict__ table,
                               float* __restrict__ out, long long N, int M,
                               int K, bool wide) {
  extern __shared__ float s_table[];  // M * K floats
  for (int i = threadIdx.x; i < M * K; i += blockDim.x) s_table[i] = table[i];
  __syncthreads();

  constexpr int PER = 16 / sizeof(CodeT);  // codes per 16-byte load
  union Word {
    uint4 v;
    CodeT c[PER];
  };
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    const CodeT* cp = codes + n * M;
    float d = 0.0f;
    if (wide) {
      const uint4* wp = reinterpret_cast<const uint4*>(cp);
      const int words = M / PER;
      for (int w = 0; w < words; ++w) {
        Word u;
        u.v = __ldg(wp + w);
#pragma unroll
        for (int j = 0; j < PER; ++j)
          d = add_code(d, u.c[j], w * PER + j, K, s_table);
      }
    } else {
      for (int m = 0; m < M; ++m) d = add_code(d, cp[m], m, K, s_table);
    }
    out[n] = d;
  }
}

template <typename CodeT>
static int pq_scan_launch(const void* codes, const void* table, void* out,
                          long long N, int M, int K, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool wide = ((size_t)M * sizeof(CodeT)) % 16 == 0 &&
                    ((uintptr_t)codes) % 16 == 0;
  long long blocks = (N + PQ_THREADS - 1) / PQ_THREADS;
  const long long cap = (long long)sms * PQ_BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  size_t smem = (size_t)M * K * sizeof(float);
  pq_scan_kernel<CodeT><<<(unsigned)blocks, PQ_THREADS, smem,
                          (cudaStream_t)stream>>>(
      (const CodeT*)codes, (const float*)table, (float*)out, N, M, K, wide);
  return (int)cudaGetLastError();
}

extern "C" int pq_scan_u8_launch(const void* codes, const void* table,
                                 void* out, long long N, int M, int K,
                                 void* stream) {
  return pq_scan_launch<uint8_t>(codes, table, out, N, M, K, stream);
}

extern "C" int pq_scan_i32_launch(const void* codes, const void* table,
                                  void* out, long long N, int M, int K,
                                  void* stream) {
  return pq_scan_launch<int32_t>(codes, table, out, N, M, K, stream);
}
