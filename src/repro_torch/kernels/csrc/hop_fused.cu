// Fused per-hop candidate pass of speculative in-filtering, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/hop_fused.py
// (`hop_fused` / `_hop_fused_kernel`). Plain version:
// repro_torch/kernels/ref.py `hop_fused_ref`.
//
// For each candidate c of query b it computes the PQ ADC distance
// sum_m table[b, m, code[c, m]], the bloom-word AND/OR probes, the rare-list
// bit `in_merged`, the NR bucket-range slots and their label/range combine,
// and writes key = d + (ok ? 0 : 1e12) and ok.
//
// What bounds it on the card: bytes. Per candidate it reads M code bytes,
// one bloom word, F bucket words and one flag, and writes 5 bytes; the M
// table lookups hit shared memory and the arithmetic is a handful of
// integer ops, far under the card's operation rate.
//
// What the design does about that: one block of 256 threads per
// (256 candidates, query); the block stages query b's (M, K) float32 table
// (16 KB at M=16, K=256) and its filter parameters in shared memory once,
// so device memory sees each input byte once. The TPU kernel's one-hot
// compare + lane reduction (a gather rephrased for the vector unit) becomes
// a direct shared-memory gather. Codes are read as uint8 straight from the
// slab. The sum runs m = 0..M-1 in that order with each addition rounded
// alone (__fadd_rn, no contraction), which is the plain version's and the
// JAX package's order, so the key is bit-identical to both.
#include <cuda_runtime.h>
#include <stdint.h>

#define HF_THREADS 256
#define HF_MAX_QL 64
#define HF_MAX_NR 32

__global__ void hop_fused_kernel(const uint8_t* __restrict__ codes,
                                 const int32_t* __restrict__ blooms,
                                 const int32_t* __restrict__ buckets,
                                 const uint8_t* __restrict__ in_merged,
                                 const float* __restrict__ table,
                                 const int32_t* __restrict__ scalars,
                                 const int32_t* __restrict__ or_masks,
                                 const int32_t* __restrict__ range_field,
                                 const int32_t* __restrict__ bucket_lo,
                                 const int32_t* __restrict__ bucket_hi,
                                 float* __restrict__ key,
                                 uint8_t* __restrict__ ok,
                                 int C, int M, int K, int F, int QL, int NR) {
  extern __shared__ float s_table[];              // M * K floats
  __shared__ int32_t s_scal[4];
  __shared__ int32_t s_om[HF_MAX_QL];
  __shared__ int32_t s_rf[HF_MAX_NR];
  __shared__ int32_t s_lo[HF_MAX_NR];
  __shared__ int32_t s_hi[HF_MAX_NR];

  const int b = blockIdx.y;
  const float* tb = table + (size_t)b * M * K;
  for (int i = threadIdx.x; i < M * K; i += blockDim.x) s_table[i] = tb[i];
  if (threadIdx.x < 4) s_scal[threadIdx.x] = scalars[b * 4 + threadIdx.x];
  for (int i = threadIdx.x; i < QL; i += blockDim.x)
    s_om[i] = or_masks[b * QL + i];
  for (int i = threadIdx.x; i < NR; i += blockDim.x) {
    s_rf[i] = range_field[b * NR + i];
    s_lo[i] = bucket_lo[b * NR + i];
    s_hi[i] = bucket_hi[b * NR + i];
  }
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t row = (size_t)b * C + c;

  // PQ ADC distance, m in order, each addition rounded alone
  const uint8_t* cp = codes + row * M;
  float d = 0.0f;
  for (int m = 0; m < M; ++m) d = __fadd_rn(d, s_table[m * K + cp[m]]);

  // frequent-label Bloom probes
  const int32_t bl = blooms[row];
  const int32_t and_mask = s_scal[0], label_mode = s_scal[1];
  const int32_t merged_mode = s_scal[2], combine = s_scal[3];
  const bool and_ok = (bl & and_mask) == and_mask;
  bool hit_any = false, has_or = false;
  for (int j = 0; j < QL; ++j) {
    const int32_t om = s_om[j];
    has_or |= om != 0;
    hit_any |= (om != 0) && ((bl & om) == om);
  }
  const bool inm = in_merged[row] != 0;
  const bool label_or = merged_mode == 1 ? (inm || hit_any)
                                         : (has_or ? hit_any : false);
  const bool label_and = merged_mode == 2 ? (inm && and_ok) : and_ok;
  const bool label_ok = label_mode == 1 ? label_and
                        : (label_mode == 2 ? label_or : true);
  const bool label_present = label_mode != 0;

  // NR bucket-range slots (AND over the active ones)
  bool range_ok = true, range_present = false;
  const int32_t* bk = buckets + row * F;
  for (int j = 0; j < NR; ++j) {
    const int32_t f = s_rf[j];
    if (f >= 0) {
      const int32_t v = f < F ? bk[f] : 0;
      range_ok = range_ok && (v >= s_lo[j]) && (v <= s_hi[j]);
      range_present = true;
    }
  }

  const bool ok_and = (label_ok || !label_present) &&
                      (range_ok || !range_present);
  const bool ok_or = (label_ok && label_present) ||
                     (range_ok && range_present);
  const bool okv = (label_present || range_present)
                       ? (combine == 1 ? ok_or : ok_and) : true;
  key[row] = __fadd_rn(d, okv ? 0.0f : 1e12f);
  ok[row] = okv ? 1 : 0;
}

extern "C" int hop_fused_launch(const void* codes, const void* blooms,
                                const void* buckets, const void* in_merged,
                                const void* table, const void* scalars,
                                const void* or_masks, const void* range_field,
                                const void* bucket_lo, const void* bucket_hi,
                                void* key, void* ok, int B, int C, int M,
                                int K, int F, int QL, int NR, void* stream) {
  if (QL > HF_MAX_QL || NR > HF_MAX_NR) return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return (int)cudaSuccess;
  dim3 grid((C + HF_THREADS - 1) / HF_THREADS, B);
  size_t smem = (size_t)M * K * sizeof(float);
  hop_fused_kernel<<<grid, HF_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)blooms, (const int32_t*)buckets,
      (const uint8_t*)in_merged, (const float*)table,
      (const int32_t*)scalars, (const int32_t*)or_masks,
      (const int32_t*)range_field, (const int32_t*)bucket_lo,
      (const int32_t*)bucket_hi, (float*)key, (uint8_t*)ok, C, M, K, F, QL,
      NR);
  return (int)cudaGetLastError();
}
