// Fused per-hop candidate pass of speculative in-filtering, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/hop_fused.py
// (`hop_fused` / `_hop_fused_kernel`). Plain versions:
// repro_torch/kernels/ref.py `hop_fused_ref` (slab entry) and
// `hop_fused_gather_ref` (gathered entry).
//
// For each candidate c of query b it computes the PQ ADC distance
// sum_m table[b, m, code[c, m]], the bloom-word AND/OR probes, the rare-list
// bit, the NR bucket-range slots and their label/range combine, and writes
// key = d + (ok ? 0 : 1e12) and ok. One kernel serves two entries:
//   * slab: the candidate rows arrive gathered as (B, C) slabs (codes
//     (B, C, M) uint8, blooms (B, C), buckets (B, C, F), in_merged (B, C)
//     bool), the TPU kernel's contract;
//   * gathered: the kernel reads ids (B, C) and gathers its own rows from the
//     in-memory stores (codes (N, M), blooms (N,), buckets (N, F)) and the
//     rare-list bit from query b's bitmap row (B, NW) of 32-bit words. An id
//     outside [0, N) reads nothing of the stores and writes key = +inf,
//     ok = 0.
//
// What bounds it on the card: at the hop's shape (B = 64, C = 512, M = 16,
// K = 256) it moves ~2 MB (~0.6 us at 3.35 TB/s) and does a few integer ops
// per byte, so it sits on the launch floor plus one chain of dependent
// memory waits per candidate: id, then its rows, then the table lookups.
// At M = 64 (768-d vectors at 12 dimensions a subspace) a query's table is
// 64 KB: ~6.7 MB move (2.1 MB of code rows, 4.2 MB of tables; ~2 us), the
// bulk copy of each block is four times longer before its first sum, and
// each candidate makes 64 shared-memory lookups in place of 16.
//
// What the design does about it:
//   * one block per query stages the (M, K) float32 table (16 KB at M = 16,
//     64 KB at M = 64) once, by one bulk asynchronous copy (cp.async.bulk)
//     that thread 0 issues first and that completes on an mbarrier. The
//     block's one barrier comes next, before any memory wait, and only
//     publishes the mbarrier's initialisation. A table over the 48 KB that
//     a launch may take by default needs the kernel's opt-in to the card's
//     limit (227 KB a block on the H100), which each instantiation asks for
//     once, at its first launch over 48 KB; three 64 KB blocks fit an SM;
//   * meanwhile every thread issues its own candidate's loads: the id, then
//     the code row as 16-byte loads (one, two or four for M = 16, 32, 64;
//     8 or 4 bytes for M = 8 or 4; bytes for other M), the bucket words,
//     the bloom word and the rare-list word. It computes ok, which needs no
//     table, and waits on the mbarrier only for the ADC sum;
//   * up to 512 threads, one candidate each at C = 512, keep 16 warps of
//     loads in flight on each of the B SMs in use. Two blocks per query
//     would fill more SMs but stage each table twice, and the time is a
//     latency chain that more SMs do not shorten. At B = 1 (the serving
//     tier's small batches) one block takes the whole slab.
// The sum runs m = 0..M-1 in that order with each addition rounded alone
// (__fadd_rn, no contraction), the plain version's and the JAX package's
// order, so the key is bit-identical to both.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_optin.cuh"

#define HF_MAX_THREADS 512
#define HF_TABLE_OFFSET 16          // bytes of dynamic smem before the table

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}" :: "r"(bar), "r"(phase) : "memory");
}

// A code row of M_T bytes as 32-bit words, by one vector load (two or four
// 16-byte loads for M_T = 32 or 64).
template <int M_T>
__device__ __forceinline__ void load_row(const uint8_t* p,
                                         uint32_t (&w)[M_T / 4]) {
  if constexpr (M_T == 32 || M_T == 64) {
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < M_T / 16; ++i) {
      const uint4 v = __ldg(p4 + i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (M_T == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (M_T == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// GATHER: rows come from the stores through ids (else from the slab).
// M_T: M known at compile time (4, 8, 16, 32, 64: vector loads), or 0
// (bytes).
template <bool GATHER, int M_T>
__global__ void __launch_bounds__(HF_MAX_THREADS)
hop_fused_kernel(const int32_t* __restrict__ ids, long long N,
                 const uint8_t* __restrict__ codes,
                 const int32_t* __restrict__ blooms,
                 const int32_t* __restrict__ buckets,
                 const uint8_t* __restrict__ in_merged,
                 const int32_t* __restrict__ merged_words, int NW,
                 const float* __restrict__ table,
                 const int32_t* __restrict__ scalars,
                 const int32_t* __restrict__ or_masks,
                 const int32_t* __restrict__ range_field,
                 const int32_t* __restrict__ bucket_lo,
                 const int32_t* __restrict__ bucket_hi,
                 float* __restrict__ key, uint8_t* __restrict__ ok, int C,
                 int M, int K, int F, int QL, int NR) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_table = reinterpret_cast<float*>(smem + HF_TABLE_OFFSET);
  const uint32_t bar = smem_addr(smem);
  const int b = blockIdx.x;

  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)(M * K * sizeof(float));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar),
                 "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_addr(s_table)), "l"(table + (size_t)b * M * K),
           "r"(bytes), "r"(bar) : "memory");
  }
  __syncthreads();                  // the mbarrier is initialised

  const int32_t* sc = scalars + b * 4;
  const int32_t and_mask = __ldg(sc), label_mode = __ldg(sc + 1);
  const int32_t merged_mode = __ldg(sc + 2), combine = __ldg(sc + 3);
  const int32_t* om_b = or_masks + b * QL;
  const int32_t* rf_b = range_field + b * NR;
  const int32_t* lo_b = bucket_lo + b * NR;
  const int32_t* hi_b = bucket_hi + b * NR;
  bool waited = false;

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const size_t slot = (size_t)b * C + c;
    size_t row = slot;
    int32_t id = 0;
    if constexpr (GATHER) {
      id = __ldg(ids + slot);
      if (id < 0 || (long long)id >= N) {
        key[slot] = INFINITY;
        ok[slot] = 0;
        continue;
      }
      row = (size_t)id;
    }
    uint32_t w[M_T > 0 ? M_T / 4 : 1];
    if constexpr (M_T > 0) load_row<M_T>(codes + row * M_T, w);

    // NR bucket-range slots (AND over the active ones), first, so that
    // their loads leave with the row's; a field past the last column reads
    // 0, as in the TPU kernel
    const int32_t* bk = buckets + row * F;
    bool range_ok = true, range_present = false;
#pragma unroll 4
    for (int j = 0; j < NR; ++j) {
      const int32_t f = __ldg(rf_b + j);
      const int32_t v = (f >= 0 && f < F) ? __ldg(bk + f) : 0;
      if (f >= 0) {
        range_ok &= (v >= __ldg(lo_b + j)) & (v <= __ldg(hi_b + j));
        range_present = true;
      }
    }

    // frequent-label Bloom probes and the rare-list bit
    const int32_t bl = __ldg(blooms + row);
    bool inm;
    if constexpr (GATHER) {
      const uint32_t mw =
          (uint32_t)__ldg(merged_words + (size_t)b * NW + (id >> 5));
      inm = (mw >> (id & 31)) & 1u;
    } else {
      inm = in_merged[slot] != 0;
    }
    const bool and_ok = (bl & and_mask) == and_mask;
    bool hit_any = false, has_or = false;
#pragma unroll 8
    for (int j = 0; j < QL; ++j) {
      const int32_t om = __ldg(om_b + j);
      has_or |= om != 0;
      hit_any |= (om != 0) && ((bl & om) == om);
    }
    const bool label_or = merged_mode == 1 ? (inm || hit_any)
                                           : (has_or ? hit_any : false);
    const bool label_and = merged_mode == 2 ? (inm && and_ok) : and_ok;
    const bool label_ok = label_mode == 1 ? label_and
                          : (label_mode == 2 ? label_or : true);
    const bool label_present = label_mode != 0;
    const bool ok_and = (label_ok || !label_present) &&
                        (range_ok || !range_present);
    const bool ok_or = (label_ok && label_present) ||
                       (range_ok && range_present);
    const bool okv = (label_present || range_present)
                         ? (combine == 1 ? ok_or : ok_and) : true;

    // PQ ADC distance, m in order, each addition rounded alone
    if (!waited) {
      mbar_wait(bar, 0);
      waited = true;
    }
    float d = 0.0f;
    if constexpr (M_T > 0) {
#pragma unroll
      for (int m = 0; m < M_T; ++m) {
        const uint32_t code = (w[m >> 2] >> (8 * (m & 3))) & 0xFFu;
        d = __fadd_rn(d, s_table[m * K + code]);
      }
    } else {
      const uint8_t* cp = codes + row * M;
      for (int m = 0; m < M; ++m)
        d = __fadd_rn(d, s_table[m * K + __ldg(cp + m)]);
    }
    key[slot] = __fadd_rn(d, okv ? 0.0f : 1e12f);
    ok[slot] = okv ? 1 : 0;
  }
  // the copy must land before the block's shared memory is released
  if (threadIdx.x == 0 && !waited) mbar_wait(bar, 0);
}

// The most dynamic shared memory a block of hop_fused_kernel<GATHER, M_T>
// may take, its opt-in asked for once per instantiation and process.
template <bool GATHER, int M_T>
static size_t hf_smem_limit() {
  static const size_t limit =
      smem_optin_limit((const void*)hop_fused_kernel<GATHER, M_T>);
  return limit;
}

template <bool GATHER>
static int hop_fused_dispatch(const void* ids, long long N, const void* codes,
                              const void* blooms, const void* buckets,
                              const void* in_merged, const void* merged_words,
                              int NW, const void* table, const void* scalars,
                              const void* or_masks, const void* range_field,
                              const void* bucket_lo, const void* bucket_hi,
                              void* key, void* ok, int B, int C, int M, int K,
                              int F, int QL, int NR, void* stream) {
  const size_t smem = HF_TABLE_OFFSET + (size_t)M * K * sizeof(float);
  if ((M * K) % 4 != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return (int)cudaSuccess;
  int threads = ((C + 31) / 32) * 32;
  if (threads > HF_MAX_THREADS) threads = HF_MAX_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
#define HF_LAUNCH(MT)                                                       \
  if (smem > SMEM_DEFAULT_BYTES && smem > hf_smem_limit<GATHER, MT>())      \
    return (int)cudaErrorInvalidValue;                                      \
  hop_fused_kernel<GATHER, MT><<<B, threads, smem, st>>>(                   \
      (const int32_t*)ids, N, (const uint8_t*)codes,                        \
      (const int32_t*)blooms, (const int32_t*)buckets,                      \
      (const uint8_t*)in_merged, (const int32_t*)merged_words, NW,          \
      (const float*)table, (const int32_t*)scalars,                         \
      (const int32_t*)or_masks, (const int32_t*)range_field,                \
      (const int32_t*)bucket_lo, (const int32_t*)bucket_hi, (float*)key,    \
      (uint8_t*)ok, C, M, K, F, QL, NR)
  switch (M) {
    case 4: HF_LAUNCH(4); break;
    case 8: HF_LAUNCH(8); break;
    case 16: HF_LAUNCH(16); break;
    case 32: HF_LAUNCH(32); break;
    case 64: HF_LAUNCH(64); break;
    default: HF_LAUNCH(0); break;
  }
#undef HF_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int hop_fused_launch(const void* codes, const void* blooms,
                                const void* buckets, const void* in_merged,
                                const void* table, const void* scalars,
                                const void* or_masks, const void* range_field,
                                const void* bucket_lo, const void* bucket_hi,
                                void* key, void* ok, int B, int C, int M,
                                int K, int F, int QL, int NR, void* stream) {
  return hop_fused_dispatch<false>(
      nullptr, 0, codes, blooms, buckets, in_merged, nullptr, 0, table,
      scalars, or_masks, range_field, bucket_lo, bucket_hi, key, ok, B, C, M,
      K, F, QL, NR, stream);
}

extern "C" int hop_fused_gather_launch(
    const void* codes, const void* blooms, const void* buckets,
    const void* merged_words, const void* ids, const void* table,
    const void* scalars, const void* or_masks, const void* range_field,
    const void* bucket_lo, const void* bucket_hi, void* key, void* ok,
    long long N, int NW, int B, int C, int M, int K, int F, int QL, int NR,
    void* stream) {
  return hop_fused_dispatch<true>(
      ids, N, codes, blooms, buckets, nullptr, merged_words, NW, table,
      scalars, or_masks, range_field, bucket_lo, bucket_hi, key, ok, B, C, M,
      K, F, QL, NR, stream);
}
