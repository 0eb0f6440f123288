// Single-field approximate-membership probe (Bloom AND/OR + bucket range),
// for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/approx_probe.py
// (`approx_probe` / `_probe_kernel`). Plain version:
// repro_torch/kernels/ref.py `approx_probe_ref`.
//
// For each candidate n it tests the 32-bit Bloom word blooms[n] against the
// query's AND mask and OR masks and the bucket code buckets[n] against
// [bucket_lo, bucket_hi], and combines the two as the param block says:
//   params = [and_mask, n_or_masks, bucket_lo, bucket_hi,
//             label_mode (0 none / 1 and / 2 or), range_on,
//             combine (0 and / 1 or), unused]
// Every OR mask is tested and a zero mask never hits; params[1] is ignored,
// as in the TPU kernel and the JAX package's oracle. An AND mask of 0
// admits every row. Bits are compared as int32; the bit patterns of a
// uint32 word and its int32 view are the same.
//
// What bounds it on the card: bytes, then instructions. Per row it reads a
// 4-byte word and a 1-byte (uint8) or 4-byte (int32) bucket code and
// writes one byte: 6 MB at 1M rows with uint8 codes, 1.79 us at 3.35 TB/s.
// The tests are a handful of integer operations a row, but with up to 8
// OR masks they are ~60 when each row is tested alone with predicates.
//
// What the design does about that: each thread takes R consecutive rows
// (R = 8 or 4 by pick_rows: 8 at 1M rows, 4 at 100,000), so the rows
// leave in vector loads (R Bloom words, R codes) and the results in one
// store of R bools, and the param block and the <= 8 OR masks are read once
// per thread, after its row loads are issued. The tests run over the R rows
// as bit masks (label, range), combined once, with the mode branches the
// same for the whole warp; the OR test is the least of (~w & m) over the 8
// masks, zero masks replaced by a nonzero one of the block (a zero mask
// never hits). The output is written as bytes 0/1 into the storage of a
// torch.bool tensor: no conversion pass. A thread whose rows run past N,
// or a call whose blooms, codes or output do not start on the vector
// width (a view such as blooms[1:]), takes the scalar path of the same
// kernel.
//
// Measured against the earlier one-row-a-thread kernel (7.4 us at 1M rows,
// 3.0 at 100,000), with tools/ab_full_phase.py --phase kernels on NVIDIA
// H100 80GB HBM3, 700.00 W (PERF.md), and dropped: R = 16: 4.97 us at 1M
// and 3.74 at 100,000 rows, against 4.75 and 2.90 for R = 8 and 4; R = 1
// or 2 with per-row predicate tests: 8.03 and 7.06 us at 1M.
//
// nvcc -Xptxas -v (sm_90a): 30-32 registers, no shared memory, no spills.
#include <cuda_runtime.h>
#include <stdint.h>

#define AP_THREADS 256
#define AP_MAX_OR 8

// The param block as one thread reads it. The OR masks that are zero
// (which never hit) are replaced by a nonzero one of the block, so the OR
// test needs no zero check; with none nonzero no row hits.
struct ProbeParams {
  uint32_t and_mask, om[AP_MAX_OR];
  int32_t lo, hi, label_mode;
  bool range_present, combine_or, any_or;
};

__device__ __forceinline__ ProbeParams read_params(
    const int32_t* __restrict__ params, const int32_t* __restrict__ or_masks,
    int QL) {
  ProbeParams p;
  p.and_mask = (uint32_t)__ldg(params + 0);
  p.lo = __ldg(params + 2);
  p.hi = __ldg(params + 3);
  p.label_mode = __ldg(params + 4);
  p.range_present = __ldg(params + 5) == 1;
  p.combine_or = __ldg(params + 6) == 1;
  uint32_t first = 0;
#pragma unroll
  for (int j = 0; j < AP_MAX_OR; ++j) {
    p.om[j] = j < QL ? (uint32_t)__ldg(or_masks + j) : 0u;
    if (first == 0) first = p.om[j];
  }
#pragma unroll
  for (int j = 0; j < AP_MAX_OR; ++j)
    if (p.om[j] == 0) p.om[j] = first;
  p.any_or = first != 0;
  return p;
}

// Bit i of the result: row i of R (Bloom word w[i], bucket code b[i])
// passes. Label and range are tested as bit masks over the R rows and
// combined once; the mode tests are the same for every row, so the
// branches on them are taken by the whole warp alike.
template <int R>
__device__ __forceinline__ uint32_t probe_bits(const ProbeParams& p,
                                               const uint32_t (&w)[R],
                                               const int32_t (&b)[R]) {
  constexpr uint32_t ALL = (1u << R) - 1u;
  const bool label_present = p.label_mode != 0;
  uint32_t lab = ALL;
  if (p.label_mode == 1) {
    lab = 0;
#pragma unroll
    for (int i = 0; i < R; ++i)
      lab |= (uint32_t)((w[i] & p.and_mask) == p.and_mask) << i;
  } else if (p.label_mode == 2) {
    lab = 0;
    if (p.any_or) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        // some mask is a subset of w: the least of (~w & m) is 0
        uint32_t least = ~w[i] & p.om[0];
#pragma unroll
        for (int j = 1; j < AP_MAX_OR; ++j)
          least = min(least, ~w[i] & p.om[j]);
        lab |= (uint32_t)(least == 0) << i;
      }
    }
  }
  uint32_t rng = 0;
#pragma unroll
  for (int i = 0; i < R; ++i)
    rng |= (uint32_t)(b[i] >= p.lo && b[i] <= p.hi) << i;
  if (!label_present && !p.range_present) return ALL;
  if (p.combine_or)
    return (label_present ? lab : 0u) | (p.range_present ? rng : 0u);
  return (label_present ? lab : ALL) & (p.range_present ? rng : ALL);
}

// BYTES (4, 8, 16 or 32) bytes from p as 32-bit words, in loads of up to
// 16 bytes; p is aligned to min(BYTES, 16)
template <int BYTES>
__device__ __forceinline__ void load_words(const void* p,
                                           uint32_t (&w)[(BYTES + 3) / 4]) {
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + k);
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
  } else if constexpr (BYTES == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else {
    static_assert(BYTES == 4, "BYTES is 4, 8, 16 or 32");
    w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
}

template <typename BucketT, int R>  // R = 4 or 8
__global__ void approx_probe_kernel(const int32_t* __restrict__ blooms,
                                    const BucketT* __restrict__ buckets,
                                    const int32_t* __restrict__ or_masks,
                                    const int32_t* __restrict__ params,
                                    uint8_t* __restrict__ out, long long N,
                                    int QL, bool vec) {
  constexpr int BB = R * (int)sizeof(BucketT);  // bucket bytes of R rows
  const long long base =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * R;
  if (base >= N) return;
  const bool whole = vec && base + R <= N;
  uint32_t w[R], bw[(BB + 3) / 4];
  if (whole) {  // the row loads go out before the params are read
    load_words<4 * R>(blooms + base, w);
    load_words<BB>(buckets + base, bw);
  }
  const ProbeParams p = read_params(params, or_masks, QL);

  if (whole) {
    int32_t bk[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if constexpr (sizeof(BucketT) == 1)
        bk[i] = (int32_t)((bw[i / 4] >> (8 * (i % 4))) & 0xff);
      else
        bk[i] = (int32_t)bw[i];
    }
    const uint32_t ok = probe_bits<R>(p, w, bk);
    // bit i of ok -> byte i of the output (0 or 1)
    uint32_t o[(R + 3) / 4];
#pragma unroll
    for (int k = 0; k < (R + 3) / 4; ++k)
      o[k] = (((ok >> (4 * k)) & 0xfu) * 0x00204081u) & 0x01010101u;
    if constexpr (R == 8)
      *reinterpret_cast<uint2*>(out + base) = make_uint2(o[0], o[1]);
    else
      *reinterpret_cast<uint32_t*>(out + base) = o[0];
    return;
  }
  const long long end = base + R < N ? base + R : N;
  for (long long n = base; n < end; ++n) {
    const uint32_t w1[1] = {(uint32_t)__ldg(blooms + n)};
    const int32_t b1[1] = {(int32_t)buckets[n]};
    out[n] = (uint8_t)probe_bits<1>(p, w1, b1);
  }
}

// Rows a thread: 8 while that still leaves 512 threads on each SM (a
// quarter of a full wave), else 4.
static int pick_rows(long long N, int sms) {
  return N / 8 >= (long long)sms * 512 ? 8 : 4;
}

template <typename BucketT, int R>
static int probe_go(const void* blooms, const void* buckets,
                    const void* or_masks, const void* params, void* out,
                    long long N, int QL, cudaStream_t stream) {
  const auto aligned = [](const void* p, size_t a) {
    return ((uintptr_t)p) % (a < 16 ? a : 16) == 0;
  };
  const bool vec = aligned(blooms, 4 * R) &&
                   aligned(buckets, R * sizeof(BucketT)) && aligned(out, R);
  const long long threads = (N + R - 1) / R;
  const long long blocks = (threads + AP_THREADS - 1) / AP_THREADS;
  approx_probe_kernel<BucketT, R><<<(unsigned)blocks, AP_THREADS, 0,
                                    stream>>>(
      (const int32_t*)blooms, (const BucketT*)buckets,
      (const int32_t*)or_masks, (const int32_t*)params, (uint8_t*)out, N,
      QL, vec);
  return (int)cudaGetLastError();
}

template <typename BucketT>
static int approx_probe_launch(const void* blooms, const void* buckets,
                               const void* or_masks, const void* params,
                               void* out, long long N, int QL, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (QL < 0 || QL > AP_MAX_OR) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (pick_rows(N, sms) == 8)
    return probe_go<BucketT, 8>(blooms, buckets, or_masks, params, out, N, QL,
                                s);
  return probe_go<BucketT, 4>(blooms, buckets, or_masks, params, out, N, QL,
                              s);
}

extern "C" int approx_probe_u8_launch(const void* blooms, const void* buckets,
                                      const void* or_masks,
                                      const void* params, void* out,
                                      long long N, int QL, void* stream) {
  return approx_probe_launch<uint8_t>(blooms, buckets, or_masks, params, out,
                                      N, QL, stream);
}

extern "C" int approx_probe_i32_launch(const void* blooms,
                                       const void* buckets,
                                       const void* or_masks,
                                       const void* params, void* out,
                                       long long N, int QL, void* stream) {
  return approx_probe_launch<int32_t>(blooms, buckets, or_masks, params, out,
                                      N, QL, stream);
}
