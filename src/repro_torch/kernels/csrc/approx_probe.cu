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
// What bounds it on the card: bytes. Per row it reads a 4-byte word and a
// 1-byte (uint8) or 4-byte (int32) bucket code and writes one byte; the
// handful of AND/compare operations is far under any compute rate.
//
// What the design does about that: one thread per candidate, neighbouring
// threads on neighbouring rows, so a warp reads 128 contiguous bytes of
// words and 32 of codes and writes 32 bytes. The kernel is templated on the
// bucket type, so uint8 codes are read as bytes with no widening pass. The
// output is written as bytes 0/1 into the storage of a torch.bool tensor:
// no conversion pass. The param block and the <= 8 OR masks live on the
// card and are read by every thread through the read-only cache (the same
// address across a warp is one transaction), so a caller's device-side
// block needs no copy to the host before the launch.
#include <cuda_runtime.h>
#include <stdint.h>

#define AP_THREADS 256
#define AP_MAX_OR 8

template <typename BucketT>
__global__ void approx_probe_kernel(const int32_t* __restrict__ blooms,
                                    const BucketT* __restrict__ buckets,
                                    const int32_t* __restrict__ or_masks,
                                    const int32_t* __restrict__ params,
                                    uint8_t* __restrict__ out, long long N,
                                    int QL) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int32_t and_mask = __ldg(params + 0);
  const int32_t lo = __ldg(params + 2);
  const int32_t hi = __ldg(params + 3);
  const int32_t label_mode = __ldg(params + 4);
  const bool range_present = __ldg(params + 5) == 1;
  const bool combine_or = __ldg(params + 6) == 1;

  const int32_t w = __ldg(blooms + n);
  const int32_t b = (int32_t)buckets[n];
  const bool and_ok = (w & and_mask) == and_mask;
  bool hit_any = false;
  for (int j = 0; j < QL; ++j) {
    const int32_t m = __ldg(or_masks + j);
    hit_any |= (m != 0) && ((w & m) == m);
  }
  const bool label_present = label_mode != 0;
  const bool label_ok =
      label_mode == 1 ? and_ok : (label_mode == 2 ? hit_any : true);
  const bool range_ok = (b >= lo) && (b <= hi);
  bool ok;
  if (!label_present && !range_present) {
    ok = true;
  } else if (combine_or) {
    ok = (label_ok && label_present) || (range_ok && range_present);
  } else {
    ok = (label_ok || !label_present) && (range_ok || !range_present);
  }
  out[n] = ok ? 1 : 0;
}

template <typename BucketT>
static int approx_probe_launch(const void* blooms, const void* buckets,
                               const void* or_masks, const void* params,
                               void* out, long long N, int QL, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (QL < 0 || QL > AP_MAX_OR) return (int)cudaErrorInvalidValue;
  const long long blocks = (N + AP_THREADS - 1) / AP_THREADS;
  approx_probe_kernel<BucketT><<<(unsigned)blocks, AP_THREADS, 0,
                                 (cudaStream_t)stream>>>(
      (const int32_t*)blooms, (const BucketT*)buckets,
      (const int32_t*)or_masks, (const int32_t*)params, (uint8_t*)out, N,
      QL);
  return (int)cudaGetLastError();
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
