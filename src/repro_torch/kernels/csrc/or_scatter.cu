// Word-packed bitmap OR-scatter (visited set, rare-list bitmap), for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/or_scatter.py
// (`or_scatter` / `_or_scatter_kernel`). Plain versions:
// repro_torch/kernels/ref.py `or_scatter_ref` and `or_scatter_ref_`.
//
// Bit s of a (B, NW) int32 table lives in word s >> 5 of its row, at bit
// s & 31. Slots < 0 or >= NW*32 are dropped. Two entries:
//
// * or_scatter_launch — the JAX function's contract, out of place:
//   out = words with the slots' bits set. The copy of the (B, NW) table is
//   one device-to-device cudaMemcpyAsync at full memory rate, then one
//   thread per (b, j) issues a single atomicOr. Bound by the copy's bytes.
//   Tests and the kernel phase call it; the search path does not.
//
// * or_scatter_inplace_launch — the hop's visited update, in place: set
//   the bit of slot(ids[b, j]) in row b of `words`. One thread per (b, j),
//   no copy. Out-of-range ids read nothing and write nothing. slot() is
//   the id itself, or, for shift > 0, the visited table's multiply-shift
//   hash (uint32)(id * 0x9E3779B1) >> shift (repro_torch/core/search.py,
//   ref.visited_slot; uint32 wrap as in the JAX package). The OR is an
//   atomicOr whose result is unused, which nvcc emits as a fire-and-forget
//   RED.E.OR (red.global.or.b32). Bound: B*C id reads and as many one-word
//   read-modify-writes in L2 (~70 KB at B = 64, C = 32), far under the
//   launch floor, so the launch is the cost.
//
// ops.or_scatter_new (a fresh table: seeding the visited set, the
// rare-list bitmap) is torch.zeros followed by the in-place entry. A kernel
// of its own that zeroed 8,192-word windows in shared memory, ORed the
// row's ids in with shared atomics and wrote each window out once in
// 16-byte stores took 4.91-4.98 / 5.88 us for the seeded visited set
// (64, 32768, 1) / the rare list (64, 31251, 2048), against 6.07-6.23 /
// 7.37-7.40 us for the composition (tools/ab_full_phase.py --phase
// kernels, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, run 16e). Less than
// 1.25x on a call made a few times a batch did not pay for a second kernel.
//
// Bits are shifted from an unsigned 1, so bit 31 is defined. Atomics make
// duplicates and already-set bits idempotent in any order. The TPU kernel
// walked a row's slots in sequence with a one-hot OR over the whole row (it
// had no scatter).
#include <cuda_runtime.h>
#include <stdint.h>

#define OS_THREADS 256

// slot of an id: the id itself (shift == 0) or its multiply-shift hash;
// -1 for a negative id
__device__ __forceinline__ long long slot_of(int32_t id, int shift) {
  if (id < 0) return -1;
  if (shift == 0) return (long long)id;
  return (long long)(((uint32_t)id * 0x9E3779B1u) >> shift);
}

__global__ void or_scatter_kernel(int32_t* __restrict__ out,
                                  const int32_t* __restrict__ slots,
                                  long long total, int C, long long NW,
                                  int shift) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long s = slot_of(__ldg(slots + i), shift);
  if (s < 0 || s >= NW * 32) return;
  const long long b = i / C;
  atomicOr((unsigned*)(out + b * NW + (s >> 5)), 1u << (s & 31));
}

static int scatter(void* out, const void* slots, int B, int NW, int C,
                   int shift, cudaStream_t st) {
  const long long total = (long long)B * C;
  if (total == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((total + OS_THREADS - 1) / OS_THREADS);
  or_scatter_kernel<<<blocks, OS_THREADS, 0, st>>>(
      (int32_t*)out, (const int32_t*)slots, total, C, (long long)NW, shift);
  return (int)cudaGetLastError();
}

extern "C" int or_scatter_launch(const void* words, const void* slots,
                                 void* out, int B, int NW, int C,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(out, words,
                                    (size_t)B * NW * sizeof(int32_t),
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  return scatter(out, slots, B, NW, C, 0, st);
}

extern "C" int or_scatter_inplace_launch(void* words, const void* ids, int B,
                                         int NW, int C, int shift,
                                         void* stream) {
  return scatter(words, ids, B, NW, C, shift, (cudaStream_t)stream);
}
