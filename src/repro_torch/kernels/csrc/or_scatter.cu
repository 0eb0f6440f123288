// Word-packed bitmap OR-scatter (visited set, rare-list bitmap), for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/or_scatter.py
// (`or_scatter` / `_or_scatter_kernel`). Plain version:
// repro_torch/kernels/ref.py `or_scatter_ref`.
//
// out = words with bit slots[b, j] set in word slots[b, j] >> 5 of row b,
// for every slot in [0, NW*32); other slots are dropped. Out of place, like
// the JAX function.
//
// What bounds it on the card: bytes. The out-of-place copy of the (B, NW)
// word table (read once, written once) dwarfs the B*C slot reads and the
// B*C single-word atomics.
//
// What the design does about that: the copy is one device-to-device
// cudaMemcpyAsync at full memory rate on the caller's stream, then one
// thread per (b, j) issues a single atomicOr. The TPU kernel walked the C
// slots of a row sequentially with a one-hot OR over the whole row (it had
// no scatter); atomics make duplicates and already-set bits idempotent in
// any order. The bit is shifted from an unsigned 1, so bit 31 is defined.
#include <cuda_runtime.h>
#include <stdint.h>

#define OS_THREADS 256

__global__ void or_scatter_kernel(int32_t* __restrict__ out,
                                  const int32_t* __restrict__ slots,
                                  long long total, int C, long long NW) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i / C;
  const int32_t s = slots[i];
  if (s < 0 || (long long)s >= NW * 32) return;
  atomicOr(out + b * NW + (s >> 5), (int)(1u << (s & 31)));
}

extern "C" int or_scatter_launch(const void* words, const void* slots,
                                 void* out, int B, int NW, int C,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(out, words,
                                    (size_t)B * NW * sizeof(int32_t),
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * C;
  if (total == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((total + OS_THREADS - 1) / OS_THREADS);
  or_scatter_kernel<<<blocks, OS_THREADS, 0, st>>>(
      (int32_t*)out, (const int32_t*)slots, total, C, (long long)NW);
  return (int)cudaGetLastError();
}
