// Exact squared-L2 re-rank of B full-precision rows against one query, for
// Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/l2_rerank.py (`l2_rerank` /
// `_l2_kernel`). Plain version: repro_torch/kernels/ref.py `l2_rerank_ref`.
//
// out[b] = |v_b|^2 - 2 v_b.q + |q|^2, the TPU kernel's decomposition, for
// vecs (B, D) float32 and q (D,) float32, any D. Nothing is clamped: rows
// that nearly equal q can come out slightly negative, as on the TPU.
//
// What bounds it on the card: bytes. Each row's D floats are read once
// (4·D bytes) for 4·D flops, far below the float32 rate per byte moved.
//
// What the design does about that: one warp per row, in a grid-stride loop
// over a grid capped at 8 blocks of 8 warps per SM. Lanes read the row as
// 16-byte float4 words (a warp reads 512 contiguous bytes per instruction)
// where D % 4 == 0 and the base is 16-byte aligned, else as floats. q is
// staged once per block in shared memory and |q|^2 is computed there once
// per block by one warp, in the same order in every block. Each lane keeps
// two running sums (v.v and v.q) and the warp reduces them with shuffles.
// The TPU kernel's 256-row tiles are not copied: a warp per row needs no
// padding and handles any B. The sums run in another order than XLA's, so
// the result agrees with the plain version within float32 rounding, not
// bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#define L2_WARPS 8
#define L2_THREADS (L2_WARPS * 32)
#define L2_BLOCKS_PER_SM 8

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void l2_rerank_kernel(const float* __restrict__ vecs,
                                 const float* __restrict__ query,
                                 float* __restrict__ out, long long B, int D,
                                 bool wide) {
  extern __shared__ float4 s_q4[];  // D floats (16-byte aligned)
  __shared__ float s_qq;
  float* s_q = reinterpret_cast<float*>(s_q4);
  for (int i = threadIdx.x; i < D; i += blockDim.x) s_q[i] = query[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 0) {
    float qq = 0.0f;
    for (int i = lane; i < D; i += 32) qq += s_q[i] * s_q[i];
    qq = warp_sum(qq);
    if (lane == 0) s_qq = qq;
  }
  __syncthreads();
  const float qq = s_qq;

  const long long stride = (long long)gridDim.x * L2_WARPS;
  for (long long row = (long long)blockIdx.x * L2_WARPS + warp; row < B;
       row += stride) {
    const float* v = vecs + row * D;
    float vv = 0.0f, vq = 0.0f;
    if (wide) {
      const float4* v4 = reinterpret_cast<const float4*>(v);
      const int D4 = D >> 2;
      for (int j = lane; j < D4; j += 32) {
        const float4 a = __ldg(v4 + j);
        const float4 q = s_q4[j];
        vv += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
        vq += a.x * q.x + a.y * q.y + a.z * q.z + a.w * q.w;
      }
    } else {
      for (int j = lane; j < D; j += 32) {
        const float a = __ldg(v + j);
        vv += a * a;
        vq += a * s_q[j];
      }
    }
    vv = warp_sum(vv);
    vq = warp_sum(vq);
    if (lane == 0) out[row] = (vv - 2.0f * vq) + qq;
  }
}

extern "C" int l2_rerank_launch(const void* vecs, const void* query,
                                void* out, long long B, int D, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (D <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool wide = D % 4 == 0 && ((uintptr_t)vecs) % 16 == 0;
  long long blocks = (B + L2_WARPS - 1) / L2_WARPS;
  const long long cap = (long long)sms * L2_BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  // whole float4 words of shared memory, so the float4 view stays in bounds
  const size_t smem = (size_t)((D + 3) / 4) * sizeof(float4);
  l2_rerank_kernel<<<(unsigned)blocks, L2_THREADS, smem,
                     (cudaStream_t)stream>>>(
      (const float*)vecs, (const float*)query, (float*)out, B, D, wide);
  return (int)cudaGetLastError();
}
