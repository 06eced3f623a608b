// Shared device and host code of the port's CUDA kernels (sm_90a): the
// bf16 type and export macro, the rounding helpers of the JAX package's bf16
// contract (products accumulate in f32, are rounded to bf16, round to
// nearest even, and widened back to f32 for the bias add), warp sums and a
// one-warp LayerNorm, the cp.async copies of the residual stack and the
// STFT, and the shared-memory opt-in that only grows. The tensor-core
// products of every kernel are wgmma, on hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

typedef __nv_bfloat16 bf16;

#define FS2_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of one row of n floats by one warp, the JAX formula:
// (v - mean) * rsqrt(var + eps) * g + b with the biased variance.
// src and dst may alias.
__device__ __forceinline__ void warp_layer_norm(const float* src, float* dst,
                                                int n, const float* __restrict__ g,
                                                const float* __restrict__ b,
                                                float eps, int lane) {
  float s = 0.f;
  for (int c = lane; c < n; c += 32) s += src[c];
  const float mean = warp_sum(s) / (float)n;
  float q = 0.f;
  for (int c = lane; c < n; c += 32) {
    const float d = src[c] - mean;
    q += d * d;
  }
  const float inv = 1.0f / sqrtf(warp_sum(q) / (float)n + eps);
  __syncwarp();
  for (int c = lane; c < n; c += 32) dst[c] = (src[c] - mean) * inv * g[c] + b[c];
}

// 16-byte global -> shared copy that bypasses registers; pred == false
// writes zeros instead of reading.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory opt-in above 48 KB. The opt-in of a kernel only ever grows,
// under a lock: two host threads launch one kernel at different widths (a
// server's dispatch thread the encoder at D=256, its delivery thread the
// decoder at D=384), and a smaller request landing between the other
// thread's request and its launch would have that launch refused
// (cudaErrorInvalidValue).
static inline cudaError_t set_smem_of(const void* kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> granted;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = granted[std::make_pair(dev, kernel)];
  if (bytes <= have) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess) have = bytes;
  return e;
}

template <class K>
static inline cudaError_t set_smem(K kernel, size_t bytes) {
  return set_smem_of(reinterpret_cast<const void*>(kernel), bytes);
}
