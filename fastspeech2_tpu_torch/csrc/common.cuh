// Shared device code of the port's Hopper kernels (sm_90a).
//
// A simple tensor-core building block: a block-cooperative GEMM tile over
// bf16 operands with f32 accumulation in registers, issued as
// mma.sync.m16n8k16 with ldmatrix fragments from shared memory. The B
// operand (weights) streams through shared memory in 32-deep slices, several
// in flight with cp.async. It carries the products of kernels 3 and 4
// (adaptor.cu, postnet.cu) only; the other kernels are wgmma kernels on
// hopper.cuh.
//
// Rounding helpers reproduce the JAX package's bf16 contract: products
// accumulate in f32, are rounded to bf16 (round to nearest even), and are
// widened back to f32 for the bias add.
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

// d += a * b for one 16x8x16 tile (a row-major 16x16, b col-major 16x8).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy that bypasses registers; pred == false
// writes zeros instead of reading.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row (l & 7) of matrix (l >> 3).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment (16 x 16, row-major) of rows [0, 16) at column 0 of `tile`
// (row stride ld elements, a multiple of 8).
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const bf16* tile, int ld,
                                            int lane) {
  ldmatrix_x4(a, tile + (lane & 15) * ld + (lane >> 4) * 8);
}

// B fragments of two adjacent 8-wide n-tiles from an n-major buffer
// (element [n][k] at tile[n * ld + k]): b[0], b[1] for n-tile 0 and b[2],
// b[3] for n-tile 1, k columns [0, 16).
__device__ __forceinline__ void load_b_frag2(uint32_t (&b)[4], const bf16* tile, int ld,
                                             int lane) {
  ldmatrix_x4(b, tile + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8);
}

// Block-cooperative C = A * W^T, bf16 operands, f32 accumulators.
//
// The block runs WM*WN warps; warp (wm, wn) owns rows [wm*MI*16, +MI*16)
// and columns [wn*NI*8, +NI*8) of the BM x BN tile.
// A lives in shared memory as `taps` row-shifted views of one buffer:
//   A[m][j*KT + c] = As[(m + j * tap_step) * lda + c],  j < taps, c < KT,
// so taps == 1 is a plain GEMM and taps == k is a conv over rows (dilation
// tap_step) whose input rows (with halo) sit in As. W lives in global memory as rows
// [n0, n0 + BN) of a row-major [N][taps*KT] matrix (the weight laid out
// (out, k, in)); rows >= N read as zero. W streams through shared memory in
// 32-deep slices, STAGES of them in flight (cp.async), so a slice's copy
// from L2 overlaps the MMAs of the STAGES-1 slices before it; one barrier
// per slice; fragments come from ldmatrix. KT must be a multiple of 32, lda
// a multiple of 8, As 16-byte aligned and holding
// BM + (taps - 1) * tap_step initialised rows; Ws holds STAGE_ELEMS.
template <int WM, int WN, int MI, int NI, int STAGES = 2>
struct TileGemm {
  static_assert(NI % 2 == 0, "n-tiles are loaded in pairs");
  static_assert(STAGES >= 2, "at least double buffering");
  static constexpr int BM = WM * MI * 16;
  static constexpr int BN = WN * NI * 8;
  static constexpr int BK = 32;
  static constexpr int WS = BK + 8;  // staging row stride: spreads banks
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int STAGE_ELEMS = STAGES * BN * WS;

  float acc[MI][NI][4];

  __device__ __forceinline__ void run(const bf16* As, int lda, int KT, int taps,
                                      const bf16* __restrict__ W, int N, int n0,
                                      bf16* Ws, int tap_step = 1) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp / WN, wn = warp % WN;
    const int K = KT * taps;
    const int nk = K / BK;
    // one commit group per slice (empty past the end) keeps wait counts exact
    auto stage = [&](int kt) {
      if (kt < nk) {
        bf16* dst = Ws + (kt % STAGES) * BN * WS;
        const int k0 = kt * BK;
        for (int i = threadIdx.x; i < BN * (BK / 8); i += THREADS) {
          const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
          const bool ok = n0 + r < N;
          cp_async16(dst + r * WS + c, ok ? W + (size_t)(n0 + r) * K + k0 + c : W, ok);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) stage(s);
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // slice kt landed; slice kt-1's buffer is free
      stage(kt + STAGES - 1);
      const int k0 = kt * BK;
      const bf16* Ak = As + (k0 / KT) * tap_step * lda + (k0 % KT) + wm * MI * 16 * lda;
      const bf16* Wk = Ws + (kt % STAGES) * BN * WS + wn * NI * 8 * WS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) load_a_frag(a[mi], Ak + mi * 16 * lda + kk, lda, lane);
#pragma unroll
        for (int ni = 0; ni < NI; ni += 2) {
          uint32_t b[4];
          load_b_frag2(b, Wk + ni * 8 * WS + kk, WS, lane);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_bf16(acc[mi][ni], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][ni + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // Ws is free for the next run
  }

  // f(row, col, value) for every accumulator of this warp; row and col are
  // relative to the tile (col relative to n0).
  template <class Fn>
  __device__ __forceinline__ void epilogue(Fn f) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp / WN, wn = warp % WN;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int r0 = wm * MI * 16 + mi * 16 + g;
        const int c0 = wn * NI * 8 + ni * 8 + 2 * t;
        f(r0, c0, acc[mi][ni][0]);
        f(r0, c0 + 1, acc[mi][ni][1]);
        f(r0 + 8, c0, acc[mi][ni][2]);
        f(r0 + 8, c0 + 1, acc[mi][ni][3]);
      }
  }
};

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
