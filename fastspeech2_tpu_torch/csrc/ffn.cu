// FFT-block conv-FFN on the H100, one body with three entries:
//   fs2_ffn_block      out = LN(x + FFN(mask(x)))    post-LN block half
//   fs2_ffn_block_pre  out = x + FFN(mask(LN(x)))    pre-LN block half
//   fs2_ffn            out = FFN(mask(x))            bare, bf16 in, O outputs
// with FFN(z) = Conv1d_k1(ReLU(Conv1d_k(z))), SAME zero padding, and mask()
// zeroing rows at or past the length. Rows whose whole window lies past the
// length carry the bias-only row c = round(relu(round(b1)) W2) + b2: they
// give LN(x + c), x + c and c respectively.
//
// Replaces fastspeech2_tpu/ops/pallas/ffn.py: fused_ffn_block_post (kernel
// _ffn_block_post_kernel), fused_ffn_block (kernel _ffn_block_kernel, every
// pre-LN block) and fused_ffn (kernel _ffn_kernel).
//
// Bound on the H100: 2*(k*D*H + H*D) FLOPs per row (~7.9 MFLOP at D=384,
// H=1024, k=9) against 8*D bytes of f32 in/out per row: ~2,500 FLOP/byte,
// far above the ridge -- tensor-core (operations) bound.
//
// Design. The TPU kernel fills a zero-padded whole-row scratch at the first
// grid step, reuses it, and keeps the hidden in VMEM. Here two launches:
//  1. ffn_conv_kernel, one block per (64-row tile, 128 hidden columns, row):
//     the tile's rows plus a halo of (k-1)/2, masked and rounded to bf16,
//     sit in shared memory; because the rows are contiguous the k-tap conv
//     is one GEMM over row-shifted views (no im2col copy) against the weight
//     laid out (H, k, D), with four 32-deep weight slices in flight. At
//     ~96 KB two blocks share an SM. The bf16 hidden relu(round(round(.)
//     + b1)) goes to global memory: 4 bytes per hidden value written and
//     read back, against 2*k*D FLOPs to make it. Keeping it in shared
//     memory, as the TPU kernel does, took 128 KB and left one block per SM
//     with one weight slice in flight, so L2 latency set the pace.
//     Pre-LN: each block LayerNorms its own tile + halo rows (f32, biased
//     variance, one warp per row, read from global memory) before masking
//     and rounding them into shared memory. The LN is recomputed by each of
//     the H/128 column blocks of a tile (8 at H=1024): ~5 extra reads of
//     the tile's f32 rows from L2 and ~10*D FLOPs per row per block, next
//     to the 2*k*D*128 FLOPs per row of the block's GEMM -- under 0.1% of
//     its work. A pre-pass writing a bf16 LN to global memory would cost a
//     launch and a (B, T, D) round trip instead.
//  2. ffn_out_kernel, one block per (64-row tile, row): the tile's hidden
//     rows in shared memory, the k=1 conv over 384 output columns at a time
//     (three slices in flight), then the entry's epilogue: x + round(y) + b2
//     and a LayerNorm by each warp over whole rows (post), x + round(y) + b2
//     (pre), or round(y) + b2 in f32 or rounded to bf16 (bare).
// Tiles wholly past length + halo skip both GEMMs: launch 2 gives them the
// constant row from one 1 x H x N product.
#include "common.cuh"

namespace {

constexpr int FT = 64;  // rows per block

using GConv = TileGemm<2, 4, 2, 4, 4>;  // 64 x 128, 8 warps, 4 slices in flight
using GOut = TileGemm<2, 4, 2, 12, 3>;  // 64 x 384, 8 warps

// conv input: f32 rows as they are (post), f32 rows LayerNormed (pre), or
// bf16 rows (bare)
enum : int { IN_F32 = 0, IN_F32_LN = 1, IN_BF16 = 2 };
// epilogue of the k=1 conv
enum : int { OUT_POST_LN = 0, OUT_PRE_RES = 1, OUT_BARE_F32 = 2, OUT_BARE_BF16 = 3 };

template <int IN>
__global__ void __launch_bounds__(256)
ffn_conv_kernel(const void* __restrict__ xin, const float* __restrict__ gamma,
                const float* __restrict__ beta, float eps, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const int* __restrict__ lens,
                bf16* __restrict__ hid, int T, int D, int Hd, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pad = (K - 1) / 2;
  const int lx = D + 8;
  bf16* Xs = reinterpret_cast<bf16*>(smem);  // [FT + K - 1][lx]
  bf16* Ws = Xs + (FT + K - 1) * lx;         // weight slices
  const int b = blockIdx.z, t0 = blockIdx.x * FT, n0 = blockIdx.y * GConv::BN;
  const int len = min(lens[b], T);
  if (t0 >= len + pad) return;  // dead tile: launch 2 writes its constant rows
  const size_t row0 = (size_t)b * T;

  // x rows t0 - pad .. t0 + FT + pad - 1, zero outside [0, len), in bf16
  if (IN == IN_F32_LN) {
    // one warp per row: LN(x) in f32, then masked and rounded
    const float* x = reinterpret_cast<const float*>(xin);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < FT + K - 1; r += 8) {
      const int t = t0 - pad + r;
      bf16* dst = Xs + r * lx;
      if (t < 0 || t >= len) {
        for (int c = lane; c < D; c += 32) dst[c] = __float2bfloat16_rn(0.f);
        continue;
      }
      const float* src = x + (row0 + t) * D;
      float s = 0.f;
      for (int c = lane; c < D; c += 32) s += src[c];
      const float mean = warp_sum(s) / (float)D;
      float q = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float d = src[c] - mean;
        q += d * d;
      }
      const float inv = 1.0f / sqrtf(warp_sum(q) / (float)D + eps);
      for (int c = lane; c < D; c += 32)
        dst[c] = __float2bfloat16_rn((src[c] - mean) * inv * gamma[c] + beta[c]);
    }
  } else if (IN == IN_F32) {
    const float* x = reinterpret_cast<const float*>(xin);
    for (int i = threadIdx.x; i < (FT + K - 1) * (D / 4); i += blockDim.x) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const int t = t0 - pad + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= 0 && t < len) v = *reinterpret_cast<const float4*>(x + (row0 + t) * D + c);
      uint32_t* dst = reinterpret_cast<uint32_t*>(Xs + r * lx + c);
      dst[0] = pack_bf16(v.x, v.y);
      dst[1] = pack_bf16(v.z, v.w);
    }
  } else {
    const bf16* x = reinterpret_cast<const bf16*>(xin);
    for (int i = threadIdx.x; i < (FT + K - 1) * (D / 8); i += blockDim.x) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const int t = t0 - pad + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t >= 0 && t < len) v = *reinterpret_cast<const uint4*>(x + (row0 + t) * D + c);
      *reinterpret_cast<uint4*>(Xs + r * lx + c) = v;
    }
  }
  __syncthreads();

  // hidden = relu(round(round(conv_k(x)) + b1)), bf16
  GConv gm;
  gm.run(Xs, lx, D, K, w1, Hd, n0, Ws);
  gm.epilogue([&](int r, int c, float v) {
    const int t = t0 + r, n = n0 + c;
    if (t < T && n < Hd)
      hid[(row0 + t) * Hd + n] = __float2bfloat16_rn(fmaxf(bf16r(bf16r(v) + b1[n]), 0.f));
  });
}

// x (B, T, N) f32 (the residual: post and pre only); out (B, T, N) f32, or
// bf16 for OUT_BARE_BF16.
template <int OUT>
__global__ void __launch_bounds__(256)
ffn_out_kernel(const float* __restrict__ x, const bf16* __restrict__ hid,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ gamma,
               const float* __restrict__ beta, const int* __restrict__ lens,
               void* __restrict__ out_ptr, int T, int N, int Hd, int K, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pad = (K - 1) / 2;
  const int lh = Hd + 8;
  bf16* Hs = reinterpret_cast<bf16*>(smem);  // [FT][lh]
  bf16* Ws = Hs + FT * lh;                   // weight slices
  const int b = blockIdx.y, t0 = blockIdx.x * FT;
  const int len = min(lens[b], T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = (size_t)b * T;
  float* outf = reinterpret_cast<float*>(out_ptr);
  bf16* outh = reinterpret_cast<bf16*>(out_ptr);

  // one output value: the residual sum for post and pre, the row for bare
  auto put = [&](size_t off, float y) {
    if (OUT == OUT_POST_LN || OUT == OUT_PRE_RES)
      outf[off] = x[off] + y;
    else if (OUT == OUT_BARE_F32)
      outf[off] = y;
    else
      outh[off] = __float2bfloat16_rn(y);
  };

  if (t0 >= len + pad) {  // dead tile: every conv tap is zero
    // constant row round(relu(round(b1)) W2) + b2: a warp per output
    // column, lanes along the contiguous weight row
    float* crow = reinterpret_cast<float*>(smem);
    for (int n = warp; n < N; n += 8) {
      const bf16* wr = w2 + (size_t)n * Hd;
      float a = 0.f;
      for (int k = lane; k < Hd; k += 32)
        a += fmaxf(bf16r(b1[k]), 0.f) * __bfloat162float(wr[k]);
      a = warp_sum(a);
      if (lane == 0) crow[n] = bf16r(a) + b2[n];
    }
    __syncthreads();
    for (int r = warp; r < FT && t0 + r < T; r += 8) {
      const size_t off = (row0 + t0 + r) * N;
      for (int c = lane; c < N; c += 32) put(off + c, crow[c]);
      if (OUT == OUT_POST_LN) {
        __syncwarp();
        warp_layer_norm(outf + off, outf + off, N, gamma, beta, eps, lane);
      }
    }
    return;
  }

  for (int i = threadIdx.x; i < FT * (Hd / 8); i += blockDim.x) {
    const int r = i / (Hd / 8), c = (i % (Hd / 8)) * 8;
    const bool ok = t0 + r < T;
    cp_async16(Hs + r * lh + c, ok ? hid + (row0 + t0 + r) * Hd + c : hid, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // y = round(hidden W2) + b2 into the entry's epilogue
  for (int n0 = 0; n0 < N; n0 += GOut::BN) {
    GOut gm;
    gm.run(Hs, lh, Hd, 1, w2, N, n0, Ws);
    gm.epilogue([&](int r, int c, float v) {
      const int t = t0 + r, n = n0 + c;
      if (t < T && n < N) put((row0 + t) * N + n, bf16r(v) + b2[n]);
    });
  }
  if (OUT == OUT_POST_LN) {
    __syncthreads();
    for (int r = warp; r < FT && t0 + r < T; r += 8) {
      float* orow = outf + (row0 + t0 + r) * N;
      warp_layer_norm(orow, orow, N, gamma, beta, eps, lane);
    }
  }
}

template <int IN, int OUT>
cudaError_t launch_ffn(const void* x, const float* g, const float* be, const bf16* w1,
                       const float* b1, const bf16* w2, const float* b2, const int* lens,
                       bf16* hid, void* out, int B, int T, int D, int Hd, int N, int K,
                       float eps, cudaStream_t stream) {
  if (D % 32 != 0 || Hd % 32 != 0 || K % 2 != 1 || N < 1) return cudaErrorInvalidValue;
  const size_t smem1 = ((size_t)(FT + K - 1) * (D + 8) + GConv::STAGE_ELEMS) * sizeof(bf16);
  cudaError_t e = set_smem(ffn_conv_kernel<IN>, smem1);
  if (e != cudaSuccess) return e;
  ffn_conv_kernel<IN><<<dim3((T + FT - 1) / FT, (Hd + GConv::BN - 1) / GConv::BN, B),
                        GConv::THREADS, smem1, stream>>>(x, g, be, eps, w1, b1, lens, hid, T,
                                                         D, Hd, K);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  size_t smem2 = ((size_t)FT * (Hd + 8) + GOut::STAGE_ELEMS) * sizeof(bf16);
  if (smem2 < (size_t)N * sizeof(float)) smem2 = (size_t)N * sizeof(float);  // dead tiles' row
  e = set_smem(ffn_out_kernel<OUT>, smem2);
  if (e != cudaSuccess) return e;
  ffn_out_kernel<OUT><<<dim3((T + FT - 1) / FT, B), GOut::THREADS, smem2, stream>>>(
      IN == IN_BF16 ? nullptr : reinterpret_cast<const float*>(x), hid, b1, w2, b2, g, be,
      lens, out, T, N, Hd, K, eps);
  return cudaGetLastError();
}

}  // namespace

// x (B,T,D) f32; w1 (Hd, K*D) bf16 [(out, tap, in)]; b1 (Hd) f32;
// w2 (D, Hd) bf16 (out, in); b2/g/be (D) f32; lens (B) i32;
// hid (B,T,Hd) bf16 scratch; out (B,T,D) f32. Post-LN: LN(x + FFN(mask(x))).
FS2_EXPORT int fs2_ffn_block(const float* x, const bf16* w1, const float* b1,
                             const bf16* w2, const float* b2, const float* g,
                             const float* be, const int* lens, bf16* hid,
                             float* out, int B, int T, int D, int Hd, int K,
                             float eps, void* stream_ptr) {
  return (int)launch_ffn<IN_F32, OUT_POST_LN>(x, g, be, w1, b1, w2, b2, lens, hid, out, B,
                                              T, D, Hd, D, K, eps,
                                              reinterpret_cast<cudaStream_t>(stream_ptr));
}

// Pre-LN: x + FFN(mask(LN(x))), g/be the LayerNorm on the conv input; the
// same arguments as fs2_ffn_block. Replaces fastspeech2_tpu/ops/pallas/
// ffn.py: fused_ffn_block (kernel _ffn_block_kernel).
FS2_EXPORT int fs2_ffn_block_pre(const float* x, const bf16* w1, const float* b1,
                                 const bf16* w2, const float* b2, const float* g,
                                 const float* be, const int* lens, bf16* hid,
                                 float* out, int B, int T, int D, int Hd, int K,
                                 float eps, void* stream_ptr) {
  return (int)launch_ffn<IN_F32_LN, OUT_PRE_RES>(x, g, be, w1, b1, w2, b2, lens, hid, out,
                                                 B, T, D, Hd, D, K, eps,
                                                 reinterpret_cast<cudaStream_t>(stream_ptr));
}

// Bare: FFN(mask(x)) with x (B,T,D) bf16, w2 (O, Hd) bf16, b2 (O) f32 and out
// (B,T,O) f32 (out_f32 != 0) or bf16 (round(y) + b2 rounded once more).
// Replaces fastspeech2_tpu/ops/pallas/ffn.py: fused_ffn (kernel _ffn_kernel).
FS2_EXPORT int fs2_ffn(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                       const float* b2, const int* lens, bf16* hid, void* out, int out_f32,
                       int B, int T, int D, int Hd, int O, int K, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (out_f32)
    return (int)launch_ffn<IN_BF16, OUT_BARE_F32>(x, nullptr, nullptr, w1, b1, w2, b2, lens,
                                                  hid, out, B, T, D, Hd, O, K, 0.f, stream);
  return (int)launch_ffn<IN_BF16, OUT_BARE_BF16>(x, nullptr, nullptr, w1, b1, w2, b2, lens,
                                                 hid, out, B, T, D, Hd, O, K, 0.f, stream);
}
