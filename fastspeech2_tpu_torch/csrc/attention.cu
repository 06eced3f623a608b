// FFT-block attention on the H100, masked by length:
//   RES_LN  out = LN(res + MHA(q, k, v) Wo + bo)   (post-LN block half)
//   RES     out = res + MHA(q, k, v) Wo + bo       (pre-LN block half)
// on one attention body with two epilogues (rows at or past the length give
// LN(res + bo) and res + bo), and the bare attention
//   out = MHA(q, k, v), bf16, no projection (rows at or past the length zero)
// on attention_fwd.cuh's wgmma/TMA forward in its SERVE mode.
//
// Replaces fastspeech2_tpu/ops/pallas/attention.py:
//  - fused_attention_packed_qkv_res_ln (kernel _attn_kernel_packed_qkv_res_ln):
//    fs2_attention_block, a QKV projection launch, then RES_LN;
//  - fused_attention_packed_res_ln (kernel _attn_kernel_packed_res_ln), which
//    the JAX package takes with FS2_FUSED_ATT_QKV=off: fs2_attention_res_ln,
//    RES_LN alone with q/k/v given;
//  - fused_attention_packed_res (kernel _attn_kernel_packed_res), every
//    pre-LN block: fs2_attention_res, RES with q/k/v given;
//  - fused_attention_packed (kernel _attn_kernel_packed, heads packed along
//    D) and fused_attention (kernel _attn_kernel, (B, H, T, dk)): both
//    through fs2_attention, the SERVE forward of attention_fwd.cuh (the body
//    of the training kernels 11 and 12 without their dropout and saved
//    state), d_k 128, 192 or 256.
//
// Bound on the H100: at the serving shapes (T <= 2048, D = 256/384, two
// heads of 128/192) the work is ~8*T*D^2 projection FLOPs plus ~4*T^2*D
// attention FLOPs per row against ~8*T*D bytes of f32 stream, i.e. well
// above the card's ~295 FLOP/byte ridge: tensor-core (operations) bound.
// The bare attention needs 4*T^2*D FLOPs against 8*T*D bytes of bf16: at
// the serving shapes (T <= 2048) its byte time is the larger; its two sweeps
// do 6*T^2*D.
//
// Design. The TPU kernel projects K/V into VMEM scratch at the first query
// block of a row and reuses it on later grid steps; CUDA blocks of one row
// run concurrently and share nothing, so the work is split in two launches:
//  1. qkv_proj_kernel: one bf16 GEMM tile (64 rows x 128 cols) per block
//     writes q|k|v in bf16, rounded like the TPU kernel's proj() (product
//     rounded to bf16, + bias in f32, rounded to bf16). Row tiles at or past
//     the length are skipped: nothing reads them.
//  2. attn_block_kernel: one block per (64-query tile, row), 4 warps x 16
//     query rows. Whole-row K/V (1.5 MB each at L=2048, D=384) cannot sit in
//     227 KB of shared memory, so K/V stream through in 64-key tiles. To keep
//     the reference's rounding points (softmax normalised in f32, then
//     rounded to bf16 before P.V) the softmax takes two passes over the keys:
//     pass 1 finds each row's max and denominator, pass 2 forms
//     p = exp(s - m) / max(l, tiny), rounds it to bf16 and accumulates P.V in
//     f32 registers. K/V tiles arrive by cp.async, fragments by ldmatrix
//     (V through the transposing load). The epilogues write the head output
//     (o_scr, bf16) over the head's Q columns in shared memory; the out
//     projection stages Wo 64 output columns at a time in the K/V space,
//     adds bo and the residual,
//     writes the f32 rows, and in RES_LN each warp LayerNorms its own 16
//     rows. QK^T runs twice (1.5x attention FLOPs) -- the price of exact
//     rounding points in a first kernel; an online softmax is the obvious
//     later trade.
#include "attention_fwd.cuh"
#include "common.cuh"

namespace {

constexpr int QT = 64;     // query rows per block: 4 warps x 16
constexpr int KTILE = 64;  // keys per streamed K/V tile

enum : int { EPI_RES_LN = 0, EPI_RES = 1 };

// Pointers, strides (elements) and sizes of one attention launch. Element
// (b, h, t, c) of q/k/v is at q[b * sb + h * sh + t * ld + c], heads packed
// along D (sh = dk); res and out are (B, T, D) f32 contiguous.
struct AttnArgs {
  const float* res;
  const bf16* q;
  const bf16* k;
  const bf16* v;
  int sb, sh, ld;
  const bf16* wo;
  const float* bo;
  const float* g;
  const float* be;
  const int* lens;
  float* out;
  int T, D, H;
  float scale, eps;
};

__global__ void __launch_bounds__(128)
qkv_proj_kernel(const float* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ bias, const int* __restrict__ lens,
                bf16* __restrict__ qkv, int T, int D) {
  using G = TileGemm<2, 2, 2, 8>;  // 64 x 128
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = D + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = As + G::BM * lda;
  const int b = blockIdx.z, t0 = blockIdx.x * G::BM, n0 = blockIdx.y * G::BN;
  if (t0 >= min(lens[b], T)) return;
  const int N = 3 * D;
  const size_t row0 = (size_t)b * T;
  for (int i = threadIdx.x; i < G::BM * (D / 4); i += G::THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T) v = *reinterpret_cast<const float4*>(x + (row0 + t0 + r) * D + c);
    uint32_t* dst = reinterpret_cast<uint32_t*>(As + r * lda + c);
    dst[0] = pack_bf16(v.x, v.y);
    dst[1] = pack_bf16(v.z, v.w);
  }
  __syncthreads();
  G gm;
  gm.run(As, lda, D, 1, w, N, n0, Ws);
  gm.epilogue([&](int r, int c, float v) {
    const int t = t0 + r, n = n0 + c;
    if (t < T && n < N)
      qkv[(row0 + t) * N + n] = __float2bfloat16_rn(bf16r(v) + bias[n]);
  });
}

// One 64-key tile of one head's K (and V) into shared memory, zeros at keys
// >= len; kh/vh point at the head's row 0, rows ld apart; row-major
// [key][d] in shared memory, row stride lk.
template <int DK>
__device__ __forceinline__ void load_kv_tile(bf16* Ks, bf16* Vs, int lk,
                                             const bf16* __restrict__ kh,
                                             const bf16* __restrict__ vh,
                                             int ld, int k0, int len) {
  for (int i = threadIdx.x; i < KTILE * (DK / 8); i += blockDim.x) {
    const int r = i / (DK / 8), c = (i % (DK / 8)) * 8;
    const bool ok = k0 + r < len;
    const size_t off = ok ? (size_t)(k0 + r) * ld + c : 0;
    cp_async16(Ks + r * lk + c, kh + off, ok);
    if (Vs != nullptr) cp_async16(Vs + r * lk + c, vh + off, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

template <int DK, int EPI>
__global__ void __launch_bounds__(128) attn_block_kernel(const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = a.T, D = a.D;
  const int lq = D + 8, lk = DK + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [QT][lq]: Q, then o_scr
  bf16* Ks = Qs + QT * lq;                   // [KTILE][lk]
  bf16* Vs = Ks + KTILE * lk;                // [KTILE][lk]
  bf16* Wst = Ks;                            // [64][D + 8]: Wo slice (aliases K/V)
  const int b = blockIdx.y, t0 = blockIdx.x * QT;
  const int len = min(a.lens[b], T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t row0 = (size_t)b * T;
  const bf16* qb = a.q + (size_t)b * a.sb;

  if (t0 >= len) {  // dead tile: LN(res + bo) or res + bo
    for (int r = warp; r < QT && t0 + r < T; r += 4) {
      const float* xr = a.res + (row0 + t0 + r) * D;
      float* orow = a.out + (row0 + t0 + r) * D;
      for (int c = lane; c < D; c += 32) orow[c] = xr[c] + a.bo[c];
      if (EPI == EPI_RES_LN) {
        __syncwarp();
        warp_layer_norm(orow, orow, D, a.g, a.be, a.eps, lane);
      }
    }
    return;
  }

  for (int i = threadIdx.x; i < QT * (D / 8); i += 128) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int h = c / DK, cc = c % DK;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T)
      v = *reinterpret_cast<const uint4*>(qb + (size_t)h * a.sh + (size_t)(t0 + r) * a.ld + cc);
    *reinterpret_cast<uint4*>(Qs + r * lq + c) = v;
  }

  const int qr = warp * 16;  // this warp's rows in the tile
  const bool va = t0 + qr + g8 < len, vb = t0 + qr + g8 + 8 < len;
  const int nkt = (len + KTILE - 1) / KTILE;
  const float scale = a.scale;

  for (int h = 0; h < a.H; ++h) {
    const bf16* Qw = Qs + qr * lq + h * DK;
    const bf16* kh = a.k + (size_t)b * a.sb + (size_t)h * a.sh;
    const bf16* vh = a.v + (size_t)b * a.sb + (size_t)h * a.sh;
    // pass 1: row max m and denominator l = sum exp(s - m) over valid keys
    float m_a = -FLT_MAX, m_b = -FLT_MAX, l_a = 0.f, l_b = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * KTILE;
      __syncthreads();
      load_kv_tile<DK>(Ks, nullptr, lk, kh, vh, a.ld, k0, len);
      __syncthreads();
      float s[8][4];
      warp_scores<DK>(s, Qw, lq, Ks, lk, lane);
      float mx_a = -FLT_MAX, mx_b = -FLT_MAX;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool vc = k0 + ni * 8 + 2 * t4 + e < len;
          s[ni][e] *= scale;
          s[ni][2 + e] *= scale;
          if (va && vc) mx_a = fmaxf(mx_a, s[ni][e]);
          if (vb && vc) mx_b = fmaxf(mx_b, s[ni][2 + e]);
        }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool vc = k0 + ni * 8 + 2 * t4 + e < len;
          if (va && vc) sa += expf(s[ni][e] - mn_a);
          if (vb && vc) sb += expf(s[ni][2 + e] - mn_b);
        }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sa += __shfl_xor_sync(0xffffffffu, sa, o);
        sb += __shfl_xor_sync(0xffffffffu, sb, o);
      }
      l_a = l_a * expf(m_a - mn_a) + sa;
      l_b = l_b * expf(m_b - mn_b) + sb;
      m_a = mn_a;
      m_b = mn_b;
    }
    const float den_a = fmaxf(l_a, FLT_MIN), den_b = fmaxf(l_b, FLT_MIN);

    // pass 2: o = round(round(p) . V), p = exp(s - m) / max(l, tiny)
    float o[DK / 8][4];
#pragma unroll
    for (int dn = 0; dn < DK / 8; ++dn)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[dn][r] = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * KTILE;
      __syncthreads();
      load_kv_tile<DK>(Ks, Vs, lk, kh, vh, a.ld, k0, len);
      __syncthreads();
      float s[8][4];
      warp_scores<DK>(s, Qw, lq, Ks, lk, lane);
      uint32_t pa[4][4];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool vc = k0 + ni * 8 + 2 * t4 + e < len;
          p[e] = (va && vc) ? expf(s[ni][e] * scale - m_a) / den_a : 0.f;
          p[2 + e] = (vb && vc) ? expf(s[ni][2 + e] * scale - m_b) / den_b : 0.f;
        }
        pa[ni >> 1][(ni & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
        pa[ni >> 1][(ni & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // A fragment order: (g, k 0-7), (g+8, k 0-7), (g, k 8-15), (g+8, k 8-15)
        const uint32_t af[4] = {pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3]};
#pragma unroll
        for (int dn = 0; dn < DK / 8; dn += 2) {
          // V is [key][d]: the transposing load gives the col-major B
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * lk +
                                    (dn + (lane >> 4)) * 8);
          mma_bf16(o[dn], af, bf[0], bf[1]);
          mma_bf16(o[dn + 1], af, bf[2], bf[3]);
        }
      }
    }
    // o_scr: the head's output in bf16 over its own Q columns (own rows only)
#pragma unroll
    for (int dn = 0; dn < DK / 8; ++dn) {
      const int c = h * DK + dn * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(Qs + (qr + g8) * lq + c) = pack_bf16(o[dn][0], o[dn][1]);
      *reinterpret_cast<uint32_t*>(Qs + (qr + g8 + 8) * lq + c) = pack_bf16(o[dn][2], o[dn][3]);
    }
  }

  // out projection, 64 output columns at a time: v = round(o_scr Wo) + bo + res
  for (int n0 = 0; n0 < D; n0 += 64) {
    __syncthreads();
    for (int i = threadIdx.x; i < 64 * (D / 8); i += 128) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      cp_async16(Wst + r * lq + c, a.wo + (size_t)(n0 + r) * D + c, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[ni][r] = 0.f;
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t af[4];
      load_a_frag(af, Qs + qr * lq + kk, lq, lane);
#pragma unroll
      for (int ni = 0; ni < 8; ni += 2) {
        uint32_t bf[4];
        load_b_frag2(bf, Wst + ni * 8 * lq + kk, lq, lane);
        mma_bf16(acc[ni], af, bf[0], bf[1]);
        mma_bf16(acc[ni + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + qr + g8 + (e >> 1) * 8;
        const int c = n0 + ni * 8 + 2 * t4 + (e & 1);
        if (t < T) {
          const size_t off = (row0 + t) * D + c;
          a.out[off] = (bf16r(acc[ni][e]) + a.bo[c]) + a.res[off];
        }
      }
  }
  if (EPI == EPI_RES_LN) {
    __syncwarp();
    for (int r = 0; r < 16 && t0 + qr + r < T; ++r) {
      float* orow = a.out + (row0 + t0 + qr + r) * D;
      warp_layer_norm(orow, orow, D, a.g, a.be, a.eps, lane);
    }
  }
}

template <int DK, int EPI>
cudaError_t launch_attn(const AttnArgs& a, int B, cudaStream_t stream) {
  const size_t kv = (size_t)2 * KTILE * (DK + 8);
  const size_t wst = (size_t)64 * (a.D + 8);
  const size_t smem = ((size_t)QT * (a.D + 8) + (kv > wst ? kv : wst)) * sizeof(bf16);
  cudaError_t e = set_smem(attn_block_kernel<DK, EPI>, smem);
  if (e != cudaSuccess) return e;
  attn_block_kernel<DK, EPI><<<dim3((a.T + QT - 1) / QT, B, 1), 128, smem, stream>>>(a);
  return cudaGetLastError();
}

// DK is a template parameter: pick the instantiation for D / H.
template <int EPI>
cudaError_t launch_attn_any(const AttnArgs& a, int B, cudaStream_t stream) {
  if (a.D / a.H == 128) return launch_attn<128, EPI>(a, B, stream);
  return launch_attn<192, EPI>(a, B, stream);
}

bool attn_shape_ok(int D, int H) {
  const int DK = H > 0 ? D / H : 0;
  return D % 64 == 0 && DK * H == D && (DK == 128 || DK == 192);
}

// q/k/v heads packed along D with a common row stride ld; res and out
// (B, T, D) f32; the RES epilogues.
AttnArgs packed_args(const float* res, const bf16* q, const bf16* k, const bf16* v,
                     int ld, const bf16* wo, const float* bo, const float* g,
                     const float* be, const int* lens, float* out, int T, int D,
                     int H, float scale, float eps) {
  AttnArgs a{};
  a.res = res;
  a.q = q;
  a.k = k;
  a.v = v;
  a.sb = T * ld;
  a.sh = D / H;
  a.ld = ld;
  a.wo = wo;
  a.bo = bo;
  a.g = g;
  a.be = be;
  a.lens = lens;
  a.out = out;
  a.T = T;
  a.D = D;
  a.H = H;
  a.scale = scale;
  a.eps = eps;
  return a;
}

}  // namespace

// x (B,T,D) f32; wqkv (3D, D) bf16 [q|k|v rows, (out, in)]; bqkv (3D) f32;
// wo (D, D) bf16 (out, in); bo/g/be (D) f32; lens (B) i32;
// qkv (B,T,3D) bf16 scratch; out (B,T,D) f32.
FS2_EXPORT int fs2_attention_block(const float* x, const bf16* wqkv,
                                   const float* bqkv, const bf16* wo,
                                   const float* bo, const float* g,
                                   const float* be, const int* lens, bf16* qkv,
                                   float* out, int B, int T, int D, int H,
                                   float scale, float eps, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (!attn_shape_ok(D, H)) return (int)cudaErrorInvalidValue;
  using G = TileGemm<2, 2, 2, 8>;
  const size_t smem1 = ((size_t)G::BM * (D + 8) + G::STAGE_ELEMS) * sizeof(bf16);
  cudaError_t e = set_smem(qkv_proj_kernel, smem1);
  if (e != cudaSuccess) return (int)e;
  qkv_proj_kernel<<<dim3((T + G::BM - 1) / G::BM, (3 * D + G::BN - 1) / G::BN, B), G::THREADS,
                    smem1, stream>>>(x, wqkv, bqkv, lens, qkv, T, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_attn_any<EPI_RES_LN>(
      packed_args(x, qkv, qkv + D, qkv + 2 * D, 3 * D, wo, bo, g, be, lens, out, T, D, H,
                  scale, eps),
      B, stream);
}

// The second launch alone, q/k/v given: out = LN(res + MHA(q, k, v) Wo + bo).
// Replaces fastspeech2_tpu/ops/pallas/attention.py:
// fused_attention_packed_res_ln (kernel _attn_kernel_packed_res_ln), which the
// JAX package takes with FS2_FUSED_ATT_QKV=off.
// res (B,T,D) f32; q, k, v (B,T,D) bf16, each with row stride ld elements
// (ld >= D, a multiple of 8, 16-byte aligned bases): three separate tensors
// (ld = D) or three column blocks of one buffer; rows at or past the length
// are not used. wo (D, D) bf16 (out, in); bo/g/be (D) f32; lens (B) i32;
// out (B,T,D) f32.
FS2_EXPORT int fs2_attention_res_ln(const float* res, const bf16* q, const bf16* k,
                                    const bf16* v, int ld, const bf16* wo,
                                    const float* bo, const float* g, const float* be,
                                    const int* lens, float* out, int B, int T, int D,
                                    int H, float scale, float eps, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (!attn_shape_ok(D, H) || ld < D || ld % 8 != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_attn_any<EPI_RES_LN>(
      packed_args(res, q, k, v, ld, wo, bo, g, be, lens, out, T, D, H, scale, eps), B,
      stream);
}

// Pre-LN: out = res + MHA(q, k, v) Wo + bo, no LayerNorm; rows at or past the
// length give res + bo. Replaces fastspeech2_tpu/ops/pallas/attention.py:
// fused_attention_packed_res (kernel _attn_kernel_packed_res). Arguments as
// fs2_attention_res_ln without g/be/eps.
FS2_EXPORT int fs2_attention_res(const float* res, const bf16* q, const bf16* k,
                                 const bf16* v, int ld, const bf16* wo,
                                 const float* bo, const int* lens, float* out, int B,
                                 int T, int D, int H, float scale, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (!attn_shape_ok(D, H) || ld < D || ld % 8 != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_attn_any<EPI_RES>(
      packed_args(res, q, k, v, ld, wo, bo, nullptr, nullptr, lens, out, T, D, H, scale,
                  0.f),
      B, stream);
}

// Bare masked attention, out = MHA(q, k, v) in bf16 (no projection); rows at
// or past the length are zeros. Replaces fastspeech2_tpu/ops/pallas/
// attention.py: fused_attention_packed (packed = 1: q, k, v (B, T, .), head h
// = columns [h DK, (h + 1) DK) of rows ld >= H * DK apart -- contiguous, or
// column blocks of one q|k|v buffer; out (B, T, H * DK) contiguous) and
// fused_attention (packed = 0: q, k, v and out (B, H, T, DK) contiguous,
// ld = DK). ld a multiple of 8, bases 16-byte aligned; lens (B) i32; DK 128,
// 192 or 256. The SERVE forward of attention_fwd.cuh, its three tensor maps
// encoded per call.
FS2_EXPORT int fs2_attention(const bf16* q, const bf16* k, const bf16* v, int ld,
                             const int* lens, bf16* out, int B, int T, int H, int DK, int packed,
                             float scale, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if ((DK != 128 && DK != 192 && DK != 256) || B < 1 || T < 1 || H < 1 || ld % 8 != 0 ||
      (packed ? ld < H * DK : ld != DK))
    return (int)cudaErrorInvalidValue;
  const long long osb = (long long)H * T * DK, osh = packed ? DK : (long long)T * DK;
  const int osr = packed ? H * DK : DK;
  const Geometry gm = packed ? Geometry{T, H, (long long)T * ld, DK, ld, 1, osb, osh, osr}
                             : Geometry{T, H, osb, osh, DK, 0, osb, osh, osr};
  if (DK == 128)
    return (int)launch_fwd<128, FWD_SERVE>(q, k, v, lens, out, nullptr, nullptr, B, gm, scale,
                                           0u, 0u, 1.0f, stream);
  if (DK == 192)
    return (int)launch_fwd<192, FWD_SERVE>(q, k, v, lens, out, nullptr, nullptr, B, gm, scale,
                                           0u, 0u, 1.0f, stream);
  return (int)launch_fwd<256, FWD_SERVE>(q, k, v, lens, out, nullptr, nullptr, B, gm, scale, 0u,
                                         0u, 1.0f, stream);
}
