// Post-LN FFT-block attention half on the H100:
//   out = LN(x + MHA(x Wq + bq, x Wk + bk, x Wv + bv) Wo + bo)
// masked by length; rows at or past the length give LN(x + bo).
//
// Replaces fastspeech2_tpu/ops/pallas/attention.py:
// fused_attention_packed_qkv_res_ln (kernel _attn_kernel_packed_qkv_res_ln)
// and, through the second launch alone with q/k/v given
// (fs2_attention_res_ln), fused_attention_packed_res_ln.
//
// Bound on the H100: at the serving shapes (T <= 2048, D = 256/384, two
// heads of 128/192) the work is ~8*T*D^2 projection FLOPs plus ~4*T^2*D
// attention FLOPs per row against ~8*T*D bytes of f32 stream, i.e. well
// above the card's ~295 FLOP/byte ridge: tensor-core (operations) bound.
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
//     (V through the transposing load). The head output (o_scr, bf16)
//     overwrites the head's Q columns in shared memory; the out projection
//     stages Wo 64 output columns at a time in the K/V space, adds bo and the
//     residual, writes the f32 rows, and each warp LayerNorms its own 16
//     rows. QK^T runs twice (1.5x attention FLOPs) -- the price of exact
//     rounding points in a first kernel; an online softmax is the obvious
//     later trade.
#include "common.cuh"

namespace {

constexpr int QT = 64;     // query rows per block: 4 warps x 16
constexpr int KTILE = 64;  // keys per streamed K/V tile

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

// s = Q_w K^T for one warp: 16 query rows (Qw, row stride lq) x 64 keys (Ks).
template <int DK>
__device__ __forceinline__ void warp_scores(float (&s)[8][4], const bf16* Qw,
                                            int lq, const bf16* Ks, int lk,
                                            int lane) {
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r) s[ni][r] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DK; kk += 16) {
    uint32_t a[4];
    load_a_frag(a, Qw + kk, lq, lane);
#pragma unroll
    for (int ni = 0; ni < 8; ni += 2) {
      uint32_t b[4];
      load_b_frag2(b, Ks + ni * 8 * lk + kk, lk, lane);
      mma_bf16(s[ni], a, b[0], b[1]);
      mma_bf16(s[ni + 1], a, b[2], b[3]);
    }
  }
}

// One 64-key tile of K (and V) of head h into shared memory, zeros at keys
// >= len; row-major [key][d], row stride lk.
template <int DK>
__device__ __forceinline__ void load_kv_tile(bf16* Ks, bf16* Vs, int lk,
                                             const bf16* __restrict__ kp,
                                             const bf16* __restrict__ vp,
                                             size_t row0, int ld, int h,
                                             int k0, int len) {
  for (int i = threadIdx.x; i < KTILE * (DK / 8); i += blockDim.x) {
    const int r = i / (DK / 8), c = (i % (DK / 8)) * 8;
    const bool ok = k0 + r < len;
    const size_t off = ok ? (row0 + k0 + r) * ld + h * DK + c : 0;
    cp_async16(Ks + r * lk + c, kp + off, ok);
    if (Vs != nullptr) cp_async16(Vs + r * lk + c, vp + off, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

template <int DK>
__global__ void __launch_bounds__(128)
attn_block_kernel(const float* __restrict__ x, const bf16* __restrict__ qp,
                  const bf16* __restrict__ kp, const bf16* __restrict__ vp, int ld,
                  const bf16* __restrict__ wo, const float* __restrict__ bo,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const int* __restrict__ lens, float* __restrict__ out, int T,
                  int D, int H, float scale, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lq = D + 8, lk = DK + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [QT][lq]: Q, then o_scr
  bf16* Ks = Qs + QT * lq;                   // [KTILE][lk]
  bf16* Vs = Ks + KTILE * lk;                // [KTILE][lk]
  bf16* Wst = Ks;                            // [64][lq]: Wo slice (aliases K/V)
  const int b = blockIdx.y, t0 = blockIdx.x * QT;
  const int len = min(lens[b], T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t row0 = (size_t)b * T;

  if (t0 >= len) {  // dead tile: every row is LN(x + bo)
    for (int r = warp; r < QT && t0 + r < T; r += 4) {
      const float* xr = x + (row0 + t0 + r) * D;
      float* orow = out + (row0 + t0 + r) * D;
      for (int c = lane; c < D; c += 32) orow[c] = xr[c] + bo[c];
      __syncwarp();
      warp_layer_norm(orow, orow, D, gamma, beta, eps, lane);
    }
    return;
  }

  for (int i = threadIdx.x; i < QT * (D / 8); i += 128) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T) v = *reinterpret_cast<const uint4*>(qp + (row0 + t0 + r) * ld + c);
    *reinterpret_cast<uint4*>(Qs + r * lq + c) = v;
  }

  const int qr = warp * 16;  // this warp's rows in the tile
  const bool va = t0 + qr + g8 < len, vb = t0 + qr + g8 + 8 < len;
  const int nkt = (len + KTILE - 1) / KTILE;

  for (int h = 0; h < H; ++h) {
    const bf16* Qw = Qs + qr * lq + h * DK;
    // pass 1: row max m and denominator l = sum exp(s - m) over valid keys
    float m_a = -FLT_MAX, m_b = -FLT_MAX, l_a = 0.f, l_b = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * KTILE;
      __syncthreads();
      load_kv_tile<DK>(Ks, nullptr, lk, kp, vp, row0, ld, h, k0, len);
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
      load_kv_tile<DK>(Ks, Vs, lk, kp, vp, row0, ld, h, k0, len);
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
        const uint32_t a[4] = {pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3]};
#pragma unroll
        for (int dn = 0; dn < DK / 8; dn += 2) {
          // V is [key][d]: the transposing load gives the col-major B
          uint32_t b[4];
          ldmatrix_x4_trans(b, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * lk +
                                   (dn + (lane >> 4)) * 8);
          mma_bf16(o[dn], a, b[0], b[1]);
          mma_bf16(o[dn + 1], a, b[2], b[3]);
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

  // out projection, 64 output columns at a time: v = round(o_scr Wo) + bo + x
  for (int n0 = 0; n0 < D; n0 += 64) {
    __syncthreads();
    for (int i = threadIdx.x; i < 64 * (D / 8); i += 128) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      cp_async16(Wst + r * lq + c, wo + (size_t)(n0 + r) * D + c, true);
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
      uint32_t a[4];
      load_a_frag(a, Qs + qr * lq + kk, lq, lane);
#pragma unroll
      for (int ni = 0; ni < 8; ni += 2) {
        uint32_t b[4];
        load_b_frag2(b, Wst + ni * 8 * lq + kk, lq, lane);
        mma_bf16(acc[ni], a, b[0], b[1]);
        mma_bf16(acc[ni + 1], a, b[2], b[3]);
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
          out[off] = (bf16r(acc[ni][e]) + bo[c]) + x[off];
        }
      }
  }
  __syncwarp();
  for (int r = 0; r < 16 && t0 + qr + r < T; ++r) {
    float* orow = out + (row0 + t0 + qr + r) * D;
    warp_layer_norm(orow, orow, D, gamma, beta, eps, lane);
  }
}

template <int DK>
cudaError_t launch_attn(const float* x, const bf16* qp, const bf16* kp,
                        const bf16* vp, int ld, const bf16* wo,
                        const float* bo, const float* g, const float* be,
                        const int* lens, float* out, int B, int T, int D, int H,
                        float scale, float eps, cudaStream_t stream) {
  const size_t kv = (size_t)2 * KTILE * (DK + 8);
  const size_t wst = (size_t)64 * (D + 8);
  const size_t smem = ((size_t)QT * (D + 8) + (kv > wst ? kv : wst)) * sizeof(bf16);
  cudaError_t e = set_smem(attn_block_kernel<DK>, smem);
  if (e != cudaSuccess) return e;
  attn_block_kernel<DK><<<dim3((T + QT - 1) / QT, B), 128, smem, stream>>>(
      x, qp, kp, vp, ld, wo, bo, g, be, lens, out, T, D, H, scale, eps);
  return cudaGetLastError();
}

// DK is a template parameter: pick the instantiation for D / H.
cudaError_t launch_attn_any(const float* x, const bf16* qp, const bf16* kp,
                            const bf16* vp, int ld, const bf16* wo, const float* bo,
                            const float* g, const float* be, const int* lens,
                            float* out, int B, int T, int D, int H, float scale,
                            float eps, cudaStream_t stream) {
  if (D / H == 128)
    return launch_attn<128>(x, qp, kp, vp, ld, wo, bo, g, be, lens, out, B, T, D, H,
                            scale, eps, stream);
  return launch_attn<192>(x, qp, kp, vp, ld, wo, bo, g, be, lens, out, B, T, D, H,
                          scale, eps, stream);
}

bool attn_shape_ok(int D, int H) {
  const int DK = H > 0 ? D / H : 0;
  return D % 64 == 0 && DK * H == D && (DK == 128 || DK == 192);
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
  return (int)launch_attn_any(x, qkv, qkv + D, qkv + 2 * D, 3 * D, wo, bo, g, be, lens,
                              out, B, T, D, H, scale, eps, stream);
}

// The second launch alone, q/k/v given: out = LN(res + MHA(q, k, v) Wo + bo).
// Replaces fastspeech2_tpu/ops/pallas/attention.py:
// fused_attention_packed_res_ln (kernel _attn_kernel_packed_res_ln), which the
// JAX package takes with FS2_FUSED_ATT_QKV=off.
// res (B,T,D) f32; q, k, v (B,T,D) bf16, each with row stride ld elements
// (ld >= D, a multiple of 8, 16-byte aligned bases): three separate tensors
// (ld = D) or three column blocks of one buffer; rows at or past the length
// are not read. wo (D, D) bf16 (out, in); bo/g/be (D) f32; lens (B) i32;
// out (B,T,D) f32.
FS2_EXPORT int fs2_attention_res_ln(const float* res, const bf16* q, const bf16* k,
                                    const bf16* v, int ld, const bf16* wo,
                                    const float* bo, const float* g, const float* be,
                                    const int* lens, float* out, int B, int T, int D,
                                    int H, float scale, float eps, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (!attn_shape_ok(D, H) || ld < D || ld % 8 != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_attn_any(res, q, k, v, ld, wo, bo, g, be, lens, out, B, T, D, H,
                              scale, eps, stream);
}
