// Training attention on the H100, forward and backward:
//   A = masked softmax(Q K^T * scale),  D = keep ? A / (1 - rate) : 0,  O = D V
//   dA = keep ? (dO V^T) / (1 - rate) : 0,  dV = D^T dO,
//   t = rowsum(dA * A),  dS = A * (dA - t),  dQ = dS K * scale,  dK = dS^T Q * scale
// valid where row < len[b] and col < len[b]; a padded query row gives exact
// zeros and takes exact-zero gradients, padded keys take zero dK and dV.
//
// Replaces fastspeech2_tpu/ops/pallas/attention_train.py:
// fused_attention_train_packed (kernels _fwd_kernel_packed, _bwd_kernel_packed;
// (B, T, D) with heads as column blocks) and fused_attention_train
// (_fwd_kernel, _bwd_kernel; (B, H, T, dk)). One kernel body serves both
// layouts through a batch, a head and a row stride; each layout has its own
// C entries and neither makes a re-packing copy.
//
// The keep mask is the TPU kernel's counter hash, bit for bit:
//   lowbias32(idx ^ lowbias32(seed ^ 0x9E3779B9 * (b * 1024 + h))) >= thresh,
//   idx = row * T + col with T the padded length, all in uint32,
// so forward and backward regenerate the same mask with no mask tensor.
//
// Bound on the H100: 4 T^2 dk FLOPs per (b, h) forward and 10 T^2 dk backward
// against 4 (8) T dk bf16 values moved: far above the ~295 FLOP/byte ridge, so
// tensor-core (operations) bound.
//
// Design. The TPU kernels hold whole (T, T) f32 score matrices in VMEM (one
// forward, three backward; 3.2 MB each at T = 896); a block here has 227 KB,
// so K/V stream through shared memory in 64-row tiles and nothing (T, T)
// ever exists.
//  * forward: one block per (64-query tile, head, row), 4 warps x 16 query
//    rows. Two passes over the keys, like the serving kernel: pass 1 finds
//    each row's max m and denominator l; pass 2 forms the NORMALISED weight
//    p = exp(s - m) / max(l, tiny) in f32, applies keep and 1 / (1 - rate) to
//    it, rounds to bf16 and accumulates D V in f32 registers. Dropping the
//    normalised weight keeps the TPU kernel's rounding point (round after
//    normalise-and-scale). m and max(l, tiny) are saved per row, (2, B, H, T)
//    f32, for the backward (the TPU kernel saves only q, k, v and recomputes
//    them; the extra vector is 0.2% of q's bytes).
//  * backward, launch 1 (dq): a block owns a query tile and loops over the
//    key tiles twice: pass 1 computes t = rowsum(dA * A) from recomputed S and
//    dA (exact, not rowsum(dO * O), which differs by O's rounding) and stores
//    it, (B, H, T) f32; pass 2 recomputes S and dA, forms dS in f32, rounds it
//    to bf16 and accumulates dQ = dS K in registers.
//  * backward, launch 2 (dk/dv): a block owns a key tile and loops over the
//    query tiles with the transposed products (S^T = K Q^T, dA^T = V dO^T), so
//    its dK or dV tile stays in registers: no atomics, no dependence on block
//    order. Even blocks of grid.x produce dV (= D^T dO), odd blocks dK
//    (= dS^T Q): two 96-register accumulators in one block would spill at
//    dk = 192.
//  That is 4 products forward for the function's 2 and 10 backward for its 5
//  (S is recomputed in every pass): the price of exact rounding points and no
//  atomics in a first kernel. mma.sync + ldmatrix; no wgmma/TMA yet.
//  An f32 instantiation with plain multiply-adds follows the bf16 kernels.
#include "common.cuh"

namespace {

constexpr int TILE = 64;  // rows per block and per streamed tile: 4 warps x 16

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t mask_key(uint32_t seed, int b, int h) {
  return lowbias32(seed ^ (0x9E3779B9u * (uint32_t)(b * 1024 + h)));
}

__device__ __forceinline__ bool keep_at(uint32_t key, uint32_t thresh, int row, int col,
                                        int T) {
  return lowbias32(((uint32_t)row * (uint32_t)T + (uint32_t)col) ^ key) >= thresh;
}

// Rows [r0, r0 + 64) x DK columns of one (b, h) matrix (row stride sr
// elements) into shared memory (row stride lk), zeros at rows >= limit.
// Issues cp.async and commits; the caller waits.
template <int DK>
__device__ __forceinline__ void load_rows(bf16* dst, int lk, const bf16* __restrict__ src,
                                          int sr, int r0, int limit) {
  for (int i = threadIdx.x; i < TILE * (DK / 8); i += blockDim.x) {
    const int r = i / (DK / 8), c = (i % (DK / 8)) * 8;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * lk + c, ok ? src + (size_t)(r0 + r) * sr + c : src, ok);
  }
  cp_async_commit();
}

// acc += A_w (16 x 64, bf16 fragments pa) * X, X a k-major tile in shared
// memory ([k][n], 64 x DK, row stride lk) read through the transposing load.
template <int DK>
__device__ __forceinline__ void warp_accumulate(float (&acc)[DK / 8][4],
                                                const uint32_t (&pa)[4][4], const bf16* Xs,
                                                int lk, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3]};
#pragma unroll
    for (int dn = 0; dn < DK / 8; dn += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, Xs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * lk +
                               (dn + (lane >> 4)) * 8);
      mma_bf16(acc[dn], a, b[0], b[1]);
      mma_bf16(acc[dn + 1], a, b[2], b[3]);
    }
  }
}

// The warp's 16 x DK accumulator tile to global memory as bf16, times mul;
// rows >= T are not written.
template <int DK>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, int sr, int r0, int T,
                                           const float (&acc)[DK / 8][4], float mul,
                                           int lane) {
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int dn = 0; dn < DK / 8; ++dn) {
    const int c = dn * 8 + 2 * t4;
    if (r0 + g8 < T)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r0 + g8) * sr + c) =
          pack_bf16(acc[dn][0] * mul, acc[dn][1] * mul);
    if (r0 + g8 + 8 < T)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r0 + g8 + 8) * sr + c) =
          pack_bf16(acc[dn][2] * mul, acc[dn][3] * mul);
  }
}

// Zero rows [r0, min(r0 + 64, T)) x DK of one (b, h) matrix.
template <int DK>
__device__ __forceinline__ void zero_rows(bf16* __restrict__ dst, int sr, int r0, int T) {
  for (int i = threadIdx.x; i < TILE * (DK / 8); i += blockDim.x) {
    const int r = i / (DK / 8), c = (i % (DK / 8)) * 8;
    if (r0 + r < T)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * sr + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

struct Geometry {
  int T, H;
  long long sb, sh;  // batch and head stride, elements
  int sr;            // row stride, elements
};

template <int DK>
__global__ void __launch_bounds__(128)
train_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ lens,
                 bf16* __restrict__ o, float* __restrict__ m_out,
                 float* __restrict__ den_out, Geometry gm, float scale, uint32_t seed,
                 uint32_t thresh, float keep_prob) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int lk = DK + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TILE * lk;
  bf16* Vs = Ks + TILE * lk;
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * TILE;
  const int T = gm.T;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  const size_t srow = ((size_t)b * gm.H + h) * T;
  if (t0 >= len) {  // dead tile: exact zeros
    zero_rows<DK>(o + base, gm.sr, t0, T);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int qr = warp * 16;
  const int ra = t0 + qr + g8, rb = ra + 8;
  const bool va = ra < len, vb = rb < len;
  const int nkt = (len + TILE - 1) / TILE;
  const uint32_t key = mask_key(seed, b, h);

  load_rows<DK>(Qs, lk, q + base, gm.sr, t0, len);
  const bf16* Qw = Qs + qr * lk;

  // pass 1: row max m and denominator l = sum exp(s - m) over valid keys
  float m_a = -FLT_MAX, m_b = -FLT_MAX, l_a = 0.f, l_b = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_rows<DK>(Ks, lk, k + base, gm.sr, k0, len);
    cp_async_wait<0>();
    __syncthreads();
    float s[8][4];
    warp_scores<DK>(s, Qw, lk, Ks, lk, lane);
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
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    float sa = 0.f, sb2 = 0.f;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool vc = k0 + ni * 8 + 2 * t4 + e < len;
        if (va && vc) sa += expf(s[ni][e] - mn_a);
        if (vb && vc) sb2 += expf(s[ni][2 + e] - mn_b);
      }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, o2);
      sb2 += __shfl_xor_sync(0xffffffffu, sb2, o2);
    }
    l_a = l_a * expf(m_a - mn_a) + sa;
    l_b = l_b * expf(m_b - mn_b) + sb2;
    m_a = mn_a;
    m_b = mn_b;
  }
  const float den_a = fmaxf(l_a, FLT_MIN), den_b = fmaxf(l_b, FLT_MIN);
  if (t4 == 0) {
    if (ra < T) {
      m_out[srow + ra] = m_a;
      den_out[srow + ra] = den_a;
    }
    if (rb < T) {
      m_out[srow + rb] = m_b;
      den_out[srow + rb] = den_b;
    }
  }

  // pass 2: O = round(D) V, D = keep ? p / (1 - rate) : 0, p normalised in f32
  float acc[DK / 8][4];
#pragma unroll
  for (int dn = 0; dn < DK / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[dn][r] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_rows<DK>(Ks, lk, k + base, gm.sr, k0, len);
    load_rows<DK>(Vs, lk, v + base, gm.sr, k0, len);
    cp_async_wait<0>();
    __syncthreads();
    float s[8][4];
    warp_scores<DK>(s, Qw, lk, Ks, lk, lane);
    uint32_t pa[4][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + ni * 8 + 2 * t4 + e;
        const bool vc = col < len;
        p[e] = (va && vc) ? expf(s[ni][e] * scale - m_a) / den_a : 0.f;
        p[2 + e] = (vb && vc) ? expf(s[ni][2 + e] * scale - m_b) / den_b : 0.f;
        if (thresh != 0u) {
          p[e] = keep_at(key, thresh, ra, col, T) ? p[e] / keep_prob : 0.f;
          p[2 + e] = keep_at(key, thresh, rb, col, T) ? p[2 + e] / keep_prob : 0.f;
        }
      }
      pa[ni >> 1][(ni & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[ni >> 1][(ni & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    warp_accumulate<DK>(acc, pa, Vs, lk, lane);
  }
  store_rows<DK>(o + base, gm.sr, t0 + qr, T, acc, 1.0f, lane);
}

// Backward launch 1: t = rowsum(dA * A) and dQ for one query tile.
template <int DK>
__global__ void __launch_bounds__(128)
train_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const int* __restrict__ lens, const float* __restrict__ m_in,
                    const float* __restrict__ den_in, float* __restrict__ t_out,
                    bf16* __restrict__ dq, Geometry gm, float scale, uint32_t seed,
                    uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int lk = DK + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + TILE * lk;  // dO
  bf16* Ks = Gs + TILE * lk;
  bf16* Vs = Ks + TILE * lk;
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * TILE;
  const int T = gm.T;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  const size_t srow = ((size_t)b * gm.H + h) * T;
  if (t0 >= len) {
    zero_rows<DK>(dq + base, gm.sr, t0, T);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int qr = warp * 16;
  const int ra = t0 + qr + g8, rb = ra + 8;
  const bool va = ra < len, vb = rb < len;
  const int nkt = (len + TILE - 1) / TILE;
  const uint32_t key = mask_key(seed, b, h);
  const float m_a = va ? m_in[srow + ra] : 0.f, m_b = vb ? m_in[srow + rb] : 0.f;
  const float den_a = va ? den_in[srow + ra] : 1.f, den_b = vb ? den_in[srow + rb] : 1.f;

  load_rows<DK>(Qs, lk, q + base, gm.sr, t0, len);
  load_rows<DK>(Gs, lk, dout + base, gm.sr, t0, len);
  const bf16* Qw = Qs + qr * lk;
  const bf16* Gw = Gs + qr * lk;

  float t_a = 0.f, t_b = 0.f;
  float acc[DK / 8][4];
#pragma unroll
  for (int dn = 0; dn < DK / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[dn][r] = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    float sum_a = 0.f, sum_b = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * TILE;
      __syncthreads();
      load_rows<DK>(Ks, lk, k + base, gm.sr, k0, len);
      load_rows<DK>(Vs, lk, v + base, gm.sr, k0, len);
      cp_async_wait<0>();
      __syncthreads();
      float s[8][4], da[8][4];
      warp_scores<DK>(s, Qw, lk, Ks, lk, lane);
      warp_scores<DK>(da, Gw, lk, Vs, lk, lane);
      uint32_t pa[4][4];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + ni * 8 + 2 * t4 + e;
          const bool vc = col < len;
          const float p_a = (va && vc) ? expf(s[ni][e] * scale - m_a) / den_a : 0.f;
          const float p_b = (vb && vc) ? expf(s[ni][2 + e] * scale - m_b) / den_b : 0.f;
          float d_a = da[ni][e], d_b = da[ni][2 + e];
          if (thresh != 0u) {
            d_a = keep_at(key, thresh, ra, col, T) ? d_a * inv_keep : 0.f;
            d_b = keep_at(key, thresh, rb, col, T) ? d_b * inv_keep : 0.f;
          }
          sum_a += d_a * p_a;
          sum_b += d_b * p_b;
          ds[e] = (va && vc) ? p_a * (d_a - t_a) : 0.f;
          ds[2 + e] = (vb && vc) ? p_b * (d_b - t_b) : 0.f;
        }
        pa[ni >> 1][(ni & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        pa[ni >> 1][(ni & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      if (pass == 1) warp_accumulate<DK>(acc, pa, Ks, lk, lane);
    }
    if (pass == 0) {
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1) {
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o2);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o2);
      }
      t_a = sum_a;
      t_b = sum_b;
      if (t4 == 0) {
        if (ra < T) t_out[srow + ra] = t_a;
        if (rb < T) t_out[srow + rb] = t_b;
      }
    }
  }
  store_rows<DK>(dq + base, gm.sr, t0 + qr, T, acc, scale, lane);
}

// Backward launch 2: one key tile's dV (even blockIdx.x) or dK (odd), looping
// over the query tiles with the transposed products.
template <int DK>
__global__ void __launch_bounds__(128)
train_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const int* __restrict__ lens, const float* __restrict__ m_in,
                     const float* __restrict__ den_in, const float* __restrict__ t_in,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, Geometry gm, float scale,
                     uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int lk = DK + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // own key tile
  bf16* Vs = Ks + TILE * lk;                 // own value tile (dK blocks)
  bf16* Qs = Vs + TILE * lk;                 // streamed query tile
  bf16* Gs = Qs + TILE * lk;                 // streamed dO tile
  float* stat = reinterpret_cast<float*>(Gs + TILE * lk);  // m, den, t: [3][64]
  const bool want_dk = (blockIdx.x & 1) != 0;
  const int b = blockIdx.z, h = blockIdx.y, k0 = (blockIdx.x >> 1) * TILE;
  const int T = gm.T;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  const size_t srow = ((size_t)b * gm.H + h) * T;
  bf16* outp = (want_dk ? dk : dv) + base;
  if (k0 >= len) {
    zero_rows<DK>(outp, gm.sr, k0, T);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int kr = warp * 16;
  const int ca = k0 + kr + g8, cb = ca + 8;  // this thread's keys
  const bool va = ca < len, vb = cb < len;
  const int nqt = (len + TILE - 1) / TILE;
  const uint32_t key = mask_key(seed, b, h);

  load_rows<DK>(Ks, lk, k + base, gm.sr, k0, len);
  if (want_dk) load_rows<DK>(Vs, lk, v + base, gm.sr, k0, len);
  const bf16* Kw = Ks + kr * lk;
  const bf16* Vw = Vs + kr * lk;

  float acc[DK / 8][4];
#pragma unroll
  for (int dn = 0; dn < DK / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[dn][r] = 0.f;

  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();
    load_rows<DK>(Qs, lk, q + base, gm.sr, q0, len);
    load_rows<DK>(Gs, lk, dout + base, gm.sr, q0, len);
    if (threadIdx.x < TILE) {
      const int r = q0 + threadIdx.x;
      const bool ok = r < len;
      stat[threadIdx.x] = ok ? m_in[srow + r] : 0.f;
      stat[TILE + threadIdx.x] = ok ? den_in[srow + r] : 1.f;
      stat[2 * TILE + threadIdx.x] = ok ? t_in[srow + r] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    float s[8][4], da[8][4];
    warp_scores<DK>(s, Kw, lk, Qs, lk, lane);  // S^T: [key][query]
    if (want_dk) warp_scores<DK>(da, Vw, lk, Gs, lk, lane);  // dA^T
    uint32_t pa[4][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      float w[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = ni * 8 + 2 * t4 + e, row = q0 + qi;
        const bool vq = row < len;
        const float m = stat[qi], den = stat[TILE + qi];
        const float p_a = (va && vq) ? expf(s[ni][e] * scale - m) / den : 0.f;
        const float p_b = (vb && vq) ? expf(s[ni][2 + e] * scale - m) / den : 0.f;
        bool keep_a = true, keep_b = true;
        if (thresh != 0u) {
          keep_a = keep_at(key, thresh, row, ca, T);
          keep_b = keep_at(key, thresh, row, cb, T);
        }
        if (want_dk) {
          const float t = stat[2 * TILE + qi];
          float d_a = da[ni][e], d_b = da[ni][2 + e];
          if (thresh != 0u) {
            d_a = keep_a ? d_a * inv_keep : 0.f;
            d_b = keep_b ? d_b * inv_keep : 0.f;
          }
          w[e] = (va && vq) ? p_a * (d_a - t) : 0.f;
          w[2 + e] = (vb && vq) ? p_b * (d_b - t) : 0.f;
        } else if (thresh != 0u) {
          w[e] = keep_a ? p_a * inv_keep : 0.f;
          w[2 + e] = keep_b ? p_b * inv_keep : 0.f;
        } else {
          w[e] = p_a;
          w[2 + e] = p_b;
        }
      }
      pa[ni >> 1][(ni & 1) * 2 + 0] = pack_bf16(w[0], w[1]);
      pa[ni >> 1][(ni & 1) * 2 + 1] = pack_bf16(w[2], w[3]);
    }
    warp_accumulate<DK>(acc, pa, want_dk ? Qs : Gs, lk, lane);
  }
  store_rows<DK>(outp, gm.sr, k0 + kr, T, acc, want_dk ? scale : 1.0f, lane);
}

template <int DK>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, const int* lens, bf16* o,
                       float* stats, int B, Geometry gm, float scale, uint32_t seed,
                       uint32_t thresh, float keep_prob, cudaStream_t stream) {
  const size_t smem = (size_t)3 * TILE * (DK + 8) * sizeof(bf16);
  cudaError_t e = set_smem(train_fwd_kernel<DK>, smem);
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)B * gm.H * gm.T;
  train_fwd_kernel<DK><<<dim3((gm.T + TILE - 1) / TILE, gm.H, B), 128, smem, stream>>>(
      q, k, v, lens, o, stats, stats + n, gm, scale, seed, thresh, keep_prob);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const int* lens, const float* stats, float* tbuf, bf16* dq, bf16* dk,
                       bf16* dv, int B, Geometry gm, float scale, uint32_t seed,
                       uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const size_t tiles = (size_t)4 * TILE * (DK + 8) * sizeof(bf16);
  const size_t smem2 = tiles + 3 * TILE * sizeof(float);
  cudaError_t e = set_smem(train_bwd_dq_kernel<DK>, tiles);
  if (e != cudaSuccess) return e;
  e = set_smem(train_bwd_dkv_kernel<DK>, smem2);
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)B * gm.H * gm.T;
  const int nt = (gm.T + TILE - 1) / TILE;
  train_bwd_dq_kernel<DK><<<dim3(nt, gm.H, B), 128, tiles, stream>>>(
      q, k, v, dout, lens, stats, stats + n, tbuf, dq, gm, scale, seed, thresh, inv_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  train_bwd_dkv_kernel<DK><<<dim3(2 * nt, gm.H, B), 128, smem2, stream>>>(
      q, k, v, dout, lens, stats, stats + n, tbuf, dk, dv, gm, scale, seed, thresh,
      inv_keep);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 instantiation: the same function on float tensors with plain
// multiply-adds (no tensor cores, no TF32), for callers that hold the kernels
// to an f32 reference. Nothing is rounded (the compute dtype is f32). Same
// decomposition as above (forward in two passes; a dQ launch that stores t; a
// dK/dV launch over key tiles with the transposed products), on 32 x 32 score
// tiles held in shared memory; 256 threads, thread (i = tid / 8, g = tid % 8)
// owns 4 scores of row i and the output columns g, g + 8, ... of row i.
constexpr int FT = 32;        // rows per block and per streamed tile
constexpr int FS = FT + 1;    // score tile row stride

template <int DK>
__device__ __forceinline__ void f32_load_rows(float* dst, const float* __restrict__ src,
                                              int sr, int r0, int limit) {
  constexpr int ld = DK + 1;
  for (int i = threadIdx.x; i < FT * DK; i += blockDim.x) {
    const int r = i / DK, c = i % DK;
    dst[r * ld + c] = r0 + r < limit ? src[(size_t)(r0 + r) * sr + c] : 0.f;
  }
}

// out[i][j] = sum_d A[i][d] * B[j][d] for the 32 x 32 tile.
template <int DK>
__device__ __forceinline__ void f32_tile_dot(float* out, const float* A, const float* B) {
  constexpr int ld = DK + 1;
  const int i = threadIdx.x >> 3, j0 = (threadIdx.x & 7) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d = 0; d < DK; ++d) {
    const float a = A[i * ld + d];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[jj] += a * B[(j0 + jj) * ld + d];
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) out[i * FS + j0 + jj] = acc[jj];
}

// acc[c] += sum_k W[i][k] * X[k][g + 8 c] for this thread's row i.
template <int DK>
__device__ __forceinline__ void f32_tile_acc(float (&acc)[DK / 8], const float* W,
                                             const float* X) {
  constexpr int ld = DK + 1;
  const int i = threadIdx.x >> 3, g = threadIdx.x & 7;
  for (int k = 0; k < FT; ++k) {
    const float w = W[i * FS + k];
#pragma unroll
    for (int c = 0; c < DK / 8; ++c) acc[c] += w * X[k * ld + g + 8 * c];
  }
}

template <int DK>
__device__ __forceinline__ void f32_store_rows(float* __restrict__ dst, int sr, int r0, int T,
                                               const float (&acc)[DK / 8], float mul) {
  const int i = threadIdx.x >> 3, g = threadIdx.x & 7;
  if (r0 + i < T)
#pragma unroll
    for (int c = 0; c < DK / 8; ++c) dst[(size_t)(r0 + i) * sr + g + 8 * c] = acc[c] * mul;
}

template <int DK>
__device__ __forceinline__ void f32_zero_rows(float* __restrict__ dst, int sr, int r0, int T) {
  for (int i = threadIdx.x; i < FT * DK; i += blockDim.x)
    if (r0 + i / DK < T) dst[(size_t)(r0 + i / DK) * sr + i % DK] = 0.f;
}

template <int DK>
__global__ void __launch_bounds__(256)
train_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ lens,
                     float* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ den_out, Geometry gm, float scale, uint32_t seed,
                     uint32_t thresh, float keep_prob) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = DK + 1;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + FT * ld;
  float* Vs = Ks + FT * ld;
  float* Ss = Vs + FT * ld;  // [FT][FS]
  float* ms = Ss + FT * FS;  // row max, then denominator
  float* ls = ms + FT;
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * FT;
  const int T = gm.T;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  const size_t srow = ((size_t)b * gm.H + h) * T;
  if (t0 >= len) {
    f32_zero_rows<DK>(o + base, gm.sr, t0, T);
    return;
  }
  const int nkt = (len + FT - 1) / FT;
  const uint32_t key = mask_key(seed, b, h);
  const int tid = threadIdx.x;
  f32_load_rows<DK>(Qs, q + base, gm.sr, t0, len);
  if (tid < FT) {
    ms[tid] = -FLT_MAX;
    ls[tid] = 0.f;
  }
  for (int kt = 0; kt < nkt; ++kt) {  // pass 1: row max and denominator
    const int k0 = kt * FT;
    __syncthreads();
    f32_load_rows<DK>(Ks, k + base, gm.sr, k0, len);
    __syncthreads();
    f32_tile_dot<DK>(Ss, Qs, Ks);
    __syncthreads();
    if (tid < FT && t0 + tid < len) {
      float mx = ms[tid];
      for (int j = 0; j < FT && k0 + j < len; ++j) mx = fmaxf(mx, Ss[tid * FS + j] * scale);
      float sum = ls[tid] * expf(ms[tid] - mx);
      for (int j = 0; j < FT && k0 + j < len; ++j) sum += expf(Ss[tid * FS + j] * scale - mx);
      ms[tid] = mx;
      ls[tid] = sum;
    }
  }
  __syncthreads();
  if (tid < FT) {
    ls[tid] = fmaxf(ls[tid], FLT_MIN);
    if (t0 + tid < T) {
      m_out[srow + t0 + tid] = ms[tid];
      den_out[srow + t0 + tid] = ls[tid];
    }
  }
  float acc[DK / 8];
#pragma unroll
  for (int c = 0; c < DK / 8; ++c) acc[c] = 0.f;
  const int i = tid >> 3, j0 = (tid & 7) * 4;
  for (int kt = 0; kt < nkt; ++kt) {  // pass 2: O = D V
    const int k0 = kt * FT;
    __syncthreads();
    f32_load_rows<DK>(Ks, k + base, gm.sr, k0, len);
    f32_load_rows<DK>(Vs, v + base, gm.sr, k0, len);
    __syncthreads();
    f32_tile_dot<DK>(Ss, Qs, Ks);  // each thread rewrites only its own 4 scores
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int row = t0 + i, col = k0 + j0 + jj;
      float p = (row < len && col < len)
                    ? expf(Ss[i * FS + j0 + jj] * scale - ms[i]) / ls[i] : 0.f;
      if (thresh != 0u) p = keep_at(key, thresh, row, col, T) ? p / keep_prob : 0.f;
      Ss[i * FS + j0 + jj] = p;
    }
    __syncthreads();
    f32_tile_acc<DK>(acc, Ss, Vs);
  }
  f32_store_rows<DK>(o + base, gm.sr, t0, T, acc, 1.0f);
}

template <int DK>
__global__ void __launch_bounds__(256)
train_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const int* __restrict__ lens, const float* __restrict__ m_in,
                        const float* __restrict__ den_in, float* __restrict__ t_out,
                        float* __restrict__ dq, Geometry gm, float scale, uint32_t seed,
                        uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = DK + 1;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Gs = Qs + FT * ld;
  float* Ks = Gs + FT * ld;
  float* Vs = Ks + FT * ld;
  float* Ss = Vs + FT * ld;
  float* Ds = Ss + FT * FS;
  float* ts = Ds + FT * FS;  // [FT]
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * FT;
  const int T = gm.T;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  const size_t srow = ((size_t)b * gm.H + h) * T;
  if (t0 >= len) {
    f32_zero_rows<DK>(dq + base, gm.sr, t0, T);
    return;
  }
  const int nkt = (len + FT - 1) / FT;
  const uint32_t key = mask_key(seed, b, h);
  const int tid = threadIdx.x, i = tid >> 3, j0 = (tid & 7) * 4;
  const int row = t0 + i;
  const bool vr = row < len;
  const float m = vr ? m_in[srow + row] : 0.f, den = vr ? den_in[srow + row] : 1.f;
  f32_load_rows<DK>(Qs, q + base, gm.sr, t0, len);
  f32_load_rows<DK>(Gs, dout + base, gm.sr, t0, len);
  if (tid < FT) ts[tid] = 0.f;
  float acc[DK / 8];
#pragma unroll
  for (int c = 0; c < DK / 8; ++c) acc[c] = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    const float t = pass == 1 ? ts[i] : 0.f;  // pass 1 reads it after the barrier below
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * FT;
      __syncthreads();
      f32_load_rows<DK>(Ks, k + base, gm.sr, k0, len);
      f32_load_rows<DK>(Vs, v + base, gm.sr, k0, len);
      __syncthreads();
      f32_tile_dot<DK>(Ss, Qs, Ks);
      f32_tile_dot<DK>(Ds, Gs, Vs);
      float part = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = k0 + j0 + jj;
        const bool ok = vr && col < len;
        const float p = ok ? expf(Ss[i * FS + j0 + jj] * scale - m) / den : 0.f;
        float d = Ds[i * FS + j0 + jj];
        if (thresh != 0u) d = keep_at(key, thresh, row, col, T) ? d * inv_keep : 0.f;
        part += d * p;
        Ss[i * FS + j0 + jj] = ok ? p * (d - t) : 0.f;
      }
      if (pass == 0) {
        // the 8 threads of a row are 8 neighbouring lanes
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        part += __shfl_xor_sync(0xffffffffu, part, 4);
        if ((tid & 7) == 0) ts[i] += part;
      } else {
        __syncthreads();
        f32_tile_acc<DK>(acc, Ss, Ks);
      }
    }
    __syncthreads();
    if (pass == 0 && tid < FT && t0 + tid < T) t_out[srow + t0 + tid] = ts[tid];
  }
  f32_store_rows<DK>(dq + base, gm.sr, t0, T, acc, scale);
}

template <int DK>
__global__ void __launch_bounds__(256)
train_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const int* __restrict__ lens, const float* __restrict__ m_in,
                         const float* __restrict__ den_in, const float* __restrict__ t_in,
                         float* __restrict__ dk, float* __restrict__ dv, Geometry gm,
                         float scale, uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = DK + 1;
  float* Ks = reinterpret_cast<float*>(smem);  // own key tile
  float* Vs = Ks + FT * ld;                    // own value tile (dK blocks)
  float* Qs = Vs + FT * ld;                    // streamed query tile
  float* Gs = Qs + FT * ld;                    // streamed dO tile
  float* Ss = Gs + FT * ld;                    // S^T: [key][query]
  float* Ds = Ss + FT * FS;                    // dA^T
  float* stat = Ds + FT * FS;                  // m, den, t: [3][FT]
  const bool want_dk = (blockIdx.x & 1) != 0;
  const int b = blockIdx.z, h = blockIdx.y, k0 = (blockIdx.x >> 1) * FT;
  const int T = gm.T;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  const size_t srow = ((size_t)b * gm.H + h) * T;
  float* outp = (want_dk ? dk : dv) + base;
  if (k0 >= len) {
    f32_zero_rows<DK>(outp, gm.sr, k0, T);
    return;
  }
  const int nqt = (len + FT - 1) / FT;
  const uint32_t key = mask_key(seed, b, h);
  const int tid = threadIdx.x, i = tid >> 3, j0 = (tid & 7) * 4;
  const int col = k0 + i;  // this thread's key
  const bool vk = col < len;
  f32_load_rows<DK>(Ks, k + base, gm.sr, k0, len);
  if (want_dk) f32_load_rows<DK>(Vs, v + base, gm.sr, k0, len);
  float acc[DK / 8];
#pragma unroll
  for (int c = 0; c < DK / 8; ++c) acc[c] = 0.f;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * FT;
    __syncthreads();
    f32_load_rows<DK>(Qs, q + base, gm.sr, q0, len);
    f32_load_rows<DK>(Gs, dout + base, gm.sr, q0, len);
    if (tid < FT) {
      const int r = q0 + tid;
      const bool ok = r < len;
      stat[tid] = ok ? m_in[srow + r] : 0.f;
      stat[FT + tid] = ok ? den_in[srow + r] : 1.f;
      stat[2 * FT + tid] = ok ? t_in[srow + r] : 0.f;
    }
    __syncthreads();
    f32_tile_dot<DK>(Ss, Ks, Qs);
    if (want_dk) f32_tile_dot<DK>(Ds, Vs, Gs);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int qi = j0 + jj, row = q0 + qi;
      const bool ok = vk && row < len;
      const float p = ok ? expf(Ss[i * FS + qi] * scale - stat[qi]) / stat[FT + qi] : 0.f;
      const bool keep = thresh == 0u || keep_at(key, thresh, row, col, T);
      float w;
      if (want_dk) {
        const float d = keep ? (thresh != 0u ? Ds[i * FS + qi] * inv_keep : Ds[i * FS + qi])
                             : 0.f;
        w = ok ? p * (d - stat[2 * FT + qi]) : 0.f;
      } else {
        w = keep ? (thresh != 0u ? p * inv_keep : p) : 0.f;
      }
      Ss[i * FS + qi] = w;
    }
    __syncthreads();
    f32_tile_acc<DK>(acc, Ss, want_dk ? Qs : Gs);
  }
  f32_store_rows<DK>(outp, gm.sr, k0, T, acc, want_dk ? scale : 1.0f);
}

template <int DK>
cudaError_t launch_fwd_f32(const float* q, const float* k, const float* v, const int* lens,
                           float* o, float* stats, int B, Geometry gm, float scale,
                           uint32_t seed, uint32_t thresh, float keep_prob,
                           cudaStream_t stream) {
  const size_t smem = ((size_t)3 * FT * (DK + 1) + FT * FS + 2 * FT) * sizeof(float);
  cudaError_t e = set_smem(train_fwd_f32_kernel<DK>, smem);
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)B * gm.H * gm.T;
  train_fwd_f32_kernel<DK><<<dim3((gm.T + FT - 1) / FT, gm.H, B), 256, smem, stream>>>(
      q, k, v, lens, o, stats, stats + n, gm, scale, seed, thresh, keep_prob);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                           const int* lens, const float* stats, float* tbuf, float* dq,
                           float* dk, float* dv, int B, Geometry gm, float scale,
                           uint32_t seed, uint32_t thresh, float inv_keep,
                           cudaStream_t stream) {
  const size_t tiles = ((size_t)4 * FT * (DK + 1) + 2 * FT * FS) * sizeof(float);
  const size_t smem1 = tiles + FT * sizeof(float), smem2 = tiles + 3 * FT * sizeof(float);
  cudaError_t e = set_smem(train_bwd_dq_f32_kernel<DK>, smem1);
  if (e != cudaSuccess) return e;
  e = set_smem(train_bwd_dkv_f32_kernel<DK>, smem2);
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)B * gm.H * gm.T;
  const int nt = (gm.T + FT - 1) / FT;
  train_bwd_dq_f32_kernel<DK><<<dim3(nt, gm.H, B), 256, smem1, stream>>>(
      q, k, v, dout, lens, stats, stats + n, tbuf, dq, gm, scale, seed, thresh, inv_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  train_bwd_dkv_f32_kernel<DK><<<dim3(2 * nt, gm.H, B), 256, smem2, stream>>>(
      q, k, v, dout, lens, stats, stats + n, tbuf, dk, dv, gm, scale, seed, thresh,
      inv_keep);
  return cudaGetLastError();
}

bool geometry_ok(int B, int T, int H, int DK) {
  return B > 0 && T > 0 && H > 0 && H <= 1024 && (DK == 128 || DK == 192) &&
         (long long)T * T < (1ll << 32);
}

Geometry packed_geometry(int T, int D, int H) {
  return Geometry{T, H, (long long)T * D, (long long)(D / H), D};
}

Geometry split_geometry(int H, int T, int DK) {
  return Geometry{T, H, (long long)H * T * DK, (long long)T * DK, DK};
}

// The entries take untyped pointers and an f32 flag: bf16 tensors go to the
// tensor-core kernels, float tensors to the f32 instantiation.
int fwd_any(const void* q, const void* k, const void* v, const int* lens, void* o,
            float* stats, int B, int DK, Geometry gm, float scale, uint32_t seed,
            uint32_t thresh, float keep_prob, int f32, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (!geometry_ok(B, gm.T, gm.H, DK)) return (int)cudaErrorInvalidValue;
  if (f32) {
    const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
    if (DK == 128)
      return (int)launch_fwd_f32<128>(qf, kf, vf, lens, (float*)o, stats, B, gm, scale, seed,
                                      thresh, keep_prob, stream);
    return (int)launch_fwd_f32<192>(qf, kf, vf, lens, (float*)o, stats, B, gm, scale, seed,
                                    thresh, keep_prob, stream);
  }
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v;
  if (DK == 128)
    return (int)launch_fwd<128>(qb, kb, vb, lens, (bf16*)o, stats, B, gm, scale, seed, thresh,
                                keep_prob, stream);
  return (int)launch_fwd<192>(qb, kb, vb, lens, (bf16*)o, stats, B, gm, scale, seed, thresh,
                              keep_prob, stream);
}

int bwd_any(const void* q, const void* k, const void* v, const void* dout, const int* lens,
            const float* stats, float* tbuf, void* dq, void* dk, void* dv, int B, int DK,
            Geometry gm, float scale, uint32_t seed, uint32_t thresh, float inv_keep, int f32,
            void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (!geometry_ok(B, gm.T, gm.H, DK)) return (int)cudaErrorInvalidValue;
  if (f32) {
    const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v,
                *gf = (const float*)dout;
    if (DK == 128)
      return (int)launch_bwd_f32<128>(qf, kf, vf, gf, lens, stats, tbuf, (float*)dq,
                                      (float*)dk, (float*)dv, B, gm, scale, seed, thresh,
                                      inv_keep, stream);
    return (int)launch_bwd_f32<192>(qf, kf, vf, gf, lens, stats, tbuf, (float*)dq, (float*)dk,
                                    (float*)dv, B, gm, scale, seed, thresh, inv_keep, stream);
  }
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v,
             *gb = (const bf16*)dout;
  if (DK == 128)
    return (int)launch_bwd<128>(qb, kb, vb, gb, lens, stats, tbuf, (bf16*)dq, (bf16*)dk,
                                (bf16*)dv, B, gm, scale, seed, thresh, inv_keep, stream);
  return (int)launch_bwd<192>(qb, kb, vb, gb, lens, stats, tbuf, (bf16*)dq, (bf16*)dk,
                              (bf16*)dv, B, gm, scale, seed, thresh, inv_keep, stream);
}

}  // namespace

// Head-packed layout: q, k, v, o (B, T, D) contiguous, bf16 (f32 = 0) or
// float (f32 = 1), head h = columns [h * D/H, (h + 1) * D/H); lens (B) i32;
// stats (2, B, H, T) f32 (row max, then denominator). thresh =
// min(int(rate * 2^32), 2^32 - 1), 0 for no dropout; keep_prob = 1 - rate.
FS2_EXPORT int fs2_attention_train_fwd_packed(const void* q, const void* k, const void* v,
                                              const int* lens, void* o, float* stats, int B,
                                              int T, int D, int H, float scale,
                                              uint32_t seed, uint32_t thresh,
                                              float keep_prob, int f32, void* stream) {
  if (H <= 0 || D % H != 0) return (int)cudaErrorInvalidValue;
  return fwd_any(q, k, v, lens, o, stats, B, D / H, packed_geometry(T, D, H), scale, seed,
                 thresh, keep_prob, f32, stream);
}

// dout, dq, dk, dv (B, T, D) contiguous, of q's type; stats as the forward
// wrote it; tbuf (B, H, T) f32 scratch; inv_keep = 1 / (1 - rate).
FS2_EXPORT int fs2_attention_train_bwd_packed(const void* q, const void* k, const void* v,
                                              const void* dout, const int* lens,
                                              const float* stats, float* tbuf, void* dq,
                                              void* dk, void* dv, int B, int T, int D, int H,
                                              float scale, uint32_t seed, uint32_t thresh,
                                              float inv_keep, int f32, void* stream) {
  if (H <= 0 || D % H != 0) return (int)cudaErrorInvalidValue;
  return bwd_any(q, k, v, dout, lens, stats, tbuf, dq, dk, dv, B, D / H,
                 packed_geometry(T, D, H), scale, seed, thresh, inv_keep, f32, stream);
}

// Per-head layout: q, k, v, o (B, H, T, DK) contiguous; the rest as above.
FS2_EXPORT int fs2_attention_train_fwd(const void* q, const void* k, const void* v,
                                       const int* lens, void* o, float* stats, int B, int H,
                                       int T, int DK, float scale, uint32_t seed,
                                       uint32_t thresh, float keep_prob, int f32,
                                       void* stream) {
  return fwd_any(q, k, v, lens, o, stats, B, DK, split_geometry(H, T, DK), scale, seed,
                 thresh, keep_prob, f32, stream);
}

FS2_EXPORT int fs2_attention_train_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, const int* lens, const float* stats,
                                       float* tbuf, void* dq, void* dk, void* dv, int B,
                                       int H, int T, int DK, float scale, uint32_t seed,
                                       uint32_t thresh, float inv_keep, int f32,
                                       void* stream) {
  return bwd_any(q, k, v, dout, lens, stats, tbuf, dq, dk, dv, B, DK,
                 split_geometry(H, T, DK), scale, seed, thresh, inv_keep, f32, stream);
}
