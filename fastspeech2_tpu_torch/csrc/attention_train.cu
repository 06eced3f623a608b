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
// (_fwd_kernel, _bwd_kernel; (B, H, T, dk)). One kernel body per direction
// serves both layouts: each operand is read through one TMA map of (columns,
// rows, planes), the plane being the batch row (head h = columns
// [h dk, (h + 1) dk)) or the (batch, head) pair; neither makes a copy.
//
// The keep mask is the TPU kernel's counter hash, bit for bit:
//   lowbias32(idx ^ lowbias32(seed ^ 0x9E3779B9 * (b * 1024 + h))) >= thresh,
//   idx = row * T + col with T the padded length, all in uint32,
// so forward and backward regenerate the same mask with no mask tensor.
//
// Bound on the H100: 4 T^2 dk FLOPs per (b, h) forward and 10 T^2 dk backward
// (the function's 2 and 5 products) against 4 (8) T dk bf16 values moved: far
// above the ~295 FLOP/byte ridge, so tensor-core (operations) bound at long
// rows; at the decoder's training shape the forward's byte bound is the larger.
//
// Design (bf16, sm_90a; primitives in hopper.cuh). Every block is two
// warpgroups, which run the products as m64n64k16 wgmma; the block's thread
// 0 keeps the streamed tiles in flight with TMA through a ring of two
// shared-memory stages (full/empty mbarriers), loading a tile as soon as
// every warp has released the stage's previous one. No separate producer
// warp: with one (288 threads, or 384 with setmaxnreg 24 / 240) ptxas held
// every thread to 168 registers, and the dQ kernels at d_k 192 and every
// d_k 256 kernel spilled; at 256 threads each may use up to 255 and none
// spills. The TPU kernels hold
// whole (T, T) f32 score matrices in VMEM; here keys and queries stream in
// 64-row tiles and nothing (T, T) exists.
//  * forward (one launch): attention_fwd.cuh's body in its FWD_TRAIN mode,
//    shared with the serving kernels 7 and 8. It also saves m (the row max in
//    log2 units) and 1 / max(l, tiny) per row ((2, B, H, Tp) f32, Tp = T
//    rounded up to 64) and the f32 accumulator of O before its rounding
//    (O32, O's layout in f32).
//  * backward, three launches, 7 products, no atomics (every output tile has
//    one writer, so two calls give the same bits):
//    - t: t = rowsum(dO * O32), one warp a row. Equal to rowsum(dA * A) but
//      for the rounding of D inside O32 (~1e-4 of a bf16 step of dS).
//    - dQ (query-major): per key tile S = Q K^T, dA = dO V^T (SS), dS =
//      A (dA - t) rounded to bf16 in registers, dQ += dS K (RS, K MN-major).
//      Row split or key split as the forward (key split always at d_k 256,
//      where 128 rows of Q and dO do not fit beside the ring).
//    - dK/dV (key-major): a block owns 64 keys and streams Q, dO and the
//      rows' m, 1 / den, t. Warpgroup 0: S^T = K Q^T, P^T, D^T, dV += D^T dO.
//      Warpgroup 1: dA^T = V dO^T, then dS^T from the P^T that warpgroup 0
//      leaves in shared memory (sign bit = dropped; double-buffered, named
//      barriers), dK += dS^T Q. One 32-register accumulator per 64 columns
//      of each output and warpgroup.
//  An f32 instantiation with plain multiply-adds follows the bf16 kernels.
#include "attention_fwd.cuh"

namespace {

constexpr int STAGES = 2;  // ring stages of the backward kernels

__device__ __forceinline__ bool keep_at(uint32_t key, uint32_t thresh, int row, int col,
                                        int T) {
  return lowbias32(((uint32_t)row * (uint32_t)T + (uint32_t)col) ^ key) >= thresh;
}

// ---- bf16 kernels: the forward is attention_fwd.cuh's FWD_TRAIN mode -------

// Backward launch 1: t = rowsum(dO * O32) for every row (0 past the length).
__global__ void __launch_bounds__(256)
train_rowdot_kernel(const bf16* __restrict__ dout, const float* __restrict__ o32,
                    const int* __restrict__ lens, float* __restrict__ t_out, Geometry gm, int B,
                    int DK, int Tp) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int T = gm.T;
  if (r >= B * gm.H * T) return;
  const int row = r % T, bh = r / T, h = bh % gm.H, b = bh / gm.H;
  float acc = 0.f;
  if (row < min(lens[b], T)) {
    const size_t off = (size_t)b * gm.sb + (size_t)h * gm.sh + (size_t)row * gm.sr;
    for (int c = 2 * lane; c < DK; c += 64) {
      const float2 x = *reinterpret_cast<const float2*>(o32 + off + c);
      const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + off + c));
      acc += g.x * x.x + g.y * x.y;
    }
    acc = warp_sum(acc);
  }
  if (lane == 0) t_out[(size_t)bh * Tp + row] = acc;
}

// Backward launch 2: dQ for a query tile (row split or key split as the
// forward).
template <int DK, bool KSPLIT>
__global__ void __launch_bounds__(CONSUMERS, 1)
train_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                    const int* __restrict__ lens, const float* __restrict__ m_in,
                    const float* __restrict__ rden_in, const float* __restrict__ t_in,
                    bf16* __restrict__ dq, Geometry gm, int Tp, float scale, uint32_t seed,
                    uint32_t thresh, float inv_keep) {
  constexpr int QROWS = KSPLIT ? TILE : 2 * TILE;
  constexpr int TB = TILE * DK * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Gs = Qs + QROWS * DK * 2;   // dO
  unsigned char* ring = Gs + QROWS * DK * 2;  // STAGES x (K tile, V tile)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * TB);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * QROWS;
  const int T = gm.T;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  if (t0 >= len) {
    zero_rows<DK, QROWS>(dq + base, gm.sr, t0, T);
    return;
  }
  const int nkt = (len + TILE - 1) / TILE;
  const int col = gm.packed ? h * DK : 0, plane = gm.packed ? b : b * gm.H + h;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], KSPLIT ? 4 : 8);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  int issued = 0;  // thread 0 keeps the ring of K and V tiles loaded
  auto top_up = [&](int upto) {
    for (; issued < min(upto, nkt); ++issued) {
      const int s = issued % STAGES;
      mbar_wait(&empty[s], ((issued / STAGES) & 1) ^ 1);
      unsigned char* Ks = ring + s * 2 * TB;
      mbar_expect_tx(&full[s], 2 * TB);
      tma_tile<DK>(Ks, &tk, &full[s], col, issued * TILE, plane);
      tma_tile<DK>(Ks + TB, &tv, &full[s], col, issued * TILE, plane);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, 2 * QROWS * DK * 2);
#pragma unroll
    for (int g = 0; g < QROWS / TILE; ++g) {
      tma_tile<DK>(Qs + g * TB, &tq, qbar, col, t0 + g * TILE, plane);
      tma_tile<DK>(Gs + g * TB, &tg, qbar, col, t0 + g * TILE, plane);
    }
    top_up(STAGES);
  }
  __syncwarp();

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const int r0 = KSPLIT ? t0 : t0 + wg * TILE;
  const int ra = r0 + (t >> 5) * 16 + g8, rb = ra + 8;
  const bool va = ra < len, vb = rb < len;
  const uint32_t key = mask_key(seed, b, h);
  const size_t srow = ((size_t)b * gm.H + h) * Tp;
  const float m_a = va ? m_in[srow + ra] : 0.f, m_b = vb ? m_in[srow + rb] : 0.f;
  const float ra_den = va ? rden_in[srow + ra] : 0.f, rb_den = vb ? rden_in[srow + rb] : 0.f;
  const float t_a = va ? t_in[srow + ra] : 0.f, t_b = vb ? t_in[srow + rb] : 0.f;
  const uint32_t rowa_T = (uint32_t)ra * (uint32_t)T, rowb_T = (uint32_t)rb * (uint32_t)T;
  const float sl2 = scale * LOG2E;
  const uint32_t qaddr = smem_u32(Qs + (KSPLIT ? 0 : wg * TB));
  const uint32_t gaddr = smem_u32(Gs + (KSPLIT ? 0 : wg * TB));
  mbar_wait(qbar, 0);

  float acc[DK / 64][32];
  zero_acc<DK>(acc);
  float s[32], da[32];
  for (int kt = 0; kt < nkt; ++kt) {
    if (KSPLIT && (kt & 1) != wg) continue;
    if (threadIdx.x == 0) top_up(kt + STAGES);
    __syncwarp();
    const int st = kt % STAGES;
    mbar_wait(&full[st], (kt / STAGES) & 1);
    const uint32_t kaddr = smem_u32(ring + st * 2 * TB);
    wgmma_fence();
    tile_product<DK>(s, qaddr, kaddr);
    tile_product<DK>(da, gaddr, kaddr + TB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(da);
    const int k0 = kt * TILE;
    uint32_t pa[4][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = k0 + ni * 8 + 2 * t4 + e;
        const bool vc = c < len;
        const float p_a = exp2f(s[ni * 4 + e] * sl2 - m_a) * ra_den;
        const float p_b = exp2f(s[ni * 4 + 2 + e] * sl2 - m_b) * rb_den;
        float d_a = da[ni * 4 + e], d_b = da[ni * 4 + 2 + e];
        if (thresh != 0u) {
          d_a = lowbias32((rowa_T + (uint32_t)c) ^ key) >= thresh ? d_a * inv_keep : 0.f;
          d_b = lowbias32((rowb_T + (uint32_t)c) ^ key) >= thresh ? d_b * inv_keep : 0.f;
        }
        ds[e] = (va && vc) ? p_a * (d_a - t_a) : 0.f;
        ds[2 + e] = (vb && vc) ? p_b * (d_b - t_b) : 0.f;
      }
      pack_a(pa, ni, ds);
    }
    wgmma_fence();
    tile_accumulate<DK>(acc, pa, kaddr);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < DK / 64; ++c) fence_regs(acc[c]);
    release(&empty[st]);
  }
  if (KSPLIT) {
    merge_acc<DK>(acc, reinterpret_cast<float*>(ring), wg, t);
    if (wg == 1) return;
  }
  store_tile<DK>(dq + base, nullptr, gm.sr, r0, T, len, acc, scale, t);
}

// Backward launch 3: dK and dV of one 64-key tile, streaming the query tiles
// with the transposed products (warpgroup 0 dV, warpgroup 1 dK).
template <int DK>
__global__ void __launch_bounds__(CONSUMERS, 1)
train_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                     const int* __restrict__ lens, const float* __restrict__ m_in,
                     const float* __restrict__ rden_in, const float* __restrict__ t_in,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, Geometry gm, int Tp,
                     float scale, uint32_t seed, uint32_t thresh, float inv_keep) {
  constexpr int TB = TILE * DK * 2;
  constexpr int STAT = 3 * TILE;  // m, 1 / den, t of a query tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Ks = smem;                 // own key tile
  unsigned char* Vs = Ks + TB;              // own value tile
  unsigned char* ring = Vs + TB;            // STAGES x (Q tile, dO tile)
  float* pbuf = reinterpret_cast<float*>(ring + STAGES * 2 * TB);  // [2][32][128]
  float* stat = pbuf + 2 * 32 * 128;                                // [STAGES][3][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(stat + STAGES * STAT);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * TILE;
  const int T = gm.T;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  if (k0 >= len) {
    zero_rows<DK, TILE>(dk + base, gm.sr, k0, T);
    zero_rows<DK, TILE>(dv + base, gm.sr, k0, T);
    return;
  }
  const int nqt = (len + TILE - 1) / TILE;
  const int col = gm.packed ? h * DK : 0, plane = gm.packed ? b : b * gm.H + h;
  const size_t srow = ((size_t)b * gm.H + h) * Tp;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  int issued = 0;  // thread 0 keeps the ring of Q, dO and row-statistic tiles loaded
  auto top_up = [&](int upto) {
    for (; issued < min(upto, nqt); ++issued) {
      const int s = issued % STAGES, q0 = issued * TILE;
      mbar_wait(&empty[s], ((issued / STAGES) & 1) ^ 1);
      unsigned char* Qt = ring + s * 2 * TB;
      float* sv = stat + s * STAT;
      mbar_expect_tx(&full[s], 2 * TB + STAT * 4);
      tma_tile<DK>(Qt, &tq, &full[s], col, q0, plane);
      tma_tile<DK>(Qt + TB, &tg, &full[s], col, q0, plane);
      bulk_load(sv, m_in + srow + q0, TILE * 4, &full[s]);
      bulk_load(sv + TILE, rden_in + srow + q0, TILE * 4, &full[s]);
      bulk_load(sv + 2 * TILE, t_in + srow + q0, TILE * 4, &full[s]);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kvbar, 2 * TB);
    tma_tile<DK>(Ks, &tk, kvbar, col, k0, plane);
    tma_tile<DK>(Vs, &tv, kvbar, col, k0, plane);
    top_up(STAGES);
  }
  __syncwarp();

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const int ca = k0 + (t >> 5) * 16 + g8, cb = ca + 8;  // this thread's keys
  const bool va = ca < len, vb = cb < len;
  const float sl2 = scale * LOG2E;
  float acc[DK / 64][32];
  zero_acc<DK>(acc);
  float s[32];
  mbar_wait(kvbar, 0);

  if (wg == 0) {  // S^T = K Q^T -> P^T, D^T; dV += D^T dO
    const uint32_t key = mask_key(seed, b, h);
    const uint32_t kaddr = smem_u32(Ks);
    for (int qt = 0; qt < nqt; ++qt) {
      if (threadIdx.x == 0) top_up(qt + STAGES);
      __syncwarp();
      const int st = qt % STAGES, buf = qt & 1;
      mbar_wait(&full[st], (qt / STAGES) & 1);
      const uint32_t qaddr = smem_u32(ring + st * 2 * TB);
      const float* sv = stat + st * STAT;
      wgmma_fence();
      tile_product<DK>(s, kaddr, qaddr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (qt >= 2) bar_sync(3 + buf, CONSUMERS);  // warpgroup 1 has read pbuf[buf]
      float* pb = pbuf + buf * 32 * 128;
      const int q0 = qt * TILE;
      uint32_t pa[4][4];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        float w[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = ni * 8 + 2 * t4 + e, row = q0 + qi;
          const bool vq = row < len;
          const float m = sv[qi], rden = sv[TILE + qi];
          const float p_a = (va && vq) ? exp2f(s[ni * 4 + e] * sl2 - m) * rden : 0.f;
          const float p_b = (vb && vq) ? exp2f(s[ni * 4 + 2 + e] * sl2 - m) * rden : 0.f;
          bool keep_a = true, keep_b = true;
          if (thresh != 0u) {
            const uint32_t rT = (uint32_t)row * (uint32_t)T;
            keep_a = lowbias32((rT + (uint32_t)ca) ^ key) >= thresh;
            keep_b = lowbias32((rT + (uint32_t)cb) ^ key) >= thresh;
          }
          w[e] = keep_a ? (thresh != 0u ? p_a * inv_keep : p_a) : 0.f;
          w[2 + e] = keep_b ? (thresh != 0u ? p_b * inv_keep : p_b) : 0.f;
          pb[(ni * 4 + e) * 128 + t] = keep_a ? p_a : -p_a;
          pb[(ni * 4 + 2 + e) * 128 + t] = keep_b ? p_b : -p_b;
        }
        pack_a(pa, ni, w);
      }
      __threadfence_block();
      bar_arrive(1 + buf, CONSUMERS);  // pbuf[buf] is full
      wgmma_fence();
      tile_accumulate<DK>(acc, pa, qaddr + TB);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < DK / 64; ++c) fence_regs(acc[c]);
      release(&empty[st]);
    }
    // consume warpgroup 1's last arrival on each buffer
    for (int buf = 0; buf < min(nqt, 2); ++buf) bar_sync(3 + buf, CONSUMERS);
    store_tile<DK>(dv + base, nullptr, gm.sr, k0, T, len, acc, 1.0f, t);
  } else {  // dA^T = V dO^T; dS^T from P^T; dK += dS^T Q
    const uint32_t vaddr = smem_u32(Vs);
    for (int qt = 0; qt < nqt; ++qt) {
      const int st = qt % STAGES, buf = qt & 1;
      mbar_wait(&full[st], (qt / STAGES) & 1);
      const uint32_t qaddr = smem_u32(ring + st * 2 * TB);
      const float* sv = stat + st * STAT;
      wgmma_fence();
      tile_product<DK>(s, vaddr, qaddr + TB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      bar_sync(1 + buf, CONSUMERS);  // pbuf[buf] is full
      const float* pb = pbuf + buf * 32 * 128;
      const int q0 = qt * TILE;
      uint32_t pa[4][4];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = ni * 8 + 2 * t4 + e;
          const bool vq = q0 + qi < len;
          const float tq = sv[2 * TILE + qi];
          const float xa = pb[(ni * 4 + e) * 128 + t], xb = pb[(ni * 4 + 2 + e) * 128 + t];
          float d_a = s[ni * 4 + e], d_b = s[ni * 4 + 2 + e];
          if (thresh != 0u) {
            d_a = signbit(xa) ? 0.f : d_a * inv_keep;
            d_b = signbit(xb) ? 0.f : d_b * inv_keep;
          }
          ds[e] = (va && vq) ? fabsf(xa) * (d_a - tq) : 0.f;
          ds[2 + e] = (vb && vq) ? fabsf(xb) * (d_b - tq) : 0.f;
        }
        pack_a(pa, ni, ds);
      }
      __threadfence_block();
      bar_arrive(3 + buf, CONSUMERS);  // pbuf[buf] may be refilled
      wgmma_fence();
      tile_accumulate<DK>(acc, pa, qaddr);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < DK / 64; ++c) fence_regs(acc[c]);
      release(&empty[st]);
    }
    store_tile<DK>(dk + base, nullptr, gm.sr, k0, T, len, acc, scale, t);
  }
}

size_t dq_smem(int DK, bool ksplit) {
  const size_t qrows = ksplit ? TILE : 2 * TILE, tb = (size_t)TILE * DK * 2;
  return 1024 + 2 * qrows * DK * 2 + STAGES * 2 * tb + (2 * STAGES + 1) * 8;
}
size_t dkv_smem(int DK) {
  const size_t tb = (size_t)TILE * DK * 2;
  return 1024 + 2 * tb + STAGES * 2 * tb + 2 * 32 * 128 * 4 + STAGES * 3 * TILE * 4 +
         (2 * STAGES + 1) * 8;
}

template <int DK, bool KSPLIT>
cudaError_t launch_dq(const Maps& mp, const int* lens, const float* stats, const float* tbuf,
                      bf16* dq, int B, Geometry gm, int Tp, float scale, uint32_t seed,
                      uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const size_t smem = dq_smem(DK, KSPLIT);
  cudaError_t e = set_smem(train_bwd_dq_kernel<DK, KSPLIT>, smem);
  if (e != cudaSuccess) return e;
  const int rows = KSPLIT ? TILE : 2 * TILE;
  const size_t n = (size_t)B * gm.H * Tp;
  train_bwd_dq_kernel<DK, KSPLIT><<<dim3((gm.T + rows - 1) / rows, gm.H, B), CONSUMERS, smem,
                                    stream>>>(mp.q, mp.k, mp.v, mp.g, lens, stats, stats + n,
                                              tbuf, dq, gm, Tp, scale, seed, thresh, inv_keep);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const float* o32, const int* lens, const float* stats, float* tbuf,
                       bf16* dq, bf16* dk, bf16* dv, int B, Geometry gm, float scale,
                       uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t stream) {
  Maps mp;
  cudaError_t e;
  if ((e = make_map(&mp.q, q, B, DK, gm)) != cudaSuccess ||
      (e = make_map(&mp.k, k, B, DK, gm)) != cudaSuccess ||
      (e = make_map(&mp.v, v, B, DK, gm)) != cudaSuccess ||
      (e = make_map(&mp.g, dout, B, DK, gm)) != cudaSuccess)
    return e;
  const int Tp = (gm.T + TILE - 1) / TILE * TILE;
  const long long rows = (long long)B * gm.H * gm.T;
  train_rowdot_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(dout, o32, lens, tbuf, gm,
                                                                        B, DK, Tp);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // 128 rows of Q and dO beside the ring do not fit at d_k 256
  if constexpr (DK == 256)
    e = launch_dq<DK, true>(mp, lens, stats, tbuf, dq, B, gm, Tp, scale, seed, thresh, inv_keep,
                            stream);
  else if (use_key_split(B, gm))
    e = launch_dq<DK, true>(mp, lens, stats, tbuf, dq, B, gm, Tp, scale, seed, thresh, inv_keep,
                            stream);
  else
    e = launch_dq<DK, false>(mp, lens, stats, tbuf, dq, B, gm, Tp, scale, seed, thresh, inv_keep,
                             stream);
  if (e != cudaSuccess) return e;
  const size_t smem = dkv_smem(DK);
  if ((e = set_smem(train_bwd_dkv_kernel<DK>, smem)) != cudaSuccess) return e;
  const size_t n = (size_t)B * gm.H * Tp;
  train_bwd_dkv_kernel<DK><<<dim3((gm.T + TILE - 1) / TILE, gm.H, B), CONSUMERS, smem, stream>>>(
      mp.q, mp.k, mp.v, mp.g, lens, stats, stats + n, tbuf, dk, dv, gm, Tp, scale, seed, thresh,
      inv_keep);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// f32 instantiation: the same function on float tensors with plain
// multiply-adds (no tensor cores, no TF32), for callers that hold the kernels
// to an f32 reference. Nothing is rounded (the compute dtype is f32). Forward
// in two passes; a dQ launch that stores t = rowsum(dA * A) exactly; a dK/dV
// launch over key tiles with the transposed products, on 32 x 32 score
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
  return B > 0 && T > 0 && H > 0 && H <= 1024 && (DK == 128 || DK == 192 || DK == 256) &&
         (long long)T * T < (1ll << 32);
}

// q, k, v and every output share one layout
Geometry packed_geometry(int T, int D, int H) {
  const long long sb = (long long)T * D, sh = D / H;
  return Geometry{T, H, sb, sh, D, 1, sb, sh, D};
}

Geometry split_geometry(int H, int T, int DK) {
  const long long sb = (long long)H * T * DK, sh = (long long)T * DK;
  return Geometry{T, H, sb, sh, DK, 0, sb, sh, DK};
}

// The entries take untyped pointers and an f32 flag: bf16 tensors go to the
// tensor-core kernels, float tensors to the f32 instantiation.
int fwd_any(const void* q, const void* k, const void* v, const int* lens, void* o, float* o32,
            float* stats, int B, int DK, Geometry gm, float scale, uint32_t seed,
            uint32_t thresh, float keep_prob, int f32, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (!geometry_ok(B, gm.T, gm.H, DK)) return (int)cudaErrorInvalidValue;
  if (f32) {
    const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
    float* of = (float*)o;
    if (DK == 128)
      return (int)launch_fwd_f32<128>(qf, kf, vf, lens, of, stats, B, gm, scale, seed, thresh,
                                      keep_prob, stream);
    if (DK == 192)
      return (int)launch_fwd_f32<192>(qf, kf, vf, lens, of, stats, B, gm, scale, seed, thresh,
                                      keep_prob, stream);
    return (int)launch_fwd_f32<256>(qf, kf, vf, lens, of, stats, B, gm, scale, seed, thresh,
                                    keep_prob, stream);
  }
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v;
  bf16* ob = (bf16*)o;
  if (DK == 128)
    return (int)launch_fwd<128, FWD_TRAIN>(qb, kb, vb, lens, ob, o32, stats, B, gm, scale,
                                           seed, thresh, keep_prob, stream);
  if (DK == 192)
    return (int)launch_fwd<192, FWD_TRAIN>(qb, kb, vb, lens, ob, o32, stats, B, gm, scale,
                                           seed, thresh, keep_prob, stream);
  return (int)launch_fwd<256, FWD_TRAIN>(qb, kb, vb, lens, ob, o32, stats, B, gm, scale, seed,
                                         thresh, keep_prob, stream);
}

int bwd_any(const void* q, const void* k, const void* v, const void* dout, const float* o32,
            const int* lens, const float* stats, float* tbuf, void* dq, void* dk, void* dv, int B,
            int DK, Geometry gm, float scale, uint32_t seed, uint32_t thresh, float inv_keep,
            int f32, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (!geometry_ok(B, gm.T, gm.H, DK)) return (int)cudaErrorInvalidValue;
  if (f32) {
    const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v,
                *gf = (const float*)dout;
    float *dqf = (float*)dq, *dkf = (float*)dk, *dvf = (float*)dv;
    if (DK == 128)
      return (int)launch_bwd_f32<128>(qf, kf, vf, gf, lens, stats, tbuf, dqf, dkf, dvf, B, gm,
                                      scale, seed, thresh, inv_keep, stream);
    if (DK == 192)
      return (int)launch_bwd_f32<192>(qf, kf, vf, gf, lens, stats, tbuf, dqf, dkf, dvf, B, gm,
                                      scale, seed, thresh, inv_keep, stream);
    return (int)launch_bwd_f32<256>(qf, kf, vf, gf, lens, stats, tbuf, dqf, dkf, dvf, B, gm,
                                    scale, seed, thresh, inv_keep, stream);
  }
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v,
             *gb = (const bf16*)dout;
  bf16 *dqb = (bf16*)dq, *dkb = (bf16*)dk, *dvb = (bf16*)dv;
  if (DK == 128)
    return (int)launch_bwd<128>(qb, kb, vb, gb, o32, lens, stats, tbuf, dqb, dkb, dvb, B, gm,
                                scale, seed, thresh, inv_keep, stream);
  if (DK == 192)
    return (int)launch_bwd<192>(qb, kb, vb, gb, o32, lens, stats, tbuf, dqb, dkb, dvb, B, gm,
                                scale, seed, thresh, inv_keep, stream);
  return (int)launch_bwd<256>(qb, kb, vb, gb, o32, lens, stats, tbuf, dqb, dkb, dvb, B, gm,
                              scale, seed, thresh, inv_keep, stream);
}

}  // namespace

// Head-packed layout: q, k, v, o (B, T, D) contiguous, bf16 (f32 = 0) or
// float (f32 = 1), head h = columns [h * D/H, (h + 1) * D/H), 16-byte aligned;
// lens (B) i32. bf16: o32 (B, T, D) f32, the accumulator of o before its
// rounding; stats (2, B, H, Tp) f32 (row max in log2 units, then
// 1 / denominator), Tp = T rounded up to a multiple of 64. f32: o32 unused, stats
// (2, B, H, T) (row max, denominator). thresh = min(int(rate * 2^32),
// 2^32 - 1), 0 for no dropout; keep_prob = 1 - rate.
FS2_EXPORT int fs2_attention_train_fwd_packed(const void* q, const void* k, const void* v,
                                              const int* lens, void* o, float* o32,
                                              float* stats, int B, int T, int D, int H,
                                              float scale, uint32_t seed, uint32_t thresh,
                                              float keep_prob, int f32, void* stream) {
  if (H <= 0 || D % H != 0) return (int)cudaErrorInvalidValue;
  return fwd_any(q, k, v, lens, o, o32, stats, B, D / H, packed_geometry(T, D, H), scale, seed,
                 thresh, keep_prob, f32, stream);
}

// dout, dq, dk, dv (B, T, D) contiguous, of q's type; o32 and stats as the
// forward wrote them; tbuf (B, H, Tp) f32 scratch (bf16; (B, H, T) for f32);
// inv_keep = 1 / (1 - rate).
FS2_EXPORT int fs2_attention_train_bwd_packed(const void* q, const void* k, const void* v,
                                              const void* dout, const float* o32,
                                              const int* lens, const float* stats, float* tbuf,
                                              void* dq, void* dk, void* dv, int B, int T, int D,
                                              int H, float scale, uint32_t seed, uint32_t thresh,
                                              float inv_keep, int f32, void* stream) {
  if (H <= 0 || D % H != 0) return (int)cudaErrorInvalidValue;
  return bwd_any(q, k, v, dout, o32, lens, stats, tbuf, dq, dk, dv, B, D / H,
                 packed_geometry(T, D, H), scale, seed, thresh, inv_keep, f32, stream);
}

// Per-head layout: q, k, v, o (B, H, T, DK) contiguous; the rest as above.
FS2_EXPORT int fs2_attention_train_fwd(const void* q, const void* k, const void* v,
                                       const int* lens, void* o, float* o32, float* stats, int B,
                                       int H, int T, int DK, float scale, uint32_t seed,
                                       uint32_t thresh, float keep_prob, int f32,
                                       void* stream) {
  return fwd_any(q, k, v, lens, o, o32, stats, B, DK, split_geometry(H, T, DK), scale, seed,
                 thresh, keep_prob, f32, stream);
}

FS2_EXPORT int fs2_attention_train_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, const float* o32, const int* lens,
                                       const float* stats, float* tbuf, void* dq, void* dk,
                                       void* dv, int B, int H, int T, int DK, float scale,
                                       uint32_t seed, uint32_t thresh, float inv_keep, int f32,
                                       void* stream) {
  return bwd_any(q, k, v, dout, o32, lens, stats, tbuf, dq, dk, dv, B, DK,
                 split_geometry(H, T, DK), scale, seed, thresh, inv_keep, f32, stream);
}

