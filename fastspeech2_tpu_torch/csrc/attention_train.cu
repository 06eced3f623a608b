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
// serves both layouts: each operand is read through one 4-D TMA map (d_k, T,
// H, B) whose innermost extent is d_k (attention_fwd.cuh: make_map), so
// neither makes a copy and a padded head never reads the next head's
// columns. Any d_k that
// is a multiple of 8 from 8 to 1024 (attention_fwd.cuh: attn_plan): the
// tile bodies below at DKP = d_k rounded up to 64, at least 128 (<= 256),
// the wide bodies
// (column parts, the reductions over d_k streamed) above.
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
//  * d_k > 256: dQ and dK/dV as above in column parts of <= 256 columns
//    (a grid dimension), each part recomputing S and dA over 64-column
//    chunks streamed with every operand through one ring (no tile resident):
//    `train_bwd_dq_wide_kernel`, `train_bwd_dkv_wide_kernel`.
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
    zero_rows<QROWS>(dq + base, gm.sr, t0, T, 0, gm.dk);
    return;
  }
  const int nkt = (len + TILE - 1) / TILE;
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
      tma_tile<DK>(Ks, &tk, &full[s], issued * TILE, h, b);
      tma_tile<DK>(Ks + TB, &tv, &full[s], issued * TILE, h, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, 2 * QROWS * DK * 2);
#pragma unroll
    for (int g = 0; g < QROWS / TILE; ++g) {
      tma_tile<DK>(Qs + g * TB, &tq, qbar, t0 + g * TILE, h, b);
      tma_tile<DK>(Gs + g * TB, &tg, qbar, t0 + g * TILE, h, b);
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
  store_tile<DK / 64>(dq + base, nullptr, gm.sr, r0, T, len, acc, scale, t, 0, gm.dk);
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
    zero_rows<TILE>(dk + base, gm.sr, k0, T, 0, gm.dk);
    zero_rows<TILE>(dv + base, gm.sr, k0, T, 0, gm.dk);
    return;
  }
  const int nqt = (len + TILE - 1) / TILE;
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
      tma_tile<DK>(Qt, &tq, &full[s], q0, h, b);
      tma_tile<DK>(Qt + TB, &tg, &full[s], q0, h, b);
      bulk_load(sv, m_in + srow + q0, TILE * 4, &full[s]);
      bulk_load(sv + TILE, rden_in + srow + q0, TILE * 4, &full[s]);
      bulk_load(sv + 2 * TILE, t_in + srow + q0, TILE * 4, &full[s]);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kvbar, 2 * TB);
    tma_tile<DK>(Ks, &tk, kvbar, k0, h, b);
    tma_tile<DK>(Vs, &tv, kvbar, k0, h, b);
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
    store_tile<DK / 64>(dv + base, nullptr, gm.sr, k0, T, len, acc, 1.0f, t, 0, gm.dk);
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
    store_tile<DK / 64>(dk + base, nullptr, gm.sr, k0, T, len, acc, scale, t, 0, gm.dk);
  }
}

// ---- d_k past 256: the backward in column parts ---------------------------
// As attn_fwd_wide_kernel: a part of PW <= 256 columns of each output a
// block (the grid's y is (head, part)), the reductions over d_k streamed in
// 64-column chunks through a ring, every item waited for and retired before
// the next. Each part recomputes the scores and dA.
constexpr int WQ_STAGES = 4;  // dQ: slots of 6 boxes (Q, Q, dO, dO, K, V) or 1 (K's part)
constexpr int WKV_STAGES = 5;  // dK/dV: slots of 4 boxes (K, Q, V, dO) or 2 (dO, Q parts)

// dQ of 128 query rows (64 a warpgroup) x the part [c0, c0 + PW): per key
// tile, S = Q K^T and dA = dO V^T chunk by chunk, dS in registers, then dQ +=
// dS K over K's part.
template <int PW>
__global__ void __launch_bounds__(CONSUMERS, 1)
train_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tg, const int* __restrict__ lens,
                         const float* __restrict__ m_in, const float* __restrict__ rden_in,
                         const float* __restrict__ t_in, bf16* __restrict__ dq, Geometry gm,
                         int Tp, int parts, float scale, uint32_t seed, uint32_t thresh,
                         float inv_keep) {
  constexpr int NJ = PW / 64, SLOT = 6 * BOX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WQ_STAGES * SLOT);
  uint64_t* empty = full + WQ_STAGES;

  const int b = blockIdx.z, h = blockIdx.y / parts, part = blockIdx.y % parts;
  const int t0 = blockIdx.x * 2 * TILE, c0 = part * PW, T = gm.T, dkh = gm.dk;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  if (t0 >= len) {
    zero_rows<2 * TILE>(dq + base, gm.sr, t0, T, c0, min(c0 + PW, dkh));
    return;
  }
  const int nkt = (len + TILE - 1) / TILE, nch = (dkh + 63) / 64, per = nch + NJ;
  const int total = nkt * per;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  int issued = 0;
  auto top_up = [&](int upto) {
    for (; issued < min(upto, total); ++issued) {
      const int s = issued % WQ_STAGES, kt = issued / per, c = issued % per;
      mbar_wait(&empty[s], ((issued / WQ_STAGES) & 1) ^ 1);
      unsigned char* dst = ring + s * SLOT;
      if (c >= nch) {
        mbar_expect_tx(&full[s], BOX);
        tma_box(dst, &tk, &full[s], c0 + (c - nch) * 64, kt * TILE, h, b);
      } else {
        mbar_expect_tx(&full[s], 6 * BOX);
        tma_box(dst, &tq, &full[s], c * 64, t0, h, b);
        tma_box(dst + BOX, &tq, &full[s], c * 64, t0 + TILE, h, b);
        tma_box(dst + 2 * BOX, &tg, &full[s], c * 64, t0, h, b);
        tma_box(dst + 3 * BOX, &tg, &full[s], c * 64, t0 + TILE, h, b);
        tma_box(dst + 4 * BOX, &tk, &full[s], c * 64, kt * TILE, h, b);
        tma_box(dst + 5 * BOX, &tv, &full[s], c * 64, kt * TILE, h, b);
      }
    }
  };
  if (threadIdx.x == 0) top_up(WQ_STAGES);
  __syncwarp();

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const int r0 = t0 + wg * TILE;
  const int ra = r0 + (t >> 5) * 16 + g8, rb = ra + 8;
  const bool va = ra < len, vb = rb < len;
  const uint32_t key = mask_key(seed, b, h);
  const size_t srow = ((size_t)b * gm.H + h) * Tp;
  const float m_a = va ? m_in[srow + ra] : 0.f, m_b = vb ? m_in[srow + rb] : 0.f;
  const float ra_den = va ? rden_in[srow + ra] : 0.f, rb_den = vb ? rden_in[srow + rb] : 0.f;
  const float t_a = va ? t_in[srow + ra] : 0.f, t_b = vb ? t_in[srow + rb] : 0.f;
  const uint32_t rowa_T = (uint32_t)ra * (uint32_t)T, rowb_T = (uint32_t)rb * (uint32_t)T;
  const float sl2 = scale * LOG2E;
  RingWalk<WQ_STAGES, SLOT> rw{ring, full, empty, 0};

  float acc[NJ][32];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  float s[32], da[32];
  for (int kt = 0; kt < nkt; ++kt) {
    for (int c = 0; c < nch; ++c) {
      const uint32_t a = rw.next(top_up);
      wgmma_fence();
      chunk_product(s, a + wg * BOX, a + 4 * BOX, c == 0);
      chunk_product(da, a + (2 + wg) * BOX, a + 5 * BOX, c == 0);
      wgmma_commit();
      wgmma_wait<0>();
      rw.done();
    }
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
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint32_t a = rw.next(top_up);
      wgmma_fence();
      box_accumulate(acc[j], pa, a);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[j]);
      rw.done();
    }
  }
  store_tile<NJ>(dq + base, nullptr, gm.sr, r0, T, len, acc, scale, t, c0, dkh);
}

// dK and dV of 64 keys x the part [c0, c0 + PW) (warpgroup 0 dV, warpgroup 1
// dK, as train_bwd_dkv_kernel): per query tile, S^T = K Q^T (warpgroup 0) and
// dA^T = V dO^T (warpgroup 1) chunk by chunk, P^T handed over in shared
// memory, then dV += D^T dO and dK += dS^T Q over dO's and Q's parts. The
// rows' m, 1 / den and t are read from global memory.
template <int PW>
__global__ void __launch_bounds__(CONSUMERS, 1)
train_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg, const int* __restrict__ lens,
                          const float* __restrict__ m_in, const float* __restrict__ rden_in,
                          const float* __restrict__ t_in, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, Geometry gm, int Tp, int parts, float scale,
                          uint32_t seed, uint32_t thresh, float inv_keep) {
  constexpr int NJ = PW / 64, SLOT = 4 * BOX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  float* pbuf = reinterpret_cast<float*>(ring + WKV_STAGES * SLOT);  // [2][32][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(pbuf + 2 * 32 * 128);
  uint64_t* empty = full + WKV_STAGES;

  const int b = blockIdx.z, h = blockIdx.y / parts, part = blockIdx.y % parts;
  const int k0 = blockIdx.x * TILE, c0 = part * PW, T = gm.T, dkh = gm.dk;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  if (k0 >= len) {
    zero_rows<TILE>(dk + base, gm.sr, k0, T, c0, min(c0 + PW, dkh));
    zero_rows<TILE>(dv + base, gm.sr, k0, T, c0, min(c0 + PW, dkh));
    return;
  }
  const int nqt = (len + TILE - 1) / TILE, nch = (dkh + 63) / 64, per = nch + NJ;
  const int total = nqt * per;
  const size_t srow = ((size_t)b * gm.H + h) * Tp;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WKV_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  int issued = 0;
  auto top_up = [&](int upto) {
    for (; issued < min(upto, total); ++issued) {
      const int s = issued % WKV_STAGES, qt = issued / per, c = issued % per;
      mbar_wait(&empty[s], ((issued / WKV_STAGES) & 1) ^ 1);
      unsigned char* dst = ring + s * SLOT;
      if (c >= nch) {  // dO's and Q's boxes of the part
        const int col = c0 + (c - nch) * 64;
        mbar_expect_tx(&full[s], 2 * BOX);
        tma_box(dst, &tg, &full[s], col, qt * TILE, h, b);
        tma_box(dst + BOX, &tq, &full[s], col, qt * TILE, h, b);
      } else {
        mbar_expect_tx(&full[s], 4 * BOX);
        tma_box(dst, &tk, &full[s], c * 64, k0, h, b);
        tma_box(dst + BOX, &tq, &full[s], c * 64, qt * TILE, h, b);
        tma_box(dst + 2 * BOX, &tv, &full[s], c * 64, k0, h, b);
        tma_box(dst + 3 * BOX, &tg, &full[s], c * 64, qt * TILE, h, b);
      }
    }
  };
  if (threadIdx.x == 0) top_up(WKV_STAGES);
  __syncwarp();

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const int ca = k0 + (t >> 5) * 16 + g8, cb = ca + 8;  // this thread's keys
  const bool va = ca < len, vb = cb < len;
  const float sl2 = scale * LOG2E;
  RingWalk<WKV_STAGES, SLOT> rw{ring, full, empty, 0};
  float acc[NJ][32];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  float s[32];
  for (int qt = 0; qt < nqt; ++qt) {
    // warpgroup 0: S^T = K Q^T; warpgroup 1: dA^T = V dO^T
    for (int c = 0; c < nch; ++c) {
      const uint32_t a = rw.next(top_up);
      wgmma_fence();
      chunk_product(s, a + 2 * wg * BOX, a + (2 * wg + 1) * BOX, c == 0);
      wgmma_commit();
      wgmma_wait<0>();
      rw.done();
    }
    fence_regs(s);
    const int buf = qt & 1, q0 = qt * TILE;
    float* pb = pbuf + buf * 32 * 128;
    uint32_t pa[4][4];
    if (wg == 0) {  // P^T, D^T; P^T (sign bit = dropped) to warpgroup 1
      const uint32_t key = mask_key(seed, b, h);
      if (qt >= 2) bar_sync(3 + buf, CONSUMERS);  // warpgroup 1 has read pbuf[buf]
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        float w[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = ni * 8 + 2 * t4 + e, row = q0 + qi;
          const bool vq = row < len;
          const float m = m_in[srow + row], rden = rden_in[srow + row];
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
    } else {  // dS^T = P^T (dA^T - t) from warpgroup 0's P^T
      bar_sync(1 + buf, CONSUMERS);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = ni * 8 + 2 * t4 + e;
          const bool vq = q0 + qi < len;
          const float tq = t_in[srow + q0 + qi];
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
    }
    // dV += D^T dO (warpgroup 0), dK += dS^T Q (warpgroup 1), box by box
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint32_t a = rw.next(top_up);
      wgmma_fence();
      box_accumulate(acc[j], pa, a + wg * BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[j]);
      rw.done();
    }
  }
  if (wg == 0) {
    // consume warpgroup 1's last arrival on each buffer
    for (int buf = 0; buf < min(nqt, 2); ++buf) bar_sync(3 + buf, CONSUMERS);
    store_tile<NJ>(dv + base, nullptr, gm.sr, k0, T, len, acc, 1.0f, t, c0, dkh);
  } else {
    store_tile<NJ>(dk + base, nullptr, gm.sr, k0, T, len, acc, scale, t, c0, dkh);
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
size_t dq_wide_smem() { return 1024 + (size_t)WQ_STAGES * 6 * BOX + 2 * WQ_STAGES * 8; }
size_t dkv_wide_smem() {
  return 1024 + (size_t)WKV_STAGES * 4 * BOX + 2 * 32 * 128 * 4 + 2 * WKV_STAGES * 8;
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

// dQ and dK/dV of the tile bodies at DK = dkp
template <int DK>
cudaError_t launch_bwd_tile(const Maps& mp, const int* lens, const float* stats,
                            const float* tbuf, bf16* dq, bf16* dk, bf16* dv, int B, Geometry gm,
                            int Tp, float scale, uint32_t seed, uint32_t thresh, float inv_keep,
                            cudaStream_t stream) {
  cudaError_t e;
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

template <int PW>
cudaError_t launch_bwd_wide(const Maps& mp, const int* lens, const float* stats,
                            const float* tbuf, bf16* dq, bf16* dk, bf16* dv, int B, Geometry gm,
                            int Tp, int parts, float scale, uint32_t seed, uint32_t thresh,
                            float inv_keep, cudaStream_t stream) {
  const size_t n = (size_t)B * gm.H * Tp, sq = dq_wide_smem(), skv = dkv_wide_smem();
  cudaError_t e;
  if ((e = set_smem(train_bwd_dq_wide_kernel<PW>, sq)) != cudaSuccess ||
      (e = set_smem(train_bwd_dkv_wide_kernel<PW>, skv)) != cudaSuccess)
    return e;
  train_bwd_dq_wide_kernel<PW><<<dim3((gm.T + 2 * TILE - 1) / (2 * TILE), gm.H * parts, B),
                                 CONSUMERS, sq, stream>>>(mp.q, mp.k, mp.v, mp.g, lens, stats,
                                                          stats + n, tbuf, dq, gm, Tp, parts,
                                                          scale, seed, thresh, inv_keep);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  train_bwd_dkv_wide_kernel<PW><<<dim3((gm.T + TILE - 1) / TILE, gm.H * parts, B), CONSUMERS,
                                  skv, stream>>>(mp.q, mp.k, mp.v, mp.g, lens, stats, stats + n,
                                                 tbuf, dk, dv, gm, Tp, parts, scale, seed, thresh,
                                                 inv_keep);
  return cudaGetLastError();
}

// The backward at any planned d_k: the row sums, then dQ and dK/dV.
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const float* o32, const int* lens, const float* stats, float* tbuf,
                       bf16* dq, bf16* dk, bf16* dv, int B, Geometry gm, float scale,
                       uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t stream) {
  AttnPlan pl;
  if (!attn_plan(gm.dk, &pl)) return cudaErrorInvalidValue;
  Maps mp;
  cudaError_t e;
  if ((e = make_map(&mp.q, q, B, gm)) != cudaSuccess ||
      (e = make_map(&mp.k, k, B, gm)) != cudaSuccess ||
      (e = make_map(&mp.v, v, B, gm)) != cudaSuccess ||
      (e = make_map(&mp.g, dout, B, gm)) != cudaSuccess)
    return e;
  const int Tp = (gm.T + TILE - 1) / TILE * TILE;
  const long long rows = (long long)B * gm.H * gm.T;
  train_rowdot_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(dout, o32, lens, tbuf, gm,
                                                                        B, gm.dk, Tp);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (pl.wide) {
    if (pl.pw == 192)
      return launch_bwd_wide<192>(mp, lens, stats, tbuf, dq, dk, dv, B, gm, Tp, pl.parts, scale,
                                  seed, thresh, inv_keep, stream);
    return launch_bwd_wide<256>(mp, lens, stats, tbuf, dq, dk, dv, B, gm, Tp, pl.parts, scale,
                                seed, thresh, inv_keep, stream);
  }
  switch (pl.dkp) {
    case 128:
      return launch_bwd_tile<128>(mp, lens, stats, tbuf, dq, dk, dv, B, gm, Tp, scale, seed,
                                  thresh, inv_keep, stream);
    case 192:
      return launch_bwd_tile<192>(mp, lens, stats, tbuf, dq, dk, dv, B, gm, Tp, scale, seed,
                                  thresh, inv_keep, stream);
    default:
      return launch_bwd_tile<256>(mp, lens, stats, tbuf, dq, dk, dv, B, gm, Tp, scale, seed,
                                  thresh, inv_keep, stream);
  }
}

// ---------------------------------------------------------------------------
// f32 instantiation: the same function on float tensors with plain
// multiply-adds (no tensor cores, no TF32), for callers that hold the kernels
// to an f32 reference. Nothing is rounded (the compute dtype is f32). Forward
// in two passes; a dQ launch that stores t = rowsum(dA * A) exactly; a dK/dV
// launch over key tiles with the transposed products, on 32 x 32 score
// tiles held in shared memory; 256 threads, thread (i = tid / 8, g = tid % 8)
// owns 4 scores of row i and the output columns g, g + 8, ... of row i.
// dkp <= 256 (attn_plan): the tile kernels at DK = dkp, the block's own rows
// resident and each score computed once; columns [d_k, DK) read as zeros and
// are not stored. dkp > 256: the wide kernels, the grid's y (head, part), a
// part 64 output columns, the scores' reduction over d_k in 64-column chunks
// in d order (the same sums as one pass over d_k), each part recomputing it.
constexpr int FT = 32;        // rows per block and per streamed tile
constexpr int FS = FT + 1;    // score tile row stride
constexpr int FC = 64;        // columns of a chunk and of a wide part
constexpr int FL = FC + 1;    // chunk row stride

// Rows [r0, r0 + FT) of one (b, h) matrix into dst (FT x DK + 1), zeros at
// rows >= limit and columns >= dk.
template <int DK>
__device__ __forceinline__ void f32_load_rows(float* dst, const float* __restrict__ src,
                                              int sr, int r0, int limit, int dk) {
  constexpr int ld = DK + 1;
  for (int i = threadIdx.x; i < FT * DK; i += blockDim.x) {
    const int r = i / DK, c = i % DK;
    dst[r * ld + c] = r0 + r < limit && c < dk ? src[(size_t)(r0 + r) * sr + c] : 0.f;
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

// acc[c] += sum_k W[i][k] * X[k][g + 8 c] for this thread's row i; X's row
// stride ld (DK + 1 for a tile, FL for a chunk).
template <int NC, int ld>
__device__ __forceinline__ void f32_tile_acc(float (&acc)[NC], const float* W, const float* X) {
  const int i = threadIdx.x >> 3, g = threadIdx.x & 7;
  for (int k = 0; k < FT; ++k) {
    const float w = W[i * FS + k];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] += w * X[k * ld + g + 8 * c];
  }
}

// This thread's row of the columns [c0, c0 + 8 NC), those below dk.
template <int NC>
__device__ __forceinline__ void f32_store_rows(float* __restrict__ dst, int sr, int r0, int T,
                                               const float (&acc)[NC], float mul, int c0,
                                               int dk) {
  const int i = threadIdx.x >> 3, g = threadIdx.x & 7;
  if (r0 + i < T)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c0 + g + 8 * c < dk) dst[(size_t)(r0 + i) * sr + c0 + g + 8 * c] = acc[c] * mul;
}

// Rows [r0, r0 + FT) x columns [c0, c0 + W) below (T, dk) to zero.
template <int W>
__device__ __forceinline__ void f32_zero_rows(float* __restrict__ dst, int sr, int r0, int T,
                                              int c0, int dk) {
  for (int i = threadIdx.x; i < FT * W; i += blockDim.x) {
    const int r = r0 + i / W, c = c0 + i % W;
    if (r < T && c < dk) dst[(size_t)r * sr + c] = 0.f;
  }
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
  const int T = gm.T, dk = gm.dk;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  const size_t srow = ((size_t)b * gm.H + h) * T;
  if (t0 >= len) {
    f32_zero_rows<DK>(o + base, gm.sr, t0, T, 0, dk);
    return;
  }
  const int nkt = (len + FT - 1) / FT;
  const uint32_t key = mask_key(seed, b, h);
  const int tid = threadIdx.x;
  f32_load_rows<DK>(Qs, q + base, gm.sr, t0, len, dk);
  if (tid < FT) {
    ms[tid] = -FLT_MAX;
    ls[tid] = 0.f;
  }
  for (int kt = 0; kt < nkt; ++kt) {  // pass 1: row max and denominator
    const int k0 = kt * FT;
    __syncthreads();
    f32_load_rows<DK>(Ks, k + base, gm.sr, k0, len, dk);
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
    f32_load_rows<DK>(Ks, k + base, gm.sr, k0, len, dk);
    f32_load_rows<DK>(Vs, v + base, gm.sr, k0, len, dk);
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
    f32_tile_acc<DK / 8, ld>(acc, Ss, Vs);
  }
  f32_store_rows<DK / 8>(o + base, gm.sr, t0, T, acc, 1.0f, 0, dk);
}

// DK 256 fits one block an SM (shared memory), so it may take more than the
// 64 registers ptxas holds the narrower ones to (it spilled at 64)
template <int DK>
__global__ void __launch_bounds__(256, DK == 256 ? 1 : 4)
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
  const int T = gm.T, dk = gm.dk;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  const size_t srow = ((size_t)b * gm.H + h) * T;
  if (t0 >= len) {
    f32_zero_rows<DK>(dq + base, gm.sr, t0, T, 0, dk);
    return;
  }
  const int nkt = (len + FT - 1) / FT;
  const uint32_t key = mask_key(seed, b, h);
  const int tid = threadIdx.x, i = tid >> 3, j0 = (tid & 7) * 4;
  const int row = t0 + i;
  const bool vr = row < len;
  const float m = vr ? m_in[srow + row] : 0.f, den = vr ? den_in[srow + row] : 1.f;
  f32_load_rows<DK>(Qs, q + base, gm.sr, t0, len, dk);
  f32_load_rows<DK>(Gs, dout + base, gm.sr, t0, len, dk);
  if (tid < FT) ts[tid] = 0.f;
  float acc[DK / 8];
#pragma unroll
  for (int c = 0; c < DK / 8; ++c) acc[c] = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    const float t = pass == 1 ? ts[i] : 0.f;  // pass 1 reads it after the barrier below
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * FT;
      __syncthreads();
      f32_load_rows<DK>(Ks, k + base, gm.sr, k0, len, dk);
      f32_load_rows<DK>(Vs, v + base, gm.sr, k0, len, dk);
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
        f32_tile_acc<DK / 8, ld>(acc, Ss, Ks);
      }
    }
    __syncthreads();
    if (pass == 0 && tid < FT && t0 + tid < T) t_out[srow + t0 + tid] = ts[tid];
  }
  f32_store_rows<DK / 8>(dq + base, gm.sr, t0, T, acc, scale, 0, dk);
}

// DK 256 fits one block an SM (shared memory), so it may take more than the
// 64 registers ptxas holds the narrower ones to (it spilled at 64)
template <int DK>
__global__ void __launch_bounds__(256, DK == 256 ? 1 : 4)
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
  const int T = gm.T, dkh = gm.dk;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  const size_t srow = ((size_t)b * gm.H + h) * T;
  float* outp = (want_dk ? dk : dv) + base;
  if (k0 >= len) {
    f32_zero_rows<DK>(outp, gm.sr, k0, T, 0, dkh);
    return;
  }
  const int nqt = (len + FT - 1) / FT;
  const uint32_t key = mask_key(seed, b, h);
  const int tid = threadIdx.x, i = tid >> 3, j0 = (tid & 7) * 4;
  const int col = k0 + i;  // this thread's key
  const bool vk = col < len;
  f32_load_rows<DK>(Ks, k + base, gm.sr, k0, len, dkh);
  if (want_dk) f32_load_rows<DK>(Vs, v + base, gm.sr, k0, len, dkh);
  float acc[DK / 8];
#pragma unroll
  for (int c = 0; c < DK / 8; ++c) acc[c] = 0.f;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * FT;
    __syncthreads();
    f32_load_rows<DK>(Qs, q + base, gm.sr, q0, len, dkh);
    f32_load_rows<DK>(Gs, dout + base, gm.sr, q0, len, dkh);
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
    f32_tile_acc<DK / 8, ld>(acc, Ss, want_dk ? Qs : Gs);
  }
  f32_store_rows<DK / 8>(outp, gm.sr, k0, T, acc, want_dk ? scale : 1.0f, 0, dkh);
}

// The wide kernels (dkp > 256): a block's rows and a 64-column part.

// Rows [r0, r0 + FT) x columns [c0, c0 + FC) of one (b, h) matrix into dst
// (FT x FL), zeros at rows >= limit and columns >= dk.
__device__ __forceinline__ void f32_load_chunk(float* dst, const float* __restrict__ src, int sr,
                                               int r0, int limit, int c0, int dk) {
  for (int i = threadIdx.x; i < FT * FC; i += blockDim.x) {
    const int r = i / FC, c = i % FC;
    dst[r * FL + c] = r0 + r < limit && c0 + c < dk ? src[(size_t)(r0 + r) * sr + c0 + c] : 0.f;
  }
}

// acc[jj] += sum over the chunk of A[i][d] * B[j0 + jj][d], this thread's
// 4 entries of the 32 x 32 tile.
__device__ __forceinline__ void f32_chunk_dot(float (&acc)[4], const float* A, const float* B) {
  const int i = threadIdx.x >> 3, j0 = (threadIdx.x & 7) * 4;
  for (int d = 0; d < FC; ++d) {
    const float a = A[i * FL + d];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[jj] += a * B[(j0 + jj) * FL + d];
  }
}

// The tile products of rows [a0, a0 + FT) of a (and b) against rows [x0, x0
// + FT) of x (and y) over all d_k, chunk by chunk, into S (and D), FT x FS
// ([row of a][row of x]); rows past `len` read as zeros. b = nullptr: S only.
__device__ __forceinline__ void f32_scores(float* S, float* D, float* ca, float* cx, float* cb,
                                           float* cy, const float* __restrict__ a,
                                           const float* __restrict__ x,
                                           const float* __restrict__ b,
                                           const float* __restrict__ y, int sr, int a0, int x0,
                                           int len, int dk) {
  float s4[4] = {0.f, 0.f, 0.f, 0.f}, d4[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < dk; c0 += FC) {
    __syncthreads();
    f32_load_chunk(ca, a, sr, a0, len, c0, dk);
    f32_load_chunk(cx, x, sr, x0, len, c0, dk);
    if (b != nullptr) {
      f32_load_chunk(cb, b, sr, a0, len, c0, dk);
      f32_load_chunk(cy, y, sr, x0, len, c0, dk);
    }
    __syncthreads();
    f32_chunk_dot(s4, ca, cx);
    if (b != nullptr) f32_chunk_dot(d4, cb, cy);
  }
  const int i = threadIdx.x >> 3, j0 = (threadIdx.x & 7) * 4;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    S[i * FS + j0 + jj] = s4[jj];
    if (b != nullptr) D[i * FS + j0 + jj] = d4[jj];
  }
}

__global__ void __launch_bounds__(256)
train_fwd_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ lens,
                     float* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ den_out, Geometry gm, int parts, float scale,
                     uint32_t seed, uint32_t thresh, float keep_prob) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qc = reinterpret_cast<float*>(smem);
  float* Kc = Qc + FT * FL;
  float* Ss = Kc + FT * FL;  // [FT][FS]; V's part reuses Kc
  float* ms = Ss + FT * FS;  // row max, then denominator
  float* ls = ms + FT;
  const int b = blockIdx.z, h = blockIdx.y / parts, c0 = (blockIdx.y % parts) * FC;
  const int t0 = blockIdx.x * FT, T = gm.T, dk = gm.dk;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  const size_t srow = ((size_t)b * gm.H + h) * T;
  if (t0 >= len) {
    f32_zero_rows<FC>(o + base, gm.sr, t0, T, c0, dk);
    return;
  }
  const int nkt = (len + FT - 1) / FT;
  const uint32_t key = mask_key(seed, b, h);
  const int tid = threadIdx.x;
  if (tid < FT) {
    ms[tid] = -FLT_MAX;
    ls[tid] = 0.f;
  }
  for (int kt = 0; kt < nkt; ++kt) {  // pass 1: row max and denominator
    const int k0 = kt * FT;
    f32_scores(Ss, nullptr, Qc, Kc, nullptr, nullptr, q + base, k + base, nullptr, nullptr,
               gm.sr, t0, k0, len, dk);
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
    if (t0 + tid < T && c0 == 0) {  // one writer of the statistics
      m_out[srow + t0 + tid] = ms[tid];
      den_out[srow + t0 + tid] = ls[tid];
    }
  }
  float acc[FC / 8];
#pragma unroll
  for (int c = 0; c < FC / 8; ++c) acc[c] = 0.f;
  const int i = tid >> 3, j0 = (tid & 7) * 4;
  for (int kt = 0; kt < nkt; ++kt) {  // pass 2: O = D V
    const int k0 = kt * FT;
    f32_scores(Ss, nullptr, Qc, Kc, nullptr, nullptr, q + base, k + base, nullptr, nullptr,
               gm.sr, t0, k0, len, dk);
    // each thread rewrites only its own 4 scores
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int row = t0 + i, col = k0 + j0 + jj;
      float p = (row < len && col < len)
                    ? expf(Ss[i * FS + j0 + jj] * scale - ms[i]) / ls[i] : 0.f;
      if (thresh != 0u) p = keep_at(key, thresh, row, col, T) ? p / keep_prob : 0.f;
      Ss[i * FS + j0 + jj] = p;
    }
    __syncthreads();
    f32_load_chunk(Kc, v + base, gm.sr, k0, len, c0, dk);
    __syncthreads();
    f32_tile_acc<FC / 8, FL>(acc, Ss, Kc);
  }
  f32_store_rows<FC / 8>(o + base, gm.sr, t0, T, acc, 1.0f, c0, dk);
}

__global__ void __launch_bounds__(256)
train_bwd_dq_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const int* __restrict__ lens, const float* __restrict__ m_in,
                        const float* __restrict__ den_in, float* __restrict__ t_out,
                        float* __restrict__ dq, Geometry gm, int parts, float scale,
                        uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qc = reinterpret_cast<float*>(smem);
  float* Kc = Qc + FT * FL;
  float* Gc = Kc + FT * FL;
  float* Vc = Gc + FT * FL;
  float* Ss = Vc + FT * FL;
  float* Ds = Ss + FT * FS;
  float* ts = Ds + FT * FS;  // [FT]
  const int b = blockIdx.z, h = blockIdx.y / parts, c0 = (blockIdx.y % parts) * FC;
  const int t0 = blockIdx.x * FT, T = gm.T, dk = gm.dk;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  const size_t srow = ((size_t)b * gm.H + h) * T;
  if (t0 >= len) {
    f32_zero_rows<FC>(dq + base, gm.sr, t0, T, c0, dk);
    return;
  }
  const int nkt = (len + FT - 1) / FT;
  const uint32_t key = mask_key(seed, b, h);
  const int tid = threadIdx.x, i = tid >> 3, j0 = (tid & 7) * 4;
  const int row = t0 + i;
  const bool vr = row < len;
  const float m = vr ? m_in[srow + row] : 0.f, den = vr ? den_in[srow + row] : 1.f;
  if (tid < FT) ts[tid] = 0.f;
  float acc[FC / 8];
#pragma unroll
  for (int c = 0; c < FC / 8; ++c) acc[c] = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
    const float t = pass == 1 ? ts[i] : 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * FT;
      f32_scores(Ss, Ds, Qc, Kc, Gc, Vc, q + base, k + base, dout + base, v + base, gm.sr, t0,
                 k0, len, dk);
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
        f32_load_chunk(Kc, k + base, gm.sr, k0, len, c0, dk);
        __syncthreads();
        f32_tile_acc<FC / 8, FL>(acc, Ss, Kc);
      }
    }
    __syncthreads();
    if (pass == 0 && c0 == 0 && tid < FT && t0 + tid < T) t_out[srow + t0 + tid] = ts[tid];
  }
  f32_store_rows<FC / 8>(dq + base, gm.sr, t0, T, acc, scale, c0, dk);
}

__global__ void __launch_bounds__(256)
train_bwd_dkv_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const int* __restrict__ lens, const float* __restrict__ m_in,
                         const float* __restrict__ den_in, const float* __restrict__ t_in,
                         float* __restrict__ dk, float* __restrict__ dv, Geometry gm, int parts,
                         float scale, uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Kc = reinterpret_cast<float*>(smem);
  float* Qc = Kc + FT * FL;
  float* Vc = Qc + FT * FL;
  float* Gc = Vc + FT * FL;
  float* Ss = Gc + FT * FL;  // S^T: [key][query]
  float* Ds = Ss + FT * FS;  // dA^T
  float* stat = Ds + FT * FS;  // m, den, t: [3][FT]
  const bool want_dk = (blockIdx.x & 1) != 0;
  const int b = blockIdx.z, h = blockIdx.y / parts, c0 = (blockIdx.y % parts) * FC;
  const int k0 = (blockIdx.x >> 1) * FT, T = gm.T, dkh = gm.dk;
  const int len = min(lens[b], T);
  const size_t base = (size_t)b * gm.sb + (size_t)h * gm.sh;
  const size_t srow = ((size_t)b * gm.H + h) * T;
  float* outp = (want_dk ? dk : dv) + base;
  if (k0 >= len) {
    f32_zero_rows<FC>(outp, gm.sr, k0, T, c0, dkh);
    return;
  }
  const int nqt = (len + FT - 1) / FT;
  const uint32_t key = mask_key(seed, b, h);
  const int tid = threadIdx.x, i = tid >> 3, j0 = (tid & 7) * 4;
  const int col = k0 + i;  // this thread's key
  const bool vk = col < len;
  float acc[FC / 8];
#pragma unroll
  for (int c = 0; c < FC / 8; ++c) acc[c] = 0.f;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * FT;
    f32_scores(Ss, Ds, Kc, Qc, want_dk ? Vc : nullptr, Gc, k + base, q + base,
               want_dk ? v + base : nullptr, dout + base, gm.sr, k0, q0, len, dkh);
    if (tid < FT) {
      const int r = q0 + tid;
      const bool ok = r < len;
      stat[tid] = ok ? m_in[srow + r] : 0.f;
      stat[FT + tid] = ok ? den_in[srow + r] : 1.f;
      stat[2 * FT + tid] = ok ? t_in[srow + r] : 0.f;
    }
    __syncthreads();
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
    f32_load_chunk(Qc, (want_dk ? q : dout) + base, gm.sr, q0, len, c0, dkh);
    __syncthreads();
    f32_tile_acc<FC / 8, FL>(acc, Ss, Qc);
  }
  f32_store_rows<FC / 8>(outp, gm.sr, k0, T, acc, want_dk ? scale : 1.0f, c0, dkh);
}

// Shared memory of the f32 kernels at dkp (attn_plan): the tile kernels at
// DK = dkp up to 256 (the dK/dV launch's, the larger of the backward's two),
// the wide kernels above.
size_t f32_fwd_smem(int dkp) {
  if (dkp > 256) return ((size_t)2 * FT * FL + FT * FS + 2 * FT) * sizeof(float);
  return ((size_t)3 * FT * (dkp + 1) + FT * FS + 2 * FT) * sizeof(float);
}

size_t f32_bwd_smem(int dkp) {
  if (dkp > 256) return ((size_t)4 * FT * FL + 2 * FT * FS + 3 * FT) * sizeof(float);
  return ((size_t)4 * FT * (dkp + 1) + 2 * FT * FS + 3 * FT) * sizeof(float);
}

template <int DK>
cudaError_t launch_fwd_f32_tile(const float* q, const float* k, const float* v, const int* lens,
                                float* o, float* stats, int B, Geometry gm, float scale,
                                uint32_t seed, uint32_t thresh, float keep_prob,
                                cudaStream_t stream) {
  const size_t smem = f32_fwd_smem(DK), n = (size_t)B * gm.H * gm.T;
  cudaError_t e = set_smem(train_fwd_f32_kernel<DK>, smem);
  if (e != cudaSuccess) return e;
  train_fwd_f32_kernel<DK><<<dim3((gm.T + FT - 1) / FT, gm.H, B), 256, smem, stream>>>(
      q, k, v, lens, o, stats, stats + n, gm, scale, seed, thresh, keep_prob);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_bwd_f32_tile(const float* q, const float* k, const float* v,
                                const float* dout, const int* lens, const float* stats,
                                float* tbuf, float* dq, float* dk, float* dv, int B, Geometry gm,
                                float scale, uint32_t seed, uint32_t thresh, float inv_keep,
                                cudaStream_t stream) {
  const size_t smem2 = f32_bwd_smem(DK), smem1 = smem2 - 2 * FT * sizeof(float);
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
      q, k, v, dout, lens, stats, stats + n, tbuf, dk, dv, gm, scale, seed, thresh, inv_keep);
  return cudaGetLastError();
}

cudaError_t launch_fwd_f32(const float* q, const float* k, const float* v, const int* lens,
                           float* o, float* stats, int B, Geometry gm, float scale,
                           uint32_t seed, uint32_t thresh, float keep_prob,
                           cudaStream_t stream) {
  AttnPlan pl;
  if (!attn_plan(gm.dk, &pl)) return cudaErrorInvalidValue;
  if (pl.dkp == 128)
    return launch_fwd_f32_tile<128>(q, k, v, lens, o, stats, B, gm, scale, seed, thresh,
                                    keep_prob, stream);
  if (pl.dkp == 192)
    return launch_fwd_f32_tile<192>(q, k, v, lens, o, stats, B, gm, scale, seed, thresh,
                                    keep_prob, stream);
  if (pl.dkp == 256)
    return launch_fwd_f32_tile<256>(q, k, v, lens, o, stats, B, gm, scale, seed, thresh,
                                    keep_prob, stream);
  const size_t smem = f32_fwd_smem(pl.dkp), n = (size_t)B * gm.H * gm.T;
  const int parts = (gm.dk + FC - 1) / FC;
  train_fwd_f32_wide_kernel<<<dim3((gm.T + FT - 1) / FT, gm.H * parts, B), 256, smem, stream>>>(
      q, k, v, lens, o, stats, stats + n, gm, parts, scale, seed, thresh, keep_prob);
  return cudaGetLastError();
}

cudaError_t launch_bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                           const int* lens, const float* stats, float* tbuf, float* dq,
                           float* dk, float* dv, int B, Geometry gm, float scale,
                           uint32_t seed, uint32_t thresh, float inv_keep,
                           cudaStream_t stream) {
  AttnPlan pl;
  if (!attn_plan(gm.dk, &pl)) return cudaErrorInvalidValue;
  if (pl.dkp == 128)
    return launch_bwd_f32_tile<128>(q, k, v, dout, lens, stats, tbuf, dq, dk, dv, B, gm, scale,
                                    seed, thresh, inv_keep, stream);
  if (pl.dkp == 192)
    return launch_bwd_f32_tile<192>(q, k, v, dout, lens, stats, tbuf, dq, dk, dv, B, gm, scale,
                                    seed, thresh, inv_keep, stream);
  if (pl.dkp == 256)
    return launch_bwd_f32_tile<256>(q, k, v, dout, lens, stats, tbuf, dq, dk, dv, B, gm, scale,
                                    seed, thresh, inv_keep, stream);
  const size_t smem = f32_bwd_smem(pl.dkp), n = (size_t)B * gm.H * gm.T;
  const int nt = (gm.T + FT - 1) / FT, parts = (gm.dk + FC - 1) / FC;
  train_bwd_dq_f32_wide_kernel<<<dim3(nt, gm.H * parts, B), 256, smem, stream>>>(
      q, k, v, dout, lens, stats, stats + n, tbuf, dq, gm, parts, scale, seed, thresh, inv_keep);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  train_bwd_dkv_f32_wide_kernel<<<dim3(2 * nt, gm.H * parts, B), 256, smem, stream>>>(
      q, k, v, dout, lens, stats, stats + n, tbuf, dk, dv, gm, parts, scale, seed, thresh,
      inv_keep);
  return cudaGetLastError();
}

bool geometry_ok(int B, int T, int H, int DK) {
  AttnPlan pl;
  return B > 0 && T > 0 && H > 0 && H <= 1024 && attn_plan(DK, &pl) &&
         (long long)T * T < (1ll << 32);
}

// q, k, v and every output share one layout
Geometry packed_geometry(int T, int D, int H) {
  const long long sb = (long long)T * D, sh = D / H;
  return Geometry{T, H, sb, sh, D, sb, sh, D, D / H};
}

Geometry split_geometry(int H, int T, int DK) {
  const long long sb = (long long)H * T * DK, sh = (long long)T * DK;
  return Geometry{T, H, sb, sh, DK, sb, sh, DK, DK};
}

// The entries take untyped pointers and an f32 flag: bf16 tensors go to the
// tensor-core kernels, float tensors to the f32 instantiation.
int fwd_any(const void* q, const void* k, const void* v, const int* lens, void* o, float* o32,
            float* stats, int B, Geometry gm, float scale, uint32_t seed, uint32_t thresh,
            float keep_prob, int f32, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (!geometry_ok(B, gm.T, gm.H, gm.dk)) return (int)cudaErrorInvalidValue;
  if (f32)
    return (int)launch_fwd_f32((const float*)q, (const float*)k, (const float*)v, lens,
                               (float*)o, stats, B, gm, scale, seed, thresh, keep_prob, stream);
  return (int)launch_fwd<FWD_TRAIN>((const bf16*)q, (const bf16*)k, (const bf16*)v, lens,
                                    (bf16*)o, o32, stats, B, gm, scale, seed, thresh, keep_prob,
                                    stream);
}

int bwd_any(const void* q, const void* k, const void* v, const void* dout, const float* o32,
            const int* lens, const float* stats, float* tbuf, void* dq, void* dk, void* dv, int B,
            Geometry gm, float scale, uint32_t seed, uint32_t thresh, float inv_keep, int f32,
            void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (!geometry_ok(B, gm.T, gm.H, gm.dk)) return (int)cudaErrorInvalidValue;
  if (f32)
    return (int)launch_bwd_f32((const float*)q, (const float*)k, (const float*)v,
                               (const float*)dout, lens, stats, tbuf, (float*)dq, (float*)dk,
                               (float*)dv, B, gm, scale, seed, thresh, inv_keep, stream);
  return (int)launch_bwd((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, o32,
                         lens, stats, tbuf, (bf16*)dq, (bf16*)dk, (bf16*)dv, B, gm, scale, seed,
                         thresh, inv_keep, stream);
}

}  // namespace

// The tiling of head dim dk (ops/kernels/attention_train.py:plan holds the
// same rule): out[0..3] = dkp, wide, pw, parts; out[4..] the shared-memory
// bytes of the kernels that serve it: the forward (row split, key split; the
// wide body: both the same) in the SERVE and the TRAIN mode, dQ (row split,
// key split), dK/dV, the f32 forward and backward. cudaErrorInvalidValue
// for a head dim the kernels refuse.
FS2_EXPORT int fs2_attention_plan(int dk, int* out) {
  AttnPlan pl;
  if (!attn_plan(dk, &pl)) return (int)cudaErrorInvalidValue;
  out[0] = pl.dkp;
  out[1] = pl.wide;
  out[2] = pl.pw;
  out[3] = pl.parts;
  const int D = pl.dkp;
  out[4] = (int)(pl.wide ? fwd_wide_smem() : fwd_smem(D, false, FWD_SERVE));
  out[5] = (int)(pl.wide ? fwd_wide_smem() : fwd_smem(D, true, FWD_SERVE));
  out[6] = (int)(pl.wide ? fwd_wide_smem() : fwd_smem(D, false, FWD_TRAIN));
  out[7] = (int)(pl.wide ? fwd_wide_smem() : fwd_smem(D, true, FWD_TRAIN));
  out[8] = (int)(pl.wide ? dq_wide_smem() : D == 256 ? 0 : dq_smem(D, false));
  out[9] = (int)(pl.wide ? dq_wide_smem() : dq_smem(D, true));
  out[10] = (int)(pl.wide ? dkv_wide_smem() : dkv_smem(D));
  out[11] = (int)f32_fwd_smem(D);
  out[12] = (int)f32_bwd_smem(D);
  return 0;
}

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
  return fwd_any(q, k, v, lens, o, o32, stats, B, packed_geometry(T, D, H), scale, seed, thresh,
                 keep_prob, f32, stream);
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
  return bwd_any(q, k, v, dout, o32, lens, stats, tbuf, dq, dk, dv, B, packed_geometry(T, D, H),
                 scale, seed, thresh, inv_keep, f32, stream);
}

// Per-head layout: q, k, v, o (B, H, T, DK) contiguous; the rest as above.
FS2_EXPORT int fs2_attention_train_fwd(const void* q, const void* k, const void* v,
                                       const int* lens, void* o, float* o32, float* stats, int B,
                                       int H, int T, int DK, float scale, uint32_t seed,
                                       uint32_t thresh, float keep_prob, int f32,
                                       void* stream) {
  return fwd_any(q, k, v, lens, o, o32, stats, B, split_geometry(H, T, DK), scale, seed, thresh,
                 keep_prob, f32, stream);
}

FS2_EXPORT int fs2_attention_train_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, const float* o32, const int* lens,
                                       const float* stats, float* tbuf, void* dq, void* dk,
                                       void* dv, int B, int H, int T, int DK, float scale,
                                       uint32_t seed, uint32_t thresh, float inv_keep, int f32,
                                       void* stream) {
  return bwd_any(q, k, v, dout, o32, lens, stats, tbuf, dq, dk, dv, B, split_geometry(H, T, DK),
                 scale, seed, thresh, inv_keep, f32, stream);
}

