// The Hopper attention forward, one body for the serving kernels 7 and 8
// (attention.cu: fs2_attention) and the training kernels 11 and 12
// (attention_train.cu), with a compile-time mode:
//   O = round(D) V,  D = keep ? A / (1 - rate) : 0,  A = masked softmax(Q K^T * scale)
// valid where row < len[b] and col < len[b]; rows at or past the length, and
// whole query tiles past it, are exact zeros.
//  * FWD_TRAIN (kernels 11, 12): the keep mask of attention_train.cu's
//    counter hash; also stores O's f32 accumulator before its rounding (O32)
//    and the row statistics for the backward. Two ring stages, every product
//    waited for before the exponentials that follow it.
//  * FWD_SERVE (kernels 7, 8; no dropout): stores the bf16 O only, no hash.
//    Three ring stages where Q and three (K, V) stages fit in shared memory
//    (d_k 128: 128 KB, 192: 192 KB). There each warpgroup issues the next
//    key tile's S before the current tile's statistics (sweep 1: a second
//    score array, the tensor cores run under the exponentials), and the
//    next tile's S with the current tile's P V (sweep 2, back to back). At
//    d_k 256 three stages would take 256 KB: two stages and the TRAIN
//    schedule.
// The modes share every arithmetic step, so kernel 7 gives kernel 11's
// forward at rate 0 bit for bit.
//
// Design (bf16, sm_90a; primitives in hopper.cuh). A block is two
// warpgroups, which run the products as m64n64k16 wgmma; the block's thread
// 0 keeps the streamed K (and V) tiles in flight with TMA through a ring of
// shared-memory stages (full/empty mbarriers). No separate producer warp:
// with one (288 threads, or 384 with setmaxnreg 24 / 240) ptxas held every
// thread to 168 registers and the d_k 256 kernels spilled; at 256 threads
// each may use up to 255. The TPU kernels hold whole (T, T) f32 score
// matrices in VMEM; here keys stream in 64-row tiles and nothing (T, T)
// exists. A block owns 128 query rows, 64 per warpgroup, or, where
// B * H * ceil(T / 128) would leave SMs idle, 64 rows whose key tiles the two
// warpgroups split (even / odd), merging row max and denominator between the
// sweeps and O at the end. Two sweeps over the keys keep the JAX function's
// rounding point (round the weights after normalising them in f32): sweep 1,
// S = Q K^T (SS) -> row max m and denominator l; sweep 2, S again, then P =
// keep * exp(s - m) / l / (1 - rate) in f32, packed in registers into the
// bf16 A fragment, O += P V (RS, V MN-major). Exponentials are exp2 of
// log2e-scaled scores, divisions multiplies by per-row reciprocals. Each
// operand is read through one 4-D TMA map (d_k, T, H, B) whose innermost
// extent is the head dim d_k itself, with the layout's row, head and batch
// strides: heads packed along a row (head h = columns [h d_k, (h + 1) d_k)
// of a row that may be a column block of a wider buffer) or (B, H, T, d_k).
// So both layouts take the same box coordinates (column, row, head, batch),
// computed with no branch by the thread that issues the loads, and a
// 64-column box past d_k reads zeros, never the next head's columns. The
// output has strides of its own, and every store masks the columns at or
// past d_k.
//
// Head dims (`attn_plan`): any multiple of 8 from 8 to 1024, padded to DKP,
// the next multiple of 64 and at least 128 (zero columns in Q and K leave
// the scores exact, zero columns of V give zero columns of O; the scale is
// the real d_k's).
//  * DKP <= 256: the body above at DK = DKP, one accumulator of 32
//    registers a thread per 64 columns (d_k 128, 192 and 256 keep their
//    instantiations and their bits).
//  * DKP > 256 (`attn_fwd_wide_kernel`): a warpgroup would need DKP / 2
//    registers for O alone, so O is cut into column parts of PW <= 256
//    columns, a grid dimension; each part recomputes S = Q K^T in both
//    sweeps, streamed through the ring in 64-column chunks of Q and K (a
//    64 x 1024 bf16 tile is 128 KB), then P V over the part's V boxes.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 64;        // rows of a streamed tile and of a warpgroup
constexpr int CONSUMERS = 256;  // two warpgroups
constexpr float LOG2E = 1.4426950408889634f;

enum : int { FWD_TRAIN = 0, FWD_SERVE = 1 };

// Ring stages of the forward, one constant per mode and d_k (see above).
__host__ __device__ constexpr int fwd_stages(int mode, int dk) {
  return mode == FWD_SERVE && dk <= 192 ? 3 : 2;
}

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

struct Geometry {
  int T, H;
  long long sb, sh;    // batch and head stride of q/k/v, elements
  int sr;              // row stride of q/k/v, elements
  long long osb, osh;  // batch and head stride of the forward's output
  int osr;             // its row stride
  int dk;              // the head dim: columns [dk, DKP) are padding
};

// One 64 x 64 box of head h of batch row b, columns [c, c + 64) of rows [r0,
// r0 + 64), through a map of `make_map`, counted on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                        int r0, int h, int b) {
  tma_load_4d(dst, map, bar, c, r0, h, b);
}

// Rows [r0, r0 + 64) x DK columns of one (b, h) matrix into a 64-row tile
// (DK / 64 swizzled sub-tiles), counted on `bar`.
template <int DK>
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, uint64_t* bar, int r0,
                                         int h, int b) {
#pragma unroll
  for (int cb = 0; cb < DK / 64; ++cb)
    tma_box(static_cast<unsigned char*>(dst) + cb * 8192, map, bar, cb * 64, r0, h, b);
}

// S (+)= A B^T over DK: A and B both 64-row K-major tiles.
template <int DK>
__device__ __forceinline__ void tile_product(float (&s)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < DK / 16; ++ks) wgmma_ss<0>(s, kmajor_desc(a, ks), kmajor_desc(b, ks), ks);
}

// acc += P X with P the 64 x 64 register operand pa and X a 64-row tile read
// MN-major (the reduction down its rows).
template <int DK>
__device__ __forceinline__ void tile_accumulate(float (&acc)[DK / 64][32],
                                                const uint32_t (&pa)[4][4], uint32_t x) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < DK / 64; ++c) wgmma_rs<1>(acc[c], pa[kk], mnmajor_desc(x, c, kk), 1);
}

// n-tile ni of a score accumulator (rows a and a + 8, columns 2t4, 2t4 + 1)
// into the bf16 A fragment.
__device__ __forceinline__ void pack_a(uint32_t (&pa)[4][4], int ni, const float (&p)[4]) {
  pa[ni >> 1][(ni & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
  pa[ni >> 1][(ni & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
}

// The warp's arrival on a stage's empty barrier, after its reads of the stage.
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

template <int DK>
__device__ __forceinline__ void zero_acc(float (&acc)[DK / 64][32]) {
#pragma unroll
  for (int c = 0; c < DK / 64; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
}

// Key split: warpgroup 1 hands its partial accumulator to warpgroup 0 through
// shared memory (`red`, 64 x DK floats, thread-major), which adds it to its own
// (fixed order: even tiles + odd tiles). Both warpgroups call it; only
// warpgroup 0 holds the sum afterwards.
template <int DK>
__device__ __forceinline__ void merge_acc(float (&acc)[DK / 64][32], float* red, int wg, int t) {
  bar_sync(1, CONSUMERS);  // both are past their last read of the ring
  if (wg == 1) {
#pragma unroll
    for (int c = 0; c < DK / 64; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) red[(c * 32 + i) * 128 + t] = acc[c][i];
  }
  bar_sync(1, CONSUMERS);
  if (wg == 0) {
#pragma unroll
    for (int c = 0; c < DK / 64; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] += red[(c * 32 + i) * 128 + t];
  }
}

// The warpgroup's 64 x (NC * 64) accumulator, columns [col0, col0 + NC * 64)
// of one (b, h) matrix, to global memory as bf16 times mul (and as f32 into
// out32 when given), rows [r0, r0 + 64); rows >= T and columns >= dk (the
// next head's, in the packed layout) are not written, rows >= zero_from are
// written as zeros.
template <int NC>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, float* __restrict__ out32,
                                           int sr, int r0, int T, int zero_from,
                                           const float (&acc)[NC][32], float mul, int t,
                                           int col0, int dk) {
  const int lane = t & 31, ra = r0 + (t >> 5) * 16 + (lane >> 2), t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = ra + 8 * half;
    if (row >= T) continue;
    const bool live = row < zero_from;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = col0 + c * 64 + ni * 8 + 2 * t4;
        if (col >= dk) continue;
        const float x = live ? acc[c][ni * 4 + 2 * half] * mul : 0.f;
        const float y = live ? acc[c][ni * 4 + 2 * half + 1] * mul : 0.f;
        *reinterpret_cast<uint32_t*>(dst + (size_t)row * sr + col) = pack_bf16(x, y);
        if (out32 != nullptr)
          *reinterpret_cast<float2*>(out32 + (size_t)row * sr + col) = make_float2(x, y);
      }
  }
}

// Zero rows [r0, min(r0 + ROWS, T)) x columns [c0, c1) of one (b, h) matrix
// (c0 and c1 multiples of 8).
template <int ROWS>
__device__ __forceinline__ void zero_rows(bf16* __restrict__ dst, int sr, int r0, int T, int c0,
                                          int c1) {
  const int n8 = (c1 - c0) / 8;
  for (int i = threadIdx.x; i < ROWS * n8; i += blockDim.x) {
    const int r = i / n8, c = c0 + (i % n8) * 8;
    if (r0 + r < T)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * sr + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Sweep 1 on one key tile's scores (columns from k0): the valid entries of
// x = s * sl2 (log2 units), their max and sum of 2^(x - max) folded into the
// running (m, l) of the thread's rows a and b. s is only read: no plain
// instruction writes a wgmma accumulator while the next tile's is pending.
__device__ __forceinline__ void fold_stats(const float (&s)[32], int k0, int len, bool va,
                                           bool vb, int t4, float sl2, float& m_a, float& m_b,
                                           float& l_a, float& l_b) {
  float mx_a = -FLT_MAX, mx_b = -FLT_MAX;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool vc = k0 + ni * 8 + 2 * t4 + e < len;
      if (va && vc) mx_a = fmaxf(mx_a, s[ni * 4 + e] * sl2);
      if (vb && vc) mx_b = fmaxf(mx_b, s[ni * 4 + 2 + e] * sl2);
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
      if (va && vc) sa += exp2f(s[ni * 4 + e] * sl2 - mn_a);
      if (vb && vc) sb2 += exp2f(s[ni * 4 + 2 + e] * sl2 - mn_b);
    }
#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, o2);
    sb2 += __shfl_xor_sync(0xffffffffu, sb2, o2);
  }
  l_a = l_a * exp2f(m_a - mn_a) + sa;
  l_b = l_b * exp2f(m_b - mn_b) + sb2;
  m_a = mn_a;
  m_b = mn_b;
}

// Sweep 2: one weight p = 2^(s * sl2 - m) / l in f32 (then the keep mask,
// TRAIN only), zero outside the valid square (ok = row and column valid).
template <int MODE>
__device__ __forceinline__ float weight(float s, bool ok, float sl2, float m, float rden,
                                        uint32_t row_T, int c, uint32_t key, uint32_t thresh,
                                        float inv_keep) {
  float p = ok ? exp2f(s * sl2 - m) * rden : 0.f;
  if (MODE == FWD_TRAIN && thresh != 0u)
    p = lowbias32((row_T + (uint32_t)c) ^ key) >= thresh ? p * inv_keep : 0.f;
  return p;
}

// Sweep 2 on one key tile's raw scores s: the weights into p (which may be
// s itself), f32, for the thread's rows a and b.
template <int MODE>
__device__ __forceinline__ void tile_weights(float (&p)[32], const float (&s)[32], int k0,
                                             int len, bool va, bool vb, int t4, float sl2,
                                             float m_a, float m_b, float ra_den, float rb_den,
                                             uint32_t key, uint32_t rowa_T, uint32_t rowb_T,
                                             uint32_t thresh, float inv_keep) {
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = k0 + ni * 8 + 2 * t4 + e;
      const bool vc = c < len;
      p[ni * 4 + e] = weight<MODE>(s[ni * 4 + e], va && vc, sl2, m_a, ra_den, rowa_T, c, key,
                                   thresh, inv_keep);
      p[ni * 4 + 2 + e] = weight<MODE>(s[ni * 4 + 2 + e], vb && vc, sl2, m_b, rb_den, rowb_T,
                                       c, key, thresh, inv_keep);
    }
}

// A tile of weights (accumulator layout) into the bf16 A fragment of P V.
__device__ __forceinline__ void pack_weights(uint32_t (&pa)[4][4], const float (&p)[32]) {
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const float q[4] = {p[ni * 4], p[ni * 4 + 1], p[ni * 4 + 2], p[ni * 4 + 3]};
    pack_a(pa, ni, q);
  }
}

struct Maps {
  CUtensorMap q, k, v, g;  // g: dO (backward only)
};

// The forward. KSPLIT = false: 128 query rows a block, warpgroup w owns rows
// [64 w, 64 w + 64) and reads every key tile. KSPLIT = true: 64 rows, the
// warpgroups take alternate key tiles. TRAIN stores O32 (o's layout) and the
// statistics (m_out, rden_out: (B, H, Tp) f32); SERVE takes nullptr for both.
template <int DK, bool KSPLIT, int MODE>
__global__ void __launch_bounds__(CONSUMERS, 1)
attn_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const int* __restrict__ lens,
                bf16* __restrict__ o, float* __restrict__ o32, float* __restrict__ m_out,
                float* __restrict__ rden_out, Geometry gm, int Tp, float scale, uint32_t seed,
                uint32_t thresh, float inv_keep) {
  constexpr int STAGES = fwd_stages(MODE, DK);
  constexpr bool PIPE = STAGES >= 3;  // next tile's S under the current tile's work
  constexpr int QROWS = KSPLIT ? TILE : 2 * TILE;
  constexpr int TB = TILE * DK * 2;    // bytes of a 64-row tile
  constexpr int STEP = KSPLIT ? 2 : 1;  // key tiles from a warpgroup's one to its next
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* ring = Qs + QROWS * DK * 2;  // STAGES x (K tile, V tile)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * TB);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  float* xch = reinterpret_cast<float*>(qbar + 1);  // key split: [2][64 rows][m, l]

  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * QROWS;
  const int T = gm.T;
  const int len = min(lens[b], T);
  const size_t obase = (size_t)b * gm.osb + (size_t)h * gm.osh;
  if (t0 >= len) {  // dead tile: exact zeros
    zero_rows<QROWS>(o + obase, gm.osr, t0, T, 0, gm.dk);
    return;
  }
  const int nkt = (len + TILE - 1) / TILE;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], KSPLIT ? 4 : 8);  // one arrival per consuming warp
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 keeps the ring loaded. Ring item i is key tile i (sweep 1: K) or
  // i - nkt (sweep 2: K and V); it goes to stage i % STAGES once every warp
  // that reads the stage has released item i - STAGES. Items below `need` are
  // waited for; later ones, up to `upto`, are issued only while their stage
  // is already free (PIPE only; the others always wait).
  const int total = 2 * nkt;
  int issued = 0;
  auto top_up = [&](int need, int upto) {
    for (; issued < min(upto, total); ++issued) {
      const int s = issued % STAGES, pass = issued >= nkt, kt = pass ? issued - nkt : issued;
      const uint32_t parity = ((issued / STAGES) & 1) ^ 1;
      if (!PIPE || issued < need)
        mbar_wait(&empty[s], parity);
      else if (!mbar_test(&empty[s], parity))
        break;
      unsigned char* Ks = ring + s * 2 * TB;
      mbar_expect_tx(&full[s], pass ? 2 * TB : TB);
      tma_tile<DK>(Ks, &tk, &full[s], kt * TILE, h, b);
      if (pass) tma_tile<DK>(Ks + TB, &tv, &full[s], kt * TILE, h, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, QROWS * DK * 2);
#pragma unroll
    for (int g = 0; g < QROWS / TILE; ++g)
      tma_tile<DK>(Qs + g * TB, &tq, qbar, t0 + g * TILE, h, b);
    top_up(STAGES, STAGES);
  }
  __syncwarp();

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const int r0 = KSPLIT ? t0 : t0 + wg * TILE;  // this warpgroup's first row
  const int ra = r0 + (t >> 5) * 16 + g8, rb = ra + 8;
  const bool va = ra < len, vb = rb < len;
  const int first = KSPLIT ? wg : 0;  // this warpgroup's first key tile
  const uint32_t key = MODE == FWD_TRAIN ? mask_key(seed, b, h) : 0u;
  const uint32_t qaddr = smem_u32(Qs + (KSPLIT ? 0 : wg * TB));
  const float sl2 = scale * LOG2E;  // scores in log2 units
  mbar_wait(qbar, 0);

  // PIPE: S of ring item `item` into d, issued and committed, not waited for
  auto issue_scores = [&](float (&d)[32], int item) {
    if (threadIdx.x == 0) top_up(item + 1, total);
    __syncwarp();
    const int st = item % STAGES;
    mbar_wait(&full[st], (item / STAGES) & 1);
    wgmma_fence();
    tile_product<DK>(d, qaddr, smem_u32(ring + st * 2 * TB));
    wgmma_commit();
  };
  // ptxas serializes every wgmma of a kernel (C7514, C7515) where a plain
  // instruction reads or writes accumulator registers it cannot prove
  // retired. PIPE therefore keeps no product in flight across a loop's back
  // edge, sets the zero accumulator before the first product, and reads a
  // score tile only after a wait for every product.

  // sweep 1: row max m and denominator l = sum 2^(x - m), x = s * scale * log2e
  float m_a = -FLT_MAX, m_b = -FLT_MAX, l_a = 0.f, l_b = 0.f;
  float s[32];
  int it = 0;
  if constexpr (PIPE) {
    // per tile: issue the next tile's S, then this tile's statistics under it
    float s2[32];
    auto tile1 = [&](float (&cur)[32], float (&nxt)[32], int kt) {
      if (kt + STEP < nkt) issue_scores(nxt, kt + STEP);
      release(&empty[kt % STAGES]);
      fold_stats(cur, kt * TILE, len, va, vb, t4, sl2, m_a, m_b, l_a, l_b);
      if (threadIdx.x == 0) top_up(0, total);
      __syncwarp();
      wgmma_wait<0>();
      fence_regs(nxt);
    };
    if (first < nkt) {
      issue_scores(s, first);
      wgmma_wait<0>();
      fence_regs(s);
    }
    // the unrolled pair (s, s2) / (s2, s) keeps both arrays in registers
    for (int kt = first; kt < nkt; kt += 2 * STEP) {
      tile1(s, s2, kt);
      if (kt + STEP < nkt) tile1(s2, s, kt + STEP);
    }
    // thread 0 waits only for the items its own warpgroup reads next: the
    // other warpgroup's last tile of the sweep may still be due
    if (threadIdx.x == 0) top_up(nkt, total);
    __syncwarp();
  } else {
    for (int kt = 0; kt < nkt; ++kt, ++it) {
      if (KSPLIT && (kt & 1) != wg) continue;
      if (threadIdx.x == 0) top_up(it + STAGES, it + STAGES);
      __syncwarp();
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      wgmma_fence();
      tile_product<DK>(s, qaddr, smem_u32(ring + st * 2 * TB));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      release(&empty[st]);
      fold_stats(s, kt * TILE, len, va, vb, t4, sl2, m_a, m_b, l_a, l_b);
    }
  }
  if (KSPLIT) {  // merge the two halves of the keys, in the same order in both
    const int ia = (t >> 5) * 16 + g8;
    if (t4 == 0) {
      xch[(wg * 64 + ia) * 2] = m_a;
      xch[(wg * 64 + ia) * 2 + 1] = l_a;
      xch[(wg * 64 + ia + 8) * 2] = m_b;
      xch[(wg * 64 + ia + 8) * 2 + 1] = l_b;
    }
    bar_sync(1, CONSUMERS);
    const float m0a = xch[ia * 2], l0a = xch[ia * 2 + 1];
    const float m1a = xch[(64 + ia) * 2], l1a = xch[(64 + ia) * 2 + 1];
    const float m0b = xch[(ia + 8) * 2], l0b = xch[(ia + 8) * 2 + 1];
    const float m1b = xch[(64 + ia + 8) * 2], l1b = xch[(64 + ia + 8) * 2 + 1];
    m_a = fmaxf(m0a, m1a);
    m_b = fmaxf(m0b, m1b);
    l_a = l0a * exp2f(m0a - m_a) + l1a * exp2f(m1a - m_a);
    l_b = l0b * exp2f(m0b - m_b) + l1b * exp2f(m1b - m_b);
  }
  // 1 / max(l, tiny): saved as it is used, so the backward multiplies by it
  const float ra_den = 1.0f / fmaxf(l_a, FLT_MIN), rb_den = 1.0f / fmaxf(l_b, FLT_MIN);
  if constexpr (MODE == FWD_TRAIN) {
    if (t4 == 0 && (!KSPLIT || wg == 0)) {
      const size_t srow = ((size_t)b * gm.H + h) * Tp;
      if (ra < T) {
        m_out[srow + ra] = m_a;
        rden_out[srow + ra] = ra_den;
      }
      if (rb < T) {
        m_out[srow + rb] = m_b;
        rden_out[srow + rb] = rb_den;
      }
    }
  }

  // sweep 2: O = round(D) V, D = keep ? p / (1 - rate) : 0, p normalised in f32
  const uint32_t rowa_T = (uint32_t)ra * (uint32_t)T, rowb_T = (uint32_t)rb * (uint32_t)T;
  float acc[DK / 64][32];
  zero_acc<DK>(acc);
  uint32_t pa[4][4];
  if constexpr (PIPE) {
    // the zeros are set before the first S is in flight
#pragma unroll
    for (int c = 0; c < DK / 64; ++c) fence_regs(acc[c]);
    // per tile: pa holds its weights; the next tile's S and this tile's P V
    // run back to back, then the next weights. (Forming them under P V,
    // after a wait<1> that retires S, made ptxas serialize every wgmma:
    // C7514, 0.073 against 0.066 ms at the decoder rung.)
    if (first < nkt) {
      issue_scores(s, nkt + first);
      wgmma_wait<0>();
      fence_regs(s);
      tile_weights<MODE>(s, s, first * TILE, len, va, vb, t4, sl2, m_a, m_b, ra_den, rb_den,
                         key, rowa_T, rowb_T, thresh, inv_keep);
      pack_weights(pa, s);
    }
    for (int kt = first; kt < nkt; kt += STEP) {
      const bool more = kt + STEP < nkt;
      if (more) issue_scores(s, nkt + kt + STEP);
      wgmma_fence();
      tile_accumulate<DK>(acc, pa, smem_u32(ring + ((nkt + kt) % STAGES) * 2 * TB) + TB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int c = 0; c < DK / 64; ++c) fence_regs(acc[c]);
      release(&empty[(nkt + kt) % STAGES]);
      if (more) {
        tile_weights<MODE>(s, s, (kt + STEP) * TILE, len, va, vb, t4, sl2, m_a, m_b, ra_den,
                           rb_den, key, rowa_T, rowb_T, thresh, inv_keep);
        pack_weights(pa, s);
      }
      if (threadIdx.x == 0) top_up(0, total);
      __syncwarp();
    }
    if (threadIdx.x == 0) top_up(total, total);  // as after sweep 1
    __syncwarp();
  } else {
    for (int kt = 0; kt < nkt; ++kt, ++it) {
      if (KSPLIT && (kt & 1) != wg) continue;
      if (threadIdx.x == 0) top_up(it + STAGES, it + STAGES);
      __syncwarp();
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      const uint32_t kaddr = smem_u32(ring + st * 2 * TB);
      wgmma_fence();
      tile_product<DK>(s, qaddr, kaddr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      float p[32];
      tile_weights<MODE>(p, s, kt * TILE, len, va, vb, t4, sl2, m_a, m_b, ra_den, rb_den, key,
                         rowa_T, rowb_T, thresh, inv_keep);
      pack_weights(pa, p);
      wgmma_fence();
      tile_accumulate<DK>(acc, pa, kaddr + TB);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < DK / 64; ++c) fence_regs(acc[c]);
      release(&empty[st]);
    }
  }
  if (KSPLIT) {
    merge_acc<DK>(acc, reinterpret_cast<float*>(ring), wg, t);
    if (wg == 1) return;
  }
  store_tile<DK / 64>(o + obase, MODE == FWD_TRAIN ? o32 + obase : nullptr, gm.osr, r0, T, len,
                      acc, 1.0f, t, 0, gm.dk);
}

// ---- d_k past 256: column parts ---------------------------------------------

// Ring of the wide bodies: slots of up to six 64 x 64 boxes (8 KB each).
constexpr int BOX = TILE * 64 * 2;
constexpr int WF_STAGES = 8;  // forward: slots of 3 boxes (Q, Q, K) or 1 (V)

// S (+)= A B^T over one 64-column chunk: A and B 64 x 64 K-major boxes;
// scale_d 0 (the chunk's first k-step of the first chunk) overwrites s.
__device__ __forceinline__ void chunk_product(float (&s)[32], uint32_t a, uint32_t b, int first) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_ss<0>(s, kmajor_desc(a, ks), kmajor_desc(b, ks), first && ks == 0 ? 0 : 1);
}

// acc += P X with P the register operand pa and X one 64 x 64 box read
// MN-major.
__device__ __forceinline__ void box_accumulate(float (&acc)[32], const uint32_t (&pa)[4][4],
                                               uint32_t x) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(acc, pa[kk], mnmajor_desc(x, 0, kk), 1);
}

// A consumer's walk over a ring whose every item every warp reads (and
// releases): item i in slot i % STAGES; thread 0 keeps it topped up
// `top_up(upto)` items ahead.
template <int STAGES, int SLOT>
struct RingWalk {
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int it;
  // the next item's slot (shared address), once it has landed
  template <class TopUp>
  __device__ __forceinline__ uint32_t next(TopUp& top_up) {
    if (threadIdx.x == 0) top_up(it + STAGES);
    __syncwarp();
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    return smem_u32(ring + (it % STAGES) * SLOT);
  }
  __device__ __forceinline__ void done() {
    release(&empty[it % STAGES]);
    ++it;
  }
};

// The forward at d_k > 256. A block owns 128 query rows (64 a warpgroup, as
// the row split above) and the column part [c0, c0 + PW) of O; the grid's y
// is (head, part). Nothing stays resident: ring item i is, per key tile, a
// score chunk (rows of Q for each warpgroup and of K, 64 columns) for each
// of the DKP / 64 chunks, in sweep 2 followed by the PW / 64 boxes of V's
// part. Each item is waited for and retired before the next: no product
// stays in flight across a runtime loop, and no runtime guard sits around a
// product. Rows >= T of Q and K and columns >= d_k read as zeros.
template <int PW, int MODE>
__global__ void __launch_bounds__(CONSUMERS, 1)
attn_fwd_wide_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const int* __restrict__ lens,
                     bf16* __restrict__ o, float* __restrict__ o32, float* __restrict__ m_out,
                     float* __restrict__ rden_out, Geometry gm, int Tp, int parts, float scale,
                     uint32_t seed, uint32_t thresh, float inv_keep) {
  constexpr int NJ = PW / 64, SLOT = 3 * BOX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WF_STAGES * SLOT);
  uint64_t* empty = full + WF_STAGES;

  const int b = blockIdx.z, h = blockIdx.y / parts, part = blockIdx.y % parts;
  const int t0 = blockIdx.x * 2 * TILE, c0 = part * PW, T = gm.T, dk = gm.dk;
  const int len = min(lens[b], T);
  const size_t obase = (size_t)b * gm.osb + (size_t)h * gm.osh;
  if (t0 >= len) {  // dead tile: exact zeros
    zero_rows<2 * TILE>(o + obase, gm.osr, t0, T, c0, min(c0 + PW, dk));
    return;
  }
  const int nkt = (len + TILE - 1) / TILE, nch = (dk + 63) / 64;
  const int n1 = nkt * nch, per2 = nch + NJ, total = n1 + nkt * per2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WF_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  int issued = 0;  // thread 0 keeps the ring loaded
  auto top_up = [&](int upto) {
    for (; issued < min(upto, total); ++issued) {
      const int s = issued % WF_STAGES;
      mbar_wait(&empty[s], ((issued / WF_STAGES) & 1) ^ 1);
      unsigned char* dst = ring + s * SLOT;
      int i = issued, kt, c;
      if (i < n1) {
        kt = i / nch, c = i % nch;
      } else {
        i -= n1;
        kt = i / per2, c = i % per2;
      }
      if (c >= nch) {  // a box of V's part
        mbar_expect_tx(&full[s], BOX);
        tma_box(dst, &tv, &full[s], c0 + (c - nch) * 64, kt * TILE, h, b);
      } else {  // a score chunk
        mbar_expect_tx(&full[s], 3 * BOX);
        tma_box(dst, &tq, &full[s], c * 64, t0, h, b);
        tma_box(dst + BOX, &tq, &full[s], c * 64, t0 + TILE, h, b);
        tma_box(dst + 2 * BOX, &tk, &full[s], c * 64, kt * TILE, h, b);
      }
    }
  };
  if (threadIdx.x == 0) top_up(WF_STAGES);
  __syncwarp();

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const int r0 = t0 + wg * TILE;
  const int ra = r0 + (t >> 5) * 16 + g8, rb = ra + 8;
  const bool va = ra < len, vb = rb < len;
  const uint32_t key = MODE == FWD_TRAIN ? mask_key(seed, b, h) : 0u;
  const float sl2 = scale * LOG2E;
  RingWalk<WF_STAGES, SLOT> rw{ring, full, empty, 0};
  float s[32];
  auto scores = [&]() {  // S = Q K^T of the next key tile, chunk by chunk
    for (int c = 0; c < nch; ++c) {
      const uint32_t a = rw.next(top_up);
      wgmma_fence();
      chunk_product(s, a + wg * BOX, a + 2 * BOX, c == 0);
      wgmma_commit();
      wgmma_wait<0>();
      rw.done();
    }
    fence_regs(s);
  };

  // sweep 1: row max m and denominator l
  float m_a = -FLT_MAX, m_b = -FLT_MAX, l_a = 0.f, l_b = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    scores();
    fold_stats(s, kt * TILE, len, va, vb, t4, sl2, m_a, m_b, l_a, l_b);
  }
  const float ra_den = 1.0f / fmaxf(l_a, FLT_MIN), rb_den = 1.0f / fmaxf(l_b, FLT_MIN);
  if constexpr (MODE == FWD_TRAIN) {
    if (t4 == 0 && part == 0) {  // one writer of the statistics
      const size_t srow = ((size_t)b * gm.H + h) * Tp;
      if (ra < T) {
        m_out[srow + ra] = m_a;
        rden_out[srow + ra] = ra_den;
      }
      if (rb < T) {
        m_out[srow + rb] = m_b;
        rden_out[srow + rb] = rb_den;
      }
    }
  }

  // sweep 2: the part's columns of O = round(D) V
  const uint32_t rowa_T = (uint32_t)ra * (uint32_t)T, rowb_T = (uint32_t)rb * (uint32_t)T;
  float acc[NJ][32];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  uint32_t pa[4][4];
  for (int kt = 0; kt < nkt; ++kt) {
    scores();
    float p[32];
    tile_weights<MODE>(p, s, kt * TILE, len, va, vb, t4, sl2, m_a, m_b, ra_den, rb_den, key,
                       rowa_T, rowb_T, thresh, inv_keep);
    pack_weights(pa, p);
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
  store_tile<NJ>(o + obase, MODE == FWD_TRAIN ? o32 + obase : nullptr, gm.osr, r0, T, len, acc,
                 1.0f, t, c0, dk);
}

// ---- host ---------------------------------------------------------------------

// The tiling of a head dim, one rule for every attention kernel (mirrored by
// ops/kernels/attention_train.py:plan): d_k a multiple of 8 in 8..1024,
// padded to dkp (a multiple of 64, at least 128: no model routes a narrower
// head, and zero columns keep the result exact). dkp <= 256: the tile bodies
// at DK = dkp, one part. Above: the wide bodies, `parts` column parts of pw columns
// (pw = 192 or 256: no warpgroup holds more than 256 accumulator columns).
struct AttnPlan {
  int dkp, wide, pw, parts;
};

bool attn_plan(int dk, AttnPlan* p) {
  if (dk < 8 || dk > 1024 || dk % 8 != 0) return false;
  p->dkp = max(128, (dk + 63) / 64 * 64);
  p->wide = p->dkp > 256;
  p->parts = p->wide ? (p->dkp + 255) / 256 : 1;
  p->pw = 64 * ((p->dkp / 64 + p->parts - 1) / p->parts);
  return true;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, c = 132;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
      n = c;
    else
      return 132;
  }
  return n;
}

// The row split (128 query rows a block) unless it leaves SMs idle.
bool use_key_split(int B, const Geometry& gm) {
  return (long long)B * gm.H * ((gm.T + 2 * TILE - 1) / (2 * TILE)) < sm_count();
}

// One TMA map of an operand, d_k columns wide (see the head of this file):
// (d_k, T, H, B) with the layout's row, head and batch strides, in 64 x 64
// boxes; both layouts take the same coordinates.
cudaError_t make_map(CUtensorMap* map, const void* p, int B, const Geometry& gm) {
  return tma_map_bf16_4d(map, p, {(uint64_t)gm.dk, (uint64_t)gm.T, (uint64_t)gm.H, (uint64_t)B},
                         {(uint64_t)gm.sr, (uint64_t)gm.sh, (uint64_t)gm.sb}, {64, 64, 1, 1});
}

size_t fwd_smem(int DK, bool ksplit, int mode) {
  const size_t qrows = ksplit ? TILE : 2 * TILE, tb = (size_t)TILE * DK * 2;
  const size_t stages = fwd_stages(mode, DK);
  return 1024 + qrows * DK * 2 + stages * 2 * tb + (2 * stages + 1) * 8 + 2 * 64 * 2 * 4;
}

size_t fwd_wide_smem() { return 1024 + (size_t)WF_STAGES * 3 * BOX + 2 * WF_STAGES * 8; }

template <int DK, bool KSPLIT, int MODE>
cudaError_t launch_fwd_split(const Maps& mp, const int* lens, bf16* o, float* o32, float* stats,
                             int B, Geometry gm, int Tp, float scale, uint32_t seed,
                             uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const size_t smem = fwd_smem(DK, KSPLIT, MODE);
  cudaError_t e = set_smem(attn_fwd_kernel<DK, KSPLIT, MODE>, smem);
  if (e != cudaSuccess) return e;
  const int rows = KSPLIT ? TILE : 2 * TILE;
  float* rden = stats != nullptr ? stats + (size_t)B * gm.H * Tp : nullptr;
  attn_fwd_kernel<DK, KSPLIT, MODE><<<dim3((gm.T + rows - 1) / rows, gm.H, B), CONSUMERS, smem,
                                      stream>>>(mp.q, mp.k, mp.v, lens, o, o32, stats, rden, gm,
                                                Tp, scale, seed, thresh, inv_keep);
  return cudaGetLastError();
}

template <int PW, int MODE>
cudaError_t launch_fwd_wide(const Maps& mp, const int* lens, bf16* o, float* o32, float* stats,
                            int B, Geometry gm, int Tp, int parts, float scale, uint32_t seed,
                            uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const size_t smem = fwd_wide_smem();
  cudaError_t e = set_smem(attn_fwd_wide_kernel<PW, MODE>, smem);
  if (e != cudaSuccess) return e;
  float* rden = stats != nullptr ? stats + (size_t)B * gm.H * Tp : nullptr;
  attn_fwd_wide_kernel<PW, MODE><<<dim3((gm.T + 2 * TILE - 1) / (2 * TILE), gm.H * parts, B),
                                   CONSUMERS, smem, stream>>>(mp.q, mp.k, mp.v, lens, o, o32,
                                                              stats, rden, gm, Tp, parts, scale,
                                                              seed, thresh, inv_keep);
  return cudaGetLastError();
}

template <int DK, int MODE>
cudaError_t launch_fwd_tile(const Maps& mp, const int* lens, bf16* o, float* o32, float* stats,
                            int B, Geometry gm, int Tp, float scale, uint32_t seed,
                            uint32_t thresh, float inv_keep, cudaStream_t stream) {
  if (use_key_split(B, gm))
    return launch_fwd_split<DK, true, MODE>(mp, lens, o, o32, stats, B, gm, Tp, scale, seed,
                                            thresh, inv_keep, stream);
  return launch_fwd_split<DK, false, MODE>(mp, lens, o, o32, stats, B, gm, Tp, scale, seed,
                                           thresh, inv_keep, stream);
}

// The forward of either mode at any planned d_k (gm.dk): three tensor maps
// encoded per call, then the body and grid split for the shape. TRAIN: o32
// and stats as attention_train.cu's entries describe them; SERVE: both
// nullptr, thresh 0, keep_prob 1.
template <int MODE>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, const int* lens, bf16* o,
                       float* o32, float* stats, int B, Geometry gm, float scale, uint32_t seed,
                       uint32_t thresh, float keep_prob, cudaStream_t stream) {
  AttnPlan pl;
  if (!attn_plan(gm.dk, &pl)) return cudaErrorInvalidValue;
  Maps mp;
  cudaError_t e;
  if ((e = make_map(&mp.q, q, B, gm)) != cudaSuccess ||
      (e = make_map(&mp.k, k, B, gm)) != cudaSuccess ||
      (e = make_map(&mp.v, v, B, gm)) != cudaSuccess)
    return e;
  const int Tp = (gm.T + TILE - 1) / TILE * TILE;
  const float inv_keep = 1.0f / keep_prob;
  if (pl.wide) {
    if (pl.pw == 192)
      return launch_fwd_wide<192, MODE>(mp, lens, o, o32, stats, B, gm, Tp, pl.parts, scale,
                                        seed, thresh, inv_keep, stream);
    return launch_fwd_wide<256, MODE>(mp, lens, o, o32, stats, B, gm, Tp, pl.parts, scale, seed,
                                      thresh, inv_keep, stream);
  }
  switch (pl.dkp) {
    case 128:
      return launch_fwd_tile<128, MODE>(mp, lens, o, o32, stats, B, gm, Tp, scale, seed, thresh,
                                        inv_keep, stream);
    case 192:
      return launch_fwd_tile<192, MODE>(mp, lens, o, o32, stats, B, gm, Tp, scale, seed, thresh,
                                        inv_keep, stream);
    default:
      return launch_fwd_tile<256, MODE>(mp, lens, o, o32, stats, B, gm, Tp, scale, seed, thresh,
                                        inv_keep, stream);
  }
}

}  // namespace
