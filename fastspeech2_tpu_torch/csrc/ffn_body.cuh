// The conv-FFN body on the H100, two wgmma launches fed by TMA rings:
//   launch 1  the k-tap conv of the masked rows into a bf16 hidden
//             h = relu(round(round(conv_k(x)) + b1))
//   launch 2  y = round(h W2) + b2 and the entry's epilogue (+ x, LayerNorm)
// shared by csrc/ffn.cu (kernels 2, 9 and 10: FFN(z) = Conv1d_k1(ReLU(
// Conv1d_k(z))), SAME zero padding) and csrc/attention.cu (kernels 1, 5 and
// 6: launch 1 at k = 1 without the ReLU is the q|k|v projection, launch 2
// with the head outputs as h and Wo as W2 the out projection, residual and
// LayerNorm).
//
// Design (sm_90a, primitives in hopper.cuh). The warp-MMA body this
// replaces lost on four counts: m16n8k16 warp MMAs, not wgmma; every w1 slice
// read from L2 once per 64 rows; the post-LN rows written to global memory
// and read back for the LayerNorm; each dead tile recomputing the bias-only
// row. Here two launches of two warpgroups (256 threads), both products as
// wgmma, every weight tile streamed through a TMA ring of full/empty
// mbarriers that thread 0 keeps topped up:
//  1. ffn_conv_kernel: hidden = relu(round(round(conv_k(x)) + b1)) in bf16.
//     A block covers P rows x NH hidden columns (P = 128, NH = 256 where
//     shared memory allows, else P = 64, NH = 128; `make_plan` below). Its
//     rows plus a halo of (k-1)/2 each side sit in shared memory once,
//     masked (zero outside [0, len)), LayerNormed first for the pre-LN entry
//     (f32, one warp a row), rounded to bf16 and kept column-chunk-major,
//     [Dp/8][rows][8] (Dp = D rounded up to 32, zero columns past D): tap
//     j's A operand is the same tile at a base shifted by
//     j rows (a descriptor without swizzle takes any row shift), so the k-tap
//     conv is one K = k*Dp product with no im2col copy. w1 (H, k*Dp), laid
//     out (out, tap, in) with zero columns past D in each tap and H a
//     multiple of 32 (zero rows past the model's width: ops/kernels/ffn.py
//     pads it once, when it packs the weights), is K-major as it is and
//     streams in NH x 64 tiles (128-byte swizzle), each serving all P rows.
//     Where the whole x tile leaves no room for two ring stages at either
//     tiling (D past 1,344 at k = 9, past 1,472 at k = 1), the tile holds
//     XC columns at a time (`make_plan`: 512, or less where the halo rows
//     need it) at P = 128, NH = 256: the product runs chunk by chunk, each
//     chunk's k taps over its columns, the accumulators carried across the
//     chunks (every chunk's tiles retired before the next chunk is loaded
//     over it), and ring tile i is the 64 columns of its (chunk, tap) that
//     the walk reaches then. The pre-LN entry first takes each row's mean
//     and 1/std over the whole row (`ln_rows` with STATS, the unchunked
//     tile's arithmetic), then normalizes each chunk as it loads it.
//  2. ffn_out_kernel: y = round(hidden W2) + b2 and the entry's epilogue. A
//     block covers 64 rows x up to 512 output columns, the two warpgroups
//     half each (192 accumulators' worth at O = 384 would not fit one); the
//     hidden tile (A) and w2 (B) stream through the ring in 64-deep K
//     chunks, so shared memory does not bound H. round(y) is staged in
//     shared memory and a row pass forms x + (round(y) + b2) and the post-LN
//     LayerNorm (mean, then the biased variance) in registers: the output is
//     written once. Wider than 512 columns, column passes run as blocks and
//     a third launch LayerNorms the rows (post-LN only).
// The hidden goes through global memory in bf16 (25 MB at (16, 768, 1024),
// mostly L2-resident).
// Any width: D, H and O need no granule of their own. Zero columns of x and
// w1 and zero rows of w1 (with zero bias) give hidden columns of
// relu(0 + 0) = 0, which zero columns of w2 meet, so the padded products
// are exact; x is loaded by threads (not TMA), a value at a time where its
// rows are not 16-byte aligned; every LayerNorm counts the real D columns
// (the pre-LN rows on load, launch 2's post-LN rows and launch 3 take O);
// stores stop at the real width.
// Dead rows, by row: every row t >= len + pad gets exactly the bias-only row
// c = round(relu(round(b1)) W2) + b2 (then LN(x + c), x + c or c). Extra
// blocks of launch 1 compute c once per call into a float scratch behind
// the hidden; launch 2 reads it for those rows whatever its tiling, and
// skips the product in tiles that hold no other row.
// What holds it back (measured on the H100, scripts/time_ffn.py): launch 1's
// products run at about 57% of the tensor rate a block, and its live tiles
// (data-dependent) fill the SMs in uneven waves. A deeper ring, a 2-CTA
// cluster sharing w1 by multicast (half the L2 reads), A from registers
// and one tile of products in flight were each no faster.
// Every product's first k-step overwrites (scale_d = 0, known at compile
// time); a ring tile's products are waited for before the next tile's are
// issued, so none is in flight across a loop's back edge and no plain
// instruction touches a pending accumulator (ptxas then keeps wgmma
// asynchronous).
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

// conv input: f32 rows as they are (post), f32 rows LayerNormed (pre), or
// bf16 rows (bare)
enum : int { IN_F32 = 0, IN_F32_LN = 1, IN_BF16 = 2 };
// epilogue of the k=1 conv
enum : int { OUT_POST_LN = 0, OUT_PRE_RES = 1, OUT_BARE = 2 };
// epilogue of launch 1: the FFN's hidden, relu(round(round(acc) + b1)), or
// the attention's q|k|v, round(round(acc) + b)
enum : int { CONV_RELU = 0, CONV_QKV = 1 };

constexpr int THREADS = 256;         // two warpgroups
constexpr int SMEM_MAX = 232448;     // a block's shared memory on the H100
constexpr int SMEM_PAIR = 115712;    // each of two blocks on one SM
constexpr int SLACK = 1024 + 64;     // the ring's 1024-byte alignment, mbarriers
constexpr int ROW_PASS = 512;        // launch 2: output columns of a block, at most
constexpr int MAX_D = 2048;          // the widest conv input the plan takes

// The conv input's width in the kernels: D rounded up to a multiple of 32.
__host__ __device__ __forceinline__ int pad32(int d) { return (d + 31) / 32 * 32; }

// Tiling of one shape; mirrors ops/kernels/ffn.py:plan (fs2_ffn_plan lets a
// test hold the two together).
struct Plan {
  int p, nh, st1, smem1;             // launch 1: rows, hidden columns, stages, bytes
  int no, passes, st2, minb2, smem2;  // launch 2: columns a warpgroup, column
                                      // passes, stages, blocks per SM, bytes
  int xc;                            // launch 1: x tile columns (D rounded up to
                                     // 32, or a chunk of them)
};

bool make_plan(int D, int Hd, int K, int O, Plan* pl) {
  static const int tiles[2][2] = {{128, 256}, {64, 128}};
  if (D < 1 || D > MAX_D) return false;
  D = pad32(D);  // the x tile's width
  pl->p = 0;
  for (const auto& c : tiles) {
    const long xb = (long)D * ((c[0] + K - 1) | 1) * 2;  // the x tile, odd rows
    const long tile = (long)c[1] * 128;
    const long st = std::min(4L, (SMEM_MAX - SLACK - xb) / tile);
    if (st >= 2) {
      pl->p = c[0];
      pl->nh = c[1];
      pl->st1 = (int)st;
      pl->smem1 = (int)(xb + st * tile + SLACK);
      pl->xc = D;
      break;
    }
  }
  // else the x tile in chunks at 128 x 256: the widest chunk of 512, 256,
  // 128 or 64 columns that leaves two stages beside the rows' statistics
  for (int xc = 512; pl->p == 0 && xc >= 64; xc /= 2) {
    const long rows = (128 + K - 1) | 1, tile = 256L * 128;
    const long xb = (long)xc * rows * 2 + 8 * rows;  // the chunk, the rows' mean and 1/std
    const long st = std::min(4L, (SMEM_MAX - SLACK - xb) / tile);
    if (st >= 2) {
      pl->p = 128;
      pl->nh = 256;
      pl->st1 = (int)st;
      pl->smem1 = (int)(xb + st * tile + SLACK);
      pl->xc = xc;
    }
  }
  if (pl->p == 0) return false;
  pl->passes = (O + ROW_PASS - 1) / ROW_PASS;
  const int per = (O + pl->passes - 1) / pl->passes;
  pl->no = ((per + 1) / 2 + 63) / 64 * 64;
  pl->minb2 = pl->no <= 128 ? 2 : 1;
  const int stage = 8192 + 2 * pl->no * 128;
  pl->st2 = std::min(4, ((pl->minb2 == 2 ? SMEM_PAIR : SMEM_MAX) - SLACK) / stage);
  pl->smem2 = pl->st2 * stage + SLACK;
  return true;
}

struct Args {
  const void* x;  // f32 (post, pre) or bf16 (bare)
  const float* g;
  const float* be;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const int* lens;
  bf16* hid;    // (B, T, Hd)
  float* crow;  // (O,) the bias-only row
  void* out;
  int T, D, Hd, K, O, out_f32;
  float eps;
};

// A ring of `st` stages of `bytes` each, kept full by thread 0 (also a
// consumer): tile i goes to stage i % st once all 8 warps released tile
// i - st; `load(i, dst, bar)` issues tile i's copies.
struct Ring {
  uint32_t base;
  unsigned char* gbase;
  uint64_t* full;
  uint64_t* empty;
  int st, bytes, issued, total;

  template <class L>
  __device__ __forceinline__ void top_up(int need, L& load) {
    for (; issued < total; ++issued) {
      const int s = issued % st;
      const uint32_t parity = ((issued / st) & 1) ^ 1;
      if (issued < need)
        mbar_wait(&empty[s], parity);
      else if (!mbar_test(&empty[s], parity))
        break;
      mbar_expect_tx(&full[s], bytes);
      load(issued, gbase + s * bytes, &full[s]);
    }
  }
  // Tile `it` is in shared memory (thread 0 issues it, and later ones whose
  // stage is free, first); returns its shared address.
  template <class L>
  __device__ __forceinline__ uint32_t acquire(int it, L& load) {
    if (threadIdx.x == 0) top_up(it + 1, load);
    __syncwarp();
    mbar_wait(&full[it % st], (it / st) & 1);
    return base + (it % st) * bytes;
  }
  __device__ __forceinline__ void init() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < st; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], THREADS / 32);  // one arrival per warp
      }
      fence_barrier_init();
    }
  }
};

// c[n] = round(relu(round(b1)) . w2[n]) + b2[n] for a slice of the O outputs
// (slice `part` of `parts`): one warp an output, lanes along the contiguous
// weight row, so every call sums in one order.
__device__ void constant_row(const Args& a, int part, int parts) {
  const int per = (a.O + parts - 1) / parts, lo = part * per, hi = min(a.O, lo + per);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n = lo + warp; n < hi; n += THREADS / 32) {
    const bf16* wr = a.w2 + (size_t)n * a.Hd;
    float s = 0.f;
    for (int k = lane; k < a.Hd; k += 32)
      s += fmaxf(bf16r(a.b1[k]), 0.f) * __bfloat162float(wr[k]);
    s = warp_sum(s);
    if (lane == 0) a.crow[n] = bf16r(s) + a.b2[n];
  }
}

__device__ __forceinline__ uint4 pack8(const float4& u, const float4& v) {
  return make_uint4(pack_bf16(u.x, u.y), pack_bf16(u.z, u.w), pack_bf16(v.x, v.y),
                    pack_bf16(v.z, v.w));
}

template <int V>
using Int = std::integral_constant<int, V>;

// Runs a product in ring tiles: step(it, Int<k-steps>, Int<first>) for tile
// it, with the k-step count and the first tile's overwrite known at compile
// time (KS is even: Dp and H are multiples of 32), so no wgmma sits behind a
// runtime guard or takes a runtime scale_d.
template <class Step>
__device__ __forceinline__ void tiles(int KS, Step& step) {
  const int full = KS / 4;
  if (full > 0)
    step(0, Int<4>{}, Int<1>{});
  else
    step(0, Int<2>{}, Int<1>{});
  for (int it = 1; it < full; ++it) step(it, Int<4>{}, Int<0>{});
  if (full > 0 && KS % 4 != 0) step(full, Int<2>{}, Int<0>{});
}

// Columns [c, c + 8) of an f32 row (c < D), zeros at or past D, for rows
// aligned to A floats (D % A == 0): A = 8, two 16-byte loads; 4, the second
// only where the chunk holds it; 1, a value at a time.
template <int A>
__device__ __forceinline__ void load8_f32(const float* row, int c, int D, float4& u, float4& w) {
  if (A == 8) {
    u = *reinterpret_cast<const float4*>(row + c);
    w = *reinterpret_cast<const float4*>(row + c + 4);
  } else if (A == 4) {
    u = *reinterpret_cast<const float4*>(row + c);
    w = c + 4 < D ? *reinterpret_cast<const float4*>(row + c + 4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    float e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = c + i < D ? row[c + i] : 0.f;
    u = make_float4(e[0], e[1], e[2], e[3]);
    w = make_float4(e[4], e[5], e[6], e[7]);
  }
}

// The same at the alignment of D, known at run time.
__device__ __forceinline__ void load8_f32(const float* row, int c, int D, float4& u, float4& w) {
  if (D % 8 == 0)
    load8_f32<8>(row, c, D, u, w);
  else if (D % 4 == 0)
    load8_f32<4>(row, c, D, u, w);
  else
    load8_f32<1>(row, c, D, u, w);
}

// The same of a bf16 row, as its raw bits: one 16-byte load where D % 8 == 0.
__device__ __forceinline__ uint4 load8_bf16(const bf16* row, int c, int D) {
  if (D % 8 == 0) return *reinterpret_cast<const uint4*>(row + c);
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  uint32_t e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = c + i < D ? r[c + i] : 0u;
  return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16, e[6] | e[7] << 16);
}

// LayerNormed x rows into xs (pre-LN): one warp takes RA = 8 / S rows at a
// time, S 8-column chunks of each per lane, every load of them issued before
// the sums (f32, biased variance over the D real columns, mean first); rows
// outside [0, len) and columns past D zero. A, the rows' alignment in
// floats (`load8_f32`), is a compile-time constant: loads chosen at run time
// kept the loads of a warp's rows from going out together and cost kernel
// 9's conv launch a third of its time at D = 384. Below 8, the chunk that
// holds column D is summed column by column.
// STATS: each row's mean and 1/std go to xs read as floats, [0, R) and
// [R, 2 R), and no tile is written (the chunked tile, `load_chunk`).
template <int S, int A, bool STATS = false>
__device__ __forceinline__ void ln_rows(bf16* xs, const Args& a, size_t row0, int tbase,
                                        int rows, int R, int len) {
  constexpr int RA = 8 / S;
  const int D = a.D, CH = pad32(D) / 8, CHD = (D + 7) / 8;  // chunks: the tile's, D's
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* x = reinterpret_cast<const float*>(a.x);
  for (int e0 = warp * RA; e0 < rows; e0 += (THREADS / 32) * RA) {
    float4 u[RA][S], w[RA][S];
    bool ok[RA];
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int t = tbase + e0 + r;
      ok[r] = e0 + r < rows && t >= 0 && t < len;
      const float* src = x + (row0 + (ok[r] ? t : 0)) * D;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int c = lane + 32 * q;
        u[r][q] = w[r][q] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok[r] && c < CHD) {
          load8_f32<A>(src, 8 * c, D, u[r][q], w[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < S; ++q)
        s += ((u[r][q].x + u[r][q].y) + (u[r][q].z + u[r][q].w)) +
             ((w[r][q].x + w[r][q].y) + (w[r][q].z + w[r][q].w));
      const float mean = warp_sum(s) / (float)D;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < S; ++q)
        if (lane + 32 * q < CHD) {
          const int c8 = 8 * (lane + 32 * q);
          const float d[8] = {u[r][q].x - mean, u[r][q].y - mean, u[r][q].z - mean,
                              u[r][q].w - mean, w[r][q].x - mean, w[r][q].y - mean,
                              w[r][q].z - mean, w[r][q].w - mean};
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (A == 8 || c8 + i < D) v += d[i] * d[i];
        }
      const float inv = 1.0f / sqrtf(warp_sum(v) / (float)D + a.eps);
      const int e = e0 + r;
      if (e >= rows) continue;
      if constexpr (STATS) {
        if (lane == 0) {
          reinterpret_cast<float*>(xs)[e] = mean;
          reinterpret_cast<float*>(xs)[R + e] = inv;
        }
        continue;
      }
      uint4* dst = reinterpret_cast<uint4*>(xs) + e;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int c = lane + 32 * q;
        if (c >= CH) continue;
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
        if (ok[r] && c < CHD) {  // g = be = 0 past D: those columns give 0
          float4 gu, gv, bu, bv;
          load8_f32<A>(a.g, 8 * c, D, gu, gv);
          load8_f32<A>(a.be, 8 * c, D, bu, bv);
          const float4 uu = u[r][q], ww = w[r][q];
          o = pack8(make_float4((uu.x - mean) * inv * gu.x + bu.x,
                                (uu.y - mean) * inv * gu.y + bu.y,
                                (uu.z - mean) * inv * gu.z + bu.z,
                                (uu.w - mean) * inv * gu.w + bu.w),
                    make_float4((ww.x - mean) * inv * gv.x + bv.x,
                                (ww.y - mean) * inv * gv.y + bv.y,
                                (ww.z - mean) * inv * gv.z + bv.z,
                                (ww.w - mean) * inv * gv.w + bv.w));
        }
        dst[(size_t)c * R] = o;
      }
    }
  }
}

// The pre-LN tile at S chunks a lane and the rows' alignment.
template <int S>
__device__ __forceinline__ void ln_tile(bf16* xs, const Args& a, size_t row0, int tbase,
                                        int rows, int R, int len) {
  if (a.D % 8 == 0)
    ln_rows<S, 8>(xs, a, row0, tbase, rows, R, len);
  else if (a.D % 4 == 0)
    ln_rows<S, 4>(xs, a, row0, tbase, rows, R, len);
  else
    ln_rows<S, 1>(xs, a, row0, tbase, rows, R, len);
}

// x rows tbase .. tbase + rows - 1 of batch row `row0 / T` into xs
// [Dp/8][R][8] bf16, zero outside [0, len) and past D; pre-LN: LayerNormed first
// (ln_rows). A thread takes 8 columns of a row (16 bytes stored, at an odd
// row count R on 8 distinct bank groups), eight such items loaded before any
// is stored: a dependent load and store per item left the tile's load
// latency-bound.
template <int IN>
__device__ __forceinline__ void load_tile(bf16* xs, const Args& a, size_t row0, int tbase,
                                          int rows, int R, int len) {
  const int D = a.D, CH = pad32(D) / 8;
  if (IN == IN_F32_LN) {
    if (CH <= 32)
      ln_tile<1>(xs, a, row0, tbase, rows, R, len);
    else if (CH <= 64)
      ln_tile<2>(xs, a, row0, tbase, rows, R, len);
    else if (CH <= 128)
      ln_tile<4>(xs, a, row0, tbase, rows, R, len);
    else
      ln_tile<8>(xs, a, row0, tbase, rows, R, len);
    return;
  }
  constexpr int U = 8;
  const int n = rows * CH;
  for (int i0 = threadIdx.x; i0 < n; i0 += U * THREADS) {
    uint4 v[U];
    float4 f[U][2];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int i = i0 + q * THREADS, e = i / CH, c = i % CH, t = tbase + e;
      const bool ok = i < n && t >= 0 && t < len && 8 * c < D;
      if (IN == IN_F32) {
        f[q][0] = f[q][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok)
          load8_f32(reinterpret_cast<const float*>(a.x) + (row0 + t) * D, 8 * c, D, f[q][0],
                    f[q][1]);
      } else {
        v[q] = make_uint4(0u, 0u, 0u, 0u);
        if (ok) v[q] = load8_bf16(reinterpret_cast<const bf16*>(a.x) + (row0 + t) * D, 8 * c, D);
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int i = i0 + q * THREADS;
      if (i < n)
        reinterpret_cast<uint4*>(xs)[(size_t)(i % CH) * R + i / CH] =
            IN == IN_F32 ? pack8(f[q][0], f[q][1]) : v[q];
    }
  }
}

// The rows' mean and 1/std for the chunked pre-LN tile (`ln_rows` with
// STATS: D past 1,024, so 8 chunks a lane) into st [0, R) and [R, 2 R).
__device__ __forceinline__ void ln_stats(float* st, const Args& a, size_t row0, int tbase,
                                         int rows, int R, int len) {
  bf16* xs = reinterpret_cast<bf16*>(st);
  if (a.D % 8 == 0)
    ln_rows<8, 8, true>(xs, a, row0, tbase, rows, R, len);
  else if (a.D % 4 == 0)
    ln_rows<8, 4, true>(xs, a, row0, tbase, rows, R, len);
  else
    ln_rows<8, 1, true>(xs, a, row0, tbase, rows, R, len);
}

// Columns [c0, c0 + 8 CH) of x rows tbase .. tbase + rows - 1 into the
// chunked tile xs [CH][R][8], as `load_tile` (zero outside [0, len) and past
// D; U items loaded before any is stored: eight, four for the pre-LN entry,
// whose 128 accumulators a thread stay live across the chunks' loads and
// which spilled at eight); pre-LN: each value (x - mean) * inv * g + be with
// the row's statistics st (`ln_stats`), the arithmetic of `ln_rows`.
template <int IN>
__device__ __forceinline__ void load_chunk(bf16* xs, const Args& a, size_t row0, int tbase,
                                           int rows, int R, int len, int c0, int CH,
                                           const float* st) {
  const int D = a.D, Dr = D - c0;  // real columns from c0 on (c0 < D, a multiple of 64)
  constexpr int U = IN == IN_F32_LN ? 4 : 8;
  const int n = rows * CH;
  for (int i0 = threadIdx.x; i0 < n; i0 += U * THREADS) {
    uint4 v[U];
    float4 f[U][2];
    bool ok[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int i = i0 + q * THREADS, e = i / CH, c = i % CH, t = tbase + e;
      ok[q] = i < n && t >= 0 && t < len && 8 * c < Dr;
      if (IN == IN_BF16) {
        v[q] = make_uint4(0u, 0u, 0u, 0u);
        if (ok[q])
          v[q] = load8_bf16(reinterpret_cast<const bf16*>(a.x) + (row0 + t) * D + c0, 8 * c, Dr);
      } else {
        f[q][0] = f[q][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok[q])
          load8_f32(reinterpret_cast<const float*>(a.x) + (row0 + t) * D + c0, 8 * c, Dr,
                    f[q][0], f[q][1]);
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int i = i0 + q * THREADS;
      if (i >= n) continue;
      const int e = i / CH, c = i % CH;
      if (IN == IN_F32_LN && ok[q]) {  // g = be = 0 past D: those columns give 0
        const float mean = st[e], inv = st[R + e];
        float4 gu, gv, bu, bv;
        load8_f32(a.g + c0, 8 * c, Dr, gu, gv);
        load8_f32(a.be + c0, 8 * c, Dr, bu, bv);
        const float4 uu = f[q][0], ww = f[q][1];
        f[q][0] = make_float4((uu.x - mean) * inv * gu.x + bu.x, (uu.y - mean) * inv * gu.y + bu.y,
                              (uu.z - mean) * inv * gu.z + bu.z, (uu.w - mean) * inv * gu.w + bu.w);
        f[q][1] = make_float4((ww.x - mean) * inv * gv.x + bv.x, (ww.y - mean) * inv * gv.y + bv.y,
                              (ww.z - mean) * inv * gv.z + bv.z, (ww.w - mean) * inv * gv.w + bv.w);
      }
      reinterpret_cast<uint4*>(xs)[(size_t)c * R + e] =
          IN == IN_BF16 ? v[q] : pack8(f[q][0], f[q][1]);
    }
  }
}

// Launch 1. Block (tile, hidden part, batch row): P = 64 * WR rows x NH
// hidden columns; WR = 2: each warpgroup 64 rows x NW columns (NH = NW);
// WR = 1: both the same 64 rows, NW columns each (NH = 2 NW). CONV_RELU:
// blocks of the extra tile index `ntiles` compute the bias-only row instead.
// CH: the x tile in chunks of xc columns (a multiple of 64; the plan's xc),
// followed by the rows' statistics (2 R floats).
template <int IN, int WR, int NW, int EPI, bool CH = false>
__global__ void __launch_bounds__(THREADS, 1)
ffn_conv_kernel(const __grid_constant__ CUtensorMap tw1, const __grid_constant__ Args a, int st,
                int ntiles, int xc) {
  constexpr int P = 64 * WR, NH = WR == 2 ? NW : 2 * NW;
  extern __shared__ unsigned char smem_raw[];
  const int b = blockIdx.z;
  if (EPI == CONV_RELU && (int)blockIdx.x == ntiles) {
    constant_row(a, b * gridDim.y + blockIdx.y, gridDim.y * gridDim.z);
    return;
  }
  const int T = a.T, Dp = pad32(a.D), pad = (a.K - 1) / 2;
  const int t0 = blockIdx.x * P, n0 = blockIdx.y * NH;
  const int len = max(0, min(a.lens[b], T)), live = min(T, len + pad);
  if (t0 >= live) return;  // launch 2 gives every row from len + pad on the row c
  unsigned char* ring_g = align1024(smem_raw);
  const int rows = P + a.K - 1, R = rows | 1;
  bf16* xs = reinterpret_cast<bf16*>(ring_g + st * NH * 128);  // [Dp/8][R][8] (CH: [xc/8])
  float* stats = reinterpret_cast<float*>(xs + (size_t)((CH ? xc : Dp) / 8) * R * 8);
  uint64_t* full = reinterpret_cast<uint64_t*>(CH ? stats + 2 * R : stats);
  // CH: nc chunks, each tap of a chunk in tq ring tiles (the last chunk's:
  // tql, its last tile 32 columns where Dp % 64 != 0)
  const int nc = CH ? (Dp + xc - 1) / xc : 1, tq = xc / 64;
  const int tql = CH ? (Dp - (nc - 1) * xc + 63) / 64 : 0;
  Ring ring{smem_u32(ring_g), ring_g, full, full + st, st, NH * 128, 0,
            CH ? a.K * ((nc - 1) * tq + tql) : (a.K * Dp + 63) / 64};
  ring.init();
  __syncthreads();
  auto load = [&](int i, unsigned char* dst, uint64_t* bar) {
    if constexpr (CH) {  // tile i: chunk q, tap j, its 64 columns from c
      const int q = min(i / (a.K * tq), nc - 1), r = i - q * a.K * tq;
      const int nq = q == nc - 1 ? tql : tq;
      tma_load_2d(dst, &tw1, bar, (r / nq) * Dp + q * xc + 64 * (r % nq), n0);
    } else {
      tma_load_2d(dst, &tw1, bar, i * 64, n0);
    }
  };
  if (threadIdx.x == 0) ring.top_up(0, load);  // every stage is free
  const size_t row0 = (size_t)b * T;
  if constexpr (CH) {
    if (IN == IN_F32_LN) {
      ln_stats(stats, a, row0, t0 - pad, rows, R, len);
      __syncthreads();
    }
    load_chunk<IN>(xs, a, row0, t0 - pad, rows, R, len, 0, xc / 8, stats);
  } else {
    load_tile<IN>(xs, a, row0, t0 - pad, rows, R, len);
  }
  fence_proxy_async_smem();  // xs is read by the products' descriptors
  __syncthreads();

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const uint32_t lbo = R * 16;  // bytes from one column chunk to the next
  const uint32_t xa = smem_u32(xs) + (WR == 2 ? wg * 64 * 16 : 0);
  const uint32_t boff = WR == 2 ? 0 : wg * NW * 128;
  float acc[NW / 2];
  int j = 0, c0 = 0;  // tap and first input column of the next k-step
  auto step = [&](int it, auto nks, auto first) {
    const uint32_t bt = ring.acquire(it, load) + boff;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < decltype(nks)::value; ++s) {
      const uint32_t ad = xa + (c0 / 8) * lbo + j * 16;
      wgmma_ss_k<NW>(acc, desc_plain(ad, lbo, 128), kmajor_desc(bt, s),
                     decltype(first)::value && s == 0 ? 0 : 1);
      c0 += 16;
      const bool wrap = c0 == Dp;  // next tap
      c0 = wrap ? 0 : c0;
      j += wrap;
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    warp_arrive(&ring.empty[it % st]);
  };
  if constexpr (CH) {
    // ring tile it at chunk column ad's descriptor base: nks k-steps of 16
    // columns (two 8-column core matrices, 2 lbo bytes, each)
    auto cstep = [&](int it, uint32_t ad, auto nks, auto first) {
      const uint32_t bt = ring.acquire(it, load) + boff;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < decltype(nks)::value; ++s)
        wgmma_ss_k<NW>(acc, desc_plain(ad + s * 2 * lbo, lbo, 128), kmajor_desc(bt, s),
                       decltype(first)::value && s == 0 ? 0 : 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      warp_arrive(&ring.empty[it % st]);
    };
    int it = 0;
    for (int q = 0; q < nc; ++q) {
      if (q > 0) {
        __syncthreads();  // every warp's products have read chunk q - 1
        load_chunk<IN>(xs, a, row0, t0 - pad, rows, R, len, q * xc, xc / 8, stats);
        fence_proxy_async_smem();
        __syncthreads();
      }
      const int nq = q == nc - 1 ? tql : tq, cw = min(xc, Dp - q * xc);
      for (int j = 0; j < a.K; ++j) {
        for (int m = 0; m < cw / 64; ++m, ++it) {
          const uint32_t ad = xa + m * 8 * lbo + j * 16;
          if (it == 0)
            cstep(it, ad, Int<4>{}, Int<1>{});
          else
            cstep(it, ad, Int<4>{}, Int<0>{});
        }
        if (nq * 64 != cw) {  // 32 columns left (cw % 64 == 32; never the first tile)
          cstep(it, xa + (cw / 64) * 8 * lbo + j * 16, Int<2>{}, Int<0>{});
          ++it;
        }
      }
    }
  } else {
    tiles(a.K * Dp / 16, step);
  }

  // CONV_RELU: rows from len + pad on are not read. CONV_QKV (k = 1): every
  // row of the tile below T, those past the length from zero x rows
  // (round(b)): the attention forward reads the whole key tile that holds
  // the length, and a V row it weighs by zero must still be finite.
  const int rows_out = EPI == CONV_QKV ? T : live;
  const int rb = t0 + (WR == 2 ? wg * 64 : 0) + warp * 16 + g8;
  const int cbase = n0 + (WR == 2 ? 0 : wg * NW) + 2 * t4;
  bf16* hb = a.hid + row0 * a.Hd;
#pragma unroll
  for (int ni = 0; ni < NW / 8; ++ni) {
    const int n = cbase + ni * 8;
    if (n >= a.Hd) continue;  // Hd is even: n + 1 < Hd too
    const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b1 + n));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tr = rb + 8 * h;
      if (tr >= rows_out) continue;
      const float u = bf16r(acc[ni * 4 + 2 * h]) + bb.x;
      const float w = bf16r(acc[ni * 4 + 2 * h + 1]) + bb.y;
      *reinterpret_cast<uint32_t*>(hb + (size_t)tr * a.Hd + n) =
          EPI == CONV_QKV ? pack_bf16(u, w)
                          : pack_bf16(fmaxf(bf16r(u), 0.f), fmaxf(bf16r(w), 0.f));
    }
  }
}

// Launch 2. Block (64-row tile, column pass, batch row): each warpgroup NO
// output columns of the pass. The products' round(y) go to shared memory,
// over the drained ring; then one warp a row forms x + (round(y) + b2), or
// the row c from len + pad on, LayerNorms it where ln_here (post-LN, the
// pass covering every column: mean, then the biased variance, from
// registers) and stores it. A lane takes columns lane + 32 j of RA rows at a
// time, so every load and store is coalesced, and x is loaded for all RA rows
// before anything else (read per element beside the shared-memory loads,
// the loads went out one at a time: 0.12 against 0.06 ms at (16, 768, 384)).
template <int OUT, int NO, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
ffn_out_kernel(const __grid_constant__ CUtensorMap thid, const __grid_constant__ CUtensorMap tw2,
               const __grid_constant__ Args a, int st, int ln_here) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int SB = 8192 + 2 * NO * 128;  // a stage: hidden 64 x 64, w2 2NO x 64
  constexpr int NC = 2 * NO, LDY = NC + 8;  // the pass's columns; ys row stride
  unsigned char* ring_g = align1024(smem_raw);
  float* ys = reinterpret_cast<float*>(ring_g);  // [64][LDY] round(y)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_g + st * SB);
  const int T = a.T, O = a.O, b = blockIdx.z, t0 = blockIdx.x * 64, cb = blockIdx.y * NC;
  const int len = max(0, min(a.lens[b], T)), live = min(T, len + (a.K - 1) / 2);
  const size_t row0 = (size_t)b * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (t0 < live) {  // else no row of the tile reads the product
    Ring ring{smem_u32(ring_g), ring_g, full, full + st, st, SB, 0, (a.Hd + 63) / 64};
    ring.init();
    __syncthreads();
    auto load = [&](int i, unsigned char* dst, uint64_t* bar) {
      tma_load_2d(dst, &thid, bar, i * 64, (int)row0 + t0);
      tma_load_2d(dst + 8192, &tw2, bar, i * 64, cb);
      tma_load_2d(dst + 8192 + NO * 128, &tw2, bar, i * 64, cb + NO);
    };
    if (threadIdx.x == 0) ring.top_up(0, load);
    const int wg = threadIdx.x >> 7;
    float acc[NO / 2];
    auto step = [&](int it, auto nks, auto first) {
      const uint32_t s0 = ring.acquire(it, load);
      const uint32_t bt = s0 + 8192 + wg * NO * 128;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < decltype(nks)::value; ++s)
        wgmma_ss_k<NO>(acc, kmajor_desc(s0, s), kmajor_desc(bt, s),
                       decltype(first)::value && s == 0 ? 0 : 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      warp_arrive(&ring.empty[it % st]);
    };
    tiles(a.Hd / 16, step);
    __syncthreads();  // every warp's products retired: the ring is free
    // rows 16 (warp % 4) + lane / 4 (+ 8), columns of n-tile ni at 8 ni +
    // 2 (lane % 4); a row stride of 8 banks past a multiple of 32 puts each
    // half-warp's pairs on 32 distinct banks
    float* yr = ys + ((warp & 3) * 16 + (lane >> 2)) * LDY + wg * NO + 2 * (lane & 3);
#pragma unroll
    for (int ni = 0; ni < NO / 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(yr + h * 8 * LDY + ni * 8) =
            make_float2(bf16r(acc[ni * 4 + 2 * h]), bf16r(acc[ni * 4 + 2 * h + 1]));
  }
  __syncthreads();

  constexpr int J = NC / 32, RA = 4;  // values of a row per lane; rows at a time
  const int cw = min(NC, O - cb);     // columns of this pass
  const bool ln = OUT == OUT_POST_LN && ln_here;
  const float* x = reinterpret_cast<const float*>(a.x);
  float* outf = reinterpret_cast<float*>(a.out);
  bf16* outh = reinterpret_cast<bf16*>(a.out);
  const bool f32 = OUT != OUT_BARE || a.out_f32;
  for (int rb = warp * RA; rb < 64; rb += (THREADS / 32) * RA) {
    float v[RA][J], xv[RA][J];
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int row = t0 + rb + r;
      const float* xr = x + (row0 + min(row, T - 1)) * O + cb;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int n = lane + 32 * j;
        xv[r][j] = OUT != OUT_BARE && n < cw ? __ldg(xr + n) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int row = t0 + rb + r;
      const bool prod = row < live;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int n = lane + 32 * j;
        float y = 0.f;
        if (row < T && n < cw) {
          y = prod ? ys[(rb + r) * LDY + n] + __ldg(a.b2 + cb + n) : __ldg(a.crow + cb + n);
          if (OUT != OUT_BARE) y = xv[r][j] + y;
        }
        v[r][j] = y;
      }
    }
    if (ln) {
#pragma unroll
      for (int r = 0; r < RA; ++r) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) s += v[r][j];  // zero past cw
        const float mean = warp_sum(s) / (float)O;
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (lane + 32 * j < cw) q += (v[r][j] - mean) * (v[r][j] - mean);
        const float inv = 1.0f / sqrtf(warp_sum(q) / (float)O + a.eps);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int n = lane + 32 * j;
          if (n < cw) v[r][j] = (v[r][j] - mean) * inv * a.g[n] + a.be[n];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int row = t0 + rb + r;
      if (row >= T) continue;
      const size_t off = (row0 + row) * O + cb;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int n = lane + 32 * j;
        if (n >= cw) continue;
        if (f32)
          outf[off + n] = v[r][j];
        else
          outh[off + n] = __float2bfloat16_rn(v[r][j]);
      }
    }
  }
}

// Launch 3 (post-LN wider than one pass): LayerNorm of every row in place.
__global__ void __launch_bounds__(THREADS)
ffn_ln_rows_kernel(const __grid_constant__ Args a, int rows) {
  const int r = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  float* row = reinterpret_cast<float*>(a.out) + (size_t)r * a.O;
  warp_layer_norm(row, row, a.O, a.g, a.be, a.eps, threadIdx.x & 31);
}

template <int IN, int WR, int NW, int EPI, bool CH = false>
cudaError_t launch_conv_tile(const CUtensorMap& tw1, const Args& a, const Plan& pl, dim3 grid,
                             int ntiles, cudaStream_t stream) {
  cudaError_t e = set_smem(ffn_conv_kernel<IN, WR, NW, EPI, CH>, pl.smem1);
  if (e != cudaSuccess) return e;
  ffn_conv_kernel<IN, WR, NW, EPI, CH><<<grid, THREADS, pl.smem1, stream>>>(tw1, a, pl.st1,
                                                                            ntiles, pl.xc);
  return cudaGetLastError();
}

// Launch 1 over B batch rows at the plan's tiling; tw1 maps w1 (Hd, K Dp) in
// nh-row boxes. CONV_RELU adds the tile index of the bias-only row.
template <int IN, int EPI>
cudaError_t launch_conv(const CUtensorMap& tw1, const Args& a, const Plan& pl, int B,
                        cudaStream_t stream) {
  const int ntiles = (a.T + pl.p - 1) / pl.p;
  const dim3 grid(ntiles + (EPI == CONV_RELU), (a.Hd + pl.nh - 1) / pl.nh, B);
  if (pl.xc < pad32(a.D))
    return launch_conv_tile<IN, 2, 256, EPI, true>(tw1, a, pl, grid, ntiles, stream);
  if (pl.p == 128) return launch_conv_tile<IN, 2, 256, EPI>(tw1, a, pl, grid, ntiles, stream);
  return launch_conv_tile<IN, 1, 64, EPI>(tw1, a, pl, grid, ntiles, stream);
}

template <int OUT, int NO>
cudaError_t launch_out(const CUtensorMap& thid, const CUtensorMap& tw2, const Args& a,
                       const Plan& pl, dim3 grid, cudaStream_t stream) {
  constexpr int MINB = NO <= 128 ? 2 : 1;
  cudaError_t e = set_smem(ffn_out_kernel<OUT, NO, MINB>, pl.smem2);
  if (e != cudaSuccess) return e;
  ffn_out_kernel<OUT, NO, MINB><<<grid, THREADS, pl.smem2, stream>>>(thid, tw2, a, pl.st2,
                                                                      pl.passes == 1);
  return cudaGetLastError();
}

// Launch 2, and launch 3 where a post-LN output is wider than one pass,
// over B batch rows: thid maps the (B T, Hd) bf16 hidden in 64-row boxes,
// tw2 the (O, Hd) weight in no-row boxes.
template <int OUT>
cudaError_t launch_epilogue(const CUtensorMap& thid, const CUtensorMap& tw2, const Args& a,
                            const Plan& pl, int B, cudaStream_t stream) {
  const dim3 g2((a.T + 63) / 64, pl.passes, B);
  cudaError_t e;
  switch (pl.no) {
    case 64: e = launch_out<OUT, 64>(thid, tw2, a, pl, g2, stream); break;
    case 128: e = launch_out<OUT, 128>(thid, tw2, a, pl, g2, stream); break;
    case 192: e = launch_out<OUT, 192>(thid, tw2, a, pl, g2, stream); break;
    default: e = launch_out<OUT, 256>(thid, tw2, a, pl, g2, stream); break;
  }
  if (e != cudaSuccess || OUT != OUT_POST_LN || pl.passes == 1) return e;
  const int rows = B * a.T;
  ffn_ln_rows_kernel<<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, stream>>>(a, rows);
  return cudaGetLastError();
}

}  // namespace
