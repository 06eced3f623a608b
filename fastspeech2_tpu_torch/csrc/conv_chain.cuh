// Chains of k-tap convs on the H100, shared by the variance adaptor
// (adaptor.cu, kernel 3) and the postnet (postnet.cu, kernel 4): the pieces
// of csrc/ffn_body.cuh's k-tap conv launch (the row-shifted A tile, the TMA
// weight ring, `Ring`) put to a conv whose input width need not be a
// multiple of 32 and whose output stays in shared memory for the next conv.
//
//  * A conv's input rows sit in shared memory column-chunk-major,
//    [chunks][R][8] bf16 (R odd: a 16-byte store of 8 columns of
//    consecutive rows lands on distinct bank groups); tap j's A operand is
//    the same tile at a base shifted by j rows (`desc_plain`).
//  * Its weights, laid out (out, tap, in), stream through the ring in tiles
//    of tap j's 64 input columns (`tma_map_bf16_taps`): the map zero-fills
//    the columns past the input width, so a width that is a multiple of 8
//    costs its own k-steps rounded up to 16 and no padded copy of the
//    weights. `conv_product` runs the tiles (64 or 128 input columns, one
//    or two boxes), the last column chunk of a tap with fewer k-steps.
//  * `load_rows` fills a tile from global rows (f32 or bf16, any row
//    source: the adaptor gathers by expansion index), several 16-byte loads
//    in flight before any store, zeros where a row is absent and past the
//    input width.
#pragma once

#include "ffn_body.cuh"

namespace {

// The first 1024-byte boundary (a 128-byte swizzle atom) of the kernel's
// dynamic shared memory, as the base plus an offset: pointers derived from
// it keep the shared address space. (hopper.cuh:align1024 rounds the
// address as an integer, which hides that: every access through such a
// pointer was a generic one with a 64-bit address, and the widest kernels
// spilled the addresses.)
__device__ __forceinline__ unsigned char* smem_align1024(unsigned char* base) {
  return base + ((1024u - (smem_u32(base) & 1023u)) & 1023u);
}

// Ring tiles of one conv of `taps` taps over `cin` input columns, KT (64 or
// 128) input columns a tile, in order: tile i is tap i / nq, input columns
// KT (i % nq) .. + KT - 1, nq = ceil(cin / KT). step(i, Int<k-steps>,
// Int<first>): KT / 16 k-steps, or ceil(rest / 16) in the last chunk of a
// tap; the first tile, whose first k-step overwrites the accumulators, is
// peeled (ACC: none does, the conv adds to them -- a later chunk of input
// columns). The k-step count selects a whole tile's code, and every tile
// retires its products before the next, so no wgmma waits behind a runtime
// guard with an accumulator pending.
template <int KT, bool ACC = false, class Step>
__device__ __forceinline__ void tap_tiles(int taps, int cin, Step& step) {
  static_assert(KT == 64 || KT == 128, "tiles of 64 or 128 input columns");
  const int nq = (cin + KT - 1) / KT, ks_last = (cin - KT * (nq - 1) + 15) / 16;
  auto one = [&](int i, auto first) {
    const int ks = i % nq + 1 < nq ? KT / 16 : ks_last;
    switch (ks) {
      case 1: step(i, Int<1>{}, first); break;
      case 2: step(i, Int<2>{}, first); break;
      case 3: step(i, Int<3>{}, first); break;
      case 4: step(i, Int<4>{}, first); break;
      default:
        if constexpr (KT == 128) {
          switch (ks) {
            case 5: step(i, Int<5>{}, first); break;
            case 6: step(i, Int<6>{}, first); break;
            case 7: step(i, Int<7>{}, first); break;
            default: step(i, Int<8>{}, first); break;
          }
        }
    }
  };
  one(0, Int<ACC ? 0 : 1>{});
  for (int i = 1; i < taps * nq; ++i) one(i, Int<0>{});
}

// Ring tiles of one conv: taps * ceil(cin / kt).
__host__ __device__ __forceinline__ int conv_tiles(int taps, int cin, int kt) {
  return taps * ((cin + kt - 1) / kt);
}

// acc = conv(A) for this warpgroup (ACC: acc += conv(A)): A is the
// row-shifted tile at shared address xa (its first row; lbo = R * 16 bytes
// between column chunks), tap j's rows tap_bytes / 16 rows apart (1 for a
// plain conv, the dilation for a dilated one), B the ring tiles it0 .. it0 +
// conv_tiles(taps, cin, KT) - 1, each KT / 64 sub-tiles of 64 input columns
// `sub` bytes apart, this warpgroup's N output rows at byte offset boff of
// each.
template <int N, int KT, bool ACC = false, class Load>
__device__ __forceinline__ void conv_product(float (&acc)[N / 2], Ring& ring, Load& load, int it0,
                                             uint32_t xa, uint32_t lbo, uint32_t boff, uint32_t sub,
                                             int taps, int cin, uint32_t tap_bytes = 16) {
  const int nq = (cin + KT - 1) / KT;
  auto step = [&](int i, auto nks, auto first) {
    const int it = it0 + i;
    const uint32_t bt = ring.acquire(it, load) + boff;
    const uint32_t a0 = xa + (uint32_t)(KT / 8 * (i % nq)) * lbo + (uint32_t)(i / nq) * tap_bytes;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < decltype(nks)::value; ++s)
      wgmma_ss_k<N>(acc, desc_plain(a0 + 2 * s * lbo, lbo, 128),
                    kmajor_desc(bt + (s >> 2) * sub, s & 3),
                    decltype(first)::value && s == 0 ? 0 : 1);
    wgmma_commit();
    // refill the stages the warps released since this tile's acquire while
    // the products run: the next tiles then load st - 1 tiles ahead
    if (threadIdx.x == 0) ring.top_up(0, load);
    wgmma_wait<0>();
    fence_regs(acc);
    warp_arrive(&ring.empty[it % ring.st]);
  };
  tap_tiles<KT, ACC>(taps, cin, step);
}

// xs [nch][R][8] bf16 from global rows: row e < rows is src(e), a pointer to
// `cols` f32 (F32) or bf16 values, or nullptr for a zero row; rows from
// `rows` to R, chunks at or past ceil(cols / 8) and, in the last chunk,
// columns at or past cols are zeros, stored without a load. A thread takes
// 8 columns of a row; U such items are loaded before any is stored
// (ffn_body.cuh:load_tile's reason: a dependent load and store per item
// left the tile latency-bound; U = 16 was no faster and raised the kernels'
// register peak to spills). A: the f32 rows' alignment in floats
// (ffn_body.cuh:load8_f32; 8 where cols % 8 == 0); bf16 rows take cols % 8
// == 0 and 16-byte alignment.
template <bool F32, int U = 8, int A = 8, class Src>
__device__ __forceinline__ void load_rows(bf16* xs, int R, int nch, int cols, int rows, Src src) {
  const int cc = (cols + 7) / 8, n = rows * cc;
  uint4* x4 = reinterpret_cast<uint4*>(xs);
  for (int i0 = threadIdx.x; i0 < n; i0 += U * THREADS) {
    float4 f[U][2];
    uint4 v[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int i = i0 + q * THREADS, e = i / cc, c = i % cc;
      const void* row = i < n ? src(e) : nullptr;
      if (F32) {
        f[q][0] = f[q][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row != nullptr)
          load8_f32<A>(static_cast<const float*>(row), 8 * c, cols, f[q][0], f[q][1]);
      } else {
        v[q] = make_uint4(0u, 0u, 0u, 0u);
        if (row != nullptr) v[q] = reinterpret_cast<const uint4*>(row)[c];
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int i = i0 + q * THREADS;
      if (i < n) x4[(size_t)(i % cc) * R + i / cc] = F32 ? pack8(f[q][0], f[q][1]) : v[q];
    }
  }
  // the zeros: chunks past the columns in every row, then the rows past `rows`
  const int nz = R * (nch - cc) + (R - rows) * cc;
  for (int i = threadIdx.x; i < nz; i += THREADS) {
    const int k = i - R * (nch - cc);
    x4[k < 0 ? (size_t)(cc + i / R) * R + i % R : (size_t)(k % cc) * R + rows + k / cc] =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// f(Int<A>{}) at the alignment A in floats (8, 4 or 1) of rows of `cols`
// f32 values: the loads of load_rows and of the kernels' output rows are
// chosen at compile time, the alignment once per call.
template <class F>
__device__ __forceinline__ void by_alignment(int cols, F&& f) {
  if (cols % 8 == 0)
    f(Int<8>{});
  else if (cols % 4 == 0)
    f(Int<4>{});
  else
    f(Int<1>{});
}

// Copies `bytes` (a multiple of 16) from global to shared memory with
// cp.async, one 16-byte piece a thread at a time, and commits them: an
// epilogue's parameters, loaded while the products run (cp_async_wait<0>
// and a barrier before they are read).
__device__ __forceinline__ void stage_params(void* dst, const void* src, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += THREADS)
    cp_async16(static_cast<char*>(dst) + 16 * i, static_cast<const char*>(src) + 16 * i, true);
  cp_async_commit();
}

// v, as a value the compiler cannot see through: what is derived from it
// inside a loop is not hoisted out of the loop and kept live across it
// (the postnet's per-n-tile column indices, hoisted out of its stage loop,
// spilled its widest kernel).
__device__ __forceinline__ int opaque(int v) {
  asm volatile("mov.b32 %0, %0;" : "+r"(v));
  return v;
}

// Stores the pair (u, w) of output columns n, n + 1 (n even) of tile row r
// into a [chunks][R][8] bf16 tile.
__device__ __forceinline__ void store_pair(bf16* xs, int R, int r, int n, float u, float w) {
  *reinterpret_cast<uint32_t*>(xs + ((size_t)(n >> 3) * R + r) * 8 + (n & 7)) = pack_bf16(u, w);
}

}  // namespace
