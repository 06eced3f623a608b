// Variance adaptor (frame-level serving segment) on the H100:
// gather encoder states by expansion index -> pitch and energy predictors
// (conv k=3 -> ReLU -> LN(1e-12) -> mask -> conv k=3 -> ReLU -> LN -> scalar
// head) -> bucketize -> embedding rows -> residual, zeroed past out_len;
// also the raw predictions (B, 2, L), zeroed past out_len.
//
// Replaces fastspeech2_tpu/ops/pallas/adaptor.py: fused_variance_adaptor
// (kernel _adaptor_kernel).
//
// Bound on the H100: two predictors of two k=3 convs at C = 256 channels
// are 2*2*3*(D + C)*C*2 ~ 3.1 MFLOP per frame at D = 256 against ~2 KB of
// f32 state in and out: ~1,500 FLOP/byte, above the ridge (~295) --
// tensor-core (operations) bound. What a block reads again is the weights:
// 1.5 MB of w1 and w2 at D = 256 for every tile of frames.
//
// Design (sm_90a; csrc/conv_chain.cuh on hopper.cuh and ffn_body.cuh). One
// launch of two warpgroups (256 threads); a block covers 62 frames of one
// batch row, and both warpgroups compute its 64 conv rows, 128 of the 256
// channels each:
//  1. the 66 input rows of the frames l0 - 2 .. (the halo of two k=3
//     convs) are gathered from hs by index, rounded to bf16 into a
//     row-shifted [D/8][rows][8] tile, zero outside [0, out_len);
//  2. per predictor, conv1 is one K = 3 D wgmma product over that tile and
//     conv2 one K = 3 C product over its bf16 output H1 (66 rows), both
//     against w1 and w2 streamed through one TMA ring of 256 x 128 tiles
//     (256 x 64 where two such stages do not fit, D > 416) that thread 0
//     keeps topped up across the four products, refilling while the
//     products run; each epilogue's parameters load into shared memory
//     with cp.async while its products run;
//  3. the epilogues run in registers: relu(round(acc) + b), the LayerNorm
//     over the row's 256 channels (the quad of threads holding a row's 128
//     sums it with shuffles, the two warpgroups' halves meet in shared
//     memory), the frame mask and the bf16 store into H1 (conv1); the head
//     round(sum round(h2) wo) + bo, the count of edges below it and `raw`
//     (conv2);
//  4. the output row (e + (emb_p + b_p)) + (emb_e + b_e), e re-read in f32.
// Tiles at or past out_len write zeros and do no products.
// Any width: w1's input columns and the embedding rows are padded with zeros
// to D rounded up to 8 when they are packed (a TMA map's row stride is a
// multiple of 16 bytes; the map zero-fills each tap past D to the K step,
// and the conv over zero columns is exact; there is no LayerNorm over D);
// the x tile and the output rows are read and written at the alignment of
// D (8, 4 or 1 floats), stores stop at D. Where the x tile at D does not fit
// beside H1 and one ring stage (D > 1136 at 256 bins), it holds AD_XC
// columns at a time: conv1 is a product over each chunk in turn,
// re-gathered per chunk, the accumulators carried across the chunks (each
// chunk's tiles retired before the next chunk is gathered). The bin edges
// sit in shared memory AD_BCH at a time; past that the count walks them in
// chunks. What bounds it
// here (clock64 phases on the H100, B=16, L=768, D=256): the products wait
// on weight tiles from L2 (every block streams both predictors' weights);
// 64-row blocks put twice the SMs to work on them, and a 128-column tile
// costs about what a 64-column one does.
#include "conv_chain.cuh"

namespace {

constexpr int AC = 256;  // predictor channels: the only width any route passes
constexpr int AD_SUB = AC * 128;  // 256 weight rows x 64 columns: a ring tile is 1 or 2
constexpr int AD_M = 64;          // conv rows a block (frames: AD_M - 2)
constexpr int AD_R = (AD_M + 2) | 1;  // rows of the x tile and of H1
constexpr int AD_XC = 512;        // x tile columns a chunk, where D does not fit whole
constexpr int AD_BCH = 4096;      // bin edges in shared memory at a time

struct AdArgs {
  const float* hs;
  const int* idx;
  const int* lens;
  const float* b1;
  const float* g1;
  const float* be1;
  const float* b2;
  const float* g2;
  const float* be2;
  const bf16* wo;
  const float* bo;
  const float* bins;
  const bf16* embw;
  const float* embb;
  float* out;
  float* raw;
  int T, L, D, DW, NB, st, xc;  // DW: w1's and the embeddings' padded width
  float eps;
};

// Tiling of one D; mirrors ops/kernels/adaptor.py:plan (fs2_adaptor_plan
// lets a test hold the two together).
struct AdPlan {
  int kt, st, smem;  // input columns a ring tile, ring stages, bytes
  int xc;            // x tile columns: D rounded up to 16, or AD_XC (chunks)
};

// shared memory beside the ring and the tiles: the rows' expansion indices
// (AD_M + 2), the bucket indices (2 AD_M), three row-sum exchanges (3 x 128
// floats), then the epilogues' parameters of one predictor: conv1's b1, g1,
// be1 (AD_PAR1 bytes) and conv2's b2, g2, be2, wo and nb bin edges
constexpr int AD_IDX = ((3 * AD_M + 2) * 4 + 3 * 128 * 4 + 15) / 16 * 16;
constexpr int AD_PAR1 = 3 * AC * 4;
__host__ __device__ constexpr int ad_misc(int nb) {
  return AD_IDX + AD_PAR1 + AD_PAR1 + AC * 2 + (nb * 4 + 15) / 16 * 16;
}

// Ring tiles of 128 input columns (two 256 x 64 boxes) where two stages
// fit, up to four, else of 64 (one stage at least). Measured on the H100
// (B=16, L=768, D=256): products wait on weight tiles that stream from L2,
// and a tile costs about the same whatever its width, so wider tiles run a
// conv in fewer steps; 64-row blocks (not 128) put twice the SMs to work.
// Where the whole x tile leaves no room for one stage, it holds AD_XC
// columns at a time, beside 64-column ring tiles.
bool ad_make_plan(int D, int NB, AdPlan* pl) {
  if (D < 1 || D > 2048 || NB < 1 || NB > 65536) return false;
  const int dp = (D + 15) / 16 * 16;
  const long misc = ad_misc(std::min(NB, AD_BCH)) + (long)AD_R * AC * 2 + SLACK;
  const long fixed = (long)AD_R * dp * 2 + misc;
  for (int kt = 128; kt >= 64; kt -= 64) {
    const long tile = (long)kt / 64 * AD_SUB;
    const long st = std::min(4L, (SMEM_MAX - fixed) / tile);
    if (st >= (kt == 128 ? 2 : 1)) {
      pl->kt = kt;
      pl->st = (int)st;
      pl->smem = (int)(fixed + st * tile);
      pl->xc = dp;
      return true;
    }
  }
  const long chunked = (long)AD_R * AD_XC * 2 + misc;
  pl->kt = 64;
  pl->st = (int)std::min(4L, (SMEM_MAX - chunked) / AD_SUB);
  pl->smem = (int)(chunked + pl->st * (long)AD_SUB);
  pl->xc = AD_XC;
  return pl->st >= 1;
}

// Block (tile of P = AD_M - 2 frames, batch row); ring tiles of KT input
// columns; CH: the x tile in chunks of a.xc columns. Both warpgroups take
// the block's 64 conv rows, NW = 128 channels each.
template <int KT, bool CH>
__global__ void __launch_bounds__(THREADS, 1)
adaptor_kernel(const __grid_constant__ CUtensorMap tw1, const __grid_constant__ CUtensorMap tw2,
               const __grid_constant__ AdArgs a) {
  constexpr int M = AD_M, P = M - 2, R = AD_R, NW = AC / 2;
  constexpr int TILE = KT / 64 * AD_SUB;
  extern __shared__ unsigned char smem_raw[];
  const int b = blockIdx.y, l0 = blockIdx.x * P, L = a.L, D = a.D;
  const int len = max(0, min(a.lens[b], L));
  if (l0 >= len) {  // dead tile: zeros
    const int rows = min(P, L - l0);
    float* o = a.out + ((size_t)b * L + l0) * D;
    if (D % 4 == 0) {
      float4* o4 = reinterpret_cast<float4*>(o);
      for (int i = threadIdx.x; i < rows * (D / 4); i += THREADS)
        o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int i = threadIdx.x; i < rows * D; i += THREADS) o[i] = 0.f;
    }
    for (int i = threadIdx.x; i < 2 * rows; i += THREADS)
      a.raw[((size_t)b * 2 + i / rows) * L + l0 + i % rows] = 0.f;
    return;
  }
  const int nchx = a.xc / 8;  // x tile chunks: D up to the K step, or a.xc
  unsigned char* ring_g = smem_align1024(smem_raw);
  bf16* xs = reinterpret_cast<bf16*>(ring_g + a.st * TILE);  // [nchx][R][8]
  bf16* h1 = xs + (size_t)nchx * R * 8;                         // [32][R][8]
  int* sidx = reinterpret_cast<int*>(h1 + (size_t)(AC / 8) * R * 8);  // [M + 2]
  int* sb = sidx + M + 2;                                       // [2][M]
  float* red = reinterpret_cast<float*>(sb + 2 * M);            // [3][2][64]
  float* par1 = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sidx) +
                                         AD_IDX);              // b1, g1, be1
  float* par2 = par1 + 3 * AC;                                  // b2, g2, be2
  bf16* wos = reinterpret_cast<bf16*>(par2 + 3 * AC);           // wo
  float* bins = reinterpret_cast<float*>(wos + AC);             // [min(NB, AD_BCH)]
  const int nbs = min(a.NB, AD_BCH);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(sidx) +
                                               ad_misc(nbs));
  // conv1's tiles: a chunk of xc columns (CH) takes 3 * xc / KT, the last
  // 3 * nql; without chunks, one of D columns
  const int nc = CH ? (D + a.xc - 1) / a.xc : 1, nql = (D - (nc - 1) * a.xc + KT - 1) / KT;
  const int nq1 = (D + KT - 1) / KT, nq2 = AC / KT;
  const int n1 = CH ? 3 * ((nc - 1) * (a.xc / KT) + nql) : conv_tiles(3, D, KT);
  const int per = n1 + conv_tiles(3, AC, KT);
  Ring ring{smem_u32(ring_g), ring_g, full, full + a.st, a.st, TILE, 0, 2 * per};
  ring.init();
  __syncthreads();
  // tiles: [conv1 pitch][conv2 pitch][conv1 energy][conv2 energy]; a tile is
  // KT / 64 boxes of 64 columns (one wholly past D loads the first again:
  // no product reads it)
  auto load = [&](int i, unsigned char* dst, uint64_t* bar) {
    const int p = i / per;
    int r = i % per;
    const bool c1 = r < n1;
    int col0, tap;
    if (CH && c1) {  // chunk q, tap, columns of the chunk
      const int pc = 3 * (a.xc / KT), q = r / pc, nqq = q == nc - 1 ? nql : a.xc / KT;
      r -= q * pc;
      tap = r / nqq;
      col0 = q * a.xc + KT * (r % nqq);
    } else {
      const int q = c1 ? nq1 : nq2;
      r -= c1 ? 0 : n1;
      tap = r / q;
      col0 = KT * (r % q);
    }
    const int cin = c1 ? D : AC;
#pragma unroll
    for (int h = 0; h < KT / 64; ++h) {
      const int col = col0 + 64 * h;
      tma_load_3d(dst + h * AD_SUB, c1 ? &tw1 : &tw2, bar, col < cin ? col : col0, tap, p * AC);
    }
  };
  if (threadIdx.x == 0) ring.top_up(0, load);  // every stage is free

  // frames l0 - 2 + e of the x tile and H1's two rows past the conv rows
  const int* idxr = a.idx + (size_t)b * L;
  for (int e = threadIdx.x; e < M + 2; e += THREADS) {
    const int f = l0 - 2 + e;
    sidx[e] = f >= 0 && f < len ? idxr[f] : -1;
  }
  for (int i = threadIdx.x; i < 2 * (AC / 8); i += THREADS)
    reinterpret_cast<uint4*>(h1)[(size_t)(i >> 1) * R + M + (i & 1)] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const float* hsb = a.hs + (size_t)b * a.T * D;
  // x tile columns q xc .. of the gathered rows (CH: fewer loads in flight,
  // as the accumulators stay live across a gather)
  auto gather = [&](int q) {
    const int c0 = q * a.xc;
    by_alignment(D, [&](auto al) {
      load_rows<true, CH ? 4 : 8, decltype(al)::value>(
          xs, R, nchx, min(a.xc, D - c0), M + 2, [&](int e) -> const void* {
            return sidx[e] >= 0 ? hsb + (size_t)sidx[e] * D + c0 : nullptr;
          });
    });
  };
  gather(0);
  fence_proxy_async_smem();  // the products read xs by descriptor
  __syncthreads();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const int rw = warp * 16 + g8;     // tile row of h = 0 (h = 1: + 8)
  const int cb = wg * NW + 2 * t4;   // column of n-tile 0
  const uint32_t boff = wg * NW * 128, lbo = R * 16;

  // sum over the row's 256 channels: the quad, then the two warpgroups
  auto row_sum = [&](float (&s)[2], float* ex) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
    }
    if (t4 == 0) {
      ex[wg * 64 + rw] = s[0];
      ex[wg * 64 + rw + 8] = s[1];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) s[h] = ex[rw + 8 * h] + ex[64 + rw + 8 * h];
  };
  // acc <- LN(relu(round(acc) + bias)) over the row's channels (f32, mean
  // first, biased variance, the plain version's formula)
  // (parameters from shared memory: b, g, be at par, + AC, + 2 AC)
  auto relu_ln = [&](float (&acc)[NW / 2], const float* par) {
    const float2* bias = reinterpret_cast<const float2*>(par + cb);
    const float2* g = reinterpret_cast<const float2*>(par + AC + cb);
    const float2* be = reinterpret_cast<const float2*>(par + 2 * AC + cb);
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int ni = 0; ni < NW / 8; ++ni) {
      const float2 bb = bias[ni * 4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& u = acc[ni * 4 + 2 * h];
        float& w = acc[ni * 4 + 2 * h + 1];
        u = fmaxf(bf16r(u) + bb.x, 0.f);
        w = fmaxf(bf16r(w) + bb.y, 0.f);
        s[h] += u + w;
      }
    }
    row_sum(s, red);
    const float mean[2] = {s[0] / (float)AC, s[1] / (float)AC};
    float q[2] = {0.f, 0.f};
#pragma unroll
    for (int ni = 0; ni < NW / 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float du = acc[ni * 4 + 2 * h] - mean[h], dw = acc[ni * 4 + 2 * h + 1] - mean[h];
        q[h] += du * du + dw * dw;
      }
    row_sum(q, red + 128);
    const float inv[2] = {1.0f / sqrtf(q[0] / (float)AC + a.eps),
                          1.0f / sqrtf(q[1] / (float)AC + a.eps)};
#pragma unroll
    for (int ni = 0; ni < NW / 8; ++ni) {
      const float2 gg = g[ni * 4], bb = be[ni * 4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& u = acc[ni * 4 + 2 * h];
        float& w = acc[ni * 4 + 2 * h + 1];
        u = (u - mean[h]) * inv[h] * gg.x + bb.x;
        w = (w - mean[h]) * inv[h] * gg.y + bb.y;
      }
    }
  };

  int it0 = 0;
  for (int p = 0; p < 2; ++p) {  // 0 = pitch, 1 = energy (the reference's order)
    {  // conv1: H1 row m <-> frame l0 - 1 + m
      // its parameters load while the products run (par1's last reader,
      // the previous conv1 epilogue, ended at a barrier)
      stage_params(par1, a.b1 + p * AC, AC * 4);
      stage_params(par1 + AC, a.g1 + p * AC, AC * 4);
      stage_params(par1 + 2 * AC, a.be1 + p * AC, AC * 4);
      float acc[NW / 2];
      if constexpr (!CH) {
        conv_product<NW, KT>(acc, ring, load, it0, smem_u32(xs), lbo, boff, AD_SUB, 3, D);
        it0 += conv_tiles(3, D, KT);
      } else {
        if (p > 0) {  // the x tile holds the last chunk (the previous conv1
                      // epilogue's barrier ended its products): the first again
          gather(0);
          fence_proxy_async_smem();
          __syncthreads();
        }
        conv_product<NW, KT>(acc, ring, load, it0, smem_u32(xs), lbo, boff, AD_SUB, 3, a.xc);
        it0 += conv_tiles(3, a.xc, KT);
        for (int q = 1; q < nc; ++q) {
          __syncthreads();  // every warp's products have read chunk q - 1
          gather(q);
          fence_proxy_async_smem();
          __syncthreads();
          const int cw = min(a.xc, D - q * a.xc);
          conv_product<NW, KT, true>(acc, ring, load, it0, smem_u32(xs), lbo, boff, AD_SUB, 3,
                                     cw);
          it0 += conv_tiles(3, cw, KT);
        }
      }
      if (threadIdx.x == 0) ring.top_up(0, load);
      cp_async_wait<0>();
      __syncthreads();  // the previous predictor's conv2 no longer reads H1; par1 landed
      relu_ln(acc, par1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rw + 8 * h, f = l0 - 1 + r;
        const bool live = f >= 0 && f < len;
#pragma unroll
        for (int ni = 0; ni < NW / 8; ++ni)
          store_pair(h1, R, r, cb + ni * 8, live ? acc[ni * 4 + 2 * h] : 0.f,
                     live ? acc[ni * 4 + 2 * h + 1] : 0.f);
      }
      fence_proxy_async_smem();  // conv2 reads H1 by descriptor
      __syncthreads();
    }
    {  // conv2: row r <-> frame l0 + r
      // par2, wo and the first bin edges load while the products run (their
      // last reader, the previous conv2 epilogue, ended before the barrier
      // of this predictor's conv1 epilogue)
      stage_params(par2, a.b2 + p * AC, AC * 4);
      stage_params(par2 + AC, a.g2 + p * AC, AC * 4);
      stage_params(par2 + 2 * AC, a.be2 + p * AC, AC * 4);
      stage_params(wos, a.wo + p * AC, AC * 2);
      for (int i = threadIdx.x; i < nbs; i += THREADS)
        bins[i] = __ldg(a.bins + (size_t)p * a.NB + i);
      float acc[NW / 2];
      conv_product<NW, KT>(acc, ring, load, it0, smem_u32(h1), lbo, boff, AD_SUB, 3, AC);
      it0 += conv_tiles(3, AC, KT);
      if (threadIdx.x == 0) ring.top_up(0, load);
      cp_async_wait<0>();
      __syncthreads();  // par2, wo and the bins landed
      relu_ln(acc, par2);
      float y[2] = {0.f, 0.f};
#pragma unroll
      for (int ni = 0; ni < NW / 8; ++ni) {
        const float2 wv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(wos + cb + ni * 8));
#pragma unroll
        for (int h = 0; h < 2; ++h)
          y[h] += bf16r(acc[ni * 4 + 2 * h]) * wv.x + bf16r(acc[ni * 4 + 2 * h + 1]) * wv.y;
      }
      row_sum(y, red + 256);
      // both warpgroups hold the rows' predictions: warpgroup wg counts the
      // edges strictly below that of row rw + 8 wg (the JAX formula), AD_BCH
      // edges at a time
      const float rv = bf16r(wg == 0 ? y[0] : y[1]) + a.bo[p];
      int cnt = 0;
      for (int c0 = 0;;) {
        const int nb = min(AD_BCH, a.NB - c0);
#pragma unroll 8
        for (int i = t4; i < nb; i += 4) cnt += bins[i] < rv ? 1 : 0;
        c0 += AD_BCH;
        if (c0 >= a.NB) break;
        __syncthreads();  // every thread has counted this chunk
        for (int i = threadIdx.x; i < min(AD_BCH, a.NB - c0); i += THREADS)
          bins[i] = __ldg(a.bins + (size_t)p * a.NB + c0 + i);
        __syncthreads();
      }
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 1);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 2);
      const int r = rw + 8 * wg, f = l0 + r;
      if (t4 == 0 && r < P) {
        sb[p * M + r] = min(cnt, a.NB - 1);
        if (f < L) a.raw[((size_t)b * 2 + p) * L + f] = f < len ? rv : 0.f;
      }
    }
  }
  __syncthreads();

  // out = (e + (emb_p + embb_p)) + (emb_e + embb_e), zero past len; a
  // thread takes 8 columns of a row, UO such items loaded before any is
  // computed; e and out at the alignment A of D, the embeddings (DW wide)
  // as 16-byte rows
  by_alignment(D, [&](auto al) {
    constexpr int A = decltype(al)::value, UO = 4;
    const int n8 = (D + 7) / 8, rows = min(P, L - l0), items = rows * n8, DW = a.DW;
    const float4* eb = reinterpret_cast<const float4*>(a.embb);
    for (int i0 = threadIdx.x; i0 < items; i0 += UO * THREADS) {
      float4 ev[UO][2];
      uint4 pw[UO], ew[UO];
#pragma unroll
      for (int q = 0; q < UO; ++q) {
        const int i = i0 + q * THREADS, r = i / n8, c = i % n8;
        if (i < items && l0 + r < len) {
          load8_f32<A>(hsb + (size_t)sidx[r + 2] * D, 8 * c, D, ev[q][0], ev[q][1]);
          pw[q] = reinterpret_cast<const uint4*>(a.embw + (size_t)sb[r] * DW)[c];
          ew[q] = reinterpret_cast<const uint4*>(a.embw + ((size_t)a.NB + sb[M + r]) * DW)[c];
        }
      }
#pragma unroll
      for (int q = 0; q < UO; ++q) {
        const int i = i0 + q * THREADS, r = i / n8, c = i % n8, f = l0 + r;
        if (i >= items) continue;
        float4 v[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
        if (f < len) {
          const __nv_bfloat162* pp = reinterpret_cast<const __nv_bfloat162*>(&pw[q]);
          const __nv_bfloat162* ep = reinterpret_cast<const __nv_bfloat162*>(&ew[q]);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float4 e = ev[q][k], pb = eb[2 * c + k], qb = eb[DW / 4 + 2 * c + k];
            const float2 p0 = __bfloat1622float2(pp[2 * k]), p1 = __bfloat1622float2(pp[2 * k + 1]);
            const float2 q0 = __bfloat1622float2(ep[2 * k]), q1 = __bfloat1622float2(ep[2 * k + 1]);
            v[k] = make_float4((e.x + (p0.x + pb.x)) + (q0.x + qb.x),
                               (e.y + (p0.y + pb.y)) + (q0.y + qb.y),
                               (e.z + (p1.x + pb.z)) + (q1.x + qb.z),
                               (e.w + (p1.y + pb.w)) + (q1.y + qb.w));
          }
        }
        float* o = a.out + ((size_t)b * L + f) * D + 8 * c;
        if (A == 8) {
          reinterpret_cast<float4*>(o)[0] = v[0];
          reinterpret_cast<float4*>(o)[1] = v[1];
        } else if (A == 4) {
          reinterpret_cast<float4*>(o)[0] = v[0];
          if (8 * c + 4 < D) reinterpret_cast<float4*>(o)[1] = v[1];
        } else {
          const float vv[8] = {v[0].x, v[0].y, v[0].z, v[0].w, v[1].x, v[1].y, v[1].z, v[1].w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (8 * c + j < D) o[j] = vv[j];
        }
      }
    }
  });
}

template <int KT, bool CH>
cudaError_t launch_adaptor(const CUtensorMap& tw1, const CUtensorMap& tw2, const AdArgs& a,
                           const AdPlan& pl, int B, cudaStream_t stream) {
  cudaError_t e = set_smem(adaptor_kernel<KT, CH>, pl.smem);
  if (e != cudaSuccess) return e;
  constexpr int P = AD_M - 2;
  adaptor_kernel<KT, CH><<<dim3((a.L + P - 1) / P, B), THREADS, pl.smem, stream>>>(tw1, tw2, a);
  return cudaGetLastError();
}

}  // namespace

// hs (B,T,D) f32; idx (B,L) i32; lens (B) i32 (out_lens);
// w1 (2, C, 3*DW) bf16 [(out, tap, in)], DW = D rounded up to 8, zero
// columns past D in each tap; w2 (2, C, 3*C) bf16;
// b1/g1/be1/b2/g2/be2 (2, C) f32; wo (2, C) bf16; bo (2) f32;
// bins (2, NB) f32 (last edge +inf); embw (2, NB, DW) bf16; embb (2, DW) f32
// (zeros past D); out (B, L, D) f32; raw (B, 2, L) f32. Index 0 is pitch, 1
// energy. C = 256; D from 1 to 2048; 1 to 65536 bin edges.
FS2_EXPORT int fs2_variance_adaptor(
    const float* hs, const int* idx, const int* lens, const bf16* w1,
    const float* b1, const float* g1, const float* be1, const bf16* w2,
    const float* b2, const float* g2, const float* be2, const bf16* wo,
    const float* bo, const float* bins, const bf16* embw, const float* embb,
    float* out, float* raw, int B, int T, int L, int D, int C, int NB,
    float eps, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  AdPlan pl;
  if (C != AC || B < 1 || T < 1 || L < 1 || !ad_make_plan(D, NB, &pl))
    return (int)cudaErrorInvalidValue;
  const int DW = (D + 7) / 8 * 8;
  CUtensorMap tw1, tw2;
  cudaError_t e;
  if ((e = tma_map_bf16_taps(&tw1, w1, D, 3, 2 * AC, DW, AC)) != cudaSuccess ||
      (e = tma_map_bf16_taps(&tw2, w2, AC, 3, 2 * AC, AC, AC)) != cudaSuccess)
    return (int)e;
  const AdArgs a{hs, idx, lens, b1, g1, be1, b2, g2, be2, wo, bo, bins, embw, embb,
                 out, raw, T, L, D, DW, NB, pl.st, pl.xc, eps};
  if (pl.xc < D) return (int)launch_adaptor<64, true>(tw1, tw2, a, pl, B, stream);
  return (int)(pl.kt == 128 ? launch_adaptor<128, false>(tw1, tw2, a, pl, B, stream)
                            : launch_adaptor<64, false>(tw1, tw2, a, pl, B, stream));
}

// The tiling chosen for D and NB bin edges, as ops/kernels/adaptor.py:plan
// gives it: kt, st, smem, xc into out[0..3]. Returns 0, or
// cudaErrorInvalidValue for a shape the kernel does not take.
FS2_EXPORT int fs2_adaptor_plan(int D, int NB, int* out) {
  AdPlan pl;
  if (!ad_make_plan(D, NB, &pl)) return (int)cudaErrorInvalidValue;
  out[0] = pl.kt;
  out[1] = pl.st;
  out[2] = pl.smem;
  out[3] = pl.xc;
  return 0;
}
