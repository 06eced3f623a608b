// Tacotron-2 postnet on the H100: n stages of
//   conv k (no bias) -> inference BatchNorm -> tanh (none on the last),
// each stage's input re-zeroed outside [0, length); the output is the
// residual added to the mel. Tiles wholly past length + halo give the last
// stage's BatchNorm of a zero input.
//
// Replaces fastspeech2_tpu/ops/pallas/postnet.py: fused_postnet (kernel
// _postnet_kernel).
//
// Bound on the H100: 2*k*(80*256 + 3*256*256 + 256*80) ~ 2.4 MFLOP per frame
// against 640 bytes of f32 mel in and out: ~3,700 FLOP/byte -- tensor-core
// (operations) bound. What a block reads again is the weights: 2.4 MB for
// 5 x k=5 at 256 channels, for every tile of frames.
//
// Design (sm_90a; csrc/conv_chain.cuh on hopper.cuh and ffn_body.cuh). One
// launch of two warpgroups (256 threads) per chain, or per part of one (see
// below). A block covers P output frames of one batch row and keeps the
// whole chain in ONE bf16 buffer in shared memory, the row-shifted
// [C/8][rows][8] tile of ffn_body.cuh: the first stage's input rows (the
// tile plus the chain's halo, zero outside [0, length)) are loaded into it,
// and each stage is one K = k * Cin wgmma product over it against the
// stage's (Cout, k, Cin) weights, streamed through a TMA ring that thread 0
// keeps topped up (refilling while the products run, and across stages:
// the next stage's tiles load during an epilogue). The stage's BatchNorm
// rows load into shared memory with cp.async while its products run. A
// stage's output stays in registers until every warp's products have read
// the buffer; then its epilogue -- BN as ((round(acc) - mean) * inv) * g +
// b, tanh, the frame mask -- writes it back in bf16 over its own input,
// shifted by the conv's pad. The last stage writes f32 rows.
// Stage rows M = 128 (each warpgroup 64 rows x all columns; ring tiles of
// 128 input columns) where the channels fit one warpgroup's accumulators
// (C <= 256), else M = 64 (both warpgroups the same rows, half the columns
// each; ring tiles of 64 columns x 512 rows); P = M - (s - 1)(k - 1) for s
// stages. A chain whose P would fall under M / 2 is cut into launches of
// fewer stages; bf16 scratch planes (B, L, CS), CS = C rounded up to 16,
// carry the masked rows from one launch to the next, two of them in turn
// past two launches (a launch cannot write the plane it reads: its
// neighbours read its halo rows) (`pn_make_plan`). Widths: any C and C0
// (the map zero-fills each tap to the K step; the mel is read and the
// residual written at the alignment of C0; columns past a width are
// written as zeros into the planes and the buffer and never stored into
// the residual); the wgmma widths are rounded up to the kernels
// instantiated below. One layer is a chain whose first stage is the last
// (C0 -> C0, no tanh). Where the chain does not fit (C > 512, C0 > 256, or
// a buffer of k - 1 halo rows a stage that leaves no room for two ring
// stages), `postnet_wide_kernel` runs one launch a stage: 128 frames x 256
// output columns a block, its input streamed through shared memory in
// chunks of 256 columns, the accumulators carried across them, through the
// same planes. What bounds it here (clock64 phases on the H100, B=16, L=768, C =
// 256): the products wait on weight tiles from L2 (each block streams 2.4
// MB; a 128-column tile costs about what a 64-column one does), and the
// epilogues' exact tanhf about half of each epilogue.
#include "conv_chain.cuh"

namespace {

struct PnArgs {
  const void* x;    // the first launch: (B, L, C0) f32; later: a (B, L, CS) bf16 plane
  const float* bn;  // (n, 4, CB) rows [mean, rsqrt(var + eps), gamma, beta]
  const int* lens;
  void* out;        // the last launch: (B, L, C0) f32; earlier: a (B, L, CS) bf16 plane
  int L, C0, C, n, K, CB, CS, i0, i1, st;
};

// The wide path: output columns a block, input columns a chunk of the x tile
constexpr int PN_WN = 256, PN_WXC = 256;

// Tiling of one postnet; mirrors ops/kernels/postnet.py:plan (fs2_postnet_plan
// lets a test hold the two together).
struct PnPlan {
  int wr;    // 2: 128-row stages, each warpgroup all columns; 1: 64-row
             // stages, the warpgroups split the columns; 0: the wide path,
             // one launch a stage
  int nh;    // hidden stages' output columns a warpgroup (wgmma N)
  int nl;    // the last stage's output columns a warpgroup
  int st;    // ring stages
  int smem;  // bytes
  int spl;   // stages a launch (the last launch takes the rest)
};

__host__ __device__ constexpr int round16(int c) { return (c + 15) / 16 * 16; }

bool pn_make_plan(int C0, int C, int K, int n, PnPlan* pl) {
  if (C0 < 1 || C < 1 || C0 > 1024 || C > 1024 || K % 2 != 1 || K < 1 || K > 31 || n < 1 ||
      n > 32)
    return false;
  const int cp = round16(C), c0p = round16(C0);
  if (cp <= 512 && c0p <= 256) {
    int sb;
    if (cp <= 256) {
      pl->wr = 2;
      pl->nh = cp <= 128 ? 128 : 256;
      pl->nl = c0p <= 80 ? 80 : c0p <= 128 ? 128 : 256;
      sb = 2 * std::max(pl->nh, pl->nl) * 128;  // 128 input columns a tile
    } else {
      pl->wr = 1;
      pl->nh = 256;
      pl->nl = c0p <= 96 ? 48 : c0p <= 128 ? 64 : 128;
      sb = 2 * 256 * 128;
    }
    const int m = 64 * pl->wr, R = (m + K - 1) | 1;
    // the chain's buffer, then a stage's BatchNorm rows (4 x max(C, C0) f32)
    const long buf = (long)std::max(cp, c0p) * R * 2 + 16L * std::max(C, C0);
    const long st = std::min(4L, (SMEM_MAX - SLACK - buf) / sb);
    if (st >= 2) {
      pl->st = (int)st;
      pl->smem = (int)(buf + st * sb + SLACK);
      pl->spl = K == 1 ? n : std::min(n, 1 + (m / 2) / (K - 1));
      return true;
    }
  }
  // the wide path: the x tile of 128 + k - 1 rows (odd) x PN_WXC columns, the
  // part's BatchNorm rows (4 x PN_WN f32), ring tiles of 128 input columns x
  // PN_WN rows
  const long buf = (long)PN_WXC * ((128 + K - 1) | 1) * 2 + 16L * PN_WN;
  const long sb = 2L * PN_WN * 128;
  const long st = std::min(4L, (SMEM_MAX - SLACK - buf) / sb);
  pl->wr = 0;
  pl->nh = pl->nl = PN_WN;
  pl->st = (int)st;
  pl->smem = (int)(buf + st * sb + SLACK);
  pl->spl = 1;
  return st >= 2;
}

// Columns n, n + 1 (n even) of an f32 residual row of C0 columns at o (the
// row's column n), rest = C0 - n > 0: one 8-byte store where C0 is even,
// else each column that exists.
__device__ __forceinline__ void store_out_pair(float* o, int rest, float u, float w) {
  if ((rest & 1) == 0) {  // C0 even: o is 8-byte aligned and n + 1 < C0
    *reinterpret_cast<float2*>(o) = make_float2(u, w);
  } else {
    o[0] = u;
    if (rest > 1) o[1] = w;
  }
}

// Block (tile of P output frames, batch row) over stages i0 .. i1 - 1. A
// ring tile: M = 128, 128 input columns of max(NH, NL) output rows (two
// boxes); M = 64, 64 input columns of 512 rows (the two warpgroups' boxes).
template <int WR, int NH, int NL>
__global__ void __launch_bounds__(THREADS, 1)
postnet_kernel(const __grid_constant__ CUtensorMap tfirst, const __grid_constant__ CUtensorMap thid,
               const __grid_constant__ CUtensorMap tlast, const __grid_constant__ PnArgs a) {
  constexpr int M = 64 * WR, KT = WR == 2 ? 128 : 64;
  constexpr int SB = 2 * (WR == 2 ? (NH > NL ? NH : NL) : 256) * 128;
  extern __shared__ unsigned char smem_raw[];
  const int pad = (a.K - 1) / 2, S = a.i1 - a.i0, H = S * pad, P = M - (S - 1) * 2 * pad;
  const int R = (M + a.K - 1) | 1, L = a.L, C = a.C, C0 = a.C0;
  const int b = blockIdx.y, t0 = blockIdx.x * P;
  const int len = max(0, min(a.lens[b], L));
  const bool last_launch = a.i1 == a.n;
  if (t0 >= len + (last_launch ? H : 0)) {
    // the last launch: every row's input is zero, so its output is the
    // last stage's BN of zero; earlier launches: the next launch's loader
    // zeroes these rows (past the length) and reads nothing of them
    if (last_launch) {
      const float* s = a.bn + (size_t)(a.n - 1) * 4 * a.CB;
      const int rows = min(P, L - t0);
      float* o = reinterpret_cast<float*>(a.out) + ((size_t)b * L + t0) * C0;
      for (int i = threadIdx.x; i < rows * C0; i += THREADS) {
        const int c = i % C0;
        o[i] = ((0.f - s[c]) * s[a.CB + c]) * s[2 * a.CB + c] + s[3 * a.CB + c];
      }
    }
    return;
  }
  const int cin0 = a.i0 == 0 ? C0 : C, nch = round16(max(C0, C)) / 8;
  unsigned char* ring_g = smem_align1024(smem_raw);
  bf16* xs = reinterpret_cast<bf16*>(ring_g + a.st * SB);  // [nch][R][8]
  float* par = reinterpret_cast<float*>(xs + (size_t)nch * R * 8);  // [4][CB] of a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(par + 4 * a.CB);
  const int total = conv_tiles(a.K, cin0, KT) + (S - 1) * conv_tiles(a.K, C, KT);
  Ring ring{smem_u32(ring_g), ring_g, full, full + a.st, a.st, SB, 0, total};
  ring.init();
  __syncthreads();
  // tile i of the launch: stage i0 + s, tap j, input columns KT q ..
  const int n0 = conv_tiles(a.K, cin0, KT), nq0 = (cin0 + KT - 1) / KT, nq = (C + KT - 1) / KT;
  auto load = [&](int i, unsigned char* dst, uint64_t* bar) {
    int s = 0, q = nq0;
    if (i >= n0) {
      s = 1 + (i - n0) / conv_tiles(a.K, C, KT);
      i = (i - n0) % conv_tiles(a.K, C, KT);
      q = nq;
    }
    const int g = a.i0 + s;
    // (one layer: the first stage is the last, whose map is the first's)
    const CUtensorMap* m = g == 0 ? &tfirst : g == a.n - 1 ? &tlast : &thid;
    const int row = g == 0 || g == a.n - 1 ? 0 : (g - 1) * C;
    const int col = KT * (i % q), j = i / q;
    tma_load_3d(dst, m, bar, col, j, row);
    if (WR == 2) {  // the second 64 columns (wholly past Cin: the first again, unread)
      const int cin = g == 0 ? C0 : C;
      tma_load_3d(dst + SB / 2, m, bar, col + 64 < cin ? col + 64 : col, j, row);
    } else {  // the second warpgroup's rows (the last stage's fit the first
              // box: its tile is that box twice, so every tile is SB bytes)
      tma_load_3d(dst + SB / 2, m, bar, col, j, g == a.n - 1 ? row : row + 256);
    }
  };
  if (threadIdx.x == 0) ring.top_up(0, load);  // every stage is free

  // the first stage's input: frames t0 - H + e, zero outside [0, len)
  const int rows_in = M + a.K - 1, tb = t0 - H;
  const size_t row0 = (size_t)b * L;
  if (a.i0 == 0) {
    const float* x = reinterpret_cast<const float*>(a.x);
    by_alignment(C0, [&](auto al) {
      load_rows<true, 8, decltype(al)::value>(xs, R, nch, C0, rows_in, [&](int e) -> const void* {
        const int t = tb + e;
        return t >= 0 && t < len ? x + (row0 + t) * C0 : nullptr;
      });
    });
  } else {
    const bf16* x = reinterpret_cast<const bf16*>(a.x);
    load_rows<false>(xs, R, nch, a.CS, rows_in, [&](int e) -> const void* {
      const int t = tb + e;
      return t >= 0 && t < len ? x + (row0 + t) * a.CS : nullptr;
    });
  }
  fence_proxy_async_smem();  // the products read xs by descriptor
  __syncthreads();

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const int rw = (WR == 2 ? wg * 64 : 0) + warp * 16 + g8;  // tile row of h = 0 (h = 1: + 8)
  const uint32_t xa = smem_u32(xs) + (WR == 2 ? wg * 64 * 16 : 0), lbo = R * 16;
  const int cp = round16(C);
  int it0 = 0;
  for (int s = 0; s < S; ++s) {
    const int g = a.i0 + s, cin = g == 0 ? C0 : C;
    // the stage's BatchNorm rows load while its products run (the previous
    // epilogue, which read them, ended at a barrier)
    stage_params(par, a.bn + (size_t)g * 4 * a.CB, 16 * a.CB);
    const float2* mean = reinterpret_cast<const float2*>(par);
    const float2* inv = reinterpret_cast<const float2*>(par + a.CB);
    const float2* gam = reinterpret_cast<const float2*>(par + 2 * a.CB);
    const float2* bet = reinterpret_cast<const float2*>(par + 3 * a.CB);
    const int fb = tb + (s + 1) * pad;  // frame of output row 0
    if (g < a.n - 1) {
      float acc[NH / 2];
      const int cb = opaque((WR == 2 ? 0 : wg * NH) + 2 * t4);  // column of n-tile 0
      conv_product<NH, KT>(acc, ring, load, it0, xa, lbo, WR == 2 ? 0 : wg * NH * 128, SB / 2,
                           a.K, cin);
      it0 += conv_tiles(a.K, cin, KT);
      if (threadIdx.x == 0) ring.top_up(0, load);
      const bool to_smem = s + 1 < S;
      cp_async_wait<0>();
      __syncthreads();  // every product has read the buffer; the BN rows landed
#pragma unroll
      for (int ni = 0; ni < NH / 8; ++ni) {
        const int n = cb + ni * 8;
        if (n >= cp) continue;  // n + 1 < cp too
        // (mean, inv, g, b) of columns n, n + 1 (CB is even: n + 1 < CB
        // where n < C); columns at or past C are written as zeros
        const bool in = n < C, in1 = n + 1 < C;
        const float2 z2 = make_float2(0.f, 0.f);
        const float2 mu = in ? mean[n / 2] : z2, iv = in ? inv[n / 2] : z2;
        const float2 ga = in ? gam[n / 2] : z2, be = in ? bet[n / 2] : z2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rw + 8 * h, f = fb + r;
          const bool live = in && f >= 0 && f < len;
          const float y0 = tanhf(((bf16r(acc[ni * 4 + 2 * h]) - mu.x) * iv.x) * ga.x + be.x);
          const float y1 = tanhf(((bf16r(acc[ni * 4 + 2 * h + 1]) - mu.y) * iv.y) * ga.y + be.y);
          const float v[2] = {live ? y0 : 0.f, live && in1 ? y1 : 0.f};
          if (to_smem) {
            store_pair(xs, R, r, n, v[0], v[1]);
          } else if (r < P && f < L) {  // the next launch's input (n < CS)
            *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(a.out) + (row0 + f) * a.CS +
                                         n) = pack_bf16(v[0], v[1]);
          }
        }
      }
      if (to_smem) {
        fence_proxy_async_smem();  // the next stage reads xs by descriptor
        __syncthreads();
      }
    } else {
      float acc[NL / 2];
      const int cb = opaque((WR == 2 ? 0 : wg * NL) + 2 * t4);
      conv_product<NL, KT>(acc, ring, load, it0, xa, lbo, WR == 2 ? 0 : wg * NL * 128, SB / 2,
                           a.K, cin);
      cp_async_wait<0>();
      __syncthreads();  // the BN rows landed
      float* out = reinterpret_cast<float*>(a.out);
#pragma unroll
      for (int ni = 0; ni < NL / 8; ++ni) {
        const int n = cb + ni * 8;
        if (n >= C0) continue;  // CB is even: n + 1 < CB
        const float2 mu = mean[n / 2], iv = inv[n / 2], ga = gam[n / 2], be = bet[n / 2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rw + 8 * h, f = fb + r;
          if (r >= P || f >= L) continue;
          store_out_pair(out + (row0 + f) * C0 + n, C0 - n,
                         ((bf16r(acc[ni * 4 + 2 * h]) - mu.x) * iv.x) * ga.x + be.x,
                         ((bf16r(acc[ni * 4 + 2 * h + 1]) - mu.y) * iv.y) * ga.y + be.y);
        }
      }
    }
  }
}

template <int WR, int NH, int NL>
cudaError_t launch_tile(const CUtensorMap (&maps)[3], const PnArgs& a, const PnPlan& pl, dim3 grid,
                        cudaStream_t stream) {
  cudaError_t e = set_smem(postnet_kernel<WR, NH, NL>, pl.smem);
  if (e != cudaSuccess) return e;
  postnet_kernel<WR, NH, NL><<<grid, THREADS, pl.smem, stream>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

// The instantiated widths: (WR, NH, NL) of the plan.
cudaError_t launch_stages(const CUtensorMap (&maps)[3], const PnArgs& a, const PnPlan& pl,
                          dim3 grid, cudaStream_t stream) {
  if (pl.wr == 1) {
    if (pl.nl == 48) return launch_tile<1, 256, 48>(maps, a, pl, grid, stream);
    if (pl.nl == 64) return launch_tile<1, 256, 64>(maps, a, pl, grid, stream);
    return launch_tile<1, 256, 128>(maps, a, pl, grid, stream);
  }
  if (pl.nh == 128) {
    if (pl.nl == 80) return launch_tile<2, 128, 80>(maps, a, pl, grid, stream);
    if (pl.nl == 128) return launch_tile<2, 128, 128>(maps, a, pl, grid, stream);
    return launch_tile<2, 128, 256>(maps, a, pl, grid, stream);
  }
  if (pl.nl == 80) return launch_tile<2, 256, 80>(maps, a, pl, grid, stream);
  if (pl.nl == 128) return launch_tile<2, 256, 128>(maps, a, pl, grid, stream);
  return launch_tile<2, 256, 256>(maps, a, pl, grid, stream);
}

// One stage of the wide path (`pn_make_plan`'s wr = 0): a block computes
// M = 128 output frames (64 a warpgroup) x PN_WN output columns (part
// blockIdx.y) of the stage, its input rows t0 - pad .. t0 + M + pad - 1
// streamed through the x tile PN_WXC columns at a time, each chunk's k taps
// x ceil(cw / 128) ring tiles added to the same accumulators (every tile's
// products retired before the next; a chunk's tiles before the next chunk
// is gathered). The first stage reads the f32 mel, the others a bf16 plane;
// the last writes the f32 residual, the others a plane (zeros past the
// length and past C). Tiles of a hidden stage at or past the length write
// nothing (the next stage's loader reads none of those rows); of the last,
// at or past len + pad, the BN of zero.
struct PnWideArgs {
  const void* x;    // the first stage: (B, L, cin) f32; later: a (B, L, CS) bf16 plane
  const float* bn;  // the stage's rows [mean, inv, gamma, beta], CB floats apart
  const int* lens;
  void* out;        // the last stage: (B, L, cout) f32; earlier: a (B, L, CS) bf16 plane
  int L, cin, cout, K, CB, CS, first, last, st;
};

__global__ void __launch_bounds__(THREADS, 1)
postnet_wide_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ PnWideArgs a) {
  constexpr int M = 128, KT = 128, NW = PN_WN, SB = 2 * NW * 128, NCH = PN_WXC / 8;
  extern __shared__ unsigned char smem_raw[];
  const int pad = (a.K - 1) / 2, R = (M + a.K - 1) | 1, L = a.L;
  const int b = blockIdx.z, c00 = blockIdx.y * NW, t0 = blockIdx.x * M;
  const int len = max(0, min(a.lens[b], L));
  const size_t row0 = (size_t)b * L;
  if (t0 >= len + (a.last ? pad : 0)) {
    if (a.last) {  // every input row of the tile is zero: the BN of zero
      const float* s = a.bn;
      const int rows = min(M, L - t0), nc = min(NW, a.cout - c00);
      float* o = reinterpret_cast<float*>(a.out) + (row0 + t0) * a.cout + c00;
      for (int i = threadIdx.x; i < rows * nc; i += THREADS) {
        const int c = c00 + i % nc;
        o[(size_t)(i / nc) * a.cout + i % nc] =
            ((0.f - s[c]) * s[a.CB + c]) * s[2 * a.CB + c] + s[3 * a.CB + c];
      }
    }
    return;
  }
  unsigned char* ring_g = smem_align1024(smem_raw);
  bf16* xs = reinterpret_cast<bf16*>(ring_g + a.st * SB);            // [NCH][R][8]
  float* par = reinterpret_cast<float*>(xs + (size_t)NCH * R * 8);  // [4][NW]
  uint64_t* full = reinterpret_cast<uint64_t*>(par + 4 * NW);
  const int nc = (a.cin + PN_WXC - 1) / PN_WXC, pc = a.K * (PN_WXC / KT);
  const int nql = (a.cin - (nc - 1) * PN_WXC + KT - 1) / KT;
  Ring ring{smem_u32(ring_g), ring_g, full, full + a.st, a.st, SB, 0, (nc - 1) * pc + a.K * nql};
  ring.init();
  // the part's BatchNorm rows, zeros past cout (read after the first barrier
  // below the products)
  for (int i = threadIdx.x; i < 4 * NW; i += THREADS) {
    const int c = c00 + i % NW;
    par[i] = c < a.cout ? a.bn[(size_t)(i / NW) * a.CB + c] : 0.f;
  }
  __syncthreads();
  // tile i: chunk q, tap j, input columns 128 (i % nq) of the chunk, as two
  // boxes of 64 columns x NW rows (a second box wholly past cin: the first
  // again, unread)
  auto load = [&](int i, unsigned char* dst, uint64_t* bar) {
    const int q = i / pc, r = i - q * pc, nqq = q == nc - 1 ? nql : PN_WXC / KT;
    const int j = r / nqq, col = q * PN_WXC + KT * (r % nqq);
    tma_load_3d(dst, &tw, bar, col, j, c00);
    tma_load_3d(dst + SB / 2, &tw, bar, col + 64 < a.cin ? col + 64 : col, j, c00);
  };
  if (threadIdx.x == 0) ring.top_up(0, load);  // every stage is free

  // input rows t0 - pad + e, zero outside [0, len), columns q PN_WXC .. (the
  // accumulators stay live across a gather: four items in flight)
  const int tb = t0 - pad, rows_in = M + a.K - 1;
  auto gather = [&](int q) {
    const int c0 = q * PN_WXC;
    if (a.first) {
      const float* x = reinterpret_cast<const float*>(a.x);
      by_alignment(a.cin, [&](auto al) {
        load_rows<true, 4, decltype(al)::value>(
            xs, R, NCH, min(PN_WXC, a.cin - c0), rows_in, [&](int e) -> const void* {
              const int t = tb + e;
              return t >= 0 && t < len ? x + (row0 + t) * a.cin + c0 : nullptr;
            });
      });
    } else {  // the plane's columns past cin are zeros (CS = cin rounded up to 16)
      const bf16* x = reinterpret_cast<const bf16*>(a.x);
      load_rows<false, 4>(xs, R, NCH, min(PN_WXC, a.CS - c0), rows_in,
                          [&](int e) -> const void* {
                            const int t = tb + e;
                            return t >= 0 && t < len ? x + (row0 + t) * a.CS + c0 : nullptr;
                          });
    }
  };
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const int rw = wg * 64 + warp * 16 + g8;  // tile row of h = 0 (h = 1: + 8)
  const uint32_t xa = smem_u32(xs) + wg * 64 * 16, lbo = R * 16;
  float acc[NW / 2];
  gather(0);
  fence_proxy_async_smem();  // the products read xs by descriptor
  __syncthreads();
  conv_product<NW, KT>(acc, ring, load, 0, xa, lbo, 0, SB / 2, a.K, min(PN_WXC, a.cin));
  int it = conv_tiles(a.K, min(PN_WXC, a.cin), KT);
  for (int q = 1; q < nc; ++q) {
    __syncthreads();  // every warp's products have read chunk q - 1
    gather(q);
    fence_proxy_async_smem();
    __syncthreads();
    const int cw = min(PN_WXC, a.cin - q * PN_WXC);
    conv_product<NW, KT, true>(acc, ring, load, it, xa, lbo, 0, SB / 2, a.K, cw);
    it += conv_tiles(a.K, cw, KT);
  }

  const float2* mean = reinterpret_cast<const float2*>(par);
  const float2* inv = reinterpret_cast<const float2*>(par + NW);
  const float2* gam = reinterpret_cast<const float2*>(par + 2 * NW);
  const float2* bet = reinterpret_cast<const float2*>(par + 3 * NW);
  const int cb = opaque(2 * t4);  // column of n-tile 0 in the part
  if (!a.last) {
    bf16* out = reinterpret_cast<bf16*>(a.out);
#pragma unroll
    for (int ni = 0; ni < NW / 8; ++ni) {
      const int n = cb + ni * 8, gc = c00 + n;
      if (gc >= a.CS) continue;  // CS is even: gc + 1 < CS too
      const bool in = gc < a.cout, in1 = gc + 1 < a.cout;
      const float2 mu = mean[n / 2], iv = inv[n / 2], ga = gam[n / 2], be = bet[n / 2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = t0 + rw + 8 * h;
        if (f >= L) continue;
        const bool live = f < len;
        const float y0 = tanhf(((bf16r(acc[ni * 4 + 2 * h]) - mu.x) * iv.x) * ga.x + be.x);
        const float y1 = tanhf(((bf16r(acc[ni * 4 + 2 * h + 1]) - mu.y) * iv.y) * ga.y + be.y);
        *reinterpret_cast<uint32_t*>(out + (row0 + f) * a.CS + gc) =
            pack_bf16(live && in ? y0 : 0.f, live && in1 ? y1 : 0.f);
      }
    }
  } else {
    float* out = reinterpret_cast<float*>(a.out);
#pragma unroll
    for (int ni = 0; ni < NW / 8; ++ni) {
      const int n = cb + ni * 8, gc = c00 + n;
      if (gc >= a.cout) continue;
      const float2 mu = mean[n / 2], iv = inv[n / 2], ga = gam[n / 2], be = bet[n / 2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = t0 + rw + 8 * h;
        if (f >= L) continue;
        store_out_pair(out + (row0 + f) * a.cout + gc, a.cout - gc,
                       ((bf16r(acc[ni * 4 + 2 * h]) - mu.x) * iv.x) * ga.x + be.x,
                       ((bf16r(acc[ni * 4 + 2 * h + 1]) - mu.y) * iv.y) * ga.y + be.y);
      }
    }
  }
}

}  // namespace

// x (B, L, C0) f32; w: the stages' weights, each (Cout, K, Cin_pad) bf16 with
// Cin_pad = Cin rounded up to 32 (zeros), concatenated; bn (n_layers, 4, CB)
// f32 rows [mean, rsqrt(var + eps), gamma, beta], CB >= max(C, C0) and even;
// lens (B) i32; out (B, L, C0) f32; scratch: the bf16 planes (B, L, CS), CS
// = C rounded up to 16, that carry a chain's rows between launches: none
// for one launch, one for two, two (used in turn) for more
// (ops/kernels/postnet.py:scratch_elems). C and C0 from 1 to 1024, odd K up
// to 31, 1 to 32 layers (one layer: C0 -> C0).
FS2_EXPORT int fs2_postnet(const float* x, const bf16* w, const float* bn, const int* lens,
                           float* out, bf16* scratch, int B, int L, int C0, int C, int n_layers,
                           int K, int CB, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  PnPlan pl;
  if (B < 1 || L < 1 || CB < C || CB < C0 || CB % 2 != 0 ||
      !pn_make_plan(C0, C, K, n_layers, &pl))
    return (int)cudaErrorInvalidValue;
  const int launches = (n_layers + pl.spl - 1) / pl.spl, CS = round16(C);
  if (launches > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  bf16* planes[2] = {scratch, scratch != nullptr ? scratch + (size_t)B * L * CS : nullptr};
  // weights: stage 0 (C, K, p0), stages 1 .. n-2 (C, K, p) each, the last
  // (C0, K, p); one layer: stage 0 alone, (C0, K, p0)
  const int p0 = (C0 + 31) / 32 * 32, p = (C + 31) / 32 * 32;
  auto stage_w = [&](int g) {
    return g == 0 ? w : w + (size_t)C * K * p0 + (size_t)(g - 1) * C * K * p;
  };
  cudaError_t e;
  if (pl.wr == 0) {  // one launch a stage
    for (int g = 0; g < n_layers; ++g) {
      const int cin = g == 0 ? C0 : C, cout = g == n_layers - 1 ? C0 : C;
      CUtensorMap tw;
      if ((e = tma_map_bf16_taps(&tw, stage_w(g), cin, K, cout, g == 0 ? p0 : p, PN_WN)) !=
          cudaSuccess)
        return (int)e;
      const PnWideArgs a{g == 0 ? (const void*)x : (const void*)planes[(g - 1) % 2],
                         bn + (size_t)g * 4 * CB, lens,
                         g == n_layers - 1 ? (void*)out : (void*)planes[g % 2],
                         L, cin, cout, K, CB, CS, g == 0, g == n_layers - 1, pl.st};
      if ((e = set_smem(postnet_wide_kernel, pl.smem)) != cudaSuccess) return (int)e;
      postnet_wide_kernel<<<dim3((L + 127) / 128, (cout + PN_WN - 1) / PN_WN, B), THREADS,
                            pl.smem, stream>>>(tw, a);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    return 0;
  }
  const int box = pl.wr == 2 ? std::max(pl.nh, pl.nl) : 256;
  const int cout0 = n_layers == 1 ? C0 : C;
  CUtensorMap maps[3];
  if ((e = tma_map_bf16_taps(&maps[0], w, C0, K, cout0, p0, box)) != cudaSuccess ||
      (e = tma_map_bf16_taps(&maps[1], n_layers > 2 ? stage_w(1) : w, n_layers > 2 ? C : C0, K,
                             n_layers > 2 ? (uint64_t)(n_layers - 2) * C : cout0,
                             n_layers > 2 ? p : p0, box)) != cudaSuccess ||
      (e = n_layers == 1 ? tma_map_bf16_taps(&maps[2], w, C0, K, C0, p0, box)
                         : tma_map_bf16_taps(&maps[2], stage_w(n_layers - 1), C, K, C0, p, box)) !=
          cudaSuccess)
    return (int)e;
  for (int l = 0, i0 = 0; l < launches; ++l, i0 += pl.spl) {
    const int i1 = std::min(n_layers, i0 + pl.spl), S = i1 - i0;
    const int P = 64 * pl.wr - (S - 1) * (K - 1);
    const PnArgs a{l == 0 ? (const void*)x : (const void*)planes[(l - 1) % 2], bn, lens,
                   l == launches - 1 ? (void*)out : (void*)planes[l % 2],
                   L, C0, C, n_layers, K, CB, CS, i0, i1, pl.st};
    if ((e = launch_stages(maps, a, pl, dim3((L + P - 1) / P, B), stream)) != cudaSuccess)
      return (int)e;
  }
  return 0;
}

// The tiling chosen for a postnet, as ops/kernels/postnet.py:plan gives it:
// wr, nh, nl, st, smem, spl into out[0..5]. Returns 0, or
// cudaErrorInvalidValue for a shape the kernel does not take.
FS2_EXPORT int fs2_postnet_plan(int C0, int C, int K, int n_layers, int* out) {
  PnPlan pl;
  if (!pn_make_plan(C0, C, K, n_layers, &pl)) return (int)cudaErrorInvalidValue;
  const int v[6] = {pl.wr, pl.nh, pl.nl, pl.st, pl.smem, pl.spl};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}
