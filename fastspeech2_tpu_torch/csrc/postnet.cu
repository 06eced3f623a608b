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
// fewer stages; a bf16 scratch (B, L, C) carries the masked rows from one
// to the next (`pn_make_plan`). Widths: C and C0 multiples of 8 (the map
// zero-fills each tap to the K step, and columns past the width are written
// as zeros); the wgmma widths are rounded up to the kernels instantiated
// below. What bounds it here (clock64 phases on the H100, B=16, L=768, C =
// 256): the products wait on weight tiles from L2 (each block streams 2.4
// MB; a 128-column tile costs about what a 64-column one does), and the
// epilogues' exact tanhf about half of each epilogue.
#include "conv_chain.cuh"

namespace {

struct PnArgs {
  const void* x;    // the first launch: (B, L, C0) f32; later: (B, L, C) bf16 scratch
  const float* bn;  // (n, 4, CB) rows [mean, rsqrt(var + eps), gamma, beta]
  const int* lens;
  void* out;        // the last launch: (B, L, C0) f32; earlier: (B, L, C) bf16 scratch
  int L, C0, C, n, K, CB, i0, i1, st;
};

// Tiling of one postnet; mirrors ops/kernels/postnet.py:plan (fs2_postnet_plan
// lets a test hold the two together).
struct PnPlan {
  int wr;    // 2: 128-row stages, each warpgroup all columns; 1: 64-row
             // stages, the warpgroups split the columns
  int nh;    // hidden stages' output columns a warpgroup (wgmma N)
  int nl;    // the last stage's output columns a warpgroup
  int st;    // ring stages
  int smem;  // bytes
  int spl;   // stages a launch (the last launch takes the rest)
};

__host__ __device__ constexpr int round16(int c) { return (c + 15) / 16 * 16; }

bool pn_make_plan(int C0, int C, int K, int n, PnPlan* pl) {
  if (C0 % 8 != 0 || C % 8 != 0 || C0 < 8 || C < 8 || C0 > 256 || C > 512 || K % 2 != 1 ||
      K < 1 || K > 9 || n < 2 || n > 8)
    return false;
  const int cp = round16(C), c0p = round16(C0);
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
  if (st < 2) return false;
  pl->st = (int)st;
  pl->smem = (int)(buf + st * sb + SLACK);
  pl->spl = K == 1 ? n : std::min(n, 1 + (m / 2) / (K - 1));
  return true;
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
    load_rows<true>(xs, R, nch, C0, rows_in, [&](int e) -> const void* {
      const int t = tb + e;
      return t >= 0 && t < len ? x + (row0 + t) * C0 : nullptr;
    });
  } else {
    const bf16* x = reinterpret_cast<const bf16*>(a.x);
    load_rows<false>(xs, R, nch, C, rows_in, [&](int e) -> const void* {
      const int t = tb + e;
      return t >= 0 && t < len ? x + (row0 + t) * C : nullptr;
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
        // (mean, inv, g, b) of columns n, n + 1 (C is even: both or neither)
        const bool in = n < C;
        const float2 z2 = make_float2(0.f, 0.f);
        const float2 mu = in ? mean[n / 2] : z2, iv = in ? inv[n / 2] : z2;
        const float2 ga = in ? gam[n / 2] : z2, be = in ? bet[n / 2] : z2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rw + 8 * h, f = fb + r;
          const bool live = in && f >= 0 && f < len;
          const float y0 = tanhf(((bf16r(acc[ni * 4 + 2 * h]) - mu.x) * iv.x) * ga.x + be.x);
          const float y1 = tanhf(((bf16r(acc[ni * 4 + 2 * h + 1]) - mu.y) * iv.y) * ga.y + be.y);
          const float v[2] = {live ? y0 : 0.f, live ? y1 : 0.f};
          if (to_smem) {
            store_pair(xs, R, r, n, v[0], v[1]);
          } else if (r < P && f < L && n < C) {  // the next launch's input
            *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(a.out) + (row0 + f) * C + n) =
                pack_bf16(v[0], v[1]);
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
        if (n >= C0) continue;  // C0 is even: n + 1 < C0 too
        const float2 mu = mean[n / 2], iv = inv[n / 2], ga = gam[n / 2], be = bet[n / 2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rw + 8 * h, f = fb + r;
          if (r >= P || f >= L) continue;
          *reinterpret_cast<float2*>(out + (row0 + f) * C0 + n) =
              make_float2(((bf16r(acc[ni * 4 + 2 * h]) - mu.x) * iv.x) * ga.x + be.x,
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

}  // namespace

// x (B, L, C0) f32; w: the stages' weights, each (Cout, K, Cin_pad) bf16 with
// Cin_pad = Cin rounded up to 32 (zeros), concatenated; bn (n_layers, 4, CB)
// f32 rows [mean, rsqrt(var + eps), gamma, beta]; lens (B) i32;
// out (B, L, C0) f32; scratch: (B, L, C) bf16 where the plan takes two
// launches (ops/kernels/postnet.py:scratch_elems), or null where it takes
// one. C and C0 multiples of 8, C <= 512, C0 <= 256, odd K <= 9, 2 to 8
// layers.
FS2_EXPORT int fs2_postnet(const float* x, const bf16* w, const float* bn, const int* lens,
                           float* out, bf16* scratch, int B, int L, int C0, int C, int n_layers,
                           int K, int CB, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  PnPlan pl;
  if (B < 1 || L < 1 || CB < C || CB < C0 || !pn_make_plan(C0, C, K, n_layers, &pl))
    return (int)cudaErrorInvalidValue;
  // over the shapes taken, a chain needs two launches at most (the
  // second reads the scratch the first wrote)
  const int launches = (n_layers + pl.spl - 1) / pl.spl;
  if (launches > 2 || (launches > 1 && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  // weights: stage 0 (C, K, p0), stages 1 .. n-2 (C, K, p) each, the last (C0, K, p)
  const int p0 = (C0 + 31) / 32 * 32, p = (C + 31) / 32 * 32;
  const bf16* wh = w + (size_t)C * K * p0;
  const bf16* wl = wh + (size_t)(n_layers - 2) * C * K * p;
  const int box = pl.wr == 2 ? std::max(pl.nh, pl.nl) : 256;
  CUtensorMap maps[3];
  cudaError_t e;
  if ((e = tma_map_bf16_taps(&maps[0], w, C0, K, C, p0, box)) != cudaSuccess ||
      (e = tma_map_bf16_taps(&maps[1], n_layers > 2 ? wh : w, n_layers > 2 ? C : C0, K,
                             n_layers > 2 ? (uint64_t)(n_layers - 2) * C : C,
                             n_layers > 2 ? p : p0, box)) != cudaSuccess ||
      (e = tma_map_bf16_taps(&maps[2], wl, C, K, C0, p, box)) != cudaSuccess)
    return (int)e;
  for (int l = 0, i0 = 0; l < launches; ++l, i0 += pl.spl) {
    const int i1 = std::min(n_layers, i0 + pl.spl), S = i1 - i0;
    const int P = 64 * pl.wr - (S - 1) * (K - 1);
    const PnArgs a{l == 0 ? (const void*)x : (const void*)scratch, bn, lens,
                   l == launches - 1 ? (void*)out : (void*)scratch,
                   L, C0, C, n_layers, K, CB, i0, i1, pl.st};
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
