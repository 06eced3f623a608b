// MelGAN residual stack on the H100: n dilated residual blocks of one
// generator stage (dilations 1, 3, 9 by default), each
//   cur = cur + conv_k1(lrelu(conv_k3,dil(reflect_pad(lrelu(cur)))))
// on a (B, S, C) activation, with the reflection padding applied per block at
// the true sequence ends.
//
// Replaces fastspeech2_tpu/ops/pallas/resstack.py: resstack_fused (kernel
// _resstack_kernel).
//
// Bound on the H100: 2*n*4*C^2 FLOPs per sample against 2*C*itemsize bytes
// (one read, one write of the activation). In bf16 that is 6*C FLOP/byte:
// operations bound for C >= 64 (1,536 FLOP/byte at C=256), bytes bound at
// C=32 (192 FLOP/byte, under the card's ~295 ridge).
//
// Tiling (both kernels). One block per (time tile, batch row). The TPU kernel
// copies a pre-padded HBM array into VMEM; here a block loads its own tile
// plus a halo of sum(dilations) rows each side straight from the unpadded
// input, and the activation stays in shared memory across all blocks of the
// stack: one read and one write of x per stage. Interior halos shrink by the
// dilation per block, so every row that is stored is exact. Rows outside
// [0, S) are rewritten before every block as mirrors of the current
// activation (row -p <- row p, row S-1+p <- row S-1-p), which is the
// per-layer ReflectionPad1d; the rule needs no tile alignment, so a tile may
// hold one end, both ends or neither, and S need not be a multiple of the
// tile.
//
// bf16 (sm_90a, primitives in hopper.cuh). NW warpgroups (two; four at
// C = 128, where that measured faster), each owning MR chunks of 64 of the
// block's P = 64 * MR * NW computed rows; thread 0 also keeps the weights in
// flight. The activation lives column-chunk-major,
// [C / 8][rows][8] (rows 16 bytes apart), in two buffers: cur and, once per
// block of the stack, z = round(lrelu(cur)) with the mirrors applied. Per
// block both products run as wgmma (m64nNRk16, NR a part of C of at most 128
// columns: C itself up to 112, 64 at C = 128, C / 2 above):
//  * B = weights: every weight tile a stage needs, in the order the products
//    take them, streams through one TMA ring (full/empty mbarriers) of NR x
//    64 tiles straight across products and blocks: no refill bubble at a
//    product's start. w1 (n, C, 3C) is (out, tap, in) and w2 (n, C, C)
//    (out, in): both K-major as they are, read by 2-D maps with the 128-byte
//    swizzle. Each tile serves all P rows of the block.
//  * The 3-tap product: A = z from shared memory, by a descriptor without
//    swizzle whose base is shifted (j - 1) * d rows for tap j: in the
//    column-chunk-major layout any row shift is 16 bytes a row, where a
//    swizzled tile would need its base on a 1024-byte atom. An A operand
//    taken from registers instead (8x8 matrix loads of shifted rows, LeakyReLU
//    per load) cost more issue slots per k-step than an m64n64k16 product takes.
//  * The hidden (K = 3C, +b1, lrelu, rounding) is formed NR columns at a time
//    and kept in registers as the register A operand of the k=1 product (the
//    accumulator layout is the A fragment's): it never touches shared memory.
//    The k=1 product then runs one NR-column output part at a time, its
//    epilogue adding round(y + b2) to cur (a bf16 add). The products read z
//    only, so the epilogue writes cur in place with no barrier; the peak is
//    MR * (C / 4 + NR / 2) registers a thread (128 at C = 256).
// A block of the stack has two barriers: before the z pass and after it.
// Each ring tile's products are issued back to back and retired one tile
// later (wait<1>); nothing is in flight across a block's back edge and no
// plain instruction writes an accumulator (the first product of each takes
// scale_d = 0), so ptxas keeps them asynchronous. Widths: C a multiple of 16
// up to 128, of 32 up to 256 (the wrapper pads any other C up to one of
// these with zero channels).
//
// f32: plain multiplies and adds (built with --fmad=false, no TF32), lrelu
// applied while reading cur, the hidden for the whole tile in shared memory,
// each thread eight output columns of one row. Written to be right, not fast.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int MAX_BLOCKS = 8;
constexpr float SLOPE = 0.2f;

struct Dilations {
  int n;
  int d[MAX_BLOCKS];
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : SLOPE * v; }

// Source row (global index) of the mirror for a row outside [0, S).
__device__ __forceinline__ int mirror_src(int t, int S) {
  return t < 0 ? -t : 2 * (S - 1) - t;
}

// bf16 LeakyReLU of a packed pair, rounded: round(lrelu(v)) in f32, per half.
__device__ __forceinline__ uint32_t lrelu_bf16x2(uint32_t v) {
  return pack_bf16(lrelu(__uint_as_float(v << 16)), lrelu(__uint_as_float(v & 0xFFFF0000u)));
}

// v, as a value the compiler cannot see through (so it cannot precompute
// what is derived from it ahead of this point).
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// Rows of an activation buffer [C / 8][rows][8]: at least `rows`, and one more
// than a multiple of 8, so 8 consecutive column chunks of one row sit on 8
// distinct 16-byte bank groups (the tile's load and store).
__host__ __device__ __forceinline__ int padded_rows(int rows) { return (rows + 6) / 8 * 8 + 1; }

// One bf16 width of the wgmma kernel: NR the N of every product (hidden chunk
// and output part), MR 64-row chunks per warpgroup, ST ring stages, MINB
// blocks per SM, NW warpgroups. The table in fs2_resstack_bf16 holds the
// choices measured best on the H100 at the stage shapes of the default
// generator (scripts/time_resstack.py): larger MR where a block's rows are
// narrow, two blocks per SM where registers and shared memory allow.
template <int C_, int NR_, int MR_, int ST_, int MINB_, int NW_>
struct Shape {
  static constexpr int C = C_, NR = NR_, MR = MR_, ST = ST_, MINB = MINB_, NW = NW_;
  static constexpr int THREADS = 128 * NW_;  // NW warpgroups
  static constexpr int NH = C_ / NR_;        // hidden chunks = output parts
  static constexpr int P = 64 * MR_ * NW_;   // rows computed per block of the stack
  static constexpr int KS1 = 3 * C_ / 16;    // k-steps of the 3-tap product
  static constexpr int KC1 = (KS1 + 3) / 4;  // its ring tiles per hidden chunk
  static constexpr int KS2 = C_ / 16;        // k-steps of the k=1 product
  static constexpr int KC2 = (KS2 + 3) / 4;  // its ring tiles per output part
  static constexpr int IPB = NH * (KC1 + KC2);  // ring tiles per block of the stack
  static constexpr int SB = NR_ * 128;          // bytes of a ring tile (NR x 64)
  static_assert(C_ % 16 == 0 && NR_ % 16 == 0 && NR_ <= 128 && NH * NR_ == C_, "width");
};

// The ring's filler (thread 0): issues tiles in order while their stage is
// free; tiles below `need` are waited for. Tile i of the stage goes to stage
// i % ST once all 8 warps released tile i - ST. Per block of the stack the
// order is the products': the 3-tap weight's K tiles of each hidden chunk,
// then the k=1 weight's K tiles of each output part.
template <class K>
struct Filler {
  const CUtensorMap* w1;
  const CUtensorMap* w2;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int issued, total;

  __device__ __forceinline__ void top_up(int need) {
    for (; issued < total; ++issued) {
      const int s = issued % K::ST;
      const uint32_t parity = ((issued / K::ST) & 1) ^ 1;
      if (issued < need)
        mbar_wait(&empty[s], parity);
      else if (!mbar_test(&empty[s], parity))
        break;
      const int bi = issued / K::IPB, r = issued % K::IPB;
      unsigned char* dst = ring + s * K::SB;
      mbar_expect_tx(&full[s], K::SB);
      if (r < K::NH * K::KC1)  // 3-tap weight: rows of hidden chunk, K tile
        tma_load_2d(dst, w1, &full[s], (r % K::KC1) * 64, bi * K::C + (r / K::KC1) * K::NR);
      else  // k=1 weight: rows of output part, K tile
        tma_load_2d(dst, w2, &full[s], ((r - K::NH * K::KC1) % K::KC2) * 64,
                    bi * K::C + ((r - K::NH * K::KC1) / K::KC2) * K::NR);
    }
  }
};

// Ring tile `it` is in shared memory: thread 0 issues it (and later ones whose
// stage is free) first. Returns the tile's shared address.
template <class K>
__device__ __forceinline__ uint32_t acquire(Filler<K>& fl, uint32_t ring_s, int it) {
  if (threadIdx.x == 0) fl.top_up(it + 1);
  __syncwarp();
  mbar_wait(&fl.full[it % K::ST], (it / K::ST) & 1);
  return ring_s + (it % K::ST) * K::SB;
}

template <class K>
__global__ void __launch_bounds__(K::THREADS, K::MINB)
resstack_wgmma_kernel(const __grid_constant__ CUtensorMap tw1,
                      const __grid_constant__ CUtensorMap tw2, const bf16* __restrict__ x,
                      const float* __restrict__ b1, const float* __restrict__ b2,
                      bf16* __restrict__ out, int S, Dilations dil, int halo, int guard,
                      int tile) {
  constexpr int C = K::C, NR = K::NR, NH = K::NH, MR = K::MR, ST = K::ST, CH = C / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int rows = K::P + 2 * guard, R = padded_rows(rows);
  const uint32_t lbo = R * 16;  // bytes from one column chunk to the next
  bf16* cur = reinterpret_cast<bf16*>(ring + ST * K::SB);  // [CH][R][8]
  bf16* z = cur + CH * R * 8;                              // [CH][R][8]: round(lrelu(cur))
  uint64_t* full = reinterpret_cast<uint64_t*>(z + CH * R * 8);
  uint64_t* empty = full + ST;
  const int b = blockIdx.y, t0 = blockIdx.x * tile;
  const int base = t0 - halo - guard;  // global row of buffer row 0
  const bf16* xb = x + (size_t)b * S * C;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * K::NW);  // one arrival per warp
    }
    fence_barrier_init();
  }
  for (int i = threadIdx.x; i < rows * CH; i += K::THREADS) {
    const int e = i / CH, c = i % CH, t = base + e;
    const bool ok = t >= 0 && t < S;
    cp_async16(cur + (c * R + e) * 8, ok ? xb + (size_t)t * C + c * 8 : xb, ok);
  }
  cp_async_commit();
  __syncthreads();  // barriers initialised
  Filler<K> fl{&tw1, &tw2, ring, full, empty, 0, dil.n * K::IPB};
  if (threadIdx.x == 0) fl.top_up(0);  // every stage is free: fill the ring
  cp_async_wait<0>();

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const uint32_t ring_s = smem_u32(ring), z_s = smem_u32(z);
  const int row0 = guard + wg * MR * 64;  // buffer row of this warpgroup's first row
  const bool ends = base < 0 || base + rows > S;
  int it = 0;  // ring tile consumed next

  for (int bi = 0; bi < dil.n; ++bi) {
    __syncthreads();  // the tile or the last block's output is in place
    // z = round(lrelu(cur)), a row outside [0, S) within the halo from its
    // mirror; a thread takes whole rows, every column chunk of one at once
    for (int e = threadIdx.x; e < rows; e += K::THREADS) {
      int src = e;
      const int tg = base + e;
      if (ends && ((tg < 0 && tg >= -halo) || (tg >= S && tg < S + halo))) {
        const int m = mirror_src(tg, S) - base;
        if (m >= 0 && m < rows) src = m;
      }
#pragma unroll 8
      for (int c = 0; c < CH; ++c) {
        uint4 v = *reinterpret_cast<const uint4*>(cur + (c * R + src) * 8);
        v.x = lrelu_bf16x2(v.x);
        v.y = lrelu_bf16x2(v.y);
        v.z = lrelu_bf16x2(v.z);
        v.w = lrelu_bf16x2(v.w);
        *reinterpret_cast<uint4*>(z + (c * R + e) * 8) = v;
      }
    }
    fence_proxy_async_smem();  // z is read by the products' descriptors
    __syncthreads();  // z complete; the products read z only, the epilogue writes cur
    const int d = dil.d[bi];
    const uint32_t shift = d * 16;  // bytes from a row to its tap-0 row
    const float* b1b = b1 + bi * C;
    const float* b2b = b2 + bi * C;

    // hidden h = round(lrelu(sum_j z[t + (j-1)d] W1_j + b1)), NR columns at a
    // time, kept as the k=1 product's register A operand
    uint32_t h[MR][K::KS2][4];
#pragma unroll
    for (int hc = 0; hc < NH; ++hc) {
      float acc[MR][NR / 2];
#pragma unroll
      for (int kc = 0; kc < K::KC1; ++kc) {
        const uint32_t bt = acquire(fl, ring_s, it + kc);
        // the tile's A addresses from here, not hoisted out of the block loop
        // as registers held across it
        const uint32_t za = opaque(z_s + row0 * 16 - shift), lb = opaque(lbo);
        wgmma_fence();
#pragma unroll
        for (int ks = kc * 4; ks < kc * 4 + 4 && ks < K::KS1; ++ks) {
          const int j = ks * 16 / C, c0 = ks * 16 % C;  // tap, first input column
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const uint32_t a = za + (c0 / 8) * lb + m * 64 * 16 + j * shift;
            wgmma_ss_k<NR>(acc[m], desc_plain(a, lb, 128), kmajor_desc(bt, ks & 3), ks > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous tile's products retired: release its stage
        if (kc > 0) warp_arrive(&empty[(it + kc - 1) % ST]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MR; ++m) fence_regs(acc[m]);
      warp_arrive(&empty[(it + K::KC1 - 1) % ST]);
      it += K::KC1;
#pragma unroll
      for (int ni = 0; ni < NR / 8; ++ni) {
        const int col = hc * NR + ni * 8;  // hidden column of n-tile ni
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b1b + col + 2 * t4));
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          uint32_t(&f)[4] = h[m][col / 16];
          f[(ni & 1) * 2] =
              pack_bf16(lrelu(acc[m][ni * 4] + bb.x), lrelu(acc[m][ni * 4 + 1] + bb.y));
          f[(ni & 1) * 2 + 1] =
              pack_bf16(lrelu(acc[m][ni * 4 + 2] + bb.x), lrelu(acc[m][ni * 4 + 3] + bb.y));
        }
      }
    }

    // per output part: y = h W2^T, then cur += round(y + b2), a bf16 add
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) {
      float acc[MR][NR / 2];
#pragma unroll
      for (int kc = 0; kc < K::KC2; ++kc) {
        const uint32_t bt = acquire(fl, ring_s, it + kc);
        wgmma_fence();
#pragma unroll
        for (int k = kc * 4; k < kc * 4 + 4 && k < K::KS2; ++k)
#pragma unroll
          for (int m = 0; m < MR; ++m)
            wgmma_rs_k<NR>(acc[m], h[m][k], kmajor_desc(bt, k & 3), k > 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (kc > 0) warp_arrive(&empty[(it + kc - 1) % ST]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MR; ++m) fence_regs(acc[m]);
      warp_arrive(&empty[(it + K::KC2 - 1) % ST]);
      it += K::KC2;
#pragma unroll
      for (int ni = 0; ni < NR / 8; ++ni) {
        const int col = nh * NR + ni * 8;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b2b + col + 2 * t4));
#pragma unroll
        for (int m = 0; m < MR; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = row0 + m * 64 + warp * 16 + g8 + 8 * half;
            bf16* q = cur + ((col / 8) * R + r) * 8 + 2 * t4;
            const __nv_bfloat162 o = *reinterpret_cast<const __nv_bfloat162*>(q);
            *reinterpret_cast<uint32_t*>(q) =
                pack_bf16(__low2float(o) + bf16r(acc[m][ni * 4 + 2 * half] + bb.x),
                          __high2float(o) + bf16r(acc[m][ni * 4 + 2 * half + 1] + bb.y));
          }
      }
    }
  }
  __syncthreads();
  bf16* ob = out + (size_t)b * S * C;
  const int e0 = guard + halo;
  for (int i = threadIdx.x; i < tile * CH; i += K::THREADS) {
    const int r = i / CH, c = i % CH, tg = t0 + r;
    if (tg < S)
      *reinterpret_cast<uint4*>(ob + (size_t)tg * C + c * 8) =
          *reinterpret_cast<const uint4*>(cur + (c * R + e0 + r) * 8);
  }
}

constexpr int F32_CPT = 8;  // output columns per thread

// Threads of a warp take 32 consecutive rows of one group of eight output
// columns: the weight reads (out-major, like the bf16 layout) are warp-wide
// broadcasts and the activation reads, at row stride C + 1, hit 32 banks.
__global__ void __launch_bounds__(256)
resstack_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out, int S,
                    int C, Dilations dil, int halo, int guard, int tile, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = P + 2 * guard, ld = C + 1;
  float* cur = reinterpret_cast<float*>(smem);  // [rows][ld]
  float* hs = cur + rows * ld;                  // [P][ld]
  const int b = blockIdx.y, t0 = blockIdx.x * tile;
  const int base = t0 - halo - guard;
  const float* xb = x + (size_t)b * S * C;
  for (int i = threadIdx.x; i < rows * C; i += 256) {
    const int e = i / C, c = i % C, t = base + e;
    cur[e * ld + c] = (t >= 0 && t < S) ? xb[(size_t)t * C + c] : 0.f;
  }
  const bool ends = base < 0 || base + rows > S;
  const int items = P * (C / F32_CPT);
  for (int bi = 0; bi < dil.n; ++bi) {
    const int d = dil.d[bi];
    __syncthreads();
    if (ends) {
      for (int i = threadIdx.x; i < rows * C; i += 256) {
        const int e = i / C, c = i % C, t = base + e;
        if ((t < 0 && t >= -halo) || (t >= S && t < S + halo)) {
          const int src = mirror_src(t, S) - base;
          if (src >= 0 && src < rows) cur[e * ld + c] = cur[src * ld + c];
        }
      }
      __syncthreads();
    }
    const float* w1b = w1 + (size_t)bi * C * 3 * C;  // (out, tap, in)
    const float* w2b = w2 + (size_t)bi * C * C;      // (out, in)
    for (int i = threadIdx.x; i < items; i += 256) {
      const int r = i % P, n0 = (i / P) * F32_CPT;
      float acc[F32_CPT];
#pragma unroll
      for (int q = 0; q < F32_CPT; ++q) acc[q] = 0.f;
      for (int j = 0; j < 3; ++j) {
        const float* src = cur + (guard + r + (j - 1) * d) * ld;
        const float* wj = w1b + (size_t)n0 * 3 * C + j * C;
        for (int k = 0; k < C; ++k) {
          const float a = lrelu(src[k]);
#pragma unroll
          for (int q = 0; q < F32_CPT; ++q) acc[q] += a * wj[(size_t)q * 3 * C + k];
        }
      }
#pragma unroll
      for (int q = 0; q < F32_CPT; ++q)
        hs[r * ld + n0 + q] = lrelu(acc[q] + b1[bi * C + n0 + q]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < items; i += 256) {
      const int r = i % P, n0 = (i / P) * F32_CPT;
      float acc[F32_CPT];
#pragma unroll
      for (int q = 0; q < F32_CPT; ++q) acc[q] = 0.f;
      const float* wn = w2b + (size_t)n0 * C;
      for (int k = 0; k < C; ++k) {
        const float a = hs[r * ld + k];
#pragma unroll
        for (int q = 0; q < F32_CPT; ++q) acc[q] += a * wn[(size_t)q * C + k];
      }
#pragma unroll
      for (int q = 0; q < F32_CPT; ++q)
        cur[(guard + r) * ld + n0 + q] += acc[q] + b2[bi * C + n0 + q];
    }
  }
  __syncthreads();
  float* ob = out + (size_t)b * S * C;
  for (int i = threadIdx.x; i < tile * C; i += 256) {
    const int r = i / C, c = i % C, t = t0 + r;
    if (t < S) ob[(size_t)t * C + c] = cur[(guard + halo + r) * ld + c];
  }
}

template <class K>
cudaError_t launch_bf16(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                        const float* b2, bf16* out, int B, int S, int n, Dilations dil,
                        int halo, int guard, cudaStream_t stream) {
  const int tile = K::P - 2 * halo;
  if (tile < 1) return cudaErrorInvalidValue;
  const size_t smem = 1024 + (size_t)K::ST * K::SB +
                      2 * (size_t)padded_rows(K::P + 2 * guard) * K::C * sizeof(bf16) +
                      2 * K::ST * 8;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  // two 2-D maps encoded per launch (rows of all n blocks, K columns)
  CUtensorMap tw1, tw2;
  cudaError_t e;
  if ((e = tma_map_bf16_2d(&tw1, w1, 3 * K::C, (uint64_t)n * K::C, 3 * K::C, K::NR)) !=
          cudaSuccess ||
      (e = tma_map_bf16_2d(&tw2, w2, K::C, (uint64_t)n * K::C, K::C, K::NR)) != cudaSuccess)
    return e;
  if ((e = set_smem(resstack_wgmma_kernel<K>, smem)) != cudaSuccess) return e;
  resstack_wgmma_kernel<K><<<dim3((S + tile - 1) / tile, B), K::THREADS, smem, stream>>>(
      tw1, tw2, x, b1, b2, out, S, dil, halo, guard, tile);
  return cudaGetLastError();
}

bool read_dilations(const int* dilations, int n, Dilations* dil, int* halo, int* guard) {
  if (n < 1 || n > MAX_BLOCKS) return false;
  dil->n = n;
  *halo = 0;
  *guard = 0;
  for (int i = 0; i < n; ++i) {
    if (dilations[i] < 1) return false;
    dil->d[i] = dilations[i];
    *halo += dilations[i];
    if (dilations[i] > *guard) *guard = dilations[i];
  }
  return true;
}

}  // namespace

// x, out (B, S, C) bf16; w1 (n, C, 3*C) bf16 [(out, tap, in)]; w2 (n, C, C)
// bf16 (out, in); b1, b2 (n, C) f32 holding bf16-rounded values;
// dilations: n host ints. S > sum(dilations); C a multiple of 16 up to 128 or
// of 32 up to 256; x, w1 and w2 16-byte aligned.
FS2_EXPORT int fs2_resstack_bf16(const bf16* x, const bf16* w1, const float* b1,
                                 const bf16* w2, const float* b2, bf16* out, int B,
                                 int S, int C, const int* dilations, int n,
                                 void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  Dilations dil;
  int halo, guard;
  if (!read_dilations(dilations, n, &dil, &halo, &guard) || S <= halo || B < 1)
    return (int)cudaErrorInvalidValue;
#define FS2_RESSTACK_CASE(CC, NR, MR, ST, MINB, NW)                                         \
  case CC:                                                                                  \
    return (int)launch_bf16<Shape<CC, NR, MR, ST, MINB, NW>>(x, w1, b1, w2, b2, out, B, S, n, \
                                                             dil, halo, guard, stream);
  switch (C) {
    FS2_RESSTACK_CASE(16, 16, 4, 6, 2, 2)
    FS2_RESSTACK_CASE(32, 32, 4, 9, 2, 2)
    FS2_RESSTACK_CASE(48, 48, 2, 4, 2, 2)
    FS2_RESSTACK_CASE(64, 64, 2, 4, 2, 2)
    FS2_RESSTACK_CASE(80, 80, 1, 8, 1, 2)
    FS2_RESSTACK_CASE(96, 96, 1, 8, 1, 2)
    FS2_RESSTACK_CASE(112, 112, 1, 8, 1, 2)
    FS2_RESSTACK_CASE(128, 64, 1, 4, 1, 4)
    FS2_RESSTACK_CASE(160, 80, 1, 8, 1, 2)
    FS2_RESSTACK_CASE(192, 96, 1, 8, 1, 2)
    FS2_RESSTACK_CASE(224, 112, 1, 5, 1, 2)
    FS2_RESSTACK_CASE(256, 128, 1, 4, 1, 2)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FS2_RESSTACK_CASE
}

// x, out (B, S, C) f32; weights as for bf16 but f32: w1 (n, C, 3*C)
// [(out, tap, in)], w2 (n, C, C) (out, in); b1, b2 (n, C) f32.
// S > sum(dilations); C a multiple of 8, at most 256.
FS2_EXPORT int fs2_resstack_f32(const float* x, const float* w1, const float* b1,
                                const float* w2, const float* b2, float* out, int B,
                                int S, int C, const int* dilations, int n,
                                void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  Dilations dil;
  int halo, guard;
  if (!read_dilations(dilations, n, &dil, &halo, &guard) || S <= halo || B < 1 ||
      C < 8 || C > 256 || C % F32_CPT != 0)
    return (int)cudaErrorInvalidValue;
  // rows per block of the stack: a multiple of 32 that leaves a tile
  int P = C > 128 ? 64 : 128;
  while (P - 2 * halo < 8) P += 64;
  const int tile = P - 2 * halo;
  const size_t smem = ((size_t)(P + 2 * guard) + P) * (C + 1) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem(resstack_f32_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  resstack_f32_kernel<<<dim3((S + tile - 1) / tile, B), 256, smem, stream>>>(
      x, w1, b1, w2, b2, out, S, C, dil, halo, guard, tile, P);
  return (int)cudaGetLastError();
}
