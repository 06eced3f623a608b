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
// Design. One block per (time tile, batch row). The TPU kernel copies a
// pre-padded HBM array into VMEM; here a block loads its own tile plus a halo
// of sum(dilations) rows each side straight from the unpadded input, and the
// activation stays in shared memory across all blocks of the stack: one read
// and one write of x per stage. Interior halos shrink by the dilation per
// block, so every row that is stored is exact. Rows outside [0, S) are
// rewritten before every block as mirrors of the current activation
// (row -p <- row p, row S-1+p <- row S-1-p), which is the per-layer
// ReflectionPad1d; the rule needs no tile alignment, so a tile may hold one
// end, both ends or neither, and S need not be a multiple of the tile.
//
// bf16: per block of the stack, z = lrelu(cur) is written once to a second
// buffer; the tile's rows are processed in chunks of BM rows: the dilated
// 3-tap conv is one GEMM over row-shifted views of z (shift = dilation)
// against the weight laid out (out, tap, in), its epilogue writes
// bf16(lrelu(acc + b1)) to a chunk-sized hidden buffer, the k=1 conv is a
// second GEMM from that buffer, and its epilogue adds bf16(acc + b2) to cur in
// place (cur is not an input of the GEMMs, z is). Weights (4*C^2 per block,
// 512 KB at C=256) stream from L2 in 32-deep slices through TileGemm. The
// time tile is what the 227 KB of shared memory leaves: 102 rows at C=256
// (cur and z at 146 x 264 bf16, a 64-row hidden, two weight slices), 230 at
// C=128, 230 at C=64 and 358 at C=32 (two blocks per SM for the last two).
// Channels run at their own width: no padding to 128.
//
// f32: plain multiplies and adds (built with --fmad=false, no TF32), lrelu
// applied while reading cur, the hidden for the whole tile in shared memory,
// each thread eight output columns of one row. Written to be right, not fast.
#include "common.cuh"

namespace {

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

template <int C_, int WM_, int WN_, int MI_, int NI_, int STAGES_, int NCH_, int MINB_>
struct Shape {
  static constexpr int C = C_, NCH = NCH_, MINB = MINB_;
  using G = TileGemm<WM_, WN_, MI_, NI_, STAGES_>;
  static_assert(G::BN == C_, "one GEMM pass covers all output channels");
  static_assert(G::THREADS == 256, "eight warps");
  static constexpr int P = NCH_ * G::BM;  // rows computed per block of the stack
  static constexpr int LD = C_ + 8;       // row stride: spreads banks
};

template <class T>
__global__ void __launch_bounds__(256, T::MINB)
resstack_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                     const float* __restrict__ b1, const bf16* __restrict__ w2,
                     const float* __restrict__ b2, bf16* __restrict__ out, int S,
                     Dilations dil, int halo, int guard, int tile) {
  using G = typename T::G;
  constexpr int C = T::C, LD = T::LD, P = T::P;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = P + 2 * guard;
  bf16* cur = reinterpret_cast<bf16*>(smem);  // [rows][LD]
  bf16* zs = cur + rows * LD;                 // [rows][LD]: lrelu(cur)
  bf16* hs = zs + rows * LD;                  // [BM][LD]: hidden of one chunk
  bf16* Ws = hs + G::BM * LD;                 // weight slices
  const int b = blockIdx.y, t0 = blockIdx.x * tile;
  const int base = t0 - halo - guard;  // global row of buffer row 0
  const bf16* xb = x + (size_t)b * S * C;

  for (int i = threadIdx.x; i < rows * (C / 8); i += 256) {
    const int e = i / (C / 8), c = (i % (C / 8)) * 8, t = base + e;
    const bool ok = t >= 0 && t < S;
    cp_async16(cur + e * LD + c, ok ? xb + (size_t)t * C + c : xb, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();

  const bool ends = base < 0 || base + rows > S;
  for (int bi = 0; bi < dil.n; ++bi) {
    const int d = dil.d[bi];
    __syncthreads();
    if (ends) {
      for (int i = threadIdx.x; i < rows * (C / 8); i += 256) {
        const int e = i / (C / 8), c = (i % (C / 8)) * 8, t = base + e;
        if ((t < 0 && t >= -halo) || (t >= S && t < S + halo)) {
          const int src = mirror_src(t, S) - base;
          if (src >= 0 && src < rows)
            *reinterpret_cast<uint4*>(cur + e * LD + c) =
                *reinterpret_cast<const uint4*>(cur + src * LD + c);
        }
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < rows * (C / 2); i += 256) {
      const int e = i / (C / 2), c = (i % (C / 2)) * 2;
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(cur + e * LD + c);
      *reinterpret_cast<uint32_t*>(zs + e * LD + c) =
          pack_bf16(lrelu(__low2float(v)), lrelu(__high2float(v)));
    }
    __syncthreads();
    const bf16* w1b = w1 + (size_t)bi * C * 3 * C;
    const bf16* w2b = w2 + (size_t)bi * C * C;
    const float* b1b = b1 + bi * C;
    const float* b2b = b2 + bi * C;
    for (int ch = 0; ch < T::NCH; ++ch) {
      const int s = guard + ch * G::BM;  // buffer row of the chunk's first output
      G gm;
      gm.run(zs + (s - d) * LD, LD, C, 3, w1b, C, 0, Ws, d);
      gm.epilogue_pairs([&](int r, int c, float v0, float v1) {
        *reinterpret_cast<uint32_t*>(hs + r * LD + c) =
            pack_bf16(lrelu(v0 + b1b[c]), lrelu(v1 + b1b[c + 1]));
      });
      __syncthreads();
      gm.run(hs, LD, C, 1, w2b, C, 0, Ws);
      gm.epilogue_pairs([&](int r, int c, float v0, float v1) {
        bf16* p = cur + (s + r) * LD + c;
        const __nv_bfloat162 o = *reinterpret_cast<const __nv_bfloat162*>(p);
        *reinterpret_cast<uint32_t*>(p) =
            pack_bf16(__low2float(o) + bf16r(v0 + b2b[c]),
                      __high2float(o) + bf16r(v1 + b2b[c + 1]));
      });
    }
  }
  __syncthreads();
  bf16* ob = out + (size_t)b * S * C;
  const int e0 = guard + halo;
  for (int i = threadIdx.x; i < tile * (C / 8); i += 256) {
    const int r = i / (C / 8), c = (i % (C / 8)) * 8, t = t0 + r;
    if (t < S)
      *reinterpret_cast<uint4*>(ob + (size_t)t * C + c) =
          *reinterpret_cast<const uint4*>(cur + (e0 + r) * LD + c);
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

template <class T>
cudaError_t launch_bf16(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                        const float* b2, bf16* out, int B, int S, Dilations dil,
                        int halo, int guard, cudaStream_t stream) {
  using G = typename T::G;
  const int tile = T::P - 2 * halo;
  if (tile < 1) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)(2 * (T::P + 2 * guard) + G::BM) * T::LD +
                       G::STAGE_ELEMS) * sizeof(bf16);
  cudaError_t e = set_smem(resstack_bf16_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  resstack_bf16_kernel<T><<<dim3((S + tile - 1) / tile, B), 256, smem, stream>>>(
      x, w1, b1, w2, b2, out, S, dil, halo, guard, tile);
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
// dilations: n host ints. S > sum(dilations); C in {32, 64, 128, 256}.
FS2_EXPORT int fs2_resstack_bf16(const bf16* x, const bf16* w1, const float* b1,
                                 const bf16* w2, const float* b2, bf16* out, int B,
                                 int S, int C, const int* dilations, int n,
                                 void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  Dilations dil;
  int halo, guard;
  if (!read_dilations(dilations, n, &dil, &halo, &guard) || S <= halo || B < 1)
    return (int)cudaErrorInvalidValue;
  switch (C) {
    case 256:
      return (int)launch_bf16<Shape<256, 2, 4, 2, 8, 2, 2, 1>>(
          x, w1, b1, w2, b2, out, B, S, dil, halo, guard, stream);
    case 128:
      return (int)launch_bf16<Shape<128, 2, 4, 2, 4, 3, 4, 1>>(
          x, w1, b1, w2, b2, out, B, S, dil, halo, guard, stream);
    case 64:
      return (int)launch_bf16<Shape<64, 4, 2, 2, 4, 3, 2, 2>>(
          x, w1, b1, w2, b2, out, B, S, dil, halo, guard, stream);
    case 32:
      return (int)launch_bf16<Shape<32, 8, 1, 1, 4, 3, 3, 2>>(
          x, w1, b1, w2, b2, out, B, S, dil, halo, guard, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
