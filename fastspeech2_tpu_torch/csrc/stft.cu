// Fused STFT -> magnitude -> mel -> log-compress, plus per-frame energy, on
// the H100, in full f32.
//
// Replaces fastspeech2_tpu/ops/pallas/stft.py: stft_mel_energy (kernel
// _stft_mel_kernel). For a (B, N) waveform with n_fft = 4 * hop:
//   X[f, k]  = sum_n ypad[f*hop + n] * basis[n, k]    (windowed real DFT)
//   mel[m, f] = log(max(sum_k |X[f, k]| * W[k, m], clip))
//   energy[f] = sqrt(sum_k |X[f, k]|^2)
// with ypad the center reflect-padded signal (the wrapper pads, as the JAX
// wrapper does outside its kernel).
//
// Work. This design computes the DFT directly, as the TPU kernel does on its
// matrix unit: 2 * n_fft * 2 * n_freq + 2 * n_freq * n_mels FLOPs per frame
// (2,183,328 at 1024/513/80). The function itself needs about 33k per frame
// (an FFT and the filterbank's nonzero weights), which is what chip_smoke.py's
// bound counts, so a direct DFT stays far above that bound. The DFT sums
// cancel (quiet bins lose digits), so no TF32 and no tensor cores: every
// product is an explicit f32 FMA (__fmaf_rn; the sources are built with
// --fmad=false, which would otherwise split a*b + c in two).
//
// Design. One block per (row, tile of FT = 64 frames), 256 threads. The
// tile's FT + 3 hop chunks sit in shared memory, one chunk per row with a
// stride of hop + 4 floats, so frame f of the tile is chunks f..f+3 and the
// frames of neighbouring threads fall in different banks: framing is
// addressing, no gather. The block walks the bins in tiles of 64 (the basis
// is pre-laid out by the wrapper as (bin tile, n_fft, [64 re | 64 im]) with
// zero columns past n_freq); each bin tile is a register-tiled f32 GEMM over
// n_fft, every thread 4 frames x 4 bins x (re, im) in 32 accumulators, the
// basis streaming from L2 through shared memory in 32-deep slices, two in
// flight (cp.async). After a bin tile the magnitudes go to shared memory
// and are at once projected onto the mel bands (each thread 4 frames x
// n_mels/16 bands, accumulated in registers across bin tiles in bin order),
// and the power is summed per frame in registers. So |X| never leaves the
// SM and no tile holds more than 64 bins. Frames past F are not written.
#include "common.cuh"

namespace {

constexpr int FT = 64;       // frames per block
constexpr int BN = 64;       // bins per tile
constexpr int BK = 32;       // depth of one basis slice
constexpr int BCOL = 2 * BN;  // basis columns per tile: 64 re, 64 im
constexpr int STAGES = 2;
constexpr int THREADS = 256;
constexpr int MS = FT + 4;   // row stride of the magnitude tile

template <int MPT>  // mel bands per thread: ceil(n_mels / 16)
__global__ void __launch_bounds__(THREADS, 1)
stft_mel_kernel(const float* __restrict__ y, int Np, int F, int hop,
                const float* __restrict__ basis, int n_tiles,
                const float* __restrict__ melw, int n_mels, float clip,
                float* __restrict__ mel_out, float* __restrict__ en_out) {
  extern __shared__ __align__(16) float smem[];
  const int CS = hop + 4;
  float* bst = smem;                           // STAGES x BK x BCOL
  float* sig = bst + STAGES * BK * BCOL;       // (FT + 3) x CS
  float* mag = sig + (FT + 3) * CS;            // BN x MS
  const int b = blockIdx.y, f0 = blockIdx.x * FT;
  const int t = threadIdx.x;
  const int tf = t >> 4, tb = t & 15;          // DFT: frames 4tf.., bins 4tb..
  const int K = 4 * hop, nk = K / BK, n_slices = n_tiles * nk;

  // one commit group per slice (empty past the end) keeps wait counts exact
  auto stage = [&](int s) {
    if (s < n_slices) {
      const float* src = basis + (size_t)s * BK * BCOL;  // slices are contiguous
      float* dst = bst + (s % STAGES) * BK * BCOL;
      for (int i = t; i < BK * BCOL / 4; i += THREADS)
        cp_async16(dst + 4 * i, src + 4 * i, true);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) stage(s);

  // the tile's chunks; samples past the padded row read as zero
  const float* yr = y + (size_t)b * Np;
  for (int i = t; i < (FT + 3) * hop; i += THREADS) {
    const int c = i / hop, j = i - c * hop;
    const long g = (long)(f0 + c) * hop + j;
    sig[c * CS + j] = g < Np ? yr[g] : 0.f;
  }

  float en[4] = {0.f, 0.f, 0.f, 0.f};
  float mel[4][MPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < MPT; ++q) mel[i][q] = 0.f;
  const int mf = t >> 4, mm = t & 15;  // mel: frames 4mf.., bands mm + 16q

  for (int tile = 0; tile < n_tiles; ++tile) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    for (int ks = 0; ks < nk; ++ks) {
      const int s = tile * nk + ks;
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // slice s landed (and the chunks, on the first pass)
      stage(s + STAGES - 1);
      const float* Bs = bst + (s % STAGES) * BK * BCOL;
      const int k0 = ks * BK, cq = k0 / hop, within = k0 - cq * hop;
      const float* sa = sig + (4 * tf + cq) * CS + within;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(sa + i * CS + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 br = *reinterpret_cast<const float4*>(Bs + (kk + u) * BCOL + 4 * tb);
          const float4 bi = *reinterpret_cast<const float4*>(Bs + (kk + u) * BCOL + BN + 4 * tb);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float av = u == 0 ? a[i].x : u == 1 ? a[i].y : u == 2 ? a[i].z : a[i].w;
            re[i][0] = __fmaf_rn(av, br.x, re[i][0]);
            re[i][1] = __fmaf_rn(av, br.y, re[i][1]);
            re[i][2] = __fmaf_rn(av, br.z, re[i][2]);
            re[i][3] = __fmaf_rn(av, br.w, re[i][3]);
            im[i][0] = __fmaf_rn(av, bi.x, im[i][0]);
            im[i][1] = __fmaf_rn(av, bi.y, im[i][1]);
            im[i][2] = __fmaf_rn(av, bi.z, im[i][2]);
            im[i][3] = __fmaf_rn(av, bi.w, im[i][3]);
          }
        }
      }
    }

    // |X| of this bin tile to shared memory; power summed per frame
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = re[i][j] * re[i][j] + im[i][j] * im[i][j];
        en[i] += p;
        mag[(4 * tb + j) * MS + 4 * tf + i] = sqrtf(p);
      }
    __syncthreads();
    // the tile's bins onto the mel bands, in bin order
    const float* wt = melw + (size_t)tile * BN * n_mels;
    for (int k = 0; k < BN; ++k) {
      const float4 m4 = *reinterpret_cast<const float4*>(mag + k * MS + 4 * mf);
#pragma unroll
      for (int q = 0; q < MPT; ++q) {
        const int m = mm + 16 * q;
        const float w = m < n_mels ? __ldg(wt + k * n_mels + m) : 0.f;
        mel[0][q] = __fmaf_rn(m4.x, w, mel[0][q]);
        mel[1][q] = __fmaf_rn(m4.y, w, mel[1][q]);
        mel[2][q] = __fmaf_rn(m4.z, w, mel[2][q]);
        mel[3][q] = __fmaf_rn(m4.w, w, mel[3][q]);
      }
    }
    // the next write to `mag` comes after the next tile's slice barriers
  }
  cp_async_wait<0>();

  // energy: the 16 threads of a frame group share one half-warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) en[i] += __shfl_xor_sync(0xffffffffu, en[i], o);
  }
  if (tb == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = f0 + 4 * tf + i;
      if (f < F) en_out[(size_t)b * F + f] = sqrtf(en[i]);
    }
  }
#pragma unroll
  for (int q = 0; q < MPT; ++q) {
    const int m = mm + 16 * q;
    if (m >= n_mels) continue;
    float* row = mel_out + ((size_t)b * n_mels + m) * F;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = f0 + 4 * mf + i;
      if (f < F) row[f] = logf(fmaxf(mel[i][q], clip));
    }
  }
}

template <int MPT>
cudaError_t launch(const float* y, int B, int Np, int F, int hop, const float* basis,
                   int n_tiles, const float* melw, int n_mels, float clip,
                   float* mel_out, float* en_out, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)STAGES * BK * BCOL + (size_t)(FT + 3) * (hop + 4) + BN * MS);
  cudaError_t e = set_smem(stft_mel_kernel<MPT>, smem);
  if (e != cudaSuccess) return e;
  stft_mel_kernel<MPT><<<dim3((F + FT - 1) / FT, B), THREADS, smem, stream>>>(
      y, Np, F, hop, basis, n_tiles, melw, n_mels, clip, mel_out, en_out);
  return cudaGetLastError();
}

}  // namespace

// y (B, Np) f32: the center reflect-padded signal (Np = N + n_fft);
// basis (n_tiles, 4*hop, 128) f32: the windowed [cos | -sin] DFT basis in bin
// tiles of 64 (64 re then 64 im columns, zeros past n_freq); melw
// (n_tiles*64, n_mels) f32: the mel filterbank transposed, zero rows past
// n_freq. Writes mel_out (B, n_mels, F) = log(max(mel, clip)) and en_out
// (B, F). hop a multiple of 32 up to 256; n_mels up to 128.
FS2_EXPORT int fs2_stft_mel_energy(const float* y, int B, int Np, int F, int hop,
                                   const float* basis, int n_tiles, const float* melw,
                                   int n_mels, float clip, float* mel_out,
                                   float* en_out, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (B < 1 || F < 1 || hop < 32 || hop > 256 || hop % 32 != 0 || n_mels < 1 ||
      n_mels > 128 || n_tiles * BN < 2 * hop + 1 || (long)(F - 1) * hop + 4 * hop > Np)
    return (int)cudaErrorInvalidValue;
  switch ((n_mels + 15) / 16) {
#define FS2_STFT_CASE(q) \
  case q:                \
    return (int)launch<q>(y, B, Np, F, hop, basis, n_tiles, melw, n_mels, clip, mel_out, en_out, stream);
    FS2_STFT_CASE(1)
    FS2_STFT_CASE(2)
    FS2_STFT_CASE(3)
    FS2_STFT_CASE(4)
    FS2_STFT_CASE(5)
    FS2_STFT_CASE(6)
    FS2_STFT_CASE(7)
    FS2_STFT_CASE(8)
#undef FS2_STFT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
