// Fused STFT -> magnitude -> mel -> log-compress, plus per-frame energy, on
// the H100, in full f32.
//
// Replaces fastspeech2_tpu/ops/pallas/stft.py: stft_mel_energy (kernel
// _stft_mel_kernel). For a (B, N) waveform with n_fft = 4 * hop:
//   X[f, k]   = rfft(window * ypad[f*hop : f*hop + n_fft])[k], k < n_freq
//   mel[m, f] = log(max(sum_k |X[f, k]| * fb[m, k], clip))
//   energy[f] = sqrt(sum_k |X[f, k]|^2)
// with ypad the center reflect-padded signal.
//
// Bound. The TPU kernel runs a direct DFT as matrix-unit products (2,183,328
// FLOPs a frame at n_fft 1024); the function needs a real FFT and the
// filterbank's nonzero weights, about 33k FLOPs a frame. At the corpus's
// longest bucket (8, 229,376), 7,176 frames, that is 0.24 GFLOP: 3.6 us at
// the card's 67 TFLOP/s of f32, against 9.6 MB of signal and outputs, 2.9 us
// at 3.35 TB/s, so operations bound it. The sums cancel (quiet bins lose
// digits), so no TF32 and no tensor cores: every product is an explicit f32
// FMA (__fmaf_rn; the sources are built with --fmad=false, which would
// otherwise split a*b + c in two). What holds this kernel back in practice is
// shared memory and its latency: every pass reads and writes the whole frame.
//
// Design. One block of 8 warps per (row, FT = 8 consecutive frames), one
// warp a frame: 904 blocks at the longest bucket, 72 at (8, 16,384), and at
// hop 256 three blocks share a multiprocessor (75 KB of shared memory and at
// most 85 registers a thread each). Measured against 16 frames a block (two
// a warp, 2 blocks an SM) and against two butterflies in flight a lane (127
// registers): no faster at hop 256, 11% slower at hop 200
// (scripts/time_stft.py on variant trees).
// 1. Framing is addressing: the block copies the span ypad[f0*hop,
//    (f0+FT+3)*hop) into shared memory with 4-byte cp.async, all in flight
//    at once, and the window and twiddle tables beside it. The kernel pads
//    by reflection as it loads (numpy's reflect, again and again for rows
//    shorter than the pad), so the signal crosses device memory once and a
//    batch is one launch. Frame i starts at i*hop, any hop.
// 2. A real FFT by a half-size complex FFT, one warp per frame: the n_fft
//    windowed samples, packed as n_fft/2 complex points (even samples real,
//    odd imaginary), go through one decimation-in-frequency pass per radix
//    of the host's plan (8, 4, 2, 5, 3: n_fft/2 = 2^a 3^b 5^c), in place in
//    the warp's own buffer: a butterfly writes back the points it read, so a
//    lane needs only its butterflies' points in registers and a pass ends
//    with one __syncwarp. (A Stockham pass in place has to hold a lane's
//    whole share of the frame across a __syncwarp: it spilled at 128 and at
//    255 registers; out of place it doubles the buffers.) The first pass
//    reads the frame straight from the span. The buffer's index i + i/16
//    spreads the strided accesses over the banks. The bins come out
//    digit-reversed; a table says where each sits. Twiddles come from tables
//    built in float64 (no __sinf/__cosf). The untangle post-pass,
//      X[k] = E + W^k O,  X[N-k] = conj(E - W^k O),
//      E = (Z[k] + Z*[N-k]) / 2,  O = -i (Z[k] - Z*[N-k]) / 2,
//    gives |X| into the block's magnitude tile and the power to a warp sum
//    (the energy).
// 3. The mel projection reads each band's nonzero bin range only (from the
//    filterbank, cached by the wrapper; 727 weights of 41,040 at 80 bands),
//    in bin order: a thread takes one frame and every 32nd band, so the
//    weight a warp reads is one of 4 addresses, and frames sit at an odd
//    stride (n_freq) in the magnitude tile.
// 4. The (n_mels x FT) log-mel tile is staged in shared memory over the dead
//    signal span and written band by band as contiguous runs of FT frames.
//    Frames past F are neither computed nor written.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int FT = 8;  // frames a block: one a warp
constexpr int MAX_N2 = 1024;  // n_fft / 2 for hop 512

__device__ __forceinline__ int bpad(int i) { return i + (i >> 4); }

// 4-byte global -> shared copy that bypasses registers: a thread keeps all of
// its span's copies in flight at once
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(__fmaf_rn(a.x, w.x, -a.y * w.y), __fmaf_rn(a.x, w.y, a.y * w.x));
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// -i * a and +i * a
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }
__device__ __forceinline__ float2 mul_pi(float2 a) { return make_float2(-a.y, a.x); }

// In-register DFTs of R points, natural order in and out:
// v[r] <- sum_n v[n] exp(-2 pi i n r / R).
template <int R>
__device__ __forceinline__ void dft(float2* v);

template <>
__device__ __forceinline__ void dft<2>(float2* v) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void dft<4>(float2* v) {
  const float2 s02 = cadd(v[0], v[2]), d02 = csub(v[0], v[2]);
  const float2 s13 = cadd(v[1], v[3]), d13 = mul_mi(csub(v[1], v[3]));
  v[0] = cadd(s02, s13);
  v[2] = csub(s02, s13);
  v[1] = cadd(d02, d13);
  v[3] = csub(d02, d13);
}

template <>
__device__ __forceinline__ void dft<8>(float2* v) {
  constexpr float S = 0.70710678118654752f;  // sqrt(1/2)
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e);
  dft<4>(o);
  // o[r] *= exp(-2 pi i r / 8)
  o[1] = make_float2((o[1].x + o[1].y) * S, (o[1].y - o[1].x) * S);
  o[2] = mul_mi(o[2]);
  o[3] = make_float2((o[3].y - o[3].x) * S, -(o[3].x + o[3].y) * S);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    v[r] = cadd(e[r], o[r]);
    v[r + 4] = csub(e[r], o[r]);
  }
}

template <>
__device__ __forceinline__ void dft<3>(float2* v) {
  constexpr float C = -0.5f, S = 0.86602540378443865f;  // exp(-2 pi i / 3) = C - iS
  const float2 t = cadd(v[1], v[2]), d = mul_mi(csub(v[1], v[2]));
  const float2 m = make_float2(__fmaf_rn(C, t.x, v[0].x), __fmaf_rn(C, t.y, v[0].y));
  v[0] = cadd(v[0], t);
  v[1] = make_float2(__fmaf_rn(S, d.x, m.x), __fmaf_rn(S, d.y, m.y));
  v[2] = make_float2(__fmaf_rn(-S, d.x, m.x), __fmaf_rn(-S, d.y, m.y));
}

template <>
__device__ __forceinline__ void dft<5>(float2* v) {
  // cos and sin of 2 pi / 5 and 4 pi / 5
  constexpr float C1 = 0.30901699437494742f, C2 = -0.80901699437494742f;
  constexpr float S1 = 0.95105651629515357f, S2 = 0.58778525229247313f;
  const float2 t1 = cadd(v[1], v[4]), t2 = cadd(v[2], v[3]);
  const float2 d1 = csub(v[1], v[4]), d2 = csub(v[2], v[3]);
  const float2 x0 = v[0];
  const float2 a1 = make_float2(__fmaf_rn(C2, t2.x, __fmaf_rn(C1, t1.x, x0.x)),
                                __fmaf_rn(C2, t2.y, __fmaf_rn(C1, t1.y, x0.y)));
  const float2 a2 = make_float2(__fmaf_rn(C1, t2.x, __fmaf_rn(C2, t1.x, x0.x)),
                                __fmaf_rn(C1, t2.y, __fmaf_rn(C2, t1.y, x0.y)));
  const float2 b1 = make_float2(__fmaf_rn(S2, d2.x, S1 * d1.x), __fmaf_rn(S2, d2.y, S1 * d1.y));
  const float2 b2 = make_float2(__fmaf_rn(-S1, d2.x, S2 * d1.x), __fmaf_rn(-S1, d2.y, S2 * d1.y));
  v[0] = cadd(x0, cadd(t1, t2));
  v[1] = cadd(a1, mul_mi(b1));
  v[4] = cadd(a1, mul_pi(b1));
  v[2] = cadd(a2, mul_mi(b2));
  v[3] = cadd(a2, mul_pi(b2));
}

// One decimation-in-frequency pass of radix R over the warp's n2 points, in
// place in z, at stride s (n2 / R for the first pass, 1 for the last):
// butterfly q (j = q mod s) takes the points at (q - j) R + j + r s, r < R,
// transforms them, multiplies output r by exp(-2 pi i r j / (s R)) (table
// tw, this stride's block at s - 1) and writes it back where it read. The
// butterflies of a pass touch disjoint points, so a lane writes as soon as
// it has read; one __syncwarp ends the pass. The first pass reads the
// windowed frame x * win instead of z (x as float2 when the frame starts on
// 8 bytes).
template <int R>
__device__ __forceinline__ void dif_pass(bool first, const float* __restrict__ x,
                                         const float* __restrict__ win, float2* z,
                                         const float2* tw, int n2, int s, int lane) {
  const int nb = n2 / R;
  const bool pow2 = (s & (s - 1)) == 0;
  const bool x2 = (reinterpret_cast<size_t>(x) & 7) == 0;
  for (int q = lane; q < nb; q += 32) {
    const int j = pow2 ? (q & (s - 1)) : q % s, base = (q - j) * R + j;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = base + r * s;
      if (!first) {
        v[r] = z[bpad(p)];
      } else {
        const float2 w = reinterpret_cast<const float2*>(win)[p];
        const float2 a = x2 ? reinterpret_cast<const float2*>(x)[p]
                            : make_float2(x[2 * p], x[2 * p + 1]);
        v[r] = make_float2(a.x * w.x, a.y * w.y);
      }
    }
    dft<R>(v);
    if (s > 1) {
      const float2* t = tw + (s - 1) + j;
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], t[(r - 1) * s]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) z[bpad(base + r * s)] = v[r];
  }
  __syncwarp();
}

// The block's shared-memory layout, in floats; every part starts on 16 bytes.
struct Layout {
  int span, tables, fft, buf, mag, en, total;
  __host__ __device__ Layout(int hop, int n_mels) {
    const int n2 = 2 * hop, n_freq = n2 + 1;
    const int span4 = ((FT + 3) * hop + 3) & ~3;
    const int tile = n_mels * FT;
    span = 0;
    tables = ((span4 > tile ? span4 : tile) + 3) & ~3;
    buf = (2 * (n2 + (n2 - 1) / 16 + 1) + 3) & ~3;  // one warp's buffer
    fft = tables + table_floats(hop);
    mag = fft + NW * buf;
    en = mag + ((FT * n_freq + 3) & ~3);
    total = en + FT;
  }
  // window (n_fft) | pass twiddles (n2 - 1 complex) | untangle twiddles
  // (n2/2 + 1 complex) | where each bin lands (n2 int32), each part rounded
  // up to 4 floats
  __host__ __device__ static int table_floats(int hop) {
    return 4 * hop + 4 * hop + ((2 * (hop + 1) + 3) & ~3) + ((2 * hop + 3) & ~3);
  }
};

__global__ void __launch_bounds__(THREADS, 3)
stft_fft_kernel(const float* __restrict__ y, int N, int F, int hop, int plan,
                const float* __restrict__ tables, const int2* __restrict__ bands,
                const float* __restrict__ fb, int n_mels, float clip,
                float* __restrict__ mel_out, float* __restrict__ en_out) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(hop, n_mels);
  const int n_fft = 4 * hop, n2 = 2 * hop, n_freq = n2 + 1;
  const int b = blockIdx.y, f0 = blockIdx.x * FT;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  float* sig = smem + L.span;
  float* tab = smem + L.tables;
  float* mag = smem + L.mag;
  float* en = smem + L.en;
  const float* win = tab;
  const float2* tw = reinterpret_cast<const float2*>(tab + n_fft);
  const float2* un = reinterpret_cast<const float2*>(tab + 2 * n_fft);
  const int* pos = reinterpret_cast<const int*>(tab + 2 * n_fft + ((2 * (hop + 1) + 3) & ~3));

  // 1. the tables, and the span of the center reflect-padded row: padded
  //    sample g is y[g - 2 hop] reflected into [0, N) (numpy's reflect,
  //    again and again where the row is shorter than the pad)
  {
    const int table_groups = Layout::table_floats(hop) / 4;
    for (int i = t; i < table_groups; i += THREADS)
      cp_async16(tab + 4 * i, tables + 4 * i, true);
    cp_async_commit();
    const float* yr = y + (size_t)b * N;
    const int g0 = f0 * hop - n2;  // padded sample 0 of the span, in y's index
    const int period = 2 * (N - 1);
    for (int i = t; i < (FT + 3) * hop; i += THREADS) {
      int g = g0 + i;
      if (g < 0 || g >= N) {
        g = period > 0 ? g % period : 0;
        g = g < 0 ? -g : g;
        g = g >= N ? period - g : g;
      }
      cp_async4(sig + i, yr + g);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // 2. one warp per frame: FFT, untangle, |X| and the energy
  float2* z = reinterpret_cast<float2*>(smem + L.fft + warp * L.buf);
  if (f0 + warp < F) {
    const float* x = sig + warp * hop;
    int s = n2;
    for (int p = 0, code = plan; code != 0; ++p, code >>= 4) {
      const int R = code & 15;
      s /= R;
      if (R == 8)
        dif_pass<8>(p == 0, x, win, z, tw, n2, s, lane);
      else if (R == 4)
        dif_pass<4>(p == 0, x, win, z, tw, n2, s, lane);
      else if (R == 2)
        dif_pass<2>(p == 0, x, win, z, tw, n2, s, lane);
      else if (R == 5)
        dif_pass<5>(p == 0, x, win, z, tw, n2, s, lane);
      else
        dif_pass<3>(p == 0, x, win, z, tw, n2, s, lane);
    }
    // Z[k] sits at pos[k] (the passes leave the bins digit-reversed)
    float* m = mag + warp * n_freq;
    float e = 0.f;
    for (int k = lane; k <= hop; k += 32) {  // bins k and n2 - k
      const float2 A = z[bpad(pos[k])], Bc = z[bpad(pos[k == 0 ? 0 : n2 - k])];
      const float Er = 0.5f * (A.x + Bc.x), Ei = 0.5f * (A.y - Bc.y);
      const float2 O = make_float2(0.5f * (A.y + Bc.y), -0.5f * (A.x - Bc.x));
      const float2 T = cmul(O, un[k]);
      const float pr = Er + T.x, pi = Ei + T.y, qr = Er - T.x, qi = Ei - T.y;
      const float p = __fmaf_rn(pr, pr, pi * pi), q = __fmaf_rn(qr, qr, qi * qi);
      m[k] = sqrtf(p);
      e += p;
      if (k != n2 - k) {
        m[n2 - k] = sqrtf(q);
        e += q;
      }
    }
    e = warp_sum(e);
    if (lane == 0) en[warp] = sqrtf(e);
  }
  __syncthreads();

  // 3. the mel projection over each band's nonzero bins, in bin order
  float* tile = sig;  // the span is dead
  {
    const int f = t % FT, G = THREADS / FT;
    if (f0 + f < F) {
      const float* mf = mag + f * n_freq;
      for (int mb = t / FT; mb < n_mels; mb += G) {
        const int2 r = __ldg(bands + mb);  // first bin, count
        const float* w = fb + (size_t)mb * n_freq + r.x;
        float acc = 0.f;
        for (int k = 0; k < r.y; ++k) acc = __fmaf_rn(mf[r.x + k], __ldg(w + k), acc);
        tile[mb * FT + f] = logf(fmaxf(acc, clip));
      }
    }
  }
  __syncthreads();

  // 4. each band's FT frames as one run of the output row; the energies
  const int nf = min(FT, F - f0);
  float* out = mel_out + (size_t)b * n_mels * F + f0;
  for (int i = t; i < n_mels * FT; i += THREADS) {
    const int mb = i / FT, f = i - mb * FT;
    if (f < nf) out[(size_t)mb * F + f] = tile[i];
  }
  if (t < nf) en_out[(size_t)b * F + f0 + t] = en[t];
}

}  // namespace

// y (B, N) f32, the signal (the kernel center-pads it by reflection);
// tables: the window, pass and untangle twiddles and the bins' positions
// (Layout::table_floats(hop) f32) for the radix plan `plan` (one radix per 4
// bits, first pass lowest; their product n_fft / 2 = 2 * hop); bands
// (n_mels) int2: each band's first nonzero bin and bin count in fb (n_mels,
// n_freq) f32. Writes mel_out (B, n_mels, F) = log(max(mel, clip)) and
// en_out (B, F), F = N / hop + 1. hop 32-512, n_mels 1 to n_freq.
FS2_EXPORT int fs2_stft_mel_energy(const float* y, int B, int N, int hop, int plan,
                                   const float* tables, const int* bands, const float* fb,
                                   int n_mels, float clip, float* mel_out, float* en_out,
                                   void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  long prod = 1;
  for (int code = plan; code != 0; code >>= 4) {
    const int R = code & 15;
    if (R != 2 && R != 3 && R != 4 && R != 5 && R != 8) return (int)cudaErrorInvalidValue;
    prod *= R;
  }
  if (B < 1 || B > 65535 || N < 1 || N > (1 << 30) || hop < 32 || 2 * hop > MAX_N2 ||
      prod != 2 * hop || n_mels < 1 || n_mels > 2 * hop + 1)
    return (int)cudaErrorInvalidValue;
  const int F = N / hop + 1;
  const size_t smem = sizeof(float) * (size_t)Layout(hop, n_mels).total;
  cudaError_t e = set_smem(stft_fft_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  stft_fft_kernel<<<dim3((F + FT - 1) / FT, B), THREADS, smem, stream>>>(
      y, N, F, hop, plan, tables, reinterpret_cast<const int2*>(bands), fb, n_mels,
      clip, mel_out, en_out);
  return (int)cudaGetLastError();
}
