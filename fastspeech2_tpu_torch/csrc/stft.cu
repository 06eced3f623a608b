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
//    of the plan (`st_make_plan`: 8s, a 4, a 2, 5s, 3s, 7s, 11s, 13s, then
//    any larger prime factor), in place in the warp's own buffer: a butterfly writes back the points it read, so a
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
// Every hop from 1 to 1024. A prime factor above 13 (hop 257: n_fft / 2 =
// 2 * 257) takes a direct DFT pass: each butterfly's R outputs, a lane at a
// time, as sums of R products with the R-th roots of unity (a float64 table
// cast once, beside the twiddles), written to the warp's magnitude row (free
// until the untangle) and copied back after a __syncwarp; N * R operations a
// frame where a register butterfly costs N * log R. Frames a block: 8 where
// the layout fits in shared memory, else 4 (hop above ~770; 4 warps a
// block). Plans of radices 8, 4, 2, 5 and 3 with 8 frames a block run the
// kernel of the hops 32-512 with 2^a 3^b 5^c points, as it was
// (`stft_fft_kernel<8, false>`: the plan's radices in 4-bit fields).
#include "common.cuh"

namespace {

constexpr int MAX_N2 = 2048;      // n_fft / 2 for hop 1024
constexpr int MAX_PASSES = 12;    // 2 * 3^6 = 1,458 points take 7
constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100

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

// An odd prime R's DFT from the pairs t_k = v_k + v_{R-k}, d_k = v_k -
// v_{R-k}: out_m = v_0 + sum_k cos(2 pi k m / R) t_k - i sum_k sin(2 pi k m
// / R) d_k, out_{R-m} the same with + i, k, m = 1 .. (R-1)/2; c[j], s[j] the
// cosine and sine of 2 pi j / R (the radix-5 and radix-3 passes above are
// this, written out).
template <int R>
__device__ __forceinline__ void dft_odd(float2* v, const float (&c)[(R + 1) / 2],
                                        const float (&s)[(R + 1) / 2]) {
  constexpr int H = (R - 1) / 2;
  float2 t[H], d[H];
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    t[k - 1] = cadd(v[k], v[R - k]);
    d[k - 1] = csub(v[k], v[R - k]);
  }
  const float2 x0 = v[0];
  float2 sum = x0;
#pragma unroll
  for (int k = 0; k < H; ++k) sum = cadd(sum, t[k]);
#pragma unroll
  for (int m = 1; m <= H; ++m) {
    float2 a = x0, b = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      const int j = k * m % R, jj = j <= H ? j : R - j;
      const float ck = c[jj], sk = j <= H ? s[jj] : -s[jj];
      a = make_float2(__fmaf_rn(ck, t[k - 1].x, a.x), __fmaf_rn(ck, t[k - 1].y, a.y));
      b = k == 1 ? make_float2(sk * d[0].x, sk * d[0].y)
                 : make_float2(__fmaf_rn(sk, d[k - 1].x, b.x), __fmaf_rn(sk, d[k - 1].y, b.y));
    }
    v[m] = cadd(a, mul_mi(b));
    v[R - m] = cadd(a, mul_pi(b));
  }
  v[0] = sum;
}

template <>
__device__ __forceinline__ void dft<7>(float2* v) {
  const float c[4] = {1.f, 0.62348980185873353f, -0.22252093395631440f, -0.90096886790241913f};
  const float s[4] = {0.f, 0.78183148246802981f, 0.97492791218182361f, 0.43388373911755812f};
  dft_odd<7>(v, c, s);
}

template <>
__device__ __forceinline__ void dft<11>(float2* v) {
  const float c[6] = {1.f, 0.84125353283118117f, 0.41541501300188643f, -0.14231483827328514f,
                      -0.65486073394528506f, -0.95949297361449739f};
  const float s[6] = {0.f, 0.54064081745559756f, 0.90963199535451837f, 0.98982144188093274f,
                      0.75574957435425828f, 0.28173255684142969f};
  dft_odd<11>(v, c, s);
}

template <>
__device__ __forceinline__ void dft<13>(float2* v) {
  const float c[7] = {1.f, 0.88545602565320989f, 0.56806474673115581f, 0.12053668025532305f,
                      -0.35460488704253562f, -0.74851074817110109f, -0.97094181742605203f};
  const float s[7] = {0.f, 0.46472317204376856f, 0.82298386589365635f, 0.99270887409805397f,
                      0.93501624268541483f, 0.66312265824079520f, 0.23931566428755777f};
  dft_odd<13>(v, c, s);
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

// A direct DFT pass of prime radix R (above 13) over the warp's n2 points at
// stride s, as dif_pass<R> computes it: butterfly q at a time (the whole
// warp), output k of a lane as sum_n v_n exp(-2 pi i n k / R) (`roots`, the
// R roots of unity), times its twiddle, into `scr` (2 R floats, the warp's
// magnitude row); then back where the butterfly read. Never a first pass (n2
// is even: the plan starts with an 8, a 4 or a 2).
__device__ __noinline__ void direct_pass(float2* z, const float2* __restrict__ roots,
                                         float* scr, const float2* tw, int n2, int R, int s,
                                         int lane) {
  for (int q = 0; q < n2 / R; ++q) {
    const int j = q % s, base = (q - j) * R + j;
    for (int k = lane; k < R; k += 32) {
      float2 acc = make_float2(0.f, 0.f);
      for (int n = 0, m = 0; n < R; ++n) {
        const float2 v = z[bpad(base + n * s)], w = roots[m];
        acc = make_float2(__fmaf_rn(v.x, w.x, __fmaf_rn(-v.y, w.y, acc.x)),
                          __fmaf_rn(v.x, w.y, __fmaf_rn(v.y, w.x, acc.y)));
        m += k;
        if (m >= R) m -= R;
      }
      if (s > 1 && k > 0) acc = cmul(acc, tw[(s - 1) + (k - 1) * s + j]);
      scr[2 * k] = acc.x;
      scr[2 * k + 1] = acc.y;
    }
    __syncwarp();
    for (int k = lane; k < R; k += 32) z[bpad(base + k * s)] = make_float2(scr[2 * k], scr[2 * k + 1]);
    __syncwarp();
  }
}

// The block's shared-memory layout, in floats, for FT frames a block (one
// warp each) and `roots` floats of direct-pass roots; every part starts on
// 16 bytes.
struct Layout {
  int span, tables, fft, buf, mag, en, total;
  __host__ __device__ Layout(int hop, int n_mels, int FT, int roots) {
    const int n2 = 2 * hop, n_freq = n2 + 1;
    const int span4 = ((FT + 3) * hop + 3) & ~3;
    const int tile = n_mels * FT;
    span = 0;
    tables = ((span4 > tile ? span4 : tile) + 3) & ~3;
    buf = (2 * (n2 + (n2 - 1) / 16 + 1) + 3) & ~3;  // one warp's buffer
    fft = tables + table_floats(hop) + roots;
    mag = fft + FT * buf;
    en = mag + ((FT * n_freq + 3) & ~3);
    total = en + FT;
  }
  // window (n_fft) | pass twiddles (n2 - 1 complex) | untangle twiddles
  // (n2/2 + 1 complex) | where each bin lands (n2 int32), each part rounded
  // up to 4 floats; the direct passes' roots follow
  __host__ __device__ static int table_floats(int hop) {
    return 4 * hop + 4 * hop + ((2 * (hop + 1) + 3) & ~3) + ((2 * hop + 3) & ~3);
  }
};

// The radices of a plan, in pass order (a kernel parameter read by index).
struct Passes {
  int n;
  int r[MAX_PASSES];
};

// The plan of one hop; mirrors ops/kernels/stft.py:plan (fs2_stft_plan lets a
// test hold the two together).
struct StPlan {
  Passes p;
  int gen;    // a radix other than 8, 4, 2, 5, 3
  int roots;  // floats of the direct passes' roots, rounded up to 4
  int ft;     // frames a block
  int smem;   // bytes
};

bool st_make_plan(int hop, int n_mels, StPlan* pl) {
  if (hop < 1 || 2 * hop > MAX_N2 || n_mels < 1 || n_mels > 2 * hop + 1) return false;
  int n = 2 * hop, roots = 0;
  pl->p.n = 0;
  pl->gen = 0;
  auto push = [&](int r) {
    if (pl->p.n == MAX_PASSES) return false;
    pl->p.r[pl->p.n++] = r;
    n /= r;
    return true;
  };
  const int reg[8][2] = {{8, 0}, {4, 1}, {2, 1}, {5, 0}, {3, 0}, {7, 0}, {11, 0}, {13, 0}};
  for (const auto& ro : reg) {
    while (n % ro[0] == 0) {
      if (!push(ro[0])) return false;
      pl->gen |= ro[0] == 7 || ro[0] > 8;  // no 4-bit field for these
      if (ro[1]) break;
    }
  }
  for (int q = 17; n > 1; q += 2) {
    while (n % q == 0) {
      if (!push(q)) return false;
      pl->gen = 1;
      roots += q;
    }
  }
  pl->roots = (2 * roots + 3) & ~3;
  const int fts[2] = {8, 4};
  for (int ft : fts) {
    pl->ft = ft;
    pl->smem = (int)sizeof(float) * Layout(hop, n_mels, ft, pl->roots).total;
    if (pl->smem <= SMEM_MAX) return true;
  }
  return false;
}

// FT frames a block (a warp each). GEN: any plan (`ps`, radices by index,
// `roots` floats of direct-pass roots after the tables); else radices 8, 4,
// 2, 5 and 3 in 4-bit fields of `plan`, first pass lowest.
template <int FT, bool GEN>
__global__ void __launch_bounds__(32 * FT, GEN && FT == 8 ? 2 : 3)
stft_fft_kernel(const float* __restrict__ y, int N, int F, int hop, int plan,
                const __grid_constant__ Passes ps, int roots,
                const float* __restrict__ tables, const int2* __restrict__ bands,
                const float* __restrict__ fb, int n_mels, float clip,
                float* __restrict__ mel_out, float* __restrict__ en_out) {
  constexpr int THREADS = 32 * FT;
  extern __shared__ __align__(16) float smem[];
  const int rf = GEN ? roots : 0;
  const Layout L(hop, n_mels, FT, rf);
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
    const int table_groups = (Layout::table_floats(hop) + rf) / 4;
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
    float* m = mag + warp * n_freq;
    int s = n2;
    if constexpr (!GEN) {
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
    } else {
      // the first pass is an 8, a 4 or a 2 (n2 is even)
      const float2* rt = reinterpret_cast<const float2*>(tab + Layout::table_floats(hop));
      for (int p = 0; p < ps.n; ++p) {
        const int R = ps.r[p];
        s /= R;
        if (R == 8)
          dif_pass<8>(p == 0, x, win, z, tw, n2, s, lane);
        else if (R == 4)
          dif_pass<4>(p == 0, x, win, z, tw, n2, s, lane);
        else if (R == 2)
          dif_pass<2>(p == 0, x, win, z, tw, n2, s, lane);
        else if (R == 5)
          dif_pass<5>(false, x, win, z, tw, n2, s, lane);
        else if (R == 3)
          dif_pass<3>(false, x, win, z, tw, n2, s, lane);
        else if (R == 7)
          dif_pass<7>(false, x, win, z, tw, n2, s, lane);
        else if (R == 11)
          dif_pass<11>(false, x, win, z, tw, n2, s, lane);
        else if (R == 13)
          dif_pass<13>(false, x, win, z, tw, n2, s, lane);
        else {
          direct_pass(z, rt, m, tw, n2, R, s, lane);
          rt += R;
        }
      }
    }
    // Z[k] sits at pos[k] (the passes leave the bins digit-reversed)
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

template <int FT, bool GEN>
cudaError_t launch_frames(const StPlan& pl, int code, const float* y, int B, int N, int F,
                          int hop, const float* tables, const int* bands, const float* fb,
                          int n_mels, float clip, float* mel_out, float* en_out,
                          cudaStream_t stream) {
  cudaError_t e = set_smem(stft_fft_kernel<FT, GEN>, pl.smem);
  if (e != cudaSuccess) return e;
  stft_fft_kernel<FT, GEN><<<dim3((F + FT - 1) / FT, B), 32 * FT, pl.smem, stream>>>(
      y, N, F, hop, code, pl.p, pl.roots, tables, reinterpret_cast<const int2*>(bands), fb,
      n_mels, clip, mel_out, en_out);
  return cudaGetLastError();
}

// y (B, N) f32, the signal (the kernel center-pads it by reflection);
// tables: the window, pass and untangle twiddles, the bins' positions
// (Layout::table_floats(hop) f32) and the direct passes' roots for the plan
// of `hop` (ops/kernels/stft.py:_device_tables); bands (n_mels) int2: each
// band's first nonzero bin and bin count in fb (n_mels, n_freq) f32. Writes
// mel_out (B, n_mels, F) = log(max(mel, clip)) and en_out (B, F), F = N /
// hop + 1. hop 1-1024, n_mels 1 to n_freq.
FS2_EXPORT int fs2_stft_mel_energy(const float* y, int B, int N, int hop, const float* tables,
                                   const int* bands, const float* fb, int n_mels, float clip,
                                   float* mel_out, float* en_out, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  StPlan pl;
  if (B < 1 || B > 65535 || N < 1 || N > (1 << 30) || !st_make_plan(hop, n_mels, &pl))
    return (int)cudaErrorInvalidValue;
  const int F = N / hop + 1;
  cudaError_t e;
  if (pl.ft == 8 && !pl.gen) {
    int code = 0;
    for (int i = 0; i < pl.p.n; ++i) code |= pl.p.r[i] << (4 * i);
    e = launch_frames<8, false>(pl, code, y, B, N, F, hop, tables, bands, fb, n_mels, clip,
                                mel_out, en_out, stream);
  } else if (pl.ft == 8) {
    e = launch_frames<8, true>(pl, 0, y, B, N, F, hop, tables, bands, fb, n_mels, clip,
                               mel_out, en_out, stream);
  } else {
    e = launch_frames<4, true>(pl, 0, y, B, N, F, hop, tables, bands, fb, n_mels, clip,
                               mel_out, en_out, stream);
  }
  return (int)e;
}

// The plan of a hop, as ops/kernels/stft.py:plan gives its radices: the
// number of passes, 12 radices, the frames a block and the shared-memory
// bytes into out[0..14]. Returns 0, or cudaErrorInvalidValue for a hop (or
// band count) the kernel does not take.
FS2_EXPORT int fs2_stft_plan(int hop, int n_mels, int* out) {
  StPlan pl;
  if (!st_make_plan(hop, n_mels, &pl)) return (int)cudaErrorInvalidValue;
  out[0] = pl.p.n;
  for (int i = 0; i < MAX_PASSES; ++i) out[1 + i] = i < pl.p.n ? pl.p.r[i] : 0;
  out[13] = pl.ft;
  out[14] = pl.smem;
  return 0;
}
