// FFT-block conv-FFN on the H100, one body with three entries:
//   fs2_ffn_block      out = LN(x + FFN(mask(x)))    post-LN block half
//   fs2_ffn_block_pre  out = x + FFN(mask(LN(x)))    pre-LN block half
//   fs2_ffn            out = FFN(mask(x))            bare, bf16 in, O outputs
// with FFN(z) = Conv1d_k1(ReLU(Conv1d_k(z))), SAME zero padding, and mask()
// zeroing rows at or past the length.
//
// Replaces fastspeech2_tpu/ops/pallas/ffn.py: fused_ffn_block_post (kernel
// _ffn_block_post_kernel), fused_ffn_block (kernel _ffn_block_kernel, every
// pre-LN block) and fused_ffn (kernel _ffn_kernel).
//
// Bound on the H100: 2*(k*D*H + H*O) FLOPs per row (~7.9 MFLOP at D=O=384,
// H=1024, k=9) against 8*D bytes of f32 in and out per row: ~2,500 FLOP/byte,
// far above the ridge (~295) -- tensor-core (operations) bound.
//
// Design: csrc/ffn_body.cuh (a k-tap conv launch writing the bf16 hidden,
// then a k=1 conv launch with the entry's epilogue). D from 1 to 2048 (the
// x tile in column chunks past what fits whole), any H and O, odd k:
// the weights come padded (w1 (Hd, K*Dp), Dp = D rounded up to 32, zero
// columns past D in each tap, Hd a multiple of 32 with zero rows and bias
// past the model's H; w2 (O, Hd) with zero columns there), x and out keep
// their real width, and x is read by threads, so no row stride meets a TMA
// rule.
#include "ffn_body.cuh"

namespace {

template <int IN, int OUT>
cudaError_t launch_ffn(Args a, const bf16* w1, int B, cudaStream_t stream) {
  Plan pl;
  const int T = a.T, D = a.D, Hd = a.Hd, K = a.K, O = a.O, Dp = pad32(D);
  if (D < 1 || Hd % 32 != 0 || K % 2 != 1 || O < 1 || B < 1 || T < 1 ||
      !make_plan(D, Hd, K, O, &pl))
    return cudaErrorInvalidValue;
  // the bias-only row lives behind the hidden, 16-byte aligned
  a.crow = reinterpret_cast<float*>(reinterpret_cast<char*>(a.hid) +
                                    ((size_t)B * T * Hd * 2 + 15) / 16 * 16);
  CUtensorMap tw1, thid, tw2;
  cudaError_t e;
  if ((e = tma_map_bf16_2d(&tw1, w1, (uint64_t)K * Dp, Hd, (uint64_t)K * Dp, pl.nh)) !=
          cudaSuccess ||
      (e = tma_map_bf16_2d(&thid, a.hid, Hd, (uint64_t)B * T, Hd, 64)) != cudaSuccess ||
      (e = tma_map_bf16_2d(&tw2, a.w2, Hd, O, Hd, pl.no)) != cudaSuccess)
    return e;
  if ((e = launch_conv<IN, CONV_RELU>(tw1, a, pl, B, stream)) != cudaSuccess) return e;
  return launch_epilogue<OUT>(thid, tw2, a, pl, B, stream);
}

}  // namespace

// x (B,T,D) f32; w1 (Hd, K*Dp) bf16 [(out, tap, in)], Dp = D rounded up to
// 32, zero past D in each tap; Hd a multiple of 32; b1 (Hd) f32;
// w2 (D, Hd) bf16 (out, in); b2/g/be (D) f32; lens (B) i32; hid bf16 scratch
// of B*T*Hd values (16-byte aligned) followed by D floats, 16-byte aligned
// (ops/kernels/ffn.py:scratch_elems); out (B,T,D) f32.
// Post-LN: LN(x + FFN(mask(x))).
FS2_EXPORT int fs2_ffn_block(const float* x, const bf16* w1, const float* b1,
                             const bf16* w2, const float* b2, const float* g,
                             const float* be, const int* lens, bf16* hid,
                             float* out, int B, int T, int D, int Hd, int K,
                             float eps, void* stream_ptr) {
  return (int)launch_ffn<IN_F32, OUT_POST_LN>(
      Args{x, g, be, b1, w2, b2, lens, hid, nullptr, out, T, D, Hd, K, D, 1, eps}, w1, B,
      reinterpret_cast<cudaStream_t>(stream_ptr));
}

// Pre-LN: x + FFN(mask(LN(x))), g/be the LayerNorm on the conv input; the
// same arguments as fs2_ffn_block. Replaces fastspeech2_tpu/ops/pallas/
// ffn.py: fused_ffn_block (kernel _ffn_block_kernel).
FS2_EXPORT int fs2_ffn_block_pre(const float* x, const bf16* w1, const float* b1,
                                 const bf16* w2, const float* b2, const float* g,
                                 const float* be, const int* lens, bf16* hid,
                                 float* out, int B, int T, int D, int Hd, int K,
                                 float eps, void* stream_ptr) {
  return (int)launch_ffn<IN_F32_LN, OUT_PRE_RES>(
      Args{x, g, be, b1, w2, b2, lens, hid, nullptr, out, T, D, Hd, K, D, 1, eps}, w1, B,
      reinterpret_cast<cudaStream_t>(stream_ptr));
}

// Bare: FFN(mask(x)) with x (B,T,D) bf16, w2 (O, Hd) bf16, b2 (O) f32, hid
// as above with O floats behind it, and out (B,T,O) f32 (out_f32 != 0) or
// bf16 (round(y) + b2 rounded once more). Replaces fastspeech2_tpu/ops/
// pallas/ffn.py: fused_ffn (kernel _ffn_kernel).
FS2_EXPORT int fs2_ffn(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                       const float* b2, const int* lens, bf16* hid, void* out, int out_f32,
                       int B, int T, int D, int Hd, int O, int K, void* stream_ptr) {
  return (int)launch_ffn<IN_BF16, OUT_BARE>(
      Args{x, nullptr, nullptr, b1, w2, b2, lens, hid, nullptr, out, T, D, Hd, K, O,
           out_f32 != 0, 0.f},
      w1, B, reinterpret_cast<cudaStream_t>(stream_ptr));
}

// The tiling chosen for a shape, as ops/kernels/ffn.py:plan gives it: p, nh,
// st1, smem1, no, passes, st2, minb2, smem2, xc into out[0..9]. Returns 0,
// or cudaErrorInvalidValue where no tiling fits (D outside 1..2048 among
// them).
FS2_EXPORT int fs2_ffn_plan(int D, int Hd, int K, int O, int* out) {
  Plan pl;
  if (!make_plan(D, Hd, K, O, &pl)) return (int)cudaErrorInvalidValue;
  const int v[10] = {pl.p,  pl.nh, pl.st1,   pl.smem1, pl.no,
                     pl.passes, pl.st2, pl.minb2, pl.smem2, pl.xc};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}
