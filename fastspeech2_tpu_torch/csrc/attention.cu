// FFT-block attention on the H100, masked by length:
//   fs2_attention_block   out = LN(x + MHA(x Wqkv + bqkv) Wo + bo)  post-LN block half
//   fs2_attention_res_ln  out = LN(res + MHA(q, k, v) Wo + bo)     q/k/v given
//   fs2_attention_res     out = res + MHA(q, k, v) Wo + bo         pre-LN block half
// (rows at or past the length give LN(x + bo), LN(res + bo) and res + bo),
// and the bare attention
//   fs2_attention         out = MHA(q, k, v), bf16, no projection (rows at or
//                         past the length zero).
// Any d_k that is a multiple of 8 from 8 to 1024 in every entry
// (attention_fwd.cuh: attn_plan).
//
// Replaces fastspeech2_tpu/ops/pallas/attention.py:
//  - fused_attention_packed_qkv_res_ln (kernel _attn_kernel_packed_qkv_res_ln):
//    fs2_attention_block, launches A, B and C below;
//  - fused_attention_packed_res_ln (kernel _attn_kernel_packed_res_ln), which
//    the JAX package takes with FS2_FUSED_ATT_QKV=off: fs2_attention_res_ln,
//    launches B and C with q/k/v given;
//  - fused_attention_packed_res (kernel _attn_kernel_packed_res), every
//    pre-LN block: fs2_attention_res, launches B and C without the LayerNorm;
//  - fused_attention_packed (kernel _attn_kernel_packed, heads packed along
//    D) and fused_attention (kernel _attn_kernel, (B, H, T, dk)): both
//    through fs2_attention, the SERVE forward of attention_fwd.cuh (the body
//    of the training kernels 11 and 12 without their dropout and saved
//    state).
//
// Bound on the H100: at the serving shapes (T <= 2048, D = 256/384, two
// heads of 128/192) the work is ~8*T*D^2 projection FLOPs plus ~4*T^2*D
// attention FLOPs per row against ~8*T*D bytes of f32 stream, i.e. well
// above the card's ~295 FLOP/byte ridge: tensor-core (operations) bound.
// The bare attention needs 4*T^2*D FLOPs against 8*T*D bytes of bf16: at
// the serving shapes (T <= 2048) its byte time is the larger; its two sweeps
// do 6*T^2*D.
//
// Design (sm_90a). The TPU kernel projects K/V into VMEM scratch at the
// first query block of a row and reuses it on later grid steps; CUDA blocks
// of one row run concurrently and share nothing, so the attention halves are
// three launches, each a wgmma kernel of two warpgroups fed by TMA, with the
// TPU kernel's rounding points:
//  A. q|k|v = round(round(bf16(x) Wqkv) + bqkv) into the (B, T, 3D) bf16
//     scratch: launch 1 of ffn_body.cuh at k = 1 without the ReLU
//     (CONV_QKV): 128-row x 256-column blocks (64 x 128 where D = 768 leaves
//     no room) of a bf16 x tile against Wqkv from a TMA ring. Row tiles past
//     the length are skipped; rows of a live tile past the length hold
//     round(bqkv), so the key tile the forward reads across the length is
//     finite.
//  B. O = MHA(q, k, v) in bf16 into a (B, T, D) scratch: attention_fwd.cuh's
//     SERVE forward (fs2_attention's kernel, unchanged) on q/k/v column blocks
//     of rows ld apart; keys at or past the length are masked and query rows
//     at or past it are written as zeros.
//  C. out = res + (round(O Wo) + bo), LayerNormed for RES_LN: launch 2 of
//     ffn_body.cuh with O as its hidden, Wo as its W2 and bo as its bias-only
//     row. O is zero past the length and round(0) = 0, so those rows are
//     exactly (the LayerNorm of) res + bo, as the TPU kernels' dead blocks
//     give, and tiles wholly past the length skip the product.
// O crosses global memory once (9.4 MB at (16, 768, 384), mostly L2).
#include "attention_fwd.cuh"
#include "ffn_body.cuh"

namespace {

// The head dims the SERVE forward takes.
bool dk_ok(int DK) {
  AttnPlan pl;
  return attn_plan(DK, &pl);
}

bool heads_ok(int D, int H) { return H > 0 && D % H == 0 && dk_ok(D / H); }

// The SERVE forward at head dim gm.dk: launch B, and the whole bare entry.
cudaError_t serve_fwd(const bf16* q, const bf16* k, const bf16* v, const int* lens, bf16* out,
                      int B, const Geometry& gm, float scale, cudaStream_t stream) {
  return launch_fwd<FWD_SERVE>(q, k, v, lens, out, nullptr, nullptr, B, gm, scale, 0u, 0u, 1.0f,
                               stream);
}

// Launch A: q|k|v = round(round(bf16(x) Wqkv) + bqkv) into qkv (B, T, 3D).
cudaError_t qkv_proj(const float* x, const bf16* wqkv, const float* bqkv, const int* lens,
                     bf16* qkv, int B, int T, int D, cudaStream_t stream) {
  Plan pl;
  if (!make_plan(D, 3 * D, 1, D, &pl)) return cudaErrorInvalidValue;
  const Args a{x, nullptr, nullptr, bqkv, nullptr, nullptr, lens, qkv, nullptr, nullptr,
               T, D, 3 * D, 1, D, 1, 0.f};
  CUtensorMap tw;
  const cudaError_t e = tma_map_bf16_2d(&tw, wqkv, D, 3 * D, D, pl.nh);
  if (e != cudaSuccess) return e;
  return launch_conv<IN_F32, CONV_QKV>(tw, a, pl, B, stream);
}

// Launches B and C: O = MHA(q, k, v) (heads packed along D, rows ld apart)
// into o (B, T, D), then out = res + (round(O Wo) + bo), LayerNormed for
// OUT_POST_LN (OUT_PRE_RES: not).
template <int OUT>
cudaError_t attention_half(const float* res, const bf16* q, const bf16* k, const bf16* v,
                           int ld, const bf16* wo, const float* bo, const float* g,
                           const float* be, const int* lens, bf16* o, float* out, int B, int T,
                           int D, int H, float scale, float eps, cudaStream_t stream) {
  Plan pl;
  if (!heads_ok(D, H) || B < 1 || T < 1 || ld < D || ld % 8 != 0 ||
      !make_plan(D, D, 1, D, &pl))
    return cudaErrorInvalidValue;
  const int DK = D / H;
  const Geometry gm{T, H, (long long)T * ld, DK, ld, (long long)T * D, DK, D, DK};
  cudaError_t e = serve_fwd(q, k, v, lens, o, B, gm, scale, stream);
  if (e != cudaSuccess) return e;
  // bo is the row c of the rows past the length (launch 2 only reads it)
  const Args a{res, g, be, nullptr, wo, bo, lens, o, const_cast<float*>(bo), out,
               T, D, D, 1, D, 1, eps};
  CUtensorMap to, two;
  if ((e = tma_map_bf16_2d(&to, o, D, (uint64_t)B * T, D, 64)) != cudaSuccess ||
      (e = tma_map_bf16_2d(&two, wo, D, D, D, pl.no)) != cudaSuccess)
    return e;
  return launch_epilogue<OUT>(to, two, a, pl, B, stream);
}

}  // namespace

// x (B,T,D) f32; wqkv (3D, D) bf16 [q|k|v rows, (out, in)]; bqkv (3D) f32;
// wo (D, D) bf16 (out, in); bo/g/be (D) f32; lens (B) i32; qkv (B,T,3D) and
// o (B,T,D) bf16 scratch; out (B,T,D) f32. D / H a multiple of 8 in 8..1024.
FS2_EXPORT int fs2_attention_block(const float* x, const bf16* wqkv, const float* bqkv,
                                   const bf16* wo, const float* bo, const float* g,
                                   const float* be, const int* lens, bf16* qkv, bf16* o,
                                   float* out, int B, int T, int D, int H, float scale,
                                   float eps, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (!heads_ok(D, H) || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = qkv_proj(x, wqkv, bqkv, lens, qkv, B, T, D, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)attention_half<OUT_POST_LN>(x, qkv, qkv + D, qkv + 2 * D, 3 * D, wo, bo, g, be,
                                          lens, o, out, B, T, D, H, scale, eps, stream);
}

// Launches B and C alone, q/k/v given: out = LN(res + MHA(q, k, v) Wo + bo).
// Replaces fastspeech2_tpu/ops/pallas/attention.py:
// fused_attention_packed_res_ln (kernel _attn_kernel_packed_res_ln), which the
// JAX package takes with FS2_FUSED_ATT_QKV=off.
// res (B,T,D) f32; q, k, v (B,T,D) bf16, each with row stride ld elements
// (ld >= D, a multiple of 8, 16-byte aligned bases): three separate tensors
// (ld = D) or three column blocks of one buffer; rows at or past the length
// need only be finite. wo (D, D) bf16 (out, in); bo/g/be (D) f32; lens (B)
// i32; o (B,T,D) bf16 scratch; out (B,T,D) f32.
FS2_EXPORT int fs2_attention_res_ln(const float* res, const bf16* q, const bf16* k,
                                    const bf16* v, int ld, const bf16* wo, const float* bo,
                                    const float* g, const float* be, const int* lens, bf16* o,
                                    float* out, int B, int T, int D, int H, float scale,
                                    float eps, void* stream_ptr) {
  return (int)attention_half<OUT_POST_LN>(res, q, k, v, ld, wo, bo, g, be, lens, o, out, B, T,
                                          D, H, scale, eps,
                                          reinterpret_cast<cudaStream_t>(stream_ptr));
}

// Pre-LN: out = res + MHA(q, k, v) Wo + bo, no LayerNorm; rows at or past the
// length give res + bo. Replaces fastspeech2_tpu/ops/pallas/attention.py:
// fused_attention_packed_res (kernel _attn_kernel_packed_res). Arguments as
// fs2_attention_res_ln without g/be/eps.
FS2_EXPORT int fs2_attention_res(const float* res, const bf16* q, const bf16* k,
                                 const bf16* v, int ld, const bf16* wo, const float* bo,
                                 const int* lens, bf16* o, float* out, int B, int T, int D,
                                 int H, float scale, void* stream_ptr) {
  return (int)attention_half<OUT_PRE_RES>(res, q, k, v, ld, wo, bo, nullptr, nullptr, lens, o,
                                          out, B, T, D, H, scale, 0.f,
                                          reinterpret_cast<cudaStream_t>(stream_ptr));
}

// Bare masked attention, out = MHA(q, k, v) in bf16 (no projection); rows at
// or past the length are zeros. Replaces fastspeech2_tpu/ops/pallas/
// attention.py: fused_attention_packed (packed = 1: q, k, v (B, T, .), head h
// = columns [h DK, (h + 1) DK) of rows ld >= H * DK apart -- contiguous, or
// column blocks of one q|k|v buffer; out (B, T, H * DK) contiguous) and
// fused_attention (packed = 0: q, k, v and out (B, H, T, DK) contiguous,
// ld = DK). ld a multiple of 8, bases 16-byte aligned; lens (B) i32; DK a
// multiple of 8 in 8..1024. The SERVE forward of attention_fwd.cuh, its three
// tensor maps encoded per call.
FS2_EXPORT int fs2_attention(const bf16* q, const bf16* k, const bf16* v, int ld,
                             const int* lens, bf16* out, int B, int T, int H, int DK, int packed,
                             float scale, void* stream_ptr) {
  if (!dk_ok(DK) || B < 1 || T < 1 || H < 1 || ld % 8 != 0 ||
      (packed ? ld < H * DK : ld != DK))
    return (int)cudaErrorInvalidValue;
  const long long osb = (long long)H * T * DK, osh = packed ? DK : (long long)T * DK;
  const int osr = packed ? H * DK : DK;
  const Geometry gm = packed ? Geometry{T, H, (long long)T * ld, DK, ld, osb, osh, osr, DK}
                             : Geometry{T, H, osb, osh, DK, osb, osh, osr, DK};
  return (int)serve_fwd(q, k, v, lens, out, B, gm, scale,
                        reinterpret_cast<cudaStream_t>(stream_ptr));
}
