"""Variance adaptor, the frame-level serving segment: expansion gather ->
pitch and energy predictors -> bucketize -> embeddings -> residual.

Port of ``fastspeech2_tpu/ops/pallas/adaptor.py:fused_variance_adaptor``
(kernel ``_adaptor_kernel``). CUDA source: ``csrc/adaptor.cu``.

Rounding points follow the TPU kernel: conv products rounded to the compute
dtype and widened for the bias; ReLU and LayerNorm (eps 1e-12) in f32; the
scalar head is an f32 sum of compute-dtype products, rounded, plus the bias;
the embedding row is exact. The bucketize counts edges strictly below the
prediction, so a one-ulp difference in the head can move a frame to the next
bucket: the tests allow a stated share of such frames.
"""

from __future__ import annotations

import torch

from fastspeech2_tpu_torch.ops import nn
from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.ops.precision import round_to

LN_EPS = 1e-12
launches = 0
_fn = None


def variance_adaptor_plain(hs, idx, out_lens, w1, b1, g1, be1, w2, b2, g2, be2,
                           wo, bo, bins, emb_w, emb_b):
    """The function the kernel computes, in plain PyTorch. Shapes as in
    :func:`variance_adaptor`; compute dtype = w1.dtype. Returns
    (hs2 (B, L, D) f32, raw (B, 2, L) f32)."""
    cd = w1.dtype
    B, T, D = hs.shape
    L = idx.shape[1]
    k = w1.shape[2] // D
    hs = hs.float()
    live = torch.arange(L, device=hs.device)[None, :] < out_lens.to(hs.device)[:, None]
    e32 = torch.gather(hs, 1, idx.long()[..., None].expand(-1, -1, D))
    e32 = torch.where(live[..., None], e32, torch.zeros_like(e32))
    x = round_to(e32, cd)
    out = e32
    raws = []
    for p in range(2):  # 0 = pitch, 1 = energy
        acc = common.unfold_rows(x, k) @ w1[p].float().t()
        h = nn.layer_norm(torch.relu(round_to(acc, cd) + b1[p]), g1[p], be1[p],
                          eps=LN_EPS)
        h = round_to(torch.where(live[..., None], h, torch.zeros_like(h)), cd)
        acc2 = common.unfold_rows(h, k) @ w2[p].float().t()
        h2 = nn.layer_norm(torch.relu(round_to(acc2, cd) + b2[p]), g2[p],
                           be2[p], eps=LN_EPS)
        y = (round_to(h2, cd) * wo[p].float()).sum(dim=-1)
        raw = round_to(y, cd) + bo[p]
        raws.append(torch.where(live, raw, torch.zeros_like(raw)))
        bidx = (bins[p] < raw[..., None]).sum(dim=-1)
        out = out + (emb_w[p].float()[bidx] + emb_b[p])
    out = torch.where(live[..., None], out, torch.zeros_like(out))
    return out, torch.stack(raws, dim=1)


def variance_adaptor(hs, idx, out_lens, w1, b1, g1, be1, w2, b2, g2, be2, wo,
                     bo, bins, emb_w, emb_b):
    """hs (B, T, D) f32; idx (B, L) int32 expansion indices; out_lens (B,)
    int32; w1 (2, C, k*D) and w2 (2, C, k*C) laid out (out, tap, in) and
    wo (2, C) in the compute dtype; b1/g1/be1/b2/g2/be2 (2, C), bo (2,) f32;
    bins (2, NB) f32 with +inf as the last edge; emb_w (2, NB, D) in the
    compute dtype, emb_b (2, D) f32. Index 0 is pitch, 1 energy."""
    global launches, _fn
    if hs.device.type == "cpu":
        return variance_adaptor_plain(hs, idx, out_lens, w1, b1, g1, be1, w2,
                                      b2, g2, be2, wo, bo, bins, emb_w, emb_b)
    B, T, D = hs.shape
    L = idx.shape[1]
    C = w1.shape[1]
    NB = bins.shape[1]
    bf16, f32 = torch.bfloat16, torch.float32
    common.check_cuda("variance_adaptor", hs.device, [
        ("hs", hs, f32, None), ("idx", idx, torch.int32, (B, L)),
        ("out_lens", out_lens, torch.int32, (B,)),
        ("w1", w1, bf16, (2, C, 3 * D)), ("b1", b1, f32, (2, C)),
        ("g1", g1, f32, (2, C)), ("be1", be1, f32, (2, C)),
        ("w2", w2, bf16, (2, C, 3 * C)), ("b2", b2, f32, (2, C)),
        ("g2", g2, f32, (2, C)), ("be2", be2, f32, (2, C)),
        ("wo", wo, bf16, (2, C)), ("bo", bo, f32, (2,)),
        ("bins", bins, f32, (2, NB)), ("emb_w", emb_w, bf16, (2, NB, D)),
        ("emb_b", emb_b, f32, (2, D))])
    if D % 32 or C % 32:
        raise ValueError(f"variance_adaptor: D={D}, C={C} not supported by "
                         "the kernel (k=3, multiples of 32)")
    if _fn is None:
        P, I, F = common.P, common.I, common.F
        _fn = common.bind(common.load("adaptor"), "fs2_variance_adaptor",
                          [P] * 18 + [I] * 6 + [F, P])
    out = torch.empty((B, L, D), dtype=f32, device=hs.device)
    raw = torch.empty((B, 2, L), dtype=f32, device=hs.device)
    common.launch(_fn, *(t.data_ptr() for t in (
        hs, idx, out_lens, w1, b1, g1, be1, w2, b2, g2, be2, wo, bo, bins,
        emb_w, emb_b, out, raw)), B, T, L, D, C, NB, LN_EPS,
        common.stream_of(hs))
    with common.count_lock:
        launches += 1
    return out, raw


@torch.no_grad()
def pack_weights(pitch, energy, pitch_embed, energy_embed, pitch_bins,
                 energy_bins, cd: torch.dtype):
    """Kernel-layout weights: pitch/energy are two-layer predictors (convs[i]
    .conv Conv1d, .ln LayerNorm; out Linear(C, 1)); the embeds are
    Linear(NB, D); the bins hold NB-1 edges each."""
    preds = (pitch, energy)

    def stack(f, dtype=torch.float32):
        return torch.stack([f(p) for p in preds]).to(dtype).contiguous()

    def conv_w(layer):
        w = layer.conv.weight
        return w.permute(0, 2, 1).reshape(w.shape[0], -1)

    inf = torch.full((1,), float("inf"), device=pitch_bins.device)
    bins = torch.stack([torch.cat([pitch_bins.float(), inf]),
                        torch.cat([energy_bins.float(), inf])])
    emb_w = torch.stack([pitch_embed.weight.t(), energy_embed.weight.t()])
    return (stack(lambda p: conv_w(p.convs[0]), cd),
            stack(lambda p: p.convs[0].conv.bias),
            stack(lambda p: p.convs[0].ln.weight),
            stack(lambda p: p.convs[0].ln.bias),
            stack(lambda p: conv_w(p.convs[1]), cd),
            stack(lambda p: p.convs[1].conv.bias),
            stack(lambda p: p.convs[1].ln.weight),
            stack(lambda p: p.convs[1].ln.bias),
            stack(lambda p: p.out.weight[0], cd),
            stack(lambda p: p.out.bias[0]),
            bins.contiguous(), emb_w.to(cd).contiguous(),
            torch.stack([pitch_embed.bias, energy_embed.bias]).float()
            .contiguous())
