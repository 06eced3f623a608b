"""Variance adaptor, the frame-level serving segment: expansion gather ->
pitch and energy predictors -> bucketize -> embeddings -> residual.

Port of ``fastspeech2_tpu/ops/pallas/adaptor.py:fused_variance_adaptor``
(kernel ``_adaptor_kernel``). CUDA source: ``csrc/adaptor.cu`` (one launch
of wgmma products from a TMA weight ring over a gathered, row-shifted x
tile, the epilogues in registers). ``plan`` picks its tiling per shape; the C
side makes the same choice (``c_plan`` reads it back on the card). It takes
C = 256 (the only predictor width of either package) and every D that is a
multiple of 8 from 64 to 1024.

Rounding points follow the TPU kernel: conv products rounded to the compute
dtype and widened for the bias; ReLU and LayerNorm (eps 1e-12) in f32; the
scalar head is an f32 sum of compute-dtype products, rounded, plus the bias;
the embedding row is exact. The bucketize counts edges strictly below the
prediction, so a one-ulp difference in the head can move a frame to the next
bucket: the tests allow a stated share of such frames.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from fastspeech2_tpu_torch.ops import nn
from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.ops.kernels.ffn import SLACK, SMEM_MAX
from fastspeech2_tpu_torch.ops.precision import round_to

LN_EPS = 1e-12
launches = 0
_fn = None
_fn_plan = None

#: the predictors' channels, the only width the kernel takes
CHANNELS = 256
#: 256 weight rows x 64 bf16 columns: a ring tile holds one or two
RING_SUB = CHANNELS * 128
#: conv rows a block (both warpgroups, 128 channels each): it covers 62 frames
ROWS = 64
#: rows of the x tile and of H1: the block's rows and two convs' halo, odd
TILE_ROWS = (ROWS + 2) | 1


class AdaptorPlan(NamedTuple):
    """Tiling of one shape: ``kt`` input columns a ring tile (128 or 64: two
    or one 256 x 64 boxes), ``st`` ring stages, ``smem`` bytes (the x tile
    and H1, TILE_ROWS rows each, the ring, the block's indices, row sums and
    epilogue parameters)."""
    kt: int
    st: int
    smem: int


def misc_bytes(nb: int = 256) -> int:
    """Shared memory beside the ring and the tiles: ROWS + 2 expansion
    indices, 2 ROWS bucket indices and three row-sum exchanges of 128
    floats, then one predictor's epilogue parameters (conv1's b1, g1, be1;
    conv2's b2, g2, be2, wo and the nb bin edges)."""
    idx = -(-((3 * ROWS + 2) * 4 + 3 * 128 * 4) // 16) * 16
    return idx + 2 * 3 * CHANNELS * 4 + CHANNELS * 2 + -(-nb * 4 // 16) * 16


def plan(D: int, NB: int = 256) -> AdaptorPlan:
    """The kernel's tiling of D with NB bin edges, as
    ``csrc/adaptor.cu:ad_make_plan`` picks it: ring tiles of 128 input
    columns where two stages fit beside the x tile (D rounded up to 16
    columns), H1, the indices and parameters, up to four; else of 64, one
    stage at least. Raises ValueError for a shape the kernel does not take
    (D not a multiple of 8 in 64 .. 1024, NB outside 1 .. 4096)."""
    if D % 8 or not 64 <= D <= 1024 or not 1 <= NB <= 4096:
        raise ValueError(f"variance_adaptor: D={D}, NB={NB} not supported by the "
                         "kernel (D a multiple of 8 from 64 to 1024)")
    dp = -(-D // 16) * 16
    fixed = TILE_ROWS * dp * 2 + TILE_ROWS * CHANNELS * 2 + misc_bytes(NB) + SLACK
    for kt in (128, 64):
        tile = kt // 64 * RING_SUB
        st = min(4, (SMEM_MAX - fixed) // tile)
        if st >= (2 if kt == 128 else 1):
            return AdaptorPlan(kt, st, fixed + st * tile)
    raise ValueError(f"variance_adaptor: no tiling fits D={D}")


def c_plan(D: int, NB: int = 256) -> AdaptorPlan:
    """The tiling the C side picks for a shape (``fs2_adaptor_plan``; needs
    the built library)."""
    global _fn_plan
    if _fn_plan is None:
        _fn_plan = common.bind(common.load("adaptor"), "fs2_adaptor_plan",
                               [common.I] * 2 + [common.P])
    out = (ctypes.c_int * 3)()
    if _fn_plan(D, NB, out) != 0:
        raise ValueError(f"variance_adaptor: no tiling fits D={D}")
    return AdaptorPlan(*out)


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
    if C != CHANNELS:
        raise ValueError(f"variance_adaptor: C={C} not supported by the kernel "
                         f"(C = {CHANNELS})")
    plan(D, NB)
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
