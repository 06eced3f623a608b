"""The port's CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips without them. Imports no JAX,
so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Shapes are the serving path's widths at ragged lengths: token buffers that
are multiples of 32 but not of the kernels' 64-row tiles, rows of length 1,
full rows, and tiles wholly past the length. Tolerance (bf16 tier, both
sides round at the same points): mean abs < 2e-3, max abs < 0.1.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fastspeech2_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _close(got, want):
    d = (got.float() - want.float()).abs()
    assert float(d.mean()) < 2e-3 and float(d.max()) < 0.1, (float(d.mean()), float(d.max()))


def _lengths(B, T, dev, g):
    ls = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    ls[0], ls[-1] = T, 1
    return ls.to(dev)


@pytest.mark.parametrize("B,T,D", [(3, 96, 256), (2, 160, 384), (4, 32, 256)])
def test_attention_and_ffn_blocks(dev, B, T, D):
    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    g = torch.Generator().manual_seed(B * T)
    torch.manual_seed(D)
    blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, linear_units=1024), device=dev)
    x = torch.randn(B, T, D, generator=g).to(dev)
    lens = _lengths(B, T, dev, g)
    with torch.inference_mode():
        ap, fp = blk.attn_pack(torch.bfloat16), blk.ffn_pack(torch.bfloat16)
        n0 = KA.launches
        _close(KA.attention_block(x, *ap, lens, 2), KA.attention_block_plain(x, *ap, lens, 2))
        _close(KF.ffn_block(x, *fp, lens, 9), KF.ffn_block_plain(x, *fp, lens, 9))
        torch.cuda.synchronize()
    assert KA.launches == n0 + 1


def test_adaptor_and_postnet(dev):
    from fastspeech2_tpu_torch.models.postnet import Postnet, PostnetConfig
    from fastspeech2_tpu_torch.models.predictors import Predictor, PredictorConfig
    from fastspeech2_tpu_torch.ops.kernels import adaptor as KAd
    from fastspeech2_tpu_torch.ops.kernels import postnet as KP
    from fastspeech2_tpu_torch.ops.length_regulator import expansion_indices
    from fastspeech2_tpu_torch.ops.quantize import linear_bins, log_bins

    g = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    B, T, L, D = 3, 40, 320, 256
    preds = [Predictor(PredictorConfig(idim=D), device=dev) for _ in range(2)]
    embs = [torch.nn.Linear(256, D, device=dev) for _ in range(2)]
    hs = torch.randn(B, T, D, generator=g).to(dev)
    tok = _lengths(B, T, dev, g)
    ds = torch.randint(0, 12, (B, T), generator=g, dtype=torch.int32).to(dev)
    net = Postnet(PostnetConfig(), device=dev)
    mel = torch.randn(B, L, 80, generator=g).to(dev)
    with torch.inference_mode():
        idx, _, out_lens = expansion_indices(
            ds, torch.arange(T, device=dev)[None] < tok[:, None], L, T)
        pack = KAd.pack_weights(*preds, *embs,
                                torch.from_numpy(log_bins(71.0, 676.0)).to(dev),
                                torch.from_numpy(linear_bins(0.0, 130.0)).to(dev),
                                torch.bfloat16)
        got, graw = KAd.variance_adaptor(hs, idx, out_lens, *pack)
        want, wraw = KAd.variance_adaptor_plain(hs, idx, out_lens, *pack)
        live = torch.arange(L, device=dev)[None] < out_lens[:, None]
        assert torch.all(got[~live] == 0) and torch.all(graw[:, 0][~live] == 0)
        assert float((graw - wraw).abs().max()) < 0.5
        w, bn, hidden = KP.pack_weights(net.layers, torch.bfloat16)
        _close(KP.postnet(mel, w, bn, out_lens, 5, hidden, 5),
               KP.postnet_plain(mel, w, bn, out_lens, 5, hidden, 5))
        torch.cuda.synchronize()


def test_wrapper_rejects_bad_inputs(dev):
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    x = torch.randn(2, 32, 256, device=dev)
    w1 = torch.zeros(1024, 9 * 256, device=dev)  # f32, the kernel takes bf16
    with pytest.raises(ValueError, match="dtype"):
        KF.ffn_block(x, w1, torch.zeros(1024, device=dev), w1[:256, :1024], x[0, 0],
                     x[0, 0], x[0, 0], torch.ones(2, dtype=torch.int32, device=dev), 9)


def _stage(C, dev, cd, g, scale=1.0):
    """Kernel-layout weights of one MelGAN stage at width C, from a seed."""
    from fastspeech2_tpu_torch.ops.precision import round_to

    bound = scale / (3 * C) ** 0.5
    w1 = ((torch.rand(3, C, 3 * C, generator=g) * 2 - 1) * bound).to(cd)
    w2 = ((torch.rand(3, C, C, generator=g) * 2 - 1) * scale / C ** 0.5).to(cd)
    b1, b2 = (round_to((torch.rand(3, C, generator=g) * 2 - 1) * bound, cd)
              for _ in range(2))
    return [t.to(dev).contiguous() for t in (w1, b1, w2, b2)]


@pytest.mark.parametrize("B,S,C", [(2, 2048, 256), (2, 4096, 128), (3, 2048, 64),
                                   (2, 6144, 32), (1, 128, 64)])
def test_resstack_bf16(dev, B, S, C):
    """bf16 kernel vs its plain version: single-tile and multi-tile lengths,
    first and last tile (reflection) included. Tolerance relative to the
    plain output's scale: both sides round at the same points, so they
    differ by accumulation order only: max < 2^-6 (two bf16 ulps of the
    largest values), mean < 1e-4."""
    from fastspeech2_tpu_torch.ops.kernels import resstack as KR

    g = torch.Generator().manual_seed(S + C)
    ws = _stage(C, dev, torch.bfloat16, g)
    x = torch.randn(B, S, C, generator=g).to(torch.bfloat16).to(dev)
    n0 = KR.launches
    got = KR.resstack(x, *ws)
    want = KR.resstack_plain(x, *ws)
    torch.cuda.synchronize()
    assert KR.launches == n0 + 1 and got.dtype == torch.bfloat16
    d = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    assert float(d.max()) < 2.0 ** -6 * scale and float(d.mean()) < 1e-4 * scale, (
        float(d.max()), float(d.mean()), scale)
    for sl in (slice(0, 16), slice(S - 16, S)):  # the reflected ends
        assert float(d[:, sl].max()) < 2.0 ** -6 * scale


@pytest.mark.parametrize("B,S,C", [(2, 1024, 64), (1, 256, 256), (2, 128, 32)])
def test_resstack_f32(dev, B, S, C):
    """f32 kernel vs its plain version: 1e-5 of the output's scale (f32
    sums in another order; no TF32, no fused multiply-add)."""
    from fastspeech2_tpu_torch.ops.kernels import resstack as KR

    g = torch.Generator().manual_seed(S + C)
    ws = _stage(C, dev, torch.float32, g)
    x = torch.randn(B, S, C, generator=g).to(dev)
    got = KR.resstack(x, *ws)
    want = KR.resstack_plain(x, *ws)
    torch.cuda.synchronize()
    d = (got - want).abs()
    assert float(d.max()) < 1e-5 * float(want.abs().max()), float(d.max())


def test_resstack_rejects_bad_inputs(dev):
    from fastspeech2_tpu_torch.ops.kernels import resstack as KR

    g = torch.Generator().manual_seed(0)
    ws = _stage(64, dev, torch.bfloat16, g)
    x = torch.zeros(1, 2048, 64, device=dev)  # f32 activation, bf16 weights
    with pytest.raises(ValueError, match="dtype"):
        KR.resstack(x, *ws)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="halo"):
        KR.resstack(xb[:, :13], *ws)
    with pytest.raises(ValueError, match="multiple"):
        KR.resstack(xb[:, :2000].contiguous(), *ws)
    with pytest.raises(ValueError, match="C=48"):
        KR.resstack(torch.zeros(1, 2048, 48, dtype=torch.bfloat16, device=dev),
                    *_stage(48, dev, torch.bfloat16, g))


@pytest.mark.parametrize("B,T,D", [(3, 96, 256), (2, 160, 384)])
def test_attention_res_ln(dev, B, T, D):
    """The q/k/v-given entry vs its plain version and vs the fused-QKV
    kernel, on separate q/k/v tensors and on column blocks of one buffer
    (those two bit for bit)."""
    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops import nn
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.precision import compute_dtype

    g = torch.Generator().manual_seed(B * T)
    torch.manual_seed(D)
    blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, linear_units=1024), device=dev)
    x = torch.randn(B, T, D, generator=g).to(dev)
    lens = _lengths(B, T, dev, g)
    with torch.inference_mode(), compute_dtype(torch.bfloat16):
        ap = blk.attn_pack(torch.bfloat16)
        q, k, v = (nn.linear(x, p.weight, p.bias, out_dtype=torch.bfloat16)
                   for p in (blk.attn.q, blk.attn.k, blk.attn.v))
        n0 = KA.res_ln_launches
        got = KA.attention_res_ln(q, k, v, x, *ap[2:], lens, 2)
        _close(got, KA.attention_res_ln_plain(q, k, v, x, *ap[2:], lens, 2))
        qkv = torch.cat([q, k, v], dim=-1)
        packed = KA.attention_res_ln(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:],
                                     x, *ap[2:], lens, 2)
        fused = KA.attention_block(x, *ap, lens, 2)
        torch.cuda.synchronize()
    assert KA.res_ln_launches == n0 + 2
    assert torch.equal(got, packed)
    # the projections are a cuBLAS f32 product here and a tensor-core product
    # in the fused kernel: q/k/v differ by rare one-ulp flips, which reach
    # many outputs through the softmax and the LayerNorm, so the two kernels
    # agree within the band but not bit for bit
    _close(got, fused)
    with pytest.raises(ValueError, match="bfloat16"):
        KA.attention_res_ln(q.float(), k, v, x, *ap[2:], lens, 2)
