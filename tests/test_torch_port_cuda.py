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


def test_two_threads_launch_one_kernel_at_two_widths(dev):
    """A server's dispatch thread runs the encoder (D=256) while its delivery
    thread runs the decoder (D=384): both reach ``qkv_proj_kernel`` with other
    shared-memory sizes. Two threads call the C entry back to back (nothing of
    Python between the calls, so they overlap inside it): no launch may be
    refused. With a per-launch opt-in that could shrink, about one launch in
    twenty at the wider size came back with cudaErrorInvalidValue."""
    import math
    import threading

    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops.kernels import attention as KA

    torch.manual_seed(5)
    jobs, keep = [], []
    for D in (256, 384):
        blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, linear_units=1024),
                       device=dev)
        x = torch.randn(1, 32, D, device=dev)
        lens = torch.tensor([32], dtype=torch.int32, device=dev)
        with torch.inference_mode():
            ap = blk.attn_pack(torch.bfloat16)
            want = KA.attention_block(x, *ap, lens, 2)  # binds KA._fn
        qkv = torch.empty((1, 32, 3 * D), dtype=torch.bfloat16, device=dev)
        out = torch.empty_like(x)
        keep.append((blk, x, lens, ap, qkv, out, want))
        jobs.append((x.data_ptr(), *(t.data_ptr() for t in ap), lens.data_ptr(),
                     qkv.data_ptr(), out.data_ptr(), 1, 32, D, 2,
                     1.0 / math.sqrt(D // 2), 1e-5,
                     torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    refused = {}

    def run(args):
        refused[args[12]] = sum(1 for _ in range(50000) if KA._fn(*args))

    threads = [threading.Thread(target=run, args=(job,)) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert refused == {256: 0, 384: 0}, f"refused launches of 50000 per width: {refused}"
    for *_, out, want in keep:
        assert torch.equal(out, want)


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
    # (no-grad: the serving kernels refuse inputs that autograd would record,
    # and the packed LayerNorm weights are the parameters themselves)
    with torch.no_grad(), pytest.raises(ValueError, match="bfloat16"):
        KA.attention_res_ln(q.float(), k, v, x, *ap[2:], lens, 2)


@pytest.mark.parametrize("packed", [True, False], ids=["kernel11_packed", "kernel12"])
@pytest.mark.parametrize("B,T,D,rate", [(3, 96, 256, 0.2), (2, 160, 384, 0.2),
                                        (2, 200, 384, 0.0), (4, 40, 256, 0.5)])
def test_attention_train_forward_and_backward(dev, packed, B, T, D, rate):
    """Kernels 11 and 12 against the plain version's autograd: output and dQ,
    dK, dV for a random dO, at lengths that are no multiple of the 64-row
    tiles, with a full row, a row of length 1 and dead tiles; a seed past
    2^31; padded rows exactly zero. Band: both sides round at the same
    points, the summation order differs: max < 2^-6 (two bf16 steps at the
    peak), mean < 1e-4 of the plain result's peak. dO arrives non-contiguous and in f32, as autograd may hand
    it over."""
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT

    H, dk = 2, D // 2
    g = torch.Generator().manual_seed(B * T + D)
    lens = _lengths(B, T, dev, g)
    shape = (B, T, D) if packed else (B, H, T, dk)
    q, k, v = (torch.randn(shape, generator=g).bfloat16().to(dev).requires_grad_()
               for _ in range(3))
    do = torch.randn(shape[:-1] + (2 * shape[-1],), generator=g).to(dev)[..., ::2]
    assert not do.is_contiguous() and do.dtype == torch.float32
    seed = 2 ** 31 + 12345
    if packed:
        kern = KT.fused_attention_train_packed(q, k, v, lens, seed, H, rate)
        plain = KT.attention_train_plain(q, k, v, lens, seed, rate, H)
    else:
        kern = KT.fused_attention_train(q, k, v, lens, seed, rate)
        plain = KT.attention_train_plain(q, k, v, lens, seed, rate)
    n0 = KT.packed_bwd_launches + KT.bwd_launches
    got = (kern, *torch.autograd.grad(kern, (q, k, v), do))
    want = (plain, *torch.autograd.grad(plain, (q, k, v), do.bfloat16()))
    torch.cuda.synchronize()
    assert KT.packed_bwd_launches + KT.bwd_launches == n0 + 1
    pad = torch.arange(T, device=dev)[None] >= lens[:, None]
    pad = pad[:, :, None] if packed else pad[:, None, :, None]
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        assert float(torch.where(pad, a.detach().float().abs(), 0.0).max()) == 0.0, name
        d, peak = (a.float() - b.float()).abs(), float(b.float().abs().max())
        assert float(d.max()) < 2.0 ** -6 * peak and float(d.mean()) < 1e-4 * peak, (
            name, float(d.max()), float(d.mean()), peak)


@pytest.mark.parametrize("packed", [True, False], ids=["kernel11_packed", "kernel12"])
@pytest.mark.parametrize("B,T,D,rate", [(2, 100, 256, 0.2), (2, 70, 384, 0.0)])
def test_attention_train_f32(dev, packed, B, T, D, rate):
    """The f32 instantiation (plain multiply-adds, no TF32) against the plain
    version's autograd in full f32: 2e-5 of each result's peak (other
    summation order, expf against torch's exp); padded rows exactly zero."""
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT

    H, dk = 2, D // 2
    g = torch.Generator().manual_seed(T + D)
    lens = _lengths(B, T, dev, g)
    shape = (B, T, D) if packed else (B, H, T, dk)
    q, k, v = (torch.randn(shape, generator=g).to(dev).requires_grad_() for _ in range(3))
    do = torch.randn(shape, generator=g).to(dev)
    seed = 2 ** 32 - 3
    if packed:
        kern = KT.fused_attention_train_packed(q, k, v, lens, seed, H, rate)
        plain = KT.attention_train_plain(q, k, v, lens, seed, rate, H)
    else:
        kern = KT.fused_attention_train(q, k, v, lens, seed, rate)
        plain = KT.attention_train_plain(q, k, v, lens, seed, rate)
    got = (kern, *torch.autograd.grad(kern, (q, k, v), do))
    want = (plain, *torch.autograd.grad(plain, (q, k, v), do))
    torch.cuda.synchronize()
    pad = torch.arange(T, device=dev)[None] >= lens[:, None]
    pad = pad[:, :, None] if packed else pad[:, None, :, None]
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert float(torch.where(pad, a.detach().abs(), 0.0).max()) == 0.0, name
        d, peak = (a - b).detach().abs(), float(b.detach().abs().max())
        assert float(d.max()) < 2e-5 * peak, (name, float(d.max()), peak)


def test_attention_train_layouts_draw_the_same_mask(dev):
    """The packed and the (B, H, T, dk) entries agree bit for bit on the same
    values: one kernel body, the same (seed, b, h) mask."""
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT

    B, T, H, dk = 2, 130, 2, 128
    g = torch.Generator().manual_seed(7)
    lens = _lengths(B, T, dev, g)
    q4, k4, v4, do4 = (torch.randn(B, H, T, dk, generator=g).bfloat16().to(dev)
                       for _ in range(4))
    pack = lambda t: t.transpose(1, 2).reshape(B, T, H * dk).contiguous()  # noqa: E731
    a = [t.clone().requires_grad_() for t in (q4, k4, v4)]
    b = [pack(t).requires_grad_() for t in (q4, k4, v4)]
    oa = KT.fused_attention_train(*a, lens, 99, 0.3)
    ob = KT.fused_attention_train_packed(*b, lens, 99, H, 0.3)
    ga = torch.autograd.grad(oa, a, do4)
    gb = torch.autograd.grad(ob, b, pack(do4))
    for x, y in zip((oa, *ga), (ob, *gb)):
        assert torch.equal(pack(x), y)


def test_attention_train_rejects_what_it_does_not_cover(dev):
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT

    lens = torch.tensor([8, 3], dtype=torch.int32, device=dev)
    q = torch.randn(2, 8, 256, device=dev)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        KT.fused_attention_train_packed(q.half(), q.half(), q.half(), lens, 1, 2, 0.0)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        KT.fused_attention_train_packed(qb, qb, qb, lens, 1, 4, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        KT.fused_attention_train_packed(qb, qb.transpose(0, 1).contiguous().transpose(0, 1),
                                        qb, lens, 1, 2, 0.0)
    with pytest.raises(ValueError, match="lengths"):
        KT.fused_attention_train_packed(qb, qb, qb, lens.long(), 1, 2, 0.0)
    a, b, c = qb.clone().requires_grad_(), qb.clone().requires_grad_(), qb.clone()
    o = KT.fused_attention_train_packed(a, b, c, lens, 1, 2, 0.0)
    with pytest.raises(RuntimeError, match="all three"):
        o.sum().backward()


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One bf16 train step at d_k=128 (kernel route) on the card against the
    same step on the CPU (plain versions): same weights, batch and seeds.
    Loss within 1%, gradient norm within 5%."""
    import numpy as np

    from fastspeech2_tpu_torch.config import Config, ModelConfig
    from fastspeech2_tpu_torch.models.fastspeech2 import Batch, FastSpeech2
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT
    from fastspeech2_tpu_torch.train.optimizer import NoamAdam
    from fastspeech2_tpu_torch.train.seeds import SeedSchedule
    from fastspeech2_tpu_torch.train.step import TrainState, make_train_step, trainable

    cfg = Config(model=ModelConfig(adim=256, aheads=2, elayers=1, eunits=128, ddim=256,
                                   dlayers=1, dunits=128, postnet_layers=2,
                                   postnet_chans=32, fused_attention="on"))
    g = np.random.default_rng(0)
    B, T, L = 4, 16, 96
    ds = g.integers(1, 7, (B, T)).astype(np.int32)
    olens = ds.sum(1).astype(np.int32)
    m = (np.arange(L)[None] < olens[:, None])
    batch = Batch(xs=g.integers(1, 68, (B, T)).astype(np.int32),
                  ilens=np.full(B, T, np.int32),
                  ys=(g.normal(-5, 2, (B, L, 80)) * m[..., None]).astype(np.float32),
                  olens=olens, ds=ds,
                  es=(g.uniform(0.02, 100, (B, L)) * m).astype(np.float32),
                  ps=(g.uniform(71, 600, (B, L)) * m).astype(np.float32))
    out = {}
    for d in ("cpu", dev):
        model = FastSpeech2(cfg, device=d, generator=torch.Generator().manual_seed(1))
        opt = NoamAdam(trainable(model), cfg)
        seeds = [SeedSchedule(model.dropout_sites(), seed=5).draw() for _ in range(2)]
        n0 = KT.packed_fwd_launches
        _, rep = make_train_step(model, opt, 2, bf16=True)(
            TrainState(model, opt), Batch(*(torch.from_numpy(a).to(d) for a in batch)), seeds)
        out[str(d)] = (float(rep["loss"]), float(rep["grad_norm"]),
                       KT.packed_fwd_launches - n0)
    (lc, nc, kc), (lg, ng, kg) = out["cpu"], out[str(dev)]
    assert kc == 0 and kg == 4  # 2 blocks x 2 micro-batches
    assert abs(lg - lc) < 0.01 * abs(lc) and abs(ng - nc) < 0.05 * nc, out


def _speechlike(B, N, g):
    """Harmonics on a gliding f0 plus noise; row 0 keeps sound only in its
    first tenth (a bucket's zero tail)."""
    t = torch.arange(N, dtype=torch.float64) / 22050
    f0 = 90 + 160 * torch.rand(B, 1, generator=g, dtype=torch.float64)
    ph = 2 * torch.pi * torch.cumsum(f0 * (1 + 0.1 * torch.sin(2 * torch.pi * t)), -1) / 22050
    y = sum(0.3 / k * torch.sin(k * ph) for k in range(1, 8))
    y = y + 0.01 * torch.randn(B, N, generator=g, dtype=torch.float64)
    y[0, N // 10:] = 0
    return y.float()


@pytest.mark.parametrize("B,N", [(8, 229_376), (8, 16_384), (3, 700), (1, 300)])
def test_stft_mel_energy(dev, B, N):
    """Kernel 14 against its plain version (full f32 on both sides) at the
    preprocess path's bucket shapes and at a short row, including one no
    longer than the reflect pad. Tolerance 1e-4 (rtol and atol; the energy's
    atol 1e-4 of its peak), the one the TPU kernel is held to."""
    from fastspeech2_tpu_torch.audio.stft import mel_filterbank
    from fastspeech2_tpu_torch.ops.kernels import stft as KS

    g = torch.Generator().manual_seed(N)
    y = _speechlike(B, N, g).to(dev)
    fb = torch.from_numpy(mel_filterbank()).to(dev)
    n0 = KS.launches
    mel, en = KS.stft_mel_energy(y, fb)
    pm, pe = KS.stft_mel_energy_plain(y, fb)
    torch.cuda.synchronize()
    assert KS.launches == n0 + 1
    F = N // 256 + 1
    assert mel.shape == pm.shape == (B, 80, F) and en.shape == pe.shape == (B, F)
    torch.testing.assert_close(mel, pm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(en, pe, rtol=1e-4, atol=1e-4 * float(pe.abs().max()))


def test_stft_mel_energy_rejects_what_it_does_not_cover(dev):
    from fastspeech2_tpu_torch.audio.stft import MelSpectrogram, mel_filterbank
    from fastspeech2_tpu_torch.ops.kernels import stft as KS

    y = torch.randn(2, 4096, device=dev)
    fb = torch.from_numpy(mel_filterbank()).to(dev)
    with pytest.raises(ValueError, match="n_fft == 4"):
        KS.stft_mel_energy(y, fb, n_fft=1024, hop_length=128)
    with pytest.raises(ValueError, match="dtype"):
        KS.stft_mel_energy(y.double(), fb)
    # another ratio takes the matmul path on the card, as in the JAX package
    n0 = KS.launches
    mel, en = MelSpectrogram(hop_length=128, device=dev).mel_and_energy(y)
    assert KS.launches == n0 and mel.shape == (2, 80, 33)


def _lengths_0_1(B, T, dev, g):
    """Random lengths with a full row, a length-1 row and a length-0 row."""
    ls = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    ls[0], ls[1], ls[-1] = T, 1, 0
    return ls.to(dev)


@pytest.mark.parametrize("B,T,D", [(4, 96, 256), (3, 160, 384), (4, 32, 256)])
def test_attention_res_and_bare(dev, B, T, D):
    """Kernel 6 (pre-LN attention half) and kernel 7 (bare, heads packed) at
    d_k 128 and 192 against their plain versions; dead tiles and lengths 0
    and 1: res + bo and zeros exactly; column blocks of one q|k|v buffer
    give the same bits as separate tensors."""
    from fastspeech2_tpu_torch.ops.kernels import attention as KA

    g = torch.Generator().manual_seed(B * T + D)
    bf = torch.bfloat16
    q, k, v = (torch.randn(B, T, D, generator=g).to(bf).to(dev) for _ in range(3))
    res = torch.randn(B, T, D, generator=g).to(dev)
    wo = (torch.randn(D, D, generator=g) / D ** 0.5).to(bf).to(dev)
    bo = (0.1 * torch.randn(D, generator=g)).to(dev)
    lens = _lengths_0_1(B, T, dev, g)
    n6, n7 = KA.res_launches, KA.packed_launches
    got = KA.attention_res(q, k, v, res, wo, bo, lens, 2)
    want = KA.attention_res_plain(q, k, v, res, wo, bo, lens, 2)
    bare = KA.fused_attention_packed(q, k, v, lens, 2)
    bare_want = KA.fused_attention_packed_plain(q, k, v, lens, 2)
    qkv = torch.cat([q, k, v], dim=-1)
    bare_cols = KA.fused_attention_packed(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:],
                                          lens, 2)
    torch.cuda.synchronize()
    assert (KA.res_launches, KA.packed_launches) == (n6 + 1, n7 + 2)
    _close(got, want)
    assert bare.dtype == bf
    _close(bare, bare_want)
    assert torch.equal(bare, bare_cols)
    for b, n in enumerate(lens.tolist()):
        assert torch.equal(got[b, n:], res[b, n:] + bo), b
        assert not bare[b, n:].any(), b


@pytest.mark.parametrize("B,H,T,dk", [(4, 2, 96, 128), (3, 2, 160, 192), (2, 4, 64, 128)])
def test_fused_attention_bhtd(dev, B, H, T, dk):
    """Kernel 8, (B, H, T, dk), against its plain version and against kernel
    7 on the same values packed along D (the same body: bit for bit)."""
    from fastspeech2_tpu_torch.ops.kernels import attention as KA

    g = torch.Generator().manual_seed(T * dk)
    q, k, v = (torch.randn(B, H, T, dk, generator=g).to(torch.bfloat16).to(dev)
               for _ in range(3))
    lens = _lengths_0_1(B, T, dev, g)
    n8 = KA.bhtd_launches
    got = KA.fused_attention(q, k, v, lens)
    want = KA.fused_attention_plain(q, k, v, lens)
    pack = lambda t: t.transpose(1, 2).reshape(B, T, H * dk).contiguous()  # noqa: E731
    packed = KA.fused_attention_packed(pack(q), pack(k), pack(v), lens, H)
    torch.cuda.synchronize()
    assert KA.bhtd_launches == n8 + 1 and got.shape == (B, H, T, dk)
    _close(got, want)
    assert torch.equal(pack(got), packed)
    for b, n in enumerate(lens.tolist()):
        assert not got[b, :, n:].any(), b


@pytest.mark.parametrize("B,T,D", [(4, 96, 256), (3, 160, 384)])
def test_ffn_block_pre(dev, B, T, D):
    """Kernel 9, x + FFN(mask(LN(x))), at k=9 and H=1024 against its plain
    version; lengths 0 and 1 and dead tiles give x + the bias row."""
    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    g = torch.Generator().manual_seed(B * T)
    torch.manual_seed(D)
    blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, linear_units=1024), device=dev)
    with torch.no_grad():
        blk.norm2.weight.add_(0.2 * torch.randn(D, generator=g).to(dev))
        blk.norm2.bias.add_(0.1 * torch.randn(D, generator=g).to(dev))
    x = (3.0 * torch.randn(B, T, D, generator=g) + 1.0).to(dev)  # LN has work to do
    lens = _lengths_0_1(B, T, dev, g)
    with torch.inference_mode():
        fp = blk.ffn_pack(torch.bfloat16)
        n9 = KF.pre_launches
        got = KF.ffn_block_pre(x, *fp, lens, 9)
        want = KF.ffn_block_pre_plain(x, *fp, lens, 9)
        torch.cuda.synchronize()
    assert KF.pre_launches == n9 + 1
    _close(got, want)
    # length 0: every tile past the first (whose halo reaches row 0) is dead
    # and holds x + the one bias row (f32 rounding of the add only)
    row = got[-1, 64:] - x[-1, 64:]
    assert float((row - row[:1]).abs().max()) < 1e-5


@pytest.mark.parametrize("O,out_dtype", [(384, torch.bfloat16), (384, torch.float32),
                                         (80, torch.float32), (200, torch.bfloat16)])
def test_fused_ffn(dev, O, out_dtype):
    """Kernel 10, the bare conv-FFN of a bf16 input with O outputs (O != D
    and O not a multiple of the 384-column tile), in bf16 and in f32."""
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    g = torch.Generator().manual_seed(O)
    B, T, D, Hd, k = 3, 160, 384, 1024, 9
    bf = torch.bfloat16
    x = torch.randn(B, T, D, generator=g).to(bf).to(dev)
    w1 = (torch.randn(Hd, k * D, generator=g) / (k * D) ** 0.5).to(bf).to(dev)
    w2 = (torch.randn(O, Hd, generator=g) / Hd ** 0.5).to(bf).to(dev)
    b1, b2 = ((0.1 * torch.randn(n, generator=g)).to(dev) for n in (Hd, O))
    lens = _lengths_0_1(B, T, dev, g)
    n10 = KF.bare_launches
    got = KF.fused_ffn(x, w1, b1, w2, b2, lens, k, out_dtype)
    want = KF.fused_ffn_plain(x, w1, b1, w2, b2, lens, k, out_dtype)
    torch.cuda.synchronize()
    assert KF.bare_launches == n10 + 1
    assert got.dtype == out_dtype and got.shape == (B, T, O)
    _close(got, want)
    # length 0: the dead tiles (all but the first) hold the one bias row
    assert torch.equal(got[-1, 64:], got[-1, 64:65].expand(T - 64, O))


def test_new_kernels_refuse_the_wrong_dtype(dev):
    """A CUDA tensor the kernels do not take raises; nothing falls back to
    the plain version."""
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    B, T, D = 2, 64, 256
    q = torch.randn(B, T, D, device=dev)  # f32: the f32 entry is not ported
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    n = (KA.res_launches, KA.packed_launches, KA.bhtd_launches, KF.pre_launches,
         KF.bare_launches)
    wo, bo = torch.zeros(D, D, dtype=torch.bfloat16, device=dev), torch.zeros(D, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        KA.attention_res(q, q, q, q, wo, bo, lens, 2)
    with pytest.raises(ValueError, match="bfloat16"):
        KA.fused_attention_packed(q, q, q, lens, 2)
    q4 = q.reshape(B, 2, T, D // 2)
    with pytest.raises(ValueError, match="bfloat16"):
        KA.fused_attention(q4, q4, q4, lens)
    with pytest.raises(ValueError, match="d_k"):
        qb = torch.zeros(B, 4, T, 64, dtype=torch.bfloat16, device=dev)
        KA.fused_attention(qb, qb, qb, lens)
    w1 = torch.zeros(1024, 9 * D, dtype=torch.bfloat16, device=dev)
    w2 = torch.zeros(D, 1024, dtype=torch.bfloat16, device=dev)
    b1, b2 = torch.zeros(1024, device=dev), torch.zeros(D, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        KF.ffn_block_pre(q.to(torch.bfloat16), w1, b1, w2, b2, b2, b2, lens, 9)
    with pytest.raises(ValueError, match="dtype"):
        KF.fused_ffn(q, w1, b1, w2, b2, lens, 9)
    with pytest.raises(ValueError, match="out_dtype"):
        KF.fused_ffn(q.to(torch.bfloat16), w1, b1, w2, b2, lens, 9, torch.float16)
    assert (KA.res_launches, KA.packed_launches, KA.bhtd_launches, KF.pre_launches,
            KF.bare_launches) == n
