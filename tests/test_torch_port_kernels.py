"""The plain versions of the port's six kernels (fastspeech2_tpu_torch/ops/
kernels/) against the JAX Pallas kernels they port, run in interpret mode on
the CPU as tests/test_pallas.py runs them.

Inputs come from numpy seeds and reach both sides as the same numbers. The
lengths cover a full row, a row cut inside a block, a length-1 row and
blocks wholly past the length (the JAX kernels' dead-block branches, at
block 8). Tolerances: f32 rtol/atol 1e-5 (the bar tests/test_pallas.py holds
interpret kernels to); bf16 a band stated per test -- both sides round at
the same points, so what differs is f32 summation order, which flips an
occasional bf16 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_tpu.ops.pallas.adaptor import fused_variance_adaptor
from fastspeech2_tpu.ops.pallas.attention import (fused_attention_packed_qkv_res_ln,
                                                  fused_attention_packed_res_ln)
from fastspeech2_tpu.ops.pallas.ffn import fused_ffn_block_post
from fastspeech2_tpu.ops.pallas.postnet import fused_postnet
from fastspeech2_tpu.ops.pallas.resstack import resstack_fused
from fastspeech2_tpu_torch.ops.kernels import adaptor as KAd
from fastspeech2_tpu_torch.ops.kernels import attention as KA
from fastspeech2_tpu_torch.ops.kernels import ffn as KF
from fastspeech2_tpu_torch.ops.kernels import postnet as KP
from fastspeech2_tpu_torch.ops.kernels import resstack as KR
from fastspeech2_tpu_torch.ops.quantize import linear_bins, log_bins

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, tier, band):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if tier == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        d = np.abs(got - want)
        assert d.mean() < band[0] and d.max() < band[1], (d.mean(), d.max())


# (tier, D, heads) of kernels 1 and 5: two heads of 32, then one head of
# 256 (d_k 256, the widest Hopper instantiation)
HALF_CASES = [("f32", 64, 2), ("bf16", 64, 2), ("f32", 256, 1), ("bf16", 256, 1)]
HALF_IDS = ["f32", "bf16", "f32-dk256", "bf16-dk256"]


@pytest.mark.parametrize("tier,D,H", HALF_CASES, ids=HALF_IDS)
def test_attention_block_matches_pallas(tier, D, H, rng):
    """Kernel 1: LN(x + MHA(x)·Wo + bo); rows past the length give
    LN(x + bo). bf16 band: mean 2e-3, max 5e-2 (LN output, unit scale)."""
    B, T = 3, 32
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    w = [(rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32) for _ in range(4)]
    bqkv = (rng.normal(size=(3, D)) * 0.1).astype(np.float32)
    bo = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    g = (rng.normal(size=(D,)) * 0.2 + 1.0).astype(np.float32)
    be = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    lengths = np.asarray([32, 13, 1], np.int32)
    jd = JAX_DT[tier]
    want = fused_attention_packed_qkv_res_ln(
        jnp.asarray(x), *(jnp.asarray(wi, jd) for wi in w[:3]), jnp.asarray(bqkv),
        jnp.asarray(w[3], jd), jnp.asarray(bo[None]), jnp.asarray(g), jnp.asarray(be),
        jnp.asarray(lengths), H, interpret=True, block_q=8)
    td = TORCH_DT[tier]
    wqkv = torch.cat([_t(wi.T) for wi in w[:3]]).to(td)
    got = KA.attention_block(_t(x), wqkv, _t(bqkv.reshape(-1)), _t(w[3].T).to(td),
                             _t(bo), _t(g), _t(be), torch.from_numpy(lengths), H)
    _close(got, want, tier, (2e-3, 5e-2))
    # rows at/past the length: exactly the JAX kernel's dead-row constant
    dead = np.asarray(want)[1, 13:]
    np.testing.assert_allclose(got.numpy()[1, 13:], dead, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tier", ["f32", "bf16"])
def test_ffn_block_matches_pallas(tier, rng):
    """Kernel 2: LN(x + Conv_k1(ReLU(Conv_k(mask(x))))); rows whose window is
    past the length give the bias-only row. bf16 band: mean 2e-3, max 5e-2."""
    B, T, D, Hd, k = 3, 32, 32, 64, 9
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    w1 = (rng.normal(size=(k, D, Hd)) * 0.1).astype(np.float32)
    b1 = rng.normal(size=(Hd,)).astype(np.float32)
    w2 = (rng.normal(size=(1, Hd, D)) * 0.1).astype(np.float32)
    b2 = rng.normal(size=(D,)).astype(np.float32)
    g = (rng.normal(size=(D,)) * 0.2 + 1.0).astype(np.float32)
    be = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    lengths = np.asarray([32, 19, 1], np.int32)
    jd, td = JAX_DT[tier], TORCH_DT[tier]
    want = fused_ffn_block_post(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(be), jnp.asarray(w1, jd),
        jnp.asarray(b1), jnp.asarray(w2, jd), jnp.asarray(b2), jnp.asarray(lengths),
        cd=jd, interpret=True, block_t=8)
    got = KF.ffn_block(_t(x), _t(w1.transpose(2, 0, 1).reshape(Hd, k * D)).to(td),
                       _t(b1), _t(w2[0].T).to(td), _t(b2), _t(g), _t(be),
                       torch.from_numpy(lengths), k)
    _close(got, want, tier, (2e-3, 5e-2))
    # row 2 (length 1): blocks 1..3 are the JAX kernel's dead blocks
    np.testing.assert_allclose(got.numpy()[2, 8:], np.asarray(want)[2, 8:],
                               rtol=1e-5, atol=1e-5)


def _adaptor_inputs(rng, B, T, D, C, L, nb):
    k = 3
    hs = rng.normal(size=(B, T, D)).astype(np.float32)
    ds = rng.integers(1, 4, (B, T)).astype(np.int32)
    ilens = np.asarray([T, 5, 1], np.int32)[:B]
    cum = np.cumsum(np.where(np.arange(T)[None] < ilens[:, None], ds, 0), -1)
    out_lens = np.minimum(cum[:, -1], L).astype(np.int32)
    idx = np.minimum((cum[:, None, :] <= np.arange(L)[None, :, None]).sum(-1),
                     T - 1).astype(np.int32)
    p = {
        "w1": (rng.normal(size=(2, k, D, C)) / np.sqrt(k * D)),
        "b1": rng.normal(size=(2, C)) * 0.1,
        "g1": 1.0 + 0.1 * rng.normal(size=(2, C)), "be1": 0.1 * rng.normal(size=(2, C)),
        "w2": (rng.normal(size=(2, k, C, C)) / np.sqrt(k * C)),
        "b2": rng.normal(size=(2, C)) * 0.1,
        "g2": 1.0 + 0.1 * rng.normal(size=(2, C)), "be2": 0.1 * rng.normal(size=(2, C)),
        # head scaled so the predictions spread over the bins
        "wo": rng.normal(size=(2, C)) * 8.0,
        "bo": np.asarray([[200.0, 40.0]]),
        "emb_w": rng.normal(size=(2, nb, D)), "emb_b": rng.normal(size=(2, D)),
    }
    p = {n: np.asarray(v, np.float32) for n, v in p.items()}
    inf = np.full((1,), np.inf, np.float32)
    bins = np.stack([np.concatenate([log_bins(71.0, 400.0, nb), inf]),
                     np.concatenate([linear_bins(0.0, 80.0, nb), inf])])
    return hs, idx, out_lens, p, bins


@pytest.mark.parametrize("tier,D", [("f32", 32), ("bf16", 32), ("f32", 40), ("bf16", 40)],
                         ids=["f32", "bf16", "f32-D40", "bf16-D40"])
def test_variance_adaptor_matches_pallas(tier, D, rng):
    """Kernel 3: expansion -> pitch/energy predictors -> bucketize ->
    embeddings -> residual, zeroed past out_len; raw predictions zeroed past
    out_len. bf16: the bucketize sits on a knife-edge (a one-ulp difference
    in the head moves a frame to the next bucket), so at most 5% of live
    frames may land one bucket off; all other frames agree within mean 1e-3,
    max 2e-2, and the raw predictions within 1% relative. D = 40 is not a
    multiple of 32 (nor of the K step, 16: the kernel zero-pads each tap)."""
    B, T, C, L, nb = 3, 10, 32, 32, 16
    hs, idx, out_lens, p, bins = _adaptor_inputs(rng, B, T, D, C, L, nb)
    jd, td = JAX_DT[tier], TORCH_DT[tier]
    want, raw_want = fused_variance_adaptor(
        jnp.asarray(hs), jnp.asarray(idx), jnp.asarray(out_lens),
        jnp.asarray(p["w1"], jd), jnp.asarray(p["b1"]), jnp.asarray(p["g1"]),
        jnp.asarray(p["be1"]), jnp.asarray(p["w2"], jd), jnp.asarray(p["b2"]),
        jnp.asarray(p["g2"]), jnp.asarray(p["be2"]), jnp.asarray(p["wo"], jd),
        jnp.asarray(p["bo"]), jnp.asarray(bins), jnp.asarray(p["emb_w"], jd),
        jnp.asarray(p["emb_b"]), cd=jd, interpret=True, block_l=8)
    got, raw = KAd.variance_adaptor(
        _t(hs), torch.from_numpy(idx), torch.from_numpy(out_lens),
        _t(p["w1"].transpose(0, 3, 1, 2).reshape(2, C, 3 * D)).to(td),
        _t(p["b1"]), _t(p["g1"]), _t(p["be1"]),
        _t(p["w2"].transpose(0, 3, 1, 2).reshape(2, C, 3 * C)).to(td),
        _t(p["b2"]), _t(p["g2"]), _t(p["be2"]), _t(p["wo"]).to(td),
        _t(p["bo"][0]), _t(bins), _t(p["emb_w"]).to(td), _t(p["emb_b"]))
    want, raw_want = np.asarray(want), np.asarray(raw_want)
    live = np.arange(L)[None] < out_lens[:, None]
    assert np.all(got.numpy()[~live] == 0.0) and np.all(raw.numpy()[:, 0][~live] == 0.0)
    if tier == "f32":
        np.testing.assert_allclose(raw.numpy(), raw_want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        return
    np.testing.assert_allclose(raw.numpy(), raw_want, rtol=1e-2, atol=1e-2)
    bk = lambda r, i: (bins[i][None, None] < r[:, i][..., None]).sum(-1)  # noqa: E731
    same = (bk(raw.numpy(), 0) == bk(raw_want, 0)) & (bk(raw.numpy(), 1) == bk(raw_want, 1))
    assert (~same & live).sum() <= 0.05 * live.sum(), (~same & live).sum()
    d = np.abs(got.numpy() - want)[same & live]
    assert d.mean() < 1e-3 and d.max() < 2e-2, (d.mean(), d.max())


@pytest.mark.parametrize("tier,C0,C,k,n", [("f32", 8, 32, 5, 3), ("bf16", 8, 32, 5, 3),
                                           ("f32", 8, 40, 7, 4), ("bf16", 8, 40, 7, 4)],
                         ids=["f32", "bf16", "f32-C40-k7", "bf16-C40-k7"])
def test_postnet_matches_pallas(tier, C0, C, k, n, rng):
    """Kernel 4: n stages of conv k -> BN -> tanh (none last), inputs
    re-zeroed past the length; tiles past length + halo give the last
    stage's BN of a zero input. 3 stages of k=5 at C=32, and 4 of k=7 at
    C=40 (not a multiple of 32; a halo of 9 rows a side past the first
    stage). bf16 band: mean 2e-3, max 3e-2."""
    from fastspeech2_tpu_torch.models.postnet import Postnet, PostnetConfig

    B, L = 3, 48
    cfg = PostnetConfig(odim=C0, n_layers=n, n_chans=C, n_filts=k)
    net = Postnet(cfg, device="cpu")
    x = rng.normal(size=(B, L, C0)).astype(np.float32)
    ws, means, invs, gs, bs = [], [], [], [], []
    with torch.no_grad():
        for layer in net.layers:
            cout, cin, _ = layer.conv.weight.shape
            w = (rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
            ws.append(w)
            layer.conv.weight.copy_(_t(w.transpose(2, 1, 0)))
            for name, v in (("running_mean", 0.1 * rng.normal(size=cout)),
                            ("running_var", 1.0 + rng.random(cout)),
                            ("weight", 1.0 + 0.1 * rng.normal(size=cout)),
                            ("bias", 0.1 * rng.normal(size=cout))):
                getattr(layer.bn, name).copy_(_t(v))
            means.append(layer.bn.running_mean.numpy())
            invs.append(torch.rsqrt(layer.bn.running_var + 1e-5).numpy())
            gs.append(layer.bn.weight.numpy())
            bs.append(layer.bn.bias.numpy())
    lengths = np.asarray([48, 21, 1], np.int32)
    jd, td = JAX_DT[tier], TORCH_DT[tier]
    want = np.asarray(fused_postnet(
        jnp.asarray(x), [jnp.asarray(w, jd) for w in ws], [jnp.asarray(m) for m in means],
        [jnp.asarray(v) for v in invs], [jnp.asarray(v) for v in gs],
        [jnp.asarray(v) for v in bs], jnp.asarray(lengths), cd=jd, interpret=True,
        block_t=8))
    w_flat, bn, hidden = KP.pack_weights(net.layers, td)
    got = KP.postnet(_t(x), w_flat, bn, torch.from_numpy(lengths), n, hidden, k)
    _close(got, want, tier, (2e-3, 3e-2))
    # row 2 (length 1): blocks from 16 on are past length + halo (6 or 12)
    np.testing.assert_allclose(got.numpy()[2, 16:], want[2, 16:], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tier,D,H", HALF_CASES, ids=HALF_IDS)
def test_attention_res_ln_matches_pallas(tier, D, H, rng):
    """Kernel 5: LN(res + MHA(q, k, v)·Wo + bo) with q/k/v given in the
    compute dtype and a separate f32 residual; rows past the length give
    LN(res + bo). bf16 band: mean 2e-3, max 5e-2 (LN output, unit scale)."""
    B, T = 3, 32
    jd, td = JAX_DT[tier], TORCH_DT[tier]
    q, k, v = (np.asarray(jnp.asarray(rng.normal(size=(B, T, D)), jd).astype(jnp.float32))
               for _ in range(3))  # values of the compute dtype
    res = rng.normal(size=(B, T, D)).astype(np.float32)
    wo = (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32)
    bo = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    g = (rng.normal(size=(D,)) * 0.2 + 1.0).astype(np.float32)
    be = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    lengths = np.asarray([32, 13, 1], np.int32)
    want = np.asarray(fused_attention_packed_res_ln(
        *(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(res), jnp.asarray(wo, jd),
        jnp.asarray(bo[None]), jnp.asarray(g), jnp.asarray(be), jnp.asarray(lengths), H,
        interpret=True, block_q=8))
    got = KA.attention_res_ln(_t(q, td), _t(k, td), _t(v, td), _t(res), _t(wo.T).to(td),
                              _t(bo), _t(g), _t(be), torch.from_numpy(lengths), H)
    _close(got, want, tier, (2e-3, 5e-2))
    np.testing.assert_allclose(got.numpy()[1, 13:], want[1, 13:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy()[2, 1:], want[2, 1:], rtol=1e-5, atol=1e-5)


def _stack_weights(rng, C, n=3):
    """One MelGAN stage in the JAX layout: w1 (n, 3, C, C), w2 (n, C, C)."""
    w1 = (rng.normal(size=(n, 3, C, C)) / np.sqrt(3 * C)).astype(np.float32)
    w2 = (rng.normal(size=(n, C, C)) / np.sqrt(C)).astype(np.float32)
    b1, b2 = ((rng.normal(size=(n, C)) * 0.1).astype(np.float32) for _ in range(2))
    return w1, b1, w2, b2


@pytest.mark.parametrize("tier", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,C", [(2, 512, 8), (1, 128, 128), (2, 256, 32), (1, 128, 48),
                                   (1, 128, 96)])
def test_resstack_matches_pallas(tier, rng, B, S, C):
    """Kernel 13: three dilated residual blocks with per-layer reflection at
    the sequence ends. (2, 512, 8): four 128-sample tiles of the JAX kernel
    at C < 128 (channel padding on the JAX side only); (1, 128, 128): a
    single tile holding both ends; (2, 256, 32): two tiles; C = 48 and 96:
    widths the CUDA kernel takes natively since it runs on wgmma (before,
    only 32/64/128/256). f32 1e-5; bf16,
    where both sides round at the same points and activations grow through
    the residual adds: 2 bf16 ulps (2^-7) of the output's scale at most, and
    under 2^-11 of it on average."""
    jd, td = JAX_DT[tier], TORCH_DT[tier]
    w1, b1, w2, b2 = _stack_weights(rng, C)
    x = np.asarray(jnp.asarray(rng.normal(size=(B, S, C)), jd).astype(jnp.float32))
    want = np.asarray(resstack_fused(
        jnp.asarray(x, jd), jnp.asarray(w1, jd), jnp.asarray(b1, jd), jnp.asarray(w2, jd),
        jnp.asarray(b2, jd), interpret=True).astype(jnp.float32))
    assert KR.resstack_tile(S) > 0
    # kernel layout: (out, tap, in) and (out, in); biases hold cd values
    pw1 = _t(w1.transpose(0, 3, 1, 2).reshape(3, C, 3 * C)).to(td)
    pw2 = _t(w2.transpose(0, 2, 1)).to(td)
    got = KR.resstack(_t(x), pw1, _t(b1).to(td).float(), pw2, _t(b2).to(td).float())
    assert got.shape == (B, S, C)
    if tier == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        d, scale = np.abs(got.numpy() - want), np.abs(want).max()
        assert d.max() <= scale * 2.0 ** -7 and d.mean() < scale * 2.0 ** -11, (
            d.max(), d.mean(), scale)


@pytest.mark.parametrize("tier", ["f32", "bf16"])
@pytest.mark.parametrize("C", [1, 24, 100, 200])
def test_resstack_pads_unserved_widths(tier, rng, C):
    """The wrapper zero-pads a width the CUDA kernel does not take to the
    next one it does (``served_width``: multiples of 16 up to 128, of 32 up
    to 256): the padded channels stay exact zeros and the real ones are the
    unpadded function's (zero weights and biases add exact zeros; only the
    f32 summation order of the longer products differs), here through the
    plain version. Bands as for the Pallas comparison above."""
    td = TORCH_DT[tier]
    Cp = KR.served_width(C)
    assert Cp >= C and (Cp % 16 == 0 if Cp <= 128 else Cp % 32 == 0)
    assert Cp - C < (16 if Cp <= 128 else 32)
    w1, b1, w2, b2 = _stack_weights(rng, C)
    x = _t(rng.normal(size=(2, 128, C))).to(td).float()
    args = (x, _t(w1.transpose(0, 3, 1, 2).reshape(3, C, 3 * C)).to(td), _t(b1).to(td).float(),
            _t(w2.transpose(0, 2, 1)).to(td), _t(b2).to(td).float())
    padded = KR.pad_channels(*args, Cp)
    assert padded[1].shape == (3, Cp, 3 * Cp) and padded[3].shape == (3, Cp, Cp)
    got = KR.resstack_plain(*padded)
    want = KR.resstack_plain(*args).numpy()
    if tier == "f32":
        np.testing.assert_allclose(got[..., :C].numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        d, scale = np.abs(got[..., :C].numpy() - want), np.abs(want).max()
        assert d.max() <= scale * 2.0 ** -7 and d.mean() < scale * 2.0 ** -11, (
            d.max(), d.mean(), scale)
    assert not got[..., C:].any()
    assert [KR.served_width(c) for c in (16, 48, 128, 129, 256, 257, 512)] == [
        16, 48, 128, 160, 256, 0, 0]


def test_resstack_pack_weights_and_tile():
    """pack_weights lays a stage's torch convs out for the kernel; the
    tileable lengths are the JAX package's."""
    from fastspeech2_tpu.ops.pallas.resstack import resstack_tile as j_tile
    from fastspeech2_tpu_torch.vocoder.melgan import MelGANConfig, MelGANGenerator

    gen = MelGANGenerator(MelGANConfig(base_channels=16), device="cpu", seed=5)
    stacks = gen.blocks[0].stacks
    w1, b1, w2, b2 = KR.pack_weights(stacks, torch.bfloat16)
    assert w1.shape == (3, 8, 24) and w1.dtype == torch.bfloat16
    assert w2.shape == (3, 8, 8) and b1.dtype == torch.float32
    np.testing.assert_array_equal(
        w1[1, :, 8:16].float().numpy(),
        stacks[1].c1.weight[:, :, 1].to(torch.bfloat16).float().detach().numpy())
    np.testing.assert_array_equal(
        b2[2].numpy(), stacks[2].c2.bias.to(torch.bfloat16).float().detach().numpy())
    for S in (13, 64, 128, 384, 2000, 2048, 6144, 196608):
        assert KR.resstack_tile(S) == j_tile(S)


def _parent_served(D, H, k, O):
    """Whether the mma.sync FFN body (PR 1-8) launched this shape: D and H
    multiples of 32, odd k, O >= 1, its conv tile (64 + k - 1 rows of D + 8
    bf16 plus 40 KB of weight slices) and its output tile (64 hidden rows of
    H + 8 plus 90 KB of slices) within a block's 232,448 bytes."""
    return (D % 32 == 0 and H % 32 == 0 and k % 2 == 1 and O >= 1
            and ((64 + k - 1) * (D + 8) + 20480) * 2 <= KF.SMEM_MAX
            and max((64 * (H + 8) + 46080) * 2, 4 * O) <= KF.SMEM_MAX)


@pytest.mark.parametrize("D", [256, 384, 768])
def test_ffn_plan_fits_the_attention_projections(D):
    """Kernels 1, 5 and 6 run their projections on the FFN body at k = 1
    (csrc/attention.cu): the q|k|v projection is launch 1 with 3D hidden
    columns, the out projection launch 2 with D inputs and outputs. At the
    widths of one to three heads of 256 (and the shipped D = 256, 384) both
    plans exist and fit a block; launch 1's row tiles are whole 64-row key
    tiles of the attention forward (it writes every row of a live tile, so
    the key tile that holds the length is written to its end), its columns
    cover 3D, and launch 2's passes cover D."""
    qkv, out = KF.plan(D, 3 * D, 1, D), KF.plan(D, D, 1, D)
    assert qkv.p % 64 == 0 and (qkv.p, qkv.nh) in KF.CONV_TILES
    assert qkv.smem1 == D * (qkv.p | 1) * 2 + qkv.st1 * qkv.nh * 128 + KF.SLACK  # x tile, ring
    assert 2 <= qkv.st1 <= 4 and qkv.smem1 <= KF.SMEM_MAX
    assert -(-3 * D // qkv.nh) * qkv.nh >= 3 * D
    assert out.passes * 2 * out.no >= D > (out.passes - 1) * 2 * out.no
    assert 2 <= out.st2 <= 4 and out.minb2 * (out.smem2 + 1024) <= KF.SMEM_MAX + 1024
    assert out.no % 64 == 0 and 64 <= out.no <= 256


@pytest.mark.parametrize("D", [32, 96, 256, 384, 512, 1024, 1440, 1472])
def test_ffn_plan_fits_and_covers(D):
    """ops/kernels/ffn.py:plan (the tiling csrc/ffn.cu picks the same way)
    over every (H, k, O) of a grid that the previous kernel body served at
    this D: a plan exists, each launch's shared memory fits a block (two
    blocks an SM where it plans two), the conv tile holds the block's rows
    and their halo, and the grids cover every hidden and output column with
    wgmma widths (multiples of 16 up to 256) and TMA boxes (up to 256 rows),
    and launch 2's drained ring holds its block's round(y)."""
    served = 0
    for H in (32, 64, 1024, 1056, 1088):
        for k in (1, 3, 5, 9, 31, 101):
            for O in sorted({1, 80, 200, 255, D, 513, 1025}):
                if not _parent_served(D, H, k, O):
                    continue
                served += 1
                pl = KF.plan(D, H, k, O)
                assert (pl.p, pl.nh) in KF.CONV_TILES
                rows = (pl.p + k - 1) | 1
                assert rows >= pl.p + k - 1
                assert pl.smem1 == D * rows * 2 + pl.st1 * pl.nh * 128 + KF.SLACK
                assert 2 <= pl.st1 <= 4 and pl.smem1 <= KF.SMEM_MAX
                # launch 1: warpgroups of 64 rows; nh // (3 - p // 64) columns each
                wn = pl.nh if pl.p == 128 else pl.nh // 2
                assert wn % 16 == 0 and wn <= 256 and pl.nh <= 256
                assert -(-H // pl.nh) * pl.nh >= H
                # launch 2: passes x 2 warpgroups x no columns cover O
                assert pl.no % 64 == 0 and 64 <= pl.no <= 256
                assert pl.passes * 2 * pl.no >= O
                assert (pl.passes - 1) * 2 * pl.no < O  # no pass is empty
                stage = 64 * 64 * 2 + 2 * pl.no * 64 * 2
                assert pl.smem2 == pl.st2 * stage + KF.SLACK
                assert 64 * (2 * pl.no + 8) * 4 <= pl.st2 * stage  # round(y) staging
                assert 2 <= pl.st2 <= 4 and pl.minb2 in (1, 2)
                assert pl.minb2 * (pl.smem2 + 1024) <= KF.SMEM_MAX + 1024
    assert served > 0


def test_adaptor_plan_fits_and_covers():
    """ops/kernels/adaptor.py:plan (the tiling csrc/adaptor.cu picks the
    same way) at every D the kernel takes, the multiples of 8 from 64 to
    1024: the plan fits a block's shared memory; the x tile holds the
    block's 64 conv rows and both convs' halo (66 rows, odd, D rounded up to
    the K step) and H1 its 64 rows and the two that conv2 reads past them;
    the two warpgroups cover the 256 channels, 128 each (a wgmma width);
    the ring has two stages of 128-column tiles, or at least one of 64
    columns; the frames of a grid of 62-frame tiles cover L. Other shapes
    raise ValueError."""
    assert KAd.TILE_ROWS == 67 and KAd.ROWS - 2 == 62
    assert 2 * 128 == KAd.CHANNELS
    for D in range(64, 1025, 8):
        pl = KAd.plan(D)
        dp = -(-D // 16) * 16
        assert dp >= D and dp % 16 == 0
        tile = pl.kt // 64 * KAd.RING_SUB
        assert pl.smem == (KAd.TILE_ROWS * (dp + KAd.CHANNELS) * 2 + KAd.misc_bytes()
                           + KF.SLACK + pl.st * tile)
        assert pl.smem <= KF.SMEM_MAX
        assert (2 if pl.kt == 128 else 1) <= pl.st <= 4
        assert pl.kt == (128 if D <= 416 else 64), D
        for L in (1, 62, 63, 768, 1000):
            assert -(-L // 62) * 62 >= L
        assert KAd.plan(D, 4096).smem <= KF.SMEM_MAX
    for D in (0, 8, 56, 60, 100, 1028, 1032, 2048):
        with pytest.raises(ValueError):
            KAd.plan(D)
    for NB in (0, 4097):
        with pytest.raises(ValueError):
            KAd.plan(256, NB)


def test_postnet_plan_fits_and_covers():
    """ops/kernels/postnet.py:plan (the tiling csrc/postnet.cu picks the
    same way) over every width the kernel takes (C a multiple of 8 up to
    512, C0 up to 256, odd k up to 9, 2 to 8 layers): the plan fits a
    block's shared memory with at least two ring stages; the warpgroups'
    wgmma widths are instantiated ones and cover C and C0 rounded up to the
    K step; the chain's buffer holds a launch's output tile plus its halo
    (k - 1 rows a stage) at an odd row count; every launch gives at least
    half its stage rows of output frames; the launches cover the stages in
    order, at most two (one scratch plane). Other shapes raise ValueError."""
    seen = set()
    for C in range(8, 513, 8):
        for C0 in range(8, 257, 8):
            for k in (1, 3, 5, 7, 9):
                for n in range(2, 9):
                    pl = KP.plan(C0, C, k, n)
                    cp, c0p = -(-C // 16) * 16, -(-C0 // 16) * 16
                    m = 64 * pl.wr
                    R = (m + k - 1) | 1
                    assert pl.smem <= KF.SMEM_MAX and 2 <= pl.st <= 4
                    if pl.wr == 2:
                        assert cp <= 256 and pl.nh >= cp and pl.nl >= c0p
                        assert pl.nh in (128, 256) and pl.nl in (80, 128, 256)
                        tile = 2 * max(pl.nh, pl.nl) * 128
                    else:
                        assert cp > 256 and 2 * pl.nh >= cp and 2 * pl.nl >= c0p
                        assert pl.nh == 256 and pl.nl in (48, 64, 128)
                        tile = 2 * 256 * 128
                    assert pl.smem == (max(cp, c0p) * R * 2 + 16 * max(C, C0)
                                       + pl.st * tile + KF.SLACK)
                    parts = KP.launch_stages(pl, n)
                    assert [i for r in parts for i in r] == list(range(n))
                    assert len(parts) <= 2
                    for r in parts:
                        P = m - (len(r) - 1) * (k - 1)
                        assert 2 * P >= m
                        # a block's first input rows: P frames and the
                        # launch's halo of len(r) (k - 1) / 2 rows a side
                        assert P + len(r) * (k - 1) == m + k - 1 <= R
                    seen.add((pl.wr, pl.nh, pl.nl))
    assert len(seen) == 9  # every instantiated kernel is some shape's
    for C0, C, k, n in ((80, 520, 5, 5), (264, 256, 5, 5), (80, 256, 11, 5),
                        (80, 256, 4, 5), (80, 256, 5, 1), (80, 256, 5, 9),
                        (80, 36, 5, 5), (84, 256, 5, 5), (0, 256, 5, 5)):
        with pytest.raises(ValueError):
            KP.plan(C0, C, k, n)
