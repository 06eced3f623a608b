"""Kernels 3 and 4 (the variance adaptor and the postnet) at the widths the
JAX routes give them past the port's first range: the plain versions
against the Pallas functions with ``interpret=True``, the padded packs, and
the tilings over the whole range.

Kernel 3 takes D from 1 to 2048 and 1 to 65,536 bin edges: w1's input
columns and the embeddings are zero-padded to D rounded up to 8 at pack
time, the x tile is loaded in column chunks where it does not fit whole,
and the edges are counted in chunks. Kernel 4 takes C and C0 from 1 to
1024, odd k up to 31 and 1 to 32 layers: chains that fit run in one or more
launches through two bf16 planes used in turn, the others one launch a
stage. Tolerances as in tests/test_torch_port_kernels.py: f32 1e-5; bf16 at
most 5% of live frames one bucket off, other rows within mean 1e-3, max
2e-2 (adaptor), mean 2e-3, max 3e-2 (postnet).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_tpu.ops.pallas.adaptor import fused_variance_adaptor
from fastspeech2_tpu.ops.pallas.postnet import fused_postnet
from fastspeech2_tpu_torch.models.postnet import Postnet, PostnetConfig
from fastspeech2_tpu_torch.ops.kernels import adaptor as KAd
from fastspeech2_tpu_torch.ops.kernels import postnet as KP
from fastspeech2_tpu_torch.ops.kernels.ffn import SLACK, SMEM_MAX
from fastspeech2_tpu_torch.ops.quantize import linear_bins, log_bins
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _adaptor_inputs(rng, B, T, D, C, L, nb):
    """Seeded kernel-3 inputs: encoder states, expansion indices from
    durations 1-3 (rows of T, 5 and 1 tokens), predictor weights laid out
    (2, k, in, out) as the JAX function takes them, the head scaled so the
    predictions spread over nb bins."""
    k = 3
    hs = rng.normal(size=(B, T, D)).astype(np.float32)
    ds = rng.integers(1, 4, (B, T)).astype(np.int32)
    ilens = np.asarray([T, 5, 1], np.int32)[:B]
    cum = np.cumsum(np.where(np.arange(T)[None] < ilens[:, None], ds, 0), -1)
    out_lens = np.minimum(cum[:, -1], L).astype(np.int32)
    idx = np.minimum((cum[:, None, :] <= np.arange(L)[None, :, None]).sum(-1),
                     T - 1).astype(np.int32)
    p = {"w1": rng.normal(size=(2, k, D, C)) / np.sqrt(k * D),
         "b1": rng.normal(size=(2, C)) * 0.1,
         "g1": 1.0 + 0.1 * rng.normal(size=(2, C)), "be1": 0.1 * rng.normal(size=(2, C)),
         "w2": rng.normal(size=(2, k, C, C)) / np.sqrt(k * C),
         "b2": rng.normal(size=(2, C)) * 0.1,
         "g2": 1.0 + 0.1 * rng.normal(size=(2, C)), "be2": 0.1 * rng.normal(size=(2, C)),
         "wo": rng.normal(size=(2, C)) * 8.0, "bo": np.asarray([[200.0, 40.0]]),
         "emb_w": rng.normal(size=(2, nb, D)), "emb_b": rng.normal(size=(2, D))}
    p = {n: np.asarray(v, np.float32) for n, v in p.items()}
    inf = np.full((1,), np.inf, np.float32)
    bins = np.stack([np.concatenate([log_bins(71.0, 400.0, nb), inf]),
                     np.concatenate([linear_bins(0.0, 80.0, nb), inf])])
    return hs, idx, out_lens, p, bins


def _adaptor_port_args(p, C, D, td):
    """The port's layout of the predictor weights: w1 (2, C, 3 D), w2 (2,
    C, 3 C), (out, tap, in), in the compute dtype."""
    return (_t(p["w1"].transpose(0, 3, 1, 2).reshape(2, C, 3 * D)).to(td),
            _t(p["b1"]), _t(p["g1"]), _t(p["be1"]),
            _t(p["w2"].transpose(0, 3, 1, 2).reshape(2, C, 3 * C)).to(td),
            _t(p["b2"]), _t(p["g2"]), _t(p["be2"]), _t(p["wo"]).to(td), _t(p["bo"][0]))


@pytest.mark.parametrize("tier", ["f32", "bf16"])
def test_adaptor_at_d36_and_4100_bins_matches_pallas(tier, rng):
    """Kernel 3 at D = 36 (below 64, not a multiple of 8: the port's pack
    pads w1's taps and the embeddings to 40 columns) and 4,100 bins (past
    the 4,096 edges the kernel holds in shared memory at a time): the
    wrapper on the padded pack against the Pallas function. Rows past
    out_len and their raw predictions exactly zero."""
    B, T, C, L, nb, D = 3, 10, 32, 32, 4100, 36
    hs, idx, out_lens, p, bins = _adaptor_inputs(rng, B, T, D, C, L, nb)
    jd, td = JAX_DT[tier], TORCH_DT[tier]
    want, raw_want = fused_variance_adaptor(
        jnp.asarray(hs), jnp.asarray(idx), jnp.asarray(out_lens),
        jnp.asarray(p["w1"], jd), jnp.asarray(p["b1"]), jnp.asarray(p["g1"]),
        jnp.asarray(p["be1"]), jnp.asarray(p["w2"], jd), jnp.asarray(p["b2"]),
        jnp.asarray(p["g2"]), jnp.asarray(p["be2"]), jnp.asarray(p["wo"], jd),
        jnp.asarray(p["bo"]), jnp.asarray(bins), jnp.asarray(p["emb_w"], jd),
        jnp.asarray(p["emb_b"]), cd=jd, interpret=True, block_l=8)
    w = _adaptor_port_args(p, C, D, td)
    w1, emb_w, emb_b = KAd.pad_weights(w[0], _t(p["emb_w"]).to(td), _t(p["emb_b"]), D)
    assert w1.shape == (2, C, 3 * 40) and emb_w.shape == (2, nb, 40) and emb_b.shape == (2, 40)
    got, raw = KAd.variance_adaptor(_t(hs), torch.from_numpy(idx), torch.from_numpy(out_lens),
                                    w1, *w[1:], _t(bins), emb_w, emb_b)
    want, raw_want = np.asarray(want), np.asarray(raw_want)
    live = np.arange(L)[None] < out_lens[:, None]
    assert np.all(got.numpy()[~live] == 0.0) and np.all(raw.numpy()[:, 0][~live] == 0.0)
    if tier == "f32":
        # the head's sums (raw - bo) add 32 terms of up to ~30 (the head is
        # scaled by 8) that cancel to anything from 0 to ~100: their f32
        # rounding is 1e-5 of that scale, not of each sum
        y, y_want = raw.numpy() - p["bo"][0][None, :, None], raw_want - p["bo"][0][None, :, None]
        np.testing.assert_allclose(y, y_want, rtol=1e-5, atol=1e-5 * np.abs(y_want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        return
    np.testing.assert_allclose(raw.numpy(), raw_want, rtol=1e-2, atol=1e-2)
    bk = lambda r, i: (bins[i][None, None] < r[:, i][..., None]).sum(-1)  # noqa: E731
    same = (bk(raw.numpy(), 0) == bk(raw_want, 0)) & (bk(raw.numpy(), 1) == bk(raw_want, 1))
    assert (~same & live).sum() <= 0.05 * live.sum(), (~same & live).sum()
    d = np.abs(got.numpy() - want)[same & live]
    assert d.mean() < 1e-3 and d.max() < 2e-2, (d.mean(), d.max())


def _postnet_case(rng, C0, C, k, n):
    """A seeded Postnet (random BatchNorm statistics) and the JAX function's
    arguments for the same weights."""
    net = Postnet(PostnetConfig(odim=C0, n_layers=n, n_chans=C, n_filts=k), device="cpu")
    ws, bn = [], []
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
            bn.append((layer.bn.running_mean.numpy(),
                       torch.rsqrt(layer.bn.running_var + 1e-5).numpy(),
                       layer.bn.weight.numpy(), layer.bn.bias.numpy()))
    return net, ws, [list(r) for r in zip(*bn)]


# each shape in one tier (the Pallas function's compile per tier dominates)
POSTNET_CASES = [("bf16", 100, 20, 11, 1), ("f32", 12, 24, 5, 10)]


@pytest.mark.parametrize("tier,C0,C,k,n", POSTNET_CASES,
                         ids=[f"{t}-C0{c0}-C{c}-k{k}-n{n}" for t, c0, c, k, n in POSTNET_CASES])
def test_postnet_new_widths_match_pallas(tier, C0, C, k, n, rng):
    """Kernel 4 with one layer of k = 11 on 100 mels (C0 -> C0, no tanh;
    not a multiple of 8; bf16) and ten layers of k = 5 at C = 24 on 12 mels
    (a halo of 20 rows a side; f32), through the packed weights (BatchNorm rows
    padded to 8 columns): rows past len + halo give the last stage's BN of
    a zero input, as in the Pallas function's dead blocks."""
    B, L = 3, 48
    net, ws, (means, invs, gs, bs) = _postnet_case(rng, C0, C, k, n)
    x = rng.normal(size=(B, L, C0)).astype(np.float32)
    lengths = np.asarray([48, 21, 1], np.int32)
    jd, td = JAX_DT[tier], TORCH_DT[tier]
    want = np.asarray(fused_postnet(
        jnp.asarray(x), [jnp.asarray(w, jd) for w in ws], [jnp.asarray(m) for m in means],
        [jnp.asarray(v) for v in invs], [jnp.asarray(v) for v in gs],
        [jnp.asarray(v) for v in bs], jnp.asarray(lengths), cd=jd, interpret=True,
        block_t=8))
    w_flat, bn, hidden = KP.pack_weights(net.layers, td)
    assert bn.shape == (n, 4, KP.bn_width(C0, hidden))
    got = KP.postnet(_t(x), w_flat, bn, torch.from_numpy(lengths), n, hidden, k)
    if tier == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        d = np.abs(got.numpy() - want)
        assert d.mean() < 2e-3 and d.max() < 3e-2, (d.mean(), d.max())
    halo = n * (k - 1) // 2
    np.testing.assert_allclose(got.numpy()[2, 1 + halo:], want[2, 1 + halo:], rtol=1e-6,
                               atol=1e-6)


def test_padded_packs_give_the_unpadded_results(rng):
    """The plain versions on the kernels' padded packs equal them on the
    weights at their own widths, bit for bit: kernel 3 at D = 36 (w1's taps
    and the embeddings padded to 40 columns, ``pack_weights`` of a model's
    predictors too) and kernel 4 at C = 20, C0 = 3 (BatchNorm rows padded to
    24 columns)."""
    from fastspeech2_tpu_torch.models.predictors import Predictor, PredictorConfig

    B, T, C, L, nb, D = 3, 10, 32, 32, 64, 36
    hs, idx, out_lens, p, bins = _adaptor_inputs(rng, B, T, D, C, L, nb)
    w = _adaptor_port_args(p, C, D, torch.bfloat16)
    emb_w, emb_b = _t(p["emb_w"]).to(torch.bfloat16), _t(p["emb_b"])
    args = (_t(hs), torch.from_numpy(idx), torch.from_numpy(out_lens))
    want = KAd.variance_adaptor_plain(*args, *w, _t(bins), emb_w, emb_b)
    w1p, emb_wp, emb_bp = KAd.pad_weights(w[0], emb_w, emb_b, D)
    assert torch.all(w1p.reshape(2, C, 3, 40)[..., D:] == 0) and torch.all(emb_wp[..., D:] == 0)
    got = KAd.variance_adaptor_plain(*args, w1p, *w[1:], _t(bins), emb_wp, emb_bp)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a model's pack is at the padded width, and gives the same function
    torch.manual_seed(0)
    preds = [Predictor(PredictorConfig(idim=D, n_chans=C), device="cpu") for _ in range(2)]
    embs = [torch.nn.Linear(nb, D) for _ in range(2)]
    pack = KAd.pack_weights(*preds, *embs, torch.from_numpy(bins[0, :-1]),
                            torch.from_numpy(bins[1, :-1]), torch.bfloat16)
    assert pack[0].shape == (2, C, 120) and pack[11].shape == (2, nb, 40)
    real = (pack[0].reshape(2, C, 3, 40)[..., :D].reshape(2, C, 3 * D), *pack[1:11],
            pack[11][..., :D], pack[12][..., :D])
    assert all(torch.equal(a, b) for a, b in zip(KAd.variance_adaptor_plain(*args, *pack),
                                                  KAd.variance_adaptor_plain(*args, *real)))

    net, _, _ = _postnet_case(rng, 3, 20, 5, 3)
    w_flat, bn, hidden = KP.pack_weights(net.layers, torch.bfloat16)
    assert bn.shape == (3, 4, 24) and torch.all(bn[..., 20:] == 0)
    x, lens = torch.randn(2, 40, 3), torch.tensor([40, 17], dtype=torch.int32)
    assert torch.equal(KP.postnet_plain(x, w_flat, bn, lens, 3, hidden, 5),
                       KP.postnet_plain(x, w_flat, bn[..., :20].contiguous(), lens, 3, hidden, 5))


def test_conv_plans_over_the_new_ranges():
    """ops/kernels/adaptor.py:plan and postnet.py:plan (the tilings the C
    sides pick the same way; the card test holds them together) over their
    whole ranges, sampled: each fits a block's shared memory. The adaptor
    keeps its whole x tile (D rounded up to 16) wherever one ring stage fits
    beside it and H1, else holds it in chunks of 512 columns that cover D;
    at most 4,096 bin edges sit in shared memory. The postnet runs a chain
    where C <= 512, C0 <= 256 and two ring stages fit beside its buffer,
    else one launch a stage; the launches cover the stages in order; the
    planes between them are two at most, launch l reading plane (l - 1) % 2
    and writing plane l % 2, never the one it reads. Shapes past the bounds
    raise ValueError naming them."""
    for D in list(range(1, 2049, 3)) + [2048, 1152, 1153]:
        for nb in (1, 256, 4096, 4097, 65536):
            pl = KAd.plan(D, nb)
            misc = KAd.misc_bytes(min(nb, KAd.BIN_CHUNK)) + KAd.TILE_ROWS * KAd.CHANNELS * 2
            assert pl.smem <= SMEM_MAX and pl.kt in (64, 128) and 1 <= pl.st <= 4
            tile = pl.kt // 64 * KAd.RING_SUB
            if pl.xc >= D:
                assert pl.xc == -(-D // 16) * 16
                assert pl.st >= (2 if pl.kt == 128 else 1)
            else:
                assert pl.xc == KAd.X_CHUNK and pl.kt == 64
                # chunks only where the whole x tile leaves no room for one stage
                assert KAd.TILE_ROWS * (-(-D // 16) * 16) * 2 + misc + SLACK + tile > SMEM_MAX
                assert -(-D // pl.xc) * pl.xc >= D
            assert pl.smem == KAd.TILE_ROWS * pl.xc * 2 + misc + SLACK + pl.st * tile
    for D, nb in ((0, 256), (2049, 256), (2056, 256), (256, 0), (256, 65537)):
        with pytest.raises(ValueError, match="D from 1 to 2048, 1 to 65536 bin edges"):
            KAd.plan(D, nb)

    B, L = 2, 100
    kinds = set()
    for C in (1, 3, 20, 100, 255, 256, 257, 300, 500, 512, 513, 768, 1000, 1024):
        for C0 in (1, 3, 12, 80, 100, 256, 257, 513, 1024):
            for k in (1, 3, 5, 11, 21, 31):
                for n in (1, 2, 3, 5, 10, 12, 32):
                    pl = KP.plan(C0, C, k, n)
                    cp, c0p = -(-C // 16) * 16, -(-C0 // 16) * 16
                    assert pl.smem <= SMEM_MAX and 2 <= pl.st <= 4
                    if pl.wr == 0:
                        R = (128 + k - 1) | 1
                        assert pl.nh == pl.nl == KP.WIDE_N and pl.spl == 1
                        assert pl.smem == (KP.WIDE_XC * R * 2 + 16 * KP.WIDE_N
                                           + pl.st * 2 * KP.WIDE_N * 128 + SLACK)
                        if cp <= 512 and c0p <= 256:
                            # a chain would fit, but not two ring stages beside its buffer
                            m = 128 if cp <= 256 else 64
                            nh = 128 if cp <= 128 else 256
                            nl = 80 if c0p <= 80 else 128 if c0p <= 128 else 256
                            sb = 2 * (max(nh, nl) if m == 128 else 256) * 128
                            buf = max(cp, c0p) * ((m + k - 1) | 1) * 2 + 16 * max(C, C0)
                            assert buf + 2 * sb + SLACK > SMEM_MAX, (C0, C, k)
                    else:
                        assert cp <= 512 and c0p <= 256 and pl.wr == (2 if cp <= 256 else 1)
                        m = 64 * pl.wr
                        for r in KP.launch_stages(pl, n):
                            assert 2 * (m - (len(r) - 1) * (k - 1)) >= m
                    kinds.add(pl.wr)
                    parts = KP.launch_stages(pl, n)
                    assert [i for r in parts for i in r] == list(range(n))
                    planes = min(2, len(parts) - 1)
                    assert KP.scratch_elems(B, L, C, len(parts)) == B * L * cp * planes
                    for li in range(1, len(parts) - 1):  # reads (li - 1) % 2, writes li % 2
                        assert (li - 1) % 2 != li % 2 and li % 2 < planes
    assert kinds == {0, 1, 2}
    for C0, C, k, n in ((80, 1025, 5, 5), (1025, 256, 5, 5), (80, 256, 33, 5),
                        (80, 256, 4, 5), (80, 256, 5, 0), (80, 256, 5, 33), (0, 256, 5, 5)):
        with pytest.raises(ValueError, match="C and C0 from 1 to 1024"):
            KP.plan(C0, C, k, n)
