"""Training-mode ops of the port against the JAX package on the CPU.

- the counter-hash dropout masks (``_hash_mix``, ``_hash_keep_mask`` and the
  training attention kernels' ``_keep_mask``): bit for bit, for several
  shapes, seeds near 2^31 and 2^32, rates 0.1 / 0.2 / 0.5;
- kernels 11 and 12: the plain version (what the CPU runs and what the CUDA
  kernels are held to on the card) against the Pallas kernels in interpret
  mode: output and dQ, dK, dV for a given dO. f32: 1e-5. bf16: inside the JAX
  package's own bf16-vs-f32 gap on the same inputs;
- ``mha_fused_train_apply`` (projections + kernel + out projection), d_k=128;
- ``nn.dropout`` / ``nn.batch_norm_train`` / the initialisers.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_tpu.ops import nn as jnn
from fastspeech2_tpu.ops.attention import init_mha
from fastspeech2_tpu.ops.pallas import attention_train as jat
from fastspeech2_tpu.ops.precision import compute_dtype as jcompute_dtype
from fastspeech2_tpu_torch.models.encoder import MultiHeadAttention
from fastspeech2_tpu_torch.ops import flags as tflags
from fastspeech2_tpu_torch.ops import nn as tnn_ops
from fastspeech2_tpu_torch.ops.kernels import attention_train as tat
from fastspeech2_tpu_torch.ops.precision import compute_dtype as tcompute_dtype
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

SEEDS = [0, 1, 12345, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 7, 2 ** 32 - 1]


def _u32(x):
    return jnp.asarray(np.uint32(x))


def test_hash_mix_matches_jax_bit_for_bit():
    g = np.random.default_rng(0)
    x = np.concatenate([g.integers(0, 2 ** 32, 4096, dtype=np.uint64),
                        [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    want = np.asarray(jnn._hash_mix(jnp.asarray(x)))
    got = tnn_ops._hash_mix(torch.from_numpy(x.astype(np.int64))).numpy()
    assert got.min() >= 0 and got.max() < 2 ** 32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("shape", [(7,), (3, 16, 5), (2, 2, 24, 24), (4, 48, 64)])
@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_hash_keep_mask_matches_jax_bit_for_bit(shape, rate):
    for seed in SEEDS:
        want = np.asarray(jnn._hash_keep_mask(_u32(seed), shape, rate))
        got = tnn_ops._hash_keep_mask(seed, shape, rate).numpy()
        np.testing.assert_array_equal(got, want)
    # a mask depends on the padded shape, as in the JAX package
    a = tnn_ops._hash_keep_mask(5, (2, 8, 4), 0.5).numpy()
    b = tnn_ops._hash_keep_mask(5, (2, 10, 4), 0.5).numpy()
    assert not np.array_equal(a[:, :8], b[:, :8])
    if got.size >= 1000:
        assert abs(got.mean() - (1 - rate)) < 0.05


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_attention_keep_mask_matches_jax_bit_for_bit(rate):
    B, H, T = 3, 2, 40
    for seed in SEEDS:
        # the JAX package holds the seed as int32 and casts it to uint32
        jseed = jnp.asarray(np.uint32(seed).astype(np.int32))
        want = np.stack([np.stack([np.asarray(jat._keep_mask(
            jseed, jnp.uint32(b), jnp.uint32(h), (T, T), rate))
            for h in range(H)]) for b in range(B)])
        got = tat._keep_mask(seed, B, H, T, rate, "cpu").numpy()
        np.testing.assert_array_equal(got, want)


def _inputs(seed, B, T, H, dk):
    g = np.random.default_rng(seed)
    q, k, v, do = (g.normal(size=(B, H, T, dk)).astype(np.float32) for _ in range(4))
    return q, k, v, do


def _pack(a):  # (B, H, T, dk) -> (B, T, H*dk)
    B, H, T, dk = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3)).reshape(B, T, H * dk)


def _jax_run(q, k, v, do, lens, seed, rate, packed, dtype):
    H = q.shape[1]
    if packed:
        q, k, v, do = (_pack(a) for a in (q, k, v, do))
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in (q, k, v, do))
    jl, js = jnp.asarray(lens, jnp.int32), jnp.asarray([seed], jnp.int32)
    if packed:
        fn = lambda a, b, c: jat.fused_attention_train_packed(  # noqa: E731
            a, b, c, jl, js, H, rate, True)
    else:
        fn = lambda a, b, c: jat.fused_attention_train(  # noqa: E731
            a, b, c, jl, js, rate, True)
    o, vjp = jax.vjp(fn, jq, jk, jv)
    return [np.asarray(t.astype(jnp.float32)) for t in (o, *vjp(jdo))]


def _torch_run(q, k, v, do, lens, seed, rate, packed, dtype):
    H = q.shape[1]
    if packed:
        q, k, v, do = (_pack(a) for a in (q, k, v, do))
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v))
    tl = torch.from_numpy(np.asarray(lens, np.int32))
    if packed:
        o = tat.fused_attention_train_packed(tq, tk, tv, tl, seed, H, rate)
    else:
        o = tat.fused_attention_train(tq, tk, tv, tl, seed, rate)
    assert o.dtype == dtype
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do).to(dtype))
    return [t.detach().float().numpy() for t in (o, *grads)]


@pytest.mark.parametrize("packed", [True, False], ids=["kernel11_packed", "kernel12"])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_attention_train_plain_matches_pallas_f32(packed, rate):
    """f32: the plain version equals the interpret-mode Pallas kernel to
    1e-5 in output and in dQ, dK, dV; padded rows are exact zeros."""
    B, T, H, dk = 2, 48, 2, 16
    lens, seed = [48, 29], 2 ** 31 - 5
    q, k, v, do = _inputs(3, B, T, H, dk)
    want = _jax_run(q, k, v, do, lens, seed, rate, packed, jnp.float32)
    got = _torch_run(q, k, v, do, lens, seed, rate, packed, torch.float32)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
        pad = g[1, 29:] if packed else g[1, :, 29:]
        assert np.all(pad == 0.0), f"{name}: padded rows not exactly zero"


@pytest.mark.parametrize("packed", [True, False], ids=["kernel11_packed", "kernel12"])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_attention_train_plain_matches_pallas_bf16(packed, rate):
    """bf16: the plain version stays inside the JAX package's own
    bf16-vs-f32 gap on the same inputs (max abs difference of each of o, dQ,
    dK, dV), and padded rows are exact zeros."""
    B, T, H, dk = 2, 48, 2, 16
    lens, seed = [48, 29], 77
    q, k, v, do = _inputs(4, B, T, H, dk)
    # both dtypes see the same bf16-representable inputs
    q, k, v, do = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                   for a in (q, k, v, do))
    j32 = _jax_run(q, k, v, do, lens, seed, rate, packed, jnp.float32)
    j16 = _jax_run(q, k, v, do, lens, seed, rate, packed, jnp.bfloat16)
    got = _torch_run(q, k, v, do, lens, seed, rate, packed, torch.bfloat16)
    for name, g, w16, w32 in zip(("o", "dq", "dk", "dv"), got, j16, j32):
        gap = np.abs(w16 - w32).max()
        assert np.abs(g - w16).max() <= gap, (name, np.abs(g - w16).max(), gap)
        pad = g[1, 29:] if packed else g[1, :, 29:]
        assert np.all(pad == 0.0), f"{name}: padded rows not exactly zero"


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_attention_train_packed_equals_unpacked(rate):
    """Both layouts draw the same mask from (seed, b, h): packed and
    (B, H, T, dk) agree exactly in output and gradients."""
    B, T, H, dk = 2, 32, 2, 8
    q, k, v, do = _inputs(5, B, T, H, dk)
    a = _torch_run(q, k, v, do, [32, 11], 991, rate, True, torch.float32)
    b = _torch_run(q, k, v, do, [32, 11], 991, rate, False, torch.float32)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, _pack(y), rtol=0, atol=1e-6)


def test_attention_train_needs_all_three_grads_and_bf16_on_cuda():
    """What the wrapper refuses is written down in code the CPU can reach:
    the CUDA entry checks dtype (bf16 or f32) and head dim before it builds
    anything."""
    q = torch.zeros(1, 8, 256)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tat._check("t", q.half(), q.half(), q.half(), torch.zeros(1, dtype=torch.int32),
                   1, 128)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="head dim"):  # d_k 1032: past 1024
        tat._check("t", qb, qb, qb, torch.zeros(1, dtype=torch.int32), 1, 1032)


@pytest.mark.parametrize("dk,ok", [(64, True), (128, True), (192, True), (256, True),
                                   (320, True), (384, True), (132, True), (1032, False)])
def test_attention_train_head_dims(dk, ok):
    """The CUDA entry takes every head dim its tiling plans (1 to 1024: 132
    runs zero-padded to 136; the JAX encoder routes every d_k >= 128 to
    these kernels) and refuses the others before it builds anything."""
    q = torch.zeros(1, 8, dk, dtype=torch.bfloat16)
    lens = torch.zeros(1, dtype=torch.int32)
    if ok:
        tat._check("t", q, q, q, lens, 1, dk)
    else:
        with pytest.raises(ValueError, match="head dim"):
            tat._check("t", q, q, q, lens, 1, dk)


@pytest.mark.parametrize("packed_flag", [True, False], ids=["packed", "unpacked"])
def test_mha_fused_train_apply_matches_jax(monkeypatch, packed_flag):
    """Projections + kernel + out projection at d_k=128, bf16 tier, rate 0.2:
    the JAX route with the Pallas kernel in interpret mode against the port's
    route through the plain version, fed the seed the JAX route draws. Band:
    2 bf16 ulps of the output's peak (the projections round at other
    summation orders)."""
    from fastspeech2_tpu.ops import flags as jflags

    monkeypatch.setattr(jflags, "FUSED_ATT_TRAIN_PACKED", packed_flag)
    monkeypatch.setattr(tflags, "FUSED_ATT_TRAIN_PACKED", packed_flag)
    B, T, D, H, rate = 2, 24, 256, 2, 0.2
    params = init_mha(jax.random.PRNGKey(1), D)
    g = np.random.default_rng(6)
    x = g.normal(size=(B, T, D)).astype(np.float32)
    lens = np.asarray([24, 9], np.int32)
    key = jax.random.PRNGKey(42)
    with jcompute_dtype(jnp.bfloat16):
        want = np.asarray(jat.mha_fused_train_apply(
            params, jnp.asarray(x), jnp.asarray(lens), H, key, rate, interpret=True))
    seed = int(jax.random.randint(key, (1,), 0, np.iinfo(np.int32).max,
                                  dtype=jnp.int32)[0])
    attn = MultiHeadAttention(D, device="cpu")
    with torch.no_grad():
        for name in ("q", "k", "v", "out"):
            lin = getattr(attn, name)
            lin.weight.copy_(torch.from_numpy(np.asarray(params[name]["w"]).T.copy()))
            lin.bias.copy_(torch.from_numpy(np.asarray(params[name]["b"])))
    with tcompute_dtype(torch.bfloat16):
        got = tat.mha_fused_train_apply(attn, torch.from_numpy(x),
                                        torch.from_numpy(lens), H, seed, rate)
    assert got.dtype == torch.float32
    d = np.abs(got.detach().numpy() - want)
    assert d.max() < 2 * 2.0 ** -8 * np.abs(want).max(), d.max()


def test_dropout_tiers():
    """bf16 tier: the hash mask with the JAX package's seed, exactly. f32
    tier: the port draws from its own generator: identity at rate 0, the keep
    share and the 1/(1-rate) scale statistically, the same mask for the same
    seed (what a checkpointed block's replay needs)."""
    x = np.random.default_rng(0).normal(size=(4, 24, 16)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    seed = int(jnn._key_to_seed(key))
    with jcompute_dtype(jnp.bfloat16):
        want = np.asarray(jnn.dropout(key, jnp.asarray(x), 0.2, deterministic=False))
    with tcompute_dtype(torch.bfloat16):
        got = tnn_ops.dropout(torch.from_numpy(x), 0.2, seed, deterministic=False)
    np.testing.assert_array_equal(got.numpy(), want)

    t = torch.ones(64, 256)
    assert tnn_ops.dropout(t, 0.0, 3, deterministic=False) is t
    assert tnn_ops.dropout(t, 0.5, None, deterministic=True) is t
    a = tnn_ops.dropout(t, 0.5, 3, deterministic=False)
    b = tnn_ops.dropout(t, 0.5, 3, deterministic=False)
    c = tnn_ops.dropout(t, 0.5, 4, deterministic=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert abs(float((a > 0).float().mean()) - 0.5) < 0.02
    with pytest.raises(ValueError):
        tnn_ops.dropout(t, 0.5, None, deterministic=False)


def test_batch_norm_train_matches_jax():
    g = np.random.default_rng(1)
    x = g.normal(1.0, 2.0, size=(3, 10, 6)).astype(np.float32)
    gam, bet = g.normal(size=6).astype(np.float32), g.normal(size=6).astype(np.float32)
    mean, var = g.normal(size=6).astype(np.float32), g.uniform(0.5, 2, 6).astype(np.float32)
    y, st = jnn.batch_norm({"g": jnp.asarray(gam), "b": jnp.asarray(bet)},
                           {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
                           jnp.asarray(x), training=True)
    rm, rv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    ty = tnn_ops.batch_norm_train(torch.from_numpy(x), rm, rv, torch.from_numpy(gam),
                                  torch.from_numpy(bet))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rm.numpy(), np.asarray(st["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rv.numpy(), np.asarray(st["var"]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("init_type", ["pytorch", "xavier_uniform", "xavier_normal",
                                       "kaiming_uniform", "kaiming_normal"])
def test_initialisers_moments_and_quirks(init_type):
    """The draws cannot equal JAX's; the distributions and the quirks do:
    bounds / standard deviations of the variants from the torch-layout fans,
    Embedding N(0, 1) with a zero padding row, LayerNorm (1, 0), biases zero
    under the variants, the BatchNorm-zero quirk, alphas untouched, and the
    same weights for the same generator seed."""
    from fastspeech2_tpu_torch.config import Config, ModelConfig
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2

    cfg = Config(model=ModelConfig(
        adim=64, aheads=2, elayers=1, eunits=128, ddim=64, dlayers=1, dunits=128,
        postnet_layers=2, postnet_chans=32, transformer_init=init_type,
        initial_encoder_alpha=0.7))
    m = FastSpeech2(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    m2 = FastSpeech2(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    for (n, a), (_, b) in zip(m.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n
    assert float(m.encoder.alpha) == pytest.approx(0.7)
    emb = m.encoder.embed.weight
    assert torch.all(emb[0] == 0) and abs(float(emb[1:].std()) - 1.0) < 0.1
    ln = m.encoder.layers[0].norm1
    assert torch.all(ln.weight == 1) and torch.all(ln.bias == 0)
    w = m.encoder.layers[0].ffn.w1.weight          # (128, 64, 9)
    fan_in, fan_out = 64 * 9, 128 * 9
    bn = m.postnet.layers[0].bn
    if init_type == "pytorch":
        bound = 1 / math.sqrt(fan_in)
        assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.95 * bound
        b = m.encoder.layers[0].ffn.w1.bias
        assert 0 < float(b.abs().max()) <= bound
        assert torch.all(bn.weight == 1) and torch.all(bn.bias == 0)
        return
    assert torch.all(m.encoder.layers[0].ffn.w1.bias == 0)
    assert torch.all(bn.weight == 0) and torch.all(bn.bias == 0)  # the quirk
    if init_type.endswith("uniform"):
        bound = (math.sqrt(6 / (fan_in + fan_out)) if init_type.startswith("xavier")
                 else math.sqrt(2) * math.sqrt(3 / fan_in))
        assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.95 * bound
        assert abs(float(w.std()) - bound / math.sqrt(3)) < 0.05 * bound
    else:
        std = (math.sqrt(2 / (fan_in + fan_out)) if init_type.startswith("xavier")
               else math.sqrt(2) / math.sqrt(fan_in))
        assert abs(float(w.std()) - std) < 0.05 * std
