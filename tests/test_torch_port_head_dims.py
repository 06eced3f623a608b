"""Every head dim of the seven attention kernels (1, 5, 6, 7, 8, 11, 12)
against the JAX package on the CPU.

The port's attention kernels take any d_k that is a multiple of 8 from 8 to
1024 (``ops/kernels/attention_train.py:plan``): up to 256 padded to a
multiple of 64 (at least 128), above that in column parts. The JAX encoder
routes every bf16 block with d_k >= 128 to its Pallas kernels, which assert
only ``D % n_heads == 0``.

Kernel level: each wrapper's plain version (what a CPU tensor takes) against
the Pallas function called with ``interpret=True`` at d_k 136 (two heads: a
column past d_k belongs to the next head) and 384 (one head: two column
parts on the card), B=3, T=32, ``block_q=8``, lengths (32, 13, 1); kernels
11 and 12 at rate 0.2 with a fixed seed, forward and the three gradients.
f32: 1e-5. bf16: both sides round at the same points, so the band of
``tests/test_torch_port_kernels.py`` (mean 2e-3, max 5e-2) for 1, 5, 6, 7
and 8, and for 11 and 12 the JAX package's own bf16-vs-f32 gap on the same
inputs (``tests/test_torch_port_train_ops.py``).

Plan level: ``plan`` covers every multiple of 8 in 8..1024 for every mode
(both layouts share it) within the H100's 232,448 bytes of shared memory a
block and 256 accumulator columns a warpgroup, and the wrappers' checks
take d_k 132 (not a multiple of 8: zero-padded to 136) and refuse
1032.

Slice level: a one-head bf16 model (``small_cfg``'s depth, adim 136, ddim
384: encoder d_k 136, decoder d_k 384) loaded from the JAX parameters with
``load_jax_params``; its mel, fed the JAX durations, against the JAX model's
with the Pallas kernels in interpret mode, in the band of
``tests/test_torch_port_prenorm.py`` (mean < 0.02, max < 0.2).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_head_dims.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_tpu.config import Config, ModelConfig
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JFS
from fastspeech2_tpu.ops.pallas import adaptor as jadaptor
from fastspeech2_tpu.ops.pallas import attention as jattn
from fastspeech2_tpu.ops.pallas import attention_train as jat
from fastspeech2_tpu.ops.pallas import ffn as jffn
from fastspeech2_tpu.ops.pallas import postnet as jpostnet
from fastspeech2_tpu.ops.precision import compute_dtype as jcompute_dtype
from fastspeech2_tpu_torch.compat.from_jax import load_jax_params
from fastspeech2_tpu_torch.config import config_from_dict
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2 as TFS
from fastspeech2_tpu_torch.ops.kernels import attention as KA
from fastspeech2_tpu_torch.ops.kernels import attention_train as KT
from fastspeech2_tpu_torch.ops.precision import compute_dtype as tcompute_dtype
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
B, T = 3, 32
LENGTHS = np.asarray([32, 13, 1], np.int32)
#: (d_k, heads): 136 at two heads, 384 at one
HEAD_DIMS = [(136, 2), (384, 1)]
CASES = [(tier, dk, h) for dk, h in HEAD_DIMS for tier in ("f32", "bf16")]
IDS = [f"{tier}-dk{dk}" for tier, dk, _ in CASES]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, tier):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if tier == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        d = np.abs(got - want)
        assert d.mean() < 2e-3 and d.max() < 5e-2, (d.mean(), d.max())


def _dead_rows(got, want):
    """Rows at or past each length: the JAX kernel's constants to 1e-5."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    for b, n in enumerate(LENGTHS):
        np.testing.assert_allclose(got[b, n:], want[b, n:], rtol=1e-5, atol=1e-5)


def _weights(rng, D):
    """Projection and LayerNorm weights; w in the JAX (in, out) layout."""
    w = [(rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32) for _ in range(4)]
    bqkv = (rng.normal(size=(3, D)) * 0.1).astype(np.float32)
    bo = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    g = (rng.normal(size=(D,)) * 0.2 + 1.0).astype(np.float32)
    be = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    return w, bqkv, bo, g, be


def _qkv(rng, shape, tier):
    """q/k/v as values of the tier's dtype, on both sides."""
    vals = [jnp.asarray(rng.normal(size=shape).astype(np.float32), JAX_DT[tier])
            for _ in range(3)]
    return vals, [_t(np.asarray(v, np.float32), TORCH_DT[tier]) for v in vals]


@pytest.mark.parametrize("tier,dk,nh", CASES, ids=IDS)
def test_attention_block_matches_pallas(tier, dk, nh):
    """Kernel 1: LN(x + MHA(x Wqkv + bqkv) Wo + bo); rows at or past the
    length give the JAX kernel's LN(x + bo)."""
    rng = np.random.default_rng(dk + nh)
    D = dk * nh
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    w, bqkv, bo, g, be = _weights(rng, D)
    jd, td = JAX_DT[tier], TORCH_DT[tier]
    want = jattn.fused_attention_packed_qkv_res_ln(
        jnp.asarray(x), *(jnp.asarray(wi, jd) for wi in w[:3]), jnp.asarray(bqkv),
        jnp.asarray(w[3], jd), jnp.asarray(bo[None]), jnp.asarray(g), jnp.asarray(be),
        jnp.asarray(LENGTHS), nh, interpret=True, block_q=8)
    wqkv = torch.cat([_t(np.asarray(jnp.asarray(wi, jd), np.float32).T) for wi in w[:3]])
    got = KA.attention_block(_t(x), wqkv.to(td), _t(bqkv.reshape(-1)),
                             _t(np.asarray(jnp.asarray(w[3], jd), np.float32).T).to(td),
                             _t(bo), _t(g), _t(be), torch.from_numpy(LENGTHS), nh)
    assert got.dtype == torch.float32 and got.shape == (B, T, D)
    _close(got, want, tier)
    _dead_rows(got, want)


@pytest.mark.parametrize("tier,dk,nh", CASES, ids=IDS)
def test_attention_res_ln_matches_pallas(tier, dk, nh):
    """Kernel 5: LN(res + MHA(q, k, v) Wo + bo), q/k/v given."""
    rng = np.random.default_rng(2 * dk + nh)
    D = dk * nh
    (jq, jk, jv), (q, k, v) = _qkv(rng, (B, T, D), tier)
    res = rng.normal(size=(B, T, D)).astype(np.float32)
    w, _, bo, g, be = _weights(rng, D)
    jwo = jnp.asarray(w[3], JAX_DT[tier])
    want = jattn.fused_attention_packed_res_ln(
        jq, jk, jv, jnp.asarray(res), jwo, jnp.asarray(bo[None]), jnp.asarray(g),
        jnp.asarray(be), jnp.asarray(LENGTHS), nh, interpret=True, block_q=8)
    got = KA.attention_res_ln(q, k, v, _t(res), _t(np.asarray(jwo, np.float32).T,
                                                    TORCH_DT[tier]),
                              _t(bo), _t(g), _t(be), torch.from_numpy(LENGTHS), nh)
    _close(got, want, tier)
    _dead_rows(got, want)


@pytest.mark.parametrize("tier,dk,nh", CASES, ids=IDS)
def test_attention_res_matches_pallas(tier, dk, nh):
    """Kernel 6: res + MHA(q, k, v) Wo + bo (pre-LN, no LayerNorm); rows at
    or past the length give res + bo."""
    rng = np.random.default_rng(3 * dk + nh)
    D = dk * nh
    (jq, jk, jv), (q, k, v) = _qkv(rng, (B, T, D), tier)
    res = rng.normal(size=(B, T, D)).astype(np.float32)
    w, _, bo, _, _ = _weights(rng, D)
    jwo = jnp.asarray(w[3], JAX_DT[tier])
    want = jattn.fused_attention_packed_res(
        jq, jk, jv, jnp.asarray(res), jwo, jnp.asarray(bo[None]), jnp.asarray(LENGTHS), nh,
        interpret=True, block_q=8)
    got = KA.attention_res(q, k, v, _t(res), _t(np.asarray(jwo, np.float32).T, TORCH_DT[tier]),
                           _t(bo), torch.from_numpy(LENGTHS), nh)
    _close(got, want, tier)
    _dead_rows(got, want)


@pytest.mark.parametrize("tier,dk,nh", CASES, ids=IDS)
def test_fused_attention_packed_matches_pallas(tier, dk, nh):
    """Kernel 7: bare masked attention, heads packed along D, out in q's
    dtype; rows at or past the length are zeros."""
    rng = np.random.default_rng(4 * dk + nh)
    D = dk * nh
    (jq, jk, jv), (q, k, v) = _qkv(rng, (B, T, D), tier)
    want = jattn.fused_attention_packed(jq, jk, jv, jnp.asarray(LENGTHS), nh,
                                        interpret=True, block_q=8)
    got = KA.fused_attention_packed(q, k, v, torch.from_numpy(LENGTHS), nh)
    assert got.dtype == TORCH_DT[tier] and got.shape == (B, T, D)
    _close(got.float(), want, tier)
    for b, n in enumerate(LENGTHS):
        assert not got[b, n:].any()


@pytest.mark.parametrize("tier,dk,nh", CASES, ids=IDS)
def test_fused_attention_matches_pallas(tier, dk, nh):
    """Kernel 8: the same function in the (B, H, T, dk) layout."""
    rng = np.random.default_rng(5 * dk + nh)
    (jq, jk, jv), (q, k, v) = _qkv(rng, (B, nh, T, dk), tier)
    want = jattn.fused_attention(jq, jk, jv, jnp.asarray(LENGTHS), interpret=True, block_q=8)
    got = KA.fused_attention(q, k, v, torch.from_numpy(LENGTHS))
    assert got.dtype == TORCH_DT[tier] and got.shape == (B, nh, T, dk)
    _close(got.float(), want, tier)
    for b, n in enumerate(LENGTHS):
        assert not got[b, :, n:].any()


def _pack(a):  # (B, H, T, dk) -> (B, T, H * dk)
    b, h, t, d = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3)).reshape(b, t, h * d)


def _train_jax(arrays, seed, rate, packed, nh, dtype):
    q, k, v, do = ((_pack(a) if packed else a) for a in arrays)
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in (q, k, v, do))
    # the JAX package holds the seed as int32 and casts it to uint32
    jl, js = jnp.asarray(LENGTHS), jnp.asarray([np.uint32(seed).astype(np.int32)])
    if packed:
        fn = lambda a, b, c: jat.fused_attention_train_packed(  # noqa: E731
            a, b, c, jl, js, nh, rate, True)
    else:
        fn = lambda a, b, c: jat.fused_attention_train(a, b, c, jl, js, rate, True)  # noqa: E731
    o, vjp = jax.vjp(fn, jq, jk, jv)
    return [np.asarray(t.astype(jnp.float32)) for t in (o, *vjp(jdo))]


def _train_torch(arrays, seed, rate, packed, nh, dtype):
    q, k, v, do = ((_pack(a) if packed else a) for a in arrays)
    tq, tk, tv = (torch.tensor(a).to(dtype).requires_grad_() for a in (q, k, v))
    lens = torch.from_numpy(LENGTHS)
    if packed:
        o = KT.fused_attention_train_packed(tq, tk, tv, lens, seed, nh, rate)
    else:
        o = KT.fused_attention_train(tq, tk, tv, lens, seed, rate)
    assert o.dtype == dtype
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.tensor(do).to(dtype))
    return [t.detach().float().numpy() for t in (o, *grads)]


@pytest.mark.parametrize("packed", [True, False], ids=["kernel11_packed", "kernel12"])
@pytest.mark.parametrize("tier,dk,nh", CASES, ids=IDS)
def test_attention_train_matches_pallas(packed, tier, dk, nh):
    """Kernels 11 and 12 at rate 0.2, seed past 2^31 (the uint32 path):
    the output and dQ, dK, dV; padded rows exact zeros. f32 to 1e-5; bf16
    within the JAX package's own bf16-vs-f32 gap on the same inputs."""
    rng = np.random.default_rng(6 * dk + nh)
    rate, seed = 0.2, 2 ** 31 + 11
    arrays = [rng.normal(size=(B, nh, T, dk)).astype(np.float32) for _ in range(4)]
    if tier == "bf16":  # both dtypes see the same bf16 values
        arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    got = _train_torch(arrays, seed, rate, packed, nh, TORCH_DT[tier])
    want = _train_jax(arrays, seed, rate, packed, nh, JAX_DT[tier])
    gap = None
    if tier == "bf16":
        gap = _train_jax(arrays, seed, rate, packed, nh, jnp.float32)
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        g, w = got[i], want[i]
        if tier == "f32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            bound = np.abs(w - gap[i]).max()
            assert np.abs(g - w).max() <= bound, (name, np.abs(g - w).max(), bound)
        pad = g[2, 1:] if packed else g[2, :, 1:]
        assert np.all(pad == 0.0), f"{name}: padded rows not exactly zero"


@pytest.mark.parametrize("body", ["tile", "wide"])
@pytest.mark.parametrize("mode", ["serve", "train", "f32"])
def test_plan_covers_every_head_dim(mode, body):
    """Every multiple of 8 from 8 to 1024 has a tiling within the H100's
    232,448 bytes of shared memory a block and 256 accumulator columns a
    warpgroup: the tile bodies at d_k padded to a multiple of 64, at least
    128, up to 256, the wide bodies above; the parts cover d_k and none lies
    wholly past it; d_k 128, 192 and 256 keep the tile bodies at their own
    width."""
    dks = range(8, 257, 8) if body == "tile" else range(264, KT.MAX_HEAD_DIM + 1, 8)
    for dk in dks:
        p = KT.plan(dk, mode)
        assert p.dkp % 64 == 0 and max(dk, 128) <= p.dkp < max(dk, 128) + 64, (dk, p)
        assert 0 < max(p.smem.values()) <= KT.SMEM_LIMIT, (dk, p)
        assert p.part_width <= 256, (dk, p)
        assert p.parts * p.part_width >= dk and (p.parts - 1) * p.part_width < dk, (dk, p)
        assert p.wide == (body == "wide") == (p.dkp > 256)
        if not p.wide:
            assert p.parts == 1 and p.part_width == p.dkp
    if body == "tile":
        for dk in (128, 192, 256):
            assert KT.plan(dk, mode).dkp == dk
    else:
        assert KT.plan(384, "serve").parts == 2 and KT.plan(384, "serve").part_width == 192


@pytest.mark.parametrize("dk", [132, 1032])
def test_wrappers_refuse_head_dims_they_do_not_take(dk):
    """d_k 1032 (past 1024) is refused by the plan and by every wrapper's
    check, before anything is built; d_k 132 (not a multiple of 8) is taken
    by all of them: the kernels run it zero-padded to 136. The checks need
    no card."""
    if dk == 132:
        assert KT.plan(dk).dkp == 192
        KA.check_head_dim("t", dk)
        for heads in (1, 2):
            KA._check_heads("t", heads * dk, heads)
        for dt in (torch.bfloat16, torch.float32):
            q = torch.zeros(1, 8, dk, dtype=dt)
            KT._check("t", q, q, q, torch.zeros(1, dtype=torch.int32), 1, dk)
        return
    with pytest.raises(ValueError, match="head dim"):
        KT.plan(dk)
    with pytest.raises(ValueError, match="d_k"):
        KA.check_head_dim("t", dk)
    for heads in (1, 2):
        with pytest.raises(ValueError, match="d_k"):
            KA._check_heads("t", heads * dk, heads)
    for dt in (torch.bfloat16, torch.float32):
        q = torch.zeros(1, 8, dk, dtype=dt)
        with pytest.raises(ValueError, match="head dim"):
            KT._check("t", q, q, q, torch.zeros(1, dtype=torch.int32), 1, dk)


def _interpret(monkeypatch):
    """Every Pallas entry the JAX model's post-LN serving route reaches,
    called with interpret=True (the HLO interpreter) instead of on a TPU."""
    for mod, names in ((jattn, ("fused_attention_packed_qkv_res_ln",)),
                       (jffn, ("fused_ffn_block_post",)),
                       (jadaptor, ("fused_variance_adaptor",)),
                       (jpostnet, ("fused_postnet",))):
        for name in names:
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _r=real, **k: _r(*a, **{
                **k, "interpret": True}))


def test_one_head_model_matches_jax(monkeypatch):
    """A bf16 post-LN model with one head (adim 136, ddim 384: d_k 136 and
    384), ``small_cfg``'s depth, loaded from the JAX parameters: kernel 1's
    plain version in both blocks, the JAX model through its Pallas kernel;
    the encoder output and the mel fed the JAX durations in the band."""
    cfg = Config(model=ModelConfig(
        adim=136, aheads=1, elayers=1, eunits=64, ddim=384, dlayers=1, dunits=64,
        postnet_layers=2, postnet_chans=16, positionwise_conv_kernel_size=3,
        duration_predictor_chans=16, fused_attention="on"))
    _interpret(monkeypatch)
    jm = JFS(cfg)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(0))
    params["duration_predictor"]["out"]["b"] = params["duration_predictor"]["out"]["b"] + 1.5
    tm = TFS(config_from_dict(cfg.to_dict()), device="cpu")
    load_jax_params(tm, jax.device_get(params), jax.device_get(state))
    assert tm.encoder.layers[0].attn.q.weight.shape == (136, 136)
    assert tm.decoder.layers[0].attn.q.weight.shape == (384, 384)
    xs = np.random.default_rng(7).integers(1, 68, (3, 32)).astype(np.int32)
    ilens = np.asarray([32, 13, 1], np.int32)
    L = 64

    def enc(p, x, i):
        with jcompute_dtype(jnp.bfloat16):
            return jm.encode(p, x, i)

    def dec(p, s, h, d, i):
        with jcompute_dtype(jnp.bfloat16):
            return jm.decode_frames(p, s, h, d, i, out_maxlen=L)

    hj, dj = jax.jit(enc)(params, jnp.asarray(xs), jnp.asarray(ilens))
    mj, lj = jax.jit(dec)(params, state, hj, dj, jnp.asarray(ilens))

    calls = []
    real = KA.attention_block_plain
    monkeypatch.setattr(KA, "attention_block_plain",
                        lambda *a, **k: (calls.append(a[0].shape[-1]), real(*a, **k))[1])
    with torch.inference_mode(), tcompute_dtype(torch.bfloat16):
        ht, dt = tm.encode(torch.from_numpy(xs), torch.from_numpy(ilens))
        mt, lt = tm.decode_frames(ht, torch.from_numpy(np.array(dj)),
                                  torch.from_numpy(ilens), out_maxlen=L)
    assert calls == [136, 384], calls
    d = np.abs(ht.float().numpy() - np.asarray(hj, np.float32))
    assert d.mean() < 0.02 and d.max() < 0.2, ("encoder", d.mean(), d.max())
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert int(lt.min()) > 0
    d = np.abs(mt.float().numpy() - np.asarray(mj, np.float32))
    assert d.mean() < 0.02 and d.max() < 0.2, ("mel", d.mean(), d.max())
