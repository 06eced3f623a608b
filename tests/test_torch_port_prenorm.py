"""The pre-LN and bare kernels of the port (5 of them) and the model routes
that take them, against the JAX package on the CPU.

Kernel level: the plain versions of ``attention_res`` (kernel 6),
``fused_attention_packed`` (7), ``fused_attention`` (8), ``ffn_block_pre``
(9) and ``fused_ffn`` (10) against the JAX Pallas functions called with
``interpret=True`` (the HLO interpreter; no TPU interpret mode), on inputs
from numpy seeds with lengths 0, 1, partial and full at blocks of 8; 7 and 8
also at d_k 256 (the widest Hopper instantiation) with one and two heads. f32:
rtol/atol 1e-5 (the bar tests/test_pallas.py holds interpret kernels to);
bf16: both sides round at the same points, f32 sums in another order flip
an occasional bf16 rounding, so the band of tests/test_torch_port_kernels.py
(mean 2e-3, max 5e-2 at unit scale); the dead rows' constants to 1e-5 in
both tiers.

Model level: ``prenorm`` (pre-LN in both stacks), ``prenorm_concat`` (and
``concat_after``) and the post-LN model with ``FUSED_ATT_RES`` off, one block
per stack at D=256, 2 heads (d_k 128): the JAX model with its Pallas
kernels forced to ``interpret=True``, the port's encode/decode_frames fed the
JAX durations; band mean < 0.02, max < 0.2 (the JAX package's own
fused-vs-XLA gap, tests/test_pallas.py:538-539). Spies prove which plain
versions ran.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_tpu.config import Config, ModelConfig
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JFS
from fastspeech2_tpu.ops import flags as jflags
from fastspeech2_tpu.ops.pallas import adaptor as jadaptor
from fastspeech2_tpu.ops.pallas import attention as jattn
from fastspeech2_tpu.ops.pallas import ffn as jffn
from fastspeech2_tpu.ops.pallas import postnet as jpostnet
from fastspeech2_tpu.ops.precision import compute_dtype as jcompute_dtype
from fastspeech2_tpu_torch.compat.from_jax import load_jax_params
from fastspeech2_tpu_torch.config import config_from_dict
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2 as TFS
from fastspeech2_tpu_torch.ops import flags as tflags
from fastspeech2_tpu_torch.ops.kernels import attention as KA
from fastspeech2_tpu_torch.ops.kernels import ffn as KF
from fastspeech2_tpu_torch.ops.precision import compute_dtype as tcompute_dtype
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
B, T, D, H = 4, 32, 256, 2
LENGTHS = np.asarray([32, 13, 1, 0], np.int32)  # full, partial, 1, 0


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, tier):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if tier == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        d = np.abs(got - want)
        assert d.mean() < 2e-3 and d.max() < 5e-2, (d.mean(), d.max())


def _dead_rows_exact(got, want):
    """Rows at or past each length: the JAX kernel's constants to 1e-5."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    for b, n in enumerate(LENGTHS):
        np.testing.assert_allclose(got[b, n:], want[b, n:], rtol=1e-5, atol=1e-5)


def _qkv(rng, shape, tier):
    """q/k/v as values of the tier's dtype, on both sides."""
    vals = [jnp.asarray(rng.normal(size=shape).astype(np.float32), JAX_DT[tier])
            for _ in range(3)]
    return vals, [_t(np.asarray(v, np.float32), TORCH_DT[tier]) for v in vals]


@pytest.mark.parametrize("tier,dm,nh", [("f32", D, H), ("bf16", D, H), ("f32", 256, 1),
                                        ("bf16", 256, 1)],
                         ids=["f32", "bf16", "f32-dk256", "bf16-dk256"])
def test_attention_res_matches_pallas(tier, dm, nh, rng):
    """Kernel 6: res + MHA(q, k, v)·Wo + bo, no LN; rows at or past the
    length give res + bo (the length-0 row wholly). d_k 128 at two heads,
    then d_k 256 at one."""
    (jq, jk, jv), (q, k, v) = _qkv(rng, (B, T, dm), tier)
    res = rng.normal(size=(B, T, dm)).astype(np.float32)
    wo = (rng.normal(size=(dm, dm)) / np.sqrt(dm)).astype(np.float32)  # (in, out)
    bo = (rng.normal(size=(dm,)) * 0.1).astype(np.float32)
    jwo = jnp.asarray(wo, JAX_DT[tier])
    want = jattn.fused_attention_packed_res(
        jq, jk, jv, jnp.asarray(res), jwo, jnp.asarray(bo[None]), jnp.asarray(LENGTHS), nh,
        interpret=True, block_q=8)
    got = KA.attention_res(q, k, v, _t(res), _t(np.asarray(jwo, np.float32).T, TORCH_DT[tier]),
                           _t(bo), torch.from_numpy(LENGTHS), nh)
    assert got.dtype == torch.float32
    _close(got, want, tier)
    _dead_rows_exact(got, want)
    np.testing.assert_allclose(got.numpy()[3], res[3] + bo, rtol=1e-6, atol=1e-6)


# kernels 7 and 8: (tier, D, heads), d_k 128 at two heads, then d_k 256 (the
# widest instantiation of the Hopper kernel) at one and at two heads
BARE_CASES = [("f32", D, H), ("bf16", D, H), ("f32", 256, 1), ("bf16", 256, 1),
              ("f32", 512, 2), ("bf16", 512, 2)]
BARE_IDS = ["f32", "bf16", "f32-dk256-h1", "bf16-dk256-h1", "f32-dk256-h2", "bf16-dk256-h2"]


@pytest.mark.parametrize("tier,dm,nh", BARE_CASES, ids=BARE_IDS)
def test_fused_attention_packed_matches_pallas(tier, dm, nh, rng):
    """Kernel 7: bare masked attention, heads packed along D, out in q's
    dtype; rows at or past the length are zeros."""
    (jq, jk, jv), (q, k, v) = _qkv(rng, (B, T, dm), tier)
    want = jattn.fused_attention_packed(jq, jk, jv, jnp.asarray(LENGTHS), nh,
                                        interpret=True, block_q=8)
    got = KA.fused_attention_packed(q, k, v, torch.from_numpy(LENGTHS), nh)
    assert got.dtype == TORCH_DT[tier] and got.shape == (B, T, dm)
    _close(got.float(), want, tier)
    _dead_rows_exact(got.float(), want)
    for b, n in enumerate(LENGTHS):
        assert not got[b, n:].any()


@pytest.mark.parametrize("tier,dm,nh", BARE_CASES, ids=BARE_IDS)
def test_fused_attention_matches_pallas(tier, dm, nh, rng):
    """Kernel 8: the same function in the (B, H, T, dk) layout; and the
    packed and unpacked plain versions agree exactly."""
    (jq, jk, jv), (q, k, v) = _qkv(rng, (B, nh, T, dm // nh), tier)
    want = jattn.fused_attention(jq, jk, jv, jnp.asarray(LENGTHS), interpret=True,
                                 block_q=8)
    got = KA.fused_attention(q, k, v, torch.from_numpy(LENGTHS))
    assert got.dtype == TORCH_DT[tier] and got.shape == (B, nh, T, dm // nh)
    _close(got.float(), want, tier)
    for b, n in enumerate(LENGTHS):
        assert not got[b, :, n:].any()
    pack = lambda t: t.transpose(1, 2).reshape(B, T, dm)  # noqa: E731
    packed = KA.fused_attention_packed(pack(q), pack(k), pack(v),
                                       torch.from_numpy(LENGTHS), nh)
    assert torch.equal(packed, pack(got))


@pytest.mark.parametrize("dk,ok", [(64, True), (128, True), (192, True), (256, True),
                                   (320, True), (136, True), (1024, True), (132, True),
                                   (1032, True), (2048, True), (2056, False)])
def test_bare_attention_head_dims(dk, ok):
    """The CUDA entry of kernels 7 and 8 takes every head dim its tiling
    plans (``attention_train.plan``: 1 to 2048; 132 runs zero-padded to 136)
    and refuses the others before it builds anything; the check needs no
    card."""
    if ok:
        KA.check_head_dim("t", dk)
    else:
        with pytest.raises(ValueError, match="d_k"):
            KA.check_head_dim("t", dk)


@pytest.mark.parametrize("dk,ok", [(128, True), (160, True), (192, True), (256, True),
                                   (384, True), (132, True), (1024, True),
                                   (2056, False)])
def test_attention_half_head_dims(dk, ok):
    """The CUDA entries of kernels 1, 5 and 6 take the bare kernels' head
    dims (1 to 2048) at one and two heads where D = heads * d_k is within
    the projections' 2048, and refuse the others before they build
    anything; the check needs no card."""
    for heads in (1, 2):
        if ok:
            KA._check_heads("t", heads * dk, heads)
        else:
            with pytest.raises(ValueError, match="d_k"):
                KA._check_heads("t", heads * dk, heads)


def _ffn_weights(rng, D, Hd, O, k):
    """JAX layout: w1 (k, D, H), w2 (1, H, O)."""
    w1 = (rng.normal(size=(k, D, Hd)) / np.sqrt(k * D)).astype(np.float32)
    b1 = (rng.normal(size=(Hd,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(1, Hd, O)) / np.sqrt(Hd)).astype(np.float32)
    b2 = (rng.normal(size=(O,)) * 0.1).astype(np.float32)
    return w1, b1, w2, b2


def _port_ffn(w1, w2, td):
    """JAX (k, D, H) / (1, H, O) -> the port's (H, k*D) [(out, tap, in)] and
    (O, H), as values of the tier's dtype."""
    k, D, Hd = w1.shape
    return (_t(w1.transpose(2, 0, 1).reshape(Hd, k * D), td), _t(w2[0].T, td))


@pytest.mark.parametrize("tier", ["f32", "bf16"])
def test_ffn_block_pre_matches_pallas(tier, rng):
    """Kernel 9: x + FFN(mask(LN(x))), LN eps 1e-5 on the conv input and no
    LN after; rows whose window is past the length give x + bias row."""
    Hd, k = 64, 3
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    g = (rng.normal(size=(D,)) * 0.2 + 1.0).astype(np.float32)
    be = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    w1, b1, w2, b2 = _ffn_weights(rng, D, Hd, D, k)
    jd = JAX_DT[tier]
    jw1, jw2 = jnp.asarray(w1, jd), jnp.asarray(w2, jd)
    want = jffn.fused_ffn_block(jnp.asarray(x), jnp.asarray(g), jnp.asarray(be), jw1,
                                jnp.asarray(b1), jw2, jnp.asarray(b2), jnp.asarray(LENGTHS),
                                cd=jd, interpret=True, block_t=8)
    pw1, pw2 = _port_ffn(np.asarray(jw1, np.float32), np.asarray(jw2, np.float32),
                         TORCH_DT[tier])
    got = KF.ffn_block_pre(_t(x), pw1, _t(b1), pw2, _t(b2), _t(g), _t(be),
                           torch.from_numpy(LENGTHS), k)
    _close(got, want, tier)
    pad = (k - 1) // 2
    for b, n in enumerate(LENGTHS):  # wholly dead windows: exact constants
        np.testing.assert_allclose(got.numpy()[b, n + pad:], np.asarray(want)[b, n + pad:],
                                   rtol=1e-5, atol=1e-5)
    # the bias row: x + the row a length-0 sequence gives everywhere
    row = got.numpy()[3] - x[3]
    np.testing.assert_allclose(row, np.broadcast_to(row[0], row.shape), rtol=0, atol=1e-6)


@pytest.mark.parametrize("tier,out_dtype", [("f32", "f32"), ("bf16", "bf16"),
                                            ("bf16", "f32")])
def test_fused_ffn_matches_pallas(tier, out_dtype, rng):
    """Kernel 10: bare masked conv-FFN of an input in the compute dtype with
    O != D outputs in ``out_dtype``; dead rows give the bias-only row."""
    Hd, O, k = 64, 96, 3
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    w1, b1, w2, b2 = _ffn_weights(rng, D, Hd, O, k)
    jd = JAX_DT[tier]
    jx, jw1, jw2 = jnp.asarray(x, jd), jnp.asarray(w1, jd), jnp.asarray(w2, jd)
    want = jffn.fused_ffn(jx, jw1, jnp.asarray(b1), jw2, jnp.asarray(b2),
                          jnp.asarray(LENGTHS), out_dtype=JAX_DT[out_dtype],
                          interpret=True, block_t=8)
    td = TORCH_DT[tier]
    pw1, pw2 = _port_ffn(np.asarray(jw1, np.float32), np.asarray(jw2, np.float32), td)
    got = KF.fused_ffn(_t(np.asarray(jx, np.float32), td), pw1, _t(b1), pw2, _t(b2),
                       torch.from_numpy(LENGTHS), k, out_dtype=TORCH_DT[out_dtype])
    assert got.dtype == TORCH_DT[out_dtype] and got.shape == (B, T, O)
    assert np.asarray(want).dtype == np.dtype(JAX_DT[out_dtype])
    _close(got.float(), np.asarray(want, np.float32), tier)
    np.testing.assert_allclose(got.float().numpy()[3], np.asarray(want, np.float32)[3],
                               rtol=1e-5, atol=1e-5)


def test_apply_wrappers_match_their_kernels(rng):
    """mha_fused_res_apply / mha_fused_apply / ffn_block_fused_apply /
    ffn_fused_apply: the projections and casts around each kernel, against
    the same composition written out (bf16 tier, CPU: plain versions)."""
    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops import nn

    torch.manual_seed(0)
    blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, linear_units=64,
                                 positionwise_conv_kernel_size=3), device="cpu")
    x = _t(rng.normal(size=(B, T, D)))
    y = _t(rng.normal(size=(B, T, D)))
    lens = torch.from_numpy(LENGTHS)
    bf = torch.bfloat16
    a = blk.attn
    with tcompute_dtype(bf), torch.inference_mode():
        q, k, v = (nn.linear(y, p.weight, p.bias, out_dtype=bf) for p in (a.q, a.k, a.v))
        want = KA.attention_res(q, k, v, x, a.out.weight.to(bf), a.out.bias, lens, H)
        assert torch.equal(KA.mha_fused_res_apply(a, y, x, lens, H), want)
        o = KA.fused_attention_packed(q, k, v, lens, H)
        want = nn.linear(o, a.out.weight, a.out.bias, out_dtype=torch.float32)
        assert torch.equal(KA.mha_fused_apply(a, y, lens, H), want)
        want = KF.ffn_block_pre(x, *KF.pack_weights(blk.ffn, blk.norm2, bf), lens, 3)
        assert torch.equal(KF.ffn_block_fused_apply(blk.norm2, blk.ffn, x, lens), want)
        want = KF.fused_ffn(x.to(bf), *KF.pack_ffn(blk.ffn, bf), lens, 3)
        got = KF.ffn_fused_apply(blk.ffn, x, lens)
        assert got.dtype == bf and torch.equal(got, want)


# -- model level ------------------------------------------------------------

def _interpret(monkeypatch):
    """Every Pallas entry the JAX model reaches on these routes, called with
    interpret=True (the HLO interpreter) instead of on a TPU."""
    for mod, names in ((jattn, ("fused_attention_packed_res", "fused_attention_packed",
                                "fused_attention_packed_qkv_res_ln")),
                       (jffn, ("fused_ffn_block", "fused_ffn_block_post")),
                       (jadaptor, ("fused_variance_adaptor",)),
                       (jpostnet, ("fused_postnet",))):
        for name in names:
            real = getattr(mod, name)
            # the callers pass interpret=False: it must be overridden
            monkeypatch.setattr(mod, name, lambda *a, _r=real, **k: _r(*a, **{
                **k, "interpret": True}))


def _model_cfg(**kw):
    return Config(model=ModelConfig(
        adim=256, aheads=2, elayers=1, eunits=64, ddim=256, dlayers=1, dunits=64,
        postnet_layers=2, postnet_chans=32, positionwise_conv_kernel_size=3,
        duration_predictor_chans=16, fused_attention="on", **kw))


PRENORM = dict(encoder_normalize_before=True, decoder_normalize_before=True)
CONCAT = dict(encoder_concat_after=True, decoder_concat_after=True)


def _pair(cfg):
    jm = JFS(cfg)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(0))
    params["duration_predictor"]["out"]["b"] = params["duration_predictor"]["out"]["b"] + 1.5
    tm = TFS(config_from_dict(cfg.to_dict()), device="cpu")
    load_jax_params(tm, jax.device_get(params), jax.device_get(state))
    return jm, params, state, tm


def _run_both(monkeypatch, cfg, expect, forbid):
    """JAX encode + decode_frames with its kernels, the port's on the same
    weights fed the JAX durations; ``expect`` maps plain-version names to
    their call counts, ``forbid`` lists plain versions that must not run."""
    _interpret(monkeypatch)
    jm, params, state, tm = _pair(cfg)
    xs = np.random.default_rng(5).integers(1, 68, (3, 32)).astype(np.int32)
    ilens = np.asarray([32, 9, 1], np.int32)
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
    for mod, fn in [(KA, n) for n in ("attention_res_plain", "fused_attention_packed_plain",
                                      "attention_block_plain", "attention_res_ln_plain")] + \
                   [(KF, n) for n in ("ffn_block_pre_plain", "ffn_block_plain")]:
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _r=real, _n=fn, **k: (calls.append(_n),
                                                                      _r(*a, **k))[1])
    with tcompute_dtype(torch.bfloat16):
        ht, dt = tm.encode(torch.from_numpy(xs), torch.from_numpy(ilens))
        mt, lt = tm.decode_frames(ht, torch.from_numpy(np.array(dj)),
                                  torch.from_numpy(ilens), out_maxlen=L)
    for name, n in expect.items():
        assert calls.count(name) == n, (name, calls)
    assert not set(forbid) & set(calls), calls
    d = np.abs(ht.numpy() - np.asarray(hj))
    assert d.mean() < 0.02 and d.max() < 0.2, ("encoder", d.mean(), d.max())
    assert (dt.numpy() == np.asarray(dj)).mean() > 0.9
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    d = np.abs(mt.numpy() - np.asarray(mj))
    assert d.mean() < 0.02 and d.max() < 0.2, ("mel", d.mean(), d.max())
    return params, state, tm


def test_prenorm_model_matches_jax(monkeypatch):
    """``prenorm``: every block's attention half through kernel 6, its FFN
    half through kernel 9 (one encoder + one decoder block each)."""
    _run_both(monkeypatch, _model_cfg(**PRENORM),
              {"attention_res_plain": 2, "ffn_block_pre_plain": 2},
              ("attention_block_plain", "attention_res_ln_plain",
               "fused_attention_packed_plain", "ffn_block_plain"))


def test_prenorm_concat_model_matches_jax(monkeypatch):
    """``prenorm_concat``: the bare attention (kernel 7) inside plain
    projections, then the ``concat`` linear; the FFN half through kernel 9.
    load_jax_params fills ``concat`` and ``after_norm`` from the JAX tree,
    strictly."""
    params, state, tm = _run_both(monkeypatch, _model_cfg(**PRENORM, **CONCAT),
                               {"fused_attention_packed_plain": 2, "ffn_block_pre_plain": 2},
                               ("attention_res_plain", "attention_block_plain",
                                "attention_res_ln_plain", "ffn_block_plain"))
    pn = jax.device_get(params)
    for stack in ("encoder", "decoder"):
        lay = pn[stack]["layers"][0]
        np.testing.assert_array_equal(
            getattr(tm, stack).layers[0].concat.weight.detach().numpy(), lay["concat"]["w"].T)
        np.testing.assert_array_equal(
            getattr(tm, stack).after_norm.weight.detach().numpy(), pn[stack]["after_norm"]["g"])
    for drop in (("layers", 0, "concat"), ("after_norm",)):
        bad = jax.device_get(params)
        node = bad["encoder"]
        for key in drop[:-1]:
            node = node[key]
        del node[drop[-1]]
        with pytest.raises(RuntimeError, match=drop[-1]):
            load_jax_params(TFS(tm.cfg, device="cpu"), bad, jax.device_get(state))
    load_jax_params(TFS(tm.cfg, device="cpu"), jax.device_get(params), jax.device_get(state))


def test_fused_att_res_off_matches_jax(monkeypatch):
    """Post-LN with FUSED_ATT_RES off in both packages: the bare attention
    (kernel 7) with plain projections, residual and LN, then the post-LN
    FFN kernel."""
    monkeypatch.setattr(jflags, "FUSED_ATT_RES", False)
    monkeypatch.setattr(tflags, "FUSED_ATT_RES", False)
    _run_both(monkeypatch, _model_cfg(),
              {"fused_attention_packed_plain": 2, "ffn_block_plain": 2},
              ("attention_res_plain", "attention_block_plain", "attention_res_ln_plain",
               "ffn_block_pre_plain"))
