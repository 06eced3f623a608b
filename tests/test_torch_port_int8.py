"""The port's int8 (W8A8) serving tier against the JAX package's
``ops/quant8.py`` on the CPU.

- Op level, numpy-seeded inputs: the quantized weights (q bit for bit, the
  scales equal) and activations, then ``int8_linear`` and ``int8_conv1d``
  (k = 1, 3, 9) on the same quantized inputs, bit for bit, at widths that
  ``torch._int_mm`` needs padded (K, N not multiples of 8); the padding
  itself is exact (``pad_operands``).
- Scope: the port's quantized model has int8 layers exactly where
  ``quantize_model_params`` puts ``{"q", "s"}`` leaves.
- f32 tier: ``Synthesizer(int8=True)`` of both packages at
  ``conftest.small_cfg`` on 5 sequences: out_lens equal, durations on >= 99%
  of the tokens (1 of 205 differs), the mel rows with equal durations within
  2e-2 (measured 1.1e-2); the cause of the gap is in the test. With the same
  durations fed, one decode of the quantized models agrees to 7.2e-7.
- bf16 tier, one block per stack at D=256, 2 heads (d_k 128): the JAX
  model with its Pallas entries called with ``interpret=True`` (the HLO
  interpreter, not TPU interpret mode) against the port fed the JAX
  durations, on the four routes: post-LN (kernel 1), ``FUSED_ATT_QKV`` off
  (5), pre-LN (6) and ``FUSED_ATT_RES`` off (7). Band of
  tests/test_torch_port_prenorm.py: mean < 0.02, max < 0.2. Spies prove which
  plain versions ran and that the FFN kernels did not.
- Memory: the caller's model is left as it was, and no bf16 copy of a
  quantized weight outlives a call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import small_cfg
from fastspeech2_tpu.config import Config, ModelConfig
from fastspeech2_tpu.infer.synthesize import Synthesizer as JSynth
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JFS
from fastspeech2_tpu.ops import flags as jflags
from fastspeech2_tpu.ops import quant8 as jq8
from fastspeech2_tpu.ops.pallas import adaptor as jadaptor
from fastspeech2_tpu.ops.pallas import attention as jattn
from fastspeech2_tpu.ops.pallas import ffn as jffn
from fastspeech2_tpu.ops.pallas import postnet as jpostnet
from fastspeech2_tpu.ops.precision import compute_dtype as jcompute_dtype
from fastspeech2_tpu_torch.compat.from_jax import load_jax_params
from fastspeech2_tpu_torch.config import config_from_dict
from fastspeech2_tpu_torch.infer.synthesize import Synthesizer as TSynth
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2 as TFS
from fastspeech2_tpu_torch.ops import flags as tflags
from fastspeech2_tpu_torch.ops import nn as tnn_ops
from fastspeech2_tpu_torch.ops import quant8
from fastspeech2_tpu_torch.ops.kernels import attention as KA
from fastspeech2_tpu_torch.ops.kernels import ffn as KF
from fastspeech2_tpu_torch.ops.precision import compute_dtype as tcompute_dtype
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# -- op level -----------------------------------------------------------------

@pytest.mark.parametrize("cin,cout,k", [(48, 64, 1), (37, 45, 1), (30, 20, 3), (64, 96, 9),
                                        (37, 45, 9)])
def test_conv_quantization_and_product_bit_equal(cin, cout, k):
    """Conv weights (JAX (k, in, out), torch (out, in, k)): q bit for bit,
    scales equal; the activation's q and scale equal; int8_conv1d's output
    bit for bit (37 and 45 need K and N padding on the card)."""
    rng = np.random.default_rng(cin * 100 + k)
    w = (rng.normal(size=(k, cin, cout)) * np.linspace(0.1, 3.0, cout)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    x = rng.normal(size=(2, 33, cin)).astype(np.float32)
    jp = jq8.quantize_conv1d_params({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    tw = quant8.quantize_weight(_t(w.transpose(2, 1, 0)), (1, 2))
    assert tw.q.dtype == torch.int8 and tw.s.shape == (cout,)
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jp["q"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(tw.s.numpy(), np.asarray(jp["s"]))
    jxq, jsx = jq8.dynamic_quantize(jnp.asarray(x))
    txq, tsx = quant8.dynamic_quantize(_t(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    assert float(tsx) == float(jsx)
    want = np.asarray(jq8.int8_conv1d(jp, jnp.asarray(x)))
    got = tnn_ops.conv1d(_t(x), tw, _t(b))  # the nn dispatch on Int8Weight
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("din,dout", [(48, 64), (37, 45), (256, 256)])
def test_linear_quantization_and_product_bit_equal(din, dout):
    """Linear weights (JAX (in, out), torch (out, in)); output in bf16 when
    asked (the projections of the bare-attention route)."""
    rng = np.random.default_rng(din + dout)
    w = (rng.normal(size=(din, dout)) / np.sqrt(din)).astype(np.float32)
    b = rng.normal(size=(dout,)).astype(np.float32)
    x = rng.normal(size=(3, 11, din)).astype(np.float32)
    jp = jq8.quantize_linear_params({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    tw = quant8.quantize_weight(_t(w.T), (1,))
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jp["q"]).T)
    np.testing.assert_array_equal(tw.s.numpy(), np.asarray(jp["s"]))
    for jdt, tdt in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jq8.int8_linear(jp, jnp.asarray(x), out_dtype=jdt), np.float32)
        got = tnn_ops.linear(_t(x), tw, _t(b), out_dtype=tdt)
        assert got.dtype == (tdt or torch.float32)
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("m,k,n", [(1, 37, 45), (16, 8, 8), (17, 3456, 1536), (40, 9, 1)])
def test_int8_product_padding_is_exact(m, k, n):
    """``pad_operands`` gives ``torch._int_mm``'s shapes (more than 16 rows,
    K and N multiples of 8), and the padded product sliced back equals the
    unpadded one (the CPU product: float64, exact)."""
    g = torch.Generator().manual_seed(m * k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    bt = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    ap, btp = quant8.pad_operands(a, bt)
    assert ap.shape[0] > 16 and ap.shape[1] % 8 == 0 and btp.shape[0] % 8 == 0
    assert ap.shape[1] == btp.shape[1] and ap.is_contiguous() and btp.is_contiguous()
    want = a.long() @ bt.long().t()
    assert torch.equal(quant8.int_mm(a, bt).long(), want)
    assert torch.equal(quant8.int_mm(ap, btp)[:m, :n].long(), want)


def test_even_kernel_refused():
    w = quant8.quantize_weight(torch.randn(4, 4, 2), (1, 2))
    with pytest.raises(NotImplementedError, match="odd"):
        quant8.int8_conv1d(torch.randn(1, 5, 4), w)


# -- model level ----------------------------------------------------------------

_PAIRS = {}


def _pair(cfg, dur_bias):
    """(JAX model, params, state, port model); one JAX init per config in
    this module (quantize_model copies, so the routes can share it)."""
    key = (cfg.to_yaml(), dur_bias)
    if key not in _PAIRS:
        _PAIRS[key] = _new_pair(cfg, dur_bias)
    return _PAIRS[key]


def _new_pair(cfg, dur_bias):
    jm = JFS(cfg)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(0))
    params["duration_predictor"]["out"]["b"] = params["duration_predictor"]["out"]["b"] + dur_bias
    tm = TFS(config_from_dict(cfg.to_dict()), device="cpu")
    load_jax_params(tm, jax.device_get(params), jax.device_get(state))
    return jm, params, state, tm


@pytest.fixture(scope="module")
def small_pair():
    return _pair(small_cfg(), 1.8)


def test_quantized_scope_matches_jax(small_pair):
    """The port's int8 layers sit exactly where the JAX package's
    ``{"q", "s"}`` leaves do, with the same q and s; the rest of the model
    keeps its weights."""
    jm, params, state, tm = small_pair
    jqp = jax.device_get(jq8.quantize_model_params(params))
    qm = quant8.quantize_model(tm)
    jax_int8 = set()
    for stack in ("encoder", "decoder"):
        for i, layer in enumerate(jqp[stack]["layers"]):
            for part in ("attn", "ffn"):
                for name, leaf in layer[part].items():
                    if jq8.is_quantized(leaf):
                        jax_int8.add(f"{stack}.layers.{i}.{part}.{name}")
    port_int8 = {n for n, m in qm.named_modules() if quant8.is_quantized(m)}
    assert port_int8 == jax_int8 and len(port_int8) == 12
    lay = jqp["decoder"]["layers"][0]
    np.testing.assert_array_equal(qm.decoder.layers[0].ffn.w1.q.numpy(),
                                  np.asarray(lay["ffn"]["w1"]["q"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(qm.encoder.layers[0].attn.v.s.numpy(),
                                  np.asarray(jqp["encoder"]["layers"][0]["attn"]["v"]["s"]))
    qsd, sd = qm.state_dict(), tm.state_dict()
    for name, t in sd.items():
        owner = name.rsplit(".", 1)[0]
        if owner in port_int8:
            continue
        assert torch.equal(qsd[name], t), name
    assert all(not n.startswith(tuple(port_int8)) or n.rsplit(".", 1)[1] in ("q", "s", "bias")
               for n in qsd)


def test_synthesizer_int8_f32_matches_jax(small_pair):
    """``Synthesizer(int8=True)`` in the f32 tier, both packages, with the
    2-way decode split engaged and one row past max_frames. The ops are bit
    for bit (above), but the f32 values entering a quantization come out of
    sums in another order (XLA's fused softmax and LayerNorm against
    torch's): they can differ in the last bit, which moves a per-tensor scale
    by an ulp and now and then carries an activation across a rounding
    boundary; one such step moves the outputs by about ``sx * s``. Measured
    at this size: 1 of the 205 tokens' durations differs (row 4, the
    100-token row, encoder states 3.5e-3 apart there and 4.8e-7 elsewhere);
    the mel rows whose durations agree are within 1.1e-2 (row 0 within
    7.2e-7). Bound: durations on >= 99% of the tokens, out_lens equal, and
    rows with equal durations within 2e-2."""
    jm, params, state, tm = small_pair
    g = np.random.default_rng(2)
    seqs = [g.integers(1, 68, (n,)).astype(np.int32) for n in (9, 14, 22, 60, 100)]
    js = JSynth(jm, params, state, max_frames=512, int8=True)
    ts = TSynth(tm, device="cpu", max_frames=512, int8=True)
    mj, lj = js.mel_from_token_batch(seqs)
    mt, lt = ts.mel_from_token_batch(seqs)
    np.testing.assert_array_equal(lt, np.asarray(lj))
    assert mt.shape == np.asarray(mj).shape
    # the durations of the served batch (the padded batch both encode)
    B, t_pad, _, xs, ilens, alphas = ts._pad_batch(seqs, 1.0)
    _, dj, _ = js._enc_fn(t_pad)(js.params, jnp.asarray(xs.numpy().astype(np.int32)),
                                 jnp.asarray(ilens.numpy()), jnp.asarray(alphas.numpy()))
    with ts._cd():
        _, dt = ts.model.encode(xs, ilens)
    dj, dt = np.asarray(dj), dt.numpy()
    live = np.arange(t_pad)[None] < ilens.numpy()[:, None]
    assert (dj == dt)[live].mean() >= 0.99, (dj != dt)[live].sum()
    same = [i for i in range(B) if np.array_equal(dj[i], dt[i])]
    assert len(same) >= B - 1, same
    for i in same:
        d = np.abs(mt[i] - np.asarray(mj)[i])
        assert d.max() < 2e-2, (i, d.max())
    # the tier is really on: the f32 model serves other numbers
    mf, _ = TSynth(tm, device="cpu", max_frames=512).mel_from_token_batch(seqs)
    assert np.abs(mf - mt).max() > 1e-3


def _interpret(monkeypatch):
    """Every Pallas entry the JAX model reaches on these routes, called with
    interpret=True (the HLO interpreter) instead of on a TPU."""
    for mod, names in ((jattn, ("fused_attention_packed_res", "fused_attention_packed",
                                "fused_attention_packed_res_ln",
                                "fused_attention_packed_qkv_res_ln")),
                       (jffn, ("fused_ffn_block", "fused_ffn_block_post")),
                       (jadaptor, ("fused_variance_adaptor",)),
                       (jpostnet, ("fused_postnet",))):
        for name in names:
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _r=real, **k: _r(*a, **{
                **k, "interpret": True}))


def _model_cfg(**kw):
    return Config(model=ModelConfig(
        adim=256, aheads=2, elayers=1, eunits=64, ddim=256, dlayers=1, dunits=64,
        postnet_layers=2, postnet_chans=32, positionwise_conv_kernel_size=3,
        duration_predictor_chans=16, fused_attention="on", **kw))


PRENORM = dict(encoder_normalize_before=True, decoder_normalize_before=True)
SPIED = [(KA, n) for n in ("attention_block_plain", "attention_res_ln_plain",
                           "attention_res_plain", "fused_attention_packed_plain")] + \
        [(KF, n) for n in ("ffn_block_plain", "ffn_block_pre_plain", "fused_ffn_plain")]


@pytest.mark.parametrize("route,cfg_kw,switch,expect", [
    ("postln", {}, None, "attention_block_plain"),
    ("qkv_off", {}, "FUSED_ATT_QKV", "attention_res_ln_plain"),
    ("prenorm", PRENORM, None, "attention_res_plain"),
    ("res_off", {}, "FUSED_ATT_RES", "fused_attention_packed_plain"),
])
def test_int8_bf16_routes_match_jax(monkeypatch, route, cfg_kw, switch, expect):
    """int8 bf16 tier: the JAX model's quantized params through its
    kernels (interpret=True) against the port's quantized model fed the JAX
    durations. Each route runs its attention kernel once per block (the
    dequantized weights on three routes, W8A8 projections around kernel 7 on
    the fourth) and no FFN kernel: the FFNs are W8A8 convs."""
    if switch:
        monkeypatch.setattr(jflags, switch, False)
        monkeypatch.setattr(tflags, switch, False)
    _interpret(monkeypatch)
    jm, params, state, tm = _pair(_model_cfg(**cfg_kw), 1.5)
    qparams = jq8.quantize_model_params(params)
    qm = quant8.quantize_model(tm)
    xs = np.random.default_rng(5).integers(1, 68, (3, 32)).astype(np.int32)
    ilens = np.asarray([32, 9, 1], np.int32)
    L = 64

    def enc(p, x, i):
        with jcompute_dtype(jnp.bfloat16):
            return jm.encode(p, x, i)

    def dec(p, s, h, d, i):
        with jcompute_dtype(jnp.bfloat16):
            return jm.decode_frames(p, s, h, d, i, out_maxlen=L)

    hj, dj = jax.jit(enc)(qparams, jnp.asarray(xs), jnp.asarray(ilens))
    mj, lj = jax.jit(dec)(qparams, state, hj, dj, jnp.asarray(ilens))

    calls = []
    for mod, fn in SPIED:
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _r=real, _n=fn, **k: (calls.append(_n),
                                                                      _r(*a, **k))[1])
    real_mm = quant8.int_mm
    n_mm = []
    monkeypatch.setattr(quant8, "int_mm", lambda *a: (n_mm.append(1), real_mm(*a))[1])
    with tcompute_dtype(torch.bfloat16), torch.inference_mode():
        ht, dt = qm.encode(torch.from_numpy(xs), torch.from_numpy(ilens))
        mt, lt = qm.decode_frames(ht, torch.from_numpy(np.array(dj)),
                                  torch.from_numpy(ilens), out_maxlen=L)
    # one encoder + one decoder block; a plain attention half calls the
    # narrower ones (block -> res_ln -> res), which must be all that runs
    assert calls.count(expect) == 2, calls
    inner = {"attention_block_plain": {"attention_res_ln_plain", "attention_res_plain"},
             "attention_res_ln_plain": {"attention_res_plain"}}.get(expect, set())
    assert set(calls) == {expect} | inner, calls
    # two W8A8 FFN convs a block, plus the four projections around kernel 7
    assert len(n_mm) == 2 * (2 + (4 if route == "res_off" else 0)), len(n_mm)
    d = np.abs(ht.numpy() - np.asarray(hj))
    assert d.mean() < 0.02 and d.max() < 0.2, ("encoder", d.mean(), d.max())
    assert (dt.numpy() == np.asarray(dj)).mean() > 0.9
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    d = np.abs(mt.numpy() - np.asarray(mj))
    assert d.mean() < 0.02 and d.max() < 0.2, ("mel", d.mean(), d.max())


def test_int8_leaves_the_caller_model_and_caches_no_bf16_copy():
    """An int8 Synthesizer beside a bf16 one of the same model: the caller's
    module keeps its layers and weights (and its own cached packs), the
    quantized copy starts without them, and after bf16 calls no module of the
    quantized model holds a kernel pack of its attention or FFN weights."""
    cfg = _model_cfg()
    tm = TFS(config_from_dict(cfg.to_dict()), device="cpu",
             generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        tm.duration_predictor.out.bias.fill_(1.5)
    seqs = [np.random.default_rng(3).integers(1, 68, (n,)) for n in (12, 30)]
    bf = TSynth(tm, device="cpu", bf16=True)
    bf.mel_from_token_batch(seqs)
    assert "_kernel_pack" in tm.encoder.layers[0].attn.__dict__  # the bf16 tier caches
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    i8 = TSynth(tm, device="cpu", bf16=True, int8=True)
    assert i8.model is not tm
    for _ in range(2):
        mel, lens = i8.mel_from_token_batch(seqs)
        assert np.isfinite(mel).all() and (lens > 0).all()
    assert isinstance(tm.encoder.layers[0].attn.q, torch.nn.Linear)
    assert isinstance(tm.decoder.layers[0].ffn.w1, torch.nn.Conv1d)
    after = tm.state_dict()
    assert before.keys() == after.keys()
    assert all(torch.equal(before[k], after[k]) for k in before)
    for stack in (i8.model.encoder, i8.model.decoder):
        for layer in stack.layers:
            for m in (layer, layer.attn, layer.ffn, *layer.attn.children(),
                      *layer.ffn.children()):
                assert "_kernel_pack" not in m.__dict__, m
    # the int8 tier's FFT-stack weights are int8; nothing else of them is held
    held = {t.dtype for layer in i8.model.decoder.layers
            for t in (*layer.attn.buffers(), *layer.ffn.buffers())}
    assert held == {torch.int8, torch.float32}
    assert not any(True for layer in i8.model.decoder.layers for _ in layer.attn.parameters())
