"""The port's whole serving slice against the JAX package on the CPU.

Both packages get the same weights (the JAX ``init`` carried over by
``compat.from_jax.load_jax_params``) and the same numpy inputs.

- f32 tier at ``conftest.small_cfg``: durations and out_lens exact, mel 1e-4.
- bf16 tier with the kernels engaged (JAX Pallas kernels called with
  ``interpret=True``, the HLO interpreter, never TPU interpret mode; the
  port's plain versions on the CPU) at adim=ddim=256 / 2 heads so that
  d_k=128 engages the attention kernel in both stacks; both sides decode the
  JAX durations. Band: the JAX package's own fused-vs-XLA gap,
  mean < 0.02, max < 0.2 (tests/test_pallas.py:538-539).
- ``Synthesizer(device="cpu").mel_from_token_batch`` against the JAX
  ``Synthesizer`` (f32) on 5 phoneme sequences with the 2-way split engaged
  and one row past ``max_frames``: mel, out_lens and truncation flags agree.
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
from fastspeech2_tpu.ops.pallas import adaptor as jadaptor
from fastspeech2_tpu.ops.pallas import attention as jattn
from fastspeech2_tpu.ops.pallas import ffn as jffn
from fastspeech2_tpu.ops.pallas import postnet as jpostnet
from fastspeech2_tpu.ops.precision import compute_dtype as jcompute_dtype
from fastspeech2_tpu_torch.compat.from_jax import load_jax_params
from fastspeech2_tpu_torch.config import config_from_dict
from fastspeech2_tpu_torch.infer.synthesize import Synthesizer as TSynth
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2 as TFS
from fastspeech2_tpu_torch.ops.kernels import adaptor, attention, ffn, postnet
from fastspeech2_tpu_torch.ops.precision import compute_dtype as tcompute_dtype
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)


def _pair(cfg, dur_bias=1.5):
    """(JAX model, params, state, port model on the CPU with the same
    weights). The duration bias gives realistic frame counts."""
    jm = JFS(cfg)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(0))
    params["duration_predictor"]["out"]["b"] = (
        params["duration_predictor"]["out"]["b"] + dur_bias)
    tm = TFS(config_from_dict(cfg.to_dict()), device="cpu")
    load_jax_params(tm, jax.device_get(params), jax.device_get(state))
    return jm, params, state, tm


@pytest.fixture(scope="module")
def small_pair():
    return _pair(small_cfg(), dur_bias=1.8)


def _interpret(monkeypatch):
    """The Pallas entries the JAX model reaches on these routes, called with
    interpret=True (the HLO interpreter) instead of on a TPU; no TPU
    interpret mode."""
    for mod, names in ((jattn, ("fused_attention_packed_qkv_res_ln",
                                "fused_attention_packed_res_ln")),
                       (jffn, ("fused_ffn_block_post",)),
                       (jadaptor, ("fused_variance_adaptor",)),
                       (jpostnet, ("fused_postnet",))):
        for name in names:
            real = getattr(mod, name)
            # the callers pass interpret=False: it must be overridden
            monkeypatch.setattr(mod, name, lambda *a, _r=real, **k: _r(*a, **{
                **k, "interpret": True}))


def _batch(seed, B, T, lens):
    g = np.random.default_rng(seed)
    xs = g.integers(1, 68, (B, T)).astype(np.int32)
    return xs, np.asarray(lens, np.int32)


def test_inference_f32_matches_jax(small_pair):
    jm, params, state, tm = small_pair
    xs, ilens = _batch(0, 3, 16, [16, 9, 1])
    L = 128

    @jax.jit
    def run(params, state, xs, ilens):
        return jm.inference(params, state, xs, ilens, out_maxlen=L)

    mj, lj, dj = run(params, state, jnp.asarray(xs), jnp.asarray(ilens))
    mt, lt, dt = tm.inference(torch.from_numpy(xs), torch.from_numpy(ilens), out_maxlen=L)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-4, atol=1e-4)
    # per-row alpha reaches the expansion the same way
    alpha = np.asarray([0.5, 1.5, 2.0], np.float32)
    mj2, lj2, _ = jax.jit(lambda p, s, x, i, a: jm.inference(
        p, s, x, i, out_maxlen=L, alpha=a))(params, state, jnp.asarray(xs),
                                            jnp.asarray(ilens), jnp.asarray(alpha))
    mt2, lt2, _ = tm.inference(torch.from_numpy(xs), torch.from_numpy(ilens),
                               out_maxlen=L, alpha=torch.from_numpy(alpha))
    np.testing.assert_array_equal(lt2.numpy(), np.asarray(lj2))
    np.testing.assert_allclose(mt2.numpy(), np.asarray(mj2), rtol=1e-4, atol=1e-4)


def test_inference_f32_plain_variants_match_jax():
    """The f32 tier's other FFT-block branches: pre-LN encoder with its
    final LayerNorm, concat_after decoder, linear position-wise FFN."""
    cfg = small_cfg()
    cfg = Config(model=ModelConfig(**{**cfg.model.__dict__,
                                      "encoder_normalize_before": True,
                                      "decoder_concat_after": True,
                                      "positionwise_layer_type": "linear"}))
    jm, params, state, tm = _pair(cfg)
    xs, ilens = _batch(3, 2, 16, [16, 5])
    mj, lj, dj = jax.jit(lambda p, s, x, i: jm.inference(p, s, x, i, out_maxlen=96))(
        params, state, jnp.asarray(xs), jnp.asarray(ilens))
    mt, lt, dt = tm.inference(torch.from_numpy(xs), torch.from_numpy(ilens), out_maxlen=96)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-4, atol=1e-4)


def test_inference_bf16_kernels_match_jax(monkeypatch):
    """bf16 tier, kernels engaged on both sides: the JAX Pallas kernels in
    interpret mode, the port's four kernel wrappers (plain versions on the
    CPU). Spies prove every port kernel module ran."""
    cfg = Config(model=ModelConfig(
        adim=256, aheads=2, elayers=1, eunits=64, ddim=256, dlayers=1, dunits=64,
        postnet_layers=2, postnet_chans=32, positionwise_conv_kernel_size=3,
        duration_predictor_chans=16, fused_attention="on"))
    jm, params, state, tm = _pair(cfg)
    xs, ilens = _batch(1, 3, 32, [32, 9, 1])
    L = 64  # row 0 fills the buffer (its demand is clipped), rows 1-2 do not
    _interpret(monkeypatch)

    def enc(p, x, i):
        with jcompute_dtype(jnp.bfloat16):
            return jm.encode(p, x, i)

    def dec(p, s, h, d, i):
        with jcompute_dtype(jnp.bfloat16):
            return jm.decode_frames(p, s, h, d, i, out_maxlen=L)

    hj, dj = jax.jit(enc)(params, jnp.asarray(xs), jnp.asarray(ilens))
    mj, lj = jax.jit(dec)(params, state, hj, dj, jnp.asarray(ilens))

    calls = []
    for mod, fn in ((attention, "attention_block_plain"), (ffn, "ffn_block_plain"),
                    (adaptor, "variance_adaptor_plain"), (postnet, "postnet_plain")):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _r=real, _n=fn, **k: (calls.append(_n),
                                                                      _r(*a, **k))[1])
    with tcompute_dtype(torch.bfloat16):
        ht, dt = tm.encode(torch.from_numpy(xs), torch.from_numpy(ilens))
        mt, lt = tm.decode_frames(ht, torch.from_numpy(np.array(dj)),
                                  torch.from_numpy(ilens), out_maxlen=L)
    assert sorted(set(calls)) == ["attention_block_plain", "ffn_block_plain",
                                  "postnet_plain", "variance_adaptor_plain"], calls
    assert calls.count("attention_block_plain") == 2  # 1 encoder + 1 decoder block
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    # the encoder states and durations of the two packages
    assert np.abs(ht.numpy() - np.asarray(hj)).mean() < 0.02
    assert (dt.numpy() == np.asarray(dj)).mean() > 0.9
    d = np.abs(mt.numpy() - np.asarray(mj))
    assert d.mean() < 0.02 and d.max() < 0.2, (d.mean(), d.max())


def test_split_qkv_route_matches_jax(monkeypatch):
    """FS2_FUSED_ATT_QKV=off in both packages: the post-LN blocks project
    q/k/v with plain ops and take the q/k/v-given attention kernel (JAX:
    fused_attention_packed_res_ln in interpret mode; the port:
    attention_res_ln, its plain version on the CPU). Band as above."""
    from fastspeech2_tpu.ops import flags as jflags
    from fastspeech2_tpu_torch.ops import flags as tflags

    monkeypatch.setattr(jflags, "FUSED_ATT_QKV", False)
    monkeypatch.setattr(tflags, "FUSED_ATT_QKV", False)
    cfg = Config(model=ModelConfig(
        adim=256, aheads=2, elayers=2, eunits=64, ddim=256, dlayers=1, dunits=64,
        postnet_layers=2, postnet_chans=32, positionwise_conv_kernel_size=3,
        duration_predictor_chans=16, fused_attention="on"))
    jm, params, state, tm = _pair(cfg)
    xs, ilens = _batch(4, 3, 32, [32, 9, 1])
    _interpret(monkeypatch)

    def enc(p, x, i):
        with jcompute_dtype(jnp.bfloat16):
            return jm.encode(p, x, i)

    hj, dj = jax.jit(enc)(params, jnp.asarray(xs), jnp.asarray(ilens))
    calls = []
    real = attention.attention_res_ln_plain
    monkeypatch.setattr(attention, "attention_res_ln_plain",
                        lambda *a, **k: (calls.append(a[0].dtype), real(*a, **k))[1])
    monkeypatch.setattr(attention, "attention_block_plain",
                        lambda *a, **k: pytest.fail("the fused-QKV kernel ran"))
    with tcompute_dtype(torch.bfloat16):
        ht, dt = tm.encode(torch.from_numpy(xs), torch.from_numpy(ilens))
    assert calls == [torch.bfloat16, torch.bfloat16]  # one per encoder block
    d = np.abs(ht.numpy() - np.asarray(hj))
    assert d.mean() < 0.02 and d.max() < 0.2, (d.mean(), d.max())
    assert (dt.numpy() == np.asarray(dj)).mean() > 0.9
    # and the split route agrees with the port's own fused-QKV route
    monkeypatch.undo()
    with tcompute_dtype(torch.bfloat16):
        hf, _ = tm.encode(torch.from_numpy(xs), torch.from_numpy(ilens))
    np.testing.assert_array_equal(ht.numpy(), hf.numpy())


@pytest.mark.parametrize("demand_sized", [True, False])
def test_synthesizer_mel_matches_jax(small_pair, demand_sized):
    """demand_sized: the 2-way split must engage. Heuristic buffer
    (frames_per_token=2): the first buffer saturates and both packages grow
    it the same way."""
    jm, params, state, tm = small_pair
    g = np.random.default_rng(2)
    seqs = [g.integers(1, 68, (n,)).astype(np.int32) for n in (9, 14, 22, 60, 100)]
    kw = dict(max_frames=512, demand_sized=demand_sized,
              frames_per_token=12 if demand_sized else 2)
    js = JSynth(jm, params, state, **kw)
    ts = TSynth(tm, device="cpu", **kw)
    mj, lj, tj = js.mel_from_token_batch(seqs, return_truncated=True)

    groups = []
    real = ts._decode_groups
    ts._decode_groups = lambda dem: (groups.append(real(dem)), groups[-1])[1]
    mt, lt, tt = ts.mel_from_token_batch(seqs, return_truncated=True)
    if demand_sized:
        assert len(groups[0]) == 2, "the 2-way demand split did not engage"
    else:
        assert not groups and ts._l_pad(128, 1.0) < mt.shape[1]
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(tt, tj)
    assert tt.any(), "expected one row past max_frames"
    assert mt.shape == mj.shape
    np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-4)
    # synth_phonemes: the phoneme frontend into the same path
    mel = ts.synth_phonemes("HH AH0 L OW1 W ER1 L D")
    assert mel.ndim == 2 and mel.shape[1] == 80 and np.isfinite(mel).all()


def test_load_jax_params_is_strict(small_pair):
    _, params, state, _ = small_pair
    tm = TFS(config_from_dict(small_cfg().to_dict()), device="cpu")
    pn = jax.device_get(params)
    del pn["feat_out"]["b"]
    with pytest.raises(RuntimeError, match="feat_out.bias"):
        load_jax_params(tm, pn, jax.device_get(state))
    pn = jax.device_get(params)
    pn["feat_out"]["w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="feat_out.weight"):
        load_jax_params(tm, pn, jax.device_get(state))


def test_entry_points_refuse_cuda_without_a_gpu():
    """device=None means cuda: without a card the entry points raise rather
    than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TFS(config_from_dict(small_cfg().to_dict()))
    tm = TFS(config_from_dict(small_cfg().to_dict()), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSynth(tm)
