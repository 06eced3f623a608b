"""The port's MelGAN generator and wav serving path against the JAX package
on the CPU.

Both packages get the same weights (the JAX ``init_melgan`` tree carried
over by ``compat.from_jax.load_jax_melgan_params``, or one seungwonpark-format
checkpoint loaded by both) and the same numpy inputs. Sizes are small:
``MelGANConfig(base_channels=16)`` and ``conftest.small_cfg``.

Tolerances: f32 1e-5 (other summation order only); bf16 inside the JAX
package's own fused-vs-unfused bf16 gap on the same input (the port rounds at
the JAX generator's points, so it sits far inside); int16 PCM within 1 LSB
(float noise at the rounding knife-edge), as ``tests/test_server.py`` holds
the JAX fused path.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_vocoder as tv
from conftest import small_cfg
from fastspeech2_tpu.infer.synthesize import Synthesizer as JSynth
from fastspeech2_tpu.infer.synthesize import mel_floor_mask as j_floor_mask
from fastspeech2_tpu.infer.synthesize import pcm16 as j_pcm16
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JFS
from fastspeech2_tpu.vocoder import melgan as J
from fastspeech2_tpu_torch import vocoder as PV
from fastspeech2_tpu_torch.compat.from_jax import load_jax_melgan_params, load_jax_params
from fastspeech2_tpu_torch.config import config_from_dict
from fastspeech2_tpu_torch.infer.synthesize import Synthesizer as TSynth
from fastspeech2_tpu_torch.infer.synthesize import mel_floor_mask, pcm16
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2 as TFS
from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.vocoder import melgan as P
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

JCFG = J.MelGANConfig(base_channels=16)
PCFG = P.MelGANConfig(base_channels=16)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(J.init_melgan(jax.random.PRNGKey(1), JCFG))


def _port_gen(jparams, **kw):
    gen = P.MelGANGenerator(PCFG, device="cpu", **kw)
    return load_jax_melgan_params(gen, jparams)


def _mel(rng, B=2, T=8):
    return (rng.normal(size=(B, T, 80)) * 2.0 - 4.0).astype(np.float32)


# -- conv helpers ------------------------------------------------------------

@pytest.mark.parametrize("k,dilation", [(7, 1), (3, 3), (1, 1)])
def test_conv1d_reflect_matches_jax(rng, k, dilation):
    x = rng.normal(size=(2, 20, 6)).astype(np.float32)
    w = rng.normal(size=(k, 6, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    want = J._conv1d_reflect({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                             jnp.asarray(x), dilation=dilation)
    got = P._conv1d_reflect(_t(x), _t(w.transpose(2, 1, 0)), _t(b), dilation=dilation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [2, 3, 8])
def test_upsample_matches_jax(rng, stride):
    """Even strides: the polyphase form against the JAX polyphase form and
    against lax.conv_transpose; odd strides: torch's conv_transpose1d. The
    JAX weight (k, in, out) is the flipped torch kernel."""
    cin, cout = 6, 4
    x = rng.normal(size=(2, 9, cin)).astype(np.float32)
    wj = rng.normal(size=(2 * stride, cin, cout)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    p = {"w": jnp.asarray(wj), "b": jnp.asarray(b)}
    want = np.asarray(J._conv_transpose1d(p, jnp.asarray(x), stride))
    wt = _t(np.ascontiguousarray(wj[::-1].transpose(1, 2, 0)))  # (in, out, k)
    got = P._conv_transpose1d(_t(x), wt, _t(b), stride)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if stride % 2 == 0:
        wantp = np.asarray(J._upsample(p, jnp.asarray(x), stride))
        gotp = P._conv_transpose1d_polyphase(_t(x), P.polyphase_kernel(wt, stride),
                                             _t(b), stride)
        np.testing.assert_allclose(gotp.numpy(), wantp, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gotp.numpy(), want, rtol=1e-5, atol=1e-5)


# -- generator -----------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_generator_f32_matches_jax(rng, jparams, fused):
    """fused=True: the JAX side runs its Pallas kernel in interpret mode, the
    port its wrapper (the plain version on the CPU). T=8 frames make the last
    stage 2048 samples: tileable. Tolerance 1e-5."""
    mel = _mel(rng)
    gj = J.MelGANGenerator(JCFG, fused_resstack=fused, fused_interpret=True)
    want = np.asarray(gj(jparams, jnp.asarray(mel)))
    got = _port_gen(jparams, fused_resstack=fused)(_t(mel)).numpy()
    assert got.shape == (2, 8 * 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_generator_bf16_inside_jax_gap(rng, jparams, fused):
    """bf16 tier, everything in bf16: the port against the JAX generator on
    the same route must lie inside the JAX package's own fused-vs-unfused
    bf16 gap (max and mean) on this input."""
    mel = _mel(rng)
    ja = np.asarray(J.MelGANGenerator(JCFG, bf16=True, fused_resstack=False)(
        jparams, jnp.asarray(mel)))
    jb = np.asarray(J.MelGANGenerator(JCFG, bf16=True, fused_resstack=True,
                                      fused_interpret=True)(jparams, jnp.asarray(mel)))
    gap = np.abs(ja - jb)
    assert gap.max() > 0  # the two JAX routes do round differently
    got = _port_gen(jparams, bf16=True, fused_resstack=fused)(_t(mel)).numpy()
    d = np.abs(got - (jb if fused else ja))
    assert d.max() <= gap.max() and d.mean() <= gap.mean(), (d.max(), gap.max())


def test_generator_routes(rng, jparams, monkeypatch):
    """fused_resstack=None on the CPU takes the per-layer loop; True takes
    the wrapper for tileable stages only; fused_min_channels gates by width."""
    from fastspeech2_tpu_torch.ops.kernels import resstack as KR

    calls = []
    real = KR.resstack
    monkeypatch.setattr(KR, "resstack", lambda x, *a, **k: (calls.append(tuple(x.shape)),
                                                          real(x, *a, **k))[1])
    mel = _t(_mel(rng, B=1, T=8))
    _port_gen(jparams)(mel)
    assert calls == []
    _port_gen(jparams, fused_resstack=True)(mel)
    # T=8: stage lengths 64, 512, 1024, 2048 -> 64 is not tileable
    assert [c[1] for c in calls] == [512, 1024, 2048]
    calls.clear()
    _port_gen(jparams, fused_resstack=True, fused_min_channels=2)(mel)
    assert [c[2] for c in calls] == [4, 2]


def test_generator_routes_other_widths(rng, monkeypatch):
    """A generator whose stage widths the old bf16 kernel refused
    (base_channels=96: 48, 24, 12, 6) hands every tileable stage to the
    wrapper, which the card's kernel now serves (natively or zero-padded)."""
    from fastspeech2_tpu_torch.ops.kernels import resstack as KR

    calls = []
    real = KR.resstack
    monkeypatch.setattr(KR, "resstack", lambda x, *a, **k: (calls.append(tuple(x.shape)),
                                                          real(x, *a, **k))[1])
    gen = P.MelGANGenerator(P.MelGANConfig(base_channels=96), bf16=True,
                            fused_resstack=True, device="cpu")
    gen(_t(_mel(rng, B=1, T=16)))
    # T=16: stage lengths 128, 1024, 2048, 4096, all tileable
    assert [(c[1], c[2]) for c in calls] == [(128, 48), (1024, 24), (2048, 12), (4096, 6)]
    assert all(KR.served_width(c[2]) > 0 for c in calls)


def test_inference_pads_and_trims(rng, jparams):
    mel = _mel(rng, B=1, T=6)
    want = np.asarray(J.MelGANGenerator(JCFG).inference(jparams, jnp.asarray(mel)))
    gen = _port_gen(jparams)
    got = gen.inference(_t(mel)).numpy()
    assert got.shape == (1, 6 * 256)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    padded = torch.nn.functional.pad(_t(mel), (0, 0, 0, 10), value=math.log(1e-5))
    np.testing.assert_array_equal(got, gen(padded)[:, :6 * 256].numpy())


def test_seeded_init_is_reproducible_and_bounded():
    a = P.MelGANGenerator(PCFG, seed=3, device="cpu")
    b = P.MelGANGenerator(PCFG, seed=3, device="cpu")
    c = P.MelGANGenerator(PCFG, seed=4, device="cpu")
    for (n, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), n
    assert not torch.equal(a.pre.weight, c.pre.weight)
    assert float(a.pre.weight.detach().abs().max()) <= 1.0 / math.sqrt(80 * 7)
    assert a.cfg.hop_length == 256


# -- checkpoints ---------------------------------------------------------------

@pytest.fixture
def ckpt(tmp_path):
    torch.manual_seed(11)
    gen_t = tv._torch_seungwonpark_generator(base=16)
    path = tmp_path / "melgan16.pt"
    torch.save({"model_g": {f"generator.{k}": v
                            for k, v in gen_t.state_dict().items()}}, path)
    return str(path)


def test_load_melgan_matches_jax_loader(rng, ckpt):
    """One seungwonpark-format checkpoint through both loaders: the port
    folds the weight norm and keeps torch layouts; the JAX package flips and
    transposes. Same function, 1e-5."""
    mel = _mel(rng, B=1, T=21)[0]
    want = J.load_melgan(ckpt, JCFG, batch_frames=16)(mel)
    voc = PV.load_melgan(ckpt, PCFG, batch_frames=16, device="cpu")
    got = voc(mel)
    assert got.shape == (21 * 256,) and voc.hop_length == 256
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert PV.melgan_config_from_checkpoint(ckpt) == PCFG
    assert PV.detect_vocoder_kind(ckpt) == "melgan"
    got2 = PV.load_vocoder(ckpt, cfg=PCFG, batch_frames=16, device="cpu")(mel)
    np.testing.assert_array_equal(got, got2)


def test_load_vocoder_refuses_waveglow(tmp_path):
    """WaveGlow is ported (tests/test_torch_port_waveglow.py): a checkpoint
    with WaveGlow keys is taken for one, and one that is not a complete
    WaveGlow raises, with no fall back to MelGAN."""
    path = tmp_path / "wg.pt"
    torch.save({"state_dict": {"WN.0.in_layers.0.weight": torch.zeros(1),
                               "convinv.0.conv.weight": torch.zeros(1)}}, path)
    assert PV.detect_vocoder_kind(str(path)) == "waveglow"
    with pytest.raises(ValueError, match="not a complete WaveGlow checkpoint"):
        PV.load_vocoder(str(path), device="cpu")


def test_load_jax_melgan_params_is_strict(jparams):
    gen = P.MelGANGenerator(PCFG, device="cpu")
    import copy

    bad = copy.deepcopy(jparams)
    del bad["post"]["b"]
    with pytest.raises(RuntimeError, match="post.bias"):
        load_jax_melgan_params(gen, bad)
    bad = copy.deepcopy(jparams)
    bad["blocks"][0]["up"]["w"] = np.zeros((3, 3, 3), np.float32)
    with pytest.raises(ValueError, match="blocks.0.up.weight"):
        load_jax_melgan_params(gen, bad)
    bad = copy.deepcopy(jparams)
    bad["pre"]["g"] = np.zeros((1,), np.float32)
    with pytest.raises(KeyError, match="pre.g"):
        load_jax_melgan_params(gen, bad)


# -- the wav serving path ------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(JAX model, params, state, port model) at small_cfg, same weights."""
    cfg = small_cfg()
    jm = JFS(cfg)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(0))
    params["duration_predictor"]["out"]["b"] = (
        params["duration_predictor"]["out"]["b"] + 1.8)
    tm = TFS(config_from_dict(cfg.to_dict()), device="cpu")
    load_jax_params(tm, jax.device_get(params), jax.device_get(state))
    return jm, params, state, tm


def _seqs(lens, seed=2):
    g = np.random.default_rng(seed)
    return [g.integers(1, 68, (n,)).astype(np.int32) for n in lens]


def test_pcm16_and_floor_mask_match_jax(rng):
    wav = np.concatenate([rng.normal(size=200).astype(np.float32),
                          np.asarray([0.5 / 32767, 1.5 / 32767, 2.5 / 32767, -1.5 / 32767,
                                      2.0, -2.0], np.float32)])
    want = np.asarray(j_pcm16(jnp.asarray(wav)))
    np.testing.assert_array_equal(pcm16(torch.from_numpy(wav)).numpy(), want)
    np.testing.assert_array_equal(pcm16(wav), want)
    assert pcm16(wav).dtype == np.int16
    mel = rng.normal(size=(2, 5, 3)).astype(np.float32)
    lens = np.asarray([5, 2], np.int32)
    np.testing.assert_array_equal(
        mel_floor_mask(torch.from_numpy(mel), torch.from_numpy(lens)).numpy(),
        np.asarray(j_floor_mask(jnp.asarray(mel), jnp.asarray(lens))))


@pytest.mark.parametrize("demand_sized", [True, False])
def test_fused_wav_matches_separate_path_and_jax(pair, jparams, demand_sized):
    """wav_from_token_batch == mel path + floor mask + separate vocode, and ==
    the JAX package's fused path, both within 1 LSB. demand_sized: the 2-way
    split engages, so the short group's wav is zero past its own rung."""
    jm, params, state, tm = pair
    seqs = _seqs((9, 14, 22, 60, 100))
    kw = dict(max_frames=512, demand_sized=demand_sized)
    ts = TSynth(tm, device="cpu", **kw)
    gen = _port_gen(jparams)
    ts.attach_vocoder(gen)
    assert ts.has_vocoder and ts.hop_length == 256
    groups = []
    real = ts._decode_groups
    ts._decode_groups = lambda dem: (groups.append(real(dem)), groups[-1])[1]
    mel_f, wav_f, wav_lens, trunc = ts.wav_from_token_batch(seqs, return_truncated=True)
    assert wav_f.dtype == np.int16 and wav_f.shape[1] == mel_f.shape[1] * 256
    assert trunc.any()

    mel_s, out_lens = ts.mel_from_token_batch(seqs)
    np.testing.assert_array_equal(mel_f, mel_s)
    np.testing.assert_array_equal(wav_lens, out_lens * 256)
    wav_s = pcm16(gen(mel_floor_mask(torch.from_numpy(mel_s),
                                     torch.from_numpy(out_lens)))).numpy()
    if demand_sized:  # rows of the short group stop at their own rung
        (rows_s, rung_s), (_, rung_l) = groups[-1]
        short = np.asarray([r for r in rows_s if r < len(seqs)])
        assert rung_s < rung_l == mel_f.shape[1] and len(short)
        assert not wav_f[short, rung_s * 256:].any()
        # the buffer's end is a reflection edge: vocode the group at its rung
        wav_s[short] = 0
        wav_s[short, :rung_s * 256] = pcm16(gen(mel_floor_mask(
            torch.from_numpy(mel_s[short, :rung_s]),
            torch.from_numpy(out_lens[short])))).numpy()
    # the two group shapes give the same samples up to float noise
    np.testing.assert_allclose(wav_f.astype(np.int32), wav_s.astype(np.int32), atol=1)

    js = JSynth(jm, params, state, **kw)
    js.attach_vocoder(J.MelGANGenerator(JCFG), jparams)
    mel_j, wav_j, lens_j, trunc_j = js.wav_from_token_batch(seqs, return_truncated=True)
    np.testing.assert_array_equal(wav_lens, lens_j)
    np.testing.assert_array_equal(trunc, trunc_j)
    np.testing.assert_allclose(mel_f, mel_j, rtol=1e-4, atol=1e-4)
    # the mels differ by ~1e-5, the vocoder amplifies that a little: 2 LSB
    np.testing.assert_allclose(wav_f.astype(np.int32), wav_j.astype(np.int32), atol=2)


def test_wav_path_rebuckets_and_flags_truncation(pair, jparams):
    """Heuristic buffer: frames_per_token=2 makes the first 256-frame buffer
    saturate; the wav buffer grows with the frame buffer. At the cap the row
    is capped and flagged."""
    _, _, _, tm = pair
    gen = _port_gen(jparams)
    tokens = np.arange(1, 65).astype(np.int64)  # ~6 frames/token
    ts = TSynth(tm, device="cpu", frames_per_token=2, max_frames=2048,
                demand_sized=False)
    ts.attach_vocoder(gen)
    mel, wav, wav_lens, trunc = ts.wav_from_token_batch([tokens], return_truncated=True)
    n = int(wav_lens[0]) // 256
    assert n > 256 and not trunc[0]  # outgrew the 256-frame first bucket
    assert wav.shape[1] == mel.shape[1] * 256 >= n * 256
    assert np.any(wav[0, 256 * 256: n * 256] != 0)
    ts2 = TSynth(tm, device="cpu", frames_per_token=2, max_frames=256,
                 demand_sized=False)
    ts2.attach_vocoder(gen)
    _, wav2, lens2, trunc2 = ts2.wav_from_token_batch([tokens], return_truncated=True)
    assert int(lens2[0]) == 256 * 256 and trunc2[0] and wav2.shape == (1, 256 * 256)


@pytest.mark.parametrize("batched", [False, True])
def test_attach_vocoder_fn(pair, batched):
    """Host-level callable: per row on the live frames, or once on the batch
    through its ``batched`` attribute with the tail zeroed."""
    _, _, _, tm = pair
    seqs = _seqs((9, 22))
    calls = []

    def voc(mel):
        calls.append(mel.shape)
        return np.full((mel.shape[0] * 4,), 0.5, np.float32)

    if batched:
        voc.batched = lambda mel, lens: (calls.append(mel.shape),
                                         np.full((mel.shape[0], mel.shape[1] * 4), 0.5,
                                                 np.float32))[1]
    ts = TSynth(tm, device="cpu")
    with pytest.raises(RuntimeError, match="no vocoder"):
        ts.wav_from_token_batch(seqs)
    ts.attach_vocoder_fn(voc, hop_length=4)
    assert ts.has_vocoder and ts.hop_length == 4
    mel, wav, wav_lens = ts.wav_from_token_batch(seqs)
    _, out_lens = ts.mel_from_token_batch(seqs)
    np.testing.assert_array_equal(wav_lens, out_lens * 4)
    assert wav.dtype == np.int16 and wav.shape == (2, mel.shape[1] * 4)
    for i in range(2):
        assert np.all(wav[i, : wav_lens[i]] == 16384)  # round(0.5 * 32767), half to even
        assert not wav[i, wav_lens[i]:].any()
    assert len(calls) == (1 if batched else 2)
    voc.hop_length = 8
    ts.attach_vocoder_fn(voc)
    assert ts.hop_length == 8


def test_warmup_call_counts(pair, jparams):
    """The JAX method's shape walk: every power-of-two bucket, and on the
    demand-sized path every 256-frame rung up to _l_pad(t_pad, alpha_max) at
    the full and the half batch."""
    _, _, _, tm = pair
    h = TSynth(tm, device="cpu", demand_sized=False)
    assert h.warmup(batch_sizes=(1,), token_lens=(8,)) == 1
    assert h.warmup(batch_sizes=(1, 8), token_lens=(8,)) == 4  # 1, 2, 4, 8
    d = TSynth(tm, device="cpu", demand_sized=True)
    # t_pad 32 x 12 = 384 -> rungs 256, 512: 1 call + 2 rungs
    assert d.warmup(batch_sizes=(1,), token_lens=(8,)) == 3
    # alpha_max 2: ceiling 768 -> 3 rungs; B=4 also warms the half batch
    assert d.warmup(batch_sizes=(4,), token_lens=(8,), alpha_max=2.0) == 1 + 2 * 3
    seen = []
    d.attach_vocoder(_port_gen(jparams))
    real = d._vocode_pcm
    d._vocode_pcm = lambda mel, lens: (seen.append(tuple(mel.shape[:2])), real(mel, lens))[1]
    assert d.warmup(batch_sizes=(1,), token_lens=(8,)) == 3
    assert (1, 256) in seen and (1, 512) in seen  # the wav path was walked


def test_synth_text_matches_jax(pair):
    jm, params, state, tm = pair
    text = "Hello world. Dr. Smith paid 12 dollars."
    want, _ = JSynth(jm, params, state).synth_text(text)
    got, stats = TSynth(tm, device="cpu").synth_text(text)
    assert got.shape == want.shape and stats["frames"] == got.shape[0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_cached_pack_is_thread_safe():
    """Eight threads ask for one module's pack at once: it is built once and
    every thread gets the same object."""
    import sys

    owner = torch.nn.Linear(4, 4)
    built, got = [], []

    def build():
        built.append(1)
        return object()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: got.append(common.cached_pack(owner, [owner.weight], build)))
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert len(built) == 1 and len(got) == 8 and all(g is got[0] for g in got)
