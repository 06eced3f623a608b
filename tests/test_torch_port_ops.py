"""The port's glue ops, config and text frontend against the JAX package, and
the port's isolation from JAX.

Length regulation, bucketize and masks are held exactly; masked softmax,
LayerNorm/BatchNorm and the f32 attention at 1e-6 / 1e-5; the bf16 linear and
conv at one bf16 rounding step (both sides round at the same points; the f32
sums differ in order).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_tpu import config as jconfig
from fastspeech2_tpu import text as jtext
from fastspeech2_tpu.ops import attention as jattn
from fastspeech2_tpu.ops import length_regulator as jlr
from fastspeech2_tpu.ops import masks as jmasks
from fastspeech2_tpu.ops import nn as jnn
from fastspeech2_tpu.ops import quantize as jq
from fastspeech2_tpu.ops.precision import compute_dtype as jcompute_dtype
from fastspeech2_tpu_torch import config as tconfig
from fastspeech2_tpu_torch import text as ttext
from fastspeech2_tpu_torch.ops import attention as tattn
from fastspeech2_tpu_torch.ops import length_regulator as tlr
from fastspeech2_tpu_torch.ops import masks as tmasks
from fastspeech2_tpu_torch.ops import nn as tnn
from fastspeech2_tpu_torch.ops import quantize as tq
from fastspeech2_tpu_torch.ops.precision import compute_dtype as tcompute_dtype

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import in a fresh
    interpreter without loading jax or the JAX package."""
    code = r"""
import importlib, importlib.util, pkgutil, sys
import fastspeech2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "fastspeech2_tpu"
       or m.startswith("fastspeech2_tpu.")]
assert not bad, bad
assert len(names) >= 58, names
need = {"vocoder", "vocoder.melgan", "infer.server", "infer.synthesize",
        "audio", "audio.stft", "audio.pitch", "audio.griffin_lim",
        "audio.processing", "native", "cli", "__main__", "ops.kernels.stft",
        "data.ljspeech",
        "text.cleaners", "text.numbers", "text.cmudict", "text.g2p",
        "ops.kernels.resstack", "ops.kernels.attention", "ops.kernels.ffn",
        "models.encoder", "models.fastspeech2", "compat.from_jax",
        "ops.kernels.attention_train", "models.init", "train.loop", "train.step",
        "train.optimizer", "train.checkpoint", "train.metrics", "train.seeds",
        "data.filelist", "data.dataset", "data.batching", "data.prefetch",
        "utils", "utils.plotting", "utils.display", "compat.torch_loader",
        "compat.torch_saver", "train.gta", "ops.quant8", "vocoder.waveglow",
        "parallel", "parallel.mesh", "parallel.sharding"}
missing = {pkg.__name__ + "." + n for n in need} - set(names)
assert not missing, missing
print(len(names))
"""
    r = subprocess.run([sys.executable, "-c", code, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_config_schema_matches_jax_package():
    """Same fields and defaults, and the repo's YAML files load the same."""
    import dataclasses

    for name in ("DataConfig", "AudioConfig", "ModelConfig", "TrainConfig"):
        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jconfig, name))]
        tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tconfig, name))]
        assert jf == tf, name
    for yaml_file in ("default.yaml", "speed_bf16.yaml"):
        p = str(ROOT / "configs" / yaml_file)
        assert jconfig.load_config(p).to_dict() == tconfig.load_config(p).to_dict()
    snap = jconfig.Config().to_yaml()
    assert tconfig.Config.from_yaml(snap).to_dict() == jconfig.Config().to_dict()


def test_phonemes_to_sequence_matches():
    s = "HH AH0 L OW1 W ER1 L D pau AA0 ER2 sil UW2 spn"
    assert ttext.phonemes_to_sequence(s) == jtext.phonemes_to_sequence(s)
    assert ttext.valid_symbols == jtext.valid_symbols
    with pytest.raises(ValueError):
        ttext.phonemes_to_sequence("HH XX")


def test_masks_match():
    lens = np.asarray([5, 1, 0, 7], np.int32)
    for fn in ("make_pad_mask", "make_non_pad_mask", "attention_mask"):
        want = np.asarray(getattr(jmasks, fn)(jnp.asarray(lens), 7))
        got = getattr(tmasks, fn)(torch.from_numpy(lens), 7).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alpha", [1.0, 0.75, "rows"])
def test_length_regulator_exact(alpha, rng):
    """effective_durations / frame_demand / expansion_indices /
    regulate_length / scale_durations, exactly, including an all-zero row
    (one frame per token), a row clipped by the buffer, half-way rounding."""
    B, T, D, L = 4, 9, 5, 40
    ds = rng.integers(0, 7, (B, T)).astype(np.int32)
    ds[1] = 0
    ds[2] = 9
    ilens = np.asarray([9, 6, 9, 2], np.int32)
    tok = np.arange(T)[None] < ilens[:, None]
    hs = rng.normal(size=(B, T, D)).astype(np.float32)
    a = (np.asarray([0.5, 1.5, 2.5, 1.25], np.float32) if alpha == "rows" else alpha)
    ja = jnp.asarray(a) if alpha == "rows" else a
    ta = torch.from_numpy(a) if alpha == "rows" else a
    jd = jlr.scale_durations(jnp.asarray(ds), ja)
    td = tlr.scale_durations(torch.from_numpy(ds), ta)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jt, tt = jnp.asarray(tok), torch.from_numpy(tok)
    np.testing.assert_array_equal(tlr.effective_durations(td, tt).numpy(),
                                  np.asarray(jlr.effective_durations(jd, jt)))
    np.testing.assert_array_equal(tlr.frame_demand(td, tt).numpy(),
                                  np.asarray(jlr.frame_demand(jd, jt)))
    for got, want in zip(tlr.expansion_indices(td, tt, L, T),
                         jlr.expansion_indices(jd, jt, L, T)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tlr.regulate_length(torch.from_numpy(hs), td, tt, L),
                         jlr.regulate_length(jnp.asarray(hs), jd, jt, L)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bucketize_exact(rng):
    """torch.bucketize(right=False) == the JAX compare-count, including
    values exactly on an edge and outside the range."""
    np.testing.assert_array_equal(tq.log_bins(71.0, 676.2260946528305),
                                  jq.log_bins(71.0, 676.2260946528305))
    np.testing.assert_array_equal(tq.linear_bins(0.0178, 130.53),
                                  jq.linear_bins(0.0178, 130.53))
    for bins in (jq.log_bins(71.0, 676.2260946528305), jq.linear_bins(0.0178, 130.53)):
        x = np.concatenate([rng.uniform(bins[0] - 5, bins[-1] + 5, 500),
                            bins[::7], [bins[0], bins[-1]]]).astype(np.float32)
        want = np.asarray(jq.bucketize(jnp.asarray(x), jnp.asarray(bins)))
        got = tq.bucketize(torch.from_numpy(x), torch.from_numpy(bins)).numpy()
        np.testing.assert_array_equal(got, want)


def test_masked_softmax_matches(rng):
    s = rng.normal(size=(2, 3, 6, 6)).astype(np.float32) * 4
    lens = np.asarray([6, 3])
    m = (np.arange(6)[None, :, None] < lens[:, None, None]) & \
        (np.arange(6)[None, None, :] < lens[:, None, None])
    m = np.broadcast_to(m[:, None], s.shape)
    want = np.asarray(jattn.masked_softmax(jnp.asarray(s), jnp.asarray(m)))
    got = tattn.masked_softmax(torch.from_numpy(s), torch.from_numpy(m.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.all(got[1, :, 3:] == 0.0)  # fully padded query rows: exact zeros


def test_norms_match(rng):
    x = rng.normal(size=(3, 7, 16)).astype(np.float32) * 3 + 1
    g, b = rng.normal(size=(2, 16)).astype(np.float32)
    mean, var = rng.normal(size=16).astype(np.float32), rng.random(16).astype(np.float32) + 0.5
    for eps in (1e-5, 1e-12):
        want = jnn.layer_norm({"g": g, "b": b}, jnp.asarray(x), eps=eps)
        got = tnn.layer_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b),
                             eps=eps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    want, _ = jnn.batch_norm({"g": g, "b": b}, {"mean": mean, "var": var}, jnp.asarray(x),
                             training=False)
    got = tnn.batch_norm(torch.from_numpy(x), *(torch.from_numpy(a) for a in (mean, var, g, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tier", ["f32", "bf16"])
def test_linear_conv_match(tier, rng):
    """f32: 1e-5. bf16: both sides round the product to bf16 and add the
    bias in f32, so they agree to one bf16 rounding step of the output."""
    x = rng.normal(size=(2, 11, 24)).astype(np.float32)
    wl = rng.normal(size=(24, 40)).astype(np.float32) * 0.2
    bl = rng.normal(size=(40,)).astype(np.float32)
    wc = rng.normal(size=(5, 24, 40)).astype(np.float32) * 0.2
    jdt, tdt = (None, None) if tier == "f32" else (jnp.bfloat16, torch.bfloat16)
    with jcompute_dtype(jdt):
        jl = np.asarray(jnn.linear({"w": wl, "b": bl}, jnp.asarray(x)))
        jc = np.asarray(jnn.conv1d({"w": wc, "b": bl}, jnp.asarray(x)))
    with tcompute_dtype(tdt):
        tl = tnn.linear(torch.from_numpy(x), torch.from_numpy(wl.T.copy()),
                        torch.from_numpy(bl)).numpy()
        tc = tnn.conv1d(torch.from_numpy(x), torch.from_numpy(wc.transpose(2, 1, 0).copy()),
                        torch.from_numpy(bl)).numpy()
    tol = 1e-5 if tier == "f32" else 2 ** -7
    for got, want in ((tl, jl), (tc, jc)):
        scale = np.maximum(np.abs(want - bl), 1.0)
        assert np.all(np.abs(got - want) <= tol * scale), np.abs(got - want).max()


def test_mha_apply_matches(rng):
    """The plain (f32 tier) attention against the JAX XLA attention."""
    from fastspeech2_tpu_torch.compat.from_jax import load_jax_params
    from fastspeech2_tpu_torch.models.encoder import MultiHeadAttention

    D, H, T = 16, 2, 9
    params = jattn.init_mha(jax.random.PRNGKey(4), D)
    mod = MultiHeadAttention(D, device="cpu")
    load_jax_params(mod, jax.device_get(params))
    x = rng.normal(size=(2, T, D)).astype(np.float32)
    lens = np.asarray([9, 4], np.int32)
    want = jattn.mha_apply(params, *(jnp.asarray(x),) * 3,
                           jmasks.attention_mask(jnp.asarray(lens), T), H)
    with torch.no_grad():
        got = tattn.mha_apply(mod, *(torch.from_numpy(x),) * 3,
                              tmasks.attention_mask(torch.from_numpy(lens), T), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
