"""The port's deploy artifacts (``fastspeech2_tpu_torch/infer/export.py``,
``torch.export``) against the JAX package's (``fastspeech2_tpu/infer/
export.py``, ``jax.export``) on the CPU.

One JAX-written ``.npz`` checkpoint at ``conftest.small_cfg`` (duration bias
1.87, so rows expand to realistic frame counts) goes through both packages'
``export_inference`` + ``load_exported``; the artifacts run the same tokens,
lengths and per-row speeds. Tolerances: the f32 inference bar (lengths
exact, mel 1e-4); with a baked MelGAN the int16 wav within 1 LSB. The
int8 and bf16 artifacts are held to the port's own eager calls bit for bit:
the traced graph runs the same ops (the bf16 one the serving kernels'
custom ops, their plain versions on the CPU).
"""

import jax
import numpy as np
import pytest
import torch

from conftest import small_cfg
from fastspeech2_tpu.infer.export import export_inference as jexport_inference
from fastspeech2_tpu.infer.export import load_exported as jload_exported
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JFS
from fastspeech2_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from fastspeech2_tpu_torch import cli as tcli
from fastspeech2_tpu_torch.config import config_from_dict
from fastspeech2_tpu_torch.infer.export import export_inference, load_exported
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_tpu_torch.ops.precision import compute_dtype
from fastspeech2_tpu_torch.ops.quant8 import quantize_model
from fastspeech2_tpu_torch.train.checkpoint import load_model, save_checkpoint
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

B, T, L = 2, 16, 128
SHAPE = dict(batch=B, max_tokens=T, max_frames=L)


def _inputs():
    g = np.random.default_rng(5)
    xs = np.zeros((B, T), np.int32)
    ilens = np.asarray([12, 5], np.int32)
    for i, n in enumerate(ilens):
        xs[i, :n] = g.integers(1, 68, n)
    return xs, ilens, np.asarray([1.0, 1.3], np.float32)


@pytest.fixture(scope="module")
def jckpt(tmp_path_factory):
    """A JAX-written checkpoint of ``small_cfg`` (adim == ddim = 32)."""
    cfg = small_cfg()
    params, state = jax.jit(JFS(cfg).init)(jax.random.PRNGKey(0))
    params = jax.device_get(params)
    params["duration_predictor"]["out"]["b"] = params["duration_predictor"]["out"]["b"] + 1.87
    path = str(tmp_path_factory.mktemp("export") / "ckpt_00000001.npz")
    jsave_checkpoint(path, params, jax.device_get(state), {}, 1, cfg)
    return path


@pytest.fixture(scope="module")
def jax_out(jckpt, tmp_path_factory):
    """The JAX f32 artifact's (mel, out_lens) on ``_inputs``."""
    path = str(tmp_path_factory.mktemp("jexport") / "fs2.jax")
    jexport_inference(jckpt, path, **SHAPE)
    mel, lens = jload_exported(path)(*_inputs())
    return np.asarray(mel), np.asarray(lens)


def _hold_to_jax(out, jax_out):
    mel, lens = (t.numpy() for t in out)
    np.testing.assert_array_equal(lens, jax_out[1])
    assert mel.shape == jax_out[0].shape == (B, L, 80)
    np.testing.assert_allclose(mel, jax_out[0], rtol=1e-4, atol=1e-4)
    assert lens.min() > 20  # rows expand: the bias is in


@pytest.fixture(scope="module")
def port_export(jckpt, tmp_path_factory):
    """The port's f32 artifact of ``jckpt``, written by ``python -m
    fastspeech2_tpu_torch export`` with the JAX command's flags (and
    ``--device cpu``), loaded."""
    out = str(tmp_path_factory.mktemp("texport") / "fs2.pt2")
    tcli.main(["export", "-p", jckpt, "-o", out, "--batch", str(B), "--max_tokens",
               str(T), "--max_frames", str(L), "--precision", "highest", "--device", "cpu"])
    return load_exported(out)


def test_export_f32_matches_jax_artifact(port_export, jax_out):
    """The same ``.npz`` through both packages' ``export`` + ``load_exported``:
    lengths exact, mel 1e-4, with per-row speeds as a runtime input; the
    artifact's own settings ride beside the graph."""
    call = port_export
    _hold_to_jax(call(*_inputs()), jax_out)
    assert call.meta["outputs"] == ["mel", "out_lens"] and call.meta["device"] == "cpu"
    assert call.meta["matmul_precision"] == "highest" and not call.meta["int8"]
    # alphas default to 1.0 per row
    xs, ilens, _ = _inputs()
    ones = call(xs, ilens, np.ones((B,), np.float32))
    for a, b in zip(call(xs, ilens), ones):
        assert torch.equal(a, b)


def test_export_of_equal_stack_widths_saves_and_loads(jckpt, port_export):
    """adim == ddim (``small_cfg``): the encoder's and the decoder's
    positional rows come from one cached table; each is a copy, so the saved
    artifact holds both and loads (``torch.export.load`` refused it while
    they aliased), with the eager call's mel bit for bit."""
    cfg, model = load_model(jckpt, device="cpu")
    assert cfg.model.adim == cfg.model.ddim
    xs, ilens, alphas = (torch.from_numpy(a) for a in _inputs())
    mel, lens = port_export(xs, ilens, alphas)
    with torch.inference_mode():
        want, wlens, _ = model.inference(xs, ilens, out_maxlen=L, alpha=alphas)
    assert torch.equal(lens, wlens) and torch.equal(mel, want)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "bf16_int8"])
def test_export_bf16_with_the_kernel_routes(tmp_path, int8):
    """bf16 at d_k 128 with ``fused_attention: on``: the serving routes
    (kernels 1-4 post-LN; under int8 the attention half on weights
    dequantized in the graph, the FFN as W8A8 convs) trace as the ``fs2::``
    custom ops, the artifact saves and loads, and on the CPU (the ops'
    plain versions) it gives the eager call bit for bit (``int8=True``:
    ``quantize_model``'s, not the bf16 tier's)."""
    d = small_cfg().to_dict()
    d["model"].update(adim=256, ddim=256, aheads=2, eunits=256, dunits=256,
                      fused_attention="on")
    cfg = config_from_dict(d)
    model = FastSpeech2(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.duration_predictor.out.bias.fill_(1.87)
    save_checkpoint(str(tmp_path / "bf.npz"), model, None, 0, cfg)
    path = export_inference(str(tmp_path / "bf.npz"), str(tmp_path / "bf.pt2"), bf16=True,
                            int8=int8, device="cpu", **SHAPE)
    graph = torch.export.load(path).graph
    ops = {str(n.target) for n in graph.nodes if str(n.target).startswith("fs2.")}
    assert ops == {"fs2.attention_block.default", "fs2.variance_adaptor.default",
                   "fs2.postnet.default"} | (set() if int8 else {"fs2.ffn_block.default"}), ops
    xs, ilens, alphas = (torch.from_numpy(a) for a in _inputs())
    mel, lens = load_exported(path)(xs, ilens, alphas)
    with torch.inference_mode(), compute_dtype(torch.bfloat16):
        want, wlens, _ = (quantize_model(model) if int8 else model).inference(
            xs, ilens, out_maxlen=L, alpha=alphas)
        if int8:
            bf16, _, _ = model.inference(xs, ilens, out_maxlen=L, alpha=alphas)
            assert float((mel - bf16).abs().max()) > 1e-3
    assert torch.equal(lens, wlens) and torch.equal(mel, want)
    assert int(lens.min()) > 20


def test_serving_kernels_are_custom_ops():
    """Kernels 1-7, 9 and 13 are ``fs2::`` custom ops with a CPU (plain
    version), a CUDA (launch) and a fake implementation, and no other: a
    tensor elsewhere finds no implementation to fall back on."""
    from fastspeech2_tpu_torch.ops.kernels import library

    names = ("attention_block", "attention_res_ln", "attention_res",
             "fused_attention_packed", "ffn_block", "ffn_block_pre", "variance_adaptor",
             "postnet", "resstack")
    for n in names:
        assert isinstance(getattr(library, n), torch._library.custom_ops.CustomOpDef), n
        for key, want in (("CPU", True), ("CUDA", True), ("Meta", True), ("XPU", False),
                          ("CompositeExplicitAutograd", False)):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(f"fs2::{n}", key) == want, \
                (n, key)
    # the fake implementation gives the shapes and launches nothing
    out = torch.ops.fs2.postnet(torch.empty(2, 8, 80, device="meta"),
                                torch.empty(10, device="meta"),
                                torch.empty(2, 4, 80, device="meta"),
                                torch.empty(2, dtype=torch.int32, device="meta"), 2, 16, 5)
    assert out.shape == (2, 8, 80) and out.device.type == "meta"


@pytest.fixture(scope="module")
def melgan_ckpt(tmp_path_factory):
    """A seeded seungwonpark-format MelGAN checkpoint at the hub's widths
    (base 512): the JAX export bakes the default generator in."""
    from test_vocoder import _torch_seungwonpark_generator

    torch.manual_seed(21)
    gen = _torch_seungwonpark_generator(base=512)
    path = tmp_path_factory.mktemp("melgan") / "melgan.pt"
    torch.save({"model_g": {f"generator.{k}": v for k, v in gen.state_dict().items()}},
               path)
    return str(path)


def test_export_with_melgan_matches_jax_artifact(jckpt, melgan_ckpt, tmp_path):
    """``vocoder_path``: both artifacts emit (mel, int16 wav, out_lens) in one
    graph; mel 1e-4, lengths exact, the wav within 1 LSB. WaveGlow is
    refused, as in the JAX package."""
    shape = dict(batch=B, max_tokens=T, max_frames=32)
    jpath = str(tmp_path / "voc.jax")
    jexport_inference(jckpt, jpath, vocoder_path=melgan_ckpt, **shape)
    jmel, jwav, jlens = (np.asarray(a) for a in jload_exported(jpath)(*_inputs()))
    call = load_exported(export_inference(jckpt, str(tmp_path / "voc.pt2"),
                                          vocoder_path=melgan_ckpt, device="cpu", **shape))
    mel, wav, lens = (t.numpy() for t in call(*_inputs()))
    assert call.meta["outputs"] == ["mel", "wav", "out_lens"]
    np.testing.assert_array_equal(lens, jlens)
    np.testing.assert_allclose(mel, jmel, rtol=1e-4, atol=1e-4)
    assert wav.dtype == np.int16 and wav.shape == jwav.shape == (B, 32 * 256)
    assert int(np.abs(wav.astype(np.int32) - jwav).max()) <= 1
    assert np.abs(wav).max() > 100  # audio, not silence

    from fastspeech2_tpu_torch.vocoder import WaveGlowConfig, init_waveglow, nvidia_state_dict

    wg = tmp_path / "wg.pt"
    torch.save(nvidia_state_dict(init_waveglow(WaveGlowConfig(n_flows=2, n_group=8,
                                                              n_early_every=4,
                                                              n_early_size=2,
                                                              wn_layers=2,
                                                              wn_channels=16),
                                               seed=0, device="cpu")), wg)
    with pytest.raises(ValueError, match="only MelGAN"):
        export_inference(jckpt, str(tmp_path / "wg.pt2"), vocoder_path=str(wg),
                         device="cpu", **shape)
