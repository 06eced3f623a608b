"""The port's ``synth`` and ``serve`` commands on the CPU, against the JAX
package's.

A small ``prenorm`` checkpoint (pre-LN in both stacks) is written by the JAX
package from a minimal override YAML, with its config embedded as
``hp_yaml``. ``synth`` runs the f32 tier in both packages: the port's
``mel.npy`` matches the JAX command's to 1e-4 (the f32 tier's tolerance,
tests/test_torch_port_model.py), both write ``test_tts.wav`` and both write
``mel.png`` (``utils/plotting.py``; the port's utils match the JAX
package's output on a seeded mel). ``serve``
runs as a subprocess on the CPU: one mel request over a live socket; every
wait has its own timeout and the process is stopped in a ``finally``.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import yaml
from scipy.io.wavfile import read as read_wav

from fastspeech2_tpu import cli as jcli
from fastspeech2_tpu.config import load_config as jload_config
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JFS
from fastspeech2_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from fastspeech2_tpu.utils import display as jdisplay
from fastspeech2_tpu.utils import plotting as jplotting
from fastspeech2_tpu_torch import cli as tcli
from fastspeech2_tpu_torch.utils import display as tdisplay
from fastspeech2_tpu_torch.utils import plotting as tplotting

ROOT = Path(__file__).resolve().parents[1]
PHONEMES = "HH AH0 L OW1 W ER1 L D pau DH IH1 S IH1 Z AH0 T EH1 S T"


@pytest.fixture(scope="module")
def prenorm_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("prenorm")
    override = {"model": {"adim": 32, "aheads": 2, "elayers": 1, "eunits": 64,
                          "ddim": 32, "dlayers": 1, "dunits": 64, "postnet_layers": 2,
                          "postnet_chans": 16, "positionwise_conv_kernel_size": 3,
                          "duration_predictor_chans": 16,
                          "encoder_normalize_before": True,
                          "decoder_normalize_before": True}}
    (d / "prenorm.yaml").write_text(yaml.safe_dump(override))
    cfg = jload_config(str(d / "prenorm.yaml"))
    assert cfg.model.encoder_normalize_before and cfg.model.adim == 32
    jm = JFS(cfg)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(3))
    params = jax.device_get(params)
    params["duration_predictor"]["out"]["b"] = params["duration_predictor"]["out"]["b"] + 1.8
    path = str(d / "ckpt_00000001.npz")
    jsave_checkpoint(path, params, jax.device_get(state), {}, 1, cfg)
    return path


def test_synth_matches_jax_command(prenorm_ckpt, tmp_path):
    args = ["synth", "-p", prenorm_ckpt, "--phonemes", "--text", PHONEMES]
    tcli.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    jcli.main(args + ["-o", str(tmp_path / "jax")])
    mt = np.load(tmp_path / "port" / "mel.npy")
    mj = np.load(tmp_path / "jax" / "mel.npy")
    assert mt.shape == mj.shape and mt.shape[0] == 80 and mt.shape[1] > 5, mt.shape
    np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-4)
    sr, wav = read_wav(str(tmp_path / "port" / "test_tts.wav"))
    assert sr == 22050 and wav.dtype == np.int16
    assert len(wav) == (mt.shape[1] - 1) * 256 and np.abs(wav).max() > 0
    assert (tmp_path / "jax" / "test_tts.wav").exists()
    pt, pj = (_png(tmp_path / d / "mel.png") for d in ("port", "jax"))
    assert pt.shape == pj.shape and pt.ndim == 3 and pt.shape[0] > 0, (pt.shape, pj.shape)


def _png(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def test_plotting_matches_jax_package(tmp_path):
    """The port's plotting helpers give the JAX package's images on one seeded
    mel: the rendered arrays, and the PNG files decoded, pixel for pixel."""
    mel = np.random.default_rng(7).normal(size=(80, 120)).astype(np.float32)
    np.testing.assert_array_equal(tplotting.plot_spectrogram_to_numpy(mel),
                                  jplotting.plot_spectrogram_to_numpy(mel))
    wav = np.sin(np.arange(4000) / 20.0).astype(np.float32)
    np.testing.assert_array_equal(tplotting.plot_waveform_to_numpy(wav),
                                  jplotting.plot_waveform_to_numpy(wav))
    tplotting.save_spectrogram_png(mel, str(tmp_path / "port.png"))
    jplotting.save_spectrogram_png(mel, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(_png(tmp_path / "port.png"), _png(tmp_path / "jax.png"))
    np.testing.assert_array_equal(tplotting._colormap_fallback(mel),
                                  jplotting._colormap_fallback(mel))


def test_display_matches_jax_package():
    rows = [("steps", 12), ("batch", "16 x 4"), ("lr", 1e-3)]
    assert tdisplay.simple_table(rows) == jdisplay.simple_table(rows)
    for i, n in ((0, 100), (25, 100), (7, 7), (3, 0)):
        assert tdisplay.progbar(i, n) == jdisplay.progbar(i, n)
    t0 = time.time() - 3725
    assert tdisplay.time_since(t0) == jdisplay.time_since(t0) == "1h 2m"


def test_serve_refuses_a_pth_checkpoint(tmp_path):
    """``serve`` reads .npz only, as the JAX package's serve does (``synth``
    reads a .pth: tests/test_torch_port_compat.py)."""
    with pytest.raises(SystemExit, match="convert"):
        tcli.main(["serve", "-p", str(tmp_path / "ref.pth"), "--device", "cpu"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_answers_a_mel_request(prenorm_ckpt, tmp_path):
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    log = open(tmp_path / "serve.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "fastspeech2_tpu_torch", "serve", "-p", prenorm_ckpt,
         "--device", "cpu", "--host", "127.0.0.1", "--port", str(port), "--max_batch", "4"],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, (tmp_path / "serve.log").read_text()[-2000:]
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                    assert r.status == 200
                    break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "the server did not come up in 120 s"
                time.sleep(0.2)
        req = urllib.request.Request(url + "/synthesize",
                                     data=json.dumps({"phonemes": PHONEMES}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            obj = json.loads(r.read())
        assert obj["frames"] == len(obj["mel"]) > 5 and len(obj["mel"][0]) == 80
        assert np.isfinite(np.asarray(obj["mel"])).all()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        log.close()


def test_synth_int8_precision_default_matches_jax_command(prenorm_ckpt, tmp_path):
    """``synth --int8 --precision default`` in both packages (the f32 int8
    tier; the precision is a no-op on the CPU): the same frames, the mel
    within the int8 f32-tier bound of tests/test_torch_port_int8.py (2e-2),
    and other numbers than the f32 tier's."""
    args = ["synth", "-p", prenorm_ckpt, "--phonemes", "--text", PHONEMES, "--int8",
            "--precision", "default"]
    tcli.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    jcli.main(args + ["-o", str(tmp_path / "jax")])
    mt = np.load(tmp_path / "port" / "mel.npy")
    mj = np.load(tmp_path / "jax" / "mel.npy")
    assert mt.shape == mj.shape and mt.shape[1] > 5, (mt.shape, mj.shape)
    assert np.abs(mt - mj).max() < 2e-2, np.abs(mt - mj).max()
    assert (tmp_path / "port" / "test_tts.wav").exists()
    tcli.main(args[:-3] + ["-o", str(tmp_path / "f32"), "--device", "cpu"])
    mf = np.load(tmp_path / "f32" / "mel.npy")
    assert mf.shape != mt.shape or np.abs(mf - mt).max() > 1e-3
    with pytest.raises(SystemExit):
        tcli.main(args[:-1] + ["fast", "-o", str(tmp_path / "x"), "--device", "cpu"])


def _tiny_waveglow(path):
    """A WaveGlow checkpoint that reads the 80-channel mels, in NVIDIA's
    weight-normed format."""
    from fastspeech2_tpu_torch.vocoder import waveglow as W

    cfg = W.WaveGlowConfig(n_flows=2, n_early_every=2, wn_layers=1, wn_channels=8,
                           upsample_kernel=1024, hop_length=256)
    import torch

    torch.save(W.nvidia_state_dict(W.init_waveglow(cfg, seed=2, device="cpu")), path)
    return str(path)


def test_synth_with_waveglow_vocoder(prenorm_ckpt, tmp_path):
    """``synth --vocoder`` with a WaveGlow checkpoint writes ``test_tts.wav``
    (L * 256 samples), where it used to raise."""
    voc = _tiny_waveglow(tmp_path / "wg.pt")
    tcli.main(["synth", "-p", prenorm_ckpt, "--phonemes", "--text", PHONEMES,
               "--vocoder", voc, "-o", str(tmp_path / "out"), "--device", "cpu"])
    mel = np.load(tmp_path / "out" / "mel.npy")
    sr, wav = read_wav(str(tmp_path / "out" / "test_tts.wav"))
    assert sr == 22050 and wav.dtype == np.int16
    assert len(wav) == mel.shape[1] * 256 and np.abs(wav).max() > 0


def test_serve_int8_with_waveglow(prenorm_ckpt, tmp_path, monkeypatch):
    """``serve --int8 --vocoder <WaveGlow>``: the command builds an int8
    Synthesizer (the checkpoint's model quantized) with the WaveGlow callable
    attached (not fused), and hands it to the server; the server itself is
    replaced here by a recorder (tests/test_torch_port_server.py drives it)."""
    from fastspeech2_tpu_torch.infer import server
    from fastspeech2_tpu_torch.ops import quant8

    got = {}
    monkeypatch.setattr(server, "serve", lambda synth, cfg, **kw: got.update(synth=synth, **kw))
    voc = _tiny_waveglow(tmp_path / "wg.pt")
    tcli.main(["serve", "-p", prenorm_ckpt, "--int8", "--vocoder", voc, "--port", "0",
               "--device", "cpu"])
    synth = got["synth"]
    assert synth.int8 and quant8.attention_is_quantized(synth.model.encoder.layers[0].attn)
    assert synth._voc is None and synth._voc_fn is not None and synth.hop_length == 256
    mel, wav16, lens = synth.wav_from_token_batch(
        [np.arange(1, 12, dtype=np.int64), np.arange(3, 9, dtype=np.int64)])
    assert wav16.shape == (2, mel.shape[1] * 256) and np.abs(wav16).max() > 0
