"""The port's released-checkpoint golden harness
(``fastspeech2_tpu_torch/compat/golden.py``) and the CLI ``golden`` against
the JAX package's (``fastspeech2_tpu/compat/golden.py``) on the CPU, and the
port's demo (``examples/demo_torch.py``).

The released checkpoints and golden artifacts are not in this repository,
so a stand-in reference ``.pth`` is written by the port's
``compat/torch_saver.py`` (``conftest.small_cfg``, duration bias 1.87) with a
seeded seungwonpark-format MelGAN beside it, and the golden mel and wav are
written by the test. Both packages read the same files with the phoneme
strings given (no g2p). Tolerances: mel 1e-4 (the f32 parity tier), the
vocoded int16 wav within 2 LSB, spectral distances 1e-4.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from conftest import small_cfg
from fastspeech2_tpu.compat import golden as J
from fastspeech2_tpu_torch import cli as tcli
from fastspeech2_tpu_torch.compat import golden as P
from fastspeech2_tpu_torch.compat.torch_saver import save_torch_checkpoint
from fastspeech2_tpu_torch.config import config_from_dict
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHONEMES = ["HH AH0 L OW1 W ER1 L D", "DH IH1 S IH1 Z AH0 T EH1 S T"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(stand-in acoustic .pth, MelGAN checkpoint, golden mel .npy, golden
    wav, the JAX harness's (mel, cfg, step) and (wav, sample rate, step)),
    the golden files made from the JAX output moved a little, so that every
    distance is non-zero."""
    from scipy.io.wavfile import write as write_wav

    from test_vocoder import _torch_seungwonpark_generator

    d = tmp_path_factory.mktemp("golden")
    cfg = config_from_dict(small_cfg().to_dict())
    model = FastSpeech2(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        model.duration_predictor.out.bias.fill_(1.87)
    acoustic = str(d / "standin_58k.pth")
    save_torch_checkpoint(acoustic, model, cfg, step=58000)
    torch.manual_seed(13)
    gen = _torch_seungwonpark_generator(base=32)
    melgan = str(d / "melgan.pt")
    torch.save({"model_g": {f"generator.{k}": v for k, v in gen.state_dict().items()}},
               melgan)
    g = np.random.default_rng(0)
    jmel = J.synth_with_torch_checkpoint(acoustic, phoneme_strs=PHONEMES)
    mel = jmel[0]
    golden_mel = str(d / "golden.npy")
    np.save(golden_mel, (mel[:, :-3] + g.normal(0, 0.05, mel[:, :-3].shape)).astype(np.float32))
    jwav = J.synth_wav_with_torch_checkpoints(acoustic, melgan, phoneme_strs=PHONEMES)
    wav, sr = jwav[:2]
    golden_wav = str(d / "golden.wav")
    noisy = np.clip(wav + g.normal(0, 0.01, wav.shape), -1, 1)
    write_wav(golden_wav, sr, (noisy * 32767).astype(np.int16))
    return acoustic, melgan, golden_mel, golden_wav, jmel, jwav


def _hold(got: dict, want: dict, skip=("golden_path", "out_wav")):
    """Two reports: the same keys, floats within 1e-4, the rest equal."""
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(want[k], float):
            assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
        elif k not in skip:
            assert got[k] == want[k], k


def test_synth_and_compare_to_golden_match_jax(files):
    """``synth_with_torch_checkpoint`` (config from the ``.pth``'s
    ``hp_str``, one call per sentence, mels concatenated) and
    ``compare_to_golden``: the same mel to 1e-4 and the same report."""
    acoustic, _, golden_mel, _, (mj, cj, sj), _ = files
    mt, ct, st = P.synth_with_torch_checkpoint(acoustic, phoneme_strs=PHONEMES,
                                               device="cpu")
    assert st == sj == 58000 and ct.model.adim == cj.model.adim
    assert mt.shape == mj.shape and mt.shape[0] == 80 and mt.shape[1] > 40
    np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-4)
    rj, rt = J.compare_to_golden(mj, golden_mel), P.compare_to_golden(mt, golden_mel)
    assert rt["mel_shape"] == rj["mel_shape"] and not rt["frames_match"]
    for k in ("mae_overlap", "max_abs_overlap"):
        assert abs(rt[k] - rj[k]) <= 1e-4 and rt[k] > 0.01, (k, rt[k], rj[k])


def test_synth_wav_and_spectral_distances_match_jax(files):
    """``synth_wav_with_torch_checkpoints`` with a MelGAN (the fused text->wav
    path), ``log_mel_distance`` and ``compare_to_golden_wav``: the wav within
    2 LSB, every distance to 1e-4."""
    acoustic, melgan, _, golden_wav, _, (wj, srj, sj) = files
    wt, srt, st = P.synth_wav_with_torch_checkpoints(acoustic, melgan,
                                                     phoneme_strs=PHONEMES, device="cpu")
    assert (srt, st) == (srj, sj) and wt.dtype == np.float32 and wt.shape == wj.shape
    assert np.abs(wt - wj).max() <= 2 / 32768 and np.abs(wt).max() > 0.01
    dj = J.log_mel_distance(wt, wj)
    dt = P.log_mel_distance(wt, wj, device="cpu")
    rj = J.compare_to_golden_wav(wj, srj, golden_path=golden_wav)
    rt = P.compare_to_golden_wav(wt, srt, golden_path=golden_wav, device="cpu")
    _hold(dt, dj)
    _hold(rt, rj)
    assert rt["log_mel_l1"] > 0.01 and rt["sr_match"]


def test_cli_golden_matches_jax(files, tmp_path, capsys):
    """``python -m fastspeech2_tpu_torch golden`` in mel mode and in wav mode
    (``--vocoder``, ``--golden_wav``, ``--out_wav``) prints the report the
    JAX command prints (its ``compare_to_golden[_wav]`` of the JAX
    harness's synthesis, with the checkpoint fields) within 1e-4."""
    acoustic, melgan, golden_mel, golden_wav, (mj, _, sj), (wj, srj, _) = files
    base = ["golden", "-p", acoustic, "--phonemes", "|".join(PHONEMES), "--device", "cpu"]
    out_wav = str(tmp_path / "out.wav")
    wants = [dict(J.compare_to_golden(mj, golden_mel), ckpt=acoustic, step=sj),
             dict(J.compare_to_golden_wav(wj, srj, "melgan", golden_path=golden_wav),
                  ckpt=acoustic, vocoder=melgan, kind="melgan", step=sj, out_wav=out_wav)]
    runs = [base + ["--golden", golden_mel],
            base + ["--vocoder", melgan, "--golden_wav", golden_wav, "--out_wav", out_wav]]
    for args, want in zip(runs, wants):
        tcli.main(args)
        got = json.loads(capsys.readouterr().out)
        _hold(got, json.loads(json.dumps(want)), skip=())
    assert os.path.getsize(out_wav) > 44


def test_melgan_state_dict_loads_in_both_packages(tmp_path):
    """``vocoder/melgan.py:melgan_state_dict`` writes a seeded generator in
    the seungwonpark format: the port's loader reads back its weights (the
    folded weight norm within 1e-6), and the port's and the JAX package's
    loaders vocode the same mel alike (1e-5)."""
    from fastspeech2_tpu.vocoder import melgan as JM
    from fastspeech2_tpu_torch.vocoder import melgan as PM

    gen = PM.MelGANGenerator(PM.MelGANConfig(base_channels=16), seed=5, device="cpu")
    path = str(tmp_path / "mg.pt")
    torch.save({"model_g": PM.melgan_state_dict(gen)}, path)
    assert PM.melgan_config_from_checkpoint(path) == gen.cfg
    back = PM.load_melgan_params(path, gen.cfg, device="cpu").state_dict()
    for k, v in gen.state_dict().items():
        np.testing.assert_allclose(back[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    mel = np.random.default_rng(1).normal(-5, 2, (21, 80)).astype(np.float32)
    got = PM.load_melgan(path, gen.cfg, batch_frames=16, device="cpu")(mel)
    jgot = JM.load_melgan(path, JM.MelGANConfig(base_channels=16), batch_frames=16)(mel)
    assert got.shape == (21 * 256,)
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-5)


def test_checkpoint_search_follows_the_jax_rules(tmp_path, monkeypatch):
    """``find_released_checkpoint`` / ``find_vocoder_checkpoint``: a set
    variable that names a file wins, one that names nothing raises (in both
    packages); the reference tree is read only where FS2_REFERENCE_DIR
    names it, and the searches stay inside this checkout otherwise."""
    hit = tmp_path / "x.pyt"
    hit.write_bytes(b"")
    for var, fns in (("FS2_RELEASED_CKPT", (J.find_released_checkpoint,
                                            P.find_released_checkpoint)),
                     ("FS2_MELGAN_CKPT", (lambda: J.find_vocoder_checkpoint("melgan"),
                                          lambda: P.find_vocoder_checkpoint("melgan"))),
                     ("FS2_WAVEGLOW_CKPT", (lambda: J.find_vocoder_checkpoint("waveglow"),
                                            lambda: P.find_vocoder_checkpoint("waveglow")))):
        monkeypatch.setenv(var, str(hit))
        assert [f() for f in fns] == [str(hit)] * 2
        monkeypatch.setenv(var, str(tmp_path / "missing.pyt"))
        for f in fns:
            with pytest.raises(FileNotFoundError, match=var):
                f()
        monkeypatch.delenv(var)
    assert P.GOLDEN_TEXT == J.GOLDEN_TEXT
    # the reference tree only from FS2_REFERENCE_DIR: the same file names
    # under it, and with it unset no path outside this checkout
    import importlib

    monkeypatch.setenv("FS2_REFERENCE_DIR", str(tmp_path))
    try:
        importlib.reload(P)
        assert P.GOLDEN_MEL_PATH == str(tmp_path / "sample" / "generated_mel_58k.npy")
        assert os.path.basename(P.GOLDEN_MEL_PATH) == os.path.basename(J.GOLDEN_MEL_PATH)
        assert {k: os.path.basename(v) for k, v in P.GOLDEN_WAVS.items()} == \
            {k: os.path.basename(v) for k, v in J.GOLDEN_WAVS.items()}
        monkeypatch.delenv("FS2_REFERENCE_DIR")
        importlib.reload(P)
        assert P.GOLDEN_MEL_PATH is None and set(P.GOLDEN_WAVS.values()) == {None}
        for pattern in P._CKPT_GLOBS + sum(P._VOCODER_GLOBS.values(), []):
            assert pattern.startswith(os.path.join(REPO, "checkpoints")), pattern
        with pytest.raises(FileNotFoundError, match="FS2_REFERENCE_DIR"):
            P.compare_to_golden(np.zeros((80, 4), np.float32))
    finally:
        monkeypatch.delenv("FS2_REFERENCE_DIR", raising=False)
        importlib.reload(P)


def test_demo_torch_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """examples/demo_torch.py: dataset -> train -> checkpoint reload -> synth
    -> Griffin-Lim wav through the port, as its ``__main__`` (its imports
    are in ``test_torch_port_ops.py``'s fresh-interpreter check)."""
    import runpy

    demo = os.path.join(REPO, "examples", "demo_torch.py")
    monkeypatch.setattr(sys, "argv", [demo, "--workdir", str(tmp_path), "--steps", "4",
                                      "--device", "cpu"])
    runpy.run_path(demo, run_name="__main__")
    assert "trained 4 steps on cpu" in capsys.readouterr().out
    mel = np.load(tmp_path / "mel.npy")
    assert mel.shape[0] == 80 and mel.shape[1] > 0 and np.all(np.isfinite(mel))
    from scipy.io.wavfile import read as read_wav

    sr, wav = read_wav(str(tmp_path / "demo.wav"))
    assert sr == 22050 and len(wav) > 0
    assert os.listdir(tmp_path / "checkpoints" / "demo")
