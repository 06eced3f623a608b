"""The port's training and checkpoint commands on the CPU, against the JAX
package's functions on the same store and weights.

- ``train`` on a fake feature store (``write_fake_feature_store``), then
  ``train -p`` to resume; the validation sample's four TensorBoard tags, its
  images equal to ``fastspeech2_tpu.utils.plotting`` of the same mels; a
  Chrome trace with ``--profile_dir``.
- ``evaluate`` against ``fastspeech2_tpu.train.loop.evaluate_predictors``
  (rtol = atol = 1e-5), ``average`` against ``average_checkpoints`` (the same
  arrays), ``gta`` against ``generate_gta`` (1e-4, the f32 inference
  tolerance of tests/test_torch_port_model.py), on JAX-written checkpoints.
- ``Synthesizer.mel_from_token_batch_bucketed`` against the JAX one: the same
  bucket plan, mels within 1e-4.
- Each new command raises without a GPU unless ``--device cpu`` is given.

The JAX ``train`` is not run here (its jit compile costs ~90 s a bucket
shape); the port's ``train()`` is held to the JAX loop in
tests/test_torch_port_train_*.py.
"""

import dataclasses
import io
import json
import os
import struct

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from conftest import small_cfg
from fastspeech2_tpu.data.dataset import TTSDataset as JDataset
from fastspeech2_tpu.infer.synthesize import Synthesizer as JSynth
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JFS
from fastspeech2_tpu.train import checkpoint as jckpt
from fastspeech2_tpu.train.gta import generate_gta as jgenerate_gta
from fastspeech2_tpu.train.loop import evaluate_predictors as jevaluate
from fastspeech2_tpu.train.step import TrainState as JTrainState
from fastspeech2_tpu.utils import plotting as jplotting
from fastspeech2_tpu_torch import cli as tcli
from fastspeech2_tpu_torch.compat.from_jax import load_jax_params
from fastspeech2_tpu_torch.config import config_from_dict
from fastspeech2_tpu_torch.data.dataset import TTSDataset as TDataset
from fastspeech2_tpu_torch.data.dataset import write_fake_feature_store
from fastspeech2_tpu_torch.infer.synthesize import Synthesizer as TSynth
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2 as TFS
from fastspeech2_tpu_torch.train.checkpoint import load_checkpoint
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

VALIDATION_TAGS = {"validation/mel_target", "validation/mel_predicted",
                   "validation/audio_predicted", "validation/audio_target"}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """(JAX Config over a 16-utterance fake store, 4 of them for validation;
    YAML of it)."""
    d = tmp_path_factory.mktemp("store")
    fl = write_fake_feature_store(str(d / "data"), n_utts=16, seed=1)
    valid = d / "valid.txt"  # the first 4 utterances
    valid.write_text("".join(open(fl).readlines()[:4]))
    cfg = small_cfg(batch_size=2, accum_grad=1, summary_interval=1, validation_step=4,
                    save_interval=2, keep_ckpts=5)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, data_dir=str(d / "data"), train_filelist=fl, valid_filelist=str(valid)))
    path = d / "small.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    return cfg, str(path)


@pytest.fixture(scope="module")
def jax_ckpts(store, tmp_path_factory):
    """(JAX model, [(params, state)] x 2, two JAX-written checkpoints)."""
    cfg, _ = store
    jm = JFS(cfg)
    init = jax.jit(jm.init)
    d = tmp_path_factory.mktemp("jax_ckpts")
    weights, paths = [], []
    for step, seed in ((2, 0), (4, 1)):
        params, state = jax.device_get(init(jax.random.PRNGKey(seed)))
        params["duration_predictor"]["out"]["b"] = params["duration_predictor"]["out"]["b"] + 1.5
        path = str(d / f"ckpt_{step:08d}.npz")
        jckpt.save_checkpoint(path, params, state, None, step, cfg)
        weights.append((params, state))
        paths.append(path)
    return jm, weights, paths


def _events(log_dir):
    """Every (step, Summary.Value) in the TensorBoard event files of log_dir."""
    from tensorboardX.proto.event_pb2 import Event

    out = []
    for name in sorted(os.listdir(log_dir)):
        if not name.startswith("events.out.tfevents"):
            continue
        with open(os.path.join(log_dir, name), "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):  # TFRecord: length, crc, payload, crc
            (n,) = struct.unpack("<Q", data[pos: pos + 8])
            ev = Event.FromString(data[pos + 12: pos + 12 + n])
            pos += 16 + n
            out += [(ev.step, v) for v in ev.summary.value]
    return out


def _png_chw(encoded):
    with Image.open(io.BytesIO(encoded)) as im:
        return np.asarray(im.convert("RGB")).transpose(2, 0, 1)


def test_train_command_logs_the_sample_profiles_and_resumes(store, tmp_path):
    cfg, cfg_path = store
    out, prof = str(tmp_path / "out"), str(tmp_path / "prof")
    tcli.main(["train", "-c", cfg_path, "-n", "run", "-o", out, "--max_steps", "4",
               "--profile_dir", prof, "--device", "cpu"])
    ckpt_dir = os.path.join(out, "checkpoints", "run")
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt_00000002.npz", "ckpt_00000004.npz"]
    assert os.path.exists(os.path.join(out, "run.log"))
    # the profiler: started before step 4 (3 warm steps), written at the end
    assert os.listdir(prof) == ["trace_steps_4-4.json"]
    with open(os.path.join(prof, "trace_steps_4-4.json")) as f:
        assert json.load(f)["traceEvents"]

    # the validation sample at step 4: four tags; its images are the JAX
    # package's plots of the target mel and of the model's free-running mel
    events = _events(os.path.join(out, "logs", "run"))
    sample = {v.tag: v for step, v in events if v.tag.startswith("validation/")
              and step == 4 and not v.HasField("simple_value")}
    assert set(sample) == VALIDATION_TAGS
    u = TDataset(cfg.data.data_dir, cfg.data.valid_filelist)[0]
    model = TFS(config_from_dict(cfg.to_dict()), device="cpu")
    assert load_checkpoint(os.path.join(ckpt_dir, "ckpt_00000004.npz"), model)[0] == 4
    mel, out_lens, _ = model.inference(
        torch.from_numpy(np.asarray(u.tokens, np.int64)[None]),
        torch.tensor([len(u.tokens)], dtype=torch.int32),
        out_maxlen=max(2 * u.mel.shape[0], 64))
    pred = mel[0, : int(out_lens[0])].numpy().T
    np.testing.assert_array_equal(
        _png_chw(sample["validation/mel_target"].image.encoded_image_string),
        jplotting.plot_spectrogram_to_numpy(u.mel.T))
    np.testing.assert_array_equal(
        _png_chw(sample["validation/mel_predicted"].image.encoded_image_string),
        jplotting.plot_spectrogram_to_numpy(pred))
    audio = sample["validation/audio_predicted"].audio
    assert audio.sample_rate == 22050 and audio.length_frames == (pred.shape[1] - 1) * 256

    # train -p resumes at step 4
    tcli.main(["train", "-c", cfg_path, "-n", "run", "-o", out, "--max_steps", "1",
               "-p", os.path.join(ckpt_dir, "ckpt_00000004.npz"), "--device", "cpu"])
    assert "ckpt_00000005.npz" in os.listdir(ckpt_dir)
    with open(os.path.join(out, "logs", "run", "train_metrics.jsonl")) as f:
        steps = [json.loads(ln)["step"] for ln in f if "main/loss" in ln]
    assert steps == [1, 2, 3, 4, 5]


def test_validation_sample_audio_comes_from_the_vocoder(store, jax_ckpts, tmp_path):
    """With a neural vocoder (the loop loads MelGAN when train.melgan_vocoder
    and train.vocoder_checkpoint are set) both audio tags are the vocoder's
    output for the predicted and the target mel, not Griffin-Lim's."""
    from fastspeech2_tpu_torch.train.loop import _log_validation_sample
    from fastspeech2_tpu_torch.train.metrics import MetricsWriter

    cfg, _ = store
    _, weights, _ = jax_ckpts
    tcfg = config_from_dict(cfg.to_dict())
    model = load_jax_params(TFS(tcfg, device="cpu"), *weights[1])
    seen = []

    def vocoder(mel):  # (L, n_mels) -> (L * 256,)
        seen.append(np.array(mel))
        return np.full(len(mel) * 256, 0.25, np.float32)

    metrics = MetricsWriter(str(tmp_path / "logs"))
    _log_validation_sample(model, TDataset(cfg.data.data_dir, cfg.data.valid_filelist),
                           metrics, 7, tcfg, audio_steps=30, vocoder=vocoder)
    metrics.close()
    got = {v.tag: v for _, v in _events(str(tmp_path / "logs"))}
    assert set(got) == VALIDATION_TAGS
    u = TDataset(cfg.data.data_dir, cfg.data.valid_filelist)[0]
    assert len(seen) == 2 and seen[0].shape[0] > 5
    np.testing.assert_array_equal(seen[1], u.mel)
    for tag, mel in (("validation/audio_predicted", seen[0]),
                     ("validation/audio_target", seen[1])):
        assert got[tag].audio.length_frames == len(mel) * 256


def test_evaluate_matches_jax(store, jax_ckpts, capsys):
    cfg, _ = store
    jm, weights, paths = jax_ckpts
    tcli.main(["evaluate", "-p", paths[1], "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    params, state = weights[1]
    valid = JDataset(cfg.data.data_dir, cfg.data.valid_filelist)
    want = jevaluate(jm, JTrainState(params, state, None, 4), valid)
    assert sorted(got) == sorted(want) == ["Dur_Loss", "Energy_Loss", "Pitch_Loss"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_average_matches_jax(jax_ckpts, tmp_path):
    _, _, paths = jax_ckpts
    tcli.main(["average", *paths, "-o", str(tmp_path / "port.npz"), "--device", "cpu"])
    assert jckpt.average_checkpoints(paths, str(tmp_path / "jax.npz")) == 4
    with np.load(tmp_path / "port.npz") as g, np.load(tmp_path / "jax.npz") as r:
        assert sorted(g.files) == sorted(r.files)
        for k in r.files:
            if k != "__meta__":
                assert g[k].dtype == r[k].dtype
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    assert jckpt.load_checkpoint_meta(str(tmp_path / "port.npz"))["step"] == 4
    with pytest.raises(SystemExit, match="need at least 2 checkpoints"):
        tcli.main(["average", paths[0], "-o", str(tmp_path / "one.npz"), "--device", "cpu"])


def test_gta_matches_jax(store, jax_ckpts, tmp_path):
    cfg, _ = store
    jm, weights, paths = jax_ckpts
    tcli.main(["gta", "-p", paths[0], "-o", str(tmp_path / "port"), "--device", "cpu"])
    ds = JDataset(cfg.data.data_dir, cfg.data.train_filelist)
    assert jgenerate_gta(jm, *weights[0], ds, str(tmp_path / "jax")) == 16
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 16
    for n in names:
        got, want = np.load(tmp_path / "port" / n), np.load(tmp_path / "jax" / n)
        assert got.dtype == np.float32 and got.shape == want.shape and got.shape[0] == 80
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=n)


def test_bucketed_mel_call_matches_jax(store, jax_ckpts):
    """Six rows over three token buckets, in the caller's order: the same
    plan in both packages, the same lengths, mels within 1e-4."""
    cfg, _ = store
    jm, weights, _ = jax_ckpts
    params, state = weights[1]
    tm = load_jax_params(TFS(config_from_dict(cfg.to_dict()), device="cpu"), params, state)
    g = np.random.default_rng(4)
    seqs = [g.integers(1, 68, (n,)).astype(np.int32) for n in (70, 9, 40, 12, 75, 33)]
    js, ts = JSynth(jm, params, state, max_frames=1024), TSynth(tm, device="cpu", max_frames=1024)
    plan = ts._bucket_plan([len(s) for s in seqs], 3, 1.0)
    assert plan == js._bucket_plan([len(s) for s in seqs], 3, 1.0) == [[1, 3], [5, 2], [0, 4]]
    mt, lt = ts.mel_from_token_batch_bucketed(seqs, max_buckets=3)
    mj, lj = js.mel_from_token_batch_bucketed(seqs, max_buckets=3)
    np.testing.assert_array_equal(lt, lj)
    assert mt.shape == mj.shape and (lt > 5).all()
    np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cmd", ["train", "evaluate", "average", "gta", "convert"])
def test_new_commands_need_the_card_unless_asked(cmd, store, jax_ckpts, tmp_path):
    """Without ``--device cpu`` each new command raises without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg_path = store
    paths = jax_ckpts[2]
    argv = {"train": ["train", "-c", cfg_path, "-o", str(tmp_path), "--max_steps", "1"],
            "evaluate": ["evaluate", "-p", paths[0]],
            "average": ["average", *paths, "-o", str(tmp_path / "a.npz")],
            "gta": ["gta", "-p", paths[0], "-o", str(tmp_path)],
            "convert": ["convert", "-p", paths[0], "-o", str(tmp_path / "a.pth")]}[cmd]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)
    assert not os.path.exists(tmp_path / "a.npz") and not os.path.exists(tmp_path / "a.pth")
