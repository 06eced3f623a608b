"""Command-line entry points of the port (``fastspeech2_tpu/cli.py``):

    python -m fastspeech2_tpu_torch preprocess -d WAV_DIR -c CONFIG [--device cpu]
    python -m fastspeech2_tpu_torch stats -c CONFIG [-d DATA_DIR]
    python -m fastspeech2_tpu_torch train -c CONFIG -n NAME -o OUTDIR [-p CKPT] [--device cpu]
    python -m fastspeech2_tpu_torch evaluate -p CKPT [-c CONFIG] [--device cpu]
    python -m fastspeech2_tpu_torch average CKPT CKPT ... -o OUT.npz [--device cpu]
    python -m fastspeech2_tpu_torch gta -p CKPT -o OUT_DIR [--filelist FL] [--device cpu]
    python -m fastspeech2_tpu_torch convert -p SRC -o DST [-c CONFIG] [--device cpu]
    python -m fastspeech2_tpu_torch synth -p CKPT --text "..." [--phonemes] -o OUT [--device cpu]
    python -m fastspeech2_tpu_torch serve -p CKPT [--port 8000] [--warmup] [--device cpu]

``preprocess`` turns a folder of wavs into the feature store that
``data/dataset.py`` and ``train`` read (``mels/``, ``energy/``, ``pitch/``
.npy per utterance); ``stats`` prints the energy and pitch statistics of that
store for the config's ``data:`` section. ``train`` runs
``train/loop.py:train`` (``-p`` resumes), ``evaluate`` prints the predictors'
teacher-forced L1 losses on the validation set, ``average`` writes the
uniform average of checkpoints, ``gta`` dumps ground-truth-aligned mels for a
vocoder (``train/gta.py``), and ``convert`` moves weights between the
``.npz`` checkpoints and the reference's ``.pth``/``.pyt`` format by file
extension (``compat/``). ``synth`` writes one sentence's mel (``mel.npy``,
(n_mels, L)) and wav (``test_tts.wav``, Griffin-Lim or ``--vocoder`` MelGAN)
in the f32 tier, from a ``.npz`` checkpoint of either package or a reference
``.pth``; ``serve`` runs the micro-batching HTTP server (``infer/server.py``),
bf16 on the card, from a ``.npz`` only (as the JAX package's ``serve``). Both
build a seeded random model from ``-c`` without ``-p``. Every command but
``stats`` takes ``--device``: the card unless ``--device cpu`` is given, and
without a GPU it raises. ``golden`` and ``export`` are not ported yet.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import logging
import os

import numpy as np

#: wavs read, featurised and written per pass of ``preprocess``
CHUNK = 64


def read_wav_float(path: str, sample_rate: int, peak_norm: bool = False) -> np.ndarray:
    """16/32-bit PCM or float wav -> float32 in [-1, 1], checked against the
    config's sample rate; optionally normalised to the file's peak."""
    from scipy.io.wavfile import read as read_wav

    sr, wav = read_wav(path)
    if wav.dtype == np.int16:
        wav = wav / 32768.0
    elif wav.dtype == np.int32:
        wav = wav / 2147483648.0
    assert sr == sample_rate, f"{path}: sr {sr} != {sample_rate}"
    wav = wav.astype(np.float32)
    if peak_norm:  # normalise to the peak of each wav file
        peak = np.abs(wav).max()
        if peak > 0:
            wav = wav / peak
    return wav


def cmd_preprocess(args):
    """wav -> (mel, energy, pitch) .npy per utterance (nvidia_preprocessing.py).

    Mel and energy run in length-bucketed batches on ``--device`` (kernel 14
    on the card); pitch is per-utterance host DIO, cut to the mel length."""
    from fastspeech2_tpu_torch.audio.pitch import extract_pitch
    from fastspeech2_tpu_torch.audio.stft import MelSpectrogram
    from fastspeech2_tpu_torch.config import load_config

    cfg = load_config(args.config)
    a = cfg.audio
    mel_fn = MelSpectrogram(a.sample_rate, a.n_fft, a.hop_length, a.win_length,
                            a.n_mels, a.fmin, a.fmax, device=args.device)
    out_root = args.out or cfg.data.data_dir
    for sub in ("mels", "energy", "pitch"):
        os.makedirs(os.path.join(out_root, sub), exist_ok=True)
    # -d overrides; otherwise data.wav_dir from the config
    wav_root = args.data_path or cfg.data.wav_dir
    wavs = sorted(glob.glob(os.path.join(wav_root, "**", "*.wav"), recursive=True))
    if not wavs:
        # exiting 0 with empty mels/energy/pitch dirs would surface much
        # later as an inexplicably empty feature store at train time
        raise SystemExit(
            f"preprocess: no .wav files under {wav_root!r} "
            "(pass -d or set data.wav_dir in the config)")
    logging.info("preprocessing %d wavs -> %s on %s", len(wavs), out_root,
                 mel_fn.device)
    for c in range(0, len(wavs), CHUNK):
        paths = wavs[c : c + CHUNK]
        signals = [read_wav_float(p, a.sample_rate, a.peak_norm) for p in paths]
        feats = mel_fn.mel_and_energy_bucketed(signals)
        for path, wav, (mel, e) in zip(paths, signals, feats):
            p = extract_pitch(wav, a.sample_rate, a.hop_length)
            p = p[: mel.shape[1]]
            utt = os.path.basename(path).split(".")[0]
            np.save(os.path.join(out_root, "mels", f"{utt}.npy"), mel)
            np.save(os.path.join(out_root, "energy", f"{utt}.npy"), e)
            np.save(os.path.join(out_root, "pitch", f"{utt}.npy"), p.astype(np.float64))


def cmd_stats(args):
    """Dataset energy/pitch statistics to paste into the config
    (compute_statistics.py): mean/std over nonzero values after the outlier
    filter, the nonzero minima, the maxima; the means and stds also land in
    the store as ``{e,f0}_{mean,std}.npy``."""
    from fastspeech2_tpu_torch.config import load_config
    from fastspeech2_tpu_torch.data.dataset import remove_outlier

    cfg = load_config(args.config)
    root = args.data_dir or cfg.data.data_dir
    out = {}
    for kind, mean_key, cfg_key in (("energy", "e", "e"), ("pitch", "f0", "p")):
        vecs = []
        for f in sorted(glob.glob(os.path.join(root, kind, "*.npy"))):
            vecs.append(remove_outlier(np.load(f)))
        if not vecs:
            logging.warning("no %s files under %s", kind, root)
            continue
        nz = np.concatenate([v[v != 0.0] for v in vecs])
        if nz.size == 0:
            logging.warning("all %s values zero after outlier filtering", kind)
            continue
        out[f"{mean_key}_mean"] = float(nz.mean())
        out[f"{mean_key}_std"] = float(nz.std())
        out[f"{cfg_key}_min"] = float(min(v[v > 0].min() for v in vecs if (v > 0).any()))
        out[f"{cfg_key}_max"] = float(max(v.max() for v in vecs))
        np.save(os.path.join(root, f"{mean_key}_mean.npy"), np.float32(out[f"{mean_key}_mean"]))
        np.save(os.path.join(root, f"{mean_key}_std.npy"), np.float32(out[f"{mean_key}_std"]))
    # drift check: a large mismatch means the config was written for another
    # dataset than the store, and the pitch/energy bin edges would be wrong
    d = cfg.data
    for key, cfg_val in (("e_mean", d.e_mean), ("e_std", d.e_std),
                         ("f0_mean", d.f0_mean), ("f0_std", d.f0_std),
                         ("e_min", d.e_min), ("e_max", d.e_max),
                         ("p_min", d.p_min), ("p_max", d.p_max)):
        if key in out and cfg_val and \
                abs(out[key] - cfg_val) > 0.25 * max(abs(cfg_val), 1e-6):
            logging.warning(
                "config data.%s=%.4g but this dataset measures %.4g "
                "(>25%% off) -- update the data: section or the "
                "pitch/energy bins will misquantize", key, cfg_val, out[key])
    print(json.dumps(out, indent=1))


TORCH_EXTS = (".pth", ".pyt", ".pt")


@contextlib.contextmanager
def _log_to_file(outdir: str, name: str):
    """Also log to ``outdir/name.log`` (the JAX command's run log)."""
    os.makedirs(outdir, exist_ok=True)
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    handler = logging.FileHandler(os.path.join(outdir, f"{name}.log"))
    handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    root.addHandler(handler)
    try:
        yield
    finally:
        root.removeHandler(handler)
        handler.close()


def _config(args):
    """The ``-c`` config, else the one embedded in the ``.npz`` checkpoint."""
    from fastspeech2_tpu_torch.config import Config, load_config
    from fastspeech2_tpu_torch.train.checkpoint import load_checkpoint_meta

    if args.config:
        return load_config(args.config)
    return Config.from_yaml(load_checkpoint_meta(args.checkpoint_path)["hp_yaml"])


def _load_model(args, device, reference_format: bool):
    """(cfg, model on ``device``): a ``.npz`` checkpoint of either package
    with its embedded config (``-p``); with ``reference_format`` also a
    reference ``.pth``/``.pyt``/``.pt`` (config from ``-c``, else its
    ``hp_str``); else a random init from seed 0 of the ``-c`` config (smoke
    runs)."""
    import torch

    from fastspeech2_tpu_torch.config import Config, load_config
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.train.checkpoint import load_checkpoint, load_checkpoint_meta

    path = args.checkpoint_path
    if path and path.endswith(TORCH_EXTS):
        if not reference_format:
            raise SystemExit(
                f"{path}: serve reads .npz checkpoints only, as the JAX package's serve "
                f"does; convert it first: python -m fastspeech2_tpu_torch convert -p {path} "
                "-o model.npz")
        from fastspeech2_tpu_torch.compat.torch_loader import load_torch_model

        cfg, _, model = load_torch_model(
            path, load_config(args.config) if args.config else None, device)
    elif path:
        cfg = Config.from_yaml(load_checkpoint_meta(path)["hp_yaml"])
        model = FastSpeech2(cfg, device=device)
        load_checkpoint(path, model)
    else:
        cfg = load_config(args.config)
        model = FastSpeech2(cfg, device=device, generator=torch.Generator().manual_seed(0))
    return cfg, model


def cmd_train(args):
    """``train/loop.py:train`` from a config (train_fastspeech.py); ``-p``
    resumes. On the card the run ends with the kernels' launch counts."""
    from fastspeech2_tpu_torch.config import load_config
    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.ops.kernels import launch_counts
    from fastspeech2_tpu_torch.train.loop import train

    device = resolve_device(args.device)
    with _log_to_file(args.outdir, args.name):
        train(load_config(args.config), args.name, args.outdir,
              resume_path=args.checkpoint_path, max_steps=args.max_steps,
              data_dir=args.data_dir, profile_dir=args.profile_dir, device=device)
        if device.type == "cuda":
            logging.info("kernel launches: %s", json.dumps(launch_counts()))


def cmd_evaluate(args):
    """Teacher-forced L1 of the duration, energy and pitch predictions over
    the validation set (evaluation.py), printed as JSON."""
    from fastspeech2_tpu_torch.data.dataset import TTSDataset
    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.train.checkpoint import load_checkpoint
    from fastspeech2_tpu_torch.train.loop import evaluate_predictors

    device = resolve_device(args.device)
    model = FastSpeech2(_config(args), device=device)
    _, cfg = load_checkpoint(args.checkpoint_path, model)
    valid = TTSDataset(args.data_dir or cfg.data.data_dir, cfg.data.valid_filelist,
                       cfg.train.use_phonemes, cfg.data.tts_cleaner_names)
    print(json.dumps(evaluate_predictors(model, valid), indent=1))


def cmd_gta(args):
    """Ground-truth-aligned mels, (n_mels, L) .npy per utterance, for vocoder
    finetuning (train/gta.py)."""
    from fastspeech2_tpu_torch.data.dataset import TTSDataset
    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.train.checkpoint import load_checkpoint
    from fastspeech2_tpu_torch.train.gta import generate_gta

    device = resolve_device(args.device)
    model = FastSpeech2(_config(args), device=device)
    _, cfg = load_checkpoint(args.checkpoint_path, model)
    ds = TTSDataset(args.data_dir or cfg.data.data_dir,
                    args.filelist or cfg.data.train_filelist,
                    cfg.train.use_phonemes, cfg.data.tts_cleaner_names)
    generate_gta(model, ds, args.out)


def cmd_convert(args):
    """Checkpoint conversion by extension: .npz <-> .pth/.pyt (compat/), so
    models trained here deploy on the reference and back."""
    from fastspeech2_tpu_torch.config import Config, load_config
    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.train.checkpoint import (load_checkpoint, load_checkpoint_meta,
                                                        save_checkpoint)

    device = resolve_device(args.device)
    src, dst = args.checkpoint_path, args.out
    if src.endswith(".npz") and dst.endswith(TORCH_EXTS):
        from fastspeech2_tpu_torch.compat.torch_saver import save_torch_checkpoint

        cfg = Config.from_yaml(load_checkpoint_meta(src)["hp_yaml"])
        model = FastSpeech2(cfg, device=device)
        step, _ = load_checkpoint(src, model)
        save_torch_checkpoint(dst, model, cfg, step=step)
        logging.info("wrote reference-format checkpoint %s (step %d)", dst, step)
    elif src.endswith(TORCH_EXTS) and dst.endswith(".npz"):
        from fastspeech2_tpu_torch.compat.torch_loader import load_torch_model

        cfg, step, model = load_torch_model(
            src, load_config(args.config) if args.config else None, device)
        save_checkpoint(dst, model, None, step, cfg)
        logging.info("wrote native checkpoint %s (step %d)", dst, step)
    else:
        raise SystemExit(
            f"unsupported conversion {src} -> {dst}: use .npz <-> .pth/.pyt")


def cmd_average(args):
    """Uniform average of N same-config checkpoints into one deployment
    checkpoint (train/checkpoint.py:average_checkpoints). The average is
    taken in float64 on the host whatever the device."""
    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.train.checkpoint import average_checkpoints

    resolve_device(args.device)
    if len(args.checkpoints) < 2:  # a 1-file glob is a usage error, not a bug
        raise SystemExit("average: need at least 2 checkpoints "
                         f"(got {args.checkpoints})")
    step = average_checkpoints(args.checkpoints, args.out)
    logging.info("wrote %s (uniform average of %d checkpoints, step %d)",
                 args.out, len(args.checkpoints), step)


def cmd_synth(args):
    """One sentence -> mel.npy (n_mels, L) and test_tts.wav (inference.py),
    in the f32 tier: the Synthesizer gets no bf16, so no kernel runs."""
    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer, vocode, write_wav

    device = resolve_device(args.device)
    cfg, model = _load_model(args, device, reference_format=True)
    synth = Synthesizer(model, device=device)
    if args.phonemes:
        mel = synth.synth_phonemes(args.text, alpha=args.alpha)
        stats = {"frames": int(mel.shape[0])}
    else:
        mel, stats = synth.synth_text(args.text, alpha=args.alpha)
    logging.info("synthesized %s frames (%s)", mel.shape[0], stats)
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "mel.npy"), mel.T)  # (n_mels, L) like the ref
    try:  # mel.png artifact (reference inference.py:177-178); best-effort
        from fastspeech2_tpu_torch.utils.plotting import save_spectrogram_png

        save_spectrogram_png(mel.T, os.path.join(args.out, "mel.png"))
    except Exception as exc:
        logging.warning("mel.png not written: %s", exc)
    vocoder = None
    vocoder_path = args.vocoder or cfg.train.vocoder_checkpoint
    if vocoder_path:
        from fastspeech2_tpu_torch.vocoder import detect_vocoder_kind, load_vocoder

        kind = detect_vocoder_kind(vocoder_path)
        vocoder = load_vocoder(vocoder_path, kind=kind, device=device)
        logging.info("vocoding with %s checkpoint %s", kind, vocoder_path)
    wav = vocode(mel, cfg, vocoder=vocoder, device=device)
    write_wav(os.path.join(args.out, "test_tts.wav"), wav, cfg.audio.sample_rate)
    logging.info("wrote %s", os.path.join(args.out, "test_tts.wav"))


def cmd_serve(args):
    """Micro-batching HTTP synthesis server (infer/server.py), bf16 on the
    card; blocks until the process is stopped."""
    import time

    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.infer.server import serve
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer

    device = resolve_device(args.device)
    cfg, model = _load_model(args, device, reference_format=False)
    on_card = device.type == "cuda"
    synth = Synthesizer(model, bf16=on_card, device=device)
    vocoder_path = args.vocoder or cfg.train.vocoder_checkpoint
    if vocoder_path:
        from fastspeech2_tpu_torch.vocoder import (detect_vocoder_kind, load_melgan_params,
                                                   load_vocoder)

        kind = detect_vocoder_kind(vocoder_path)
        if kind != "melgan":
            load_vocoder(vocoder_path, kind=kind)  # raises: WaveGlow is not ported
        # fused text->wav: MelGAN runs on the device right after the model
        synth.attach_vocoder(load_melgan_params(vocoder_path, bf16=on_card, device=device))
        logging.info("serving wav fused with MelGAN checkpoint %s", vocoder_path)
    if args.warmup:
        t0 = time.perf_counter()
        n = synth.warmup(batch_sizes=(1, args.max_batch))
        logging.info("warmed %d serving shapes in %.1fs", n, time.perf_counter() - t0)
    serve(synth, cfg, host=args.host, port=args.port, max_batch=args.max_batch,
          max_wait_ms=args.max_wait_ms)


def main(argv=None):
    p = argparse.ArgumentParser(prog="fastspeech2_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("preprocess")
    sp.add_argument("-d", "--data_path", default=None,
                    help="wav root; defaults to data.wav_dir from the config")
    sp.add_argument("-c", "--config", default=None)
    sp.add_argument("-o", "--out", default=None)
    sp.add_argument("--device", default=None,
                    help="torch device of the mel/energy batches (default: cuda)")
    sp.set_defaults(fn=cmd_preprocess)

    sp = sub.add_parser("stats")
    sp.add_argument("-c", "--config", default=None)
    sp.add_argument("-d", "--data_dir", default=None)
    sp.set_defaults(fn=cmd_stats)

    sp = sub.add_parser("train")
    sp.add_argument("-c", "--config", default=None)
    sp.add_argument("-n", "--name", default="fastspeech2")
    sp.add_argument("-o", "--outdir", default="./out")
    sp.add_argument("-p", "--checkpoint_path", default=None,
                    help=".npz checkpoint of either package to resume from")
    sp.add_argument("-d", "--data_dir", default=None)
    sp.add_argument("--max_steps", type=int, default=None)
    sp.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler Chrome trace of a few warm steps here")
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("gta")
    sp.add_argument("-p", "--checkpoint_path", required=True)
    sp.add_argument("-c", "--config", default=None)
    sp.add_argument("-d", "--data_dir", default=None)
    sp.add_argument("--filelist", default=None)
    sp.add_argument("-o", "--out", required=True)
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_gta)

    sp = sub.add_parser("synth")
    sp.add_argument("-p", "--checkpoint_path", default=None,
                    help=".npz checkpoint (its embedded config is used) or a "
                         "reference .pth/.pyt (config from -c, else its hp_str)")
    sp.add_argument("-c", "--config", default=None,
                    help="config of a random init from seed 0 (without -p)")
    sp.add_argument("--text", required=True)
    sp.add_argument("--phonemes", action="store_true",
                    help="treat --text as a space-joined phoneme string")
    sp.add_argument("--alpha", type=float, default=1.0)
    sp.add_argument("--vocoder", default=None,
                    help="local seungwonpark-format MelGAN checkpoint "
                         "(else Griffin-Lim)")
    sp.add_argument("-o", "--out", default="./synth_out")
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_synth)

    sp = sub.add_parser("serve")
    sp.add_argument("-p", "--checkpoint_path", default=None,
                    help=".npz checkpoint; its embedded config is used")
    sp.add_argument("-c", "--config", default=None,
                    help="config of a random init from seed 0 (without -p)")
    sp.add_argument("--host", default="0.0.0.0")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--max_batch", type=int, default=16)
    sp.add_argument("--max_wait_ms", type=float, default=5.0)
    sp.add_argument("--vocoder", default=None,
                    help="local MelGAN checkpoint for wav responses "
                         "(else Griffin-Lim)")
    sp.add_argument("--warmup", action="store_true",
                    help="run every pow2 batch bucket up to --max_batch at "
                         "common token lengths before binding the port")
    sp.add_argument("--device", default=None,
                    help="torch device (default: cuda, in bf16; cpu runs f32)")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("evaluate")
    sp.add_argument("-p", "--checkpoint_path", required=True)
    sp.add_argument("-c", "--config", default=None)
    sp.add_argument("-d", "--data_dir", default=None)
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("convert")
    sp.add_argument("-p", "--checkpoint_path", required=True)
    sp.add_argument("-o", "--out", required=True)
    sp.add_argument("-c", "--config", default=None,
                    help="override config for .pth sources (default: the "
                         "checkpoint's embedded hp_str)")
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_convert)

    sp = sub.add_parser("average")
    sp.add_argument("checkpoints", nargs="+",
                    help="two or more .npz checkpoints of the same config")
    sp.add_argument("-o", "--out", required=True)
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_average)

    args = p.parse_args(argv)
    args.fn(args)
