"""Command-line entry points of the port (``fastspeech2_tpu/cli.py``):

    python -m fastspeech2_tpu_torch preprocess -d WAV_DIR -c CONFIG [--device cpu]
    python -m fastspeech2_tpu_torch stats -c CONFIG [-d DATA_DIR]

``preprocess`` turns a folder of wavs into the feature store that
``data/dataset.py`` and ``train.loop.train`` read (``mels/``, ``energy/``,
``pitch/`` .npy per utterance); ``stats`` prints the energy and pitch
statistics of that store for the config's ``data:`` section. The other
subcommands of the JAX package are not ported yet.
"""

from __future__ import annotations

import argparse
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

    args = p.parse_args(argv)
    args.fn(args)
