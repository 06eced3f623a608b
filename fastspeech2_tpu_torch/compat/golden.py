"""Released-checkpoint golden harness (``fastspeech2_tpu/compat/golden.py``).

The reference ships a golden artifact: ``sample/generated_mel_58k.npy``, the
(80, 423) float32 mel its 58k-step released checkpoint produced for the
README example sentence (the reference's ``README.md:57``,
``inference.py:143-178``), and vocoded samples beside it. The released
``.pyt``/``.pth`` files are not part of this repository, so the comparison
runs the moment a checkpoint is provided:

    FS2_RELEASED_CKPT=/path/to/ckpt.pyt python -m fastspeech2_tpu_torch golden

This module follows the reference's inference entry (``inference.py:133-
178``): load the checkpoint, rebuild the config from its embedded
``hp_str``, split the paragraph on '.', clean and g2p each sentence,
synthesize each on its own and concatenate the sentence mels. Synthesis is
the port's ``Synthesizer`` in the f32 parity tier (``matmul_precision=
"highest"``) on ``device`` (the card unless the caller passes ``"cpu"``);
MelGAN runs fused after it (kernel 13 in f32 on the card), WaveGlow as a
host-level vocoder; the spectral distances take ``audio/stft.py``'s
``MelSpectrogram`` (kernel 14 on the card).

The reference tree's checkout is ``$FS2_REFERENCE_DIR``; with it unset the
golden paths are None and a comparison needs its golden file passed. Released
checkpoints are the file ``$FS2_RELEASED_CKPT`` names, else looked for under
this checkout's ``checkpoints/released/`` and then the reference tree's
``checkpoints/``; vocoders likewise (``$FS2_MELGAN_CKPT``,
``$FS2_WAVEGLOW_CKPT``, ``checkpoints/melgan/``, ``checkpoints/waveglow/``).
Nothing outside this checkout is read unless a variable names it.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

_CHECKOUT = Path(__file__).resolve().parents[2]
#: the reference tree's checkout, or None
REFERENCE_DIR = os.environ.get("FS2_REFERENCE_DIR") or None


def _reference(*parts: str) -> Optional[str]:
    return os.path.join(REFERENCE_DIR, *parts) if REFERENCE_DIR else None


GOLDEN_MEL_PATH = _reference("sample", "generated_mel_58k.npy")

#: the README example sentence (the reference's README.md:57): the input the
#: released checkpoints are demonstrated on and the presumed golden-mel input
GOLDEN_TEXT = ("ModuleList can be indexed like a regular Python list but "
               "modules it contains are properly registered.")

#: places a released checkpoint is looked for, in order (first match wins);
#: FS2_RELEASED_CKPT overrides
_CKPT_GLOBS = [str(_CHECKOUT / "checkpoints" / "released" / "*.p*t*")] + (
    [_reference("checkpoints", "**", "*.p*t*")] if REFERENCE_DIR else [])

GOLDEN_WAVS = {
    "melgan": _reference("sample", "sample_74k_melgan.wav"),
    "waveglow": _reference("sample", "sample_74k_waveglow.wav"),
}

_VOCODER_ENV = {"melgan": "FS2_MELGAN_CKPT", "waveglow": "FS2_WAVEGLOW_CKPT"}
_VOCODER_GLOBS = {kind: [str(_CHECKOUT / "checkpoints" / kind / "*.p*t*")]
                  for kind in _VOCODER_ENV}

Device = Union[str, torch.device, None]


def _first_match(env: str, patterns: List[str]) -> Optional[str]:
    """The path ``env`` names (which must exist: a set path never turns the
    check it exists for into a silent skip), else the first glob hit."""
    path = os.environ.get(env)
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"{env}={path!r} does not exist")
        return path
    for pattern in patterns:
        hits = sorted(glob.glob(pattern, recursive=True))
        if hits:
            return hits[0]
    return None


def find_released_checkpoint() -> Optional[str]:
    """Path of a released reference checkpoint, or None if none is present."""
    return _first_match("FS2_RELEASED_CKPT", _CKPT_GLOBS)


def find_vocoder_checkpoint(kind: str) -> Optional[str]:
    """Path of a vocoder checkpoint of the given kind, or None;
    ``FS2_MELGAN_CKPT`` / ``FS2_WAVEGLOW_CKPT`` override."""
    return _first_match(_VOCODER_ENV[kind], _VOCODER_GLOBS[kind])


def _phoneme_strs(text: str, phoneme_strs: Optional[List[str]], g2p) -> List[str]:
    from fastspeech2_tpu_torch.text.g2p import preprocess_text, process_paragraph

    if phoneme_strs is None:
        sentences = [s for s in process_paragraph(text) if s.strip()]
        phoneme_strs = [preprocess_text(s, g2p=g2p) for s in sentences]
    return [p for p in phoneme_strs if p]


def _parity_synthesizer(ckpt_path: str, device: Device):
    """(Synthesizer in the f32 parity tier, cfg, step) of a reference
    checkpoint, its config rebuilt from the embedded ``hp_str``."""
    from fastspeech2_tpu_torch.compat.torch_loader import load_torch_model
    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer

    dev = resolve_device(device)
    cfg, step, model = load_torch_model(ckpt_path, None, dev)
    return Synthesizer(model, device=dev, matmul_precision="highest"), cfg, step


def synth_with_torch_checkpoint(ckpt_path: str, text: str = GOLDEN_TEXT,
                                phoneme_strs: Optional[List[str]] = None, g2p=None,
                                device: Device = None) -> Tuple[np.ndarray, object, int]:
    """Reference-format checkpoint + text -> (mel (n_mels, frames), cfg,
    step), the layout of ``sample/generated_mel_58k.npy``.

    phoneme_strs: pre-computed space-joined phoneme strings (one per
    sentence) in place of g2p, to reproduce the exact g2p_en tokenization
    the golden mel was made with where g2p_en is not installed."""
    synth, cfg, step = _parity_synthesizer(ckpt_path, device)
    mels = [synth.synth_phonemes(p) for p in _phoneme_strs(text, phoneme_strs, g2p)]
    if not mels:
        raise ValueError(f"input produced no phonemes: {text!r}")
    mel = np.concatenate(mels, axis=0)  # (frames, n_mels)
    return mel.T.astype(np.float32), cfg, step


def synth_wav_with_torch_checkpoints(acoustic_ckpt: str, vocoder_ckpt: str,
                                     kind: str = "auto", text: str = GOLDEN_TEXT,
                                     phoneme_strs: Optional[List[str]] = None, g2p=None,
                                     melgan_cfg=None, device: Device = None
                                     ) -> Tuple[np.ndarray, int, int]:
    """Reference acoustic checkpoint + vocoder checkpoint + text -> (wav
    float32 in [-1, 1], sample_rate, step): the reference's audio path
    (``inference.py:133-201``), sentence wavs concatenated. MelGAN runs on
    the fused text->wav path (``Synthesizer.attach_vocoder``), WaveGlow,
    which draws noise, after it (``attach_vocoder_fn``). melgan_cfg: a
    ``vocoder.MelGANConfig`` for a generator of other widths (default: read
    from the checkpoint's shapes)."""
    from fastspeech2_tpu_torch.text import phonemes_to_sequence
    from fastspeech2_tpu_torch.vocoder import (detect_vocoder_kind, load_melgan_params,
                                               load_waveglow, melgan_config_from_checkpoint)

    synth, cfg, step = _parity_synthesizer(acoustic_ckpt, device)
    if kind == "auto":
        kind = detect_vocoder_kind(vocoder_ckpt)
    if kind == "melgan":
        mcfg = melgan_cfg if melgan_cfg is not None else melgan_config_from_checkpoint(
            vocoder_ckpt)
        synth.attach_vocoder(load_melgan_params(vocoder_ckpt, mcfg, device=synth.device))
    elif kind == "waveglow":
        synth.attach_vocoder_fn(load_waveglow(vocoder_ckpt, device=synth.device))
    else:
        raise ValueError(f"unknown vocoder kind {kind!r}")
    pieces = []
    for p in _phoneme_strs(text, phoneme_strs, g2p):
        seq = np.asarray(phonemes_to_sequence(p), np.int64)
        _, wav, wav_lens = synth.wav_from_token_batch([seq])
        pieces.append(np.asarray(wav[0, : int(wav_lens[0])]))
    if not pieces:
        raise ValueError(f"input produced no phonemes: {text!r}")
    wav = np.concatenate(pieces)
    if wav.dtype == np.int16:  # the fused MelGAN path emits int16 PCM
        wav = wav.astype(np.float32) / 32768.0
    return wav.astype(np.float32), cfg.audio.sample_rate, step


def log_mel_distance(wav_a: np.ndarray, wav_b: np.ndarray, sample_rate: int = 22050,
                     device: Device = None) -> dict:
    """Spectral distance between two waveforms: L1/RMS over log-mel frames
    (the domain the acoustic model is trained in) over the overlapping
    prefix, with the port's reference-parity mel extractor. Also the
    duration ratio: a tokenization drift shows there, not in the spectral
    numbers."""
    from fastspeech2_tpu_torch.audio.stft import MelSpectrogram

    mel_fn = MelSpectrogram(sample_rate, 1024, 256, 1024, 80, 0.0, 8000.0, device=device)

    def logmel(w):
        y = torch.from_numpy(np.asarray(w, np.float32)[None]).to(mel_fn.device)
        m, _ = mel_fn.mel_and_energy(y)
        return m[0].cpu().numpy()  # (n_mels, frames)

    a, b = logmel(wav_a), logmel(wav_b)
    frames = min(a.shape[1], b.shape[1])
    d = a[:, :frames] - b[:, :frames]
    return {
        "frames_compared": int(frames),
        "duration_ratio": float(len(wav_a) / max(len(wav_b), 1)),
        "log_mel_l1": float(np.mean(np.abs(d))),
        "log_mel_rms": float(np.sqrt(np.mean(d ** 2))),
    }


def compare_to_golden_wav(wav: np.ndarray, sample_rate: int, kind: str = "melgan",
                          golden_path: Optional[str] = None,
                          device: Device = None) -> dict:
    """Spectral-distance report of a synthesized wav against the published
    sample (``sample_74k_melgan.wav`` / ``sample_74k_waveglow.wav``)."""
    from scipy.io.wavfile import read as read_wav

    path = golden_path or GOLDEN_WAVS[kind]
    if path is None:
        raise FileNotFoundError(
            f"no golden {kind} wav: pass its path or set FS2_REFERENCE_DIR")
    sr, golden = read_wav(path)
    if golden.dtype == np.int16:
        golden = golden / 32768.0
    report = {"golden_path": path, "golden_sr": int(sr),
              "sr_match": int(sr) == int(sample_rate),
              "golden_samples": int(len(golden)), "samples": int(len(wav))}
    report.update(log_mel_distance(wav, golden.astype(np.float32), sample_rate, device))
    return report


def compare_to_golden(mel: np.ndarray, golden_path: Optional[str] = None) -> dict:
    """MAE/shape report of an (n_mels, frames) mel against the golden
    artifact. When the frame counts differ (a g2p tokenization drift
    changes the predicted durations) the MAE is over the overlapping
    prefix; ``frames_match`` says whether the comparison is the exact
    golden contract."""
    golden_path = golden_path or GOLDEN_MEL_PATH
    if golden_path is None:
        raise FileNotFoundError("no golden mel: pass its path or set FS2_REFERENCE_DIR")
    golden = np.load(golden_path)
    frames = min(mel.shape[1], golden.shape[1])
    diff = np.abs(mel[:, :frames] - golden[:, :frames])
    return {
        "mel_shape": tuple(mel.shape),
        "golden_shape": tuple(golden.shape),
        "frames_match": mel.shape == golden.shape,
        "mae_overlap": float(np.mean(diff)),
        "max_abs_overlap": float(np.max(diff)),
    }
