"""Misc audio transforms (reference ``dataset/audio_processing.py:11-52,97-146``):
mu-law companding, amplitude/dB conversion, bit-label/float conversion,
spectrogram normalization. Host-side numpy (preprocessing-path helpers); the
port's own copy of ``fastspeech2_tpu/audio/processing.py``."""

from __future__ import annotations

import math

import numpy as np


def label_2_float(x, bits: int):
    return 2 * x / (2 ** bits - 1.0) - 1.0


def float_2_label(x, bits: int):
    assert np.abs(x).max() <= 1.0
    x = (x + 1.0) * (2 ** bits - 1) / 2
    return np.clip(x, 0, 2 ** bits - 1)


def encode_16bits(x):
    return np.clip(x * 2 ** 15, -(2 ** 15), 2 ** 15 - 1).astype(np.int16)


def split_signal(x):
    unsigned = x + 2 ** 15
    return unsigned // 256, unsigned % 256


def combine_signal(coarse, fine):
    return coarse * 256 + fine - 2 ** 15


def encode_mu_law(x, mu: int):
    mu = mu - 1
    fx = np.sign(x) * np.log(1 + mu * np.abs(x)) / np.log(1 + mu)
    return np.floor((fx + 1) / 2 * mu + 0.5)


def decode_mu_law(y, mu: int, from_labels: bool = True):
    if from_labels:
        y = label_2_float(y, math.log2(mu))
    mu = mu - 1
    return np.sign(y) / mu * ((1 + mu) ** np.abs(y) - 1)


def amp_to_db(x):
    return 20 * np.log10(np.maximum(1e-5, x))


def db_to_amp(x):
    return np.power(10.0, x * 0.05)


def normalize_db(S, min_level_db: float):
    """dB spectrogram -> [0, 1] (reference audio_processing.py:89-90)."""
    return np.clip((S - min_level_db) / -min_level_db, 0, 1)


def denormalize_db(S, min_level_db: float):
    return (np.clip(S, 0, 1) * -min_level_db) + min_level_db
