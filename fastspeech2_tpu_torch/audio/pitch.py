"""F0 (pitch) extraction for preprocessing (``fastspeech2_tpu/audio/pitch.py``).

The reference uses PyWORLD's DIO with frame_period = hop/sr*1000 and the
default f0 range [71, 800] Hz. Host-side work, in the JAX package's order:

- ``pyworld`` when importable (exact parity with the reference's store);
- otherwise the port's native C++ DIO-style estimator
  (``fastspeech2_tpu_torch/native/dio.cc``, the same algorithm family, not
  bit-identical to WORLD);
- a pure-Python normalized-autocorrelation tracker as the last resort, so
  the pipeline runs without a C++ toolchain.

The same machine gives the port and the JAX package the same branch.
"""

from __future__ import annotations

import numpy as np

F0_FLOOR = 71.0
F0_CEIL = 800.0


def extract_pitch(wav: np.ndarray, sample_rate: int, hop_length: int) -> np.ndarray:
    """Waveform [-1,1] float -> per-frame F0 in Hz (0 for unvoiced)."""
    try:
        import pyworld as pw  # type: ignore

        f0, _ = pw.dio(
            wav.astype(np.float64), sample_rate,
            frame_period=hop_length / sample_rate * 1000,
        )
        return f0
    except (ImportError, AttributeError):
        # AttributeError: a stub/broken pyworld module -- fall through to DIO
        pass
    from fastspeech2_tpu_torch import native

    if native.available():
        return native.dio(wav, sample_rate, hop_length,
                          F0_FLOOR, F0_CEIL).astype(np.float64)
    return _autocorr_pitch(wav, sample_rate, hop_length)


def _autocorr_pitch(
    wav: np.ndarray, sample_rate: int, hop_length: int,
    f0_floor: float = F0_FLOOR, f0_ceil: float = F0_CEIL,
    voicing_threshold: float = 0.3,
) -> np.ndarray:
    """Normalized autocorrelation F0 tracker (fallback, not DIO-parity).

    Frame length is two full periods of f0_floor; a frame is voiced when the
    best normalized autocorrelation peak exceeds ``voicing_threshold``.
    """
    wav = wav.astype(np.float64)
    lag_min = int(sample_rate / f0_ceil)
    lag_max = int(sample_rate / f0_floor)
    frame_len = 2 * lag_max
    n_frames = len(wav) // hop_length + 1
    pad = frame_len
    x = np.pad(wav, (0, pad))
    f0 = np.zeros(n_frames)
    for i in range(n_frames):
        s = i * hop_length
        frame = x[s : s + frame_len]
        frame = frame - frame.mean()
        e0 = np.dot(frame[:lag_max], frame[:lag_max])
        if e0 < 1e-9:
            continue
        best_corr, best_lag = 0.0, 0
        base = frame[:lag_max]
        for lag in range(lag_min, lag_max):
            seg = frame[lag : lag + lag_max]
            denom = np.sqrt(e0 * np.dot(seg, seg))
            if denom < 1e-12:
                continue
            corr = np.dot(base, seg) / denom
            if corr > best_corr:
                best_corr, best_lag = corr, lag
        if best_corr > voicing_threshold and best_lag > 0:
            f0[i] = sample_rate / best_lag
    return f0
