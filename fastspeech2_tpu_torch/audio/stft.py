"""STFT + mel feature extraction (``fastspeech2_tpu/audio/stft.py``).

The reference computes the STFT as a Conv1d against a windowed Fourier basis
with reflect padding and the mel spectrogram as
``log(clamp(mel_basis @ |STFT|, min=1e-5))``. Here, as in the JAX package:

- framing is a strided view of the reflect-padded signal, and the DFT one f32
  matmul of the frames against the windowed ``[cos | -sin]`` basis;
- the mel filterbank is librosa's slaney-scale ``filters.mel`` (fmin=0,
  fmax=8000, 80 bins) in numpy;
- energy is the per-frame L2 norm over magnitude bins.

``MelSpectrogram.mel_and_energy`` runs the fused CUDA kernel
(``ops/kernels/stft.py``, kernel 14) for a CUDA tensor when
``n_fft == 4 * hop_length``, as the JAX package runs its Pallas kernel on a
TPU; otherwise the matmul path. The CPU path is the JAX package's XLA path.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from fastspeech2_tpu_torch.device import resolve_device


def hann_window(win_length: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window == scipy.signal.get_window('hann', n)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _hz_to_mel_slaney(hz):
    """Slaney mel scale (librosa default, htk=False)."""
    hz = np.asarray(hz, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = hz / f_sp
    log_region = hz >= min_log_hz
    mel = np.where(log_region, min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz_slaney(mel):
    mel = np.asarray(mel, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    hz = mel * f_sp
    log_region = mel >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (mel - min_log_mel)), hz)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sample_rate: int = 22050, n_fft: int = 1024, n_mels: int = 80,
    fmin: float = 0.0, fmax: Optional[float] = 8000.0,
) -> np.ndarray:
    """(n_mels, n_fft//2+1) slaney-normalized triangular mel filterbank,
    matching ``librosa.filters.mel`` defaults (htk=False, norm='slaney')."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)  # (n_mels+2,)

    fdiff = np.diff(hz_pts)  # (n_mels+1,)
    ramps = hz_pts[:, None] - fft_freqs[None, :]  # (n_mels+2, n_freqs)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # slaney normalization: equal area per filter
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _reflect_index(n: int, left: int, right: int) -> np.ndarray:
    return np.pad(np.arange(n), (left, right), mode="reflect")


def reflect_pad(y: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the last axis, numpy's way: a pad as long as the signal
    or longer reflects again and again (``np.pad``/``jnp.pad``), where
    ``F.pad(mode="reflect")`` raises."""
    n = y.shape[-1]
    if max(left, right) < n:
        return F.pad(y, (left, right), mode="reflect")
    idx = torch.from_numpy(_reflect_index(n, left, right)).to(y.device)
    return y[..., idx]


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(B, N) -> (B, n_frames, n_fft) with center reflect padding
    (librosa-style); a view of the padded signal."""
    pad = n_fft // 2
    return reflect_pad(y, pad, pad).unfold(-1, n_fft, hop_length)


@functools.lru_cache(maxsize=8)
def _dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed real-DFT basis (n_fft, 2*(n_fft//2+1)): [cos | -sin] columns.

    frames @ basis gives [real | imag] of the one-sided DFT of the windowed
    frame."""
    k = np.arange(n_fft // 2 + 1)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    window = hann_window(win_length).astype(np.float64)
    if win_length < n_fft:  # pad_center like the reference
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    return (basis * window[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def dft_basis(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    """``_dft_basis`` as an f32 tensor on ``device``, uploaded once (4 MB at
    n_fft 1024: Griffin-Lim needs it every iteration)."""
    return torch.from_numpy(_dft_basis(n_fft, win_length)).to(device)


def stft_magnitude_phase(
    y: torch.Tensor, n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) waveform in [-1, 1] -> (magnitude, phase), each (B, n_freq, n_frames)."""
    frames = frame_signal(y, n_fft, hop_length)  # (B, F, n_fft)
    spec = frames @ dft_basis(n_fft, win_length, y.device)  # (B, F, 2*n_freq)
    n_freq = n_fft // 2 + 1
    real = spec[..., :n_freq].transpose(1, 2)  # (B, n_freq, F)
    imag = spec[..., n_freq:].transpose(1, 2)
    magnitude = torch.sqrt(real * real + imag * imag)
    phase = torch.atan2(imag, real)
    return magnitude, phase


def energy_from_magnitude(magnitude: torch.Tensor) -> torch.Tensor:
    """Per-frame L2 norm over frequency bins."""
    return torch.sqrt(torch.sum(magnitude * magnitude, dim=-2))


def log_mel_magnitude(
    y: torch.Tensor, mel_basis: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
    win_length: int = 1024, clip_val: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) -> (log-mel (B, n_mels, F), magnitude (B, n_freq, F)) by the
    matmul path; the plain version of kernel 14 adds ``energy_from_magnitude``."""
    magnitude, _ = stft_magnitude_phase(y, n_fft, hop_length, win_length)
    mel = mel_basis.to(y.device) @ magnitude
    # dynamic range compression (dataset/audio_processing.py:243-249)
    return torch.log(torch.clamp(mel, min=clip_val)), magnitude


class MelSpectrogram:
    """TacotronSTFT equivalent: waveform -> (log-mel (B, n_mels, T),
    magnitude (B, n_freq, T)). ``device`` places the mel basis and the
    bucketed path's batches (None: the card)."""

    def __init__(self, sample_rate=22050, n_fft=1024, hop_length=256,
                 win_length=1024, n_mels=80, fmin=0.0, fmax=8000.0,
                 clip_val=1e-5, device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.clip_val = clip_val
        self.mel_basis = torch.from_numpy(
            mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)).to(self.device)

    def __call__(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return log_mel_magnitude(y, self.mel_basis, self.n_fft, self.hop_length,
                                 self.win_length, self.clip_val)

    def mel_and_energy_bucketed(self, wavs, bucket: int = 16384,
                                max_batch: int = 8):
        """Variable-length wavs -> [(log-mel (n_mels, F_i), energy (F_i,))]
        as numpy arrays, computed in batches of up to ``max_batch`` rows,
        each row zero-padded to a multiple of ``bucket`` samples (no padding
        rows: torch does not recompile per batch size).

        Sample-exact frame inputs: each wav is reflect-padded at its TRUE end
        on the host (the ``pad = n_fft//2`` tail of the center padding)
        before zero-extension, so every one of its ``N//hop + 1`` valid
        frames sees exactly the samples the unbatched transform sees; the
        batch's own right reflect only touches the zero tail, which lands in
        trimmed frames. Wavs no longer than ``pad`` take the per-utterance
        path.
        """
        pad = self.n_fft // 2
        out: list = [None] * len(wavs)
        groups: dict = {}
        for i, w in enumerate(wavs):
            w = np.asarray(w, np.float32)
            if len(w) <= pad:
                mel, e = self.mel_and_energy(torch.from_numpy(w)[None].to(self.device))
                out[i] = (mel[0].cpu().numpy(), e[0].cpu().numpy())
                continue
            n_pad = -(-(len(w) + pad) // bucket) * bucket
            groups.setdefault(n_pad, []).append(i)
        for n_pad, idxs in sorted(groups.items()):
            for c in range(0, len(idxs), max_batch):
                chunk = idxs[c : c + max_batch]
                ys = np.zeros((len(chunk), n_pad), np.float32)
                for row, i in enumerate(chunk):
                    w = np.asarray(wavs[i], np.float32)
                    ys[row, : len(w) + pad] = np.pad(w, (0, pad), mode="reflect")
                mel, e = self.mel_and_energy(torch.from_numpy(ys).to(self.device))
                mel, e = mel.cpu().numpy(), e.cpu().numpy()
                for row, i in enumerate(chunk):
                    F_i = len(wavs[i]) // self.hop_length + 1
                    out[i] = (mel[row, :, :F_i], e[row, :F_i])
        return out

    def mel_and_energy(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N) -> (log-mel (B, n_mels, F), energy (B, F)).

        On the card with n_fft == 4*hop this runs kernel 14
        (``ops/kernels/stft.py``), which raises for a hop its FFT does not
        take (``ops/kernels/stft.py:plan``), as the JAX package takes its
        Pallas kernel for every such hop; elsewhere the matmul path, which
        is the kernel's plain version."""
        from fastspeech2_tpu_torch.ops.kernels import stft as kernel

        run = (kernel.stft_mel_energy
               if y.device.type == "cuda" and self.n_fft == 4 * self.hop_length
               else kernel.stft_mel_energy_plain)
        return run(y, self.mel_basis.to(y.device), n_fft=self.n_fft,
                   hop_length=self.hop_length, win_length=self.win_length,
                   clip_val=self.clip_val)
