"""Griffin-Lim phase recovery, the vocoder when none is attached
(``fastspeech2_tpu/audio/griffin_lim.py``).

The reference iterates ``inverse -> transform`` 30 times over its conv-STFT
pair; here it is a loop over the matmul STFT/iSTFT in f32 on the tensor's
device. The iSTFT matches the reference's ``STFT.inverse`` semantics:
windowed overlap-add, division by the window sum-square envelope where it is
non-negligible, and trimming n_fft//2 from both ends.

The JAX package draws the initial phase with ``jax.random``, which torch
cannot reproduce: here it comes from a CPU ``torch.Generator(seed)``,
uniform in [-pi, pi), or from the caller (``phase=``).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fastspeech2_tpu_torch.audio.stft import hann_window, stft_magnitude_phase


@functools.lru_cache(maxsize=8)
def _window_and_inv_basis(n_fft: int, win_length: int) -> np.ndarray:
    """(2*n_freq, n_fft) windowed inverse-DFT basis: [real | imag] -> frame."""
    n_freq = n_fft // 2 + 1
    k = np.arange(n_freq)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    # one-sided inverse DFT with hermitian weights (DC/nyquist counted once)
    w = np.full((n_freq, 1), 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    inv = np.concatenate([np.cos(ang) * w, -np.sin(ang) * w], axis=0) / n_fft
    window = hann_window(win_length).astype(np.float64)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    return (inv * window[None, :]).astype(np.float32)


def _window_sumsquare(n_frames: int, n_fft: int, hop: int, win_length: int) -> np.ndarray:
    n = n_fft + hop * (n_frames - 1)
    win_sq = hann_window(win_length).astype(np.float64) ** 2
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win_sq = np.pad(win_sq, (lpad, n_fft - win_length - lpad))
    x = np.zeros(n)
    for i in range(n_frames):
        s = i * hop
        x[s : s + n_fft] += win_sq[: max(0, min(n_fft, n - s))]
    return x.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _inv_basis_on(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_window_and_inv_basis(n_fft, win_length)).to(device)


@functools.lru_cache(maxsize=16)
def _window_sumsquare_on(n_frames: int, n_fft: int, hop: int, win_length: int,
                         device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_window_sumsquare(n_frames, n_fft, hop, win_length)).to(device)


def istft(magnitude: torch.Tensor, phase: torch.Tensor,
          n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024
          ) -> torch.Tensor:
    """(B, n_freq, T) magnitude+phase -> (B, N) waveform."""
    B, n_freq, T = magnitude.shape
    dev = magnitude.device
    real = magnitude * torch.cos(phase)
    imag = magnitude * torch.sin(phase)
    spec = torch.cat([real, imag], dim=1).transpose(1, 2)  # (B, T, 2F)
    frames = spec @ _inv_basis_on(n_fft, win_length, dev)  # (B, T, n_fft)
    # overlap-add: fold sums each frame's n_fft samples at hop offsets
    out_len = n_fft + hop_length * (T - 1)
    sig = F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                 kernel_size=(1, n_fft), stride=(1, hop_length)).reshape(B, out_len)
    # window sum-square normalization (the reference's utils/stft.py:124-146;
    # no n_fft/hop rescale: the reference needs it only because its
    # pinv-based inverse basis carries a 1/scale factor)
    wss = _window_sumsquare_on(T, n_fft, hop_length, win_length, dev)
    tiny = float(np.finfo(np.float32).tiny * 10)
    sig = torch.where(wss[None] > tiny, sig / torch.clamp(wss[None], min=tiny), sig)
    half = n_fft // 2
    return sig[:, half : out_len - half]


def initial_phase(shape, seed: int = 0) -> torch.Tensor:
    """Uniform in [-pi, pi) from a CPU generator: the same numbers on every
    device."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) * (2 * np.pi) - np.pi


def griffin_lim(magnitude: torch.Tensor, n_iters: int = 30,
                n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024,
                seed: int = 0, phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, n_freq, T) magnitudes -> (B, N) waveform, 30 iterations by default
    (reference inference.py:195-199). ``phase`` replaces the seeded initial
    phase."""
    if phase is None:
        phase = initial_phase(magnitude.shape, seed)
    phase = phase.to(magnitude.device, torch.float32)
    T = magnitude.shape[-1]
    for _ in range(n_iters):
        signal = istft(magnitude, phase, n_fft, hop_length, win_length)
        _, new_phase = stft_magnitude_phase(signal, n_fft, hop_length, win_length)
        # phase frames may exceed magnitude frames by edge effects; trim
        phase = new_phase[..., :T]
    return istft(magnitude, phase, n_fft, hop_length, win_length)
