"""Fused STFT -> magnitude -> mel -> log-compress, plus per-frame energy:
``(B, N)`` waveform -> ``(log-mel (B, n_mels, F), energy (B, F))``,
``F = N // hop + 1``, for ``n_fft == 4 * hop``.

Port of ``fastspeech2_tpu/ops/pallas/stft.py:stft_mel_energy`` (kernel
``_stft_mel_kernel``). CUDA source: ``csrc/stft.cu`` (one launch per batch,
full f32: the DFT sums cancel, so no TF32 anywhere).

The wrapper does what the JAX wrapper does outside its kernel: the center
reflect pad of the signal, and the bases, built in float64 and cast (the
windowed DFT basis laid out in bin tiles of 64, the mel filterbank
transposed, both zero past ``n_freq``). Rows of a bucket past a wav's end
are the caller's to trim.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from fastspeech2_tpu_torch.audio.stft import (
    _dft_basis, energy_from_magnitude, log_mel_magnitude, reflect_pad)
from fastspeech2_tpu_torch.ops.kernels import common

#: launches of the CUDA kernel (the plain version does not count)
launches = 0
_fn = None

_RATIO = 4  # n_fft // hop_length; the only case the reference uses
_BIN_TILE = 64


def stft_mel_energy_plain(y, mel_basis, n_fft: int = 1024, hop_length: int = 256,
                          win_length: int = 1024, clip_val: float = 1e-5
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function the kernel computes, in plain PyTorch: the matmul path of
    ``audio/stft.py`` (f32 matmuls), which CPU tensors take too."""
    mel, magnitude = log_mel_magnitude(y, mel_basis, n_fft, hop_length, win_length,
                                       clip_val)
    return mel, energy_from_magnitude(magnitude)


@functools.lru_cache(maxsize=8)
def _tiled_basis(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    """(n_tiles, n_fft, 128) f32: bin tile t holds the cos columns of bins
    64t..64t+63, then their -sin columns; zeros past n_freq."""
    n_freq = n_fft // 2 + 1
    n_tiles = -(-n_freq // _BIN_TILE)
    basis = _dft_basis(n_fft, win_length)
    out = np.zeros((n_tiles, n_fft, 2 * _BIN_TILE), np.float32)
    for part in range(2):
        cols = np.zeros((n_fft, n_tiles * _BIN_TILE), np.float32)
        cols[:, :n_freq] = basis[:, part * n_freq:(part + 1) * n_freq]
        out[:, :, part * _BIN_TILE:(part + 1) * _BIN_TILE] = (
            cols.reshape(n_fft, n_tiles, _BIN_TILE).transpose(1, 0, 2))
    return torch.from_numpy(out).to(device)


def stft_mel_energy(y, mel_basis, n_fft: int = 1024, hop_length: int = 256,
                    win_length: int = 1024, clip_val: float = 1e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (B, N) f32 in [-1, 1]; mel_basis (n_mels, n_fft//2+1) f32. CPU
    tensors take the plain version; CUDA tensors launch the kernel (hop a
    multiple of 32 up to 256, n_mels up to 128)."""
    global launches, _fn
    if n_fft != _RATIO * hop_length:
        raise ValueError("fused STFT kernel assumes n_fft == 4*hop")
    if y.device.type == "cpu":
        return stft_mel_energy_plain(y, mel_basis, n_fft, hop_length, win_length,
                                     clip_val)
    if y.dim() != 2:
        raise ValueError(f"stft_mel_energy: y must be (B, N), got {tuple(y.shape)}")
    B, N = y.shape
    n_freq = n_fft // 2 + 1
    n_mels = mel_basis.shape[0]
    common.check_cuda("stft_mel_energy", y.device, [
        ("y", y, torch.float32, None),
        ("mel_basis", mel_basis, torch.float32, (n_mels, n_freq))])
    if hop_length % 32 or not 32 <= hop_length <= 256:
        raise ValueError(f"stft_mel_energy: hop_length={hop_length} not supported "
                         "(a multiple of 32 up to 256)")
    if not 1 <= n_mels <= 128 or win_length > n_fft:
        raise ValueError(f"stft_mel_energy: n_mels={n_mels}, win_length={win_length} "
                         "not supported")
    if _fn is None:
        P, I, F = common.P, common.I, common.F
        _fn = common.bind(common.load("stft"), "fs2_stft_mel_energy",
                          [P, I, I, I, I, P, I, P, I, F, P, P, P])
    pad = n_fft // 2
    y_pad = reflect_pad(y, pad, pad).contiguous()
    basis = _tiled_basis(n_fft, win_length, y.device)
    n_tiles = basis.shape[0]
    melw = torch.zeros(n_tiles * _BIN_TILE, n_mels, device=y.device)
    melw[:n_freq] = mel_basis.t()
    F_ = N // hop_length + 1
    mel = torch.empty(B, n_mels, F_, device=y.device)
    energy = torch.empty(B, F_, device=y.device)
    common.launch(_fn, y_pad.data_ptr(), B, y_pad.shape[1], F_, hop_length,
                  basis.data_ptr(), n_tiles, melw.data_ptr(), n_mels, clip_val,
                  mel.data_ptr(), energy.data_ptr(), common.stream_of(y))
    with common.count_lock:
        launches += 1
    return mel, energy
