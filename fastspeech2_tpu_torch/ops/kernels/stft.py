"""Fused STFT -> magnitude -> mel -> log-compress, plus per-frame energy:
``(B, N)`` waveform -> ``(log-mel (B, n_mels, F), energy (B, F))``,
``F = N // hop + 1``, for ``n_fft == 4 * hop``.

Port of ``fastspeech2_tpu/ops/pallas/stft.py:stft_mel_energy`` (kernel
``_stft_mel_kernel``). CUDA source: ``csrc/stft.cu``, one launch per batch,
full f32: a real FFT of each frame in shared memory (in-place
decimation-in-frequency passes over ``n_fft / 2`` complex points: register
butterflies of radix 8, 4, 2, 5, 3, 7, 11 and 13, a direct DFT pass for any
larger prime), then ``|X|``, the energy and the mel projection over each
band's nonzero bins. It takes every ``hop`` from 1 to 2616 (:func:`plan`),
``win_length <= n_fft`` and 1 to ``n_fft / 2 + 1`` mels: 8 frames a block
where the layout fits in shared memory, else 4, 2 or 1
(:func:`frames_per_block`).

The kernel reads the signal itself and pads it by reflection as it loads a
block's span (the JAX wrapper pads outside its kernel: here that would be
one more pass over the signal in device memory). The window and twiddle
tables are built in float64 and cast once per ``(n_fft, win_length,
device)``; each band's nonzero bin range comes from the filterbank tensor by
torch ops on its device, cached per tensor. Rows of a bucket past a wav's
end are the caller's to trim.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import numpy as np
import torch

from fastspeech2_tpu_torch.audio.stft import energy_from_magnitude, log_mel_magnitude
from fastspeech2_tpu_torch.ops.kernels import common

#: launches of the CUDA kernel (the plain version does not count)
launches = 0
_fn = None

_RATIO = 4  # n_fft // hop_length; the only case the reference uses
MIN_HOP, MAX_HOP = 1, 2616  # hop 2617 fits in no layout (frames_per_block)
#: a block's shared memory on the H100, and the frames a block in the
#: order the kernel tries them
SMEM_MAX = 232448
FRAMES_PER_BLOCK = (8, 4, 2, 1)
#: the radices with register butterflies, in plan order after the 8s, the 4
#: and the 2; a larger prime factor takes a direct DFT pass
REGISTER_RADICES = (5, 3, 7, 11, 13)
_bands_lock = threading.Lock()
_bands_cache: dict = {}
_BANDS_KEPT = 8


def stft_mel_energy_plain(y, mel_basis, n_fft: int = 1024, hop_length: int = 256,
                          win_length: int = 1024, clip_val: float = 1e-5
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function the kernel computes, in plain PyTorch: the matmul path of
    ``audio/stft.py`` (f32 matmuls), which CPU tensors take too."""
    mel, magnitude = log_mel_magnitude(y, mel_basis, n_fft, hop_length, win_length,
                                       clip_val)
    return mel, energy_from_magnitude(magnitude)


def plan(n_fft: int) -> Tuple[int, ...]:
    """The radices of the kernel's ``n_fft / 2``-point complex FFT, in the
    order of its passes: as many 8s as divide it, then a 4, a 2, 5s, 3s, 7s,
    11s, 13s and the larger prime factors in ascending order (each a direct
    DFT pass). Pass p runs at stride ``n_fft / 2`` over the product of the
    radices up to and including its own (1 for the last). The C side's
    ``st_make_plan`` (``csrc/stft.cu``) follows the same rule. Raises
    ``ValueError`` unless ``n_fft = 4 * hop`` with ``hop`` in 1..2616."""
    hop, rest = divmod(n_fft, _RATIO)
    if rest or not MIN_HOP <= hop <= MAX_HOP:
        raise ValueError(f"stft_mel_energy: n_fft={n_fft} not supported (n_fft = 4 * hop "
                         f"with hop from {MIN_HOP} to {MAX_HOP})")
    n, radices = n_fft // 2, []
    for r, once in ((8, False), (4, True), (2, True)) + tuple(
            (r, False) for r in REGISTER_RADICES):
        while n % r == 0:
            radices.append(r)
            n //= r
            if once:
                break
    p = 17
    while n > 1:
        while n % p == 0:
            radices.append(p)
            n //= p
        p += 2
    return tuple(radices)


def _round4(n: int) -> int:
    return (n + 3) & ~3


def frames_per_block(hop: int, n_mels: int) -> Tuple[int, int]:
    """(frames a block, shared-memory bytes) of the kernel at ``hop`` and
    ``n_mels``: the first of ``FRAMES_PER_BLOCK`` whose layout fits in
    ``SMEM_MAX`` (``csrc/stft.cu:Layout``, ``st_make_plan``; ``c_plan``
    gives the C side's). In floats, every part rounded up to 4: the span of
    (FT + 3) hop signal samples; the tables (window and pass twiddles, 4 hop
    each; untangle twiddles; bin positions) and the direct passes' roots;
    FT FFT buffers of 2 (n2 + (n2 - 1) / 16 + 1); FT magnitude rows of n2 +
    1; FT energies. With 8 or 4 frames the log-mel tile (n_mels FT) shares
    the span; with 2 or 1 the magnitudes do and the tile lies over the FFT
    buffers. Raises ``ValueError`` where no layout fits."""
    plan(4 * hop)
    n2 = 2 * hop
    tables = 8 * hop + _round4(2 * (hop + 1)) + _round4(2 * hop)
    roots = _round4(2 * sum(r for r in plan(4 * hop)
                            if r not in (8, 4, 2) + REGISTER_RADICES))
    buf = _round4(2 * (n2 + (n2 - 1) // 16 + 1))
    for ft in FRAMES_PER_BLOCK:
        span, mag = _round4((ft + 3) * hop), _round4(ft * (n2 + 1))
        if ft >= 4:
            en = _round4(max(span, n_mels * ft)) + tables + roots + ft * buf + mag
        else:
            en = max(span, mag) + tables + roots + ft * buf
        smem = 4 * (en + ft)
        if smem <= SMEM_MAX:
            return ft, smem
    raise ValueError(f"stft_mel_energy: hop={hop} fits in no layout")


def direct_roots(n_fft: int) -> np.ndarray:
    """The roots of unity of the plan's direct DFT passes (radices above 13),
    in float64: for each such pass in order, ``exp(-2 pi i m / R)``, ``m <
    R``; empty where the plan has none."""
    parts = [np.exp(-2j * np.pi * np.arange(R) / R) for R in plan(n_fft)
             if R not in (8, 4, 2) + REGISTER_RADICES]
    return np.concatenate(parts) if parts else np.zeros(0, np.complex128)


def fft_tables(n_fft: int, win_length: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's tables, in float64: the window (hann of ``win_length``
    centered in ``n_fft``); the passes' twiddles, ``n_fft/2 - 1`` in all (the
    pass of radix R at stride s holds ``exp(-2 pi i r j / (s R))``, ``0 < r <
    R``, ``j < s``, at ``s - 1 + (r - 1) s + j``); the untangle twiddles
    ``exp(-2 pi i k / n_fft)``, ``k = 0..n_fft/4``; and where the passes,
    which run in place and decimate in frequency, leave bin k of the
    ``n_fft/2``-point transform (its digits reversed: digit p of k, in the
    radix of pass p, times that pass's stride)."""
    n2 = n_fft // 2
    n = np.arange(win_length, dtype=np.float64)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    lpad = (n_fft - win_length) // 2
    window = np.pad(window, (lpad, n_fft - win_length - lpad))
    tw = np.zeros(n2 - 1, np.complex128)
    pos = np.zeros(n2, np.int64)
    k, s = np.arange(n2), n2
    for R in plan(n_fft):
        s //= R
        j = np.arange(s)
        for r in range(1, R):
            tw[s - 1 + (r - 1) * s + j] = np.exp(-2j * np.pi * r * j / (s * R))
        pos += (k % R) * s
        k = k // R
    untangle = np.exp(-2j * np.pi * np.arange(n2 // 2 + 1) / n_fft)
    return window, tw, untangle, pos


def _interleave(c: np.ndarray) -> np.ndarray:
    out = np.empty(2 * len(c), np.float32)
    out[0::2], out[1::2] = c.real, c.imag
    return out


def _pad4(a: np.ndarray) -> np.ndarray:
    return np.pad(a, (0, -len(a) % 4))


@functools.lru_cache(maxsize=8)
def _device_tables(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    """``fft_tables`` cast to f32 (the positions as int32 bits) in the
    kernel's layout (``stft.cu:Layout``): window | pass twiddles (re, im) |
    untangle twiddles | positions | the direct passes' roots, each part
    rounded up to 4 floats."""
    window, tw, untangle, pos = fft_tables(n_fft, win_length)
    parts = [window.astype(np.float32), _interleave(tw), _interleave(untangle),
             pos.astype(np.int32).view(np.float32), _interleave(direct_roots(n_fft))]
    return torch.from_numpy(np.concatenate([_pad4(p) for p in parts])).to(device)


def band_ranges(mel_basis: torch.Tensor) -> torch.Tensor:
    """(n_mels, 2) int32 on the filterbank's device: each band's first nonzero
    bin and the count of bins from it to its last nonzero one (0, 0 for a
    band of zeros). Torch ops only: no read back to the host."""
    nz = mel_basis != 0
    n_freq = mel_basis.shape[1]
    bins = torch.arange(n_freq, device=mel_basis.device)
    first = torch.where(nz, bins, n_freq).amin(dim=1)
    last = torch.where(nz, bins, -1).amax(dim=1)
    count = (last - first + 1).clamp_min(0)
    return torch.stack([torch.where(count > 0, first, 0), count], 1).to(torch.int32)


def _bands(mel_basis: torch.Tensor) -> torch.Tensor:
    """``band_ranges`` of the filterbank, kept per tensor (keyed on storage
    pointer, version counter, shape and device, as ``common.cached_pack``
    keys; the entry holds the tensor, so its storage cannot be reused under
    the same key). Safe to call from several threads."""
    key = (mel_basis.data_ptr(), mel_basis._version, tuple(mel_basis.shape),
           str(mel_basis.device))
    with _bands_lock:
        hit = _bands_cache.get(key)
        if hit is None:
            if len(_bands_cache) >= _BANDS_KEPT:
                _bands_cache.pop(next(iter(_bands_cache)))
            hit = (mel_basis, band_ranges(mel_basis))
            _bands_cache[key] = hit
    return hit[1]


def c_plan(hop: int, n_mels: int) -> Tuple[Tuple[int, ...], int, int]:
    """The C side's plan for a hop (``fs2_stft_plan``; needs the built
    library): (radices, frames a block, shared-memory bytes). Raises
    ``ValueError`` where it refuses the hop."""
    P, I = common.P, common.I
    fn = common.bind(common.load("stft"), "fs2_stft_plan", [I, I, P])
    out = (ctypes.c_int * 16)()
    if fn(hop, n_mels, out) != 0:
        raise ValueError(f"stft_mel_energy: the kernel refuses hop={hop}")
    return tuple(out[1:1 + out[0]]), out[13], out[14]


def _bind():
    global _fn
    if _fn is None:
        P, I, F = common.P, common.I, common.F
        _fn = common.bind(common.load("stft"), "fs2_stft_mel_energy",
                          [P, I, I, I, P, P, P, I, F, P, P, P])


def stft_mel_energy(y, mel_basis, n_fft: int = 1024, hop_length: int = 256,
                    win_length: int = 1024, clip_val: float = 1e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (B, N) f32 in [-1, 1]; mel_basis (n_mels, n_fft//2+1) f32. CPU
    tensors take the plain version; CUDA tensors launch the kernel (hop 1 to
    2616, win_length <= n_fft, 1 to n_fft//2+1 mels) or raise."""
    global launches
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
    plan(n_fft)
    if not 1 <= n_mels <= n_freq or not 1 <= win_length <= n_fft:
        raise ValueError(f"stft_mel_energy: n_mels={n_mels}, win_length={win_length} "
                         f"not supported (1 to {n_freq} mels, win_length <= n_fft)")
    if not (1 <= B <= 65535 and 1 <= N <= 1 << 30):
        raise ValueError(f"stft_mel_energy: y of shape {tuple(y.shape)} not supported "
                         "(1 to 65535 rows of 1 to 2^30 samples)")
    _bind()
    tables = _device_tables(n_fft, win_length, y.device)
    bands = _bands(mel_basis)
    F_ = N // hop_length + 1
    mel = torch.empty(B, n_mels, F_, device=y.device)
    energy = torch.empty(B, F_, device=y.device)
    common.launch(_fn, y.data_ptr(), B, N, hop_length, tables.data_ptr(),
                  bands.data_ptr(), mel_basis.data_ptr(), n_mels,
                  clip_val, mel.data_ptr(), energy.data_ptr(), common.stream_of(y))
    with common.count_lock:
        launches += 1
    return mel, energy
