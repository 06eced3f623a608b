"""Kernel 14 past hop 1024, on the CPU: the FFT plan, the float64 tables
and the shared-memory layout of ``ops/kernels/stft.py`` at hops 1025-2616,
and the wrapper's plain version at hops 1200 and 2048 against the JAX
package.

The plan and tables go through a numpy loop of the kernel's passes
(decimation in frequency, in place; each butterfly a DFT of its radix) and
the real-FFT untangle, to numpy's rfft within 1e-12 of its peak, as
``tests/test_torch_port_vocoder_stft_widths.py`` replays hops 1-1024; the
direct passes' roots are held to exp(-2 pi i m / R). The plain version is
held to the JAX XLA path and, at hop 1200, to the Pallas kernel in
interpret mode at 1e-4, the band of
``test_kernel14_plain_at_odd_hops_matches_xla_and_pallas_interpret``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_tpu.audio import stft as jstft
from fastspeech2_tpu.ops.pallas.stft import stft_mel_energy as pallas_stft
from fastspeech2_tpu_torch.audio import stft as tstft
from fastspeech2_tpu_torch.ops.kernels import stft as KS
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_port_vocoder_stft_widths import _close, _voiced


def _replay_rfft(hop: int, g) -> None:
    """One frame of noise through the plan and tables of ``hop``: its rfft
    within 1e-12 of the peak."""
    n_fft, n2 = 4 * hop, 2 * hop
    radices = KS.plan(n_fft)
    assert int(np.prod(radices)) == n2
    win, tw, untangle, pos = KS.fft_tables(n_fft, n_fft)
    roots, r0 = KS.direct_roots(n_fft), 0
    xw = g.normal(size=n_fft) * win
    z = xw[0::2] + 1j * xw[1::2]
    s = n2
    for R in radices:
        s //= R
        q = np.arange(n2 // R)
        j = q % s
        idx = ((q - j) * R + j)[:, None] + s * np.arange(R)[None]
        if R not in (8, 4, 2) + KS.REGISTER_RADICES:
            w = roots[r0:r0 + R]
            r0 += R
            assert np.abs(w - np.exp(-2j * np.pi * np.arange(R) / R)).max() < 1e-15
        v = np.fft.fft(z[idx], axis=1)
        v[:, 1:] *= tw[s - 1 + (np.arange(1, R)[None] - 1) * s + j[:, None]]
        z[idx] = v
    assert s == 1 and r0 == len(roots) and np.array_equal(np.sort(pos), np.arange(n2))
    Z = z[pos]
    k = np.arange(hop + 1)
    A, B = Z[k], np.conj(Z[(n2 - k) % n2])
    E, T = (A + B) / 2, untangle * (-0.5j) * (A - B)
    X = np.empty(n2 + 1, np.complex128)
    X[k], X[n2 - k] = E + T, np.conj(E - T)
    want = np.fft.rfft(xw)
    assert np.abs(X - want).max() <= 1e-12 * np.abs(want).max(), hop


def test_kernel14_plan_and_tables_at_hops_past_1024():
    """Every hop from 1025 to 2048, and every 7th hop to 2616 with the
    largest, give the rfft; the plan keeps its order (8s, a 4, a 2, 5s, 3s,
    7s, 11s, 13s, larger primes ascending)."""
    g = np.random.default_rng(1025)
    for hop in sorted(set(range(1025, 2049)) | set(range(2049, 2617, 7)) | {2609, 2616}):
        _replay_rfft(hop, g)
        big = [p for p in KS.plan(4 * hop) if p not in (8, 4, 2) + KS.REGISTER_RADICES]
        assert big == sorted(big) and all(p > 13 for p in big)
    assert KS.plan(4 * 1200) == (8, 4, 5, 5, 3) and KS.plan(4 * 2048) == (8, 8, 8, 8)
    assert KS.plan(4 * 1025) == (2, 5, 5, 41) and KS.plan(4 * 2609) == (2, 2609)


def test_kernel14_frames_per_block_reach_hop_2616():
    """The layout rule: at every hop 1-2616 and any band count some layout
    fits in the card's shared memory; 8 frames a block where they fit, else
    4, 2, 1; hops 1-1024 at 80 bands keep the 8 or 4 they took (4 only past
    512); 2 frames first at hop 1277, 1 at 2113. Hop 2617 is refused."""
    first = {}
    for hop in range(1, 2617):
        for n_mels in {1, min(80, 2 * hop + 1), 2 * hop + 1}:
            ft, smem = KS.frames_per_block(hop, n_mels)
            assert smem <= KS.SMEM_MAX and ft in KS.FRAMES_PER_BLOCK, (hop, n_mels)
            if n_mels == min(80, 2 * hop + 1):
                first.setdefault(ft, hop)
                if hop <= 1024:
                    assert ft == 8 or (ft == 4 and hop > 512), (hop, ft)
    assert first == {8: 1, 4: 787, 2: 1277, 1: 2113}, first
    assert KS.frames_per_block(2048, 80) == (2, 208920)
    for hop in (2617, 3000, 4096):
        with pytest.raises(ValueError, match="not supported"):
            KS.frames_per_block(hop, 80)


@pytest.mark.parametrize("sr,hop,interpret", [(96000, 1200, True), (96000, 2048, False)])
def test_kernel14_plain_at_hops_past_1024_matches_xla_and_pallas_interpret(sr, hop,
                                                                           interpret):
    """A 96 kHz corpus at a 12.5 ms hop (1200, n_fft 4800) and at hop 2048
    (n_fft 8192), 80 mels: the wrapper's CPU route against the JAX
    package's XLA path (eager: jit folds the DFT basis, 8192 x 8194 at hop
    2048, into a constant and takes seconds more), 1e-4; at hop 1200 also
    against its Pallas kernel in interpret mode (at hop 2048 that takes
    ~12 s: 256-frame blocks of an 8192 x 8194 DFT); one row of 50 ms with a
    zero tail."""
    n_fft, N = 4 * hop, sr // 20
    y = _voiced(N, hop, sr=sr)[None]
    y[0, 3 * N // 4:] = 0.0
    fb = tstft.mel_filterbank(sr, n_fft, 80)
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft)
    mel, en = KS.stft_mel_energy(torch.from_numpy(y), torch.from_numpy(fb), **kw)
    F = N // hop + 1
    assert mel.shape == (1, 80, F) and en.shape == (1, F)
    ms = jstft.MelSpectrogram(sample_rate=sr, n_fft=n_fft, hop_length=hop, win_length=n_fft)
    jmel, jmag = ms(jnp.asarray(y))
    jen = jstft.energy_from_magnitude(jmag)
    _close(mel, jmel, 1e-4)
    _close(en, jen, 1e-4)
    if not interpret:
        return
    pmel, pen = pallas_stft(jnp.asarray(y), jnp.asarray(fb), interpret=True, **kw)
    _close(mel, pmel, 1e-4)
    _close(en, pen, 1e-4)
