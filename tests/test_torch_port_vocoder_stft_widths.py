"""Kernels 13 and 14 past their first ranges, on the CPU: the MelGAN residual
stack at stage widths above 256 and at f32 widths that are not a multiple
of 8, and the STFT kernel's FFT plan at every hop from 1 to 1024.

The port's plain versions (``ops/kernels/resstack.py:resstack_plain``,
``ops/kernels/stft.py:stft_mel_energy_plain``) are held to the JAX Pallas
kernels run in interpret mode, as ``tests/test_pallas.py`` runs them, on
inputs made with numpy from a seed. Tolerances: the residual stack f32
rtol/atol 1e-5, bf16 2 bf16 ulps (2^-7) of the output's scale at most and
2^-11 of it on average (``tests/test_torch_port_kernels.py``'s band: both
sides round at the same points, the f32 summation order differs); the STFT
1e-4 (the tolerance ``tests/test_pallas.py`` holds that kernel to); the FFT
plan and float64 tables, through a numpy loop of the kernel's passes,
numpy's rfft to 1e-12 of the peak.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_tpu.audio import stft as jstft
from fastspeech2_tpu.ops.pallas.resstack import resstack_fused
from fastspeech2_tpu.ops.pallas.stft import stft_mel_energy as pallas_stft
from fastspeech2_tpu_torch.audio import stft as tstft
from fastspeech2_tpu_torch.ops.kernels import resstack as KR
from fastspeech2_tpu_torch.ops.kernels import stft as KS
from fastspeech2_tpu_torch.vocoder.melgan import MelGANConfig, MelGANGenerator
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
SR = 22050


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _stage(rng, C, n=3):
    """One MelGAN stage in the JAX layout: w1 (n, 3, C, C), w2 (n, C, C)."""
    w1 = (rng.normal(size=(n, 3, C, C)) / np.sqrt(3 * C)).astype(np.float32)
    w2 = (rng.normal(size=(n, C, C)) / np.sqrt(C)).astype(np.float32)
    b1, b2 = ((rng.normal(size=(n, C)) * 0.1).astype(np.float32) for _ in range(2))
    return w1, b1, w2, b2


def _kernel_layout(w1, b1, w2, b2, td):
    """The kernel's layout: w1 (out, tap, in), w2 (out, in); biases hold cd values."""
    n, C = w2.shape[:2]
    return (_t(w1.transpose(0, 3, 1, 2).reshape(n, C, 3 * C)).to(td), _t(b1).to(td).float(),
            _t(w2.transpose(0, 2, 1)).to(td), _t(b2).to(td).float())


@pytest.mark.parametrize("tier", ["f32", "bf16"])
@pytest.mark.parametrize("C", [320, 512])
def test_resstack_wide_stage_matches_pallas(tier, rng, C):
    """A stage wider than 256 (the wide path on the card: 320 pads to no
    multiple of 256, 512 is a ``base_channels: 1024`` generator's first),
    S = 128 (one tile of the JAX kernel, both ends in it), B = 1."""
    jd, td = JAX_DT[tier], TORCH_DT[tier]
    w1, b1, w2, b2 = _stage(rng, C)
    x = np.asarray(jnp.asarray(rng.normal(size=(1, 128, C)), jd).astype(jnp.float32))
    want = np.asarray(resstack_fused(
        jnp.asarray(x, jd), jnp.asarray(w1, jd), jnp.asarray(b1, jd), jnp.asarray(w2, jd),
        jnp.asarray(b2, jd), interpret=True).astype(jnp.float32))
    assert KR.wide(KR.served_width(C)) and KR.wide(KR.f32_width(C))
    got = KR.resstack(_t(x), *_kernel_layout(w1, b1, w2, b2, td))
    assert got.shape == (1, 128, C)
    if tier == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        d, scale = np.abs(got.numpy() - want), np.abs(want).max()
        assert d.max() <= scale * 2.0 ** -7 and d.mean() < scale * 2.0 ** -11, (
            d.max(), d.mean(), scale)


@pytest.mark.parametrize("C", [125, 250])
def test_resstack_f32_pads_to_a_multiple_of_8(rng, C):
    """The f32 kernels take C a multiple of 8 (``f32_width``); the wrapper
    zero-pads any other width to it: the padded channels come out exactly 0
    and the real ones are the unpadded function's (f32 1e-5: only the
    summation order of the longer products differs)."""
    Cp = KR.f32_width(C)
    assert Cp % 8 == 0 and 0 < Cp - C < 8 and not KR.wide(Cp)
    w1, b1, w2, b2 = _stage(rng, C)
    x = _t(rng.normal(size=(2, 128, C)))
    args = (x, *_kernel_layout(w1, b1, w2, b2, torch.float32))
    padded = KR.pad_channels(*args, Cp)
    got = KR.resstack_plain(*padded)
    np.testing.assert_allclose(got[..., :C].numpy(), KR.resstack_plain(*args).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not got[..., C:].any()
    assert [KR.f32_width(c) for c in (1, 8, 250, 256, 257, 1024, 1025)] == [
        8, 8, 256, 256, 264, 1024, 0]
    assert [KR.served_width(c) for c in (257, 320, 500, 1024, 1025)] == [
        264, 320, 504, 1024, 0]


@pytest.mark.parametrize("base,bf16", [(1024, True), (500, False)])
def test_generator_routes_every_stage_through_the_wrapper(rng, monkeypatch, base, bf16):
    """``base_channels`` 1024 (stages 512, 256, 128, 64, bf16) and 500 (250,
    125, 62, 31, f32): with ``fused_resstack=True`` every tileable stage
    reaches the wrapper, at a width the card's kernels serve (the wide path
    for 512)."""
    calls = []
    real = KR.resstack
    monkeypatch.setattr(KR, "resstack", lambda x, *a, **k: (calls.append(tuple(x.shape)),
                                                          real(x, *a, **k))[1])
    gen = MelGANGenerator(MelGANConfig(base_channels=base), bf16=bf16, fused_resstack=True,
                          device="cpu", seed=0)
    mel = _t(rng.normal(size=(1, 16, 80)) - 4.0)
    with torch.inference_mode():
        wav = gen(mel)
    assert wav.shape == (1, 16 * 256) and torch.isfinite(wav).all()
    # T=16: stage lengths 128, 1024, 2048, 4096, all tileable
    widths = [base // 2, base // 4, base // 8, base // 16]
    assert [(c[1], c[2]) for c in calls] == list(zip((128, 1024, 2048, 4096), widths))
    width = KR.served_width if bf16 else KR.f32_width
    assert all(width(c[2]) > 0 for c in calls)
    assert [KR.wide(width(c[2])) for c in calls] == [base == 1024, False, False, False]


def _replay(n_fft, win_length, x):
    """The kernel's FFT of one frame, in float64 numpy: the plan's passes in
    place (decimation in frequency), register radices as DFTs, the direct
    passes through ``direct_roots``; then the real-FFT untangle."""
    n2 = n_fft // 2
    radices = KS.plan(n_fft)
    win, tw, untangle, pos = KS.fft_tables(n_fft, win_length)
    roots, r0 = KS.direct_roots(n_fft), 0
    xw = x * win
    z = xw[0::2] + 1j * xw[1::2]
    s = n2
    for R in radices:
        s //= R
        q = np.arange(n2 // R)
        j = q % s
        idx = ((q - j) * R + j)[:, None] + s * np.arange(R)[None]
        if R in (8, 4, 2) + KS.REGISTER_RADICES:
            v = np.fft.fft(z[idx], axis=1)
        else:
            w = roots[r0:r0 + R]
            r0 += R
            v = z[idx] @ w[np.outer(np.arange(R), np.arange(R)) % R]
        v[:, 1:] *= tw[s - 1 + (np.arange(1, R)[None] - 1) * s + j[:, None]]
        z[idx] = v
    assert s == 1 and r0 == len(roots) and sorted(pos) == list(range(n2))
    Z = z[pos]
    k = np.arange(n2 // 2 + 1)
    A, B = Z[k], np.conj(Z[(n2 - k) % n2])
    E, T = (A + B) / 2, untangle * (-0.5j) * (A - B)
    X = np.empty(n2 + 1, np.complex128)
    X[k], X[n2 - k] = E + T, np.conj(E - T)
    return X, xw


def _check_rfft(hop):
    n_fft = 4 * hop
    radices = KS.plan(n_fft)
    assert int(np.prod(radices)) == 2 * hop
    x = np.random.default_rng(hop).normal(size=n_fft)
    X, xw = _replay(n_fft, n_fft - 2 * (hop % 3) if hop > 2 else n_fft, x)
    want = np.fft.rfft(xw)
    assert np.abs(X - want).max() <= 1e-12 * np.abs(want).max(), hop


@pytest.mark.parametrize("hop", [1, 7, 28, 220, 257, 275, 441, 600, 1000, 1024])
def test_kernel14_plan_and_tables_give_the_rfft(hop):
    """Hops the kernel took only from this slice on (1-31, a prime factor of
    n_fft / 2 above 5, or above 512): plan() and the float64 tables give
    numpy's rfft of the windowed frame to 1e-12 of its peak; two thirds with
    a window 2 or 4 samples shorter than n_fft."""
    _check_rfft(hop)


def test_kernel14_plan_and_tables_at_every_hop():
    """The same at every hop from 1 to 1024. The plan keeps the order of
    the hops the kernel took before (8s, a 4, a 2, 5s, 3s), then 7s, 11s,
    13s and the larger primes ascending."""
    for hop in range(1, 1025):
        _check_rfft(hop)
        r = KS.plan(4 * hop)
        big = [p for p in r if p not in (8, 4, 2) + KS.REGISTER_RADICES]
        assert big == sorted(big) and all(p > 13 for p in big)
    assert KS.plan(4 * 275) == (2, 5, 5, 11) and KS.plan(4 * 257) == (2, 257)
    assert KS.plan(4 * 441) == (2, 3, 3, 7, 7) and KS.plan(4 * 600) == (8, 2, 5, 5, 3)


def _voiced(n, seed, f0=140.0, sr=SR):
    g = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f = f0 * (1 + 0.1 * np.sin(2 * np.pi * 1.5 * t))
    ph = 2 * np.pi * np.cumsum(f) / sr
    y = sum(0.3 / k * np.sin(k * ph) for k in range(1, 6))
    y = y * (0.5 + 0.5 * np.sin(2 * np.pi * 2.0 * t) ** 2) + 0.01 * g.normal(size=n)
    return y.astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("sr,hop", [(22050, 220), (44100, 441), (48000, 600)])
def test_kernel14_plain_at_odd_hops_matches_xla_and_pallas_interpret(sr, hop):
    """10 ms and 12.5 ms hops of 22.05, 44.1 and 48 kHz corpora, n_fft = 4
    hop, 80 mels: the wrapper's CPU route against the JAX package's XLA path
    and its Pallas kernel in interpret mode, 1e-4; two rows of 0.1 s, one
    with a zero tail."""
    n_fft, N = 4 * hop, sr // 10
    y = np.stack([_voiced(N, hop, sr=sr), _voiced(N, hop + 1, f0=100.0, sr=sr)])
    y[1, N // 2:] = 0.0
    fb = tstft.mel_filterbank(sr, n_fft, 80)
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft)
    mel, en = KS.stft_mel_energy(torch.from_numpy(y), torch.from_numpy(fb), **kw)
    F = N // hop + 1
    assert mel.shape == (2, 80, F) and en.shape == (2, F)
    ms = jstft.MelSpectrogram(sample_rate=sr, n_fft=n_fft, hop_length=hop, win_length=n_fft)
    jmel, jmag = ms(jnp.asarray(y))
    _close(mel, jmel, 1e-4)
    _close(en, jstft.energy_from_magnitude(jmag), 1e-4)
    pmel, pen = pallas_stft(jnp.asarray(y), jnp.asarray(fb), interpret=True, **kw)
    _close(mel, pmel, 1e-4)
    _close(en, pen, 1e-4)
