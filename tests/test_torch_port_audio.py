"""The port's audio DSP (``fastspeech2_tpu_torch/audio/``) and kernel 14's
plain version against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: bases, windows and filterbanks exact (the same float64 numpy
code, cast once); framing exact; f32 transforms 1e-5 (``assert_allclose``
rtol and atol; for magnitudes and energies the atol is 1e-5 of the peak:
the two packages sum the 1024-term DFT products in another order, and the
error of a sum that cancels scales with the frame's level, not with the
bin's own size); kernel 14's plain version against the Pallas kernel in interpret
mode 1e-4, the tolerance ``tests/test_pallas.py`` holds that kernel to;
Griffin-Lim with the JAX draw of the initial phase injected 1e-4 of the
output's peak (its phases go through atan2 three times). Kernel 14's FFT
plan and float64 tables, through a numpy loop of its passes, against
numpy's rfft to 1e-12 of the peak (float64 on both sides); its filterbank
band ranges exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_tpu import native as jnative
from fastspeech2_tpu.audio import griffin_lim as jgl
from fastspeech2_tpu.audio import pitch as jpitch
from fastspeech2_tpu.audio import processing as jproc
from fastspeech2_tpu.audio import stft as jstft
from fastspeech2_tpu.config import Config as JConfig
from fastspeech2_tpu.data.ljspeech import read_metadata as j_read_metadata
from fastspeech2_tpu.infer import synthesize as jsynth
from fastspeech2_tpu_torch import native as tnative
from fastspeech2_tpu_torch.audio import griffin_lim as tgl
from fastspeech2_tpu_torch.audio import pitch as tpitch
from fastspeech2_tpu_torch.audio import processing as tproc
from fastspeech2_tpu_torch.audio import stft as tstft
from fastspeech2_tpu_torch.config import Config as TConfig
from fastspeech2_tpu_torch.data.ljspeech import read_metadata as t_read_metadata
from fastspeech2_tpu_torch.infer import synthesize as tsynth
from fastspeech2_tpu_torch.ops.kernels import stft as kstft
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

SR = 22050


def _close(got, want, tol=1e-5, peak=False):
    """rtol = atol = tol; with ``peak``, atol = tol times the peak of want."""
    want = np.asarray(want)
    atol = tol * np.abs(want).max() if peak else tol
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=atol)


def _voiced(n, seed, f0=140.0):
    """A harmonic series on a slowly varying f0, with an envelope and noise."""
    g = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f = f0 * (1 + 0.1 * np.sin(2 * np.pi * 1.5 * t))
    ph = 2 * np.pi * np.cumsum(f) / SR
    y = sum(0.3 / k * np.sin(k * ph) for k in range(1, 6))
    y = y * (0.5 + 0.5 * np.sin(2 * np.pi * 2.0 * t) ** 2) + 0.01 * g.normal(size=n)
    return y.astype(np.float32)


@pytest.mark.parametrize("n_fft,win", [(1024, 1024), (1024, 800), (512, 512)])
def test_windows_and_bases_are_exact(n_fft, win):
    np.testing.assert_array_equal(tstft.hann_window(win), jstft.hann_window(win))
    np.testing.assert_array_equal(tstft._dft_basis(n_fft, win), jstft._dft_basis(n_fft, win))
    np.testing.assert_array_equal(tgl._window_and_inv_basis(n_fft, win),
                                  jgl._window_and_inv_basis(n_fft, win))
    np.testing.assert_array_equal(tgl._window_sumsquare(7, n_fft, n_fft // 4, win),
                                  jgl._window_sumsquare(7, n_fft, n_fft // 4, win))


@pytest.mark.parametrize("args", [(22050, 1024, 80, 0.0, 8000.0),
                                  (16000, 512, 40, 50.0, None)])
def test_mel_filterbank_is_exact(args):
    np.testing.assert_array_equal(tstft.mel_filterbank(*args), jstft.mel_filterbank(*args))


@pytest.mark.parametrize("n,left,right", [(5, 7, 7), (5, 12, 3), (1, 3, 3),
                                          (300, 512, 512), (513, 512, 512)])
def test_reflect_pad_matches_numpy(n, left, right):
    """numpy's repeated reflection where F.pad(mode="reflect") would raise."""
    x = np.random.default_rng(n).normal(size=(2, n)).astype(np.float32)
    got = tstft.reflect_pad(torch.from_numpy(x), left, right).numpy()
    np.testing.assert_array_equal(got, np.pad(x, ((0, 0), (left, right)), mode="reflect"))
    np.testing.assert_array_equal(
        got, np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (left, right)), mode="reflect")))


@pytest.mark.parametrize("n", [7, 300, 512, 513, 4000])
def test_frame_signal_matches(n):
    y = np.random.default_rng(n).uniform(-0.9, 0.9, (2, n)).astype(np.float32)
    got = tstft.frame_signal(torch.from_numpy(y), 1024, 256).numpy()
    want = np.asarray(jstft.frame_signal(jnp.asarray(y), 1024, 256))
    assert got.shape == want.shape == (2, n // 256 + 1, 1024)
    _close(got, want)


def test_stft_magnitude_phase_and_mel_spectrogram_match():
    y = np.stack([_voiced(11025, 0), _voiced(11025, 1, f0=210.0)])
    mag, phase = tstft.stft_magnitude_phase(torch.from_numpy(y))
    jmag, jphase = jstft.stft_magnitude_phase(jnp.asarray(y))
    jmag, jphase = np.asarray(jmag), np.asarray(jphase)
    _close(mag, jmag, peak=True)
    strong = jmag > 1e-2 * jmag.max()  # atan2 is unstable near zero
    d = np.angle(np.exp(1j * (phase.numpy() - jphase)))
    assert np.abs(d[strong]).max() < 1e-4
    mel, mag2 = tstft.MelSpectrogram(device="cpu")(torch.from_numpy(y))
    jmel, _ = jstft.MelSpectrogram()(jnp.asarray(y))
    _close(mel, jmel)
    _close(mag2, jmag, peak=True)
    _close(tstft.energy_from_magnitude(mag), jstft.energy_from_magnitude(jnp.asarray(jmag)))


def test_mel_and_energy_bucketed_matches():
    """Bucketed batches, including a wav no longer than the reflect pad (the
    per-utterance path, where numpy-style reflection is needed)."""
    g = np.random.default_rng(7)
    lens = [22050, 22051, 4096, 256 * 37 + 13, 511, 300]
    wavs = [g.uniform(-0.9, 0.9, size=(n,)).astype(np.float32) for n in lens]
    got = tstft.MelSpectrogram(device="cpu").mel_and_energy_bucketed(
        wavs, bucket=16384, max_batch=4)
    want = jstft.MelSpectrogram().mel_and_energy_bucketed(wavs, bucket=16384, max_batch=4)
    for n, (m, e), (jm, je) in zip(lens, got, want):
        assert m.shape == (80, n // 256 + 1) and e.shape == (n // 256 + 1,)
        _close(m, jm)
        _close(e, je)


def test_kernel14_plain_matches_xla_path_and_pallas_interpret():
    """stft_mel_energy's plain version (the CPU path of the wrapper) against
    the JAX package's XLA path at 1e-5 and its Pallas kernel run by the HLO
    interpreter (``interpret=True``) at 1e-4; B=2, 0.5 s, one row voiced and
    one with a zero tail."""
    from fastspeech2_tpu.ops.pallas.stft import stft_mel_energy as pallas_stft

    y = np.stack([_voiced(11025, 2), _voiced(11025, 3, f0=100.0)])
    y[1, 6000:] = 0.0
    fb = tstft.mel_filterbank()
    mel, en = kstft.stft_mel_energy(torch.from_numpy(y), torch.from_numpy(fb))
    assert mel.shape == (2, 80, 44) and en.shape == (2, 44)
    jmel, jmag = jstft.MelSpectrogram()(jnp.asarray(y))
    _close(mel, jmel)
    _close(en, jstft.energy_from_magnitude(jmag))
    pmel, pen = pallas_stft(jnp.asarray(y), jnp.asarray(fb), interpret=True)
    pmel, pen = np.asarray(pmel), np.asarray(pen)
    _close(mel, pmel, 1e-4)
    _close(en, pen, 1e-4)
    with pytest.raises(ValueError, match="n_fft == 4"):
        kstft.stft_mel_energy(torch.from_numpy(y), torch.from_numpy(fb), n_fft=1024,
                              hop_length=128)


def _only_2_3_5(n):
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


KERNEL14_HOPS = [h for h in range(32, 513) if _only_2_3_5(2 * h)]


@pytest.mark.parametrize("hop", KERNEL14_HOPS)
def test_kernel14_fft_plan_and_tables_give_the_rfft(hop):
    """kstft.plan() and the wrapper's float64 tables (window, pass twiddles,
    untangle twiddles, bin positions), run through a numpy loop of the
    kernel's passes (in place, decimation in frequency, at the strides the
    plan gives), then the real-FFT untangle: numpy's rfft of the windowed
    frame to 1e-12 of its peak, for every n_fft = 4 hop the kernel takes
    (n_fft / 2 a product of 2s, 3s and 5s, n_fft 128 to 2048); two thirds
    of them with a window 2 or 4 samples shorter than n_fft."""
    n_fft, n2 = 4 * hop, 2 * hop
    radices = kstft.plan(n_fft)
    assert int(np.prod(radices)) == n2 and set(radices) <= {2, 3, 4, 5, 8}
    win, tw, untangle, pos = kstft.fft_tables(n_fft, n_fft - 2 * (hop % 3))
    x = np.random.default_rng(hop).normal(size=n_fft)
    xw = x * win
    z = xw[0::2] + 1j * xw[1::2]
    s = n2
    for R in radices:
        s //= R
        q = np.arange(n2 // R)
        j = q % s
        idx = ((q - j) * R + j)[:, None] + s * np.arange(R)[None]
        v = np.fft.fft(z[idx], axis=1)
        v[:, 1:] *= tw[s - 1 + (np.arange(1, R)[None] - 1) * s + j[:, None]]
        z[idx] = v
    assert s == 1 and sorted(pos) == list(range(n2))
    Z = z[pos]
    k = np.arange(n2 // 2 + 1)
    A, B = Z[k], np.conj(Z[(n2 - k) % n2])
    E, T = (A + B) / 2, untangle * (-0.5j) * (A - B)
    X = np.empty(n2 + 1, np.complex128)
    X[k], X[n2 - k] = E + T, np.conj(E - T)
    want = np.fft.rfft(xw)
    assert np.abs(X - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("hop", [1025, 1031, 1100, 2048, 4096])
def test_kernel14_plan_refuses_other_hops(hop):
    with pytest.raises(ValueError, match="not supported"):
        kstft.plan(4 * hop)


def test_kernel14_plan_refuses_other_ratios():
    with pytest.raises(ValueError, match="not supported"):
        kstft.plan(1022)


@pytest.mark.parametrize("n_mels", [80, 128, 160])
def test_kernel14_band_ranges_cover_every_weight(n_mels):
    """Each band's range from band_ranges(), [first, first + count), runs
    from its first to its last nonzero weight of mel_filterbank(): it covers
    every nonzero weight and no weight is nonzero outside the ranges. A band
    of zeros gets (0, 0)."""
    fb = tstft.mel_filterbank(22050, 1024, n_mels)
    ranges = kstft.band_ranges(torch.from_numpy(fb)).numpy()
    assert ranges.shape == (n_mels, 2) and ranges.dtype == np.int32
    inside = np.zeros_like(fb, bool)
    for m, (first, count) in enumerate(ranges):
        inside[m, first:first + count] = True
        nz = np.flatnonzero(fb[m])
        assert count == nz[-1] - nz[0] + 1 and first == nz[0]
    assert (fb[~inside] == 0).all()
    empty = torch.from_numpy(fb).clone()
    empty[3] = 0
    assert kstft.band_ranges(empty)[3].tolist() == [0, 0]


@pytest.mark.parametrize("hop,n_mels", [(200, 80), (512, 80), (256, 128)])
def test_kernel14_plain_at_the_new_hops_matches_xla_path_and_pallas_interpret(hop, n_mels):
    """The wrapper's CPU route (the plain version) at the shapes this slice
    opens on the card (hop 200 / n_fft 800, hop 512 / n_fft 2048, 128 mels
    at hop 256) against the JAX package's XLA path and its Pallas kernel
    run by the HLO interpreter (``interpret=True``), 1e-4; 0.25 s of audio,
    two rows, one with a zero tail."""
    from fastspeech2_tpu.ops.pallas.stft import stft_mel_energy as pallas_stft

    n_fft = 4 * hop
    y = np.stack([_voiced(5512, hop), _voiced(5512, hop + 1, f0=100.0)])
    y[1, 3000:] = 0.0
    fb = tstft.mel_filterbank(22050, n_fft, n_mels)
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft)
    mel, en = kstft.stft_mel_energy(torch.from_numpy(y), torch.from_numpy(fb), **kw)
    F = 5512 // hop + 1
    assert mel.shape == (2, n_mels, F) and en.shape == (2, F)
    ms = jstft.MelSpectrogram(n_fft=n_fft, hop_length=hop, win_length=n_fft, n_mels=n_mels)
    jmel, jmag = ms(jnp.asarray(y))
    _close(mel, jmel, 1e-4)
    _close(en, jstft.energy_from_magnitude(jmag), 1e-4)
    pmel, pen = pallas_stft(jnp.asarray(y), jnp.asarray(fb), interpret=True, **kw)
    _close(mel, np.asarray(pmel), 1e-4)
    _close(en, np.asarray(pen), 1e-4)


def test_cpu_tensors_take_the_plain_paths():
    """A CPU tensor never reaches the kernel's launch: mel_and_energy takes
    the matmul path, the wrapper its plain version; n_fft != 4*hop takes the
    matmul path on every device, as in the JAX package."""
    y = torch.from_numpy(_voiced(4096, 4)[None])
    ms = tstft.MelSpectrogram(device="cpu")
    n0 = kstft.launches
    mel, en = ms.mel_and_energy(y)
    pm, pe = kstft.stft_mel_energy(y, ms.mel_basis)
    assert kstft.launches == n0
    _close(mel, pm)
    _close(en, pe)
    mel2, en2 = tstft.MelSpectrogram(hop_length=128, device="cpu").mel_and_energy(y)
    jmel2, jen2 = jstft.MelSpectrogram(hop_length=128).mel_and_energy(jnp.asarray(y.numpy()))
    assert mel2.shape == (1, 80, 4096 // 128 + 1)
    _close(mel2, jmel2)
    _close(en2, jen2)


def test_istft_matches():
    g = np.random.default_rng(11)
    mag = np.abs(g.normal(size=(2, 513, 20))).astype(np.float32)
    phase = g.uniform(-np.pi, np.pi, size=mag.shape).astype(np.float32)
    got = tgl.istft(torch.from_numpy(mag), torch.from_numpy(phase))
    want = np.asarray(jgl.istft(jnp.asarray(mag), jnp.asarray(phase)))
    assert got.shape == want.shape == (2, 19 * 256)
    _close(got, want)


def test_griffin_lim_with_injected_phase_matches():
    y = _voiced(8192, 5)[None]
    jmag, _ = jstft.stft_magnitude_phase(jnp.asarray(y))
    phase = np.array(jax.random.uniform(jax.random.PRNGKey(0), jmag.shape,
                                          minval=-np.pi, maxval=np.pi))
    want = np.asarray(jgl.griffin_lim(jmag, n_iters=3))
    got = tgl.griffin_lim(torch.from_numpy(np.array(jmag)), n_iters=3,
                          phase=torch.from_numpy(phase)).numpy()
    peak = np.abs(want).max()
    assert got.shape == want.shape and peak > 0.05
    assert np.abs(got - want).max() < 1e-4 * peak


def test_griffin_lim_seeded_phase_converges():
    """The port's own initial phase (CPU generator): 30 iterations bring the
    magnitude of the result close to the target."""
    y = _voiced(8192, 6)[None]
    mag, _ = tstft.stft_magnitude_phase(torch.from_numpy(y))
    p0 = tgl.initial_phase(mag.shape, seed=0)
    assert float(p0.min()) >= -np.pi and float(p0.max()) < np.pi
    assert torch.equal(p0, tgl.initial_phase(mag.shape, seed=0))

    def rel_err(n):
        rec = tgl.griffin_lim(mag, n_iters=n)
        mag2, _ = tstft.stft_magnitude_phase(rec)
        return float((mag2 - mag).abs().mean() / mag.abs().mean())

    e0, e30 = rel_err(0), rel_err(30)
    assert e30 < 0.2 and e30 < e0 / 2, (e0, e30)


def test_vocode_matches_with_injected_phase():
    """infer.synthesize.vocode: pinv of the filterbank, then Griffin-Lim;
    the JAX package's draw of the initial phase injected."""
    g = np.random.default_rng(12)
    L = 24
    mel = (g.normal(size=(L, 80)) - 4.0).astype(np.float32)
    phase = np.array(jax.random.uniform(jax.random.PRNGKey(0), (1, 513, L),
                                          minval=-np.pi, maxval=np.pi))
    want = jsynth.vocode(mel, JConfig(), gl_iters=3)
    got = tsynth.vocode(mel, TConfig(), gl_iters=3, device="cpu",
                        phase=torch.from_numpy(phase))
    assert got.shape == want.shape == ((L - 1) * 256,)
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    voc = tsynth.vocode(mel, TConfig(), vocoder=lambda m: np.ones(len(m) * 256))
    assert voc.shape == (L * 256,)


def test_write_wav_roundtrip(tmp_path):
    from scipy.io.wavfile import read

    wav = np.linspace(-2.0, 2.0, 1000).astype(np.float32)
    tsynth.write_wav(str(tmp_path / "t.wav"), wav, SR)
    jsynth.write_wav(str(tmp_path / "j.wav"), wav, SR)
    (sr, a), (_, b) = read(str(tmp_path / "t.wav")), read(str(tmp_path / "j.wav"))
    assert sr == SR and a.dtype == np.int16
    np.testing.assert_array_equal(a, b)


@pytest.fixture
def native_pair():
    """Both packages' native DIO, built on demand; skips where no C++
    toolchain is present (as tests/test_native.py does)."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("native toolchain unavailable")


@pytest.mark.parametrize("seed,f0", [(20, 120.0), (21, 230.0)])
def test_native_dio_matches_jax_package(native_pair, seed, f0):
    wav = _voiced(SR, seed, f0)
    wav[8000:11000] = 0.0  # an unvoiced gap
    got = tnative.dio(wav, SR, 256)
    np.testing.assert_array_equal(got, jnative.dio(wav, SR, 256))
    assert got.shape == (SR // 256 + 1,)
    voiced = got[5:25]
    assert (voiced > 0).all() and abs(np.median(voiced) - f0) < 0.2 * f0
    np.testing.assert_array_equal(tpitch.extract_pitch(wav, SR, 256),
                                  jpitch.extract_pitch(wav, SR, 256))


def test_autocorr_pitch_matches():
    wav = _voiced(6000, 22, 180.0)
    got = tpitch._autocorr_pitch(wav, SR, 256)
    np.testing.assert_array_equal(got, jpitch._autocorr_pitch(wav, SR, 256))
    assert (got[3:15] > 0).all()


def test_processing_helpers_match():
    g = np.random.default_rng(13)
    x = g.uniform(-1, 1, 64)
    for name, args in [("label_2_float", (g.integers(0, 512, 64), 9)),
                       ("float_2_label", (x, 9)), ("encode_16bits", (x,)),
                       ("encode_mu_law", (x, 512)),
                       ("decode_mu_law", (g.integers(0, 512, 64).astype(float), 512)),
                       ("amp_to_db", (np.abs(x),)), ("db_to_amp", (x * 20,)),
                       ("normalize_db", (x * 100 - 50, -100.0)),
                       ("denormalize_db", (x, -100.0))]:
        np.testing.assert_array_equal(getattr(tproc, name)(*args),
                                      getattr(jproc, name)(*args), err_msg=name)
    s = (g.integers(-2 ** 15, 2 ** 15, 64))
    for a, b in zip(tproc.split_signal(s), jproc.split_signal(s)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tproc.combine_signal(*tproc.split_signal(s)), s)


def test_read_metadata_matches(tmp_path):
    (tmp_path / "metadata.csv").write_text(
        'LJ001-0001|Printing, in the only sense|Printing, in the only sense\n'
        'LJ001-0002|in being comparatively modern.|in being "comparatively" modern.\n'
        'LJ001-0003|two fields\n', encoding="utf-8")
    got = t_read_metadata(str(tmp_path))
    assert got == j_read_metadata(str(tmp_path))
    assert got[0] == ["LJ001-0001", "LJ001-0002", "LJ001-0003"]
    assert got[1][1] == 'in being "comparatively" modern.'
