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
output's peak (its phases go through atan2 three times).
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
