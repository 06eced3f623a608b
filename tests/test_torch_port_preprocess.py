"""The port's ``preprocess`` and ``stats`` commands (``fastspeech2_tpu_torch/cli.py``)
against the JAX package's on the CPU, on the same four short 16-bit wavs.

Tolerances: each mel and energy ``.npy`` 1e-4 (rtol and atol; the energies'
atol 1e-4 of their peak: both are f32 DFT sums taken in another order),
pitch exact (both packages take the same branch on one machine: pyworld,
native DIO or the autocorrelation tracker), the same dtypes; the statistics
1e-6 relative.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io.wavfile import write as write_wav

from fastspeech2_tpu import cli as jcli
from fastspeech2_tpu_torch import cli as tcli
from fastspeech2_tpu_torch.data.dataset import TTSDataset
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

SR = 22050
ROOT = Path(__file__).resolve().parents[1]


def _utterance(n, seed):
    """Harmonics on a gliding f0 with an envelope, noise and an unvoiced gap."""
    g = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = 110.0 + 60.0 * seed + 30.0 * np.sin(2 * np.pi * 0.8 * t)
    ph = 2 * np.pi * np.cumsum(f0) / SR
    y = sum(0.25 / k * np.sin(k * ph) for k in range(1, 7))
    y = y * np.abs(np.sin(np.pi * t / t[-1])) ** 0.5 + 0.005 * g.normal(size=n)
    y[n // 3: n // 3 + 2000] = 0.01 * g.normal(size=2000)
    return y


def _same_pitch_branch():
    """Both packages must take the same pitch branch. The JAX package
    compiles its native library in place, not atomically: in a fresh
    checkout, a test worker can load the library while another worker is
    still writing it, take that for a missing toolchain and use the
    autocorrelation tracker for the rest of its process. Load it again once
    the writer is done (its module state only; nothing of it is edited)."""
    from fastspeech2_tpu import native as jnative
    from fastspeech2_tpu_torch import native as tnative

    for _ in range(60):
        if jnative.available() or not tnative.available():
            break
        time.sleep(1.0)
        jnative._build_failed = False
    assert jnative.available() == tnative.available()


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Four wavs (one in a subfolder), preprocessed by both packages."""
    _same_pitch_branch()
    root = tmp_path_factory.mktemp("pre")
    wavs = root / "wavs"
    (wavs / "sub").mkdir(parents=True)
    lens = [13000, 20000, 9000, 17000]
    for i, n in enumerate(lens):
        pcm = np.round(np.clip(_utterance(n, i), -1, 1) * 32767).astype(np.int16)
        write_wav(str(wavs / ("sub" if i == 3 else "") / f"LJ{i:03d}.wav"), SR, pcm)
    jcli.cmd_preprocess(argparse.Namespace(data_path=str(wavs), config=None,
                                           out=str(root / "jax")))
    tcli.main(["preprocess", "-d", str(wavs), "-o", str(root / "port"), "--device", "cpu"])
    return root, lens


def _stats(fn, data_dir):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(data_dir)
    return json.loads(buf.getvalue())


@pytest.mark.parametrize("kind", ["mels", "energy", "pitch"])
def test_preprocess_store_matches_jax_package(stores, kind):
    root, lens = stores
    names = sorted(os.listdir(root / "jax" / kind))
    assert names == sorted(os.listdir(root / "port" / kind)) == [
        f"LJ{i:03d}.npy" for i in range(4)]
    for name, n in zip(names, lens):
        got, want = np.load(root / "port" / kind / name), np.load(root / "jax" / kind / name)
        F = n // 256 + 1
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.shape == ((80, F) if kind == "mels" else (F,))
        if kind == "pitch":
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.float64 and (got > 0).mean() > 0.5
        else:
            assert got.dtype == np.float32
            atol = 1e-4 * np.abs(want).max() if kind == "energy" else 1e-4
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


def test_stats_match_jax_package(stores):
    root, _ = stores
    got = _stats(lambda d: tcli.main(["stats", "-d", d]), str(root / "port"))
    want = _stats(lambda d: jcli.cmd_stats(argparse.Namespace(config=None, data_dir=d)),
                  str(root / "jax"))
    assert set(got) == set(want) == {"e_mean", "e_std", "e_min", "e_max",
                                     "f0_mean", "f0_std", "p_min", "p_max"}
    for k in want:
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= 1e-6 * abs(want[k]), k
    for name in ("e_mean", "e_std", "f0_mean", "f0_std"):
        a, b = np.load(root / "port" / f"{name}.npy"), np.load(root / "jax" / f"{name}.npy")
        assert a.dtype == b.dtype == np.float32 and abs(a - b) <= 1e-6 * abs(b)


def test_dataset_reads_the_preprocessed_store(stores):
    """A filelist whose durations sum to each utterance's frame count: every
    utterance loads through the port's TTSDataset."""
    root, lens = stores
    lines = []
    for i, n in enumerate(lens):
        F = n // 256 + 1
        durs = [F // 4] * 3 + [F - 3 * (F // 4)]
        starts = np.concatenate([[0], np.cumsum(durs)[:-1]])
        lines.append(f"t|{' '.join(map(str, starts))}|{' '.join(map(str, durs))}|"
                     f"HH AH0 L OW1|LJ{i:03d}.wav")
    fl = root / "filelist.txt"
    fl.write_text("\n".join(lines) + "\n")
    ds = TTSDataset(str(root / "port"), str(fl))
    assert list(ds.frame_lengths()) == [n // 256 + 1 for n in lens]
    for i, n in enumerate(lens):
        u = ds[i]
        F = n // 256 + 1
        assert u.mel.shape == (F, 80) and u.energy.shape == u.pitch.shape == (F,)
        assert int(u.durations.sum()) == F and np.isfinite(u.mel).all()


def test_preprocess_refuses_an_empty_folder_and_a_missing_card(tmp_path):
    with pytest.raises(SystemExit, match="no .wav files"):
        tcli.main(["preprocess", "-d", str(tmp_path), "-o", str(tmp_path / "o"),
                   "--device", "cpu"])
    if not torch.cuda.is_available():  # the entry point's default is the card
        write_wav(str(tmp_path / "a.wav"), SR, np.zeros(3000, np.int16))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["preprocess", "-d", str(tmp_path), "-o", str(tmp_path / "o")])


def test_module_entry_point_runs_stats(stores):
    """``python -m fastspeech2_tpu_torch stats`` in a fresh interpreter."""
    root, _ = stores
    r = subprocess.run([sys.executable, "-m", "fastspeech2_tpu_torch", "stats",
                        "-d", str(root / "port")], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert set(json.loads(r.stdout)) >= {"e_mean", "f0_mean", "p_max"}
