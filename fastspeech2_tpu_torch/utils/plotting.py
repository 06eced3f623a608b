"""Plot helpers for TensorBoard images (reference ``utils/plot.py:56-93``).

matplotlib is an optional dependency: without it the functions return a simple
normalized-colormap array instead of a rendered figure, so headless training
still logs usable images.
"""

from __future__ import annotations

import numpy as np


def _render_figure(fig) -> np.ndarray:
    fig.canvas.draw()
    data = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    img = data.reshape(h, w, 4)[..., :3]
    import matplotlib.pyplot as plt

    plt.close(fig)
    return img.transpose(2, 0, 1)  # CHW for tensorboard


def _colormap_fallback(x: np.ndarray) -> np.ndarray:
    """(H, W) array -> (3, H, W) uint8 grayscale-ish image without matplotlib."""
    lo, hi = float(x.min()), float(x.max())
    norm = (x - lo) / max(hi - lo, 1e-9)
    img = (norm * 255).astype(np.uint8)
    return np.stack([img, img, img])


def plot_spectrogram_to_numpy(mel: np.ndarray) -> np.ndarray:
    """(n_mels, T) mel -> (3, H, W) uint8 image (reference utils/plot.py:82-93)."""
    mel = np.asarray(mel)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 4))
        im = ax.imshow(mel, aspect="auto", origin="lower", interpolation="none")
        plt.colorbar(im, ax=ax)
        ax.set_xlabel("Frames")
        ax.set_ylabel("Channels")
        plt.tight_layout()
        return _render_figure(fig)
    except Exception:
        return _colormap_fallback(mel[::-1])


def plot_waveform_to_numpy(wav: np.ndarray) -> np.ndarray:
    """(N,) waveform -> (3, H, W) uint8 image (reference utils/plot.py:56-79)."""
    wav = np.asarray(wav)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(12, 4))
        ax.plot(wav, linewidth=0.5)
        ax.set_xlabel("Samples")
        ax.set_ylabel("Amplitude")
        plt.tight_layout()
        return _render_figure(fig)
    except Exception:
        h = 64
        img = np.zeros((h, max(len(wav) // 64, 1)), np.float32)
        return _colormap_fallback(img)


def save_spectrogram_png(mel: np.ndarray, path: str) -> None:
    """Write the (n_mels, T) mel as a PNG file (reference inference.py:178
    saves mel.png next to mel.npy). Uses matplotlib when available, else the
    dependency-free fallback image via PIL, else skips with an error."""
    mel = np.asarray(mel)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 4))
        im = ax.imshow(mel, aspect="auto", origin="lower", interpolation="none")
        plt.colorbar(im, ax=ax)
        ax.set_xlabel("Frames")
        ax.set_ylabel("Channels")
        plt.tight_layout()
        fig.savefig(path)
        plt.close(fig)
        return
    except Exception:
        pass
    from PIL import Image  # pillow ships with matplotlib-less installs too

    img = _colormap_fallback(mel[::-1]).transpose(1, 2, 0)
    Image.fromarray(img).save(path)
