"""Shared utilities: plotting/TB image helpers and terminal display
(the port's copies of the JAX package's ``utils/plotting.py`` and
``utils/display.py``, which use no JAX)."""

from fastspeech2_tpu_torch.utils.plotting import (  # noqa: F401
    plot_spectrogram_to_numpy,
    plot_waveform_to_numpy,
)
