"""Audio DSP of the port (``fastspeech2_tpu/audio/``): STFT, mel filterbank,
energy, pitch, Griffin-Lim.

Torch versions on the tensor's device; on the card the fused STFT -> mel ->
energy path is kernel 14 (``ops/kernels/stft.py``).
"""

from fastspeech2_tpu_torch.audio.stft import (  # noqa: F401
    MelSpectrogram,
    energy_from_magnitude,
    hann_window,
    mel_filterbank,
    stft_magnitude_phase,
)
