"""Neural vocoder stage, downstream of text -> mel
(``fastspeech2_tpu/vocoder``).

MelGAN (``vocoder/melgan.py``) and WaveGlow (``vocoder/waveglow.py``);
``load_vocoder`` sniffs which family a torch checkpoint belongs to.
"""

from fastspeech2_tpu_torch.vocoder.melgan import (  # noqa: F401
    MelGANConfig,
    MelGANGenerator,
    load_melgan,
    load_melgan_params,
    load_melgan_state_dict,
    melgan_config_from_checkpoint,
    melgan_state_dict,
)
from fastspeech2_tpu_torch.vocoder.waveglow import (  # noqa: F401
    WaveGlow,
    WaveGlowConfig,
    init_waveglow,
    load_waveglow,
    load_waveglow_params,
    nvidia_state_dict,
    waveglow_params_from_torch,
)


def detect_vocoder_kind(path: str) -> str:
    """'melgan' | 'waveglow' from a torch checkpoint's key names (WaveGlow
    carries WN.{k}./convinv.{k}. modules; MelGAN a generator Sequential)."""
    import torch

    try:  # meta: key names without materializing weights
        obj = torch.load(path, map_location="meta", weights_only=False)
    except Exception:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "waveglow", "model_g", "generator"):
        if isinstance(obj, dict) and key in obj and obj[key] is not None:
            inner = obj[key]
            if isinstance(inner, dict):
                obj = inner
            elif hasattr(inner, "state_dict"):
                # NVIDIA train-style layout: a pickled nn.Module under the key
                obj = inner.state_dict()
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    keys = " ".join(obj.keys()) if isinstance(obj, dict) else ""
    return "waveglow" if ("WN." in keys or "convinv." in keys) else "melgan"


def load_vocoder(path: str, kind: str = "auto", **kw):
    """Load either vocoder family as a ``(L, n_mels) log-mel -> (L*hop,)
    waveform`` callable for ``infer.synthesize.vocode`` (f32 unless
    ``bf16=True`` is passed)."""
    if kind == "auto":
        kind = detect_vocoder_kind(path)
    if kind == "waveglow":
        return load_waveglow(path, **kw)
    return load_melgan(path, **kw)
