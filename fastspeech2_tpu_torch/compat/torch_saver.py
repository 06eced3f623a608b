"""The port's weights out to a reference PyTorch checkpoint
(``fastspeech2_tpu/compat/torch_saver.py``).

The inverse of ``compat/torch_loader.py``, over the same ``name_map``: a
model's parameters and BatchNorm statistics in the JAX layout (the flat
keys of ``train/checkpoint.py:snapshot``) become the reference's
``state_dict``. The reference also holds buffers and modules that the JAX
tree has no leaf for, written so that ``load_state_dict(strict=True)``
passes there: each stack's sinusoid table (``embed.N.pe``), the pitch and
energy bin edges, the always-allocated ``concat_linear`` (zeros when
``concat_after`` is off), ``after_norm`` (ones and zeros when
``normalize_before`` is off) and the BatchNorms' ``num_batches_tracked``.
The file is the reference's training checkpoint: ``model``, ``optim`` (empty:
the optimizer state is not translated), ``step``, ``hp_str``, ``githash``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from fastspeech2_tpu_torch.compat.torch_loader import name_map, to_layout
from fastspeech2_tpu_torch.config import Config


def state_dict_from_model(model, cfg: Config) -> Dict[str, np.ndarray]:
    """The reference state_dict (numpy arrays, torch naming) of a port
    ``FastSpeech2``."""
    from fastspeech2_tpu_torch.models.encoder import sinusoid_table
    from fastspeech2_tpu_torch.ops.quantize import linear_bins, log_bins
    from fastspeech2_tpu_torch.train.checkpoint import snapshot

    flat = snapshot(model)  # "params::<JAX key>" and "state::<JAX key>"
    m, d = cfg.model, cfg.data
    sd = {key: to_layout(np.asarray(flat[f"{tree}::{jkey}"], np.float32), layout)
          for key, tree, jkey, layout in name_map(cfg)}
    for prefix, dim, pe_idx, normalize_before, concat_after, n in (
            ("encoder", m.adim, 1, m.encoder_normalize_before, m.encoder_concat_after,
             m.elayers),
            ("decoder", m.ddim, 4, m.decoder_normalize_before, m.decoder_concat_after,
             m.dlayers)):
        # the reference's PE table is a registered buffer: ship the port's
        # values so the reference reproduces this model's outputs
        sd[f"{prefix}.embed.{pe_idx}.pe"] = sinusoid_table(m.max_pos_len, dim)[None]
        for i in range(n if not concat_after else 0):
            sd[f"{prefix}.encoders_.{i}.concat_linear.weight"] = np.zeros(
                (dim, 2 * dim), np.float32)
            sd[f"{prefix}.encoders_.{i}.concat_linear.bias"] = np.zeros((dim,), np.float32)
        if not normalize_before:  # allocated always, applied only pre-LN
            sd[f"{prefix}.after_norm.weight"] = np.ones((dim,), np.float32)
            sd[f"{prefix}.after_norm.bias"] = np.zeros((dim,), np.float32)
    sd["energy_predictor.energy_bins"] = linear_bins(d.e_min, d.e_max, m.variance_n_bins)
    sd["pitch_predictor.pitch_bins"] = log_bins(d.p_min, d.p_max, m.variance_n_bins)
    for i in range(m.postnet_layers if m.use_batch_norm else 0):
        sd[f"postnet.postnet.{i}.1.num_batches_tracked"] = np.asarray(0, np.int64)
    return sd


def save_torch_checkpoint(path: str, model, cfg: Config, step: int = 0,
                          githash: Optional[str] = None) -> None:
    """Write ``model`` as a reference-format ``.pth``/``.pyt`` checkpoint."""
    from fastspeech2_tpu_torch.train.checkpoint import git_hash

    # np.array(copy) keeps 0-dim shapes (the PE alphas) and makes the
    # buffers writable for torch
    sd = {k: torch.as_tensor(np.array(v, copy=True))
          for k, v in state_dict_from_model(model, cfg).items()}
    torch.save({"model": sd, "optim": {}, "step": int(step), "hp_str": cfg.to_yaml(),
                "githash": git_hash() if githash is None else githash}, path)
