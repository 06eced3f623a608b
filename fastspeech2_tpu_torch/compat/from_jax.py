"""Carry the JAX package's weights into the port.

``load_jax_params(model, params, state)`` takes the JAX params and state as
nested dicts (lists for stacked layers) of numpy arrays -- e.g.
``jax.device_get`` of ``FastSpeech2.init`` or of a checkpoint -- and fills the
port's modules with strict checking: every tensor of the model's state dict
must be set, with its exact shape, and no JAX leaf may be left over.

Layouts: JAX linear weights are (in, out), torch (out, in); JAX conv weights
are (k, in, out), torch (out, in, k). Leaf names map ``w`` -> ``weight``,
``b`` -> ``bias``, ``g`` -> ``weight`` (norms); the postnet BatchNorm running
statistics come from ``state["postnet"]["bn"]``.

``load_jax_melgan_params(gen, params)`` does the same for the MelGAN
generator.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn as tnn


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree, np.float32)


def _to_torch_layout(module: tnn.Module, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf == "w" and isinstance(module, tnn.Linear):
        return a.T
    if leaf == "w" and isinstance(module, tnn.Conv1d):
        return a.transpose(2, 1, 0)
    return a


_LEAF = {"w": "weight", "b": "bias", "g": "weight", "alpha": "alpha"}


def state_dict_from_jax(model: tnn.Module, params, state=None
                        ) -> Dict[str, torch.Tensor]:
    """The port's state dict built from JAX params/state (see module doc)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, a in _flatten(params):
        mod_path, _, leaf = path.rpartition(".")
        if leaf not in _LEAF:
            raise KeyError(f"unexpected JAX leaf {path!r}")
        module = model.get_submodule(mod_path) if mod_path else model
        name = f"{mod_path}.{_LEAF[leaf]}" if mod_path else _LEAF[leaf]
        sd[name] = torch.from_numpy(np.array(_to_torch_layout(module, leaf, a),
                                             order="C"))
    for i, s in enumerate((state or {}).get("postnet", {}).get("bn", [])):
        sd[f"postnet.layers.{i}.bn.running_mean"] = torch.from_numpy(
            np.array(s["mean"], np.float32))
        sd[f"postnet.layers.{i}.bn.running_var"] = torch.from_numpy(
            np.array(s["var"], np.float32))
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            sd[name] = t.clone()
    return sd


def load_jax_params(model: tnn.Module, params, state=None) -> tnn.Module:
    """Fill ``model`` in place from the JAX params/state; strict: raises on
    a missing or unexpected key and on any shape mismatch."""
    sd = state_dict_from_jax(model, params, state)
    own = model.state_dict()
    for name, t in sd.items():
        if name in own and tuple(own[name].shape) != tuple(t.shape):
            raise ValueError(f"{name}: JAX shape {tuple(t.shape)} != port "
                             f"shape {tuple(own[name].shape)}")
    model.load_state_dict(sd, strict=True)
    return model


def load_jax_melgan_params(gen: tnn.Module, params) -> tnn.Module:
    """Fill a ``vocoder.melgan.MelGANGenerator`` in place from the JAX
    generator's params tree (``init_melgan`` / ``load_melgan_params``).

    JAX conv weights (k, in, out) become torch Conv1d weights (out, in, k).
    The JAX ``up`` weights are stored in ``lax.conv_transpose``'s orientation
    (k, in, out), spatially flipped relative to torch's ConvTranspose1d; the
    port keeps torch's orientation (in, out, k), so they are flipped back
    here. Strict: raises on a missing or unexpected key and on any shape
    mismatch."""
    sd: Dict[str, torch.Tensor] = {}
    for path, a in _flatten(params):
        mod_path, _, leaf = path.rpartition(".")
        if leaf not in ("w", "b"):
            raise KeyError(f"unexpected JAX leaf {path!r}")
        module = gen.get_submodule(mod_path)
        if leaf == "w" and isinstance(module, tnn.ConvTranspose1d):
            a = a[::-1].transpose(1, 2, 0)
        elif leaf == "w":
            a = a.transpose(2, 1, 0)
        sd[f"{mod_path}.{_LEAF[leaf]}"] = torch.from_numpy(np.array(a, order="C"))
    own = gen.state_dict()
    for name, t in sd.items():
        if name in own and tuple(own[name].shape) != tuple(t.shape):
            raise ValueError(f"{name}: JAX shape {tuple(t.shape)} != port "
                             f"shape {tuple(own[name].shape)}")
    gen.load_state_dict(sd, strict=True)
    return gen
