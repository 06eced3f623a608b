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

The inverse, for checkpoints: ``flat_to_jax(model, tensors)`` turns tensors
named like the model's parameters (the parameters themselves, or an
optimizer's moments) into the JAX package's flat ``/``-joined keys and
layouts; ``flat_from_jax(model, flat)`` is its strict inverse;
``state_to_jax`` / ``load_jax_state`` carry the BatchNorm running statistics.
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


def _jax_key(model: tnn.Module, name: str):
    """(JAX flat key, leaf) of the model parameter called ``name``."""
    mod_path, _, attr = name.rpartition(".")
    module = model.get_submodule(mod_path) if mod_path else model
    if attr == "alpha":
        leaf = "alpha"
    elif attr == "bias":
        leaf = "b"
    elif isinstance(module, (tnn.LayerNorm, tnn.BatchNorm1d)):
        leaf = "g"
    else:
        leaf = "w"
    return "/".join(filter(None, [mod_path.replace(".", "/"), leaf])), module, leaf


def flat_to_jax(model: tnn.Module, tensors: Mapping[str, torch.Tensor]
                ) -> Dict[str, np.ndarray]:
    """{parameter name: tensor} -> {JAX key: numpy array in the JAX layout}."""
    out = {}
    for name, t in tensors.items():
        key, module, leaf = _jax_key(model, name)
        a = t.detach().cpu().numpy()
        if leaf == "w" and isinstance(module, tnn.Linear):
            a = a.T
        elif leaf == "w" and isinstance(module, tnn.Conv1d):
            a = a.transpose(2, 1, 0)
        out[key] = np.array(a, order="C")  # (ascontiguousarray would make 0-dim 1-dim)
    return out


def flat_from_jax(model: tnn.Module, flat: Mapping[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
    """Strict inverse of :func:`flat_to_jax` over ALL of the model's
    parameters: raises KeyError on a missing leaf, ValueError on a shape
    mismatch or a leaf left over."""
    out = {}
    used = set()
    for name, p in model.named_parameters():
        key, module, leaf = _jax_key(model, name)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        a = _to_torch_layout(module, leaf, np.asarray(flat[key], np.float32))
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{tuple(a.shape)} vs model {tuple(p.shape)}")
        out[name] = torch.from_numpy(np.array(a, order="C"))
        used.add(key)
    extra = set(flat) - used
    if extra:
        raise ValueError(f"unexpected leaves {sorted(extra)[:5]}")
    return out


def _bn_layers(model: tnn.Module):
    post = getattr(model, "postnet", None)
    if post is None or not post.cfg.use_batch_norm:
        return []
    return [layer.bn for layer in post.layers]


def state_to_jax(model: tnn.Module) -> Dict[str, np.ndarray]:
    """The BatchNorm running statistics under the JAX state's flat keys."""
    out = {}
    for i, bn in enumerate(_bn_layers(model)):
        out[f"postnet/bn/{i}/mean"] = bn.running_mean.detach().cpu().numpy().copy()
        out[f"postnet/bn/{i}/var"] = bn.running_var.detach().cpu().numpy().copy()
    return out


@torch.no_grad()
def load_jax_state(model: tnn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Strict inverse of :func:`state_to_jax`, in place."""
    want = state_to_jax(model)
    if set(flat) != set(want):
        raise KeyError(f"state leaves differ: {sorted(set(flat) ^ set(want))[:5]}")
    for i, bn in enumerate(_bn_layers(model)):
        for stat, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
            a = np.asarray(flat[f"postnet/bn/{i}/{stat}"], np.float32)
            if tuple(a.shape) != tuple(buf.shape):
                raise ValueError(f"shape mismatch for postnet/bn/{i}/{stat}")
            buf.copy_(torch.from_numpy(a.copy()))
