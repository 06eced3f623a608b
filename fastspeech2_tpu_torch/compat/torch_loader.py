"""Reference PyTorch checkpoints (``.pth``/``.pyt``) into the port
(``fastspeech2_tpu/compat/torch_loader.py``).

``name_map(cfg)`` is the one map between the reference's ``state_dict`` keys
and the JAX params tree's flat ``/``-joined keys (the keys of the ``.npz``
checkpoints, ``train/checkpoint.py``); ``compat/torch_saver.py`` walks the
same map the other way. A torch Linear weight (out, in) and Conv1d weight
(out, in, k) become the JAX layouts (in, out) and (k, in, out) by reversing
their axes; embeddings and norms are copied. The key names follow the
reference module tree (``fastspeech.py``, ``core/encoder.py``,
``core/duration_modeling/duration_predictor.py``,
``core/variance_predictor.py``, ``core/modules.py``).

``load_torch_checkpoint(path, cfg)`` returns the JAX-layout ``(params,
state)`` trees, which ``compat/from_jax.py:load_jax_params`` puts into a
``FastSpeech2``. Formats and released-checkpoint traps handled:

- a dict with ``model`` (the state_dict), ``hp_str``, ``step``: the config is
  rebuilt from ``hp_str`` unless a config is given;
- a bare state_dict ("old model" format): the given config, else the default;
- the ``encoders`` -> ``encoders_`` module rename: either name is read;
- an undersized symbol embedding (56-symbol-era checkpoints): zero-padded to
  the frontend vocabulary with a warning.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from fastspeech2_tpu_torch.config import Config

log = logging.getLogger(__name__)

#: (reference key, tree, flat JAX key, layout): tree is "params" or "state";
#: layout "T" reverses the axes (Linear/Conv1d weights), "copy" keeps them,
#: "scalar" reshapes to 0-dim (the scaled-PE alphas)
Entry = Tuple[str, str, str, str]


def _encoder_map(prefix: str, num_blocks: int, input_layer: str,
                 normalize_before: bool, concat_after: bool,
                 use_scaled_pos_enc: bool) -> List[Entry]:
    out: List[Entry] = []

    def add(key, jkey, layout="copy"):
        out.append((f"{prefix}.{key}", "params", f"{prefix}/{jkey}", layout))

    def linear(key, jkey):
        add(f"{key}.weight", f"{jkey}/w", "T")
        add(f"{key}.bias", f"{jkey}/b")

    def norm(key, jkey):
        add(f"{key}.weight", f"{jkey}/g")
        add(f"{key}.bias", f"{jkey}/b")

    if input_layer == "embed":
        add("embed.0.weight", "embed/w")
        pe_idx = 1
    else:  # Sequential(Linear, LayerNorm, Dropout, ReLU, PE)
        linear("embed.0", "input_linear")
        norm("embed.1", "input_ln")
        pe_idx = 4
    if use_scaled_pos_enc:
        add(f"embed.{pe_idx}.alpha", "alpha", "scalar")
    for i in range(num_blocks):
        lp, jp = f"encoders_.{i}", f"layers/{i}"
        for name in ("q", "k", "v", "out"):
            linear(f"{lp}.self_attn.linear_{name}", f"{jp}/attn/{name}")
        linear(f"{lp}.feed_forward.w_1", f"{jp}/ffn/w1")
        linear(f"{lp}.feed_forward.w_2", f"{jp}/ffn/w2")
        norm(f"{lp}.norm1", f"{jp}/norm1")
        norm(f"{lp}.norm2", f"{jp}/norm2")
        if concat_after:
            linear(f"{lp}.concat_linear", f"{jp}/concat")
    if normalize_before:
        norm("after_norm", "after_norm")
    return out


def _predictor_map(prefix: str, jprefix: str, n_layers: int) -> List[Entry]:
    out: List[Entry] = []
    for i in range(n_layers):
        out += [(f"{prefix}.conv.{i}.0.weight", "params", f"{jprefix}/convs/{i}/conv/w", "T"),
                (f"{prefix}.conv.{i}.0.bias", "params", f"{jprefix}/convs/{i}/conv/b", "copy"),
                (f"{prefix}.conv.{i}.2.layer_norm.weight", "params",
                 f"{jprefix}/convs/{i}/ln/g", "copy"),
                (f"{prefix}.conv.{i}.2.layer_norm.bias", "params",
                 f"{jprefix}/convs/{i}/ln/b", "copy")]
    return out + [(f"{prefix}.linear.weight", "params", f"{jprefix}/out/w", "T"),
                  (f"{prefix}.linear.bias", "params", f"{jprefix}/out/b", "copy")]


def name_map(cfg: Config) -> List[Entry]:
    """Every parameter and BatchNorm statistic of the model ``cfg`` builds,
    as (reference key, tree, flat JAX key, layout)."""
    m = cfg.model
    out = _encoder_map("encoder", m.elayers, "embed", m.encoder_normalize_before,
                       m.encoder_concat_after, m.use_scaled_pos_enc)
    out += _predictor_map("duration_predictor", "duration_predictor",
                          m.duration_predictor_layers)
    out += _predictor_map("energy_predictor.predictor", "energy_predictor", 2)
    out += _predictor_map("pitch_predictor.predictor", "pitch_predictor", 2)
    for name in ("energy_embed", "pitch_embed", "feat_out"):
        out += [(f"{name}.weight", "params", f"{name}/w", "T"),
                (f"{name}.bias", "params", f"{name}/b", "copy")]
    out += _encoder_map("decoder", m.dlayers, "linear", m.decoder_normalize_before,
                        m.decoder_concat_after, m.use_scaled_pos_enc)
    for i in range(m.postnet_layers):
        p, j = f"postnet.postnet.{i}", f"postnet/layers/{i}"
        out.append((f"{p}.0.weight", "params", f"{j}/conv/w", "T"))
        if m.use_batch_norm:
            out += [(f"{p}.1.weight", "params", f"{j}/bn/g", "copy"),
                    (f"{p}.1.bias", "params", f"{j}/bn/b", "copy"),
                    (f"{p}.1.running_mean", "state", f"postnet/bn/{i}/mean", "copy"),
                    (f"{p}.1.running_var", "state", f"postnet/bn/{i}/var", "copy")]
    return out


def to_layout(a: np.ndarray, layout: str) -> np.ndarray:
    """One step of the map, either way: the axis reversal is its own inverse."""
    if layout == "T":
        return np.ascontiguousarray(a.T)
    if layout == "scalar":
        return np.array(a).reshape(())
    return np.array(a)


def unflatten(flat: Dict[str, np.ndarray]) -> dict:
    """Flat ``/``-joined keys -> the JAX nested tree (digit levels -> lists)."""
    tree: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


def _lookup(sd: Dict[str, np.ndarray], key: str) -> np.ndarray:
    """A state_dict entry under its name or the pre-rename ``encoders``."""
    if key in sd:
        return sd[key]
    alt = key.replace(".encoders_.", ".encoders.")
    if alt in sd:
        return sd[alt]
    raise KeyError(f"checkpoint missing key {key} (and {alt})")


def params_from_state_dict(state_dict: Dict[str, np.ndarray], cfg: Config
                           ) -> Tuple[dict, dict]:
    """Reference state_dict (numpy arrays) -> (params, state) JAX-layout trees
    for the model ``cfg`` builds."""
    from fastspeech2_tpu_torch.text.symbols import NUM_PHONEMES

    flat: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "state": {}}
    for key, tree, jkey, layout in name_map(cfg):
        flat[tree][jkey] = to_layout(np.asarray(_lookup(state_dict, key)), layout)
    emb = flat["params"]["encoder/embed/w"]
    if emb.shape[0] < NUM_PHONEMES:
        # token ids past the checkpoint's rows embed to a deterministic zero
        # vector (and say so) instead of indexing out of range
        log.warning("checkpoint embedding has %d symbol rows < frontend vocabulary "
                    "%d (a released-checkpoint quirk); ids >= %d will embed to zeros",
                    emb.shape[0], NUM_PHONEMES, emb.shape[0])
        pad = np.zeros((NUM_PHONEMES - emb.shape[0], emb.shape[1]), emb.dtype)
        flat["params"]["encoder/embed/w"] = np.concatenate([emb, pad], axis=0)
    state = unflatten(flat["state"])
    if cfg.model.postnet_layers > 0:
        state.setdefault("postnet", {"bn": []})
    return unflatten(flat["params"]), state


def load_torch_checkpoint(path: str, cfg: Optional[Config] = None
                          ) -> Tuple[dict, dict, Config, int]:
    """A reference ``.pth``/``.pyt`` file -> (params, state, cfg, step). The
    config comes from ``cfg`` when given, else the checkpoint's ``hp_str``,
    else the defaults."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    step = 0
    if isinstance(ckpt, dict) and "model" in ckpt:
        sd = ckpt["model"]
        step = int(ckpt.get("step", 0))
        if cfg is None and "hp_str" in ckpt:
            cfg = Config.from_yaml(ckpt["hp_str"])
    else:
        sd = ckpt
    if cfg is None:
        cfg = Config()
    sd_np = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    params, state = params_from_state_dict(sd_np, cfg)
    return params, state, cfg, step


def load_torch_model(path: str, cfg: Optional[Config] = None, device=None):
    """(cfg, step, ``FastSpeech2`` on ``device`` with the checkpoint's
    weights), through ``compat/from_jax.py:load_jax_params``."""
    from fastspeech2_tpu_torch.compat.from_jax import load_jax_params
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2

    params, state, cfg, step = load_torch_checkpoint(path, cfg)
    model = FastSpeech2(cfg, device=device)
    load_jax_params(model, params, state)
    return cfg, step, model
