"""Parameter initialisers (``fastspeech2_tpu/models/init.py`` and the
``init_*`` helpers of ``fastspeech2_tpu/ops/nn.py``), drawn from an explicit
``torch.Generator`` on the CPU and copied to the parameters' device.

``reset_parameters`` re-draws the torch module defaults, which are the JAX
package's "pytorch" init: Linear/Conv1d weight and bias
~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)); Embedding ~ N(0, 1) with the padding row
zeroed; LayerNorm and BatchNorm gamma = 1, beta = 0. The scaled-PE ``alpha``
(0-dim) is left as constructed.

``apply_transformer_init`` applies the reference's ``initialize(model,
init_type)`` for any init_type other than "pytorch":

1. every parameter with ``dim > 1`` -> xavier_uniform / xavier_normal /
   kaiming_uniform / kaiming_normal (kaiming with gain sqrt(2), fan_in mode);
2. every ``dim == 1`` parameter -> zero;
3. Embedding and LayerNorm -> reset (Embedding keeps its N(0, 1) draw with the
   padding row zeroed; LayerNorm back to gamma = 1, beta = 0).

The quirk is kept on purpose: BatchNorm1d is not in the reset list, so step 2
leaves the postnet's BN gamma and beta at zero and the postnet residual starts
at exactly 0. The values cannot equal the JAX package's draws (another
generator); the distributions and the quirks do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn as tnn

INIT_TYPES = ("pytorch", "xavier_uniform", "xavier_normal",
              "kaiming_uniform", "kaiming_normal")


def _fans(shape):
    """(fan_in, fan_out) of a torch-layout weight: Linear (out, in); Conv1d
    (out, in, k) with receptive field k."""
    rf = 1
    for d in shape[2:]:
        rf *= d
    return shape[1] * rf, shape[0] * rf


def _uniform_(p: torch.Tensor, bound: float, g: Optional[torch.Generator]):
    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))


def _normal_(p: torch.Tensor, std: float, g: Optional[torch.Generator]):
    p.copy_(torch.empty(p.shape).normal_(0.0, std, generator=g))


def _reset_embedding(m: tnn.Embedding, g):
    _normal_(m.weight, 1.0, g)
    if m.padding_idx is not None:
        m.weight[m.padding_idx].zero_()


@torch.no_grad()
def reset_parameters(model: tnn.Module,
                     generator: Optional[torch.Generator] = None) -> None:
    """Re-draw every module's default ("pytorch") init from ``generator``,
    in module order."""
    for m in model.modules():
        if isinstance(m, (tnn.Linear, tnn.Conv1d)):
            bound = 1.0 / math.sqrt(_fans(m.weight.shape)[0])
            _uniform_(m.weight, bound, generator)
            if m.bias is not None:
                _uniform_(m.bias, bound, generator)
        elif isinstance(m, tnn.Embedding):
            _reset_embedding(m, generator)
        elif isinstance(m, (tnn.LayerNorm, tnn.BatchNorm1d)):
            m.weight.fill_(1.0)
            m.bias.zero_()


def _draw_(p: torch.Tensor, init_type: str, g) -> None:
    fan_in, fan_out = _fans(p.shape)
    if init_type == "xavier_uniform":
        _uniform_(p, math.sqrt(6.0 / (fan_in + fan_out)), g)
    elif init_type == "xavier_normal":
        _normal_(p, math.sqrt(2.0 / (fan_in + fan_out)), g)
    elif init_type == "kaiming_uniform":
        _uniform_(p, math.sqrt(2.0) * math.sqrt(3.0 / fan_in), g)
    elif init_type == "kaiming_normal":
        _normal_(p, math.sqrt(2.0) / math.sqrt(fan_in), g)
    else:
        raise ValueError("Unknown initialization: " + init_type)


@torch.no_grad()
def apply_transformer_init(model: tnn.Module, init_type: str,
                           generator: Optional[torch.Generator] = None) -> None:
    """The reference's ``initialize()`` on a default-initialised model, in
    place; "pytorch" is the identity."""
    if init_type == "pytorch":
        return
    if init_type not in INIT_TYPES:
        raise ValueError("Unknown initialization: " + init_type)
    for p in model.parameters():
        if p.dim() > 1:
            _draw_(p, init_type, generator)
        elif p.dim() == 1:
            p.zero_()
    for m in model.modules():
        if isinstance(m, tnn.Embedding):
            _reset_embedding(m, generator)
        elif isinstance(m, tnn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
