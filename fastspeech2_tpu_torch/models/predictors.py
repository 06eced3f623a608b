"""Duration / pitch / energy predictors
(``fastspeech2_tpu/models/predictors.py``).

n_layers x [Conv1d(k) -> ReLU -> LayerNorm(eps 1e-12 over channels) ->
Dropout] -> Linear(chans, 1). Durations train in the log domain and convert
as ``clamp(round(exp(x) - 1), min=0)`` (round half to even in both
frameworks) at inference; padded positions are zeroed. One dropout site per
layer, named by its index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch
from torch import nn as tnn

from fastspeech2_tpu_torch.ops import nn

_LN_EPS = 1e-12


@dataclass(frozen=True)
class PredictorConfig:
    idim: int = 256
    n_layers: int = 2
    n_chans: int = 256
    kernel_size: int = 3
    dropout_rate: float = 0.5
    offset: float = 1.0


class PredictorLayer(tnn.Module):
    def __init__(self, in_ch: int, cfg: PredictorConfig, device=None):
        super().__init__()
        k = cfg.kernel_size
        self.conv = tnn.Conv1d(in_ch, cfg.n_chans, k, padding=(k - 1) // 2,
                               device=device)
        self.ln = tnn.LayerNorm(cfg.n_chans, eps=_LN_EPS, device=device)


class Predictor(tnn.Module):
    """Conv stack -> scalar head: (B, T, idim) -> (B, T) raw values."""

    def __init__(self, cfg: PredictorConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.convs = tnn.ModuleList(
            PredictorLayer(cfg.idim if i == 0 else cfg.n_chans, cfg, device=device)
            for i in range(cfg.n_layers))
        self.out = tnn.Linear(cfg.n_chans, 1, device=device)

    def forward(self, xs: torch.Tensor,
                conv_mask: Optional[torch.Tensor] = None, *,
                seeds: Optional[Mapping[str, int]] = None,
                deterministic: bool = True) -> torch.Tensor:
        h = xs
        for i, layer in enumerate(self.convs):
            if conv_mask is not None:
                h = torch.where(conv_mask[..., None], h, torch.zeros_like(h))
            h = torch.relu(nn.conv1d(h, layer.conv.weight, layer.conv.bias))
            h = nn.layer_norm(h, layer.ln.weight, layer.ln.bias, eps=_LN_EPS)
            h = nn.dropout(h, self.cfg.dropout_rate,
                           None if deterministic else seeds[str(i)],
                           deterministic=deterministic)
        return nn.linear(h, self.out.weight, self.out.bias)[..., 0]

    def masked(self, xs: torch.Tensor, mask: torch.Tensor, **kw) -> torch.Tensor:
        """Raw prediction zeroed at padded positions: the training form of
        the duration (log domain) and variance (linear domain) heads."""
        out = self(xs, **kw)
        return torch.where(mask, out, torch.zeros_like(out))

    def durations(self, hs: torch.Tensor, tok_mask: torch.Tensor,
                  conv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Linear-domain integer durations (B, T) int32."""
        out = self(hs, conv_mask)
        d = torch.clamp_min(torch.round(torch.exp(out) - self.cfg.offset), 0.0)
        return torch.where(tok_mask, d, torch.zeros_like(d)).to(torch.int32)
