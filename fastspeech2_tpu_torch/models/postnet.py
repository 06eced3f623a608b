"""Tacotron-2 postnet (``fastspeech2_tpu/models/postnet.py``).

(n_layers-1) x [Conv1d(k, no bias) -> BatchNorm1d -> Tanh -> Dropout] then
Conv1d -> BatchNorm1d -> Dropout; applied residually:
``after = before + postnet(before)``. In training mode BatchNorm normalises
with the batch statistics and updates its running statistics in place, and
the teacher-forced forward passes no conv mask (pad rows leak into conv
windows, as in the reference). One dropout site per layer, named by its index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch
from torch import nn as tnn

from fastspeech2_tpu_torch.ops import nn
from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.ops.kernels import postnet as postnet_kernel


@dataclass(frozen=True)
class PostnetConfig:
    odim: int = 80
    n_layers: int = 5
    n_chans: int = 256
    n_filts: int = 5
    dropout_rate: float = 0.5
    use_batch_norm: bool = True


class PostnetLayer(tnn.Module):
    def __init__(self, in_ch: int, out_ch: int, cfg: PostnetConfig, device=None):
        super().__init__()
        k = cfg.n_filts
        self.conv = tnn.Conv1d(in_ch, out_ch, k, padding=(k - 1) // 2,
                               bias=False, device=device)
        if cfg.use_batch_norm:
            self.bn = tnn.BatchNorm1d(out_ch, device=device)


class Postnet(tnn.Module):
    def __init__(self, cfg: PostnetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.layers = tnn.ModuleList(
            PostnetLayer(cfg.odim if i == 0 else cfg.n_chans,
                         cfg.odim if i == cfg.n_layers - 1 else cfg.n_chans,
                         cfg, device=device)
            for i in range(cfg.n_layers))

    def forward(self, xs: torch.Tensor,
                conv_mask: Optional[torch.Tensor] = None, *,
                seeds: Optional[Mapping[str, int]] = None,
                training: bool = False) -> torch.Tensor:
        """xs (B, L, odim) -> residual (B, L, odim), module-by-module ops.
        training: batch statistics (running statistics updated in place) and
        dropout with the per-layer seeds."""
        h = xs
        for i, layer in enumerate(self.layers):
            if conv_mask is not None:
                h = torch.where(conv_mask[..., None], h, torch.zeros_like(h))
            h = nn.conv1d(h, layer.conv.weight)
            if self.cfg.use_batch_norm:
                bn = nn.batch_norm_train if training else nn.batch_norm
                h = bn(h, layer.bn.running_mean, layer.bn.running_var,
                       layer.bn.weight, layer.bn.bias)
            if i < self.cfg.n_layers - 1:
                h = torch.tanh(h)
            h = nn.dropout(h, self.cfg.dropout_rate,
                           seeds[str(i)] if training else None,
                           deterministic=not training)
        return h

    def fused(self, xs: torch.Tensor, lengths: torch.Tensor,
              cd: torch.dtype) -> torch.Tensor:
        """The same chain through the postnet kernel (exact-unpadded
        semantics: each stage's input zeroed past the length)."""
        srcs = [t for layer in self.layers for t in
                (layer.conv.weight, layer.bn.running_mean, layer.bn.running_var,
                 layer.bn.weight, layer.bn.bias)]
        w, bn, C = common.cached_pack(
            self, srcs, lambda: postnet_kernel.pack_weights(self.layers, cd))
        return postnet_kernel.postnet(xs, w, bn, lengths, self.cfg.n_layers, C,
                                      self.cfg.n_filts)
