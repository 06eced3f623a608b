"""FFT-block (feed-forward Transformer) encoder/decoder stack, inference path
(``fastspeech2_tpu/models/encoder.py``).

Input layer: token embedding ("embed", the text encoder) or
Linear -> LayerNorm -> ReLU ("linear", the decoder), then (scaled) sinusoidal
positional encoding; N blocks of [self-attention + position-wise FFN], post-LN
by default; a final LayerNorm only when ``normalize_before``.

Branches follow the JAX engagement rules (``encoder.py:191-219``), so both
packages take the same path: the attention-half kernel runs only under bf16,
at d_k >= 128, post-LN, with lengths given; the FFN-half kernel only with a
conv mask. On the f32 tier the JAX package uses XLA ops and the port uses
plain PyTorch ops. With ``flags.FUSED_ATT_QKV`` off the post-LN blocks
project q/k/v with plain ops and take the q/k/v-given attention kernel, as the
JAX package does. Branches whose JAX counterpart is a kernel this port does
not have yet (pre-LN, ``concat_after``, ``FUSED_ATT_RES`` off) raise
NotImplementedError rather than run something else.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn as tnn

from fastspeech2_tpu_torch.ops import flags, nn
from fastspeech2_tpu_torch.ops.attention import mha_apply
from fastspeech2_tpu_torch.ops.kernels import attention as attn_kernel
from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.ops.kernels import ffn as ffn_kernel
from fastspeech2_tpu_torch.ops.precision import current_compute_dtype


@dataclass(frozen=True)
class EncoderConfig:
    idim: int                      # vocab size (embed) or input feature dim (linear)
    attention_dim: int = 256
    attention_heads: int = 2
    linear_units: int = 1024
    num_blocks: int = 4
    input_layer: str = "embed"     # "embed" | "linear"
    use_scaled_pos_enc: bool = True
    normalize_before: bool = False
    concat_after: bool = False
    positionwise_layer_type: str = "conv1d"  # "conv1d" | "linear"
    positionwise_conv_kernel_size: int = 9
    padding_idx: int = 0
    max_pos_len: int = 5000


@functools.lru_cache(maxsize=8)
def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """Absolute sinusoidal PE table, computed as the JAX package does."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class MultiHeadAttention(tnn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.q = tnn.Linear(d, d, device=device)
        self.k = tnn.Linear(d, d, device=device)
        self.v = tnn.Linear(d, d, device=device)
        self.out = tnn.Linear(d, d, device=device)


class PositionwiseFFN(tnn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        d, h, k = cfg.attention_dim, cfg.linear_units, cfg.positionwise_conv_kernel_size
        self.kind = cfg.positionwise_layer_type
        if self.kind == "conv1d":
            self.w1 = tnn.Conv1d(d, h, k, padding=(k - 1) // 2, device=device)
            self.w2 = tnn.Conv1d(h, d, 1, device=device)
        elif self.kind == "linear":
            self.w1 = tnn.Linear(d, h, device=device)
            self.w2 = tnn.Linear(h, d, device=device)
        else:
            raise ValueError(f"unknown positionwise_layer_type {self.kind}")

    def forward(self, x: torch.Tensor,
                conv_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """conv_mask (B, T): zero conv inputs at invalid rows. Under bf16 the
        wide hidden stays in bf16, as in the JAX package."""
        mid = current_compute_dtype() or x.dtype
        op = nn.conv1d if self.kind == "conv1d" else nn.linear
        if self.kind == "conv1d" and conv_mask is not None:
            x = torch.where(conv_mask[..., None], x, torch.zeros_like(x))
        h = torch.relu(op(x, self.w1.weight, self.w1.bias, out_dtype=mid))
        return op(h, self.w2.weight, self.w2.bias, out_dtype=x.dtype)


class FFTBlock(tnn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        d = cfg.attention_dim
        self.attn = MultiHeadAttention(d, device=device)
        self.ffn = PositionwiseFFN(cfg, device=device)
        self.norm1 = tnn.LayerNorm(d, device=device)
        self.norm2 = tnn.LayerNorm(d, device=device)
        if cfg.concat_after:
            self.concat = tnn.Linear(2 * d, d, device=device)

    def attn_pack(self, cd):
        return common.cached_pack(
            self.attn, [p for p in self.attn.parameters()] + [self.norm1.weight, self.norm1.bias],
            lambda: attn_kernel.pack_weights(self.attn, self.norm1, cd))

    def ffn_pack(self, cd):
        return common.cached_pack(
            self.ffn, [p for p in self.ffn.parameters()] + [self.norm2.weight, self.norm2.bias],
            lambda: ffn_kernel.pack_weights(self.ffn, self.norm2, cd))


class Encoder(tnn.Module):
    def __init__(self, cfg: EncoderConfig, init_alpha: float = 1.0, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.attention_dim
        if cfg.input_layer == "embed":
            self.embed = tnn.Embedding(cfg.idim, d, padding_idx=cfg.padding_idx,
                                       device=device)
        elif cfg.input_layer == "linear":
            self.input_linear = tnn.Linear(cfg.idim, d, device=device)
            self.input_ln = tnn.LayerNorm(d, device=device)
        else:
            raise ValueError(f"unknown input_layer {cfg.input_layer}")
        if cfg.use_scaled_pos_enc:
            self.alpha = tnn.Parameter(torch.tensor(float(init_alpha), device=device))
        self.layers = tnn.ModuleList(FFTBlock(cfg, device=device)
                                     for _ in range(cfg.num_blocks))
        if cfg.normalize_before:
            self.after_norm = tnn.LayerNorm(d, device=device)

    def _positional_encode(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        pe = torch.from_numpy(
            sinusoid_table(cfg.max_pos_len, cfg.attention_dim)[: x.shape[1]]
        ).to(device=x.device, dtype=x.dtype)
        if cfg.use_scaled_pos_enc:
            return x + self.alpha * pe
        return x * math.sqrt(cfg.attention_dim) + pe

    def forward(self, xs: torch.Tensor, mask: Optional[torch.Tensor], *,
                conv_mask: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                fused_attention: bool = False) -> torch.Tensor:
        """xs: (B, T) token ids ("embed") or (B, T, idim) features ("linear");
        mask: (B, T, T) bool, True where valid; conv_mask: (B, T) row validity;
        lengths: (B,) int32, required by the kernels."""
        cfg = self.cfg
        d_k = cfg.attention_dim // cfg.attention_heads
        speed_path = (fused_attention and lengths is not None
                      and current_compute_dtype() == torch.bfloat16)
        use_fused = speed_path and d_k >= 128
        use_fused_res = use_fused and not cfg.concat_after and flags.FUSED_ATT_RES
        use_fused_ffn = (speed_path and conv_mask is not None
                         and cfg.positionwise_layer_type == "conv1d"
                         and cfg.positionwise_conv_kernel_size % 2 == 1)
        if use_fused and not use_fused_res:
            raise NotImplementedError(
                "bare fused attention (fastspeech2_tpu/ops/pallas/attention.py:"
                "fused_attention_packed) is not ported yet")
        if use_fused_res and cfg.normalize_before:
            raise NotImplementedError(
                "pre-LN fused attention (attention.py:"
                "fused_attention_packed_res) is not ported yet")
        if use_fused_ffn and cfg.normalize_before:
            raise NotImplementedError(
                "pre-LN fused FFN (ffn.py:fused_ffn_block) is not ported yet")

        if cfg.input_layer == "embed":
            x = nn.embedding(self.embed.weight, xs)
        else:
            x = nn.linear(xs, self.input_linear.weight, self.input_linear.bias)
            x = nn.layer_norm(x, self.input_ln.weight, self.input_ln.bias)
            x = torch.relu(x)
        x = self._positional_encode(x)

        cd = current_compute_dtype()
        for layer in self.layers:
            if use_fused_res and flags.FUSED_ATT_QKV:
                x = attn_kernel.attention_block(x, *layer.attn_pack(cd), lengths,
                                                cfg.attention_heads)
            elif use_fused_res:
                # split route: projections as plain ops (the JAX package
                # leaves them to XLA), then the q/k/v-given kernel
                a = layer.attn
                q, k, v = (nn.linear(x, p.weight, p.bias, out_dtype=cd)
                           for p in (a.q, a.k, a.v))
                x = attn_kernel.attention_res_ln(
                    q, k, v, x, *layer.attn_pack(cd)[2:], lengths,
                    cfg.attention_heads)
            else:
                residual = x
                y = (nn.layer_norm(x, layer.norm1.weight, layer.norm1.bias)
                     if cfg.normalize_before else x)
                att = mha_apply(layer.attn, y, y, y, mask, cfg.attention_heads)
                if cfg.concat_after:
                    x = residual + nn.linear(torch.cat([y, att], dim=-1),
                                             layer.concat.weight, layer.concat.bias)
                else:
                    x = residual + att
                if not cfg.normalize_before:
                    x = nn.layer_norm(x, layer.norm1.weight, layer.norm1.bias)
            if use_fused_ffn:
                x = ffn_kernel.ffn_block(x, *layer.ffn_pack(cd), lengths,
                                         cfg.positionwise_conv_kernel_size)
            else:
                residual = x
                y = (nn.layer_norm(x, layer.norm2.weight, layer.norm2.bias)
                     if cfg.normalize_before else x)
                x = residual + layer.ffn(y, conv_mask)
                if not cfg.normalize_before:
                    x = nn.layer_norm(x, layer.norm2.weight, layer.norm2.bias)
        if cfg.normalize_before:
            x = nn.layer_norm(x, self.after_norm.weight, self.after_norm.bias)
        return x
