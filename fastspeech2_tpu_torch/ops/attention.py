"""Multi-head self-attention, plain ops (``fastspeech2_tpu/ops/attention.py``).

Scale by 1/sqrt(d_k), fill masked scores with ``finfo.min``, softmax, then
re-zero the masked weights; the denominator is ``max(denom, tiny)``, so a
fully padded query row gives exact zeros.
"""

from typing import Optional

import math

import torch

from fastspeech2_tpu_torch.ops import nn


def masked_softmax(scores: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last axis; mask is True at VALID positions."""
    if mask is None:
        return torch.softmax(scores, dim=-1)
    fi = torch.finfo(scores.dtype)
    s = torch.where(mask, scores, torch.full_like(scores, fi.min))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m) * mask.to(scores.dtype)
    denom = e.sum(dim=-1, keepdim=True)
    return e / torch.clamp_min(denom, fi.tiny)


def mha_apply(attn, query: torch.Tensor, key: torch.Tensor,
              value: torch.Tensor, mask: Optional[torch.Tensor],
              n_heads: int, *, dropout_rate: float = 0.0,
              dropout_seed: Optional[int] = None,
              deterministic: bool = True) -> torch.Tensor:
    """Scaled dot-product multi-head attention.

    attn: a module with ``q``, ``k``, ``v``, ``out`` linears (torch layout).
    query/key/value: (B, T, D); mask: (B, Tq, Tk) bool, True where valid.
    In training mode the attention weights are dropped after the masked
    softmax (``nn.dropout`` over (B, H, Tq, Tk) with the site's seed).
    """
    B, Tq, D = query.shape
    d_k = D // n_heads

    def split(x, lin):
        y = nn.linear(x, lin.weight, lin.bias)
        return y.reshape(B, -1, n_heads, d_k).transpose(1, 2)  # (B,H,T,dk)

    q, k, v = split(query, attn.q), split(key, attn.k), split(value, attn.v)
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d_k)
    w = masked_softmax(scores, None if mask is None else mask[:, None])
    w = nn.dropout(w.to(query.dtype), dropout_rate, dropout_seed,
                   deterministic=deterministic)
    x = (w.float() @ v.float()).to(query.dtype)
    x = x.transpose(1, 2).reshape(B, Tq, D)
    return nn.linear(x, attn.out.weight, attn.out.bias)
