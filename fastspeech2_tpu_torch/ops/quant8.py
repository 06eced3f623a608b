"""int8 (W8A8) serving tier (``fastspeech2_tpu/ops/quant8.py``).

Scheme (dynamic W8A8, as in the JAX package):

- weights: symmetric per-output-channel int8, ``s = max(amax, tiny) / 127``
  per output channel, quantized once by :func:`quantize_model`;
- activations: one symmetric per-tensor scale, computed in f32 on every call
  (:func:`dynamic_quantize`);
- the product accumulates in int32 and is dequantized in f32 by
  ``sx * s`` (formed first), then the f32 bias is added.

The arithmetic keeps the JAX order (``torch.round`` rounds half to even as
``jnp.round``; the scale divides, it is not a reciprocal multiply), so the
quantized weights and activations equal the JAX package's bit for bit, and
so do ``int8_linear`` and ``int8_conv1d`` for the same quantized inputs: an
integer product is exact in any summation order.

The int8 product is ``torch._int_mm`` for CUDA tensors (a library GEMM: the
JAX package computes it in XLA, outside any Pallas kernel) and the same
product in float64 on the CPU (exact: every partial sum is an integer below
2^53). ``_int_mm`` wants more than 16 rows and K, N multiples of 8: rows,
K and N are padded with zeros, which is exact (``pad_operands``).

Quantization is a property of the module tree: :func:`quantize_model`
returns a copy of a ``FastSpeech2`` whose encoder and decoder attention
q/k/v/out linears and FFN w1/w2 are :class:`Int8Layer` modules (an int8 ``q``
and an f32 ``s`` buffer in torch layout, plus the f32 bias).
Their ``weight`` is an :class:`Int8Weight`, on which ``ops/nn.py``'s
``linear`` and ``conv1d`` dispatch here. Everything else keeps its weights.
The serving attention kernels take the attention weights dequantized for
the call (:func:`dequantize_attention`, ``w = q * s`` in f32), as the JAX
package's do (``models/encoder.py:260-276``); the FFN never takes the
FFN kernels under int8 and runs these W8A8 convs.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn as tnn

_QMAX = 127.0
_TINY = torch.finfo(torch.float32).tiny


class Int8Weight(NamedTuple):
    """A quantized weight: ``q`` int8 in torch layout ((out, in) or (out,
    in, k)), ``s`` (out,) f32 per-output-channel scale."""

    q: torch.Tensor
    s: torch.Tensor


def _scale(amax: torch.Tensor) -> torch.Tensor:
    # 127 as a tensor on amax's device: CUDA divides by a host scalar as a
    # multiply by its reciprocal, which is not the JAX package's rounding
    return torch.clamp_min(amax, _TINY) / amax.new_tensor(_QMAX)


def quantize_weight(w: torch.Tensor, reduce_dims) -> Int8Weight:
    """Symmetric per-output-channel int8 of ``w`` (out channels on dim 0;
    ``reduce_dims`` are folded into each channel's scale)."""
    w = w.detach().float()
    s = _scale(w.abs().amax(dim=reduce_dims, keepdim=True))
    q = torch.clamp(torch.round(w / s), -_QMAX, _QMAX).to(torch.int8)
    return Int8Weight(q, s.reshape(-1))


def dynamic_quantize(x: torch.Tensor):
    """(q int8, s f32 scalar tensor): symmetric per-tensor int8 of an
    activation, computed in f32; zero inputs quantize to exact zero."""
    xf = x.float()
    s = _scale(xf.abs().amax())
    q = torch.clamp(torch.round(xf / s), -_QMAX, _QMAX).to(torch.int8)
    return q, s


def _pad_to(t: torch.Tensor, dim: int, m: int) -> torch.Tensor:
    n = t.shape[dim]
    if n >= m:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, m - n]
    return F.pad(t, pad)


def pad_operands(a: torch.Tensor, bt: torch.Tensor):
    """int8 a (M, K) and bt (N, K) zero-padded to ``torch._int_mm``'s
    shapes: more than 16 rows of a, K and N multiples of 8 (exact: the
    padded rows and columns add zeros)."""
    M, K = a.shape
    Kp = -(-K // 8) * 8
    a = _pad_to(_pad_to(a, 1, Kp), 0, max(M, 17))
    bt = _pad_to(_pad_to(bt, 1, Kp), 0, -(-bt.shape[0] // 8) * 8)
    return a.contiguous(), bt.contiguous()


def int_mm(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Exact int32 product ``a @ bt.T`` of int8 a (M, K) and bt (N, K).
    CUDA: ``torch._int_mm`` on ``pad_operands``; CPU: a float64 product,
    exact for int8 operands."""
    if not a.is_cuda:
        return (a.double() @ bt.double().t()).to(torch.int32)
    M, N = a.shape[0], bt.shape[0]
    ap, btp = pad_operands(a, bt)
    y = torch._int_mm(ap, btp.t())
    return y if y.shape == (M, N) else y[:M, :N]


def _epilogue(acc: torch.Tensor, sx, w: Int8Weight, b, out_dtype) -> torch.Tensor:
    y = acc.float() * (sx * w.s)
    if b is not None:
        y = y + b
    return y.to(out_dtype)


def int8_linear(x: torch.Tensor, w: Int8Weight, b: Optional[torch.Tensor] = None,
                *, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """W8A8 ``x @ W.T + b`` over the last axis; w.q is (out, in)."""
    xq, sx = dynamic_quantize(x)
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), w.q)
    y = _epilogue(acc, sx, w, b, out_dtype or x.dtype)
    return y.reshape(*x.shape[:-1], w.q.shape[0])


def int8_conv1d(x: torch.Tensor, w: Int8Weight, b: Optional[torch.Tensor] = None,
                *, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """SAME stride-1 W8A8 conv over NLC activations; w.q is (out, in, k),
    k odd. k > 1 is an im2col product: the int8 rows of the zero-padded
    input (exact: zero quantizes to zero) gathered channel-major, so that
    ``w.q`` viewed as (out, in*k) is the matrix, with no weight copy."""
    cout, cin, k = w.q.shape
    if k % 2 == 0:
        raise NotImplementedError(f"int8 conv1d supports odd kernels only, got k={k}")
    xq, sx = dynamic_quantize(x)
    B, L, _ = xq.shape
    if k == 1:
        cols = xq.reshape(B * L, cin)
    else:
        pad = (k - 1) // 2
        xp = F.pad(xq, (0, 0, pad, pad))
        cols = torch.stack([xp[:, j:j + L] for j in range(k)], dim=-1)
        cols = cols.reshape(B * L, cin * k)
    acc = int_mm(cols, w.q.reshape(cout, cin * k))
    return _epilogue(acc, sx, w, b, out_dtype or x.dtype).reshape(B, L, cout)


class Int8Layer(tnn.Module):
    """A ``torch.nn.Linear`` or SAME ``torch.nn.Conv1d`` quantized per output
    channel: int8 ``q`` and f32 ``s`` buffers in the layer's torch layout,
    and its f32 bias."""

    def __init__(self, layer: tnn.Module):
        super().__init__()
        if not isinstance(layer, (tnn.Linear, tnn.Conv1d)):
            raise TypeError(f"cannot quantize {type(layer).__name__}")
        w = quantize_weight(layer.weight, tuple(range(1, layer.weight.dim())))
        self.register_buffer("q", w.q)
        self.register_buffer("s", w.s)
        bias = layer.bias
        self.register_buffer("bias", None if bias is None else bias.detach().float().clone())

    @property
    def weight(self) -> Int8Weight:
        return Int8Weight(self.q, self.s)


def is_quantized(module) -> bool:
    return isinstance(module, Int8Layer)


def attention_is_quantized(attn) -> bool:
    """All four projections int8: the case the serving attention kernels
    take dequantized (a partly quantized layer keeps the other routes)."""
    return all(is_quantized(getattr(attn, n)) for n in ("q", "k", "v", "out"))


def dequantize_attention(attn) -> SimpleNamespace:
    """The four projections of an int8 attention dequantized, ``weight = q *
    s`` in f32 (W8: the activations keep their precision), with their
    biases, in the layout of the module; for this call only: nothing holds
    them after the caller drops them."""
    def dequantized(lin: Int8Layer) -> SimpleNamespace:
        return SimpleNamespace(weight=lin.q * lin.s[:, None], bias=lin.bias)

    return SimpleNamespace(**{n: dequantized(getattr(attn, n)) for n in ("q", "k", "v", "out")})


@torch.no_grad()
def quantize_model(model: tnn.Module) -> tnn.Module:
    """A copy of a FastSpeech2 for the int8 tier: in the encoder and the
    decoder, every block's attention q/k/v/out and FFN w1/w2 quantized;
    embeddings, norms, predictors, postnet and feat_out as they are. The
    caller's module is left unchanged. Kernel-layout packs cached on the
    caller's modules are not carried over."""
    out = copy.deepcopy(model)
    for m in out.modules():
        m.__dict__.pop("_kernel_pack", None)
    for stack in (out.encoder, out.decoder):
        for layer in stack.layers:
            for part, names in ((layer.attn, ("q", "k", "v", "out")),
                                (layer.ffn, ("w1", "w2"))):
                for name in names:
                    setattr(part, name, Int8Layer(getattr(part, name)))
    return out.eval()
