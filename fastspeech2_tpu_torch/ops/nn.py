"""Functional NN primitives with the JAX package's numerics
(``fastspeech2_tpu/ops/nn.py``).

Weights arrive in PyTorch layouts (``linear``: (out, in); ``conv1d``:
(out, in, k)); activations are NLC, (B, T, C), as in the JAX package, so the
tests compare like with like.

The bf16 contract (``ops/nn.py:75-133`` of the JAX package): under a bf16
compute dtype (``ops/precision.py``) the operands are rounded to bf16, the
product accumulates in f32, the result is rounded to bf16 and widened to f32
for the bias add. On the CPU that is written as an f32 product of bf16-valued
operands, ``round(round(a) @ round(b))``, which relies on no bf16 GEMM
internals; on the card the operands go to cuBLAS/cuDNN as bf16 tensors (f32
accumulation, one rounding of the result): the same rounding points, other
summation order.

Both are differentiable with the JAX package's backward contract: parameters
stay f32 masters and are cast per use (no ``autocast``, whose rounding points
differ). Every ``round_to`` is a cast pair, so autograd rounds the cotangent
to bf16 where the value was rounded: the incoming cotangent, dx and dw each
come out of an f32-accumulated product rounded once to bf16, as the JAX
transposes of a bf16 ``dot`` do.

Dropout in the bf16 tier draws its keep mask from the JAX package's
counter hash (``_hash_keep_mask``), bit for bit, from a ``uint32`` seed drawn
on the host; the f32 tier draws uniform numbers from a generator seeded with
the same site seed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fastspeech2_tpu_torch.ops.precision import current_compute_dtype, round_to


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ w.T + b over the last axis; w is (out, in)."""
    dt = current_compute_dtype()
    if dt is None:
        y = x.float() @ w.float().t()
    elif x.is_cuda:
        # the card's GEMM takes the bf16 operands, accumulates in f32 and
        # rounds once (device.py turns reduced-precision reductions off)
        y = (x.to(dt) @ w.to(dt).t()).float()
    else:
        y = round_to(round_to(x.float(), dt) @ round_to(w.float(), dt).t(), dt)
    if b is not None:
        y = y + b
    return y.to(out_dtype or x.dtype)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """SAME 1-D convolution over NLC activations; w is (out, in, k), k odd."""
    dt = current_compute_dtype()
    pad = (w.shape[2] - 1) // 2
    if dt is not None and x.is_cuda:
        # as in linear: a bf16 convolution with f32 accumulation on the card
        y = F.conv1d(x.to(dt).transpose(1, 2), w.to(dt), padding=pad)
        y = y.transpose(1, 2).float()
    else:
        xc, wc = x.float(), w.float()
        if dt is not None:
            xc, wc = round_to(xc, dt), round_to(wc, dt)
        y = round_to(F.conv1d(xc.transpose(1, 2), wc, padding=pad).transpose(1, 2), dt)
    if b is not None:
        y = y + b
    return y.to(out_dtype or x.dtype)


def embedding(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids.long(), w)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis (biased variance), the JAX formula."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def batch_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               g: torch.Tensor, b: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """Inference-form BatchNorm over the channel (last) axis."""
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def batch_norm_train(x: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, g: torch.Tensor,
                     b: torch.Tensor, *, momentum: float = 0.1,
                     eps: float = 1e-5) -> torch.Tensor:
    """Training-form BatchNorm over (B, T, C): normalises with the batch mean
    and the biased batch variance, and updates the running statistics IN
    PLACE with torch's convention (unbiased variance, momentum 0.1)."""
    n = x.shape[0] * x.shape[1]
    mean = x.mean(dim=(0, 1))
    var = (x - mean).square().mean(dim=(0, 1))
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(momentum * mean)
        running_var.mul_(1 - momentum).add_(momentum * var * (n / max(n - 1, 1)))
    return (x - mean) * torch.rsqrt(var + eps) * g + b


_M32 = 0xFFFFFFFF


def _hash_mix(x):
    """lowbias32 finalizer on uint32 values carried in an int64 tensor (or a
    Python integer). An int64 product may wrap, but its low 32 bits are those
    of the uint32 product, and ``>>`` on a masked (non-negative) value is a
    logical shift."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def dropout_threshold(rate: float) -> int:
    """Keep where the 32 hash bits are >= this: min(int(rate * 2^32), 2^32 - 1)."""
    return min(int(rate * 4294967296.0), 4294967295)


def _hash_keep_mask(seed: int, shape, rate: float, device=None) -> torch.Tensor:
    """Counter-based keep mask of the JAX package, bit for bit: keep where
    ``lowbias32(linear index ^ lowbias32(seed))`` clears the rate threshold.
    The linear index follows ``shape`` as given, pad included."""
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, device=device, dtype=torch.int64).reshape(tuple(shape))
    if n > _M32:  # the uint32 index wraps
        idx = idx & _M32
    # the seed is a host integer: its mix costs no launch and no copy
    bits = _hash_mix(idx ^ _hash_mix(int(seed) & _M32))
    return bits >= dropout_threshold(rate)


def dropout(x: torch.Tensor, rate: float, seed: Optional[int], *,
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout (scale by 1/(1-rate) at train time). ``seed`` is the
    site's uint32 seed (``train.seeds.SeedSchedule``). bf16 tier: the hash
    mask; f32 tier: uniform numbers from a generator on x's device seeded
    with ``seed``. Either way the mask is a pure function of (seed, shape),
    so a checkpointed block replays it."""
    if deterministic or rate == 0.0:
        return x
    if seed is None:
        raise ValueError("dropout in training mode needs the site's seed")
    keep = 1.0 - rate
    if current_compute_dtype() is not None:
        mask = _hash_keep_mask(seed, x.shape, rate, x.device)
    else:
        g = torch.Generator(device=x.device).manual_seed(int(seed))
        mask = torch.rand(x.shape, generator=g, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
