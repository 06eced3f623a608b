"""The serving kernels as ``torch.library`` custom ops, namespace ``fs2``.

``torch.export`` (``infer/export.py``) cannot trace a ``ctypes`` launch: it
reads raw pointers, which a traced (fake) tensor does not have. Behind these
ops a launch is opaque to the tracer, which records the op and asks its fake
implementation for the outputs' shapes. An exported graph then calls the
same ops, so it launches the same kernels; ``load_exported`` imports this
module before it loads one, so that the ``fs2::`` names resolve.

Every op has three implementations:

- CUDA: the kernel's launch in its wrapper module (``launch*``), which
  increments the wrapper's ``launches`` counter under ``common.count_lock``.
  Each wrapper module registers its launches with the dispatcher directly
  (``register_cuda``), with no Python frame between: not through
  ``register_kernel``, whose wrapper checks the outputs for aliases of the
  inputs on every call. The serving path is host-bound and makes 18-28 op
  calls a mel call;
- CPU: the kernel's plain PyTorch version (``custom_op``'s own kernel);
- fake: empty outputs of the right shapes and dtypes; it launches nothing.

No other device has an implementation, so a tensor elsewhere raises: a CUDA
tensor never takes the plain version. The wrappers (``attention.py``,
``ffn.py``, ``adaptor.py``, ``postnet.py``, ``resstack.py``) check shapes,
dtypes and gradients ahead of the op, and call its overload
(``torch.ops.fs2.<name>.default``) for every device, so eager serving, the
server and an exported graph take the same code.

The ops, by the TPU kernel each replaces (``fastspeech2_tpu/ops/pallas/``):
1 ``attention_block``, 5 ``attention_res_ln``, 6 ``attention_res``, 7
``fused_attention_packed``, 2 ``ffn_block``, 9 ``ffn_block_pre``, 3
``variance_adaptor``, 4 ``postnet``, 13 ``resstack``. Kernels 8 and 10 have
no model route, and 11, 12 and 14 are not on an inference graph: they keep
their direct wrappers.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import Tensor
from torch.library import custom_op


_CUDA_KERNELS = torch.library.Library("fs2", "IMPL")


def register_cuda(name: str, launch) -> None:
    """Register a wrapper module's ``launch`` as the CUDA kernel of
    ``fs2::<name>``; the dispatcher calls it with the op's arguments."""
    _CUDA_KERNELS.impl(name, launch, "CUDA")


# -- 1: post-LN attention half with the q|k|v projection ------------------------

@custom_op("fs2::attention_block", mutates_args=(), device_types="cpu")
def attention_block(x: Tensor, wqkv: Tensor, bqkv: Tensor, wo: Tensor, bo: Tensor,
                    g: Tensor, be: Tensor, lengths: Tensor, n_heads: int,
                    eps: float) -> Tensor:
    return _attention.attention_block_plain(x, wqkv, bqkv, wo, bo, g, be, lengths,
                                            n_heads, eps)


@attention_block.register_fake
def _(x, wqkv, bqkv, wo, bo, g, be, lengths, n_heads, eps):
    return torch.empty_like(x, dtype=torch.float32)


# -- 5: post-LN attention half, q/k/v given ------------------------------------

@custom_op("fs2::attention_res_ln", mutates_args=(), device_types="cpu")
def attention_res_ln(q: Tensor, k: Tensor, v: Tensor, res: Tensor, wo: Tensor,
                     bo: Tensor, g: Tensor, be: Tensor, lengths: Tensor, n_heads: int,
                     eps: float) -> Tensor:
    return _attention.attention_res_ln_plain(q, k, v, res, wo, bo, g, be,
                                             lengths, n_heads, eps)


@attention_res_ln.register_fake
def _(q, k, v, res, wo, bo, g, be, lengths, n_heads, eps):
    return torch.empty_like(res, dtype=torch.float32, memory_format=torch.contiguous_format)


# -- 6: pre-LN attention half, q/k/v given ------------------------------------

@custom_op("fs2::attention_res", mutates_args=(), device_types="cpu")
def attention_res(q: Tensor, k: Tensor, v: Tensor, res: Tensor, wo: Tensor, bo: Tensor,
                  lengths: Tensor, n_heads: int) -> Tensor:
    return _attention.attention_res_plain(q, k, v, res, wo, bo, lengths, n_heads)


@attention_res.register_fake
def _(q, k, v, res, wo, bo, lengths, n_heads):
    return torch.empty_like(res, dtype=torch.float32, memory_format=torch.contiguous_format)


# -- 7: bare masked attention, heads packed along D -----------------------------

@custom_op("fs2::fused_attention_packed", mutates_args=(), device_types="cpu")
def fused_attention_packed(q: Tensor, k: Tensor, v: Tensor, lengths: Tensor,
                           n_heads: int) -> Tensor:
    return _attention.fused_attention_packed_plain(q, k, v, lengths, n_heads)


@fused_attention_packed.register_fake
def _(q, k, v, lengths, n_heads):
    return q.new_empty(q.shape)


# -- 2 and 9: conv-FFN halves --------------------------------------------------

@custom_op("fs2::ffn_block", mutates_args=(), device_types="cpu")
def ffn_block(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, g: Tensor,
              be: Tensor, lengths: Tensor, kernel: int, eps: float) -> Tensor:
    return _ffn.ffn_block_plain(x, w1, b1, w2, b2, g, be, lengths, kernel, eps)


@ffn_block.register_fake
def _(x, w1, b1, w2, b2, g, be, lengths, kernel, eps):
    return torch.empty_like(x, dtype=torch.float32)


@custom_op("fs2::ffn_block_pre", mutates_args=(), device_types="cpu")
def ffn_block_pre(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, g: Tensor,
                  be: Tensor, lengths: Tensor, kernel: int, eps: float) -> Tensor:
    return _ffn.ffn_block_pre_plain(x, w1, b1, w2, b2, g, be, lengths, kernel, eps)


@ffn_block_pre.register_fake
def _(x, w1, b1, w2, b2, g, be, lengths, kernel, eps):
    return torch.empty_like(x, dtype=torch.float32)


# -- 3: variance adaptor ---------------------------------------------------------

@custom_op("fs2::variance_adaptor", mutates_args=(), device_types="cpu")
def variance_adaptor(hs: Tensor, idx: Tensor, out_lens: Tensor, w1: Tensor, b1: Tensor,
                     g1: Tensor, be1: Tensor, w2: Tensor, b2: Tensor, g2: Tensor,
                     be2: Tensor, wo: Tensor, bo: Tensor, bins: Tensor, emb_w: Tensor,
                     emb_b: Tensor) -> Tuple[Tensor, Tensor]:
    return _adaptor.variance_adaptor_plain(
        hs, idx, out_lens, w1, b1, g1, be1, w2, b2, g2, be2, wo, bo, bins, emb_w, emb_b)


@variance_adaptor.register_fake
def _(hs, idx, out_lens, *weights):
    B, L, D = hs.shape[0], idx.shape[1], hs.shape[2]
    return (hs.new_empty((B, L, D), dtype=torch.float32),
            hs.new_empty((B, 2, L), dtype=torch.float32))


# -- 4: postnet -------------------------------------------------------------------

@custom_op("fs2::postnet", mutates_args=(), device_types="cpu")
def postnet(x: Tensor, w_flat: Tensor, bn: Tensor, lengths: Tensor, n_layers: int,
            C: int, k: int) -> Tensor:
    return _postnet.postnet_plain(x, w_flat, bn, lengths, n_layers, C, k)


@postnet.register_fake
def _(x, w_flat, bn, lengths, n_layers, C, k):
    return torch.empty_like(x, dtype=torch.float32)


# -- 13: a MelGAN stage's residual stack -----------------------------------------

@custom_op("fs2::resstack", mutates_args=(), device_types="cpu")
def resstack(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
             dilations: List[int]) -> Tensor:
    return _resstack.resstack_plain(x, w1, b1, w2, b2, dilations)


@resstack.register_fake
def _(x, w1, b1, w2, b2, dilations):
    return torch.empty_like(x)


# the wrapper modules (which import this one: the CPU kernels above reach
# them at call time) register their launches as the CUDA kernels, each at
# its end, so importing this module alone makes every op launchable
from fastspeech2_tpu_torch.ops.kernels import adaptor as _adaptor  # noqa: E402
from fastspeech2_tpu_torch.ops.kernels import attention as _attention  # noqa: E402
from fastspeech2_tpu_torch.ops.kernels import ffn as _ffn  # noqa: E402
from fastspeech2_tpu_torch.ops.kernels import postnet as _postnet  # noqa: E402
from fastspeech2_tpu_torch.ops.kernels import resstack as _resstack  # noqa: E402
