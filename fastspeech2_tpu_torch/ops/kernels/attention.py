"""Post-LN FFT-block attention half: ``LN(x + MHA(x)·Wo + bo)``.

Port of ``fastspeech2_tpu/ops/pallas/attention.py:fused_attention_packed_qkv_res_ln``
(kernel ``_attn_kernel_packed_qkv_res_ln``). CUDA source:
``csrc/attention.cu`` (a QKV projection launch, then one attention + out
projection + residual + LayerNorm launch).

Rounding points follow the TPU kernel: q/k/v are ``round(round(x@W) + b)``
in the compute dtype, the softmax is f32 with ``finfo.min`` fill, re-zeroing
and ``max(denom, tiny)``, the weights are rounded before P·V, the head output
(``o_scr``) is rounded, and the out projection is ``round(o@Wo) + bo``. Rows at
or past the length come out as ``LN(x + bo)``.

``attention_res_ln`` is the same function with q/k/v given: the port of
``attention.py:fused_attention_packed_res_ln`` (kernel
``_attn_kernel_packed_res_ln``), which the JAX package takes with
``FS2_FUSED_ATT_QKV=off``. It is the second launch of ``csrc/attention.cu``
alone, under its own C entry; q/k/v arrive rounded to the compute dtype and
the residual is a separate f32 input.
"""

from __future__ import annotations

import math

import torch

from fastspeech2_tpu_torch.ops import nn
from fastspeech2_tpu_torch.ops.attention import masked_softmax
from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.ops.precision import round_to

#: launches of the CUDA kernel (the plain version does not count)
launches = 0
#: launches of the q/k/v-given entry (``attention_res_ln``)
res_ln_launches = 0
_fn = None
_fn_res_ln = None


def attention_res_ln_plain(q, k, v, res, wo, bo, g, be, lengths, n_heads: int,
                           eps: float = 1e-5):
    """``LN(res + MHA(q, k, v)·Wo + bo)`` in plain PyTorch; q/k/v hold values
    of the compute dtype, which is wo's dtype."""
    cd = wo.dtype
    B, T, D = q.shape
    dk = D // n_heads
    q, k, v = (t.float().reshape(B, T, n_heads, dk).transpose(1, 2)
               for t in (q, k, v))
    scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dk))
    pos = torch.arange(T, device=q.device)
    valid = pos[None, :] < lengths.to(q.device)[:, None]
    w = masked_softmax(scores, valid[:, None, :, None] & valid[:, None, None, :])
    o = round_to(round_to(w, cd) @ v, cd).transpose(1, 2).reshape(B, T, D)
    out = round_to(o @ wo.float().t(), cd) + bo
    return nn.layer_norm(out + res.float(), g, be, eps=eps)


def attention_block_plain(x, wqkv, bqkv, wo, bo, g, be, lengths, n_heads: int,
                          eps: float = 1e-5):
    """The function the kernel computes, in plain PyTorch. The compute dtype
    is the weights' dtype (bf16 rounds, f32 does not)."""
    cd = wqkv.dtype
    D = x.shape[-1]
    x = x.float()
    xc = round_to(x, cd)

    def proj(i):
        y = round_to(xc @ wqkv[i * D:(i + 1) * D].float().t(), cd)
        return round_to(y + bqkv[i * D:(i + 1) * D], cd)

    return attention_res_ln_plain(proj(0), proj(1), proj(2), x, wo, bo, g, be,
                                  lengths, n_heads, eps)


def attention_block(x, wqkv, bqkv, wo, bo, g, be, lengths, n_heads: int,
                    eps: float = 1e-5):
    """x (B, T, D) f32; wqkv (3D, D) [q|k|v rows, (out, in)] and wo (D, D) in
    the compute dtype; bqkv (3D,), bo/g/be (D,) f32; lengths (B,) int32.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global launches, _fn
    if x.device.type == "cpu":
        return attention_block_plain(x, wqkv, bqkv, wo, bo, g, be, lengths,
                                     n_heads, eps)
    B, T, D = x.shape
    bf16, f32 = torch.bfloat16, torch.float32
    common.check_cuda("attention_block", x.device, [
        ("x", x, f32, None), ("wqkv", wqkv, bf16, (3 * D, D)),
        ("bqkv", bqkv, f32, (3 * D,)), ("wo", wo, bf16, (D, D)),
        ("bo", bo, f32, (D,)), ("g", g, f32, (D,)), ("be", be, f32, (D,)),
        ("lengths", lengths, torch.int32, (B,))])
    if D % 64 or D % n_heads or D // n_heads not in (128, 192):
        raise ValueError(f"attention_block: D={D}, heads={n_heads} not "
                         "supported by the kernel (d_k 128 or 192)")
    if _fn is None:
        P, I, F = common.P, common.I, common.F
        _fn = common.bind(common.load("attention"), "fs2_attention_block",
                          [P] * 10 + [I] * 4 + [F, F, P])
    qkv = torch.empty((B, T, 3 * D), dtype=bf16, device=x.device)
    out = torch.empty_like(x)
    common.launch(_fn, x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                  wo.data_ptr(), bo.data_ptr(), g.data_ptr(), be.data_ptr(),
                  lengths.data_ptr(), qkv.data_ptr(), out.data_ptr(),
                  B, T, D, n_heads, 1.0 / math.sqrt(D // n_heads), eps,
                  common.stream_of(x))
    with common.count_lock:
        launches += 1
    return out


def attention_res_ln(q, k, v, res, wo, bo, g, be, lengths, n_heads: int,
                     eps: float = 1e-5):
    """q, k, v (B, T, D) in the compute dtype, each contiguous or a column
    block of one wider buffer (a common row stride, unit column stride: no
    re-packing copy is made); res (B, T, D) f32; wo (D, D) in the compute
    dtype; bo/g/be (D,) f32; lengths (B,) int32. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global res_ln_launches, _fn_res_ln
    if q.device.type == "cpu":
        return attention_res_ln_plain(q, k, v, res, wo, bo, g, be, lengths,
                                      n_heads, eps)
    B, T, D = q.shape
    bf16, f32 = torch.bfloat16, torch.float32
    common.check_cuda("attention_res_ln", q.device, [
        ("res", res, f32, (B, T, D)), ("wo", wo, bf16, (D, D)),
        ("bo", bo, f32, (D,)), ("g", g, f32, (D,)), ("be", be, f32, (D,)),
        ("lengths", lengths, torch.int32, (B,))])
    ld = q.stride(1)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != bf16 or tuple(t.shape) != (B, T, D):
            raise ValueError(f"attention_res_ln: {name} must be a {(B, T, D)} "
                             f"bfloat16 tensor on {q.device}")
        if (t.stride(2) != 1 or t.stride(1) != ld or ld % 8 or t.data_ptr() % 16
                or (B > 1 and t.stride(0) != T * ld)):
            raise ValueError(f"attention_res_ln: {name} needs unit column "
                             "stride, the common row stride (a multiple of 8) "
                             "and a 16-byte aligned base")
    if D % 64 or D % n_heads or D // n_heads not in (128, 192):
        raise ValueError(f"attention_res_ln: D={D}, heads={n_heads} not "
                         "supported by the kernel (d_k 128 or 192)")
    if _fn_res_ln is None:
        P, I, F = common.P, common.I, common.F
        _fn_res_ln = common.bind(common.load("attention"), "fs2_attention_res_ln",
                                 [P] * 4 + [I] + [P] * 6 + [I] * 4 + [F, F, P])
    out = torch.empty_like(res)
    common.launch(_fn_res_ln, res.data_ptr(), q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), ld, wo.data_ptr(), bo.data_ptr(), g.data_ptr(),
                  be.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, T, D,
                  n_heads, 1.0 / math.sqrt(D // n_heads), eps,
                  common.stream_of(q))
    with common.count_lock:
        res_ln_launches += 1
    return out


@torch.no_grad()
def pack_weights(attn, norm, cd: torch.dtype):
    """Kernel-layout weights of one block's attention half: attn has q, k,
    v, out linears (torch layout), norm is the trailing LayerNorm."""
    wqkv = torch.cat([attn.q.weight, attn.k.weight, attn.v.weight]).to(cd)
    bqkv = torch.cat([attn.q.bias, attn.k.bias, attn.v.bias]).float()
    return (wqkv.contiguous(), bqkv.contiguous(),
            attn.out.weight.to(cd).contiguous(), attn.out.bias.float(),
            norm.weight.float(), norm.bias.float())
