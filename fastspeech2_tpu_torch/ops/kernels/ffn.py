"""Post-LN FFT-block conv-FFN half: ``LN(x + Conv_k1(ReLU(Conv_k(mask(x)))))``.

Port of ``fastspeech2_tpu/ops/pallas/ffn.py:fused_ffn_block_post`` (kernel
``_ffn_block_post_kernel``). CUDA source: ``csrc/ffn.cu`` (a k-tap conv
launch writing the bf16 hidden, then a k=1 conv + residual + LayerNorm
launch).

Rounding points follow the TPU kernel: the masked input is rounded to the
compute dtype, each conv's product is rounded and widened for its bias, the
hidden is ``relu(round(...))`` in the compute dtype, and the residual add and
LayerNorm run in f32. A row whose window lies past the length gets the
bias-only row.
"""

from __future__ import annotations

import torch

from fastspeech2_tpu_torch.ops import nn
from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.ops.precision import round_to

launches = 0
_fn = None


def ffn_block_plain(x, w1, b1, w2, b2, g, be, lengths, kernel: int,
                    eps: float = 1e-5):
    """The function the kernel computes, in plain PyTorch; w1 is
    (H, k*D) laid out (out, tap, in), w2 (D, H). Compute dtype = w1.dtype."""
    cd = w1.dtype
    B, T, D = x.shape
    x = x.float()
    valid = torch.arange(T, device=x.device)[None, :] < lengths.to(x.device)[:, None]
    xm = round_to(torch.where(valid[..., None], x, torch.zeros_like(x)), cd)
    acc = common.unfold_rows(xm, kernel) @ w1.float().t()
    h = torch.relu(round_to(round_to(acc, cd) + b1, cd))
    y = round_to(h @ w2.float().t(), cd) + b2
    return nn.layer_norm(x + y, g, be, eps=eps)


def ffn_block(x, w1, b1, w2, b2, g, be, lengths, kernel: int,
              eps: float = 1e-5):
    """x (B, T, D) f32; w1 (H, k*D) and w2 (D, H) in the compute dtype;
    b1 (H,), b2/g/be (D,) f32; lengths (B,) int32."""
    global launches, _fn
    if x.device.type == "cpu":
        return ffn_block_plain(x, w1, b1, w2, b2, g, be, lengths, kernel, eps)
    B, T, D = x.shape
    H = w1.shape[0]
    bf16, f32 = torch.bfloat16, torch.float32
    common.check_cuda("ffn_block", x.device, [
        ("x", x, f32, None), ("w1", w1, bf16, (H, kernel * D)),
        ("b1", b1, f32, (H,)), ("w2", w2, bf16, (D, H)), ("b2", b2, f32, (D,)),
        ("g", g, f32, (D,)), ("be", be, f32, (D,)),
        ("lengths", lengths, torch.int32, (B,))])
    if D % 32 or H % 32 or kernel % 2 != 1:
        raise ValueError(f"ffn_block: D={D}, H={H}, k={kernel} not supported "
                         "by the kernel (multiples of 32, odd k)")
    if _fn is None:
        P, I, F = common.P, common.I, common.F
        _fn = common.bind(common.load("ffn"), "fs2_ffn_block",
                          [P] * 10 + [I] * 5 + [F, P])
    hid = torch.empty((B, T, H), dtype=bf16, device=x.device)
    out = torch.empty_like(x)
    common.launch(_fn, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                  w2.data_ptr(), b2.data_ptr(), g.data_ptr(), be.data_ptr(),
                  lengths.data_ptr(), hid.data_ptr(), out.data_ptr(), B, T, D, H,
                  kernel, eps, common.stream_of(x))
    with common.count_lock:
        launches += 1
    return out


@torch.no_grad()
def pack_weights(ffn, norm, cd: torch.dtype):
    """Kernel-layout weights of one block's FFN half: ffn.w1 is a Conv1d
    (H, D, k), ffn.w2 a Conv1d (D, H, 1); norm the trailing LayerNorm."""
    w1 = ffn.w1.weight.permute(0, 2, 1).reshape(ffn.w1.weight.shape[0], -1)
    return (w1.to(cd).contiguous(), ffn.w1.bias.float(),
            ffn.w2.weight[:, :, 0].to(cd).contiguous(), ffn.w2.bias.float(),
            norm.weight.float(), norm.bias.float())
