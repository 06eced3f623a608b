"""Tacotron-2 postnet chain: n x [conv k (no bias) -> inference BatchNorm ->
tanh], no tanh on the last stage, each stage's input re-zeroed past the
length. Returns the residual that is added to the mel.

Port of ``fastspeech2_tpu/ops/pallas/postnet.py:fused_postnet`` (kernel
``_postnet_kernel``). CUDA source: ``csrc/postnet.cu``.

Rounding points follow the TPU kernel: conv operands in the compute dtype,
the product rounded and widened, BatchNorm as ((h - mean) * inv) * g + b in
f32, tanh in f32.
"""

from __future__ import annotations

from typing import List

import torch

from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.ops.precision import round_to

launches = 0
_fn = None


def _cin_pad(c: int) -> int:
    return (c + 31) // 32 * 32


def _stages(w_flat: torch.Tensor, n_layers: int, C0: int, C: int, k: int
            ) -> List[torch.Tensor]:
    """Split the packed weights into per-stage (Cout, k, Cin) views."""
    out, off = [], 0
    for i in range(n_layers):
        cin = C0 if i == 0 else C
        cout = C0 if i == n_layers - 1 else C
        n = cout * k * _cin_pad(cin)
        out.append(w_flat[off:off + n].view(cout, k, _cin_pad(cin))[..., :cin])
        off += n
    return out


def postnet_plain(x, w_flat, bn, lengths, n_layers: int, C: int, k: int):
    """The function the kernel computes, in plain PyTorch. Compute dtype =
    w_flat.dtype."""
    cd = w_flat.dtype
    B, L, C0 = x.shape
    valid = torch.arange(L, device=x.device)[None, :, None] < \
        lengths.to(x.device)[:, None, None]
    h = round_to(torch.where(valid, x.float(), torch.zeros_like(x, dtype=torch.float32)), cd)
    for i, w in enumerate(_stages(w_flat, n_layers, C0, C, k)):
        cout = w.shape[0]
        acc = common.unfold_rows(h, k) @ w.reshape(cout, -1).float().t()
        mean, inv, g, b = (bn[i, j, :cout] for j in range(4))
        h = ((round_to(acc, cd) - mean) * inv) * g + b
        if i < n_layers - 1:
            h = round_to(torch.where(valid, torch.tanh(h), torch.zeros_like(h)), cd)
    return h


def postnet(x, w_flat, bn, lengths, n_layers: int, C: int, k: int):
    """x (B, L, C0) f32 mel; w_flat: the stages' (Cout, k, Cin_pad) weights
    in the compute dtype, Cin_pad = Cin rounded up to 32 with zeros,
    flattened and concatenated; bn (n_layers, 4, CB) f32 rows
    [mean, rsqrt(var + eps), gamma, beta], zero-padded to CB = max(C, C0);
    C is the hidden width; lengths (B,) int32."""
    global launches, _fn
    if x.device.type == "cpu":
        return postnet_plain(x, w_flat, bn, lengths, n_layers, C, k)
    B, L, C0 = x.shape
    common.check_cuda("postnet", x.device, [
        ("x", x, torch.float32, None), ("w", w_flat, torch.bfloat16, None),
        ("bn", bn, torch.float32, (n_layers, 4, max(C, C0))),
        ("lengths", lengths, torch.int32, (B,))])
    if (C % 32 or C > 256 or C0 > 128 or k % 2 != 1 or n_layers < 2
            or (n_layers - 1) * ((k - 1) // 2) > 8):
        raise ValueError(f"postnet: C={C}, C0={C0}, k={k}, layers={n_layers} "
                         "not supported by the kernel")
    if _fn is None:
        P, I = common.P, common.I
        _fn = common.bind(common.load("postnet"), "fs2_postnet",
                          [P] * 5 + [I] * 7 + [P])
    out = torch.empty_like(x)
    common.launch(_fn, x.data_ptr(), w_flat.data_ptr(), bn.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), B, L, C0, C, n_layers, k,
                  bn.shape[2], common.stream_of(x))
    with common.count_lock:
        launches += 1
    return out


@torch.no_grad()
def pack_weights(layers, cd: torch.dtype, eps: float = 1e-5):
    """Kernel-layout weights of a postnet: layers[i] has .conv (Conv1d, no
    bias) and .bn (BatchNorm1d with running statistics). Returns
    (w_flat, bn, C) with C the hidden width."""
    C = layers[0].conv.weight.shape[0]
    CB = max(max(l.conv.weight.shape[:2]) for l in layers)
    ws, bn = [], []
    for l in layers:
        w = l.conv.weight.permute(0, 2, 1)  # (Cout, k, Cin)
        w = torch.nn.functional.pad(w, (0, _cin_pad(w.shape[2]) - w.shape[2]))
        ws.append(w.reshape(-1))
        rows = [l.bn.running_mean, torch.rsqrt(l.bn.running_var + eps),
                l.bn.weight, l.bn.bias]
        bn.append(torch.stack([torch.nn.functional.pad(r.float(), (0, CB - r.shape[0]))
                               for r in rows]))
    return torch.cat(ws).to(cd).contiguous(), torch.stack(bn).contiguous(), C
