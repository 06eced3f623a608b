"""MelGAN residual stack: the dilated residual blocks of one generator stage,
``cur = cur + conv_k1(lrelu(conv_k3,dil(reflect_pad(lrelu(cur)))))`` per
dilation, on a (B, S, C) activation.

Port of ``fastspeech2_tpu/ops/pallas/resstack.py:resstack_fused`` (kernel
``_resstack_kernel``). CUDA source: ``csrc/resstack.cu`` (one launch per
stage; a bf16 wgmma/TMA kernel and an f32 kernel).

Widths: the bf16 kernel takes C a multiple of 16 up to 128 and of 32 up to
256 (``served_width``); any other C up to 256 is zero-padded to the next of
those (``pad_channels``), as the JAX kernel pads to 128 lanes: zero weight
rows and columns and zero biases keep the padded channels at exactly 0
through every block, so the real channels are unchanged. C > 256 raises (the
64 x C f32 output of a warpgroup would need C / 2 registers a thread). The
f32 kernel takes C a multiple of 8 up to 256.

Rounding points follow the TPU kernel (cd = the compute dtype, the weights'
dtype): ``lrelu`` of the cd activation is rounded to cd; the three taps'
products accumulate in f32 and take ``b1`` in f32; ``lrelu`` of that is
rounded to cd; the k=1 product plus ``b2`` is f32 and rounded to cd; the
residual add is a cd add. Reflection padding is per block at the true
sequence ends, as the per-layer ``ReflectionPad1d`` of the unfused loop.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.ops.precision import round_to

#: launches of the CUDA kernel (the plain version does not count)
launches = 0
_fns = {}

LRELU_SLOPE = 0.2
_TILES = (2048, 1024, 512, 256, 128)


def resstack_tile(S: int) -> int:
    """Largest tile of the JAX package's kernel that divides S (0 if none).
    The CUDA kernel needs no such alignment; the port keeps the JAX
    package's domain so both packages route a stage the same way."""
    for t in _TILES:
        if S % t == 0 and S >= t:
            return t
    return 0


def served_width(C: int) -> int:
    """The bf16 kernel's width for a C-channel stage: C rounded up to a
    multiple of 16 up to 128, of 32 up to 256; 0 above 256."""
    if C <= 128:
        return max(16, -(-C // 16) * 16)
    return -(-C // 32) * 32 if C <= 256 else 0


def pad_channels(x, w1, b1, w2, b2, Cp: int):
    """The stage's input and weights zero-padded from C to Cp channels
    (w1 laid out (out, tap, in), w2 (out, in)); the padded channels of the
    output are exact zeros and its first C are the unpadded stage's (the
    padding adds zero terms only)."""
    n, C = w2.shape[0], x.shape[-1]
    p = Cp - C
    x = F.pad(x, (0, p))
    w1 = F.pad(w1.reshape(n, C, 3, C), (0, p, 0, 0, 0, p)).reshape(n, Cp, 3 * Cp)
    w2 = F.pad(w2, (0, p, 0, p))
    b1, b2 = F.pad(b1, (0, p)), F.pad(b2, (0, p))
    return x, w1.contiguous(), b1.contiguous(), w2.contiguous(), b2.contiguous()


def resstack_plain(x, w1, b1, w2, b2, dilations: Sequence[int] = (1, 3, 9)):
    """The function the kernel computes, in plain PyTorch. The compute dtype
    is the weights' dtype; the result has x's dtype."""
    cd = w1.dtype
    cur = round_to(x.float(), cd)
    for i, d in enumerate(dilations):
        z = round_to(F.leaky_relu(cur, LRELU_SLOPE), cd)
        zp = F.pad(z.transpose(1, 2), (d, d), mode="reflect").transpose(1, 2)
        S = cur.shape[1]
        taps = torch.cat([zp[:, j * d:j * d + S] for j in range(3)], dim=-1)
        h = taps @ w1[i].float().t() + b1[i]
        h = round_to(F.leaky_relu(h, LRELU_SLOPE), cd)
        y = round_to(h @ w2[i].float().t() + b2[i], cd)
        cur = round_to(cur + y, cd)
    return cur.to(x.dtype)


def resstack(x, w1, b1, w2, b2, dilations: Sequence[int] = (1, 3, 9)):
    """x (B, S, C); w1 (n, C, 3*C) laid out (out, tap, in) and w2 (n, C, C)
    (out, in) in the compute dtype; b1, b2 (n, C) f32 holding values of the
    compute dtype. Through the op ``fs2::resstack`` (``library.py``): CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    needs x in the compute dtype (bf16 or f32)."""
    if x.device.type != "cpu":
        B, S, C = x.shape
        n, cd = len(dilations), w1.dtype
        if cd not in (torch.bfloat16, torch.float32):
            raise ValueError(f"resstack: compute dtype {cd} not supported")
        common.check_cuda("resstack", x.device, [
            ("x", x, cd, None), ("w1", w1, cd, (n, C, 3 * C)),
            ("b1", b1, torch.float32, (n, C)), ("w2", w2, cd, (n, C, C)),
            ("b2", b2, torch.float32, (n, C))])
        if S <= sum(dilations):
            raise ValueError(f"resstack: S={S} must exceed the halo "
                             f"{sum(dilations)} (reflection needs it)")
        if resstack_tile(S) == 0:
            raise ValueError(f"resstack: S={S} is not a multiple of {_TILES[-1]}")
        if not 1 <= n <= 8 or min(dilations) < 1:
            raise ValueError(f"resstack: dilations {tuple(dilations)} not supported")
        bf16 = cd == torch.bfloat16
        Cp = served_width(C) if bf16 else C
        if Cp == 0:
            raise ValueError(f"resstack: C={C} not supported by the {cd} kernel (at most "
                             "256: a warpgroup's 64 x C f32 output takes C / 2 registers "
                             "a thread)")
        if not bf16 and (C % 8 or C > 256):
            raise ValueError(f"resstack: C={C} not supported by the {cd} kernel")
        if Cp != C:
            return resstack(*pad_channels(x, w1, b1, w2, b2, Cp), dilations)[..., :C].contiguous()
    return torch.ops.fs2.resstack.default(x, w1, b1, w2, b2, list(dilations))


def launch(x, w1, b1, w2, b2, dilations: Sequence[int]):
    """The CUDA implementation of ``fs2::resstack`` on checked inputs."""
    global launches
    B, S, C = x.shape
    n, cd = len(dilations), w1.dtype
    bf16 = cd == torch.bfloat16
    fn = _fns.get(cd)
    if fn is None:
        P, I = common.P, common.I
        fn = _fns[cd] = common.bind(
            common.load("resstack"),
            "fs2_resstack_bf16" if bf16 else "fs2_resstack_f32",
            [P] * 6 + [I] * 3 + [ctypes.POINTER(ctypes.c_int), I, P])
    out = torch.empty_like(x)
    dil = (ctypes.c_int * n)(*dilations)
    common.launch(fn, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                  b2.data_ptr(), out.data_ptr(), B, S, C, dil, n,
                  common.stream_of(x))
    with common.count_lock:
        launches += 1
    return out


@torch.no_grad()
def pack_weights(stacks, cd: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel-layout weights of one stage: stacks[i] has .c1 (Conv1d C->C,
    k=3) and .c2 (Conv1d C->C, k=1) in torch layout (out, in, k). The biases
    are rounded to the compute dtype and widened (the bf16 generator holds
    them in bf16)."""
    w1 = torch.stack([s.c1.weight.permute(0, 2, 1).reshape(s.c1.weight.shape[0], -1)
                      for s in stacks])
    w2 = torch.stack([s.c2.weight[:, :, 0] for s in stacks])
    b1 = torch.stack([s.c1.bias for s in stacks])
    b2 = torch.stack([s.c2.bias for s in stacks])
    return (w1.to(cd).contiguous(), round_to(b1.float(), cd).contiguous(),
            w2.to(cd).contiguous(), round_to(b2.float(), cd).contiguous())


# the ops' CUDA kernels (``library.py``, which imports this module)
from fastspeech2_tpu_torch.ops.kernels import library  # noqa: E402
library.register_cuda("resstack", launch)
