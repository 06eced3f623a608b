"""MelGAN residual stack: the dilated residual blocks of one generator stage,
``cur = cur + conv_k1(lrelu(conv_k3,dil(reflect_pad(lrelu(cur)))))`` per
dilation, on a (B, S, C) activation.

Port of ``fastspeech2_tpu/ops/pallas/resstack.py:resstack_fused`` (kernel
``_resstack_kernel``). CUDA source: ``csrc/resstack.cu``: up to C = 256 one
launch per stage (a bf16 wgmma/TMA kernel and an f32 kernel); above, the
wide path, two launches per dilated block through a (B, S, C) hidden
scratch (the 3-tap product, then the k=1 product with the residual).

Widths: every C from 1 to 1024 in both compute dtypes. The bf16 kernel takes
C a multiple of 16 up to 128, of 32 up to 256 and of 8 up to 1024
(``served_width``), the f32 kernels C a multiple of 8 up to 1024
(``f32_width``); any other C is zero-padded to the next of those
(``pad_channels``), as the JAX kernel pads to 128 lanes: zero weight rows
and columns and zero biases keep the padded channels at exactly 0 through
every block, so the real channels are unchanged. C > 1024 raises, and so
does a dilation above 64 on the wide path (its z tile of 128 + 2d rows).

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
#: the widest stage the kernels take, the narrow kernels' widest, and the
#: wide path's largest dilation
MAX_WIDTH, NARROW_WIDTH, MAX_WIDE_DILATION = 1024, 256, 64


def resstack_tile(S: int) -> int:
    """Largest tile of the JAX package's kernel that divides S (0 if none).
    The CUDA kernel needs no such alignment; the port keeps the JAX
    package's domain so both packages route a stage the same way."""
    for t in _TILES:
        if S % t == 0 and S >= t:
            return t
    return 0


def served_width(C: int) -> int:
    """The bf16 kernels' width for a C-channel stage: C rounded up to a
    multiple of 16 up to 128, of 32 up to 256 and of 8 up to 1024 (the wide
    path); 0 above 1024."""
    if C <= 128:
        return max(16, -(-C // 16) * 16)
    if C <= NARROW_WIDTH:
        return -(-C // 32) * 32
    return -(-C // 8) * 8 if C <= MAX_WIDTH else 0


def f32_width(C: int) -> int:
    """The f32 kernels' width for a C-channel stage: C rounded up to a
    multiple of 8 up to 1024 (the wide path above 256); 0 above 1024."""
    return -(-C // 8) * 8 if C <= MAX_WIDTH else 0


def wide(C: int) -> bool:
    """Whether a stage of C kernel channels takes the wide path (two
    launches per dilated block)."""
    return C > NARROW_WIDTH


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
        Cp = served_width(C) if cd == torch.bfloat16 else f32_width(C)
        if Cp == 0:
            raise ValueError(f"resstack: C={C} not supported by the {cd} kernels (at most "
                             f"{MAX_WIDTH} channels)")
        if wide(Cp) and max(dilations) > MAX_WIDE_DILATION:
            raise ValueError(f"resstack: dilations {tuple(dilations)} not supported at C={C} "
                             f"(the wide path takes dilations up to {MAX_WIDE_DILATION})")
        if Cp != C:
            return resstack(*pad_channels(x, w1, b1, w2, b2, Cp), dilations)[..., :C].contiguous()
    return torch.ops.fs2.resstack.default(x, w1, b1, w2, b2, list(dilations))


def launch(x, w1, b1, w2, b2, dilations: Sequence[int]):
    """The CUDA implementation of ``fs2::resstack`` on checked inputs. The
    count rises by one per kernel launch: one a stage up to C = 256, two per
    dilated block on the wide path."""
    global launches
    B, S, C = x.shape
    n, cd, is_wide = len(dilations), w1.dtype, wide(C)
    fn = _fns.get((cd, is_wide))
    if fn is None:
        P, I = common.P, common.I
        name = "fs2_resstack_" + ("bf16" if cd == torch.bfloat16 else "f32")
        fn = _fns[cd, is_wide] = common.bind(
            common.load("resstack"), name + ("_wide" if is_wide else ""),
            [P] * (7 if is_wide else 6) + [I] * 3 + [ctypes.POINTER(ctypes.c_int), I, P])
    out = torch.empty_like(x)
    dil = (ctypes.c_int * n)(*dilations)
    hidden = [torch.empty_like(x)] if is_wide else []  # the wide path's scratch
    common.launch(fn, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                  b2.data_ptr(), out.data_ptr(), *(h.data_ptr() for h in hidden),
                  B, S, C, dil, n, common.stream_of(x))
    with common.count_lock:
        launches += 2 * n if is_wide else 1
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
