"""FFT-block conv-FFN kernels, ``FFN(z) = Conv_k1(ReLU(Conv_k(z)))``.

- ``ffn_block``: the post-LN block half ``LN(x + FFN(mask(x)))``, the port of
  ``fastspeech2_tpu/ops/pallas/ffn.py:fused_ffn_block_post`` (kernel
  ``_ffn_block_post_kernel``).
- ``ffn_block_pre``: the pre-LN block half ``x + FFN(mask(LN(x)))``, LN eps
  1e-5 on the conv input and no LN after, the port of
  ``ffn.py:fused_ffn_block`` (kernel ``_ffn_block_kernel``);
  ``ffn_block_fused_apply`` calls it with a block's weights.
- ``fused_ffn``: the bare masked conv-FFN of a bf16 input with O output
  channels, in ``out_dtype``, the port of ``ffn.py:fused_ffn`` (kernel
  ``_ffn_kernel``); ``ffn_fused_apply`` calls it with a module's weights.

CUDA source: ``csrc/ffn.cu`` (a k-tap conv launch writing the bf16 hidden,
then a k=1 conv launch with the entry's epilogue, both wgmma kernels fed by
a TMA weight ring). ``plan`` picks their tiling per shape; the C side makes
the same choice (``c_plan`` reads it back on the card).

Rounding points follow the TPU kernels: the masked conv input is rounded to
the compute dtype, each conv's product is rounded and widened for its bias,
the hidden is ``relu(round(...))`` in the compute dtype, and the residual add
and LayerNorm run in f32. A row whose window lies past the length gets the
bias-only row (then +x and LN, +x, or nothing).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from fastspeech2_tpu_torch.ops import nn
from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.ops.precision import current_compute_dtype, round_to

#: launches of the post-LN entry (``ffn_block``)
launches = 0
#: launches of the pre-LN entry (``ffn_block_pre``)
pre_launches = 0
#: launches of the bare entry (``fused_ffn``)
bare_launches = 0
_fn = None
_fn_pre = None
_fn_bare = None
_fn_plan = None

#: shared memory a block may use on the H100, and each of two on one SM
SMEM_MAX, SMEM_PAIR = 232_448, 115_712
#: the ring's 1024-byte alignment and its mbarriers
SLACK = 1024 + 64
#: launch 1's (rows, hidden columns) per block, in the order tried: the
#: second fits every shape the first does not (D up to 1,472 at k = 1)
CONV_TILES = ((128, 256), (64, 128))
#: launch 2's output columns per block, at most
ROW_PASS = 512


class FfnPlan(NamedTuple):
    """Tiling of one FFN shape. Launch 1 (the k-tap conv): ``p`` rows x
    ``nh`` hidden columns a block, ``st1`` ring stages of nh x 64 weights,
    ``smem1`` bytes. Launch 2 (the k=1 conv and epilogue): ``no`` output
    columns per warpgroup (two per block), ``passes`` column passes (blocks)
    over O, ``st2`` stages of a 64 x 64 hidden tile plus 2*no x 64 weights,
    ``minb2`` blocks per SM, ``smem2`` bytes (the drained ring then holds
    the block's round(y), 64 x (2*no + 8) floats)."""
    p: int
    nh: int
    st1: int
    smem1: int
    no: int
    passes: int
    st2: int
    minb2: int
    smem2: int


def plan(D: int, H: int, kernel: int, O: int) -> FfnPlan:
    """The kernels' tiling of (D, H, k, O), as ``csrc/ffn.cu:make_plan``
    picks it: launch 1 takes the first of ``CONV_TILES`` whose x tile
    (p + k - 1 rows, rounded up to odd, D bf16 columns) and at least two
    ring stages fit a block's shared memory, with up to four stages;
    launch 2 splits O into passes of at most 512 columns, rounds each
    warpgroup's half up to 64, and takes two blocks per SM at 128 columns or
    fewer. Raises ValueError where no tiling fits."""
    for p, nh in CONV_TILES:
        xb = D * ((p + kernel - 1) | 1) * 2
        st1 = min(4, (SMEM_MAX - SLACK - xb) // (nh * 128))
        if st1 >= 2:
            break
    else:
        raise ValueError(f"ffn: D={D}, k={kernel} leave no room for the conv "
                         "tile in shared memory")
    passes = -(-O // ROW_PASS)
    per = -(-O // passes)  # columns of a pass
    no = -(-((per + 1) // 2) // 64) * 64  # a warpgroup's half, up to a multiple of 64
    minb2 = 2 if no <= 128 else 1
    stage = 8192 + 2 * no * 128
    st2 = min(4, ((SMEM_PAIR if minb2 == 2 else SMEM_MAX) - SLACK) // stage)
    return FfnPlan(p, nh, st1, xb + st1 * nh * 128 + SLACK, no, passes, st2, minb2,
                   st2 * stage + SLACK)


def scratch_elems(B: int, T: int, H: int, O: int) -> int:
    """bf16 elements of the kernels' scratch: the (B, T, H) hidden, then the
    O-float bias-only row at the next 16-byte boundary."""
    return -(-(B * T * H) // 8) * 8 + 2 * O


def c_plan(D: int, H: int, kernel: int, O: int) -> FfnPlan:
    """The tiling the C side picks for a shape (``fs2_ffn_plan``; needs the
    built library)."""
    global _fn_plan
    if _fn_plan is None:
        _fn_plan = common.bind(common.load("ffn"), "fs2_ffn_plan",
                               [common.I] * 4 + [common.P])
    out = (ctypes.c_int * 9)()
    if _fn_plan(D, H, kernel, O, out) != 0:
        raise ValueError(f"ffn: no tiling fits D={D}, H={H}, k={kernel}, O={O}")
    return FfnPlan(*out)


def _masked(x, lengths):
    valid = torch.arange(x.shape[1], device=x.device)[None, :] < lengths.to(x.device)[:, None]
    return torch.where(valid[..., None], x, torch.zeros_like(x))


def _conv_ffn(xm, w1, b1, w2, b2, kernel: int, cd):
    """``round(relu(round(round(conv_k(xm)) + b1)) W2) + b2`` in f32; xm holds
    values of the compute dtype ``cd``."""
    acc = common.unfold_rows(xm, kernel) @ w1.float().t()
    h = torch.relu(round_to(round_to(acc, cd) + b1, cd))
    return round_to(h @ w2.float().t(), cd) + b2


def ffn_block_plain(x, w1, b1, w2, b2, g, be, lengths, kernel: int,
                    eps: float = 1e-5):
    """The post-LN function in plain PyTorch; w1 is (H, k*D) laid out (out,
    tap, in), w2 (D, H). Compute dtype = w1.dtype."""
    cd = w1.dtype
    x = x.float()
    y = _conv_ffn(round_to(_masked(x, lengths), cd), w1, b1, w2, b2, kernel, cd)
    return nn.layer_norm(x + y, g, be, eps=eps)


def ffn_block_pre_plain(x, w1, b1, w2, b2, g, be, lengths, kernel: int,
                        eps: float = 1e-5):
    """The pre-LN function ``x + FFN(mask(LN(x)))`` in plain PyTorch; the
    weights as in ``ffn_block_plain``, g/be the LayerNorm on the conv
    input."""
    cd = w1.dtype
    x = x.float()
    ym = round_to(_masked(nn.layer_norm(x, g, be, eps=eps), lengths), cd)
    return x + _conv_ffn(ym, w1, b1, w2, b2, kernel, cd)


def fused_ffn_plain(x, w1, b1, w2, b2, lengths, kernel: int, out_dtype=None):
    """The bare function ``FFN(mask(x))`` in plain PyTorch: x (B, T, D) in the
    compute dtype, w1 (H, k*D), w2 (O, H); out in ``out_dtype`` (default x's
    dtype)."""
    cd = x.dtype
    y = _conv_ffn(_masked(x.float(), lengths), w1, b1, w2, b2, kernel, cd)
    return y.to(out_dtype or x.dtype)


def _check(name, x, w1, b1, w2, b2, lengths, kernel, D, O, x_dtype):
    B, T, _ = x.shape
    H = w1.shape[0]
    bf16, f32 = torch.bfloat16, torch.float32
    common.check_cuda(name, x.device, [
        ("x", x, x_dtype, None), ("w1", w1, bf16, (H, kernel * D)),
        ("b1", b1, f32, (H,)), ("w2", w2, bf16, (O, H)), ("b2", b2, f32, (O,)),
        ("lengths", lengths, torch.int32, (B,))])
    if D % 32 or H % 32 or kernel % 2 != 1:
        raise ValueError(f"{name}: D={D}, H={H}, k={kernel} not supported "
                         "by the kernel (multiples of 32, odd k)")
    plan(D, H, kernel, O)
    return B, T, H


def ffn_block(x, w1, b1, w2, b2, g, be, lengths, kernel: int,
              eps: float = 1e-5):
    """Post-LN: x (B, T, D) f32; w1 (H, k*D) and w2 (D, H) in the compute
    dtype; b1 (H,), b2/g/be (D,) f32; lengths (B,) int32. Through the op
    ``fs2::ffn_block`` (``library.py``): CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    common.refuse_grad("ffn_block", x, w1, b1, w2, b2, g, be)
    if x.device.type != "cpu":
        _check_block("ffn_block", x, w1, b1, w2, b2, g, be, lengths, kernel)
    return torch.ops.fs2.ffn_block.default(x, w1, b1, w2, b2, g, be, lengths, kernel,
                                           eps)


def ffn_block_pre(x, w1, b1, w2, b2, g, be, lengths, kernel: int,
                  eps: float = 1e-5):
    """Pre-LN: ``x + FFN(mask(LN(x)))``, arguments as ``ffn_block`` (g/be the
    LayerNorm on the conv input). Through the op ``fs2::ffn_block_pre``
    (``library.py``): CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    common.refuse_grad("ffn_block_pre", x, w1, b1, w2, b2, g, be)
    if x.device.type != "cpu":
        _check_block("ffn_block_pre", x, w1, b1, w2, b2, g, be, lengths, kernel)
    return torch.ops.fs2.ffn_block_pre.default(x, w1, b1, w2, b2, g, be, lengths, kernel,
                                               eps)


def _check_block(name, x, w1, b1, w2, b2, g, be, lengths, kernel):
    D = x.shape[-1]
    _check(name, x, w1, b1, w2, b2, lengths, kernel, D, D, torch.float32)
    common.check_cuda(name, x.device, [("g", g, torch.float32, (D,)),
                                       ("be", be, torch.float32, (D,))])


def launch_block(pre: bool, x, w1, b1, w2, b2, g, be, lengths, kernel: int, eps: float):
    """The CUDA implementation of ``fs2::ffn_block`` (``pre`` False) and
    ``fs2::ffn_block_pre`` (True) on checked inputs."""
    global launches, pre_launches, _fn, _fn_pre
    if pre and _fn_pre is None:
        _fn_pre = _bind_block("fs2_ffn_block_pre")
    if not pre and _fn is None:
        _fn = _bind_block("fs2_ffn_block")
    (B, T, D), H = x.shape, w1.shape[0]
    hid = torch.empty(scratch_elems(B, T, H, D), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    common.launch(_fn_pre if pre else _fn, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                  w2.data_ptr(), b2.data_ptr(), g.data_ptr(), be.data_ptr(),
                  lengths.data_ptr(), hid.data_ptr(), out.data_ptr(), B, T, D, H,
                  kernel, eps, common.stream_of(x))
    with common.count_lock:
        if pre:
            pre_launches += 1
        else:
            launches += 1
    return out


def _bind_block(symbol):
    P, I, F = common.P, common.I, common.F
    return common.bind(common.load("ffn"), symbol, [P] * 10 + [I] * 5 + [F, P])


def fused_ffn(x, w1, b1, w2, b2, lengths, kernel: int, out_dtype=None):
    """Bare conv-FFN: x (B, T, D) in the compute dtype (bf16 on the card),
    w1 (H, k*D) and w2 (O, H) bf16, b1 (H,), b2 (O,) f32, lengths (B,)
    int32 -> (B, T, O) in ``out_dtype`` (bf16 or f32; default x's dtype).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global bare_launches, _fn_bare
    common.refuse_grad("fused_ffn", x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1, b1, w2, b2, lengths, kernel, out_dtype)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_ffn: out_dtype {out_dtype} is not bf16 or f32")
    D, O = x.shape[-1], w2.shape[0]
    B, T, H = _check("fused_ffn", x, w1, b1, w2, b2, lengths, kernel, D, O,
                     torch.bfloat16)
    if _fn_bare is None:
        P, I = common.P, common.I
        _fn_bare = common.bind(common.load("ffn"), "fs2_ffn", [P] * 8 + [I] * 7 + [P])
    hid = torch.empty(scratch_elems(B, T, H, O), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((B, T, O), dtype=out_dtype, device=x.device)
    common.launch(_fn_bare, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                  b2.data_ptr(), lengths.data_ptr(), hid.data_ptr(), out.data_ptr(),
                  int(out_dtype == torch.float32), B, T, D, H, O, kernel,
                  common.stream_of(x))
    with common.count_lock:
        bare_launches += 1
    return out


@torch.no_grad()
def pack_ffn(ffn, cd: torch.dtype):
    """Kernel-layout weights of a conv position-wise FFN: ffn.w1 is a Conv1d
    (H, D, k), ffn.w2 a Conv1d (O, H, 1) -> (w1 (H, k*D), b1, w2 (O, H),
    b2)."""
    w1 = ffn.w1.weight.permute(0, 2, 1).reshape(ffn.w1.weight.shape[0], -1)
    return (w1.to(cd).contiguous(), ffn.w1.bias.float(),
            ffn.w2.weight[:, :, 0].to(cd).contiguous(), ffn.w2.bias.float())


@torch.no_grad()
def pack_weights(ffn, norm, cd: torch.dtype):
    """Kernel-layout weights of one block's FFN half: ``pack_ffn`` plus the
    block's LayerNorm (after the FFN post-LN, before it pre-LN)."""
    return (*pack_ffn(ffn, cd), norm.weight.float(), norm.bias.float())


def block_pack(ffn, norm, cd: torch.dtype):
    """``pack_weights`` cached on the FFN module (``common.cached_pack``)."""
    return common.cached_pack(ffn, [*ffn.parameters(), norm.weight, norm.bias],
                              lambda: pack_weights(ffn, norm, cd))


def ffn_block_fused_apply(norm, ffn, x, lengths):
    """Pre-LN block tail on the serving path, ``x + FFN(mask(LN(x)))`` with
    a block's LayerNorm and conv FFN modules, under the compute dtype."""
    cd = current_compute_dtype() or x.dtype
    return ffn_block_pre(x, *block_pack(ffn, norm, cd), lengths,
                         ffn.w1.weight.shape[2]).to(x.dtype)


def ffn_fused_apply(ffn, x, lengths, out_dtype=None):
    """The bare conv-FFN of a conv position-wise FFN module, operands cast
    to the compute dtype; out in ``out_dtype`` (default: x's dtype after
    the cast)."""
    cd = current_compute_dtype() or x.dtype
    xc = x.to(cd)
    return fused_ffn(xc, *pack_ffn(ffn, cd), lengths, ffn.w1.weight.shape[2],
                     out_dtype or xc.dtype)


# the ops' CUDA kernels (``library.py``, which imports this module)
from fastspeech2_tpu_torch.ops.kernels import library  # noqa: E402
library.register_cuda("ffn_block", functools.partial(launch_block, False))
library.register_cuda("ffn_block_pre", functools.partial(launch_block, True))
