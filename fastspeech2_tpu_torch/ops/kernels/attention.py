"""Post-LN FFT-block attention half: ``LN(x + MHA(x)·Wo + bo)``.

Port of ``fastspeech2_tpu/ops/pallas/attention.py:fused_attention_packed_qkv_res_ln``
(kernel ``_attn_kernel_packed_qkv_res_ln``). CUDA source:
``csrc/attention.cu``: three wgmma launches, the q|k|v projection (launch 1
of ``csrc/ffn_body.cuh`` at k = 1 without the ReLU), the SERVE forward of
``csrc/attention_fwd.cuh`` (kernel 7's) into a bf16 head-output scratch,
and the out projection with the residual and LayerNorm (launch 2 of
``csrc/ffn_body.cuh``). Any d_k that is a multiple of 8 from 8 to 1024
(``attention_train.plan``).

Rounding points follow the TPU kernel: q/k/v are ``round(round(x@W) + b)``
in the compute dtype, the softmax is f32 with ``finfo.min`` fill, re-zeroing
and ``max(denom, tiny)``, the weights are rounded before P·V, the head output
(``o_scr``) is rounded, and the out projection is ``round(o@Wo) + bo``. Rows at
or past the length come out as ``LN(x + bo)``.

``attention_res_ln`` is the same function with q/k/v given: the port of
``attention.py:fused_attention_packed_res_ln`` (kernel
``_attn_kernel_packed_res_ln``), which the JAX package takes with
``FS2_FUSED_ATT_QKV=off``. It is the last two launches of
``csrc/attention.cu`` alone, under their own C entry; q/k/v arrive rounded
to the compute dtype and the residual is a separate f32 input.

``attention_res`` is the pre-LN block's attention half, ``res + MHA(q, k,
v)·Wo + bo`` with no LayerNorm (rows at or past the length: ``res + bo``): the
port of ``attention.py:fused_attention_packed_res`` (kernel
``_attn_kernel_packed_res``), C entry ``fs2_attention_res`` (the same two
launches, the out projection's epilogue without the LayerNorm).
``mha_fused_res_apply`` projects q/k/v and calls it, as the JAX wrapper does.

``fused_attention_packed`` and ``fused_attention`` are the bare masked
attention, heads packed along D (B, T, D) and in the (B, H, T, dk) layout,
out in q's dtype, rows at or past the length zero: the ports of
``attention.py:fused_attention_packed`` (kernel ``_attn_kernel_packed``) and
``attention.py:fused_attention`` (kernel ``_attn_kernel``), both through the
C entry ``fs2_attention``: the SERVE mode of ``csrc/attention_fwd.cuh``, the
wgmma/TMA forward of the training kernels 11 and 12 without their dropout,
O32 and row statistics (any planned d_k). For the same bf16 values the
packed entry gives ``attention_train.fused_attention_train_packed`` at rate
0 bit for bit. f32 operands on the card take the training kernels' f32
forward (plain multiply-adds, no TF32) at rate 0, its row statistics
discarded. ``mha_fused_apply`` wraps the packed one in the q/k/v and out
projections; the model takes it under ``concat_after`` and
``flags.FUSED_ATT_RES`` off.
"""

from __future__ import annotations

import math

import torch

from fastspeech2_tpu_torch.ops import nn
from fastspeech2_tpu_torch.ops.attention import masked_softmax
from fastspeech2_tpu_torch.ops.kernels import attention_train, common, ffn
from fastspeech2_tpu_torch.ops.precision import current_compute_dtype, round_to

#: launches of the CUDA kernel (the plain version does not count)
launches = 0
#: launches of the q/k/v-given entry (``attention_res_ln``)
res_ln_launches = 0
#: launches of the pre-LN entry (``attention_res``)
res_launches = 0
#: launches of the bare attention, head-packed (``fused_attention_packed``)
packed_launches = 0
#: launches of the bare attention, (B, H, T, dk) (``fused_attention``)
bhtd_launches = 0
_fn = None
_fn_res_ln = None
_fn_res = None
_fn_bare = None


def _attend(q, k, v, lengths, cd):
    """Masked attention of (B, H, T, dk) values; f32 result holding values of
    the compute dtype ``cd``: weights rounded before P·V, the product
    rounded. Rows at or past the length come out zero."""
    T, dk = q.shape[2], q.shape[3]
    q, k, v = q.float(), k.float(), v.float()
    scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dk))
    pos = torch.arange(T, device=q.device)
    valid = pos[None, :] < lengths.to(q.device)[:, None]
    w = masked_softmax(scores, valid[:, None, :, None] & valid[:, None, None, :])
    return round_to(round_to(w, cd) @ v, cd)


def _attend_packed(q, k, v, lengths, n_heads: int, cd):
    """``_attend`` with heads packed along D: (B, T, D) in and out."""
    B, T, D = q.shape
    split = [t.reshape(B, T, n_heads, D // n_heads).transpose(1, 2) for t in (q, k, v)]
    return _attend(*split, lengths, cd).transpose(1, 2).reshape(B, T, D)


def attention_res_plain(q, k, v, res, wo, bo, lengths, n_heads: int):
    """``res + MHA(q, k, v)·Wo + bo`` in plain PyTorch (f32 out); q/k/v hold
    values of the compute dtype, which is wo's dtype."""
    cd = wo.dtype
    o = _attend_packed(q, k, v, lengths, n_heads, cd)
    return (round_to(o @ wo.float().t(), cd) + bo) + res.float()


def attention_res_ln_plain(q, k, v, res, wo, bo, g, be, lengths, n_heads: int,
                           eps: float = 1e-5):
    """``LN(res + MHA(q, k, v)·Wo + bo)`` in plain PyTorch; q/k/v hold values
    of the compute dtype, which is wo's dtype."""
    return nn.layer_norm(attention_res_plain(q, k, v, res, wo, bo, lengths, n_heads),
                         g, be, eps=eps)


def fused_attention_packed_plain(q, k, v, lengths, n_heads: int):
    """Bare masked attention, heads packed along D, in plain PyTorch; out in
    q's dtype (bf16 rounds the weights and the result, f32 does not)."""
    return _attend_packed(q, k, v, lengths, n_heads, q.dtype).to(q.dtype)


def fused_attention_plain(q, k, v, lengths):
    """Bare masked attention of (B, H, T, dk) q/k/v in plain PyTorch."""
    return _attend(q, k, v, lengths, q.dtype).to(q.dtype)


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
    Through the op ``fs2::attention_block`` (``library.py``): CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    common.refuse_grad("attention_block", x, wqkv, bqkv, wo, bo, g, be)
    if x.device.type != "cpu":
        B, T, D = x.shape
        bf16, f32 = torch.bfloat16, torch.float32
        common.check_cuda("attention_block", x.device, [
            ("x", x, f32, None), ("wqkv", wqkv, bf16, (3 * D, D)),
            ("bqkv", bqkv, f32, (3 * D,)), ("wo", wo, bf16, (D, D)),
            ("bo", bo, f32, (D,)), ("g", g, f32, (D,)), ("be", be, f32, (D,)),
            ("lengths", lengths, torch.int32, (B,))])
        _check_heads("attention_block", D, n_heads)
    return torch.ops.fs2.attention_block.default(x, wqkv, bqkv, wo, bo, g, be, lengths,
                                                 n_heads, eps)


def launch_block(x, wqkv, bqkv, wo, bo, g, be, lengths, n_heads: int, eps: float):
    """The CUDA implementation of ``fs2::attention_block`` on checked inputs."""
    global launches, _fn
    B, T, D = x.shape
    bf16 = torch.bfloat16
    if _fn is None:
        P, I, F = common.P, common.I, common.F
        _fn = common.bind(common.load("attention"), "fs2_attention_block",
                          [P] * 11 + [I] * 4 + [F, F, P])
    qkv = torch.empty((B, T, 3 * D), dtype=bf16, device=x.device)
    o = torch.empty((B, T, D), dtype=bf16, device=x.device)
    out = torch.empty_like(x)
    common.launch(_fn, x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                  wo.data_ptr(), bo.data_ptr(), g.data_ptr(), be.data_ptr(),
                  lengths.data_ptr(), qkv.data_ptr(), o.data_ptr(), out.data_ptr(),
                  B, T, D, n_heads, 1.0 / math.sqrt(D // n_heads), eps,
                  common.stream_of(x))
    with common.count_lock:
        launches += 1
    return out


def _qkv_stride(name, q, k, v, shape):
    """The common row stride of q, k, v: bf16 tensors of ``shape`` on one
    device, each contiguous or a column block of one wider buffer (unit
    column stride, a row stride that is a multiple of 8; 16-byte aligned
    bases, which the launch checks: a traced tensor has no address): no
    re-packing copy is made."""
    B, T, _ = shape
    ld = q.stride(1)
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be a {shape} bfloat16 tensor on "
                             f"{q.device}")
        if (t.stride(2) != 1 or t.stride(1) != ld or ld % 8
                or (B > 1 and t.stride(0) != T * ld)):
            raise ValueError(f"{name}: {arg} needs unit column stride, the common "
                             "row stride (a multiple of 8) and a 16-byte aligned base")
    return ld


def _check_aligned(name, *tensors):
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: inputs need 16-byte aligned bases")


def _check_heads(name, D, n_heads):
    """The attention halves' shape rule: the bare kernels' head dims
    (``check_head_dim``), and a width D whose q|k|v and out projections
    have a tiling on ``csrc/ffn_body.cuh`` (``ffn.plan`` at k = 1, which
    depends on D alone); raise for others."""
    if n_heads < 1 or D % n_heads:
        raise ValueError(f"{name}: D={D} is not a multiple of heads={n_heads}")
    check_head_dim(name, D // n_heads)
    try:
        ffn.plan(D, D, 1, D)
    except ValueError:
        raise ValueError(f"{name}: D={D} leaves the projections no tiling") from None


def attention_res_ln(q, k, v, res, wo, bo, g, be, lengths, n_heads: int,
                     eps: float = 1e-5):
    """q, k, v (B, T, D) in the compute dtype, each contiguous or a column
    block of one wider buffer (a common row stride, unit column stride: no
    re-packing copy is made); res (B, T, D) f32; wo (D, D) in the compute
    dtype; bo/g/be (D,) f32; lengths (B,) int32. Through the op
    ``fs2::attention_res_ln`` (``library.py``): CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    common.refuse_grad("attention_res_ln", q, k, v, res, wo, bo, g, be)
    if q.device.type != "cpu":
        B, T, D = q.shape
        bf16, f32 = torch.bfloat16, torch.float32
        common.check_cuda("attention_res_ln", q.device, [
            ("res", res, f32, (B, T, D)), ("wo", wo, bf16, (D, D)),
            ("bo", bo, f32, (D,)), ("g", g, f32, (D,)), ("be", be, f32, (D,)),
            ("lengths", lengths, torch.int32, (B,))])
        _check_heads("attention_res_ln", D, n_heads)
        _qkv_stride("attention_res_ln", q, k, v, (B, T, D))
    return torch.ops.fs2.attention_res_ln.default(q, k, v, res, wo, bo, g, be, lengths,
                                                  n_heads, eps)


def launch_res_ln(q, k, v, res, wo, bo, g, be, lengths, n_heads: int, eps: float):
    """The CUDA implementation of ``fs2::attention_res_ln`` on checked inputs."""
    global res_ln_launches, _fn_res_ln
    B, T, D = q.shape
    bf16 = torch.bfloat16
    ld = q.stride(1)
    _check_aligned("attention_res_ln", q, k, v)
    if _fn_res_ln is None:
        P, I, F = common.P, common.I, common.F
        _fn_res_ln = common.bind(common.load("attention"), "fs2_attention_res_ln",
                                 [P] * 4 + [I] + [P] * 7 + [I] * 4 + [F, F, P])
    o = torch.empty((B, T, D), dtype=bf16, device=q.device)
    out = torch.empty_like(res)
    common.launch(_fn_res_ln, res.data_ptr(), q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), ld, wo.data_ptr(), bo.data_ptr(), g.data_ptr(),
                  be.data_ptr(), lengths.data_ptr(), o.data_ptr(), out.data_ptr(),
                  B, T, D, n_heads, 1.0 / math.sqrt(D // n_heads), eps,
                  common.stream_of(q))
    with common.count_lock:
        res_ln_launches += 1
    return out


def attention_res(q, k, v, res, wo, bo, lengths, n_heads: int):
    """Pre-LN attention half ``res + MHA(q, k, v)·Wo + bo``: q, k, v as in
    ``attention_res_ln``; res (B, T, D) f32; wo (D, D) in the compute dtype;
    bo (D,) f32; lengths (B,) int32. Through the op ``fs2::attention_res``
    (``library.py``): CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    common.refuse_grad("attention_res", q, k, v, res, wo, bo)
    if q.device.type != "cpu":
        B, T, D = q.shape
        common.check_cuda("attention_res", q.device, [
            ("res", res, torch.float32, (B, T, D)), ("wo", wo, torch.bfloat16, (D, D)),
            ("bo", bo, torch.float32, (D,)), ("lengths", lengths, torch.int32, (B,))])
        _check_heads("attention_res", D, n_heads)
        _qkv_stride("attention_res", q, k, v, (B, T, D))
    return torch.ops.fs2.attention_res.default(q, k, v, res, wo, bo, lengths, n_heads)


def launch_res(q, k, v, res, wo, bo, lengths, n_heads: int):
    """The CUDA implementation of ``fs2::attention_res`` on checked inputs."""
    global res_launches, _fn_res
    B, T, D = q.shape
    ld = q.stride(1)
    _check_aligned("attention_res", q, k, v)
    if _fn_res is None:
        P, I, F = common.P, common.I, common.F
        _fn_res = common.bind(common.load("attention"), "fs2_attention_res",
                              [P] * 4 + [I] + [P] * 5 + [I] * 4 + [F, P])
    o = torch.empty((B, T, D), dtype=torch.bfloat16, device=q.device)
    out = torch.empty_like(res)
    common.launch(_fn_res, res.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  ld, wo.data_ptr(), bo.data_ptr(), lengths.data_ptr(), o.data_ptr(),
                  out.data_ptr(), B, T, D, n_heads, 1.0 / math.sqrt(D // n_heads),
                  common.stream_of(q))
    with common.count_lock:
        res_launches += 1
    return out


def check_head_dim(name: str, dk: int) -> None:
    """The attention kernels take every head dim ``attention_train.plan``
    plans (a multiple of 8 from 8 to 1024); raise ValueError for others."""
    attention_train.check_head_dim(name, dk)


def _bare_shape(name, q, n_heads=None):
    """(packed, B, H, T, dk) of a bare attention's q, raising for what the
    kernels do not take. ``n_heads`` given: (B, T, D) operands, heads
    packed along D; None: (B, H, T, dk)."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: the kernel takes bfloat16 or float32, got {q.dtype}")
    packed = n_heads is not None
    if packed:
        B, T, D = q.shape
        if D % n_heads:
            raise ValueError(f"{name}: D={D} is not a multiple of heads={n_heads}")
        H, dk = n_heads, D // n_heads
    else:
        B, H, T, dk = q.shape
    check_head_dim(name, dk)
    return packed, B, H, T, dk


def _bare(name, q, k, v, lengths, n_heads=None):
    """Launch the bare attention: bf16 through ``fs2_attention``, f32
    through the training kernels' f32 forward at rate 0 (``_bare_shape``
    gives the layouts). The output is contiguous."""
    global _fn_bare
    packed, B, H, T, dk = _bare_shape(name, q, n_heads)
    if q.dtype == torch.float32:
        q, k, v = (t.contiguous() for t in (q, k, v))
        attention_train._check(name, q, k, v, lengths, B, dk)
        o = torch.empty_like(q)
        stats = torch.empty((2, B, H, T), dtype=torch.float32, device=q.device)
        entry = "fs2_attention_train_fwd" + ("_packed" if packed else "")
        dims = (B, T, H * dk, H) if packed else (B, H, T, dk)
        common.launch(attention_train._entry(entry, 7), q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), lengths.data_ptr(), o.data_ptr(), 0, stats.data_ptr(),
                      *dims, 1.0 / math.sqrt(dk), 0, 0, 1.0, 1, common.stream_of(q))
        return o
    if packed:
        ld = _qkv_stride(name, q, k, v, (B, T, H * dk))
    else:
        common.check_cuda(name, q.device, [
            (n, t, torch.bfloat16, (B, H, T, dk)) for n, t in (("q", q), ("k", k), ("v", v))])
        ld = dk
    _check_aligned(name, q, k, v)
    common.check_cuda(name, q.device, [("lengths", lengths, torch.int32, (B,))])
    if _fn_bare is None:
        P, I, F = common.P, common.I, common.F
        _fn_bare = common.bind(common.load("attention"), "fs2_attention",
                               [P] * 3 + [I] + [P] * 2 + [I] * 5 + [F, P])
    out = torch.empty((B, T, H * dk) if packed else (B, H, T, dk), dtype=torch.bfloat16,
                      device=q.device)
    common.launch(_fn_bare, q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, lengths.data_ptr(),
                  out.data_ptr(), B, T, H, dk, int(packed), 1.0 / math.sqrt(dk),
                  common.stream_of(q))
    return out


def fused_attention_packed(q, k, v, lengths, n_heads: int):
    """Bare masked attention, heads packed along D: q, k, v (B, T, D) (bf16
    on the card: contiguous or column blocks of one buffer, as in
    ``attention_res_ln``; or f32), lengths (B,) int32 -> (B, T, D) in q's
    dtype, rows at or past the length zero. Through the op
    ``fs2::fused_attention_packed`` (``library.py``): CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    common.refuse_grad("fused_attention_packed", q, k, v)
    if q.device.type != "cpu":
        _bare_shape("fused_attention_packed", q, n_heads)
    return torch.ops.fs2.fused_attention_packed.default(q, k, v, lengths, n_heads)


def launch_packed(q, k, v, lengths, n_heads: int):
    """The CUDA implementation of ``fs2::fused_attention_packed``."""
    global packed_launches
    out = _bare("fused_attention_packed", q, k, v, lengths, n_heads)
    with common.count_lock:
        packed_launches += 1
    return out


def fused_attention(q, k, v, lengths):
    """Bare masked attention of (B, H, T, dk) q, k, v (contiguous; bf16 or
    f32 on the card), lengths (B,) int32 -> (B, H, T, dk), rows at or past
    the length zero. CPU tensors take the plain version; CUDA tensors launch
    the kernel (the body of ``fused_attention_packed``, other tensor maps)."""
    global bhtd_launches
    common.refuse_grad("fused_attention", q, k, v)
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, lengths)
    out = _bare("fused_attention", q, k, v, lengths)
    with common.count_lock:
        bhtd_launches += 1
    return out


def _project(attn, x, dt):
    return tuple(nn.linear(x, p.weight, p.bias, out_dtype=dt)
                 for p in (attn.q, attn.k, attn.v))


def mha_fused_res_apply(attn, x, residual, lengths, n_heads: int):
    """Pre-LN attention half on the serving path: q/k/v projected from x
    (the normalised stream) with plain ops in the compute dtype, then
    ``attention_res`` with ``residual`` (the block input). attn has q, k, v,
    out linears (torch layout)."""
    dt = current_compute_dtype() or x.dtype
    o = attn.out
    wo, bo = common.cached_pack(o, [o.weight, o.bias], lambda: (
        o.weight.to(dt).contiguous(), o.bias.float().contiguous()))
    return attention_res(*_project(attn, x, dt), residual, wo, bo, lengths, n_heads)


def mha_fused_apply(attn, x, lengths, n_heads: int):
    """Self-attention through the bare kernel: q/k/v projections in the
    compute dtype, ``fused_attention_packed``, then the out projection back
    to x's dtype (plain ops around the kernel)."""
    dt = current_compute_dtype() or x.dtype
    o = fused_attention_packed(*_project(attn, x, dt), lengths, n_heads)
    return nn.linear(o, attn.out.weight, attn.out.bias, out_dtype=x.dtype)


@torch.no_grad()
def pack_weights(attn, norm, cd: torch.dtype):
    """Kernel-layout weights of one block's attention half: attn has q, k,
    v, out linears (torch layout), norm is the trailing LayerNorm."""
    wqkv = torch.cat([attn.q.weight, attn.k.weight, attn.v.weight]).to(cd)
    bqkv = torch.cat([attn.q.bias, attn.k.bias, attn.v.bias]).float()
    return (wqkv.contiguous(), bqkv.contiguous(),
            attn.out.weight.to(cd).contiguous(), attn.out.bias.float(),
            norm.weight.float(), norm.bias.float())


# the ops' CUDA kernels (``library.py``, which imports this module)
from fastspeech2_tpu_torch.ops.kernels import library  # noqa: E402
library.register_cuda("attention_block", launch_block)
library.register_cuda("attention_res_ln", launch_res_ln)
library.register_cuda("attention_res", launch_res)
library.register_cuda("fused_attention_packed", launch_packed)
