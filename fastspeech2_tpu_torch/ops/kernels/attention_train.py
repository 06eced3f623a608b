"""Training attention with in-kernel hash dropout, forward and backward:
``O = dropout(masked_softmax(Q Kᵀ / sqrt(dk))) V``.

Port of ``fastspeech2_tpu/ops/pallas/attention_train.py``:
``fused_attention_train_packed`` ((B, T, D), heads as column blocks) and
``fused_attention_train`` ((B, H, T, dk)), each a forward and a backward
kernel. CUDA sources: ``csrc/attention_train.cu``, ``csrc/attention_fwd.cuh``
and ``csrc/hopper.cuh`` (one kernel body per direction serves both layouts
through TMA maps; bf16 on wgmma: a forward launch that also saves O's f32
accumulator -- the forward body of the serving kernels 7 and 8 in its TRAIN
mode -- and a backward of three launches: the row sums
``t = rowsum(dO * O32)``, dQ, then dK/dV).

What the function is, to the rounding point (cd = the inputs' dtype):

- ``S = (Q Kᵀ) * scale`` accumulated in f32; valid where ``row < len`` and
  ``col < len``; ``finfo.min`` fill, row max subtracted, ``e = exp(.) * valid``,
  ``A = e / max(sum, tiny)``: a padded query row is exact zeros and takes
  exact-zero gradients, padded keys take zero dK and dV.
- keep mask: ``lowbias32(idx ^ lowbias32(seed ^ 0x9E3779B9 * (b * 1024 + h)))
  >= min(int(rate * 2^32), 2^32 - 1)`` with ``idx = row * T + col``, T the
  padded length, all in uint32; both layouts draw the same mask.
- ``D = keep ? A / (1 - rate) : 0`` in f32, rounded to cd, ``O = D V``
  accumulated in f32 and rounded to cd.
- backward: ``dA = keep ? (dO Vᵀ) / (1 - rate) : 0`` (f32, not rounded),
  ``dV = round(D)ᵀ dO``, ``t = rowsum(dA * A)``, ``dS = A * (dA - t)`` rounded
  to cd, ``dQ = dS K * scale``, ``dK = dSᵀ Q * scale``, each rounded to cd.

``attention_train_plain`` is the same function in plain PyTorch,
differentiable by autograd; two small autograd helpers put the backward's
rounding points where the kernels have them. The CPU takes it; a CUDA tensor
launches the kernels or raises: bf16 on the tensor cores (what the model
sends) or f32 with plain multiply-adds and no TF32 (for callers that hold the
kernels to an f32 reference), at any d_k from 1 to 2048 (``plan``: the
tiling the CUDA sources choose for it). A head dim that is not a multiple of
8 (a TMA stride is a multiple of 16 bytes) runs at ``padded_head_dim(dk)`` on
zero-filled copies of q, k, v and dO with the real d_k's scale: the zero
columns leave every product and gradient exact, the keep mask does not read
d_k, and the outputs are cut back to the caller's layout. The bf16 backward
takes t from O's f32 accumulator before its rounding: equal to
``rowsum(dA * A)`` but for the rounding of D inside it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional

import torch

from fastspeech2_tpu_torch.ops import flags, nn
from fastspeech2_tpu_torch.ops.attention import masked_softmax
from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.ops.nn import _hash_mix, dropout_threshold
from fastspeech2_tpu_torch.ops.precision import current_compute_dtype

#: longest T the model routes to these kernels (the JAX package's whole-T
#: VMEM budget; kept so both packages route a batch the same way)
MAX_T = 1024
#: longest T the model routes to the head-packed entry
PACKED_MAX_T = 896

#: widest head dim the CUDA kernels take (every one from 1 up to it): the
#: widest D the port's other kernels serve (``adaptor.plan``, ``ffn.plan``)
MAX_HEAD_DIM = 2048
#: shared memory a block may opt into on the H100
SMEM_LIMIT = 232_448

#: launches of the CUDA kernels (the plain version does not count): forward
#: and backward of the head-packed entry, then of the (B, H, T, dk) entry
packed_fwd_launches = 0
packed_bwd_launches = 0
fwd_launches = 0
bwd_launches = 0
_fns = {}

_GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF
#: seed offset between mesh shards (``shard_seed``)
SHARD_SEED_STRIDE = 0x9E37


def _keep_mask(seed: int, B: int, H: int, T: int, rate: float,
               device) -> torch.Tensor:
    """(B, H, T, T) bool keep mask of the kernels (see module doc); uint32
    arithmetic carried in int64 and masked to 32 bits."""
    i64 = torch.int64
    t = torch.arange(T, device=device, dtype=i64)
    idx = (t[:, None] * T + t[None, :]) & _M32
    bh = (torch.arange(B, device=device, dtype=i64)[:, None] * 1024
          + torch.arange(H, device=device, dtype=i64)[None, :])
    key = _hash_mix(((bh * _GOLDEN) & _M32) ^ (int(seed) & _M32))
    bits = _hash_mix(idx[None, None] ^ key[:, :, None, None])
    return bits >= dropout_threshold(rate)


class _RoundValue(torch.autograd.Function):
    """Round the value to ``dtype``; the cotangent passes unrounded."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundCotangent(torch.autograd.Function):
    """Identity whose cotangent is rounded to ``dtype``."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def attention_train_plain(q, k, v, lengths, seed: int, rate: float,
                          n_heads: Optional[int] = None):
    """The function the kernels compute, in plain PyTorch. ``n_heads`` given:
    q, k, v are head-packed (B, T, D); None: (B, H, T, dk). The result has
    q's layout and dtype."""
    cd = q.dtype
    packed = n_heads is not None
    if packed:
        B, T, D = q.shape
        H = n_heads
        q, k, v = (t.reshape(B, T, H, D // H).transpose(1, 2) for t in (q, k, v))
    B, H, T, dk = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    s = _RoundCotangent.apply((qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(dk)), cd)
    pos = torch.arange(T, device=q.device)
    valid = pos[None, :] < lengths.to(q.device)[:, None]
    a = masked_softmax(s, valid[:, None, :, None] & valid[:, None, None, :])
    if rate > 0.0:
        keep = _keep_mask(seed, B, H, T, rate, q.device)
        a = torch.where(keep, a / (1.0 - rate), torch.zeros_like(a))
    o = (_RoundValue.apply(a, cd) @ vf).to(cd)
    if packed:
        o = o.transpose(1, 2).reshape(B, T, H * dk)
    return o


class Plan(NamedTuple):
    """The tiling of one head dim (``plan``)."""

    dkp: int         #: d_k padded to a multiple of 64, at least 128 (zero columns)
    wide: bool       #: column parts (the wide bodies) rather than the tile bodies
    part_width: int  #: output columns a block (and a warpgroup) accumulates
    parts: int       #: column parts of each output: a grid dimension
    smem: Dict[str, int]  #: shared-memory bytes of each kernel that serves it


_BOX = 64 * 64 * 2  # a 64 x 64 bf16 box (8 KB)
_BAR = 8            # an mbarrier


def _tile_smem(dkp: int) -> Dict[str, int]:
    """Shared-memory bytes of the tile bodies at DK = dkp
    (``csrc/attention_fwd.cuh:fwd_smem``, ``csrc/attention_train.cu:dq_smem``
    and ``dkv_smem``); dQ's row split does not fit at 256 and is not built."""
    tb = 64 * dkp * 2

    def fwd(qrows, stages):
        return 1024 + qrows * dkp * 2 + stages * 2 * tb + (2 * stages + 1) * _BAR + 2 * 64 * 2 * 4

    serve_stages = 3 if dkp <= 192 else 2
    return {"serve_rows": fwd(128, serve_stages), "serve_keys": fwd(64, serve_stages),
            "train_rows": fwd(128, 2), "train_keys": fwd(64, 2),
            "dq_rows": 0 if dkp == 256 else 1024 + 2 * 128 * dkp * 2 + 2 * 2 * tb + 5 * _BAR,
            "dq_keys": 1024 + 2 * 64 * dkp * 2 + 2 * 2 * tb + 5 * _BAR,
            "dkv": 1024 + 2 * tb + 2 * 2 * tb + 2 * 32 * 128 * 4 + 2 * 3 * 64 * 4 + 5 * _BAR}


def _wide_smem() -> Dict[str, int]:
    """Shared-memory bytes of the wide bodies (rings of 8, 4 and 5 slots of
    3, 6 and 4 boxes: ``WF_STAGES``, ``WQ_STAGES``, ``WKV_STAGES``)."""
    fwd = 1024 + 8 * 3 * _BOX + 2 * 8 * _BAR
    return {"serve_rows": fwd, "serve_keys": fwd, "train_rows": fwd, "train_keys": fwd,
            "dq_rows": 1024 + 4 * 6 * _BOX + 2 * 4 * _BAR,
            "dq_keys": 1024 + 4 * 6 * _BOX + 2 * 4 * _BAR,
            "dkv": 1024 + 5 * 4 * _BOX + 2 * 32 * 128 * 4 + 2 * 5 * _BAR}


def _f32_smem(dkp: int) -> Dict[str, int]:
    """Shared-memory bytes of the f32 kernels (``csrc/attention_train.cu:
    f32_fwd_smem``, ``f32_bwd_smem``): 32-row tiles of dkp + 1 columns up to
    256, 64-column chunks above."""
    ld = dkp + 1 if dkp <= 256 else 65
    n = 3 if dkp <= 256 else 2
    return {"f32_fwd": (n * 32 * ld + 32 * 33 + 2 * 32) * 4,
            "f32_bwd": (4 * 32 * ld + 2 * 32 * 33 + 3 * 32) * 4}


def plan(dk: int, mode: str = "serve") -> Plan:
    """The tiling the CUDA sources choose for head dim ``dk``
    (``csrc/attention_fwd.cuh:attn_plan``; ``fs2_attention_plan`` returns
    the C side's, which the card test holds to this): d_k from 1 to
    ``MAX_HEAD_DIM``, padded to ``dkp``. dkp <= 256: the tile
    bodies at DK = dkp, one part; above: ``parts`` column parts of
    ``part_width`` (192 or 256) columns each, every part recomputing the
    scores over 64-column chunks of d_k. ``mode``: "serve" (kernels 1, 5-8:
    the SERVE forward), "train" (11, 12: the TRAIN forward, dQ, dK/dV) or
    "f32" (their f32 kernels: the tile at dkp, or 64-column parts above
    256); ``smem`` holds the bytes of the mode's kernels. Both layouts,
    (B, T, D) and (B, H, T, dk), have the same plan. Raises ValueError for
    what the kernels refuse."""
    if not isinstance(dk, int) or dk < 1 or dk > MAX_HEAD_DIM:
        raise ValueError(f"head dim d_k={dk} not supported by the kernels (1 to "
                         f"{MAX_HEAD_DIM})")
    if mode not in ("serve", "train", "f32"):
        raise ValueError(f"plan: unknown mode {mode!r}")
    dkp = max(128, -(-dk // 64) * 64)
    wide = dkp > 256
    parts = -(-dkp // 256) if wide else 1
    pw = 64 * -(-(dkp // 64) // parts)
    if mode == "f32":
        if wide:
            pw, parts = 64, -(-dk // 64)
        return Plan(dkp, wide, pw, parts, _f32_smem(dkp))
    every = _wide_smem() if wide else _tile_smem(dkp)
    keys = {"serve": ("serve_rows", "serve_keys"),
            "train": ("train_rows", "train_keys", "dq_rows", "dq_keys", "dkv")}[mode]
    return Plan(dkp, wide, pw, parts, {k: every[k] for k in keys})


def check_head_dim(name: str, dk: int) -> None:
    """Raise ValueError (naming ``name``) for a head dim no kernel takes."""
    try:
        plan(dk)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def c_plan(dk: int):
    """The C side's plan (``fs2_attention_plan``): (dkp, wide, pw, parts,
    smem of serve rows/keys, train rows/keys, dQ rows/keys, dK/dV, f32
    forward, f32 backward). Raises ValueError where the C side refuses.
    Builds the library: card only."""
    fn = _fns.get("plan")
    if fn is None:
        fn = _fns["plan"] = common.bind(common.load("attention_train"), "fs2_attention_plan",
                                        [common.I, ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 13)()
    if fn(dk, out) != 0:
        raise ValueError(f"fs2_attention_plan refuses d_k={dk}")
    return tuple(out)


def padded_head_dim(dk: int) -> int:
    """The head stride the kernels run a head dim at: d_k rounded up to 8."""
    return -(-dk // 8) * 8


def pad_head_dim(tensors, n_heads: int, dkp: int):
    """Each of ``tensors`` with its heads zero-filled to dkp columns:
    (B, T, H * dk) -> (B, T, H * dkp) for ``n_heads`` > 0, (B, H, T, dk) ->
    (B, H, T, dkp) for 0; as they are where dk == dkp."""
    out = []
    for t in tensors:
        if n_heads:
            B, T, D = t.shape
            dk = D // n_heads
            t4 = t.reshape(B, T, n_heads, dk)
        else:
            dk, t4 = t.shape[-1], t
        if dk != dkp:
            t4 = torch.nn.functional.pad(t4, (0, dkp - dk))
            t = t4.reshape(B, T, n_heads * dkp) if n_heads else t4
        out.append(t)
    return tuple(out)


def cut_head_dim(t, n_heads: int, dk: int):
    """The inverse of ``pad_head_dim`` for one tensor: contiguous."""
    if n_heads:
        B, T, Dp = t.shape
        if Dp == n_heads * dk:
            return t
        return t.reshape(B, T, n_heads, Dp // n_heads)[..., :dk].reshape(B, T, n_heads * dk)
    return t if t.shape[-1] == dk else t[..., :dk].contiguous()


def _entry(name: str, n_ptr: int):
    fn = _fns.get(name)
    if fn is None:
        P, I, F, U = common.P, common.I, common.F, ctypes.c_uint32
        fn = _fns[name] = common.bind(common.load("attention_train"), name,
                                      [P] * n_ptr + [I] * 4 + [F, U, U, F, I, P])
    return fn


def _check(name, q, k, v, lengths, B, dk):
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: the CUDA kernels take bfloat16 or float32, "
                         f"got {q.dtype}")
    check_head_dim(name, dk)
    common.check_cuda(name, q.device, [
        ("q", q, q.dtype, None), ("k", k, q.dtype, tuple(q.shape)),
        ("v", v, q.dtype, tuple(q.shape)),
        ("lengths", lengths, torch.int32, (B,))])
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs need 16-byte aligned bases")


class _AttentionTrainFn(torch.autograd.Function):
    """Forward and backward through the CUDA kernels. ``n_heads`` > 0: the
    head-packed (B, T, D) entry; 0: the (B, H, T, dk) entry."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, seed: int, rate: float, n_heads: int):
        global packed_fwd_launches, fwd_launches
        packed = n_heads > 0
        if packed:
            B, T, D = q.shape
            dk, H = D // n_heads, n_heads
            name = "fs2_attention_train_fwd_packed"
        else:
            B, H, T, dk = q.shape
            name = "fs2_attention_train_fwd"
        _check(name, q, k, v, lengths, B, dk)
        dkp = padded_head_dim(dk)
        q, k, v = pad_head_dim((q, k, v), n_heads, dkp)
        dims = (B, T, H * dkp, H) if packed else (B, H, T, dkp)
        f32 = q.dtype == torch.float32
        o = torch.empty_like(q)
        # bf16: O's f32 accumulator for the backward's row sums, and the row
        # statistics padded to whole 64-row tiles (the dK/dV launch copies
        # them a tile at a time); the f32 kernels use neither
        o32 = torch.empty(0 if f32 else q.shape, dtype=torch.float32, device=q.device)
        Tp = T if f32 else -(-T // 64) * 64
        stats = torch.empty((2, B, H, Tp), dtype=torch.float32, device=q.device)
        scale, thresh = 1.0 / math.sqrt(dk), dropout_threshold(rate) if rate > 0.0 else 0
        common.launch(_entry(name, 7), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lengths.data_ptr(), o.data_ptr(), o32.data_ptr(), stats.data_ptr(),
                      *dims, scale, int(seed) & _M32, thresh, 1.0 - rate, int(f32),
                      common.stream_of(q))
        with common.count_lock:
            if packed:
                packed_fwd_launches += 1
            else:
                fwd_launches += 1
        ctx.save_for_backward(q, k, v, lengths, o32, stats)
        ctx.args = (dims, scale, int(seed) & _M32, thresh, rate, n_heads, dk)
        return cut_head_dim(o, n_heads, dk)

    @staticmethod
    def backward(ctx, do):
        global packed_bwd_launches, bwd_launches
        if not all(ctx.needs_input_grad[:3]):
            raise RuntimeError("attention_train: the backward kernels produce dQ, "
                               "dK and dV together; all three inputs must "
                               "require grad")
        q, k, v, lengths, o32, stats = ctx.saved_tensors
        dims, scale, seed, thresh, rate, n_heads, dk_real = ctx.args
        packed = n_heads > 0
        do = do.to(q.dtype).contiguous()
        if do.data_ptr() % 16:  # a view at an odd offset: TMA reads 16-byte aligned bases
            do = do.clone()
        (do,) = pad_head_dim((do,), n_heads, padded_head_dim(dk_real))
        dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
        tbuf = torch.empty(stats.shape[1:], dtype=torch.float32, device=q.device)
        name = "fs2_attention_train_bwd" + ("_packed" if packed else "")
        common.launch(_entry(name, 11), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      do.data_ptr(), o32.data_ptr(), lengths.data_ptr(), stats.data_ptr(),
                      tbuf.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      *dims, scale, seed, thresh, 1.0 / (1.0 - rate),
                      int(q.dtype == torch.float32), common.stream_of(q))
        with common.count_lock:
            if packed:
                packed_bwd_launches += 1
            else:
                bwd_launches += 1
        return (*(cut_head_dim(t, n_heads, dk_real) for t in (dq, dk, dv)), None, None, None,
                None)


def fused_attention_train_packed(q, k, v, lengths, seed: int, n_heads: int,
                                 rate: float = 0.0):
    """q, k, v (B, T, D) head-packed, lengths (B,) int32, seed a host integer
    (uint32) -> (B, T, D), differentiable. CPU tensors take the plain
    version; CUDA tensors launch the kernels."""
    if q.device.type == "cpu":
        return attention_train_plain(q, k, v, lengths, seed, rate, n_heads)
    return _AttentionTrainFn.apply(q, k, v, lengths, seed, rate, n_heads)


def fused_attention_train(q, k, v, lengths, seed: int, rate: float = 0.0):
    """The (B, H, T, dk) twin of :func:`fused_attention_train_packed`; the
    same mask for the same (seed, b, h)."""
    if q.device.type == "cpu":
        return attention_train_plain(q, k, v, lengths, seed, rate)
    return _AttentionTrainFn.apply(q, k, v, lengths, seed, rate, 0)


def shard_seed(seed: int, shard_index: int) -> int:
    """The seed a mesh shard's kernel takes: ``seed + shard_index * 0x9E37``
    in uint32 (the JAX package's ``fused_attention_train_tp``, shard index =
    data index * tp + model index). The kernel's hash runs over the shard's
    local b and h, so the offset keeps two shards' masks apart."""
    return (int(seed) + shard_index * SHARD_SEED_STRIDE) & _M32


def mha_fused_train_apply(attn, x: torch.Tensor, lengths: torch.Tensor,
                          n_heads: int, seed: int, rate: float,
                          shard_index: Optional[int] = None) -> torch.Tensor:
    """Projections + training attention kernel + output projection: the
    training-mode self-attention with a lengths mask
    (``attention_train.py:mha_fused_train_apply`` of the JAX package). attn
    has ``q``, ``k``, ``v``, ``out`` linears; seed feeds the in-kernel dropout.
    ``shard_index``: x is one shard of a multi-device mesh; as in the JAX
    package the (B, H, T, dk) kernel 12 then runs, never the head-packed
    one, with the shard's seed (``shard_seed``)."""
    B, T, D = x.shape
    dk = D // n_heads
    dt = current_compute_dtype() or x.dtype

    def proj(lin):
        return nn.linear(x, lin.weight, lin.bias, out_dtype=dt)

    if shard_index is not None:
        seed = shard_seed(seed, shard_index)
    elif flags.FUSED_ATT_TRAIN_PACKED and T <= PACKED_MAX_T:
        # head-packed: the projection outputs feed the kernel as they are
        o = fused_attention_train_packed(proj(attn.q), proj(attn.k), proj(attn.v),
                                         lengths, seed, n_heads, rate)
        return nn.linear(o, attn.out.weight, attn.out.bias, out_dtype=x.dtype)
    q, k, v = (proj(lin).reshape(B, T, n_heads, dk).transpose(1, 2).contiguous()
               for lin in (attn.q, attn.k, attn.v))
    o = fused_attention_train(q, k, v, lengths, seed, rate)
    o = o.transpose(1, 2).reshape(B, T, D)
    return nn.linear(o, attn.out.weight, attn.out.bias, out_dtype=x.dtype)
