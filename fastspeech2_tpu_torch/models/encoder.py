"""FFT-block (feed-forward Transformer) encoder/decoder stack
(``fastspeech2_tpu/models/encoder.py``).

Input layer: token embedding ("embed", the text encoder) or
Linear -> LayerNorm -> Dropout -> ReLU ("linear", the decoder), then (scaled)
sinusoidal positional encoding and positional dropout; N blocks of
[self-attention + position-wise FFN], post-LN by default; a final LayerNorm
only when ``normalize_before``.

Branches follow the JAX engagement rules (``encoder.py:191-229, 248-368``),
so both packages take the same path. Routes served:

- serving (deterministic, bf16, d_k >= 128, lengths given), attention half:
  post-LN blocks take the attention-half kernel (with ``flags.FUSED_ATT_QKV``
  off the q/k/v-given kernel after plain projections); pre-LN blocks project
  q/k/v from LN(x) and take ``attention_res`` with x as the residual; under
  ``concat_after`` or with ``flags.FUSED_ATT_RES`` off, the bare attention
  kernel inside plain q/k/v and out projections (``mha_fused_apply``), then
  the ``concat`` linear or the residual, and the post-LN LayerNorm where the
  block is post-LN.
- serving, FFN half (conv FFN with odd k, a conv mask given): the post-LN
  kernel or the pre-LN kernel ``ffn_block_pre``. These kernels take no
  gradient.
- the int8 tier (``ops/quant8.py:quantize_model``): the three attention-half
  routes above take the int8 attention weights dequantized for the call;
  the bare-kernel route gets them still quantized, so its projections are
  W8A8; int8 FFNs never take the FFN kernels and run W8A8 convs; in the f32
  tier every projection and conv is W8A8 (``encoder.py:260-350`` of the JAX
  package).
- training (not deterministic, seeds given, bf16, d_k >= 128, T <= 1024):
  q/k/v projections, the training attention kernels with in-kernel hash
  dropout (``ops/kernels/attention_train.py``; head-packed up to T = 896
  unless ``flags.FUSED_ATT_TRAIN_PACKED`` is off), out projection, then the
  dropout sites and the FFN as plain ops. ``remat`` checkpoints each block.
- everything else (the f32 tier, small heads, the CPU tests): plain ops,
  ``ops.attention.mha_apply`` with its dropout branch.
- a data shard of a multi-device mesh (``parallel/mesh.py:data_shard``)
  trains through kernel 12, never the head-packed kernel 11, with the
  shard's seed (``attention_train.shard_seed``), as the JAX package does.
- tensor parallelism (``parallel/sharding.py:shard_model`` binds a mesh of
  tp > 1 to the stack; ``_tp_block``, JAX ``encoder.py:193-225``): q/k/v and
  w1 column-parallel, out and w2 row-parallel with their all-reduce before
  the bias and the residual; when tp divides the heads, kernel 7 in serving
  and kernel 12 in training per head shard, else plain attention over the
  gathered heads; kernels 1, 5, 6 and the FFN kernels stay off. Sequence
  parallelism (the training shard's ``sequence_parallel``, when tp divides
  T) splits the residual stream on time between blocks.

Dropout sites, in the JAX package's fixed order: ``input`` (linear input
layer only), ``pos``, then per block i ``{i}/attn``, ``{i}/res``, ``{i}/ffn``,
``{i}/ffn_res``; ``Encoder.dropout_sites()`` lists them and ``forward`` takes
their uint32 seeds as a mapping.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Mapping, Optional

import numpy as np
import torch
from torch import nn as tnn
from torch.utils.checkpoint import checkpoint

from fastspeech2_tpu_torch.ops import flags, nn, quant8
from fastspeech2_tpu_torch.ops.attention import masked_softmax, mha_apply
from fastspeech2_tpu_torch.ops.kernels import attention as attn_kernel
from fastspeech2_tpu_torch.ops.kernels import attention_train
from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.ops.kernels import ffn as ffn_kernel
from fastspeech2_tpu_torch.ops.precision import compute_dtype, current_compute_dtype
from fastspeech2_tpu_torch.parallel import sharding
from fastspeech2_tpu_torch.parallel.mesh import chunk, current_shard, data_shard


@dataclass(frozen=True)
class EncoderConfig:
    idim: int                      # vocab size (embed) or input feature dim (linear)
    attention_dim: int = 256
    attention_heads: int = 2
    linear_units: int = 1024
    num_blocks: int = 4
    dropout_rate: float = 0.2
    positional_dropout_rate: float = 0.2
    attention_dropout_rate: float = 0.2
    input_layer: str = "embed"     # "embed" | "linear"
    use_scaled_pos_enc: bool = True
    normalize_before: bool = False
    concat_after: bool = False
    positionwise_layer_type: str = "conv1d"  # "conv1d" | "linear"
    positionwise_conv_kernel_size: int = 9
    padding_idx: int = 0
    max_pos_len: int = 5000


@functools.lru_cache(maxsize=8)
def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """Absolute sinusoidal PE table, computed as the JAX package does."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class MultiHeadAttention(tnn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.q = tnn.Linear(d, d, device=device)
        self.k = tnn.Linear(d, d, device=device)
        self.v = tnn.Linear(d, d, device=device)
        self.out = tnn.Linear(d, d, device=device)


class PositionwiseFFN(tnn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        d, h, k = cfg.attention_dim, cfg.linear_units, cfg.positionwise_conv_kernel_size
        self.kind = cfg.positionwise_layer_type
        if self.kind == "conv1d":
            self.w1 = tnn.Conv1d(d, h, k, padding=(k - 1) // 2, device=device)
            self.w2 = tnn.Conv1d(h, d, 1, device=device)
        elif self.kind == "linear":
            self.w1 = tnn.Linear(d, h, device=device)
            self.w2 = tnn.Linear(h, d, device=device)
        else:
            raise ValueError(f"unknown positionwise_layer_type {self.kind}")

    def forward(self, x: torch.Tensor, conv_mask: Optional[torch.Tensor], *,
                dropout_rate: float = 0.0, seed: Optional[int] = None,
                deterministic: bool = True) -> torch.Tensor:
        """conv_mask (B, T): zero conv inputs at invalid rows. Under bf16 the
        wide hidden stays in bf16, as in the JAX package; in training mode
        it is dropped after the ReLU."""
        mid = current_compute_dtype() or x.dtype
        op = nn.conv1d if self.kind == "conv1d" else nn.linear
        if self.kind == "conv1d" and conv_mask is not None:
            x = torch.where(conv_mask[..., None], x, torch.zeros_like(x))
        h = torch.relu(op(x, self.w1.weight, self.w1.bias, out_dtype=mid))
        h = nn.dropout(h, dropout_rate, seed, deterministic=deterministic)
        return op(h, self.w2.weight, self.w2.bias, out_dtype=x.dtype)


class FFTBlock(tnn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        d = cfg.attention_dim
        self.attn = MultiHeadAttention(d, device=device)
        self.ffn = PositionwiseFFN(cfg, device=device)
        self.norm1 = tnn.LayerNorm(d, device=device)
        self.norm2 = tnn.LayerNorm(d, device=device)
        if cfg.concat_after:
            self.concat = tnn.Linear(2 * d, d, device=device)

    def attn_pack(self, cd, attn=None):
        """The attention half's kernel-layout weights. ``attn``: the
        projections to pack, default this block's; the int8 tier passes
        them dequantized for the call (``quant8.dequantize_attention``), and
        the pack is cached on that object, so it goes with it."""
        attn = self.attn if attn is None else attn
        lins = [getattr(attn, n) for n in ("q", "k", "v", "out")]
        return common.cached_pack(
            attn, [t for lin in lins for t in (lin.weight, lin.bias)]
            + [self.norm1.weight, self.norm1.bias],
            lambda: attn_kernel.pack_weights(attn, self.norm1, cd))

    def ffn_pack(self, cd):
        return ffn_kernel.block_pack(self.ffn, self.norm2, cd)


class Encoder(tnn.Module):
    def __init__(self, cfg: EncoderConfig, init_alpha: float = 1.0, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.attention_dim
        if cfg.input_layer == "embed":
            self.embed = tnn.Embedding(cfg.idim, d, padding_idx=cfg.padding_idx,
                                       device=device)
        elif cfg.input_layer == "linear":
            self.input_linear = tnn.Linear(cfg.idim, d, device=device)
            self.input_ln = tnn.LayerNorm(d, device=device)
        else:
            raise ValueError(f"unknown input_layer {cfg.input_layer}")
        if cfg.use_scaled_pos_enc:
            self.alpha = tnn.Parameter(torch.tensor(float(init_alpha), device=device))
        self.layers = tnn.ModuleList(FFTBlock(cfg, device=device)
                                     for _ in range(cfg.num_blocks))
        if cfg.normalize_before:
            self.after_norm = tnn.LayerNorm(d, device=device)
        #: the tensor-parallel mesh (``parallel/sharding.py:shard_model``)
        self.mesh = None

    def _positional_encode(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        rows = sinusoid_table(cfg.max_pos_len, cfg.attention_dim)[: x.shape[1]]
        if x.device.type == "cpu" or torch.compiler.is_compiling():
            # rows of their own: the cached table is shared by every stack
            # of one width, and ``torch.export`` lifts the array a tensor is
            # made from as a constant, saving one storage for constants
            # that alias (a CUDA tensor copies them anyway)
            rows = rows.copy()
        pe = torch.from_numpy(rows).to(device=x.device, dtype=x.dtype)
        if cfg.use_scaled_pos_enc:
            return x + self.alpha * pe
        return x * math.sqrt(cfg.attention_dim) + pe

    def dropout_sites(self) -> List[str]:
        """Names of this stack's dropout sites in the JAX package's key order
        (``encoder.py:226-253``): 2 + 4 per block. The embed input layer has
        no ``input`` dropout; the JAX package skips that key too."""
        sites = ["input", "pos"]
        for i in range(self.cfg.num_blocks):
            sites += [f"{i}/attn", f"{i}/res", f"{i}/ffn", f"{i}/ffn_res"]
        return sites

    def forward(self, xs: torch.Tensor, mask: Optional[torch.Tensor], *,
                conv_mask: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                fused_attention: bool = False,
                seeds: Optional[Mapping[str, int]] = None,
                deterministic: bool = True,
                remat: bool = False) -> torch.Tensor:
        """xs: (B, T) token ids ("embed") or (B, T, idim) features ("linear");
        mask: (B, T, T) bool, True where valid; conv_mask: (B, T) row validity;
        lengths: (B,) int32, required by the kernels; seeds: uint32 per
        dropout site (``dropout_sites``), required when not deterministic;
        remat: recompute each block in the backward pass
        (``torch.utils.checkpoint``; the seeds make the replay identical)."""
        cfg = self.cfg
        if not deterministic and seeds is None:
            raise ValueError("training mode needs the dropout seeds")
        seed = (lambda name: None) if deterministic else seeds.__getitem__
        d_k = cfg.attention_dim // cfg.attention_heads
        mesh = self.mesh
        tp = 1 if mesh is None else mesh.tp
        shard = current_shard()
        speed_path = (fused_attention and lengths is not None
                      and current_compute_dtype() == torch.bfloat16)
        fusable = (speed_path and d_k >= 128
                   and (tp == 1 or cfg.attention_heads % tp == 0))
        use_fused = fusable and deterministic
        use_fused_res = (use_fused and not cfg.concat_after and flags.FUSED_ATT_RES
                         and tp == 1)
        use_fused_ffn = (speed_path and deterministic and conv_mask is not None
                         and cfg.positionwise_layer_type == "conv1d"
                         and cfg.positionwise_conv_kernel_size % 2 == 1 and tp == 1)
        use_fused_train = (fusable and not deterministic
                           and xs.shape[1] <= attention_train.MAX_T)
        # a shard of a multi-device mesh: kernel 12 with the shard's seed
        shard_index = (shard.shard_index if shard is not None and shard.mesh.size > 1
                       else None)
        sp = (tp > 1 and shard is not None and shard.sequence_parallel
              and xs.shape[1] % tp == 0)

        if cfg.input_layer == "embed":
            x = nn.embedding(self.embed.weight, xs)
        else:
            x = nn.linear(xs, self.input_linear.weight, self.input_linear.bias)
            x = nn.layer_norm(x, self.input_ln.weight, self.input_ln.bias)
            x = nn.dropout(x, cfg.dropout_rate, seed("input"),
                           deterministic=deterministic)
            x = torch.relu(x)
        x = self._positional_encode(x)
        x = nn.dropout(x, cfg.positional_dropout_rate, seed("pos"),
                       deterministic=deterministic)
        if sp:
            x = sharding.split_seq(x, mesh)

        cd = current_compute_dtype()

        def fft_block(i: int, layer: FFTBlock, x: torch.Tensor) -> torch.Tensor:
            if tp > 1:
                return self._tp_block(
                    i, layer, x, mask=mask, conv_mask=conv_mask, lengths=lengths,
                    seed=seed, deterministic=deterministic, fused=use_fused,
                    fused_train=use_fused_train, sp=sp,
                    shard_index=0 if shard_index is None else shard_index)
            ran_fused_res = False
            residual = x
            y = (nn.layer_norm(x, layer.norm1.weight, layer.norm1.bias)
                 if cfg.normalize_before else x)
            a = layer.attn
            if use_fused_res and quant8.attention_is_quantized(a):
                # int8 tier: the attention-half kernels take the weights
                # dequantized for this call (W8, activations unquantized)
                a = quant8.dequantize_attention(a)
            if use_fused_res and cfg.normalize_before:
                x = attn_kernel.mha_fused_res_apply(a, y, residual, lengths,
                                                    cfg.attention_heads)
                ran_fused_res = True
            elif use_fused_res and flags.FUSED_ATT_QKV:
                x = attn_kernel.attention_block(x, *layer.attn_pack(cd, a), lengths,
                                                cfg.attention_heads)
                ran_fused_res = True
            elif use_fused_res:
                # split route: projections as plain ops (the JAX package
                # leaves them to XLA), then the q/k/v-given kernel
                q, k, v = (nn.linear(x, p.weight, p.bias, out_dtype=cd)
                           for p in (a.q, a.k, a.v))
                x = attn_kernel.attention_res_ln(
                    q, k, v, x, *layer.attn_pack(cd, a)[2:], lengths,
                    cfg.attention_heads)
                ran_fused_res = True
            elif use_fused:
                att = attn_kernel.mha_fused_apply(layer.attn, y, lengths,
                                                  cfg.attention_heads)
            elif use_fused_train:
                att = attention_train.mha_fused_train_apply(
                    layer.attn, y, lengths, cfg.attention_heads,
                    seed(f"{i}/attn"), cfg.attention_dropout_rate,
                    shard_index=shard_index)
            else:
                att = mha_apply(layer.attn, y, y, y, mask, cfg.attention_heads,
                                dropout_rate=cfg.attention_dropout_rate,
                                dropout_seed=seed(f"{i}/attn"),
                                deterministic=deterministic)
            if not ran_fused_res:
                if cfg.concat_after:
                    x = residual + nn.linear(torch.cat([y, att], dim=-1),
                                             layer.concat.weight, layer.concat.bias)
                else:
                    x = residual + nn.dropout(att, cfg.dropout_rate,
                                              seed(f"{i}/res"),
                                              deterministic=deterministic)
                if not cfg.normalize_before:
                    x = nn.layer_norm(x, layer.norm1.weight, layer.norm1.bias)
            # int8 FFN weights never take the FFN kernels: W8A8 convs
            fuse_ffn = use_fused_ffn and not quant8.is_quantized(layer.ffn.w1)
            if fuse_ffn and cfg.normalize_before:
                return ffn_kernel.ffn_block_fused_apply(layer.norm2, layer.ffn, x, lengths)
            if fuse_ffn:
                return ffn_kernel.ffn_block(x, *layer.ffn_pack(cd), lengths,
                                            cfg.positionwise_conv_kernel_size)
            residual = x
            y = (nn.layer_norm(x, layer.norm2.weight, layer.norm2.bias)
                 if cfg.normalize_before else x)
            f = layer.ffn(y, conv_mask, dropout_rate=cfg.dropout_rate,
                          seed=seed(f"{i}/ffn"), deterministic=deterministic)
            x = residual + nn.dropout(f, cfg.dropout_rate, seed(f"{i}/ffn_res"),
                                      deterministic=deterministic)
            if not cfg.normalize_before:
                x = nn.layer_norm(x, layer.norm2.weight, layer.norm2.bias)
            return x

        def replayed_block(i: int, layer: FFTBlock, x: torch.Tensor) -> torch.Tensor:
            # the backward pass replays the block outside the caller's
            # compute-dtype and data-shard contexts: enter them again
            with compute_dtype(cd), data_shard(shard):
                return fft_block(i, layer, x)

        for i, layer in enumerate(self.layers):
            if remat and torch.is_grad_enabled():
                x = checkpoint(replayed_block, i, layer, x, use_reentrant=False)
            else:
                x = fft_block(i, layer, x)
        if sp:
            x = sharding.unsplit_seq(x, mesh)
        if cfg.normalize_before:
            x = nn.layer_norm(x, self.after_norm.weight, self.after_norm.bias)
        return x

    def _tp_block(self, i: int, layer: FFTBlock, x: torch.Tensor, *, mask, conv_mask,
                  lengths, seed, deterministic: bool, fused: bool, fused_train: bool,
                  sp: bool, shard_index: int) -> torch.Tensor:
        """One FFT block over the model group (Megatron; ``sp``: x is this
        rank's time chunk of the residual stream). Dropout masks are the
        blocks of the single-device masks (``nn.dropout``'s ``split``)."""
        cfg, mesh = self.cfg, self.mesh
        H = cfg.attention_heads
        cd = current_compute_dtype()
        dt = cd or x.dtype
        B = x.shape[0]
        T = x.shape[1] * (mesh.tp if sp else 1)
        stream = (1, mesh.model_index * x.shape[1], T) if sp else None

        def P(t):  # a replicated parameter used on the (split) stream
            return sharding.sp_param(t, mesh) if sp else t

        def enter(t):  # into a column-parallel product
            return sharding.gather_seq(t, mesh) if sp else sharding.copy_to_model(t, mesh)

        def leave(t):  # out of a row-parallel product, then its bias
            return (sharding.reduce_scatter_seq(t, mesh) if sp
                    else sharding.reduce_from_model(t, mesh))

        def site(name):
            return None if deterministic else seed(f"{i}/{name}")

        # -- attention half
        a = layer.attn
        residual = x
        y = (nn.layer_norm(x, P(layer.norm1.weight), P(layer.norm1.bias))
             if cfg.normalize_before else x)
        yf = enter(y)
        # the kernels take their operands in the compute dtype; plain
        # attention keeps mha_apply's f32 projections
        pdt = dt if (fused or fused_train) else x.dtype
        q, k, v = (nn.linear(yf, p.weight, p.bias, out_dtype=pdt) for p in (a.q, a.k, a.v))
        Dl = q.shape[-1]
        if H % mesh.tp == 0:
            hl = H // mesh.tp
            h0, dk = mesh.model_index * hl, Dl // hl
            if fused:  # kernel 7 on this rank's heads
                o = attn_kernel.fused_attention_packed(q, k, v, lengths, hl)
            elif fused_train:  # kernel 12 on this rank's heads
                qh, kh, vh = (t.reshape(B, T, hl, dk).transpose(1, 2).contiguous()
                              for t in (q, k, v))
                o = attention_train.fused_attention_train(
                    qh, kh, vh, lengths,
                    attention_train.shard_seed(site("attn"), shard_index),
                    cfg.attention_dropout_rate)
                o = o.transpose(1, 2).reshape(B, T, Dl)
            else:
                o = _heads_attention(q, k, v, mask, hl, cfg.attention_dropout_rate,
                                     site("attn"), deterministic, (1, h0, H))
        else:
            # heads straddle the shards: every rank attends over all heads
            # (the gathered q/k/v) and keeps its own columns
            qf, kf, vf = (sharding.gather_cols(t, mesh) for t in (q, k, v))
            o = _heads_attention(qf, kf, vf, mask, H, cfg.attention_dropout_rate,
                                 site("attn"), deterministic, None)
            o = chunk(o, mesh.model_group, 2)
        att = leave(nn.linear(o.to(dt), a.out.weight, None, out_dtype=torch.float32))
        att = att + P(a.out.bias)
        if cfg.concat_after:
            x = residual + nn.linear(torch.cat([y, att], dim=-1),
                                     P(layer.concat.weight), P(layer.concat.bias))
        else:
            x = residual + nn.dropout(att, cfg.dropout_rate, site("res"),
                                      deterministic=deterministic, split=stream)
        if not cfg.normalize_before:
            x = nn.layer_norm(x, P(layer.norm1.weight), P(layer.norm1.bias))

        # -- FFN half
        f = layer.ffn
        residual = x
        y = (nn.layer_norm(x, P(layer.norm2.weight), P(layer.norm2.bias))
             if cfg.normalize_before else x)
        yf = enter(y)
        op = nn.conv1d if f.kind == "conv1d" else nn.linear
        if f.kind == "conv1d" and conv_mask is not None:
            yf = torch.where(conv_mask[..., None], yf, torch.zeros_like(yf))
        h = torch.relu(op(yf, f.w1.weight, f.w1.bias, out_dtype=dt))
        hl = h.shape[-1]
        h = nn.dropout(h, cfg.dropout_rate, site("ffn"), deterministic=deterministic,
                       split=(2, mesh.model_index * hl, hl * mesh.tp))
        out = leave(op(h, f.w2.weight, None, out_dtype=torch.float32)) + P(f.w2.bias)
        x = residual + nn.dropout(out, cfg.dropout_rate, site("ffn_res"),
                                  deterministic=deterministic, split=stream)
        if not cfg.normalize_before:
            x = nn.layer_norm(x, P(layer.norm2.weight), P(layer.norm2.bias))
        return x


def _heads_attention(q, k, v, mask, n_heads: int, rate: float, seed,
                     deterministic: bool, split) -> torch.Tensor:
    """Masked attention of projected (B, T, n_heads * dk) q, k, v
    (``ops.attention.mha_apply`` without its projections); ``split`` places
    the heads' dropout mask in the single-device one."""
    B, T, D = q.shape
    dk = D // n_heads
    qh, kh, vh = (t.float().reshape(B, T, n_heads, dk).transpose(1, 2) for t in (q, k, v))
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(dk)
    w = masked_softmax(scores, None if mask is None else mask[:, None])
    w = nn.dropout(w, rate, seed, deterministic=deterministic, split=split)
    return (w @ vh).transpose(1, 2).reshape(B, T, D)
