"""MelGAN generator (``fastspeech2_tpu/vocoder/melgan.py``; the reference's
external vocoder, ``seungwonpark/melgan``).

Architecture (MelGAN, arXiv 1910.06711, as released by seungwonpark):
Conv7(n_mels->512, reflect pad), then per upsample rate r in (8, 8, 2, 2):
LeakyReLU(0.2) -> ConvTranspose1d(C -> C/2, kernel 2r, stride r, pad r/2+r%2,
output_pad r%2) -> 3 residual dilated blocks (dilations 1, 3, 9; each
LReLU-Conv3(dil)-LReLU-Conv1 with residual add), finishing with
LeakyReLU -> Conv7(32->1, reflect) -> tanh. Total upsampling 256 == hop length.

Activations are (B, T, C) as in the JAX package. The module's parameter
names follow the JAX params tree (``pre``, ``blocks[i].up``,
``blocks[i].stacks[j].c1/c2``, ``post``) and hold torch layouts, so a
seungwonpark state dict loads after folding its weight norm, with no flip
or transpose (``load_melgan_state_dict``).

The three residual blocks of a stage run as one CUDA kernel
(``ops/kernels/resstack.py``) for CUDA tensors; the convs around them are
plain PyTorch ops, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn as tnn

from fastspeech2_tpu_torch.device import resolve_device
from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.ops.kernels import resstack as resstack_kernel
from fastspeech2_tpu_torch.ops.precision import round_to

LRELU_SLOPE = 0.2
# the log-mel value vocoders treat as silence (log of the mel pipeline's clamp)
MEL_FLOOR = math.log(1e-5)


@dataclass(frozen=True)
class MelGANConfig:
    n_mels: int = 80
    base_channels: int = 512
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    resstack_dilations: Tuple[int, ...] = (1, 3, 9)

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.upsample_rates))


# -- functional ops over (B, T, C) activations --------------------------------
#
# ``cd`` is the rounding dtype of the bf16 tier (None on the f32 tier). A
# tensor that is stored in bf16 rounds by itself; an f32 tensor (the CPU
# route) is rounded with ``round_to`` after every op, which puts the rounding
# points in the same places.

def _q(t: torch.Tensor, cd) -> torch.Tensor:
    return t if cd is None or t.dtype == cd else round_to(t, cd)


def _lrelu(x: torch.Tensor, cd) -> torch.Tensor:
    """LeakyReLU as the JAX package's unfused path computes it: under bf16
    the slope itself is a bf16 value (0.2001953125)."""
    slope = LRELU_SLOPE if cd is None else float(torch.tensor(LRELU_SLOPE).to(cd))
    return torch.where(x >= 0, x, _q(x * slope, cd))


def _conv1d_reflect(x, w, b, dilation: int = 1, cd=None):
    """Conv with reflect padding to SAME length; w (out, in, k), b (out,)."""
    pad = dilation * (w.shape[2] - 1) // 2
    xt = x.transpose(1, 2)
    if pad:
        xt = F.pad(xt, (pad, pad), mode="reflect")
    y = F.conv1d(xt, w.to(x.dtype), dilation=dilation).transpose(1, 2)
    return _q(_q(y, cd) + b.to(x.dtype), cd)


def _conv_transpose1d(x, w, b, stride: int, cd=None):
    """torch ConvTranspose1d(kernel=2*stride, stride, padding=ceil(stride/2),
    output_padding=stride%2); w (in, out, k) in torch's orientation."""
    y = F.conv_transpose1d(x.transpose(1, 2), w.to(x.dtype), stride=stride,
                           padding=stride // 2 + stride % 2,
                           output_padding=stride % 2).transpose(1, 2)
    return _q(_q(y, cd) + b.to(x.dtype), cd)


def polyphase_kernel(w: torch.Tensor, stride: int) -> torch.Tensor:
    """(in, out, 2r) transposed-conv weight -> (2*in, r*out) matrix of the
    polyphase form: rows [0, in) multiply frame t, rows [in, 2*in) frame
    t + 1 of the input padded by one zero frame each side."""
    cin, cout, k = w.shape
    r, h = stride, stride // 2
    # the JAX package stores the spatially flipped kernel as (k, in, out)
    wj = w.flip(-1).permute(2, 0, 1).reshape(2, r, cin, cout)
    phase = (h - 1 - torch.arange(r, device=w.device)) % r
    return wj[:, phase].permute(0, 2, 1, 3).reshape(2 * cin, r * cout)


def _conv_transpose1d_polyphase(x, kern, b, stride: int, cd=None):
    """Polyphase form of ``_conv_transpose1d`` for even strides; kern is
    ``polyphase_kernel(w, stride)``. Since kernel == 2*stride, every output
    sample depends on exactly two input frames: one dense
    (2*C_in -> stride*C_out) product per frame, then a sub-pixel interleave.
    Output phase s of frame t reads frames (t-1, t) for s < stride/2 and
    (t, t+1) above."""
    B, T, cin = x.shape
    r, h = stride, stride // 2
    cout = kern.shape[1] // r
    xp = F.pad(x, (0, 0, 1, 1))
    z = _q(torch.cat([xp[:, :-1], xp[:, 1:]], dim=-1) @ kern.to(x.dtype), cd)
    z = z.reshape(B, T + 1, r, cout)
    y = torch.cat([z[:, :-1, :h], z[:, 1:, h:]], dim=2).reshape(B, T * r, cout)
    return _q(y + b.to(x.dtype), cd)


class _Stack(tnn.Module):
    def __init__(self, ch: int, dilation: int, device=None):
        super().__init__()
        self.c1 = tnn.Conv1d(ch, ch, 3, dilation=dilation, device=device)
        self.c2 = tnn.Conv1d(ch, ch, 1, device=device)


class _Block(tnn.Module):
    def __init__(self, ch: int, rate: int, dilations, device=None):
        super().__init__()
        self.up = tnn.ConvTranspose1d(ch, ch // 2, 2 * rate, stride=rate,
                                      padding=rate // 2 + rate % 2,
                                      output_padding=rate % 2, device=device)
        self.stacks = tnn.ModuleList(_Stack(ch // 2, d, device=device)
                                     for d in dilations)


class MelGANGenerator(tnn.Module):
    """(B, T, n_mels) log-mel -> (B, T*hop) f32 waveform.

    ``bf16=True`` runs the whole stack in bfloat16 -- weights, mel, conv
    outputs, bias adds, LeakyReLU, tanh -- and widens the result to f32 (the
    JAX generator's bf16 tier; a different contract from ``ops/nn.py``'s).
    On the card the activations are stored in bf16; on the CPU they are f32
    tensors rounded to bf16 after every op.

    ``fused_resstack``: run the residual blocks of each stage as one kernel
    (``ops/kernels/resstack.py``). None (default) takes it for CUDA tensors
    when the stage length is tileable (``resstack_tile``) and the width is at
    least ``fused_min_channels``; such a stage launches the kernel or raises.
    The per-layer loop of plain convs serves untileable lengths, CPU tensors
    and ``fused_resstack=False``. True takes the wrapper on any device (its
    plain version on the CPU).

    Weights are drawn from ``seed`` with an explicit ``torch.Generator``
    (uniform in +-1/sqrt(fan_in), as ``init_melgan``; not its numbers).
    """

    def __init__(self, cfg: MelGANConfig = MelGANConfig(), bf16: bool = False,
                 fused_resstack: Optional[bool] = None,
                 fused_min_channels: int = 0, seed: int = 0,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        self.cfg = cfg
        self.bf16 = bf16
        self.fused_resstack = fused_resstack
        self.fused_min_channels = fused_min_channels
        device = resolve_device(device)
        ch = cfg.base_channels
        self.pre = tnn.Conv1d(cfg.n_mels, ch, 7, device=device)
        blocks = []
        for r in cfg.upsample_rates:
            blocks.append(_Block(ch, r, cfg.resstack_dilations, device=device))
            ch //= 2
        self.blocks = tnn.ModuleList(blocks)
        self.post = tnn.Conv1d(ch, 1, 7, device=device)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, tnn.Conv1d):
                    fan_in = m.weight.shape[1] * m.weight.shape[2]
                elif isinstance(m, tnn.ConvTranspose1d):
                    fan_in = m.weight.shape[0] * m.weight.shape[2]
                else:
                    continue
                bound = 1.0 / math.sqrt(fan_in)
                for p in (m.weight, m.bias):
                    p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
        self.eval()

    def _use_fused(self, x: torch.Tensor) -> bool:
        if self.fused_resstack is None:
            if x.device.type != "cuda":
                return False
        elif not self.fused_resstack:
            return False
        return (x.shape[2] >= self.fused_min_channels
                and resstack_kernel.resstack_tile(x.shape[1]) > 0)

    def _stage_pack(self, block: _Block, cd: torch.dtype):
        """(polyphase matrix or None, resstack weights) of one stage."""
        def build():
            r = block.up.stride[0]
            kern = (polyphase_kernel(block.up.weight, r).to(cd).contiguous()
                    if r % 2 == 0 else None)
            return kern, resstack_kernel.pack_weights(block.stacks, cd)
        return common.cached_pack(block, list(block.parameters()), build)

    def residual_loop(self, x: torch.Tensor, block: _Block, cd) -> torch.Tensor:
        """One stage's residual blocks as the per-layer loop of plain convs
        (cuDNN on the card): the route of ``fused_resstack=False``."""
        for d, stack in zip(self.cfg.resstack_dilations, block.stacks):
            y = _lrelu(x, cd)
            y = _conv1d_reflect(y, _q(stack.c1.weight, cd), _q(stack.c1.bias, cd),
                                dilation=d, cd=cd)
            y = _lrelu(y, cd)
            y = _conv1d_reflect(y, _q(stack.c2.weight, cd), _q(stack.c2.bias, cd), cd=cd)
            x = _q(x + y, cd)
        return x

    @torch.inference_mode()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cd = torch.bfloat16 if self.bf16 else None
        pack_dt = cd or torch.float32
        # storage dtype: real bf16 on the card, rounded f32 on the CPU
        x = mel.to(cd) if (cd is not None and mel.device.type == "cuda") \
            else _q(mel.float(), cd)
        x = _conv1d_reflect(x, _q(self.pre.weight, cd), _q(self.pre.bias, cd), cd=cd)
        for r, block in zip(self.cfg.upsample_rates, self.blocks):
            kern, stack_w = self._stage_pack(block, pack_dt)
            x = _lrelu(x, cd)
            if r % 2 == 0:
                x = _conv_transpose1d_polyphase(x, kern, _q(block.up.bias, cd), r,
                                                cd=cd)
            else:
                x = _conv_transpose1d(x, _q(block.up.weight, cd),
                                      _q(block.up.bias, cd), r, cd=cd)
            if self._use_fused(x):
                x = resstack_kernel.resstack(x.contiguous(), *stack_w,
                                             self.cfg.resstack_dilations)
            else:
                x = self.residual_loop(x, block, cd)
        x = _lrelu(x, cd)
        x = _conv1d_reflect(x, _q(self.post.weight, cd), _q(self.post.bias, cd), cd=cd)
        return _q(torch.tanh(x), cd)[..., 0].float()

    def inference(self, mel: torch.Tensor, pad_frames: int = 10) -> torch.Tensor:
        """Mirror of the hub model's .inference: pad the mel tail with the
        log-floor value (log(1e-5)) to flush the transposed-conv edge, then
        trim."""
        mel = F.pad(mel, (0, 0, 0, pad_frames), value=MEL_FLOOR)
        return self(mel)[:, : -(pad_frames * self.cfg.hop_length)]


# -- checkpoints ---------------------------------------------------------------

def _melgan_state_dict(path: str) -> Dict[str, np.ndarray]:
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj
    for key in ("model_g", "generator", "model", "state_dict"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    return {k: np.asarray(v) for k, v in sd.items()
            if hasattr(v, "__array__") or hasattr(v, "numpy")}


def melgan_config_from_checkpoint(path: str) -> MelGANConfig:
    """Infer (n_mels, base_channels) from the first conv's weight shape --
    the hub checkpoint is the default (80, 512); locally-trained narrower
    generators load without a hand-written config."""
    sd = _melgan_state_dict(path)
    key = next(k for k in ("1.weight_v", "generator.1.weight_v") if k in sd)
    out_ch, in_ch, _ = sd[key].shape  # Conv1d (out, in, k)
    return MelGANConfig(n_mels=int(in_ch), base_channels=int(out_ch))


def _fold_weight_norm(sd: Dict[str, np.ndarray], base: str) -> np.ndarray:
    g = np.asarray(sd[f"{base}.weight_g"])
    v = np.asarray(sd[f"{base}.weight_v"])
    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def load_melgan_state_dict(gen: MelGANGenerator, sd: Dict[str, np.ndarray]
                           ) -> MelGANGenerator:
    """Fill ``gen`` from a seungwonpark/melgan generator state dict
    (weight-normed, Sequential index naming ``generator.{i}...``). Conv1d
    (out, in, k) and ConvTranspose1d (in, out, k) weights keep their torch
    layout: only the weight norm is folded. Lands on the same function as the
    JAX package's ``melgan_params_from_torch``. Strict: every tensor of the
    module is set, with its exact shape."""
    sd = {k.replace("generator.", "", 1) if k.startswith("generator.") else k: v
          for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, base: str):
        out[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(_fold_weight_norm(sd, base), np.float32))
        out[f"{name}.bias"] = torch.from_numpy(
            np.asarray(sd[f"{base}.bias"], np.float32))

    # Sequential layout of seungwonpark's Generator:
    # 0 ReflectionPad, 1 Conv7, then per rate: LeakyReLU, ConvT, ResStack,
    # finally LeakyReLU, ReflectionPad, Conv7, Tanh.
    put("pre", "1")
    idx = 2
    for i in range(len(gen.cfg.upsample_rates)):
        idx += 1  # LeakyReLU
        put(f"blocks.{i}.up", str(idx))
        idx += 1
        for j in range(len(gen.cfg.resstack_dilations)):
            # ResStack block Sequential: 0 LReLU, 1 ReflectionPad, 2 Conv3,
            # 3 LReLU, 4 Conv1
            put(f"blocks.{i}.stacks.{j}.c1", f"{idx}.blocks.{j}.2")
            put(f"blocks.{i}.stacks.{j}.c2", f"{idx}.blocks.{j}.4")
        idx += 1
    idx += 2  # LeakyReLU, ReflectionPad
    put("post", str(idx))
    own = gen.state_dict()
    for name, t in out.items():
        if name in own and tuple(own[name].shape) != tuple(t.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != "
                             f"generator shape {tuple(own[name].shape)}")
    gen.load_state_dict(out, strict=True)
    return gen


def melgan_state_dict(gen: MelGANGenerator) -> Dict[str, torch.Tensor]:
    """``gen``'s weights as a seungwonpark/melgan generator state dict
    (``generator.{i}`` Sequential names, each weight as ``weight_g`` = its
    norm over all but the first axis and ``weight_v`` = the weight): the
    format ``load_melgan_state_dict`` reads, for checkpoints of seeded
    generators. The weight norm folds back to the weight up to rounding."""
    own = {k: v.detach().float().cpu() for k, v in gen.state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    idx, n_stacks = 2, len(gen.cfg.resstack_dilations)

    def put(name: str, base: str):
        w = own[f"{name}.weight"]
        out[f"generator.{base}.weight_g"] = w.flatten(1).norm(dim=1).reshape(
            -1, *([1] * (w.dim() - 1)))
        out[f"generator.{base}.weight_v"] = w.clone()
        out[f"generator.{base}.bias"] = own[f"{name}.bias"].clone()

    # the Sequential indices of load_melgan_state_dict
    put("pre", "1")
    for i in range(len(gen.cfg.upsample_rates)):
        idx += 1
        put(f"blocks.{i}.up", str(idx))
        idx += 1
        for j in range(n_stacks):
            put(f"blocks.{i}.stacks.{j}.c1", f"{idx}.blocks.{j}.2")
            put(f"blocks.{i}.stacks.{j}.c2", f"{idx}.blocks.{j}.4")
        idx += 1
    put("post", str(idx + 2))
    return out


def load_melgan_params(path: str, cfg: MelGANConfig = MelGANConfig(),
                       bf16: bool = False,
                       device: Union[str, torch.device, None] = None
                       ) -> MelGANGenerator:
    """Load a seungwonpark/melgan-format torch checkpoint into a generator
    on ``device`` -- e.g. for ``Synthesizer.attach_vocoder``, which keeps
    the mel on the device."""
    gen = MelGANGenerator(cfg, bf16=bf16, device=device)
    return load_melgan_state_dict(gen, _melgan_state_dict(path))


def load_melgan(path: str, cfg: MelGANConfig = MelGANConfig(),
                bf16: bool = False, batch_frames: int = 256,
                device: Union[str, torch.device, None] = None):
    """Load a seungwonpark/melgan-format torch checkpoint and return a
    callable ``(L, n_mels) log-mel -> (L*hop,) float waveform`` for a
    server's ``vocoder=`` or ``Synthesizer.attach_vocoder_fn``.

    Accepts a raw generator state_dict or a training checkpoint carrying it
    under ``model_g`` / ``generator`` / ``model``. Mels pad with the log
    floor so that L + 10 tail frames land on a multiple of ``batch_frames``:
    a few shapes instead of one per mel, and with the default 256 every stage
    length is a multiple of 2048, which the fused residual-stack route needs.
    """
    gen = load_melgan_params(path, cfg, bf16=bf16, device=device)
    dev = gen.pre.weight.device
    tail = 10  # gen.inference's pad_frames default

    def vocoder(mel: np.ndarray) -> np.ndarray:
        L = mel.shape[0]
        pad = (-(L + tail)) % batch_frames
        m = np.pad(np.asarray(mel, np.float32), ((0, pad), (0, 0)),
                   constant_values=MEL_FLOOR)
        wav = gen.inference(torch.from_numpy(m[None]).to(dev))
        return wav[0, : L * cfg.hop_length].cpu().numpy()

    vocoder.hop_length = cfg.hop_length
    return vocoder
