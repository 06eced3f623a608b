"""WaveGlow vocoder, inference (``fastspeech2_tpu/vocoder/waveglow.py``).

NVIDIA's WaveGlow (arXiv 1811.00002), the vocoder the reference's demo pairs
with FastSpeech 2, run in the synthesis direction only:

- conditioning: mel (B, T, n_mels) -> ConvTranspose1d(n_mels -> n_mels,
  kernel 1024, stride 256), tail-trimmed by kernel - stride, grouped by
  ``n_group`` samples into (B, n_mels*n_group, T*hop/n_group) with channel
  mel_bin*n_group + offset. The transposed conv runs as a polyphase
  kernel-4 product (one dense (4*n_mels -> hop*n_mels) matrix per mel
  frame), the trick of the port's MelGAN upsampler at kernel = m*stride.
- 12 flows in reverse: the affine coupling's inverse (a WaveNet-like WN on
  the untouched half predicts (b, log s); ``a1 = (a1 - b) * exp(-s)``), then
  the invertible 1x1 convolution's inverse, precomputed in float64 at load.
- before flows 8 and 4 (every ``n_early_every`` in reverse) ``n_early_size``
  noise channels are prepended.

Activations are channels-first inside (torch's conv layout); ``infer``
takes and returns the JAX package's layouts: mel (B, T, n_mels), pinned
noise ``zs`` (B, T*hop/n_group, c), audio (B, T*hop). ``bf16=True`` casts
the weights, the mel and the noise to bf16 and rounds after every op, as the
JAX package's bf16 tier does (bf16 tensors on the card; f32 tensors rounded
to bf16 on the CPU). WaveGlow has no TPU kernel: every op is a PyTorch op.

The module's names follow the JAX params tree (``upsample``,
``flows[k].inv_w``, ``flows[k].wn.{start,end,cond}``, ``flows[k].wn.in_layers[i]``
for its ``in``, ``flows[k].wn.res_skip[i]``). ``waveglow_params_from_torch``
translates an NVIDIA state dict (weight-normed or folded, fused ``cond_layer``
or legacy ``cond_layers``) into that state dict; ``nvidia_state_dict`` is
its inverse, weight-normed as NVIDIA's training checkpoints are.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn as tnn

from fastspeech2_tpu_torch.device import resolve_device
from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.ops.precision import round_to

# the log-mel value vocoders treat as silence (log of the mel pipeline's clamp)
MEL_FLOOR = math.log(1e-5)


@dataclass(frozen=True)
class WaveGlowConfig:
    n_mels: int = 80
    n_flows: int = 12
    n_group: int = 8
    n_early_every: int = 4
    n_early_size: int = 2
    wn_layers: int = 8
    wn_channels: int = 512
    wn_kernel: int = 3
    upsample_kernel: int = 1024
    hop_length: int = 256  # == upsample stride

    @property
    def flow_channels(self) -> Tuple[int, ...]:
        """Audio channels entering each flow k (forward direction)."""
        rem, chans = self.n_group, []
        for k in range(self.n_flows):
            if k % self.n_early_every == 0 and k > 0:
                rem -= self.n_early_size
            chans.append(rem)
        return tuple(chans)

    @property
    def n_remaining(self) -> int:
        """Channels of the final latent z (4 at the default config)."""
        return self.flow_channels[-1]

    @property
    def n_draws(self) -> int:
        """Noise tensors one synthesis draws: z, then one per early output."""
        return 1 + sum(1 for k in range(1, self.n_flows) if k % self.n_early_every == 0)


def _q(t: torch.Tensor, cd) -> torch.Tensor:
    return t if cd is None or t.dtype == cd else round_to(t, cd)


def _conv(x, w, b, cd, dilation: int = 1):
    """SAME zero-padded conv over (B, C, L): ``round(round(conv) + b)``."""
    pad = dilation * (w.shape[2] - 1) // 2
    y = F.conv1d(x, w, padding=pad, dilation=dilation)
    return _q(_q(y, cd) + b[:, None], cd)


def polyphase_kernel(w: torch.Tensor, stride: int) -> torch.Tensor:
    """(in, out, m*stride) transposed-conv weight -> the (m*in, stride*out)
    matrix of its polyphase form: row j*in + i multiplies input frame
    u - m + 1 + j of output block u, column s*out + o is output sample
    u*stride + s, channel o."""
    cin, cout, k = w.shape
    m = k // stride
    if m * stride != k:
        raise ValueError(f"upsample kernel {k} is not a multiple of its stride {stride}")
    taps = w.reshape(cin, cout, m, stride).flip(2)            # [i, o, j, s]
    return taps.permute(2, 0, 3, 1).reshape(m * cin, stride * cout)


def upsample_polyphase(mel: torch.Tensor, kern: torch.Tensor, b: torch.Tensor,
                       stride: int, cd=None) -> torch.Tensor:
    """torch ConvTranspose1d(kernel = m*stride, stride, padding 0) of a
    (B, T, C) input with the tail ``kernel - stride`` samples trimmed, as a
    kernel-m product: left-pad m - 1 zero frames, gather m frames a row,
    multiply by ``polyphase_kernel``, then a sub-pixel reshape. (B, T*stride,
    C_out) out."""
    B, T, cin = mel.shape
    m = kern.shape[0] // cin
    xp = F.pad(mel, (0, 0, m - 1, 0))
    cols = torch.cat([xp[:, j:j + T] for j in range(m)], dim=-1)
    z = _q(cols @ kern, cd)
    return _q(z.reshape(B, T * stride, -1) + b, cd)


class _Conv(tnn.Module):
    """Weight (out, in, k) and bias of one WN conv."""

    def __init__(self, cin: int, cout: int, k: int = 1, device=None):
        super().__init__()
        self.weight = tnn.Parameter(torch.zeros(cout, cin, k, device=device))
        self.bias = tnn.Parameter(torch.zeros(cout, device=device))


class _WN(tnn.Module):
    def __init__(self, n_half: int, cfg: WaveGlowConfig, device=None):
        super().__init__()
        C, L = cfg.wn_channels, cfg.wn_layers
        self.start = _Conv(n_half, C, 1, device)
        self.end = _Conv(C, 2 * n_half, 1, device)
        self.cond = _Conv(cfg.n_mels * cfg.n_group, 2 * C * L, 1, device)
        self.in_layers = tnn.ModuleList(_Conv(C, 2 * C, cfg.wn_kernel, device)
                                        for _ in range(L))
        self.res_skip = tnn.ModuleList(_Conv(C, 2 * C if i < L - 1 else C, 1, device)
                                       for i in range(L))


class _Flow(tnn.Module):
    def __init__(self, c: int, cfg: WaveGlowConfig, device=None):
        super().__init__()
        self.wn = _WN(c // 2, cfg, device)
        # inverse of the 1x1 conv, transposed: audio (.., c) @ inv_w
        self.register_buffer("inv_w", torch.eye(c, device=device))


def _wn_apply(wn: Dict[str, torch.Tensor], a0: torch.Tensor, cond: torch.Tensor,
              n_layers: int, cd) -> torch.Tensor:
    """The coupling network on (B, n_half, Lg) with the flow's conditioning
    activations (B, 2*C*n_layers, Lg) -> (B, 2*n_half, Lg) = [b | log s].
    ``wn``: this flow's weights by name (``start.weight`` ...)."""
    x = _conv(a0, wn["start.weight"], wn["start.bias"], cd)
    C = x.shape[1]
    out = None
    for i in range(n_layers):
        ia = _conv(x, wn[f"in_layers.{i}.weight"], wn[f"in_layers.{i}.bias"], cd,
                   dilation=2 ** i)
        ia = _q(ia + cond[:, i * 2 * C:(i + 1) * 2 * C], cd)
        acts = _q(_q(torch.tanh(ia[:, :C]), cd) * _q(torch.sigmoid(ia[:, C:]), cd), cd)
        rs = _conv(acts, wn[f"res_skip.{i}.weight"], wn[f"res_skip.{i}.bias"], cd)
        skip = rs[:, C:] if i < n_layers - 1 else rs
        out = skip if out is None else _q(out + skip, cd)
        if i < n_layers - 1:
            x = _q(x + rs[:, :C], cd)
    return _conv(out, wn["end.weight"], wn["end.bias"], cd)


class WaveGlow(tnn.Module):
    """(B, T, n_mels) log-mel -> (B, T*hop) f32 waveform: ``WaveGlow.infer``
    of NVIDIA's released model. Weights are zeros until loaded or drawn
    (``init_waveglow``)."""

    def __init__(self, cfg: WaveGlowConfig = WaveGlowConfig(), bf16: bool = False,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        self.cfg = cfg
        self.bf16 = bf16
        device = resolve_device(device)
        self.upsample = tnn.Module()
        self.upsample.weight = tnn.Parameter(torch.zeros(
            cfg.n_mels, cfg.n_mels, cfg.upsample_kernel, device=device))
        self.upsample.bias = tnn.Parameter(torch.zeros(cfg.n_mels, device=device))
        self.flows = tnn.ModuleList(_Flow(c, cfg, device) for c in cfg.flow_channels)
        self.eval()

    def _dtypes(self):
        """(rounding dtype, storage dtype): (None, f32) in f32; under bf16
        (bf16, bf16) on the card and (bf16, f32 rounded to bf16) on the CPU."""
        cd = torch.bfloat16 if self.bf16 else None
        on_card = self.upsample.weight.device.type == "cuda"
        return cd, (cd if cd is not None and on_card else torch.float32)

    def _weights(self):
        """(polyphase matrix, upsample bias, per flow: (WN weights by name,
        inv_w)) as the synthesis uses them (cast and rounded as ``_dtypes``
        says), kept until a weight changes."""
        cd, dt = self._dtypes()

        def cast(t):
            return _q(t.to(dt), cd)

        def build():
            up = self.upsample
            flows = [({n: cast(p) for n, p in f.wn.named_parameters()}, cast(f.inv_w))
                     for f in self.flows]
            return (polyphase_kernel(cast(up.weight), self.cfg.hop_length).contiguous(),
                    cast(up.bias), flows)
        return common.cached_pack(self, [*self.parameters(), *self.buffers()], build)

    def condition(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) -> grouped upsampled mel (B, n_mels*n_group, Lg),
        in the synthesis dtype."""
        cfg = self.cfg
        cd, dt = self._dtypes()
        kern, b, _ = self._weights()
        up = upsample_polyphase(_q(mel.to(dt), cd), kern, b, cfg.hop_length, cd)
        B, L, _ = up.shape
        g = cfg.n_group
        return up.reshape(B, L // g, g, cfg.n_mels).permute(0, 3, 2, 1).reshape(
            B, cfg.n_mels * g, L // g)

    @torch.inference_mode()
    def infer(self, mel: torch.Tensor, generator: Optional[torch.Generator] = None,
              sigma: float = 1.0, zs: Optional[Sequence[torch.Tensor]] = None
              ) -> torch.Tensor:
        """Synthesize. Noise is ``zs`` (pinned, for parity: the initial z
        (B, Lg, n_remaining), then one (B, Lg, n_early_size) per early
        re-injection in reverse flow order) or drawn in that order from
        ``generator`` (a ``torch.Generator`` on the mel's device)."""
        cfg = self.cfg
        cd, dt = self._dtypes()
        spect = self.condition(mel)
        B, _, Lg = spect.shape
        chans = cfg.flow_channels
        if zs is None:
            if generator is None:
                raise ValueError("WaveGlow.infer needs a generator or pinned zs")
            shapes = [(B, Lg, chans[-1])] + [(B, Lg, cfg.n_early_size)] * (cfg.n_draws - 1)
            zs = [torch.randn(s, generator=generator, device=mel.device) for s in shapes]
        if len(zs) != cfg.n_draws:
            raise ValueError(f"expected {cfg.n_draws} noise tensors, got {len(zs)}")
        zi = iter(_q(torch.as_tensor(z).to(device=mel.device, dtype=dt), cd).transpose(1, 2)
                  for z in zs)
        _, _, flows = self._weights()
        audio = _q(sigma * next(zi), cd)
        for k in reversed(range(cfg.n_flows)):
            wn, inv_w = flows[k]
            n_half = chans[k] // 2
            a0, a1 = audio[:, :n_half], audio[:, n_half:]
            cond = _conv(spect, wn["cond.weight"], wn["cond.bias"], cd)
            out = _wn_apply(wn, a0, cond, cfg.wn_layers, cd)
            del cond
            b, s = out[:, :n_half], out[:, n_half:]
            a1 = _q(_q(a1 - b, cd) * _q(torch.exp(-s), cd), cd)
            audio = torch.cat([a0, a1], dim=1)
            # the inverse 1x1 in the audio dtype: (B, Lg, c) @ inv_w
            audio = _q(torch.einsum("bct,co->bot", audio, inv_w), cd)
            if k % cfg.n_early_every == 0 and k > 0:
                audio = torch.cat([_q(sigma * next(zi), cd), audio], dim=1)
        return audio.transpose(1, 2).reshape(B, -1).float()


# -- weights -------------------------------------------------------------------

def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    t.copy_((torch.rand(t.shape, generator=gen, dtype=torch.float64) * 2 - 1) * bound)


@torch.no_grad()
def init_waveglow(cfg: WaveGlowConfig = WaveGlowConfig(), seed: int = 0,
                  bf16: bool = False, device: Union[str, torch.device, None] = None
                  ) -> WaveGlow:
    """Seeded random weights (tests, smoke), drawn as ``init_waveglow`` of
    the JAX package draws them (not its numbers): uniform +-1/sqrt(fan_in),
    orthogonal 1x1 convs from the QR of a Gaussian with det +1 (NVIDIA's
    init), a small random ``end`` (NVIDIA zero-inits it; a non-zero one
    makes the couplings do work); the 1x1 inverses in float64."""
    wg = WaveGlow(cfg, bf16=bf16, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    _uniform_(wg.upsample.weight, 1.0 / math.sqrt(cfg.n_mels * cfg.upsample_kernel), gen)
    _uniform_(wg.upsample.bias, 1.0 / math.sqrt(cfg.n_mels * cfg.upsample_kernel), gen)
    for flow in wg.flows:
        c = flow.inv_w.shape[0]
        q, _ = torch.linalg.qr(torch.randn(c, c, generator=gen, dtype=torch.float64))
        if torch.det(q) < 0:
            q[:, 0] = -q[:, 0]
        flow.inv_w.copy_(torch.linalg.inv(q).t())
        for name, conv in flow.wn.named_modules():
            if isinstance(conv, _Conv):
                out, cin, k = conv.weight.shape
                bound = 0.01 if name == "end" else 1.0 / math.sqrt(cin * k)
                _uniform_(conv.weight, bound, gen)
                _uniform_(conv.bias, bound, gen)
    return wg.to(resolve_device(device))


def _fold_wn(sd: Dict[str, np.ndarray], base: str) -> np.ndarray:
    """The plain weight at ``base``, folding torch weight_norm (g * v / ||v||,
    the norm over all dims but 0) when the dict still carries it."""
    if f"{base}.weight" in sd:
        return np.asarray(sd[f"{base}.weight"])
    g = np.asarray(sd[f"{base}.weight_g"])
    v = np.asarray(sd[f"{base}.weight_v"])
    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _has(sd, base: str) -> bool:
    return f"{base}.weight" in sd or f"{base}.weight_v" in sd


def waveglow_config_from_state_dict(sd: Dict[str, np.ndarray]) -> WaveGlowConfig:
    """Every dimension from the checkpoint's shapes (256- and 512-channel WN
    variants load without a config file). The stride is not in the shapes:
    NVIDIA's upsampler always has kernel = 4 * stride."""
    n_flows = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("WN."))
    wn_layers = 1 + max(int(k.split(".")[3]) for k in sd
                        if k.startswith("WN.0.in_layers."))
    w_in0 = _fold_wn(sd, "WN.0.in_layers.0")
    n_mels, _, up_k = np.asarray(sd["upsample.weight"]).shape  # (in, out, k)
    chans = [2 * _fold_wn(sd, f"WN.{k}.start").shape[1] for k in range(n_flows)]
    n_early_every = next((k for k in range(1, n_flows) if chans[k] != chans[k - 1]), 4)
    n_early_size = chans[0] - chans[n_early_every] if n_early_every < n_flows else 2
    cond = "WN.0.cond_layer" if _has(sd, "WN.0.cond_layer") else "WN.0.cond_layers.0"
    cond_in = _fold_wn(sd, cond).shape[1]
    if cond_in != n_mels * chans[0]:
        raise ValueError(f"cond input {cond_in} != n_mels {n_mels} * n_group {chans[0]}")
    return WaveGlowConfig(
        n_mels=int(n_mels), n_flows=n_flows, n_group=chans[0],
        n_early_every=n_early_every, n_early_size=n_early_size,
        wn_layers=wn_layers, wn_channels=w_in0.shape[0] // 2,
        wn_kernel=w_in0.shape[2], upsample_kernel=int(up_k), hop_length=int(up_k) // 4)


def waveglow_params_from_torch(sd: Dict[str, np.ndarray],
                               cfg: Optional[WaveGlowConfig] = None
                               ) -> Tuple[Dict[str, torch.Tensor], WaveGlowConfig]:
    """An NVIDIA-format WaveGlow state dict (torch hub ``nvidia_waveglow`` /
    the waveglow repo; weight-normed or folded; fused ``cond_layer`` or
    legacy per-layer ``cond_layers.{i}``, concatenated in layer order) ->
    (the port's state dict, config). Conv weights keep torch's (out, in, k);
    each Invertible1x1Conv is inverted in float64 and transposed."""
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
    if cfg is None:
        cfg = waveglow_config_from_state_dict(sd)
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, w: np.ndarray, b: np.ndarray) -> None:
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w, np.float32))
        out[f"{name}.bias"] = torch.from_numpy(np.ascontiguousarray(b, np.float32))

    def conv(name: str, base: str) -> None:
        w = _fold_wn(sd, base)
        put(name, w, sd.get(f"{base}.bias", np.zeros(w.shape[0], np.float32)))

    put("upsample", np.asarray(sd["upsample.weight"]), np.asarray(sd["upsample.bias"]))
    for k in range(cfg.n_flows):
        src, dst = f"WN.{k}", f"flows.{k}.wn"
        conv(f"{dst}.start", f"{src}.start")
        conv(f"{dst}.end", f"{src}.end")
        if _has(sd, f"{src}.cond_layer"):
            conv(f"{dst}.cond", f"{src}.cond_layer")
        else:
            parts = [(_fold_wn(sd, f"{src}.cond_layers.{i}"),
                      np.asarray(sd[f"{src}.cond_layers.{i}.bias"]))
                     for i in range(cfg.wn_layers)]
            put(f"{dst}.cond", np.concatenate([w for w, _ in parts]),
                np.concatenate([b for _, b in parts]))
        for i in range(cfg.wn_layers):
            conv(f"{dst}.in_layers.{i}", f"{src}.in_layers.{i}")
            conv(f"{dst}.res_skip.{i}", f"{src}.res_skip_layers.{i}")
        w1x1 = np.asarray(sd[f"convinv.{k}.conv.weight"], np.float64)[..., 0]
        out[f"flows.{k}.inv_w"] = torch.from_numpy(
            np.ascontiguousarray(np.linalg.inv(w1x1).T, np.float32))
    return out, cfg


@torch.no_grad()
def nvidia_state_dict(wg: WaveGlow, weight_norm: bool = True) -> Dict[str, torch.Tensor]:
    """The port's weights in NVIDIA's key format (fused ``cond_layer``); with
    ``weight_norm`` the start, cond, in and res_skip convs carry
    ``weight_g``/``weight_v`` as an unfolded training checkpoint does. The
    1x1 conv weights are the inverses of ``inv_w``, taken in float64."""
    sd: Dict[str, torch.Tensor] = {
        "upsample.weight": wg.upsample.weight.detach().cpu().clone(),
        "upsample.bias": wg.upsample.bias.detach().cpu().clone()}
    normed = ("start", "cond_layer", "in_layers", "res_skip_layers")
    for k, flow in enumerate(wg.flows):
        wn = flow.wn
        convs = [("start", wn.start), ("end", wn.end), ("cond_layer", wn.cond)]
        convs += [(f"in_layers.{i}", c) for i, c in enumerate(wn.in_layers)]
        convs += [(f"res_skip_layers.{i}", c) for i, c in enumerate(wn.res_skip)]
        for name, c in convs:
            base, w = f"WN.{k}.{name}", c.weight.detach().cpu().float()
            if weight_norm and name.split(".")[0] in normed:
                sd[f"{base}.weight_g"] = w.flatten(1).norm(dim=1).reshape(-1, 1, 1)
                sd[f"{base}.weight_v"] = w.clone()
            else:
                sd[f"{base}.weight"] = w.clone()
            sd[f"{base}.bias"] = c.bias.detach().cpu().clone()
        w1x1 = torch.linalg.inv(flow.inv_w.detach().cpu().double().t())
        sd[f"convinv.{k}.conv.weight"] = w1x1.float()[:, :, None]
    return sd


def _state_dict_of(path: str) -> Dict[str, np.ndarray]:
    """The WaveGlow state dict of a checkpoint: a raw state dict, the
    hub/DeepLearningExamples wrappers (``state_dict`` / ``model``), or a
    training checkpoint holding the pickled module."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj
    for key in ("state_dict", "model", "waveglow"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    if hasattr(sd, "state_dict"):  # a pickled nn.Module
        sd = sd.state_dict()
    return {k[len("model."):] if k.startswith("model.") else k:
            np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in sd.items() if hasattr(v, "__array__") or hasattr(v, "numpy")}


def load_waveglow_params(path: str, bf16: bool = False,
                         device: Union[str, torch.device, None] = None) -> WaveGlow:
    """A WaveGlow checkpoint -> a ``WaveGlow`` on ``device`` (its ``cfg``
    read from the shapes). Strict: every weight of the module is set; a
    dict that lacks one, or whose shapes do not make a WaveGlow, raises
    ``ValueError``."""
    try:
        sd, cfg = waveglow_params_from_torch(_state_dict_of(path))
    except (KeyError, IndexError, ValueError) as e:
        raise ValueError(f"{path} is not a complete WaveGlow checkpoint: {e!r}") from e
    wg = WaveGlow(cfg, bf16=bf16, device="cpu")
    wg.load_state_dict(sd, strict=True)
    return wg.to(resolve_device(device))


def load_waveglow(path: str, sigma: float = 1.0, bf16: bool = False,
                  batch_frames: int = 64, seed: int = 0,
                  device: Union[str, torch.device, None] = None):
    """Load a torch WaveGlow checkpoint and return a callable ``(L, n_mels)
    log-mel -> (L*hop,) float waveform`` for ``infer.synthesize.vocode``, the
    counterpart of ``melgan.load_melgan``.

    Mels pad with the log(1e-5) floor to a multiple of ``batch_frames``.
    Noise comes from a generator seeded by (seed, call counter): the same
    for a fixed sequence of calls, independent across calls. The counter is
    taken under a lock (the server's threads call the vocoder).

    ``.batched(mels (B, L, n_mels), out_lens (B,)) -> (B, L*hop)`` vocodes a
    padded serving batch in one call, frames past each row's length masked
    to the floor first; ``Synthesizer.attach_vocoder_fn`` uses it. The
    callable also carries ``.hop_length`` and ``.waveglow`` (the module)."""
    wg = load_waveglow_params(path, bf16=bf16, device=device)
    dev = wg.upsample.weight.device
    hop = wg.cfg.hop_length
    lock, calls = threading.Lock(), [0]

    def generator() -> torch.Generator:
        with lock:
            n = calls[0]
            calls[0] += 1
        return torch.Generator(device=dev).manual_seed((seed << 32) + n)

    def padded(mels: np.ndarray) -> torch.Tensor:
        pad = (-mels.shape[1]) % batch_frames
        m = np.pad(np.asarray(mels, np.float32), ((0, 0), (0, pad), (0, 0)),
                   constant_values=MEL_FLOOR)
        return torch.from_numpy(m).to(dev)

    def vocoder(mel: np.ndarray) -> np.ndarray:
        L = mel.shape[0]
        wav = wg.infer(padded(mel[None]), generator(), sigma=sigma)
        return wav[0, : L * hop].cpu().numpy()

    def batched(mels: np.ndarray, out_lens: np.ndarray) -> np.ndarray:
        L = mels.shape[1]
        m = padded(mels)
        valid = (torch.arange(m.shape[1], device=dev)[None, :, None]
                 < torch.as_tensor(np.asarray(out_lens), device=dev)[:, None, None])
        m = torch.where(valid, m, torch.full_like(m, MEL_FLOOR))
        wav = wg.infer(m, generator(), sigma=sigma)
        return wav[:, : L * hop].cpu().numpy()

    vocoder.batched = batched
    vocoder.hop_length = hop
    vocoder.waveglow = wg
    return vocoder
