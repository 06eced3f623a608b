"""FastSpeech2 text->mel model (``fastspeech2_tpu/models/fastspeech2.py``:
``forward``/``_loss`` for training, ``encode``, ``decode_frames``,
``inference`` for serving).

The training ``forward`` is teacher-forced: ground-truth durations drive the
length regulator and ground-truth frame-level pitch/energy are quantized,
one-hot encoded and added through the linear embeddings; pitch and energy are
predicted at frame level after the length regulation. It keeps the
reference's batched padding semantics (no conv mask: pad rows leak into conv
windows). Losses: L1(before) + L1(after) + MSE(log-duration) + MSE(energy) +
MSE(pitch), masked means over valid positions. Under bf16 with
``fused_attention`` on, every FFT block trains through the training attention
kernels (``ops/kernels/attention_train.py``); the serving kernels take no
gradient and are not reached.

Inference predicts durations (exp/round/clamp), expands the token states by
them, predicts pitch and energy, embeds them, decodes and refines with the
postnet. Every conv input is re-zeroed beyond the true length, so a padded
buffer gives the unpadded result (exact-unpadded semantics).

Under the bf16 tier (``ops.precision.compute_dtype(torch.bfloat16)``) and
``fused_attention`` on, the kernels of ``ops/kernels`` carry the path with
the JAX engagement rules: attention and FFN halves of every block (post-LN,
pre-LN, ``concat_after`` and the ``FUSED_ATT_*`` switches each take their
own kernel, ``models/encoder.py``), the variance adaptor (``FUSED_ADAPTOR``)
and the postnet.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn as tnn

from fastspeech2_tpu_torch.config import Config
from fastspeech2_tpu_torch.device import resolve_device
from fastspeech2_tpu_torch.models.encoder import Encoder, EncoderConfig
from fastspeech2_tpu_torch.models.init import (apply_transformer_init,
                                                reset_parameters)
from fastspeech2_tpu_torch.models.postnet import Postnet, PostnetConfig
from fastspeech2_tpu_torch.models.predictors import Predictor, PredictorConfig
from fastspeech2_tpu_torch.ops import attention_mask, flags, make_non_pad_mask, nn
from fastspeech2_tpu_torch.ops.kernels import adaptor as adaptor_kernel
from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.ops.length_regulator import (expansion_indices,
                                                         regulate_length,
                                                         scale_durations)
from fastspeech2_tpu_torch.ops.precision import compute_dtype, current_compute_dtype
from fastspeech2_tpu_torch.ops.quantize import linear_bins, log_bins, to_one_hot
from fastspeech2_tpu_torch.parallel.mesh import current_shard, data_total
from fastspeech2_tpu_torch.text.symbols import NUM_PHONEMES


class Batch(NamedTuple):
    """A padded training batch (static shapes); numpy arrays from the data
    pipeline, tensors on the model's device at ``forward``."""

    xs: torch.Tensor      # (B, T) int32 token ids
    ilens: torch.Tensor   # (B,) int32
    ys: torch.Tensor      # (B, L, odim) float mel targets
    olens: torch.Tensor   # (B,) int32
    ds: torch.Tensor      # (B, T) int32 durations
    es: torch.Tensor      # (B, L) float energy targets
    ps: torch.Tensor      # (B, L) float pitch targets


def _sub(seeds: Optional[Mapping[str, int]], prefix: str) -> Optional[Dict[str, int]]:
    if seeds is None:
        return None
    n = len(prefix) + 1
    return {k[n:]: v for k, v in seeds.items() if k.startswith(prefix + "/")}


class FastSpeech2(tnn.Module):
    """Module names follow the JAX params tree, so ``compat.from_jax`` maps
    one onto the other leaf by leaf. ``generator`` (a CPU ``torch.Generator``)
    makes the initial weights a function of its seed alone; without one the
    modules keep the draws of torch's global generator."""

    def __init__(self, cfg: Optional[Config] = None, idim: int = NUM_PHONEMES,
                 device: Union[str, torch.device, None] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg = cfg if cfg is not None else Config()
        self.idim = idim
        device = resolve_device(device)
        m = cfg.model
        self.encoder = Encoder(self.encoder_cfg, m.initial_encoder_alpha, device=device)
        self.duration_predictor = Predictor(self.duration_cfg, device=device)
        self.energy_predictor = Predictor(self.variance_cfg, device=device)
        self.pitch_predictor = Predictor(self.variance_cfg, device=device)
        self.energy_embed = tnn.Linear(m.variance_n_bins, m.adim, device=device)
        self.pitch_embed = tnn.Linear(m.variance_n_bins, m.adim, device=device)
        self.decoder = Encoder(self.decoder_cfg, m.initial_decoder_alpha, device=device)
        self.feat_out = tnn.Linear(m.ddim, self.odim * m.reduction_factor, device=device)
        self.postnet = (Postnet(self.postnet_cfg, device=device)
                        if self.postnet_cfg is not None else None)
        d = cfg.data
        self.register_buffer("energy_bins", torch.from_numpy(
            linear_bins(d.e_min, d.e_max, m.variance_n_bins)).to(device),
            persistent=False)
        self.register_buffer("pitch_bins", torch.from_numpy(
            log_bins(d.p_min, d.p_max, m.variance_n_bins)).to(device),
            persistent=False)
        if generator is not None:
            reset_parameters(self, generator)
        # xavier/kaiming variants + the reference's Embedding/LayerNorm reset
        # and BatchNorm-zero quirk; the scaled-PE alphas stay as set above
        apply_transformer_init(self, m.transformer_init, generator)
        self.eval()

    # -- derived sub-configs -------------------------------------------------

    @property
    def odim(self) -> int:
        return self.cfg.audio.num_mels

    @property
    def encoder_cfg(self) -> EncoderConfig:
        m = self.cfg.model
        return EncoderConfig(
            idim=self.idim, attention_dim=m.adim, attention_heads=m.aheads,
            linear_units=m.eunits, num_blocks=m.elayers,
            dropout_rate=m.transformer_dropout_rate,
            positional_dropout_rate=m.transformer_dropout_rate,
            attention_dropout_rate=m.transformer_dropout_rate,
            input_layer="embed",
            use_scaled_pos_enc=m.use_scaled_pos_enc,
            normalize_before=m.encoder_normalize_before,
            concat_after=m.encoder_concat_after,
            positionwise_layer_type=m.positionwise_layer_type,
            positionwise_conv_kernel_size=m.positionwise_conv_kernel_size,
            max_pos_len=m.max_pos_len)

    @property
    def decoder_cfg(self) -> EncoderConfig:
        m = self.cfg.model
        return EncoderConfig(
            idim=m.adim, attention_dim=m.ddim, attention_heads=m.aheads,
            linear_units=m.dunits, num_blocks=m.dlayers,
            dropout_rate=m.transformer_dropout_rate,
            positional_dropout_rate=m.transformer_dropout_rate,
            attention_dropout_rate=m.transformer_dropout_rate,
            input_layer="linear",
            use_scaled_pos_enc=m.use_scaled_pos_enc,
            normalize_before=m.decoder_normalize_before,
            concat_after=m.decoder_concat_after,
            positionwise_layer_type=m.positionwise_layer_type,
            positionwise_conv_kernel_size=m.positionwise_conv_kernel_size,
            max_pos_len=m.max_pos_len)

    @property
    def duration_cfg(self) -> PredictorConfig:
        m = self.cfg.model
        return PredictorConfig(idim=m.adim, n_layers=m.duration_predictor_layers,
                               n_chans=m.duration_predictor_chans,
                               kernel_size=m.duration_predictor_kernel_size,
                               dropout_rate=m.duration_predictor_dropout_rate)

    @property
    def variance_cfg(self) -> PredictorConfig:
        # the reference's Energy/PitchPredictor keep VariancePredictor's
        # defaults (2 layers, 256 chans, k=3), as the JAX package does
        return PredictorConfig(
            idim=self.cfg.model.adim,
            dropout_rate=self.cfg.model.variance_predictor_dropout_rate)

    @property
    def postnet_cfg(self) -> Optional[PostnetConfig]:
        m = self.cfg.model
        if m.postnet_layers == 0:
            return None
        return PostnetConfig(odim=self.odim, n_layers=m.postnet_layers,
                             n_chans=m.postnet_chans, n_filts=m.postnet_filts,
                             dropout_rate=m.postnet_dropout_rate,
                             use_batch_norm=m.use_batch_norm)

    @property
    def device(self) -> torch.device:
        return self.feat_out.weight.device

    @property
    def tp(self) -> int:
        """Tensor-parallel degree of the FFT stacks (``parallel/sharding.py:
        shard_model``); the adaptor and postnet kernels stay off under TP, as
        in the JAX package."""
        mesh = self.encoder.mesh
        return 1 if mesh is None else mesh.tp

    def _use_fused_attention(self) -> bool:
        fa = self.cfg.model.fused_attention
        if fa == "on":
            return True
        if fa == "off":
            return False
        return self.device.type == "cuda"

    # -- training forward ----------------------------------------------------

    def dropout_sites(self) -> List[str]:
        """Every dropout site of the training forward, in the JAX package's
        key order: the six top-level names of ``forward`` (encoder, decoder,
        postnet, dur, en, pi), each followed by its own sites."""
        sites = [f"encoder/{s}" for s in self.encoder.dropout_sites()]
        sites += [f"decoder/{s}" for s in self.decoder.dropout_sites()]
        if self.postnet is not None:
            sites += [f"postnet/{i}" for i in range(self.postnet_cfg.n_layers)]
        sites += [f"dur/{i}" for i in range(self.duration_cfg.n_layers)]
        sites += [f"{n}/{i}" for n in ("en", "pi")
                  for i in range(self.variance_cfg.n_layers)]
        return sites

    def forward(self, batch: Batch, *,
                seeds: Optional[Mapping[str, int]] = None,
                training: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Teacher-forced forward; returns (loss, report). ``training``
        needs ``seeds``, one uint32 per name of ``dropout_sites``, and updates
        the postnet's BatchNorm running statistics in place."""
        if training and seeds is None:
            raise ValueError("training forward needs the dropout seeds")
        T, L = batch.xs.shape[1], batch.ys.shape[1]
        fused = self._use_fused_attention()
        remat = training and self.cfg.train.remat
        tok_mask = make_non_pad_mask(batch.ilens, T)
        mel_mask = make_non_pad_mask(batch.olens, L)

        hs = self.encoder(batch.xs, attention_mask(batch.ilens, T),
                          lengths=batch.ilens, fused_attention=fused,
                          seeds=_sub(seeds, "encoder"), deterministic=not training,
                          remat=remat)

        # ground-truth quantized pitch/energy: table lookups, no gradient
        nb = self.cfg.model.variance_n_bins
        one_hot_energy = to_one_hot(batch.es, self.energy_bins, nb)
        one_hot_pitch = to_one_hot(batch.ps, self.pitch_bins, nb)

        kw = dict(deterministic=not training)
        d_outs = self.duration_predictor.masked(hs, tok_mask, seeds=_sub(seeds, "dur"), **kw)
        hs_e, _, _ = regulate_length(hs, batch.ds, tok_mask, L)
        e_outs = self.energy_predictor.masked(hs_e, mel_mask, seeds=_sub(seeds, "en"), **kw)
        p_outs = self.pitch_predictor.masked(hs_e, mel_mask, seeds=_sub(seeds, "pi"), **kw)

        # the reference's addition order: pitch, then energy
        hs2 = hs_e + nn.linear(one_hot_pitch, self.pitch_embed.weight,
                               self.pitch_embed.bias)
        hs2 = hs2 + nn.linear(one_hot_energy, self.energy_embed.weight,
                              self.energy_embed.bias)

        zs = self.decoder(hs2, attention_mask(batch.olens, L), lengths=batch.olens,
                          fused_attention=fused, seeds=_sub(seeds, "decoder"),
                          deterministic=not training, remat=remat)
        before = nn.linear(zs, self.feat_out.weight, self.feat_out.bias)
        before = before.reshape(before.shape[0], -1, self.odim)
        if self.postnet is None:
            after = before
        else:
            after = before + self.postnet(before, seeds=_sub(seeds, "postnet"),
                                          training=training)
        return self._loss(before, after, d_outs, e_outs, p_outs, batch,
                          tok_mask, mel_mask)

    def _loss(self, before, after, d_outs, e_outs, p_outs, batch: Batch,
              tok_mask, mel_mask) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Masked losses. ``use_weighted_masking`` weights the element-wise
        L1/MSE maps before the reduction, so every sequence counts equally in
        the l1 and duration losses whatever its length (energy and pitch keep
        the plain masked mean); ``use_masking`` takes means over the valid
        positions; neither takes plain means over the padded batch.

        Inside a data shard (``parallel/mesh.py:data_shard``) the batch is a
        block of rows of the global micro-batch: every denominator (the
        valid-position counts, the weighted form's B, the full-tensor
        sizes) is the global one, so each term is this rank's part of the
        global-batch loss and the data group's sum of the terms, and of
        their gradients, is the single-device value."""
        m = self.cfg.model
        mel_m3 = mel_mask[..., None].float()
        tok_m = tok_mask.float()
        log_d = torch.log(batch.ds.float() + 1.0)
        sh = current_shard()
        rows = before.shape[0] if sh is None else sh.rows

        def mean(t):  # the mean over the global tensor
            return t.mean() if sh is None else t.sum() / (t.numel() // t.shape[0] * rows)

        if m.use_weighted_masking:
            B = rows
            frames = mel_m3.sum(dim=1, keepdim=True).clamp_min(1.0)
            out_w = mel_m3 / frames / (B * self.odim)
            before_loss = ((before - batch.ys).abs() * out_w).sum()
            after_loss = ((after - batch.ys).abs() * out_w).sum()
            toks = tok_m.sum(dim=1, keepdim=True).clamp_min(1.0)
            duration_loss = ((d_outs - log_d).square() * (tok_m / toks / B)).sum()
        elif m.use_masking:
            n_mel, n_tok = data_total([mel_m3.sum(), tok_m.sum()])
            n_mel = n_mel.clamp_min(1.0) * self.odim
            before_loss = ((before - batch.ys).abs() * mel_m3).sum() / n_mel
            after_loss = ((after - batch.ys).abs() * mel_m3).sum() / n_mel
            duration_loss = (((d_outs - log_d).square() * tok_m).sum()
                             / n_tok.clamp_min(1.0))
        else:
            before_loss = mean((before - batch.ys).abs())
            after_loss = mean((after - batch.ys).abs())
            duration_loss = mean((d_outs - log_d).square())
        l1_loss = before_loss + after_loss

        if m.use_masking or m.use_weighted_masking:
            mel_m = mel_mask.float()
            n_frames = data_total([mel_m.sum()])[0].clamp_min(1.0)
            energy_loss = ((e_outs - batch.es).square() * mel_m).sum() / n_frames
            pitch_loss = ((p_outs - batch.ps).square() * mel_m).sum() / n_frames
        else:
            energy_loss = mean((e_outs - batch.es).square())
            pitch_loss = mean((p_outs - batch.ps).square())

        loss = l1_loss + duration_loss + energy_loss + pitch_loss
        return loss, {
            "l1_loss": l1_loss, "before_loss": before_loss, "after_loss": after_loss,
            "duration_loss": duration_loss, "energy_loss": energy_loss,
            "pitch_loss": pitch_loss, "loss": loss}

    # -- inference -----------------------------------------------------------

    def _decode(self, hs: torch.Tensor, h_mask: torch.Tensor,
                conv_mask: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Decoder + feat_out + postnet -> after (B, L, odim)."""
        fused = self._use_fused_attention()
        zs = self.decoder(hs, h_mask, conv_mask=conv_mask, lengths=lengths,
                          fused_attention=fused)
        before = nn.linear(zs, self.feat_out.weight, self.feat_out.bias)
        before = before.reshape(before.shape[0], -1, self.odim)
        if self.postnet is None:
            return before
        cd = current_compute_dtype()
        if (fused and cd == torch.bfloat16 and self.postnet_cfg.use_batch_norm
                and self.postnet_cfg.n_filts % 2 == 1 and self.tp == 1):
            resid = self.postnet.fused(before, lengths, cd)
        else:
            resid = self.postnet(before, conv_mask)
        return before + resid

    @torch.inference_mode()
    def encode(self, xs: torch.Tensor, ilens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encoder + duration head: (hs (B, T, adim), d_outs (B, T) int32)."""
        T = xs.shape[1]
        tok_mask = make_non_pad_mask(ilens, T)
        hs = self.encoder(xs, attention_mask(ilens, T), conv_mask=tok_mask,
                          lengths=ilens, fused_attention=self._use_fused_attention())
        if flags.F32_DURATION and current_compute_dtype() == torch.bfloat16:
            # the head's exp/round/clamp is a rounding knife-edge: run the
            # tiny head in f32 (TF32 is off on the card, device.py)
            with compute_dtype(None):
                d_outs = self.duration_predictor.durations(
                    hs.float(), tok_mask, conv_mask=tok_mask)
        else:
            d_outs = self.duration_predictor.durations(hs, tok_mask,
                                                       conv_mask=tok_mask)
        return hs, d_outs

    def _adaptor_pack(self, cd):
        srcs = [*self.pitch_predictor.parameters(), *self.energy_predictor.parameters(),
                *self.pitch_embed.parameters(), *self.energy_embed.parameters()]
        return common.cached_pack(
            self.pitch_predictor, srcs, lambda: adaptor_kernel.pack_weights(
                self.pitch_predictor, self.energy_predictor, self.pitch_embed,
                self.energy_embed, self.pitch_bins, self.energy_bins, cd))

    @torch.inference_mode()
    def decode_frames(self, hs: torch.Tensor, d_outs: torch.Tensor,
                      ilens: torch.Tensor, *, out_maxlen: int,
                      alpha: Union[float, torch.Tensor] = 1.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Length-regulate by the predicted durations, then variance adaptor,
        decoder and postnet: (mel (B, out_maxlen, odim) zeroed past each
        row's length, out_lens (B,) int32)."""
        T = hs.shape[1]
        tok_mask = make_non_pad_mask(ilens, T)
        d_scaled = scale_durations(d_outs, alpha)
        vcfg = self.variance_cfg
        cd = current_compute_dtype()
        if (self._use_fused_attention() and cd == torch.bfloat16
                and vcfg.n_layers == 2 and vcfg.kernel_size == 3
                and vcfg.idim == hs.shape[-1] and flags.FUSED_ADAPTOR and self.tp == 1):
            idx, frame_mask, out_lens = expansion_indices(d_scaled, tok_mask,
                                                          out_maxlen, T)
            hs2, _ = adaptor_kernel.variance_adaptor(
                hs.float().contiguous(), idx, out_lens, *self._adaptor_pack(cd))
        else:
            hs_e, frame_mask, out_lens = regulate_length(hs, d_scaled, tok_mask,
                                                         out_maxlen)
            e_raw = self.energy_predictor(hs_e, conv_mask=frame_mask)
            p_raw = self.pitch_predictor(hs_e, conv_mask=frame_mask)
            nb = self.cfg.model.variance_n_bins
            hs2 = hs_e + nn.linear(to_one_hot(p_raw, self.pitch_bins, nb),
                                   self.pitch_embed.weight, self.pitch_embed.bias)
            hs2 = hs2 + nn.linear(to_one_hot(e_raw, self.energy_bins, nb),
                                  self.energy_embed.weight, self.energy_embed.bias)
            hs2 = torch.where(frame_mask[..., None], hs2, torch.zeros_like(hs2))
        after = self._decode(hs2, attention_mask(out_lens, out_maxlen), frame_mask,
                             out_lens)
        return torch.where(frame_mask[..., None], after, torch.zeros_like(after)), out_lens

    @torch.inference_mode()
    def inference(self, xs: torch.Tensor, ilens: torch.Tensor, *,
                  out_maxlen: int, alpha: Union[float, torch.Tensor] = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Free-running synthesis: (mel (B, out_maxlen, odim), out_lens (B,),
        durations (B, T) int32) == decode_frames(*encode())."""
        hs, d_outs = self.encode(xs, ilens)
        mel, out_lens = self.decode_frames(hs, d_outs, ilens, out_maxlen=out_maxlen,
                                           alpha=alpha)
        return mel, out_lens, d_outs
