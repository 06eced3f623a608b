"""Deploy-artifact export (``fastspeech2_tpu/infer/export.py``): the
inference function with its weights baked in, traced by ``torch.export`` for
a fixed (batch, max_tokens, max_frames) signature and saved with
``torch.export.save``, to be reloaded and called without the model-building
code.

The serving kernels are ``torch.library`` custom ops
(``ops/kernels/library.py``), so the traced graph calls them: an artifact
exported on the card launches the kernels, one exported on the CPU runs
their plain versions. Their kernel-layout weight packs are built by one
eager call before the trace and frozen into the model
(``ops/kernels/common.py:freeze_packs``), so the graph holds them. The
artifact runs on the device it was exported on.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

import torch

from fastspeech2_tpu_torch.device import matmul_precision as precision_ctx
from fastspeech2_tpu_torch.device import resolve_device
from fastspeech2_tpu_torch.ops.precision import compute_dtype

log = logging.getLogger("fastspeech2_tpu_torch.export")

#: the artifact's own settings, saved beside the graph
META = "fs2_meta.json"


class _Inference(torch.nn.Module):
    """tokens (B, T) int32, lengths (B,) int32, per-row speed (B,) f32 ->
    (mel (B, max_frames, n_mels), out_lens) or, with a vocoder, (mel, wav
    int16 PCM, out_lens), as ``Synthesizer``'s fused wav path computes it."""

    def __init__(self, model, max_frames: int, bf16: bool, vocoder=None):
        super().__init__()
        self.model = model
        self.vocoder = vocoder
        self.max_frames = max_frames
        self.bf16 = bf16

    def forward(self, xs, ilens, alphas):
        from fastspeech2_tpu_torch.infer.synthesize import mel_floor_mask, pcm16

        with compute_dtype(torch.bfloat16 if self.bf16 else None):
            mel, out_lens, _ = self.model.inference(xs, ilens, out_maxlen=self.max_frames,
                                                    alpha=alphas)
            if self.vocoder is None:
                return mel, out_lens
            # silence past each row's length, int16 PCM on the device
            wav = self.vocoder(mel_floor_mask(mel, out_lens))
            return mel, pcm16(wav), out_lens


def export_inference(checkpoint_path: Optional[str], out_path: str,
                     config_path: Optional[str] = None, batch: int = 1,
                     max_tokens: int = 192, max_frames: int = 1024,
                     bf16: bool = False, matmul_precision: str = "default",
                     int8: bool = False, vocoder_path: Optional[str] = None,
                     device=None) -> str:
    """Trace the inference function (weights baked in) and save it to
    ``out_path``; returns the path.

    Loads a ``.npz`` checkpoint of either package or a reference
    ``.pth``/``.pyt``/``.pt``; with no checkpoint it exports the seed-0 init
    of ``config_path``'s config (a shape contract). The settings are baked
    in with ``Synthesizer``'s meanings: ``bf16`` the bf16 tier (the kernels
    on the card), ``matmul_precision`` "default" lets f32 products use TF32
    when the artifact is called on the card, "highest" keeps them full f32
    (the parity tier), ``int8`` the W8A8 tier (``ops/quant8.py``).

    ``vocoder_path``: a MelGAN checkpoint to bake in; the artifact then
    computes tokens -> (mel, int16 wav, out_lens) in one graph. WaveGlow
    draws noise on every call and is not baked in: vocode with it after the
    artifact. ``device``: where the artifact is traced and runs (None: the
    card)."""
    from fastspeech2_tpu_torch.ops.kernels.common import freeze_packs
    from fastspeech2_tpu_torch.ops.quant8 import quantize_model
    from fastspeech2_tpu_torch.train.checkpoint import load_model

    dev = resolve_device(device)
    cfg, model = load_model(checkpoint_path, config_path, dev)
    if int8:
        model = quantize_model(model)
    vocoder = None
    if vocoder_path:
        from fastspeech2_tpu_torch.vocoder import (detect_vocoder_kind, load_melgan_params,
                                                   melgan_config_from_checkpoint)

        kind = detect_vocoder_kind(vocoder_path)
        if kind != "melgan":
            raise ValueError(
                f"only MelGAN can be baked into the artifact (got {kind}: WaveGlow "
                "samples noise per call); vocode with it after the artifact instead")
        vocoder = load_melgan_params(vocoder_path, melgan_config_from_checkpoint(vocoder_path),
                                     bf16=bf16, device=dev)
    fn = _Inference(model.eval(), max_frames, bf16, vocoder).eval()
    args = (torch.ones((batch, max_tokens), dtype=torch.int32, device=dev),
            torch.full((batch,), max_tokens, dtype=torch.int32, device=dev),
            torch.ones((batch,), dtype=torch.float32, device=dev))
    with precision_ctx(matmul_precision, dev), torch.inference_mode():
        fn(*args)  # builds every kernel-layout pack at the traced shapes
    freeze_packs(fn)
    # traced without gradients: a grad-mode switch inside (a pack built in
    # the graph under no_grad) would otherwise be captured as an op that
    # the saved program does not load
    with precision_ctx(matmul_precision, dev), torch.no_grad():
        program = torch.export.export(fn, args, strict=False)
    meta = {"batch": batch, "max_tokens": max_tokens, "max_frames": max_frames,
            "bf16": bf16, "matmul_precision": matmul_precision, "int8": int8,
            "vocoder": vocoder is not None, "device": str(dev),
            "outputs": ["mel", "wav", "out_lens"] if vocoder is not None
            else ["mel", "out_lens"]}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(program, out_path, extra_files={META: json.dumps(meta)})
    log.info("exported %d-byte artifact to %s (B=%d, T<=%d, L<=%d, %s)",
             os.path.getsize(out_path), out_path, batch, max_tokens, max_frames, dev)
    return out_path


def load_exported(path: str):
    """Reload an exported artifact; returns a callable ``(xs, ilens,
    alphas=None)`` -> (mel, out_lens), or (mel, wav int16, out_lens) for an
    artifact with a baked vocoder, as tensors on the artifact's device.
    ``alphas`` defaults to 1.0 (normal speed) per row. Inputs may be numpy
    arrays or tensors of the exported shapes."""
    from fastspeech2_tpu_torch.ops.kernels import library  # noqa: F401  (the fs2:: ops)

    extra = {META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[META])
    dev = resolve_device(meta["device"])
    module = program.module()

    def call(xs, ilens, alphas=None):
        xs = torch.as_tensor(xs, dtype=torch.int32).to(dev)
        ilens = torch.as_tensor(ilens, dtype=torch.int32).to(dev)
        alphas = (torch.ones((xs.shape[0],), dtype=torch.float32, device=dev)
                  if alphas is None else
                  torch.as_tensor(alphas, dtype=torch.float32).to(dev))
        with precision_ctx(meta["matmul_precision"], dev), torch.inference_mode():
            return module(xs, ilens, alphas)

    call.meta = meta
    return call
