"""Ground-truth-aligned (GTA) mels for vocoder finetuning
(``fastspeech2_tpu/train/gta.py``).

A teacher-forced forward: the encoder, the ground-truth durations, pitch and
energy embeddings, the decoder, ``feat_out`` and the postnet in eval mode,
dumping the post-postnet mel of each utterance. It takes the JAX function's
routes: the stacks get no ``lengths``, so no kernel runs, in f32.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from fastspeech2_tpu_torch.data.batching import pad_batch
from fastspeech2_tpu_torch.data.dataset import TTSDataset
from fastspeech2_tpu_torch.data.prefetch import batch_to_device
from fastspeech2_tpu_torch.models.fastspeech2 import Batch, FastSpeech2
from fastspeech2_tpu_torch.ops import attention_mask, make_non_pad_mask, nn
from fastspeech2_tpu_torch.ops.length_regulator import regulate_length
from fastspeech2_tpu_torch.ops.quantize import to_one_hot

log = logging.getLogger("fastspeech2_tpu_torch.gta")


def gta_forward(model: FastSpeech2, b: Batch) -> torch.Tensor:
    """Padded batch on the model's device -> post-postnet mel (B, L, odim)."""
    T, L = b.xs.shape[1], b.ys.shape[1]
    tok_mask = make_non_pad_mask(b.ilens, T)
    hs = model.encoder(b.xs, attention_mask(b.ilens, T))
    hs_e, _, _ = regulate_length(hs, b.ds, tok_mask, L)
    nb = model.cfg.model.variance_n_bins
    hs2 = hs_e + nn.linear(to_one_hot(b.ps, model.pitch_bins, nb),
                           model.pitch_embed.weight, model.pitch_embed.bias)
    hs2 = hs2 + nn.linear(to_one_hot(b.es, model.energy_bins, nb),
                          model.energy_embed.weight, model.energy_embed.bias)
    zs = model.decoder(hs2, attention_mask(b.olens, L))
    before = nn.linear(zs, model.feat_out.weight, model.feat_out.bias)
    before = before.reshape(before.shape[0], -1, model.odim)
    if model.postnet is None:
        return before
    return before + model.postnet(before)


@torch.inference_mode()
def generate_gta(model: FastSpeech2, dataset: TTSDataset, outdir: str,
                 batch_size: int = 8) -> int:
    """Dump GTA mels as (n_mels, L) f32 .npy per utterance; returns the count
    written. One static (T, L) for the whole set, as the JAX function."""
    os.makedirs(outdir, exist_ok=True)
    utts = [dataset[i] for i in range(len(dataset))]
    T = max(len(u.tokens) for u in utts)
    L = max(u.mel.shape[0] for u in utts)
    n = 0
    for i in range(0, len(utts), batch_size):
        chunk = utts[i: i + batch_size]
        mels = gta_forward(model, batch_to_device(pad_batch(chunk, T, L), model.device))
        mels = mels.cpu().numpy()
        for j, u in enumerate(chunk):
            np.save(os.path.join(outdir, f"{u.utt_id}.npy"),
                    mels[j, : u.mel.shape[0]].T.astype(np.float32))
            n += 1
    log.info("wrote %d GTA mels to %s", n, outdir)
    return n
