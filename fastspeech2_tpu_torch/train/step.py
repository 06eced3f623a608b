"""The training step: gradient accumulation, clipping, non-finite skip
(``fastspeech2_tpu/train/step.py``).

The whole accumulation window is one call: the incoming batch is cut into
``accum_grad`` micro-batches, each runs forward + loss / accum_grad + backward
(gradients accumulate in ``.grad``; the postnet's BatchNorm running statistics
thread through the micro-batches in order), then clip -> Noam-Adam -> apply.
The report is the mean over the micro-batches plus the optimizer's gradient
norm, all device scalars: the step reads nothing back to the host.

bf16 (``cfg.train.bf16``): matmul/conv operands in bf16 with f32 accumulation
for forward and backward, while the master parameters, the optimizer state,
the losses, LayerNorms and softmax stay f32 (``ops/nn.py``); it also engages
the training attention kernels (``ops/kernels/attention_train.py``) and the
hash-mask dropout.

Data and tensor parallelism are not ported: the step runs on one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Sequence

import torch

from fastspeech2_tpu_torch.models.fastspeech2 import Batch, FastSpeech2
from fastspeech2_tpu_torch.ops.precision import compute_dtype
from fastspeech2_tpu_torch.train.optimizer import NoamAdam


@dataclass
class TrainState:
    """What a step reads and updates in place: the model (parameters and
    BatchNorm running statistics), the optimizer state and the step count
    (a host integer)."""

    model: FastSpeech2
    optimizer: NoamAdam
    step: int = 0


def trainable(model: FastSpeech2):
    """The model's parameters in ``named_parameters`` order: the order of the
    optimizer's moments."""
    return [p for _, p in model.named_parameters()]


def make_train_step(model: FastSpeech2, optimizer: NoamAdam,
                    accum_grad: int = 1, bf16: bool = False):
    """Build the step fn: (TrainState, Batch, seeds) -> (TrainState, report).

    The Batch is the full accumulation window (tensors on the model's
    device); ``seeds`` holds one ``{site: seed}`` mapping per micro-batch
    (``train.seeds.SeedSchedule.draw``)."""
    params = trainable(model)

    def train_step(ts: TrainState, batch: Batch,
                   seeds: Sequence[Mapping[str, int]]):
        if len(seeds) != accum_grad:
            raise ValueError(f"{accum_grad} micro-batches need {accum_grad} "
                             f"seed mappings, got {len(seeds)}")
        n = batch.xs.shape[0]
        if n % accum_grad:
            raise ValueError(f"batch of {n} does not divide into {accum_grad} "
                             "micro-batches")
        mb = n // accum_grad
        reports = []
        for i in range(accum_grad):
            micro = Batch(*(t[i * mb:(i + 1) * mb] for t in batch))
            with compute_dtype(torch.bfloat16 if bf16 else None):
                loss, report = model(micro, seeds=seeds[i], training=True)
            (loss / accum_grad).backward()
            reports.append({k: v.detach() for k, v in report.items()})
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        norm = optimizer.step(grads)
        for p in params:
            p.grad = None
        report: Dict[str, torch.Tensor] = {
            k: torch.stack([r[k] for r in reports]).mean() for k in reports[0]}
        report["grad_norm"] = norm
        ts.step += 1
        return ts, report

    return train_step


def make_eval_step(model: FastSpeech2):
    """Teacher-forced validation step (no dropout, BatchNorm running
    statistics, f32 as in the JAX package): (TrainState, Batch) -> report."""

    @torch.no_grad()
    def eval_step(ts: TrainState, batch: Batch):
        _, report = model(batch, training=False)
        return report

    return eval_step
