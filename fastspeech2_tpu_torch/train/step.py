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

Under a mesh (``parallel/``) the step keeps the JAX step's global-batch
numbers. The incoming batch is this rank's rows of the global window
(``parallel/mesh.py:window_rows``): ``accum_grad`` contiguous blocks, block
``i`` being the data index's share of global micro-batch ``i``, so the
BatchNorm statistics advance micro-batch by micro-batch as in the JAX step.
Each micro-batch's forward runs inside ``data_shard`` (global dropout index,
BatchNorm statistics and loss denominators over the data group, kernel 12
with the shard's seed); the gradients are summed over the data group once a
window, after accumulation, in flat buckets; the optimizer clips on the
global norm (over the model group too under tensor parallelism), which every
rank then shares, and so its non-finite skip. The report is summed over the
data group: each rank's terms are its parts of the global-batch losses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

import torch

from fastspeech2_tpu_torch.models.fastspeech2 import Batch, FastSpeech2
from fastspeech2_tpu_torch.ops.precision import compute_dtype
from fastspeech2_tpu_torch.parallel.mesh import DataShard, Mesh, all_reduce, data_shard
from fastspeech2_tpu_torch.train.optimizer import NoamAdam

#: elements per all-reduce of the summed gradients (f32: 64 MiB)
BUCKET = 1 << 24


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


def sum_over_group(tensors: List[torch.Tensor], group, bucket: int = BUCKET) -> None:
    """Sum same-dtype tensors over ``group`` in place, a few flat buffers
    (one all-reduce each) of up to ``bucket`` elements."""
    if group is None:
        return
    i = 0
    while i < len(tensors):
        j, n = i, 0
        while j < len(tensors) and (j == i or n + tensors[j].numel() <= bucket):
            n += tensors[j].numel()
            j += 1
        flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors[i:j]]), group)
        for t, part in zip(tensors[i:j], flat.split([t.numel() for t in tensors[i:j]])):
            t.copy_(part.view_as(t))
        i = j


def make_train_step(model: FastSpeech2, optimizer: NoamAdam,
                    accum_grad: int = 1, bf16: bool = False,
                    mesh: Optional[Mesh] = None, sequence_parallel: bool = False):
    """Build the step fn: (TrainState, Batch, seeds) -> (TrainState, report).

    The Batch is the full accumulation window, or under ``mesh`` this rank's
    rows of it (tensors on the model's device); ``seeds`` holds one
    ``{site: seed}`` mapping per micro-batch (``train.seeds.SeedSchedule.draw``,
    the same on every rank). ``sequence_parallel``: Megatron-SP under a
    tensor-parallel model."""
    params = trainable(model)
    dp = mesh.dp if mesh is not None else 1
    group = mesh.data_group if mesh is not None else None

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
        shard = (DataShard(mesh, mesh.data_index * mb, mb * dp, sequence_parallel)
                 if mesh is not None and mesh.size > 1 else None)
        reports = []
        for i in range(accum_grad):
            micro = Batch(*(t[i * mb:(i + 1) * mb] for t in batch))
            with compute_dtype(torch.bfloat16 if bf16 else None), data_shard(shard):
                loss, report = model(micro, seeds=seeds[i], training=True)
            (loss / accum_grad).backward()
            reports.append({k: v.detach() for k, v in report.items()})
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        sum_over_group(grads, group)
        norm = optimizer.step(grads)
        for p in params:
            p.grad = None
        keys = list(reports[0])
        vals = torch.stack([torch.stack([r[k] for r in reports]).mean() for k in keys])
        report: Dict[str, torch.Tensor] = dict(zip(keys, all_reduce(vals, group).unbind(0)))
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
