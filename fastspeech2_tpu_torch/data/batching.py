"""Bucketed batching with deterministic multi-host sharding: the port's own
copy of ``fastspeech2_tpu/data/batching.py`` (numpy only), the same batches in
the same order for the same seed.

- utterances are length-bucketed so each batch pads to one of a small set of
  (T, L) shapes (multiples of 16 tokens and 64 frames): little pad waste, and
  the dropout masks, whose index follows the padded shape, see few shapes;
- the shuffle is a deterministic function of (seed, epoch) and identical on
  every host; each host takes a disjoint stride of the batch stream;
- padding is zeros everywhere, as the reference's ``collate_tts``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple

import numpy as np

from fastspeech2_tpu_torch.data.dataset import TTSDataset, Utterance
from fastspeech2_tpu_torch.models.fastspeech2 import Batch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_batch(utts: Sequence[Utterance], t_pad: int, l_pad: int,
              n_mels: int = 0) -> Batch:
    """Pad a list of utterances to static (T, L) shapes (zero padding).

    n_mels defaults to the utterances' own mel width, so non-80-bin configs
    (audio.num_mels) work without every caller threading the value through.
    """
    B = len(utts)
    if n_mels <= 0:
        n_mels = utts[0].mel.shape[1]
    xs = np.zeros((B, t_pad), np.int32)
    ds = np.zeros((B, t_pad), np.int32)
    ys = np.zeros((B, l_pad, n_mels), np.float32)
    es = np.zeros((B, l_pad), np.float32)
    ps = np.zeros((B, l_pad), np.float32)
    ilens = np.zeros((B,), np.int32)
    olens = np.zeros((B,), np.int32)
    for i, u in enumerate(utts):
        T, L = len(u.tokens), u.mel.shape[0]
        if T > t_pad or L > l_pad:
            raise ValueError(f"utterance {u.utt_id} ({T},{L}) exceeds pad ({t_pad},{l_pad})")
        xs[i, :T] = u.tokens
        ds[i, :T] = u.durations
        ys[i, :L] = u.mel
        es[i, :L] = u.energy
        ps[i, :L] = u.pitch
        ilens[i] = T
        olens[i] = L
    return Batch(xs=xs, ilens=ilens, ys=ys, olens=olens, ds=ds, es=es, ps=ps)


@dataclass
class BucketBatcher:
    """Deterministic length-bucketed batch stream.

    Args:
        dataset: TTSDataset (or anything with __len__/__getitem__/
            token_lengths()/frame_lengths()).
        batch_size: per-host batch size (must divide the local device count
            when used with data parallelism).
        token_multiple/frame_multiple: static-shape quantization -- pad targets
            are the per-batch max rounded up to these multiples.
        max_frames: hard cap on mel length (reference tts_max_mel_len=870,
            configs/default.yaml:137); longer utterances are dropped.
        host_id/num_hosts: disjoint batch striding for multi-host training.
        bin_size_batches: shuffle locality (BinnedLengthSampler's bin_size is
            bin_size_batches * batch_size).
        bin_lengths: config train.tts_bin_lengths. True (default): the
            length-binned order below. False: a plain uniform shuffle --
            batches mix lengths freely, padding to the batch max like the
            reference's default DataLoader path (its BinnedLengthSampler was
            defined but never wired, dataset/dataloader.py:121-150). Costs
            more pad waste and more (t_pad, l_pad) shapes.
    """

    dataset: TTSDataset
    batch_size: int
    token_multiple: int = 16
    frame_multiple: int = 64
    max_frames: int = 870
    seed: int = 1
    host_id: int = 0
    num_hosts: int = 1
    bin_size_batches: int = 8
    drop_remainder: bool = True
    bin_lengths: bool = True

    def _order(self, epoch: int, lengths: np.ndarray) -> np.ndarray:
        """Length-sorted -> binned shuffle -> batch shuffle, seeded by epoch.
        With bin_lengths=False: uniform permutation, no length structure."""
        g = np.random.default_rng((self.seed, epoch))
        if not self.bin_lengths:
            return g.permutation(len(lengths))
        idx = np.argsort(lengths, kind="stable")
        bin_size = self.bin_size_batches * self.batch_size
        bins = [idx[i : i + bin_size] for i in range(0, len(idx), bin_size)]
        for b in bins:
            g.shuffle(b)
        order = np.concatenate(bins) if bins else idx
        return order

    def batches_per_epoch(self) -> int:
        n = len(self.dataset) // self.batch_size
        return n // self.num_hosts

    def epoch(self, epoch: int) -> Iterator[Tuple[Batch, Tuple[int, int]]]:
        """Yield (batch, (t_pad, l_pad)) for this host's share of the epoch.

        Multi-host alignment: every host computes the same permutation,
        overlong utterances are dropped from the GLOBAL order (so all hosts
        yield identical step counts -- no host can hit an empty batch and
        skip), and each step's pad shape is the max over the whole
        ``num_hosts``-batch stride group (so all hosts run the same
        (t_pad, l_pad) shapes in step).
        Lengths come from cached token counts / npy headers -- no feature IO.
        """
        tok_lens = np.asarray(self.dataset.token_lengths())
        frame_lens = np.asarray(self.dataset.frame_lengths())
        order = self._order(epoch, tok_lens)
        order = order[frame_lens[order] <= self.max_frames]
        g = np.random.default_rng((self.seed, epoch, 1))
        starts = np.arange(0, len(order) - self.batch_size + 1, self.batch_size)
        g.shuffle(starts)
        # all hosts compute the same permutation; each takes its stride
        n_usable = (len(starts) // self.num_hosts) * self.num_hosts
        groups = starts[:n_usable].reshape(-1, self.num_hosts)
        for grp in groups:
            s = int(grp[self.host_id])
            utts = [self.dataset[int(i)] for i in order[s : s + self.batch_size]]
            gidx = np.concatenate(
                [order[int(x) : int(x) + self.batch_size] for x in grp])
            t_pad = _round_up(int(tok_lens[gidx].max()), self.token_multiple)
            l_pad = _round_up(int(frame_lens[gidx].max()), self.frame_multiple)
            yield pad_batch(utts, t_pad, l_pad), (t_pad, l_pad)
        if not self.drop_remainder and self.num_hosts == 1:
            # tail utterances beyond the last full batch: yield them as one
            # smaller batch (exact -- no duplicate-weighting)
            tail_idx = order[len(starts) * self.batch_size:]
            if len(tail_idx):
                utts = [self.dataset[int(i)] for i in tail_idx]
                t_pad = _round_up(int(tok_lens[tail_idx].max()),
                                  self.token_multiple)
                l_pad = _round_up(int(frame_lens[tail_idx].max()),
                                  self.frame_multiple)
                yield pad_batch(utts, t_pad, l_pad), (t_pad, l_pad)
