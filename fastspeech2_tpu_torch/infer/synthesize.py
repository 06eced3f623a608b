"""Serving entry point, mel and wav paths
(``fastspeech2_tpu/infer/synthesize.py``).

A batch of phoneme-id sequences is padded (tokens to a multiple of 32, the
batch to a power of two with length-1 rows), encoded, and the exact frame
demand is read to the host. The decode then runs on the smallest 256-frame
rung that covers the demand, split 2 ways at the demand median when that
shrinks the short half's rung. Both groups' decodes are enqueued before any
result is read back: the host does not wait between them.

With ``demand_sized=False`` (``FS2_DEMAND_SIZED=off``) one call runs on the
frames-per-token heuristic buffer and re-runs on a doubled buffer while a
row's demand exceeds it. Rows whose demand exceeds ``max_frames`` are truncated and
flagged either way.

With a MelGAN generator attached (``attach_vocoder``) the wav methods run the
vocoder and the int16 PCM conversion on the device right after each group's
decode, assemble mel and wav there, and cross to the host once. A host-level
vocoder callable (``attach_vocoder_fn``) runs on the finished mels instead.
With neither, ``vocode`` turns a finished mel into audio by Griffin-Lim
(``audio/griffin_lim.py``) on the given device.

``int8=True`` serves a W8A8-quantized copy of the model (``ops/quant8.py``);
``matmul_precision="default"`` lets the calls' f32 products use TF32
(``device.py``), ``"highest"`` (the default) keeps them full f32.

``mesh`` (``parallel/mesh.py``) serves data-parallel, as the JAX package's
sharded ``Synthesizer``: the batch is padded to a multiple of the mesh's
data shards, and the outputs come back in order. This is the port's one
sharded inference path. A process mesh runs one sharded call, each rank
calling with the same batch, as the JAX package's sharded programs do: each
rank encodes its contiguous row shard, the demand (with the encoder states)
is all-gathered over the data group, the decode groups and their rungs come
from the whole batch's demand, each rank decodes its contiguous share of
every group's rows, and each group's outputs are all-gathered. Every
activation quantization of the int8 tier takes the max over the data group
(``ops/quant8.py:dynamic_quantize`` inside ``data_shard``), so an int8 row's
scale sees its whole group, not its shard. A process mesh with a model axis
(``tp > 1``) serves a model that ``parallel.sharding.shard_model`` cut over
it (the counterpart of the JAX package's ``shard_inference_fn_tp``): the
ranks of a model group compute their data shard together, the fused
attention per head shard. Behind ``serve``, rank 0 leads (``lead``: it sends
each call's batch to every other rank) and the others ``follow``. A local
mesh keeps one replica per device of its list (entries may repeat) and runs
the row shards one after another, each the demand-sized dispatch on its own
replica, the outputs padded to the longest shard's frames. Its replicas
cannot share an activation scale, so it refuses the int8 tier.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import logging
import threading
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fastspeech2_tpu_torch.device import matmul_precision, resolve_device
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_tpu_torch.ops import flags, make_non_pad_mask
from fastspeech2_tpu_torch.ops.length_regulator import frame_demand, scale_durations
from fastspeech2_tpu_torch.ops.precision import compute_dtype
from fastspeech2_tpu_torch.ops.quant8 import quantize_model
from fastspeech2_tpu_torch.parallel.mesh import (DataShard, all_gather, current_shard,
                                                 data_shard)
from fastspeech2_tpu_torch.text import phonemes_to_sequence
from fastspeech2_tpu_torch.text.g2p import preprocess_text, process_paragraph
from fastspeech2_tpu_torch.vocoder.melgan import MEL_FLOOR

log = logging.getLogger("fastspeech2_tpu_torch.synth")


def mel_floor_mask(mel: torch.Tensor, out_lens: torch.Tensor) -> torch.Tensor:
    """Frames at/past each row's length -> the log-mel floor, so a padded
    buffer vocodes to silence beyond the utterance."""
    valid = (torch.arange(mel.shape[1], device=mel.device)[None, :, None]
             < out_lens[:, None, None])
    return torch.where(valid, mel, torch.full_like(mel, MEL_FLOOR))


def pcm16(wav):
    """float waveform -> int16 PCM, round half to even; a torch tensor or a
    numpy array, converted where it lies."""
    if isinstance(wav, torch.Tensor):
        return torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
    return np.round(np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Synthesizer:
    """Holds the model (and an attached vocoder) on its device and serves
    mel and wav batches."""

    def __init__(self, model: FastSpeech2, token_multiple: int = 32,
                 frames_per_token: int = 12, max_frames: int = 2048,
                 bf16: bool = False, demand_sized: Optional[bool] = None,
                 device: Union[str, torch.device, None] = None,
                 matmul_precision: str = "highest", int8: bool = False,
                 mesh=None):
        self.device = _indexed(resolve_device(device))
        if int8:
            # W8A8 tier: a quantized copy of the model (ops/quant8.py); the
            # caller's module is left as it is. A weight-memory lever, not a
            # speed tier (the JAX package measured parity with bf16).
            self.model = quantize_model(model).to(self.device)
        else:
            self.model = model.to(self.device).eval()
        self.int8 = int8
        # "highest": full f32 products (device.py); "default": TF32 for the
        # f32 matmuls and convolutions of each call, then the flags restored
        # (JAX's DEFAULT precision on this hardware). No-op on the CPU.
        self.matmul_precision = matmul_precision
        self.token_multiple = token_multiple
        self.frames_per_token = frames_per_token
        self.max_frames = max_frames
        self.bf16 = bf16  # speed tier: bf16 matmuls, f32 accum/softmax/LN
        self.demand_sized = (flags.DEMAND_SIZED if demand_sized is None
                             else demand_sized)
        self._voc = None           # fused text->wav: set by attach_vocoder
        self._voc_fn = None        # host-level text->wav: attach_vocoder_fn
        self._voc_fn_hop = 256
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None and not self.mesh.distributed and int8:
            raise ValueError("the int8 tier is not served over a local mesh: its "
                             "replicas run apart and cannot share an activation "
                             "scale (serve it over a process mesh)")
        if self.mesh is not None and self.mesh.tp > 1:
            if int8:
                raise ValueError("the int8 tier serves no tensor-parallel model")
            if model.encoder.mesh is not self.mesh:
                raise ValueError("a tensor-parallel mesh serves a model sharded over "
                                 "it: parallel.sharding.shard_model(model, mesh)")
        self._replicas = {}
        self._lock = threading.Lock()
        self._leading = False
        if self.mesh is not None and not self.mesh.distributed:
            for dev in dict.fromkeys(_indexed(torch.device(d)) for d in self.mesh.devices):
                self._replicas[dev] = self if dev == self.device else Synthesizer(
                    copy.deepcopy(model), token_multiple, frames_per_token, max_frames,
                    bf16, demand_sized, dev, matmul_precision, int8)

    def attach_vocoder(self, gen) -> None:
        """Enable the fused text->wav path: the acoustic model, the MelGAN
        generator and the PCM conversion run back to back on the device, so
        the mel never crosses to the host between them. gen: a
        ``vocoder.MelGANGenerator`` (its weights move to this device)."""
        self._voc = gen.to(self.device).eval()
        for r in self._replicas.values():
            if r is not self:
                r.attach_vocoder(copy.deepcopy(gen))

    def attach_vocoder_fn(self, fn, hop_length: Optional[int] = None) -> None:
        """Enable text->wav via a host-level vocoder callable
        ``(L, n_mels) log-mel -> (L*hop,) float wav`` (e.g.
        ``vocoder.load_melgan``), run on each finished mel. A ``batched``
        attribute ``(mel (B, L, n_mels), out_lens) -> (B, L*hop)`` is used
        when present. hop_length defaults to the callable's own
        ``hop_length`` attribute (else 256)."""
        self._voc_fn = fn
        self._voc_fn_hop = (hop_length if hop_length is not None
                            else getattr(fn, "hop_length", 256))

    @property
    def has_vocoder(self) -> bool:
        return self._voc is not None or self._voc_fn is not None

    @property
    def hop_length(self) -> int:
        return (self._voc.cfg.hop_length if self._voc is not None
                else self._voc_fn_hop)

    @contextlib.contextmanager
    def _cd(self):
        # the kernels launch on the current card: a replica of a local mesh
        # on another card makes its own card current for its calls
        card = (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())
        with compute_dtype(torch.bfloat16 if self.bf16 else None), \
                matmul_precision(self.matmul_precision, self.device), \
                torch.inference_mode(), card:
            yield

    def _b_pad(self, B: int) -> int:
        """Next power of two: padded rows carry ilens=1."""
        return 1 << (B - 1).bit_length()

    def _alphas(self, alpha, B: int, B_pad: int) -> Tuple[np.ndarray, float]:
        a = np.asarray(alpha, np.float32).reshape(-1)
        if a.size == 1:
            a = np.full((B,), a[0], np.float32)
        if a.size != B:
            raise ValueError(f"alpha has {a.size} entries for {B} sequences")
        if not np.all(np.isfinite(a)) or np.any(a < 0):
            raise ValueError(f"invalid alpha {alpha!r}")
        out = np.ones((B_pad,), np.float32)
        out[:B] = a
        return out, float(a.max())

    def _l_pad(self, t_pad: int, alpha_max: float) -> int:
        base = t_pad * self.frames_per_token * max(alpha_max, 1.0)
        return min(_round_up(int(np.ceil(base)), 256), self.max_frames)

    def _l_rung(self, demand_max: int) -> int:
        """Smallest 256-frame rung covering the demand, capped at max_frames."""
        return min(_round_up(max(demand_max, 1), 256), self.max_frames)

    def _decode_groups(self, dem_all: np.ndarray) -> List[Tuple[np.ndarray, int]]:
        """[(rows, rung)]: split at the demand median when that shrinks the
        short half's rung; one group for tiny batches, or where a process
        mesh's data shards would not divide the halves."""
        B_pad = len(dem_all)
        rung_all = self._l_rung(int(dem_all.max()))
        shards = self.mesh.dp if self.mesh is not None and self.mesh.distributed else 1
        if B_pad < 4 or (B_pad // 2) % shards:
            return [(np.arange(B_pad), rung_all)]
        order = np.argsort(dem_all, kind="stable")
        short, long_ = order[: B_pad // 2], order[B_pad // 2:]
        rung_s = self._l_rung(int(dem_all[short].max()))
        if rung_s >= rung_all:
            return [(np.arange(B_pad), rung_all)]
        return [(short, rung_s), (long_, rung_all)]

    def _truncated(self, demand: np.ndarray, B: int, cap: int) -> np.ndarray:
        trunc = np.asarray(demand[:B]) > cap
        if trunc.any():
            log.warning("frame demand exceeds max_frames=%d for %d/%d rows -- "
                        "audio is truncated (raise max_frames or split the "
                        "input)", self.max_frames, int(trunc.sum()), B)
        return trunc

    def _pad_host(self, token_seqs: Sequence[np.ndarray], alpha, multiple: int = 1):
        """(B, t_pad, alpha max, xs, ilens, alphas) as host arrays, the rows
        padded to a power of two, then to a multiple of ``multiple``."""
        if not token_seqs or not all(len(s) for s in token_seqs):
            raise ValueError("empty token sequence: input produced no phonemes")
        B = len(token_seqs)
        B_pad = _round_up(self._b_pad(B), multiple)
        alphas, a_max = self._alphas(alpha, B, B_pad)
        t_pad = _round_up(max(len(s) for s in token_seqs), self.token_multiple)
        xs = np.zeros((B_pad, t_pad), np.int64)
        ilens = np.ones((B_pad,), np.int32)  # padded rows: length 1
        for i, s in enumerate(token_seqs):
            xs[i, : len(s)] = s
            ilens[i] = len(s)
        return B, t_pad, a_max, xs, ilens, alphas

    def _pad_batch(self, token_seqs: Sequence[np.ndarray], alpha):
        B, t_pad, a_max, *arrays = self._pad_host(token_seqs, alpha)
        return (B, t_pad, a_max, *(torch.from_numpy(a).to(self.device) for a in arrays))

    def mel_from_token_batch_async(self, token_seqs: Sequence[np.ndarray],
                                   alpha=1.0):
        """Enqueue the encode; returns a zero-arg finisher -> (mel (B, L,
        n_mels) f32, out_lens (B,), truncated (B,) bool) that reads the
        demand, enqueues every decode group, then reads the results."""
        return self._dispatch(token_seqs, alpha, wav=False)

    def _dispatch(self, token_seqs, alpha, wav: bool):
        """Enqueue the first device work of a mel (wav=False) or fused wav
        call and return its finisher."""
        if self.mesh is not None:
            return self._dispatch_sharded(token_seqs, alpha, wav)
        return self._run(*self._pad_batch(token_seqs, alpha), wav)

    def _dispatch_sharded(self, token_seqs, alpha, wav: bool):
        """A local mesh: the row shards, each through its replica's ``_run``.
        A process mesh: ``_run`` of the whole batch as this rank's part of
        one sharded call (a model group's ranks run the same part)."""
        n = self.mesh.dp
        B, t_pad, a_max, *arrays = self._pad_host(token_seqs, alpha, n)
        b = len(arrays[0]) // n
        if not self.mesh.distributed:
            fins = []
            for s, dev in enumerate(self.mesh.devices):
                rep = self._replicas[_indexed(torch.device(dev))]
                rows = (torch.from_numpy(a[s * b:(s + 1) * b]).to(rep.device)
                        for a in arrays)
                fins.append(rep._run(b, t_pad, a_max, *rows, wav))
            return lambda: _merge([f() for f in fins], B)
        import torch.distributed as dist

        # one call at a time on this process: the collectives of two calls
        # (the server's dispatch and delivery threads) must not interleave
        with self._lock:
            if self._leading:
                dist.broadcast_object_list([(wav, list(token_seqs), alpha)], src=0)
            shard = DataShard(self.mesh, self.mesh.data_index * b, n * b)
            with data_shard(shard):
                out = self._run(B, t_pad, a_max, *(torch.from_numpy(a).to(self.device)
                                                   for a in arrays), wav)()
        return lambda: out

    def lead(self) -> None:
        """This rank, rank 0, takes the requests (behind ``serve``): each
        call first sends its batch to the ranks that ``follow``."""
        import torch.distributed as dist

        if dist.get_rank() != 0:
            raise ValueError("rank 0 leads the serving ranks")
        self._leading = True

    def follow(self) -> None:
        """Serve the leader's calls on this rank's shard until it stops
        (``stop_followers``)."""
        import torch.distributed as dist

        while True:
            req = [None]
            dist.broadcast_object_list(req, src=0)
            if req[0] is None:
                return
            wav, seqs, alpha = req[0]
            self._dispatch(seqs, alpha, wav)()

    def stop_followers(self) -> None:
        """Release the following ranks (the leader's last call)."""
        import torch.distributed as dist

        if self._leading:
            with self._lock:
                dist.broadcast_object_list([None], src=0)
            self._leading = False

    def _run(self, B, t_pad, a_max, xs, ilens, alphas, wav: bool):
        """The demand-sized (or heuristic) call on padded device rows. Inside
        a data shard (``_dispatch_sharded``) the rows are the whole batch and
        this rank computes its part of each step (``_Part``)."""
        if not self.demand_sized:
            return self._heuristic(B, t_pad, a_max, xs, ilens, alphas, wav)
        part = _Part(current_shard())
        with self._cd():
            hs, d_outs = self.model.encode(part.mine(xs), part.mine(ilens))
            demand = frame_demand(scale_durations(d_outs, part.mine(alphas)),
                                  make_non_pad_mask(part.mine(ilens), t_pad))
            hs, d_outs, demand = (part.whole(t) for t in (hs, d_outs, demand))

        def finish_demand():
            dem_all = demand.cpu().numpy()
            trunc = self._truncated(dem_all, B, self.max_frames)
            groups = self._decode_groups(dem_all)
            l_max = max(r for _, r in groups)
            hop = self.hop_length if wav else 0
            with self._cd():
                # row indices cross before any decode is enqueued (a blocking
                # copy waits for the stream); the groups' mels (and wavs) are
                # assembled on the device and cross back in one copy each
                # (pinned buffers per call cost a cudaHostAlloc each while
                # callers hold earlier results)
                idx = [torch.from_numpy(rows).to(self.device) for rows, _ in groups]
                mel = torch.zeros((len(dem_all), l_max, self.model.odim),
                                  device=self.device)
                pcm = torch.zeros((len(dem_all), l_max * hop), dtype=torch.int16,
                                  device=self.device)
                out_lens = torch.zeros((len(dem_all),), dtype=torch.int32,
                                       device=self.device)
                for gi, (_, rung) in zip(idx, groups):
                    args = ((hs, d_outs, ilens, alphas)
                            if len(groups) == 1 and part.shards == 1 else
                            tuple(t.index_select(0, part.mine(gi))
                                  for t in (hs, d_outs, ilens, alphas)))
                    mel_g, lens_g = self.model.decode_frames(
                        args[0], args[1], args[2], out_maxlen=rung, alpha=args[3])
                    mel[gi, :rung] = part.whole(mel_g)
                    out_lens[gi] = part.whole(lens_g)
                    if wav:
                        pcm[gi, :rung * hop] = part.whole(self._vocode_pcm(mel_g, lens_g))
            lens = out_lens[:B].cpu().numpy().astype(np.int64)
            if wav:
                return (mel[:B].cpu().numpy(), pcm[:B].cpu().numpy(),
                        lens * hop, trunc)
            return mel[:B].cpu().numpy(), lens, trunc

        return finish_demand

    def _vocode_pcm(self, mel: torch.Tensor, out_lens: torch.Tensor) -> torch.Tensor:
        """Device mel (B, L, n_mels) -> int16 PCM (B, L*hop): floor-masked
        frames double as the tail-flush frames a standalone vocoder pads in,
        and L stays a multiple of 256 on the demand-sized rungs, so every
        MelGAN stage keeps a tileable length."""
        return pcm16(self._voc(mel_floor_mask(mel, out_lens)))

    def _grow_l_pad(self, l_pad: int, demand: int) -> int:
        """Next heuristic buffer after a saturated row: double until the
        demand fits (a logarithmic set of shapes), capped at max_frames."""
        new = l_pad * 2
        while new < demand and new < self.max_frames:
            new *= 2
        return min(_round_up(new, 256), self.max_frames)

    def _heuristic(self, B, t_pad, a_max, xs, ilens, alphas, wav: bool = False):
        """One call on the frames-per-token buffer; while a row's demand
        exceeds it and max_frames allows, re-run on a grown buffer (the wav
        buffer grows with it). Inside a data shard every rank runs its rows
        and decides on the whole batch's demand."""
        part = _Part(current_shard())
        xs, ilens, alphas = (part.mine(t) for t in (xs, ilens, alphas))

        def run(l_pad):
            with self._cd():
                mel, out_lens, d_outs = self.model.inference(
                    xs, ilens, out_maxlen=l_pad, alpha=alphas)
                pcm = part.whole(self._vocode_pcm(mel, out_lens)) if wav else None
            return part.whole(mel), part.whole(out_lens), d_outs, pcm

        l_pad = self._l_pad(t_pad, a_max)
        mel, out_lens, d_outs, pcm = run(l_pad)
        with self._cd():
            demand = part.whole(frame_demand(scale_durations(d_outs, alphas),
                                             make_non_pad_mask(ilens, t_pad)))

        def finish_heuristic(mel=mel, out_lens=out_lens, pcm=pcm, l_pad=l_pad):
            dem = demand.cpu().numpy()[:B]
            while (dem > l_pad).any() and l_pad < self.max_frames:
                l_pad = self._grow_l_pad(l_pad, int(dem.max()))
                log.info("frame demand %d > buffer; re-running at l_pad=%d",
                         int(dem.max()), l_pad)
                mel, out_lens, _, pcm = run(l_pad)
            trunc = self._truncated(dem, B, l_pad)
            lens = out_lens[:B].cpu().numpy().astype(np.int64)
            if wav:
                return (mel[:B].cpu().numpy(), pcm[:B].cpu().numpy(),
                        lens * self.hop_length, trunc)
            return mel[:B].cpu().numpy(), lens, trunc

        return finish_heuristic

    def mel_from_token_batch(self, token_seqs: Sequence[np.ndarray], alpha=1.0,
                             return_truncated: bool = False):
        """List of id sequences -> (mel (B, L, n_mels), out_lens (B,)) and,
        with return_truncated, a (B,) bool array of rows capped by
        max_frames."""
        mel, out_lens, trunc = self.mel_from_token_batch_async(token_seqs, alpha)()
        if return_truncated:
            return mel, out_lens, trunc
        return mel, out_lens

    def _bucket_plan(self, lens: Sequence[int], max_buckets: int, a_max: float
                     ) -> List[List[int]]:
        """Partition the length-sorted rows into <= max_buckets contiguous
        segments minimizing the total padded frame cost sum(|seg| * l_pad(seg
        max)): exact O(n^2 k) dynamic program (n is a serving batch)."""
        order = sorted(range(len(lens)), key=lambda i: lens[i])
        n = len(order)

        def seg_cost(i, j):  # ranks [i, j)
            t_pad = _round_up(lens[order[j - 1]], self.token_multiple)
            return (j - i) * self._l_pad(t_pad, a_max)

        INF = float("inf")
        best = [[INF] * (max_buckets + 1) for _ in range(n + 1)]
        cut = [[0] * (max_buckets + 1) for _ in range(n + 1)]
        best[0][0] = 0.0
        for j in range(1, n + 1):
            for k in range(1, max_buckets + 1):
                for i in range(j):
                    if best[i][k - 1] == INF:
                        continue
                    c = best[i][k - 1] + seg_cost(i, j)
                    if c < best[j][k]:
                        best[j][k] = c
                        cut[j][k] = i
        k = min(range(1, max_buckets + 1), key=lambda k: best[n][k])
        bounds, j = [], n
        while j > 0:
            i = cut[j][k]
            bounds.append((i, j))
            j, k = i, k - 1
        return [[order[r] for r in range(i, j)] for i, j in reversed(bounds)]

    def mel_from_token_batch_bucketed(self, token_seqs: Sequence[np.ndarray],
                                      alpha=1.0, max_buckets: int = 3
                                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Like mel_from_token_batch, but the batch is split into up to
        max_buckets length-sorted sub-batches (``_bucket_plan``), each served
        by mel_from_token_batch with its own padded shapes; rows come back in
        the caller's order, zero-padded to the longest sub-batch's frames."""
        B = len(token_seqs)
        if B <= 1 or max_buckets <= 1:
            return self.mel_from_token_batch(token_seqs, alpha)
        alphas, a_max = self._alphas(alpha, B, B)
        groups = self._bucket_plan([len(s) for s in token_seqs], max_buckets, a_max)
        mels, out_lens = [None] * B, np.zeros((B,), np.int64)
        for g in groups:
            mel_g, lens_g = self.mel_from_token_batch([token_seqs[i] for i in g], alphas[g])
            for row, i in enumerate(g):
                mels[i] = mel_g[row]
                out_lens[i] = lens_g[row]
        out = np.zeros((B, max(m.shape[0] for m in mels), mels[0].shape[1]), mels[0].dtype)
        for i, m in enumerate(mels):
            out[i, : m.shape[0]] = m
        return out, out_lens

    def wav_from_token_batch_async(self, token_seqs: Sequence[np.ndarray],
                                   alpha=1.0):
        """Enqueue the text->wav call without waiting for its result;
        returns a zero-arg finisher -> (mel (B, L, n_mels) f32, wav (B, L*hop)
        int16 PCM, wav_lens (B,) = out_lens*hop, truncated (B,) bool). A
        server dispatches batch k+1 before finishing batch k, so the host
        read of one overlaps the device work of the other."""
        if self._voc is None and self._voc_fn is not None:
            # host-level vocoder: the mel path is enqueued now, the vocoder
            # itself runs at finish time on the finished mels
            finish_mel = self.mel_from_token_batch_async(token_seqs, alpha)

            def finish_hostvoc():
                mel, out_lens, trunc = finish_mel()
                hop = self._voc_fn_hop
                batched = getattr(self._voc_fn, "batched", None)
                if batched is not None:
                    wav16 = pcm16(np.asarray(batched(mel, out_lens)))
                    tail = (np.arange(wav16.shape[1])[None, :]
                            >= (out_lens * hop)[:, None])
                    wav16[tail] = 0
                else:
                    wav16 = np.zeros((len(token_seqs), mel.shape[1] * hop),
                                     np.int16)
                    for i in range(len(token_seqs)):
                        w = np.asarray(self._voc_fn(mel[i, : out_lens[i]]))
                        wav16[i, : w.shape[0]] = pcm16(w)
                return mel, wav16, out_lens * hop, trunc

            return finish_hostvoc
        if self._voc is None:
            raise RuntimeError("no vocoder attached: call attach_vocoder or "
                               "attach_vocoder_fn first")
        return self._dispatch(token_seqs, alpha, wav=True)

    def wav_from_token_batch(self, token_seqs: Sequence[np.ndarray], alpha=1.0,
                             return_truncated: bool = False):
        """List of id sequences -> (mel (B, L, n_mels) f32, wav (B, L*hop)
        int16 PCM, wav valid lengths = out_lens*hop). Requires
        attach_vocoder or attach_vocoder_fn. return_truncated appends a (B,)
        bool array marking rows capped by max_frames."""
        out = self.wav_from_token_batch_async(token_seqs, alpha)()
        return out if return_truncated else out[:3]

    def warmup(self, batch_sizes=(1, 16), token_lens=(32, 96),
               alpha_max: float = 1.0) -> int:
        """Run dummy batches through the serving shapes so the first real
        requests do not pay for first use. There is no compilation per shape
        here; what a first call does pay for, and this warms, is the build
        and load of the kernel libraries, the kernel-layout weight packs
        (``ops/kernels/common.py:cached_pack``), the cuDNN/cuBLAS handles
        and algorithm choices per shape, and the caching allocator's blocks
        for every power-of-two batch and decode rung.

        Every power-of-two bucket between min and max of ``batch_sizes`` is
        walked for each token length, through the wav path when a vocoder is
        attached, else the mel path; on the demand-sized path every 256-frame
        rung up to the heuristic ceiling ``_l_pad(t_pad, alpha_max)`` is
        decoded too (pass the largest alpha the service admits). Returns the
        number of calls made."""
        lo, hi = max(min(batch_sizes), 1), max(batch_sizes)
        sizes, b = [], lo
        while b < hi:
            sizes.append(self._b_pad(b))
            b <<= 1
        sizes.append(self._b_pad(hi))
        sizes = sorted(set(sizes))
        calls = 0
        for t in token_lens:
            for b in sizes:
                seqs = [np.ones((t,), np.int64)] * b
                if self.has_vocoder:
                    self.wav_from_token_batch(seqs)
                else:
                    self.mel_from_token_batch(seqs)
                calls += 1
                if self.demand_sized:
                    for r in (list(self._replicas.values()) or [self]):
                        calls += r._warm_dec_rungs(t, b, alpha_max)
        return calls

    def _warm_dec_rungs(self, t: int, b: int, alpha_max: float = 1.0) -> int:
        """The rung a real batch lands on depends on its predicted
        durations, so the dummy warmup batch touches one rung only. Decode
        zero-filled inputs on every 256-frame rung up to the heuristic
        ceiling for this token length, at the full batch and at the half
        batch the 2-way split dispatches."""
        t_pad = _round_up(t, self.token_multiple)
        B_pad = self._b_pad(b)
        dev = self.device
        sizes = [B_pad] + ([B_pad // 2] if B_pad >= 4 else [])
        calls = 0
        for bp in sizes:
            hs0 = torch.zeros((bp, t_pad, self.model.cfg.model.adim), device=dev)
            d0 = torch.ones((bp, t_pad), dtype=torch.int32, device=dev)
            il0 = torch.ones((bp,), dtype=torch.int32, device=dev)
            al0 = torch.ones((bp,), device=dev)
            rung, top = 256, self._l_pad(t_pad, alpha_max)
            while rung <= top:
                with self._cd():
                    mel, lens = self.model.decode_frames(hs0, d0, il0,
                                                         out_maxlen=rung, alpha=al0)
                    out = self._vocode_pcm(mel, lens) if self._voc is not None else lens
                out.cpu()  # wait for the rung before the next one
                calls += 1
                rung += 256
        return calls

    def synth_phonemes(self, phoneme_str: str, alpha: float = 1.0) -> np.ndarray:
        """Space-joined phoneme string -> (L, n_mels) mel."""
        tokens = np.asarray(phonemes_to_sequence(phoneme_str), np.int64)
        mel, out_lens = self.mel_from_token_batch([tokens], alpha)
        return mel[0, : out_lens[0]]

    def synth_text(self, text: str, alpha: float = 1.0,
                   g2p=None) -> Tuple[np.ndarray, dict]:
        """Free text -> (L_total, n_mels) mel (sentence mels concatenated)
        and timing stats."""
        t0 = time.perf_counter()
        sentences = [s for s in process_paragraph(text) if s.strip()]
        phoneme_strs = [preprocess_text(s, g2p=g2p) for s in sentences]
        token_seqs = [np.asarray(phonemes_to_sequence(p), np.int64)
                      for p in phoneme_strs if p]
        t_frontend = time.perf_counter() - t0

        t0 = time.perf_counter()
        mel, out_lens = self.mel_from_token_batch(token_seqs, alpha)
        mels = [mel[i, : out_lens[i]] for i in range(len(token_seqs))]
        full = np.concatenate(mels, axis=0)
        t_model = time.perf_counter() - t0
        stats = {
            "frontend_s": t_frontend, "model_s": t_model,
            "frames": int(full.shape[0]),
            "msec_per_frame": 1000.0 * t_model / max(full.shape[0], 1),
        }
        return full, stats


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index (``cuda`` means the current card)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class _Part:
    """This rank's part of a sharded call (``shard``: the data shard of
    ``_dispatch_sharded``, or None: the whole call on this process)."""

    def __init__(self, shard: Optional[DataShard]):
        self.shard = shard
        self.shards = 1 if shard is None else shard.mesh.dp

    def mine(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous share of the rows of ``t``."""
        if self.shard is None:
            return t
        n = t.shape[0] // self.shards
        return t[self.shard.mesh.data_index * n:(self.shard.mesh.data_index + 1) * n]

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """The data group's shares of ``t``, in row order (int16 PCM crosses
        as int32: the collectives take no int16)."""
        if self.shard is None or self.shard.group is None:
            return t
        if t.dtype == torch.int16:
            return all_gather(t.int(), self.shard.group).to(torch.int16)
        return all_gather(t, self.shard.group)


def _merge(parts, B: int):
    """Row shards' results, (mel, [pcm,] lens, trunc) each, in order: the
    frame axis zero-padded to the longest shard's, then the first B rows."""
    out = []
    for j in range(len(parts[0])):
        arrs = [p[j] for p in parts]
        if arrs[0].ndim >= 2:
            w = max(a.shape[1] for a in arrs)
            arrs = [np.pad(a, [(0, 0), (0, w - a.shape[1])] + [(0, 0)] * (a.ndim - 2))
                    for a in arrs]
        out.append(np.concatenate(arrs)[:B])
    return tuple(out)


@functools.lru_cache(maxsize=4)
def _mel_pinv(sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax) -> np.ndarray:
    """Pseudo-inverse of the mel filterbank, computed once per audio config
    (an SVD of (n_mels, n_freq): ~25 ms on the host, per request otherwise)."""
    from fastspeech2_tpu_torch.audio.stft import mel_filterbank

    return np.linalg.pinv(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax))


def vocode(mel: np.ndarray, cfg, vocoder=None, gl_iters: int = 30,
           device: Union[str, torch.device, None] = None,
           phase: Optional[torch.Tensor] = None) -> np.ndarray:
    """(L, n_mels) log-mel -> float waveform. Uses the given neural vocoder
    (callable mel->wav) when provided, else Griffin-Lim over the approximate
    inverse mel on ``device`` (None: the card; reference
    inference.py:180-199). ``phase`` (1, n_freq, L) replaces Griffin-Lim's
    seeded initial phase."""
    if vocoder is not None:
        return np.asarray(vocoder(mel))
    from fastspeech2_tpu_torch.audio.griffin_lim import griffin_lim

    dev = resolve_device(device)
    a = cfg.audio
    # least-squares pseudo-inverse mel -> linear magnitude (host, numpy)
    inv = _mel_pinv(a.sample_rate, a.n_fft, a.n_mels, a.fmin, a.fmax)
    mag = np.maximum(inv @ np.exp(mel.T), 0.0)  # (n_freq, L)
    wav = griffin_lim(torch.from_numpy(np.ascontiguousarray(mag[None], np.float32)).to(dev),
                      n_iters=gl_iters, n_fft=a.n_fft, hop_length=a.hop_length,
                      win_length=a.win_length, phase=phase)
    return wav[0].cpu().numpy()


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """int16 PCM wav (reference inference.py:200-201), via scipy."""
    from scipy.io.wavfile import write

    peak = np.abs(wav).max()
    if peak > 1.0:
        wav = wav / peak
    write(path, sample_rate, (wav * 32767.0).astype(np.int16))
