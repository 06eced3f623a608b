"""Training loop (``fastspeech2_tpu/train/loop.py``), on one device.

Structure per epoch: bucketed batches (prefetched and copied to the device on
a background thread) -> accumulate + clip + Noam-Adam step -> periodic scalar
metrics (summary_interval), teacher-forced validation with a free-running
sample's mel images and audio (validation_step), asynchronous checkpoint +
predictor evaluation (save_interval); a final checkpoint + prune at
``max_steps``; a checkpoint at the next step boundary on SIGTERM/SIGINT. With
``profile_dir``, one torch.profiler trace of a few warm steps.

Not ported yet (ROADMAP.md queue 1 item 8): multi-host and multi-device
training (``dp_size``, ``tensor_parallel``, ``num_hosts``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import time
from typing import Optional, Union

import numpy as np
import torch

from fastspeech2_tpu_torch.config import Config
from fastspeech2_tpu_torch.data.batching import BucketBatcher, pad_batch
from fastspeech2_tpu_torch.data.dataset import TTSDataset
from fastspeech2_tpu_torch.data.prefetch import batch_to_device, prefetch
from fastspeech2_tpu_torch.device import resolve_device
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_tpu_torch.ops import attention_mask, make_non_pad_mask
from fastspeech2_tpu_torch.ops.length_regulator import regulate_length
from fastspeech2_tpu_torch.train.checkpoint import (AsyncCheckpointer,
                                                    load_checkpoint,
                                                    prune_checkpoints,
                                                    save_checkpoint)
from fastspeech2_tpu_torch.train.metrics import MetricsWriter, Throughput
from fastspeech2_tpu_torch.train.optimizer import NoamAdam
from fastspeech2_tpu_torch.train.seeds import SeedSchedule
from fastspeech2_tpu_torch.train.step import (TrainState, make_eval_step,
                                              make_train_step, trainable)

log = logging.getLogger("fastspeech2_tpu_torch.train")


def _drain_writer(ckpt_writer: AsyncCheckpointer) -> None:
    """Join the async writer before a synchronous exit save, LOGGING a stale
    error from an earlier failed periodic write instead of re-raising it:
    otherwise a transient disk error long ago would abort the preemption or
    final checkpoint. The sync save that follows raises on its own if the
    disk is still bad."""
    try:
        ckpt_writer.wait()
    except Exception:
        log.exception("earlier async checkpoint write had failed; "
                      "attempting the synchronous exit save anyway")


@contextlib.contextmanager
def _preemption_guard(flag: dict):
    """Install SIGTERM/SIGINT handlers setting ``flag['hit']``; restore the
    previous handlers on exit. No-op off the main thread (tests, servers)."""

    def _on_signal(signum, frame):
        flag["hit"] = True
        log.warning("signal %d received; checkpointing at the next step "
                    "boundary then exiting", signum)

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, _on_signal)
        except ValueError:  # not in the main thread: leave handlers alone
            pass
    try:
        yield
    finally:
        for sig, h in prev.items():
            signal.signal(sig, h)


@torch.no_grad()
def evaluate_predictors(model: FastSpeech2, valid_ds: TTSDataset) -> dict:
    """Per-utterance teacher-forced L1 of the duration, energy and pitch
    predictions (f32, no dropout), averaged over the validation set."""
    dev = model.device
    utts = [valid_ds[i] for i in range(len(valid_ds))]
    T = max(len(u.tokens) for u in utts)
    L = max(u.mel.shape[0] for u in utts)
    d_l, e_l, p_l = [], [], []
    for u in utts:
        b = batch_to_device(pad_batch([u], T, L), dev)
        tok_mask = make_non_pad_mask(b.ilens, T)
        mel_mask = make_non_pad_mask(b.olens, L)
        hs = model.encoder(b.xs, attention_mask(b.ilens, T))
        d_outs = model.duration_predictor.masked(hs, tok_mask)
        hs_e, _, _ = regulate_length(hs, b.ds, tok_mask, L)
        e_outs = model.energy_predictor.masked(hs_e, mel_mask)
        p_outs = model.pitch_predictor.masked(hs_e, mel_mask)
        nd = tok_mask.sum().clamp_min(1)
        nf = mel_mask.sum().clamp_min(1)
        d_l.append(((d_outs - b.ds).abs() * tok_mask).sum() / nd)
        e_l.append(((e_outs - b.es).abs() * mel_mask).sum() / nf)
        p_l.append(((p_outs - b.ps).abs() * mel_mask).sum() / nf)
    d, e, p = (float(torch.stack(x).mean()) for x in (d_l, e_l, p_l))
    return {"Dur_Loss": d, "Energy_Loss": e, "Pitch_Loss": p}


@torch.no_grad()
def _log_validation_sample(model: FastSpeech2, valid_ds: TTSDataset,
                           metrics: MetricsWriter, step: int, cfg: Config,
                           audio_steps: int = 0, vocoder=None) -> None:
    """Free-running inference (f32) on the first validation utterance: its
    target and predicted mel images and, with ``audio_steps``, both as audio
    to TensorBoard (reference train_fastspeech.py:167-219). The audio comes
    from ``vocoder`` (MelGAN) when given, else Griffin-Lim of
    ``audio_steps`` iterations on the model's device."""
    from fastspeech2_tpu_torch.infer.synthesize import vocode
    from fastspeech2_tpu_torch.utils.plotting import plot_spectrogram_to_numpy

    u = valid_ds[0]
    T = len(u.tokens)
    L = max(u.mel.shape[0] * 2, 64)
    dev = model.device
    mel, out_lens, _ = model.inference(
        torch.from_numpy(np.asarray(u.tokens, np.int64)[None]).to(dev),
        torch.tensor([T], dtype=torch.int32, device=dev), out_maxlen=L)
    n = int(out_lens[0])
    if n >= L:
        # out_lens is clipped to the buffer; an untrained or duration-exploding
        # model would otherwise truncate silently
        log.warning("validation sample filled its %d-frame buffer (target %d frames): "
                    "predicted durations likely exploding, sample image/audio "
                    "truncated", L, u.mel.shape[0])
    pred = mel[0, :n].float().cpu().numpy().T
    metrics.image(step, "validation/mel_target", plot_spectrogram_to_numpy(u.mel.T))
    if pred.shape[1] > 0:
        metrics.image(step, "validation/mel_predicted", plot_spectrogram_to_numpy(pred))
    if audio_steps > 0 and pred.shape[1] > 0:
        sr = cfg.audio.sample_rate
        metrics.audio(step, "validation/audio_predicted",
                      vocode(pred.T, cfg, vocoder=vocoder, gl_iters=audio_steps,
                             device=dev), sr)
        metrics.audio(step, "validation/audio_target",
                      vocode(u.mel, cfg, vocoder=vocoder, gl_iters=audio_steps,
                             device=dev), sr)


class _Profiler:
    """One torch.profiler trace of ``n_steps`` steps, started once the step
    is warm (3 steps after the start or resume) and written into ``out_dir``
    as a Chrome trace when they are done, or when the run ends first."""

    def __init__(self, out_dir: Optional[str], n_steps: int, step0: int,
                 device: torch.device):
        self.out_dir, self.n_steps, self.step0, self.device = out_dir, n_steps, step0, device
        self.prof = None
        self.first = self.stop_at = -1

    def before_step(self, step: int) -> None:
        if self.out_dir and self.prof is None and step >= self.step0 + 3:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.first, self.stop_at = step + 1, step + self.n_steps

    def after_step(self, step: int) -> None:
        if self.prof is not None and self.out_dir and step >= self.stop_at:
            self.close(step)

    def close(self, step: int) -> None:
        """Stop and write the trace, if one is running."""
        if self.prof is None or not self.out_dir:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"trace_steps_{self.first}-{step}.json")
        self.prof.export_chrome_trace(path)
        self.out_dir = None  # once
        log.info("profiler trace of steps %d-%d written to %s", self.first, step, path)


def resolve_dp(cfg: Config, n_dev: int, tp: int) -> int:
    """Data-parallel degree. The port trains on ONE device: anything else
    that is asked for raises, naming what is still to port."""
    if tp > 1:
        raise NotImplementedError(
            f"train.tensor_parallel={tp}: tensor parallelism is not ported yet "
            "(ROADMAP.md queue 1 item 8: parallel/, shard_train_step)")
    if cfg.train.dp_size > 1:
        raise NotImplementedError(
            f"train.dp_size={cfg.train.dp_size}: data parallelism is not ported "
            "yet (ROADMAP.md queue 1 item 8: parallel/, shard_train_step)")
    return 1


def train(cfg: Config, name: str, outdir: str,
          resume_path: Optional[str] = None,
          max_steps: Optional[int] = None,
          data_dir: Optional[str] = None,
          device: Union[str, torch.device, None] = None,
          profile_dir: Optional[str] = None,
          profile_steps: int = 5) -> TrainState:
    """Run training; returns the final TrainState. ``device`` None means the
    CUDA card and raises without one; the CPU must be asked for.

    With ``profile_dir``, a torch.profiler trace of ``profile_steps`` steps
    is written there once the step is warm (``_Profiler``).

    Preemption-safe: SIGTERM/SIGINT during setup OR the loop checkpoints the
    in-flight state at the next step boundary and returns; the guard wraps
    the whole function, set-up included."""
    preempt = {"hit": False}
    with _preemption_guard(preempt):
        return _train(cfg, name, outdir, resume_path, max_steps, data_dir,
                      device, profile_dir, profile_steps, preempt)


def _train(cfg: Config, name: str, outdir: str, resume_path: Optional[str],
           max_steps: Optional[int], data_dir: Optional[str], device,
           profile_dir: Optional[str], profile_steps: int,
           preempt: dict) -> TrainState:
    device = resolve_device(device)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    resolve_dp(cfg, n_dev, max(1, cfg.train.tensor_parallel))
    if cfg.train.num_hosts > 1:
        raise NotImplementedError(
            "train.num_hosts > 1: multi-host training is not ported yet "
            "(ROADMAP.md queue 1 item 8)")

    data_dir = data_dir or cfg.data.data_dir
    train_ds = TTSDataset(data_dir, cfg.data.train_filelist,
                          cfg.train.use_phonemes, cfg.data.tts_cleaner_names)
    valid_ds = TTSDataset(data_dir, cfg.data.valid_filelist,
                          cfg.train.use_phonemes, cfg.data.tts_cleaner_names)

    model = FastSpeech2(cfg, device=device, generator=torch.Generator().manual_seed(
        cfg.train.seed))
    opt = NoamAdam(trainable(model), cfg)
    ts = TrainState(model, opt, 0)
    if resume_path:
        try:
            ts.step, _ = load_checkpoint(resume_path, model, opt)
        except (KeyError, ValueError) as e:
            # optimizer layout changed across versions: keep params/step,
            # restart the optimizer state
            log.warning("optimizer state in %s doesn't match current "
                        "optimizer (%s); reinitializing it", resume_path, e)
            ts.step, _ = load_checkpoint(resume_path, model)
        log.info("resumed from %s at step %d", resume_path, ts.step)
    step0 = ts.step

    accum = cfg.train.accum_grad
    step_fn = make_train_step(model, opt, accum, bf16=cfg.train.bf16)
    eval_fn = make_eval_step(model)
    # the dropout seeds of a resumed run must not repeat the first run's
    seeds = SeedSchedule(model.dropout_sites(), seed=cfg.train.seed + step0)

    batcher = BucketBatcher(
        train_ds, batch_size=cfg.train.batch_size * accum,
        max_frames=cfg.train.tts_max_mel_len, seed=cfg.train.seed,
        bin_lengths=cfg.train.tts_bin_lengths)

    ckpt_dir = os.path.normpath(os.path.join(outdir, cfg.train.chkpt_dir, name))
    ckpt_writer = AsyncCheckpointer()  # periodic saves overlap the loop
    log_dir = os.path.normpath(os.path.join(outdir, cfg.train.log_dir, name))
    metrics = MetricsWriter(log_dir)
    tput = Throughput(cfg.audio.hop_length, cfg.audio.sample_rate)
    profiler = _Profiler(profile_dir, profile_steps, step0, device)

    vocoder = None  # neural validation audio (reference train_fastspeech.py:446)
    if cfg.train.melgan_vocoder and cfg.train.vocoder_checkpoint:
        try:
            from fastspeech2_tpu_torch.vocoder import load_melgan

            vocoder = load_melgan(cfg.train.vocoder_checkpoint, device=device)
            log.info("validation audio via MelGAN %s", cfg.train.vocoder_checkpoint)
        except Exception as e:  # audio is best-effort, as in the JAX loop
            log.warning("MelGAN load failed (%s); Griffin-Lim audio", e)

    def to_device(item):
        batch, _shape = item
        return batch_to_device(batch, device), int(np.sum(batch.olens))

    def ckpt_path(step: int) -> str:
        return os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")

    try:
        for epoch in range(10 ** 9):
            t_epoch = time.time()
            step_before = ts.step
            for batch, n_frames in prefetch(batcher.epoch(epoch), depth=2,
                                            transform=to_device):
                profiler.before_step(ts.step)
                ts, report = step_fn(ts, batch, [seeds.draw() for _ in range(accum)])
                step = ts.step
                tput.add(n_frames)
                profiler.after_step(step)

                if preempt["hit"]:
                    _drain_writer(ckpt_writer)  # don't race the periodic writer
                    save_checkpoint(ckpt_path(step), model, opt, step, cfg)
                    log.warning("preempted at step %d: saved %s", step, ckpt_path(step))
                    return ts

                if step % cfg.train.summary_interval == 0:
                    # the one read of device scalars: every summary_interval steps
                    scalars = {k: float(v) for k, v in report.items()}
                    scalars.update(tput.report())
                    metrics.scalars(step, scalars, prefix="main")
                    tput.reset()
                    log.info("step %d loss %.4f", step, scalars["loss"])

                if step % cfg.train.validation_step == 0:
                    vloss = []
                    for vb, _ in BucketBatcher(
                            valid_ds, batch_size=min(len(valid_ds), 2),
                            seed=0, drop_remainder=False).epoch(0):
                        vr = eval_fn(ts, batch_to_device(vb, device))
                        vloss.append(vr["loss"])
                    if vloss:
                        metrics.scalars(
                            step, {"loss": float(torch.stack(vloss).mean())},
                            prefix="validation")
                        try:
                            _log_validation_sample(model, valid_ds, metrics, step, cfg,
                                                   audio_steps=30, vocoder=vocoder)
                        except Exception as e:  # images are best-effort
                            log.warning("validation sample logging failed: %s", e)

                if step % cfg.train.save_interval == 0:
                    # async: snapshot to host now, npz write + retention prune
                    # on the writer thread while the loop keeps stepping
                    ckpt_writer.save(ckpt_path(step), model, opt, step, cfg)
                    metrics.scalars(step, evaluate_predictors(model, valid_ds),
                                    prefix="evaluation")
                    log.info("saving %s (async)", ckpt_path(step))

                if max_steps is not None and step - step0 >= max_steps:
                    # sync final save: wait for any in-flight async write (the
                    # same path when max_steps lands on save_interval), then
                    # write + prune on this thread before returning
                    _drain_writer(ckpt_writer)
                    save_checkpoint(ckpt_path(step), model, opt, step, cfg)
                    prune_checkpoints(ckpt_dir, cfg.train.keep_ckpts)
                    return ts
            if ts.step == step_before:
                raise ValueError(
                    f"the training set yields no batch: {len(train_ds)} utterances, "
                    f"{cfg.train.batch_size * accum} per step after dropping those "
                    f"over {cfg.train.tts_max_mel_len} frames")
            log.info("epoch %d done in %.1fs", epoch, time.time() - t_epoch)
            if epoch + 1 >= cfg.train.epochs:
                ckpt_writer.wait()
                return ts
    finally:
        profiler.close(ts.step)
        metrics.close()
