"""Training observability (the port's own copy of
``fastspeech2_tpu/train/metrics.py``): scalar metrics to JSONL (always) and
TensorBoard, matching the reference's reporting surface
(``train_fastspeech.py:133-226``: per-interval train scalars, validation
scalars and sample images and audio, evaluation losses). The TensorBoard
writer is tensorboardX's where it is installed, else the one torch ships
(``torch.utils.tensorboard``, which needs the tensorboard package), else
none."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str, name: str = "train", use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._f = open(self.path, "a", encoding="utf-8")
        self.tb = self._summary = None
        if use_tensorboard:
            self.tb, self._summary = _summary_writer(log_dir)

    def scalars(self, step: int, values: Dict[str, float], prefix: str = "main"):
        rec = {"step": int(step), "time": time.time(),
               **{f"{prefix}/{k}": float(v) for k, v in values.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(f"{prefix}/{k}", float(v), step)

    def image(self, step: int, tag: str, img_chw):
        """CHW uint8 image to TensorBoard (mel/waveform plots, reference
        train_fastspeech.py:167-219). No-op without a writer."""
        if self.tb is not None:
            self.tb.add_image(tag, img_chw, step)

    def audio(self, step: int, tag: str, wav, sample_rate: int):
        """Float waveform to TensorBoard. Encodes the WAV with the stdlib
        (add_audio needs soundfile, which may be absent) and emits the
        writer's own Summary.Audio proto directly."""
        if self.tb is None:
            return
        import io
        import wave as wave_mod

        import numpy as np

        Summary = self._summary
        pcm = (np.clip(np.asarray(wav).reshape(-1), -1, 1) * 32767).astype("<i2")
        buf = io.BytesIO()
        with wave_mod.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes(pcm.tobytes())
        audio = Summary.Audio(sample_rate=sample_rate, num_channels=1,
                              length_frames=len(pcm),
                              encoded_audio_string=buf.getvalue(),
                              content_type="audio/wav")
        self.tb._get_file_writer().add_summary(
            Summary(value=[Summary.Value(tag=tag, audio=audio)]), step)

    def close(self):
        self._f.close()
        if self.tb is not None:
            self.tb.close()


def _summary_writer(log_dir: str):
    """(SummaryWriter, its Summary proto class), or (None, None)."""
    try:
        from tensorboardX import SummaryWriter  # type: ignore
        from tensorboardX.proto.summary_pb2 import Summary  # type: ignore
    except ImportError:
        try:
            from tensorboard.compat.proto.summary_pb2 import Summary  # type: ignore
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None, None
    try:
        return SummaryWriter(log_dir), Summary
    except Exception:
        return None, None


class Throughput:
    """Step-time / throughput counters (mel-frames/s, audio-seconds/s)."""

    def __init__(self, hop_length: int = 256, sample_rate: int = 22050):
        self.hop = hop_length
        self.sr = sample_rate
        self.reset()

    def reset(self):
        self.frames = 0
        self.t0 = time.perf_counter()

    def add(self, n_frames: int):
        self.frames += int(n_frames)

    def report(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        fps = self.frames / dt
        return {
            "mel_frames_per_s": fps,
            "audio_seconds_per_s": fps * self.hop / self.sr,
            "wall_s": dt,
        }
