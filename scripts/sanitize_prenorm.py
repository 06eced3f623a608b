#!/usr/bin/env python3
"""Calls of the port on the card, small enough to run under the CUDA
toolkit's ``compute-sanitizer``:

    compute-sanitizer --tool memcheck python scripts/sanitize_prenorm.py [--what W]

``--what prenorm`` (the default): the ``prenorm`` model of
``chip_smoke.py:prenorm_path_phase`` (configs/default.yaml with pre-LN blocks
in both stacks, full width and depth, bf16, seed 0, duration bias 1.87):
in-process B=1, 8 and 32 mel calls through ``Synthesizer(bf16=True)``
(kernels 6 and 9 in every block, 3 and 4), then kernels 6 and 9 alone on
the arguments the B=1 call gave them, each synchronised. ``local_int8``:
the int8 tier over a local mesh of two entries of the card (two threads
launching at once) at configs/default.yaml: a B=32 mel call and a B=8 wav
call with the default MelGAN (kernels 1, 3, 4 and 13). ``stft``: kernel 14
at hops 1025, 1200, 1536, 2048, 2113 and 2616 (four, two and one frames a
block) on two 3 s rows at 96 kHz, and on a row shorter than the reflect
pad. ``all`` runs the three. Every call is followed by
``torch.cuda.synchronize()``, so a fault is reported at the call that made
it. Prints one line a call and exits 0 when every call returned; the
kernels are built from this checkout first, all sources at once
(``ops/kernels/common.py:build_all``). The model helpers come from
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _say(what: str, t0: float) -> None:
    print(f"sanitize: {what} ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def prenorm(torch, smoke) -> None:
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as work:
        cfg = smoke.override_config(work, "prenorm", smoke.PRENORM_KEYS)
    synth = Synthesizer(smoke.seeded_model(torch, cfg), bf16=True)
    calls = {"attention_res": [], "ffn_block_pre": []}
    real = {"attention_res": KA.attention_res, "ffn_block_pre": KF.ffn_block_pre}

    def recording(name):
        def fn(*a, **k):
            calls[name].append(([x.clone() if isinstance(x, torch.Tensor) else x
                                 for x in a], dict(k)))
            return real[name](*a, **k)
        return fn

    for n in (1, 8, 32):
        t0 = time.perf_counter()
        if n == 1:
            KA.attention_res, KF.ffn_block_pre = (recording("attention_res"),
                                                  recording("ffn_block_pre"))
        try:
            mel, lens = synth.mel_from_token_batch(smoke.batch(n, offset=n))
            torch.cuda.synchronize()
        finally:
            KA.attention_res, KF.ffn_block_pre = real["attention_res"], real["ffn_block_pre"]
        assert (lens > 0).all() and mel.shape[0] == n
        _say(f"prenorm B={n} mel call ({int(lens.sum())} frames)", t0)
    for name, fn in real.items():
        assert calls[name], f"the B=1 call launched no {name}"
        for i, (a, k) in enumerate(calls[name]):
            t0 = time.perf_counter()
            with torch.inference_mode():
                out = fn(*a, **k)
            torch.cuda.synchronize()
            assert torch.isfinite(out).all(), (name, i)
            shapes = [tuple(x.shape) for x in a if isinstance(x, torch.Tensor)]
            _say(f"{name} alone, B=1 call's launch {i}, shapes {shapes[:2]}", t0)


def local_int8(torch, smoke) -> None:
    from fastspeech2_tpu_torch.config import Config
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.parallel.mesh import make_mesh
    from fastspeech2_tpu_torch.vocoder.melgan import MelGANGenerator

    synth = Synthesizer(smoke.seeded_model(torch, Config()), bf16=True, int8=True,
                        mesh=make_mesh(devices=["cuda:0", "cuda:0"]))
    t0 = time.perf_counter()
    mel, lens = synth.mel_from_token_batch(smoke.batch(32))
    torch.cuda.synchronize()
    _say(f"local int8 mesh B=32 mel call ({int(lens.sum())} frames)", t0)
    synth.attach_vocoder(MelGANGenerator(bf16=True, seed=0, device="cuda"))
    t0 = time.perf_counter()
    _, pcm, wl = synth.wav_from_token_batch(smoke.batch(8, offset=5))
    torch.cuda.synchronize()
    _say(f"local int8 mesh B=8 wav call ({int(wl.sum())} samples)", t0)


def stft(torch, smoke) -> None:
    import numpy as np

    from fastspeech2_tpu_torch.audio.stft import mel_filterbank
    from fastspeech2_tpu_torch.ops.kernels import stft as KS

    g = np.random.default_rng(14)
    for hop in (1025, 1200, 1536, 2048, 2113, 2616):
        n_fft = 4 * hop
        y = torch.from_numpy(np.stack([smoke.synthetic_utterance(288_000, g)
                                       for _ in range(2)])).cuda()
        fb = torch.from_numpy(mel_filterbank(96000, n_fft, 80)).cuda()
        t0 = time.perf_counter()
        kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft)
        mel, en = KS.stft_mel_energy(y, fb, **kw)
        short, _ = KS.stft_mel_energy(y[:1, :hop].contiguous(), fb, **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(mel).all() and torch.isfinite(en).all() and torch.isfinite(short).all()
        _say(f"kernel 14 hop {hop} ({KS.frames_per_block(hop, 80)[0]} frames a block)", t0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", choices=("prenorm", "local_int8", "stft", "all"),
                    default="prenorm")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sanitize_prenorm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    (ROOT / "build").mkdir(exist_ok=True)
    smoke = _smoke()
    print(smoke.smi_line(), flush=True)
    from fastspeech2_tpu_torch.ops.kernels import common

    print(f"sanitize: kernels built in {common.build_all():.1f} s", flush=True)
    for name, fn in (("prenorm", prenorm), ("local_int8", local_int8), ("stft", stft)):
        if args.what in (name, "all"):
            fn(torch, smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
