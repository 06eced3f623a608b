#!/usr/bin/env python3
"""The bf16-vs-f32 gap of WaveGlow synthesis at the width of NVIDIA's
``waveglow_256channels`` checkpoint (12 flows, 8 WN layers of 256 channels,
n_group 8, 2 early channels every 4 flows, upsampler 1024/256), in the JAX
package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python scripts/waveglow_bf16_gap.py [--frames 24] [--seed 0]

The weights are the port's ``init_waveglow(cfg, seed)`` (the ones
``chip_smoke.py``'s waveglow phase writes), carried into the JAX package
through NVIDIA's key format (``nvidia_state_dict`` -> the JAX
``waveglow_params_from_torch``); one mel of ``--frames`` frames (normal,
mean -5, std 2) and the noise are drawn from numpy with ``--seed`` and
pinned in both packages. Prints one JSON line: for the JAX package's bf16
against its f32 and for the port's bf16 against its own f32 (its CPU
route, f32 tensors rounded to bf16 at every op), the mean and max absolute
gap and the same relative to the f32 output (mean gap / rms, max gap / max
|output|); and the port's f32 against the JAX package's f32. The card is
held to the JAX package's relative gap (``chip_smoke.py:waveglow_phase``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def gap(a: np.ndarray, ref: np.ndarray) -> dict:
    d = np.abs(a - ref)
    return {"mean": float(d.mean()), "max": float(d.max()),
            "mean_over_rms": float(d.mean() / np.sqrt(np.mean(ref ** 2))),
            "max_over_peak": float(d.max() / np.abs(ref).max())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import dataclasses

    import jax.numpy as jnp
    import torch

    from fastspeech2_tpu.vocoder.waveglow import WaveGlow as JWaveGlow
    from fastspeech2_tpu.vocoder.waveglow import WaveGlowConfig as JConfig
    from fastspeech2_tpu.vocoder.waveglow import waveglow_params_from_torch
    from fastspeech2_tpu_torch.vocoder import waveglow as W

    cfg = W.WaveGlowConfig(wn_channels=256)
    wg = W.init_waveglow(cfg, seed=args.seed, device="cpu")
    sd = {k: v.numpy() for k, v in W.nvidia_state_dict(wg).items()}
    jcfg = JConfig(**dataclasses.asdict(cfg))
    jparams = waveglow_params_from_torch(sd, jcfg)
    rng = np.random.default_rng(args.seed)
    T = args.frames
    Lg = T * cfg.hop_length // cfg.n_group
    mel = rng.normal(-5, 2, size=(1, T, cfg.n_mels)).astype(np.float32)
    shapes = [(1, Lg, cfg.n_remaining)] + [(1, Lg, cfg.n_early_size)] * (cfg.n_draws - 1)
    zs = [rng.normal(size=s).astype(np.float32) for s in shapes]

    def jax_run(bf16):
        return np.asarray(JWaveGlow(jcfg, bf16=bf16).infer(
            jparams, jnp.asarray(mel), zs=[jnp.asarray(z) for z in zs]))

    def port_run(bf16):
        m = W.init_waveglow(cfg, seed=args.seed, bf16=bf16, device="cpu")
        return m.infer(torch.from_numpy(mel), zs=[torch.from_numpy(z) for z in zs]).numpy()

    jf, jb = jax_run(False), jax_run(True)
    pf, pb = port_run(False), port_run(True)
    print(json.dumps({
        "config": dataclasses.asdict(cfg), "frames": T, "seed": args.seed,
        "samples": int(jf.size),
        "jax_bf16_vs_f32": gap(jb, jf), "port_bf16_vs_f32": gap(pb, pf),
        "port_f32_vs_jax_f32": gap(pf, jf)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
