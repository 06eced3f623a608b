#!/usr/bin/env python3
"""The bucket-flip share of two reference implementations of kernel 3 in bf16.

    JAX_PLATFORMS=cpu python scripts/adaptor_flip_band.py [--cases D:NB ...] [--seeds N]

Runs the JAX package's ``fused_variance_adaptor`` (its Pallas kernel in
interpret mode, bf16 compute) and the port's plain version
(``ops/kernels/adaptor.py:variance_adaptor_plain``, bf16 compute) on the CPU
on the same seeded inputs, built as the card tests build theirs (PyTorch's
default initialisation of the predictors and embeddings, the head scaled by
8, biases 200 and 40, log pitch edges 71-676 and linear energy edges 0-130
over NB bins, 4 rows of 331 frames with lengths 331, 1, 0 and 200). Both
round at the same points; they differ only in f32 summation order. Prints
one JSON line per (D, NB, seed): the live frames, the frames whose raw
predictions differ, the frames one bucket or more apart (a raw prediction
on either side of an edge), and the largest raw difference. Where the bin
spacing is finer than one bf16 step of the head's sum, every raw difference
moves a frame to another bucket.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from fastspeech2_tpu.ops.pallas.adaptor import fused_variance_adaptor  # noqa: E402
from fastspeech2_tpu_torch.ops.kernels import adaptor as KAd  # noqa: E402
from fastspeech2_tpu_torch.ops.quantize import linear_bins, log_bins  # noqa: E402

C, K, T, L = 256, 3, 40, 331
LENS = (331, 1, 0, 200)


def inputs(D, nb, seed):
    rng = np.random.default_rng(seed)
    u = lambda shape, fan: rng.uniform(-1, 1, shape) / np.sqrt(fan)  # noqa: E731
    p = {"w1": u((2, K, D, C), K * D), "b1": u((2, C), K * D),
         "g1": np.ones((2, C)), "be1": np.zeros((2, C)),
         "w2": u((2, K, C, C), K * C), "b2": u((2, C), K * C),
         "g2": np.ones((2, C)), "be2": np.zeros((2, C)),
         "wo": 8.0 * u((2, C), C), "bo": np.asarray([[200.0, 40.0]]),
         "emb_w": u((2, nb, D), nb), "emb_b": u((2, D), nb)}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    hs = rng.normal(size=(len(LENS), T, D)).astype(np.float32)
    idx = np.sort(rng.integers(0, T, (len(LENS), L)), -1).astype(np.int32)
    inf = np.full((1,), np.inf, np.float32)
    bins = np.stack([np.concatenate([log_bins(71.0, 676.0, nb), inf]),
                     np.concatenate([linear_bins(0.0, 130.0, nb), inf])])
    return hs, idx, np.asarray(LENS, np.int32), p, bins


def case(D, nb, seed):
    hs, idx, lens, p, bins = inputs(D, nb, seed)
    bf = jnp.bfloat16
    _, raw_j = fused_variance_adaptor(
        jnp.asarray(hs), jnp.asarray(idx), jnp.asarray(lens), jnp.asarray(p["w1"], bf),
        jnp.asarray(p["b1"]), jnp.asarray(p["g1"]), jnp.asarray(p["be1"]),
        jnp.asarray(p["w2"], bf), jnp.asarray(p["b2"]), jnp.asarray(p["g2"]),
        jnp.asarray(p["be2"]), jnp.asarray(p["wo"], bf), jnp.asarray(p["bo"]),
        jnp.asarray(bins), jnp.asarray(p["emb_w"], bf), jnp.asarray(p["emb_b"]),
        cd=bf, interpret=True)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dt)  # noqa: E731
    b16 = torch.bfloat16
    _, raw_t = KAd.variance_adaptor_plain(
        t(hs), t(idx, torch.int32), t(lens, torch.int32),
        t(p["w1"].transpose(0, 3, 1, 2).reshape(2, C, K * D), b16), t(p["b1"]), t(p["g1"]),
        t(p["be1"]), t(p["w2"].transpose(0, 3, 1, 2).reshape(2, C, K * C), b16), t(p["b2"]),
        t(p["g2"]), t(p["be2"]), t(p["wo"], b16), t(p["bo"][0]), t(bins),
        t(p["emb_w"], b16), t(p["emb_b"]))
    raw_j, raw_t = np.asarray(raw_j), raw_t.numpy()
    live = np.arange(L)[None] < lens[:, None]
    bk = lambda r, i: (bins[i][None, None] < r[:, i][..., None]).sum(-1)  # noqa: E731
    flipped = ((bk(raw_j, 0) != bk(raw_t, 0)) | (bk(raw_j, 1) != bk(raw_t, 1))) & live
    differs = (raw_j != raw_t).any(1) & live
    return {"D": D, "NB": nb, "seed": seed, "live": int(live.sum()),
            "raw_differs": int(differs.sum()), "flipped": int(flipped.sum()),
            "flip_share": float(flipped.sum() / live.sum()),
            "raw_max_diff": float(np.abs(raw_j - raw_t).max())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", nargs="*", default=["256:256", "1024:256", "1100:256",
                                                   "2048:256", "256:4096", "256:8192",
                                                   "256:65536"])
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    for c in args.cases:
        D, nb = (int(v) for v in c.split(":"))
        for seed in range(args.seeds):
            print(json.dumps(case(D, nb, seed)), flush=True)


if __name__ == "__main__":
    main()
